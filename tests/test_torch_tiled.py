"""The port's ``api.render_tiled`` (a frame streamed through the device a
block of rows at a time into host memory) against its own whole-frame
render and against the JAX package's ``render_tiled``, on the CPU: twins of
tests/test_tiled.py.  Within the port the tiled frame is the whole frame
bit for bit (a block's rays are the frame's rows, bitwise); across the
packages the images agree within tests/test_mega.py:87's 5e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu as jrt  # noqa: E402
from raymarching_tpu.api import render_tiled as jax_tiled  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.api import render_tiled  # noqa: E402

CFG = rt.RenderConfig(width=32, height=24, ssaa=1, iterations=80)
# tests/test_mega.py:87, the cross-path image tolerance
IMG_ATOL = 5e-4


def _jax_cfg(cfg):
    return jrt.RenderConfig(**{f: getattr(cfg, f)
                               for f in cfg.__dataclass_fields__})


@pytest.fixture(scope="module")
def demo():
    return rt.compile_scene(rt.load_scene("scenes/demo.txt"))


@pytest.fixture(scope="module")
def whole(demo):
    """The port's whole frames: pinhole and thin-lens."""
    plan, tables = demo
    return {ap: rt.render_tables(plan, tables, CFG.replace(aperture=ap),
                                 device="cpu").numpy() for ap in (0.0, 0.2)}


@pytest.fixture(scope="module")
def jax_frames():
    """JAX's render_tiled (the jnp backend) of the same frames."""
    plan, tables = jrt.compile_scene(jrt.load_scene("scenes/demo.txt"))
    return {ap: jax_tiled(plan, tables, _jax_cfg(CFG.replace(aperture=ap)),
                          row_block=10, backend="jnp") for ap in (0.0, 0.2)}


@pytest.mark.parametrize("row_block", [24, 7, 5, 1000])
def test_tiled_matches_whole_frame(demo, whole, row_block):
    """Ragged and whole-frame blocks: the port's whole frame, bitwise."""
    plan, tables = demo
    tiled = render_tiled(plan, tables, CFG, row_block=row_block,
                         device="cpu")
    np.testing.assert_array_equal(tiled, whole[0.0])


@pytest.mark.parametrize("aperture", [0.0, 0.2])
def test_tiled_matches_jax_render_tiled(demo, whole, jax_frames, aperture):
    """Pinhole and thin-lens (the DoF band) tiled frames against JAX's
    render_tiled, and the DoF frame is not the pinhole one."""
    plan, tables = demo
    cfg = CFG.replace(aperture=aperture)
    tiled = render_tiled(plan, tables, cfg, row_block=9, device="cpu")
    np.testing.assert_array_equal(tiled, whole[aperture])
    np.testing.assert_allclose(tiled, jax_frames[aperture], rtol=0,
                               atol=IMG_ATOL)
    assert (tiled.sum(-1) > 0).mean() > 0.3
    if aperture:
        assert np.abs(tiled - whole[0.0]).max() > 1e-3


def test_tiled_row_slice_matches_band(demo, whole):
    """row_start / num_rows stream exactly the band asked for."""
    plan, tables = demo
    band = render_tiled(plan, tables, CFG, row_block=4, row_start=11,
                        num_rows=13, device="cpu")
    assert band.shape == (13, CFG.width, 3)
    np.testing.assert_array_equal(band, whole[0.0][11:24])


def test_tiled_rejects_out_of_range_band(demo):
    plan, tables = demo
    for r0, n in ((20, 10), (-1, 4)):
        with pytest.raises(ValueError, match="outside frame"):
            render_tiled(plan, tables, CFG, row_block=16, row_start=r0,
                         num_rows=n, device="cpu")
    with pytest.raises(ValueError, match="row_block"):
        render_tiled(plan, tables, CFG, row_block=0, device="cpu")


def test_tiled_output_is_host_memory(demo):
    plan, tables = demo
    tiled = render_tiled(plan, tables, CFG.replace(width=8, height=6),
                         row_block=4, device="cpu")
    assert isinstance(tiled, np.ndarray) and tiled.dtype == np.float32
    assert tiled.shape == (6, 8, 3) and np.isfinite(tiled).all()


@pytest.mark.parametrize("backend,change", [
    ("multi", {}), ("ref", {}), ("cuda", dict(ray_chunk=50)),
    ("multi", dict(soft_shadow_k=6.0, ao_strength=0.8))])
def test_tiled_backends_match_their_whole_frames(backend, change):
    """Every backend's tiled frame is its whole frame, bitwise, chunked
    launches too; multi with soft shadows and AO goes to cuda, as
    render_tables sends it."""
    plan, tables = rt.compile_scene(rt.load_scene("scenes/config3.txt"))
    cfg = CFG.replace(width=16, height=12, **change)
    want = rt.render_tables(plan, tables, cfg, backend=backend, device="cpu")
    got = render_tiled(plan, tables, cfg, row_block=5, backend=backend,
                       device="cpu")
    np.testing.assert_array_equal(got, want.numpy())
    if change.get("ao_strength"):
        np.testing.assert_array_equal(got, rt.render_tables(
            plan, tables, cfg, backend="cuda", device="cpu").numpy())


def test_tiled_on_missing_cuda_device_raises(demo):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    plan, tables = demo
    with pytest.raises(RuntimeError, match="cuda"):
        render_tiled(plan, tables, CFG, device="cuda")
