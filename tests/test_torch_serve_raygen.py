"""The port's in-kernel raygen serving path (RenderConfig.serve_raygen) on
the CPU (K1's raygen twin: ``core.camera.raygen_dirs`` and K1's plain
twin), mirroring tests/test_serve_raygen.py on scenes/config4.txt: the
image against the standard path and against the JAX package's
``serve_raygen`` image (``mega`` in interpret mode) by the suite's
agreement share, in scan order, chunked, and in the fused analytic
regime; the camera rows against JAX's; the path primal only; the envelope
outside which the standard raygen renders."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402
from raymarching_tpu.ops.pallas_render import _serve_cam_rows  # noqa: E402
from raymarching_tpu.scene.compile import compile_scene as jax_compile  # noqa: E402
from raymarching_tpu.scene.parser import load_scene as jax_load  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch import api  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

SCENE = "config4"
# tests/test_serve_raygen.py:41-44: ulp noise in the directions moves a
# march at silhouettes, so images agree on a share of the pixels
ATOL, SHARE, MEDIAN = 5e-3, 0.995, 1e-4


def _port(cfg: RenderConfig) -> rt.RenderConfig:
    return rt.RenderConfig(**{f: getattr(cfg, f)
                              for f in cfg.__dataclass_fields__})


@pytest.fixture(scope="module")
def world(scenes_dir):
    return rt.compile_scene(rt.load_scene(str(scenes_dir / f"{SCENE}.txt")))


def _agree(a, b, median=True):
    diff = np.abs(a - b).max(axis=-1)
    assert (diff < ATOL).mean() > SHARE, (diff >= ATOL).sum()
    if median:
        assert np.median(diff) < MEDIAN


def _img(plan, tables, cfg):
    return rt.render_tables(plan, tables, _port(cfg), device="cpu").numpy()


@pytest.mark.parametrize("over", [
    dict(width=64, height=48, ssaa=2),
    dict(width=16, height=8, ssaa=1),
    dict(width=64, height=48, ssaa=2, ray_chunk=4096)])
def test_serve_matches_standard(world, over):
    """The raygen path's image against the standard camera pass's; the
    chunked frame (raygen launches keyed by their first ray) is the
    unchunked one bit for bit."""
    plan, tables = world
    cfg = RenderConfig(iterations=120, shadows=True, **over)
    a = _img(plan, tables, cfg)
    b = _img(plan, tables, cfg.replace(serve_raygen=True))
    _agree(a, b)
    if cfg.ray_chunk:
        assert np.array_equal(b, _img(plan, tables, cfg.replace(
            serve_raygen=True, ray_chunk=0)))


def test_serve_matches_jax_serve_raygen(world, scenes_dir):
    """The port's raygen image against the JAX package's in-kernel raygen
    image (mega, interpret mode)."""
    plan, tables = world
    cfg = RenderConfig(width=32, height=24, ssaa=2, iterations=120,
                       shadows=True, serve_raygen=True)
    jplan, jtables = jax_compile(jax_load(str(scenes_dir / f"{SCENE}.txt")))
    want = np.asarray(jax_render_tables(jplan, jtables, cfg, backend="mega",
                                        interpret=True))
    _agree(_img(plan, tables, cfg), want)


def test_serve_fused_analytic_regime(world):
    plan, tables = world
    cfg = RenderConfig(width=64, height=48, ssaa=2, iterations=120,
                       shadows=True, fused_generators=True,
                       normal_mode="analytic")
    _agree(_img(plan, tables, cfg),
           _img(plan, tables, cfg.replace(serve_raygen=True)), median=False)


def test_serve_with_shading_extensions(world):
    """Soft shadows and AO through the raygen entry's extended shading."""
    plan, tables = world
    cfg = RenderConfig(width=32, height=24, ssaa=1, iterations=120,
                       soft_shadow_k=6.0, ao_strength=0.8)
    _agree(_img(plan, tables, cfg),
           _img(plan, tables, cfg.replace(serve_raygen=True)))


def test_serve_is_primal_only(world):
    plan, tables = world
    cfg = rt.RenderConfig(width=32, height=16, ssaa=1, iterations=60,
                          serve_raygen=True)
    tt = tables_to_torch(tables, "cpu", requires_grad=("prim_pos",))
    with pytest.raises(ValueError, match="serve_raygen"):
        rt.render_tables(plan, tt, cfg, differentiable=True, device="cpu")
    # the same frame differentiates through the standard raygen
    img = rt.render_tables(plan, tt, cfg.replace(serve_raygen=False),
                           differentiable=True, device="cpu")
    assert torch.autograd.grad(img.mean(), tt.prim_pos)[0].abs().max() > 0


def test_serve_envelope():
    """The raygen path is the fused backend's, pinhole only: depth of field
    (per-ray lens origins) takes the standard raygen, as the JAX package's
    does, and so do the other backends."""
    cfg = rt.RenderConfig(serve_raygen=True)
    assert api.serves_in_kernel(cfg, "cuda")
    assert not api.serves_in_kernel(cfg.replace(aperture=0.1), "cuda")
    assert not api.serves_in_kernel(cfg, "multi")
    assert not api.serves_in_kernel(cfg, "ref")
    assert not api.serves_in_kernel(cfg.replace(serve_raygen=False), "cuda")


def test_camera_rows_and_directions(world, scenes_dir):
    """serve_cam_rows against JAX's _serve_cam_rows (the chunk base aside,
    an integer here), and the raygen twin's directions against the
    standard camera's to float32 roundings, in generate_rays' order."""
    plan, tables = world
    cfg = RenderConfig(width=40, height=30, ssaa=3)
    jplan, jtables = jax_compile(jax_load(str(scenes_dir / f"{SCENE}.txt")))
    want = np.asarray(_serve_cam_rows(jtables, cfg, 0))
    tt = tables_to_torch(tables, "cpu")
    rows = cam.serve_cam_rows(tt, _port(cfg))
    np.testing.assert_allclose(rows.numpy(), want, rtol=1e-6, atol=1e-7)
    _, dirs = cam.generate_rays(tt, _port(cfg))
    dirs = dirs.reshape(-1, 3)
    got = cam.raygen_dirs(rows, _port(cfg), 0, dirs.shape[0])
    assert (got - dirs).abs().max() < 1e-6
    # a chunk's directions are the frame's rays from its first ray on
    assert torch.equal(cam.raygen_dirs(rows, _port(cfg), 777, 500),
                       got[777:1277])


def test_render_raygen_counts_no_direction_pass(world, monkeypatch):
    """The serving render calls render_raygen once a chunk, keyed by the
    chunk's first ray, and never the camera pass; on CPU tensors it takes
    the twin, which counts no launch."""
    plan, tables = world
    cfg = rt.RenderConfig(width=16, height=12, ssaa=2, iterations=60,
                          serve_raygen=True, ray_chunk=300)
    calls, chunks = [], []
    monkeypatch.setattr(api.cam, "generate_rays",
                        lambda *a, **k: calls.append(1))
    raygen = api.render_raygen
    monkeypatch.setattr(api, "render_raygen", lambda p, c, t, base, n:
                        chunks.append((base, n)) or raygen(p, c, t, base, n))
    before = rk.render_raygen.launches
    img = rt.render_tables(plan, tables, cfg, device="cpu")
    assert calls == [] and img.shape == (12, 16, 3)
    assert chunks == [(0, 300), (300, 300), (600, 168)]
    assert rk.render_raygen.launches == before
