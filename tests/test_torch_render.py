"""The port's slice end to end: the demo scene through the port's ``ref``
backend and its fused path (plain twins on the CPU) against the JAX mega
backend (Pallas interpret mode) and the JAX oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu as jrt  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402

CFG = jrt.RenderConfig(width=32, height=24, ssaa=1, iterations=300)
# tests/test_mega.py's mega-vs-ref image tolerance
ATOL = 5e-4


@pytest.fixture(scope="module")
def demo(scenes_dir):
    scene = jrt.load_scene(str(scenes_dir / "demo.txt"))
    plan, tables = jrt.compile_scene(scene)
    return {
        "plan": plan, "tables": tables,
        "jax_mega": np.asarray(jax_render_tables(plan, tables, CFG,
                                                 backend="mega",
                                                 interpret=True)),
        "jax_ref": np.asarray(jrt.render_ref(scene, CFG)),
        "port_fused": rt.render_tables(plan, tables, CFG, backend="cuda",
                                       device="cpu").numpy(),
        "port_ref": rt.render_tables(plan, tables, CFG, backend="ref",
                                     device="cpu").numpy(),
    }


@pytest.mark.parametrize("port,jax", [("port_fused", "jax_mega"),
                                      ("port_fused", "jax_ref"),
                                      ("port_ref", "jax_ref"),
                                      ("port_ref", "jax_mega")])
def test_demo_image_matches_jax(demo, port, jax):
    np.testing.assert_allclose(demo[port], demo[jax], rtol=0, atol=ATOL)


def test_fused_path_matches_port_oracle(demo):
    np.testing.assert_allclose(demo["port_fused"], demo["port_ref"], rtol=0,
                               atol=ATOL)


def test_demo_image_has_its_objects(demo):
    img = demo["port_fused"]
    assert img.shape == (24, 32, 3) and img.dtype == np.float32
    assert np.isfinite(img).all()
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    # red sphere, blue DeathStar, green sphere, black background
    assert ((r > 0.2) & (g < 0.05) & (b < 0.05)).any()
    assert ((b > 0.2) & (r < 0.05) & (g < 0.05)).any()
    assert ((g > 0.2) & (r < 0.05) & (b < 0.05)).any()
    assert (img.max(axis=-1) == 0).any()


def test_render_entry_point_matches_render_tables(demo, scenes_dir):
    scene = rt.load_scene(str(scenes_dir / "demo.txt"))
    img = rt.render(scene, CFG, device=torch.device("cpu")).numpy()
    np.testing.assert_array_equal(img, demo["port_fused"])


@pytest.mark.parametrize("chunk", [97, 768, 5000])
def test_ray_chunk_gives_the_same_image(demo, chunk):
    """``cfg.ray_chunk`` renders the rays in chunks, one after the other:
    rays are independent, so the image is the unchunked one bit for bit
    (768 is the frame's ray count, 5000 more than it)."""
    img = rt.render_tables(demo["plan"], demo["tables"],
                           CFG.replace(ray_chunk=chunk), device="cpu")
    np.testing.assert_array_equal(img.numpy(), demo["port_fused"])


@pytest.mark.parametrize("normal_mode", ["fd", "analytic"])
def test_ray_chunk_gives_the_same_gradients(demo, normal_mode):
    """The differentiable fused path in chunks: the image bit for bit, and
    the gradients to a few float32 roundings of partial sums.  Each
    chunk's backward sums its parameter rows in float64 and rounds once;
    autograd adds the chunks' float32 sums.  A leaf's partial sum over a
    chunk can be far larger than its total: an FD stencil's rows carry
    +-1 / 2 fd_h, and where a point's +h and -h winners differ they land
    on different leaves and cancel only over many rays (on this frame the
    gap is 5e-5 of the field's scale, 2.98e-8 on a scale of 6e-4)."""
    from raymarching_tpu_torch.tables import tables_to_torch
    cfg = CFG.replace(width=16, height=12, iterations=120,
                      normal_mode=normal_mode)
    fields = ("prim_pos", "prim_aux", "prim_color", "light_pos")
    grads = []
    for chunk in (0, 50):
        tt = tables_to_torch(demo["tables"], "cpu", requires_grad=fields)
        img = rt.render_tables(demo["plan"], tt, cfg.replace(ray_chunk=chunk),
                               differentiable=True, device="cpu")
        grads.append((img.detach(), torch.autograd.grad(
            torch.mean((img - 0.25) ** 2), [getattr(tt, f) for f in fields])))
    assert torch.equal(grads[0][0], grads[1][0])
    for name, a, b in zip(fields, grads[1][1], grads[0][1]):
        scale = max(b.abs().max().item(), 1e-8)
        assert scale > 1e-8, name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-4 * scale,
                                   msg=name)
