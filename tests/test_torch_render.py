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
