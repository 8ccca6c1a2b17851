"""The light and AO-tap counts in the port against the JAX package, on the
CPU.  Lights: the fused kernels keep a light's shadow in a bit of an int32,
as JAX's mega kernel does (which fails from 32 lights on, its constant
1 << 31 overflowing), so the port's ``cuda`` backend takes at most 32 and
raises ValueError above; ``multi`` and ``ref`` keep no mask and render 33
lights as JAX's pallas and ref backends do.  AO taps: JAX's kernels loop
over any count, and so do the port's twins and its extended entries (up
to 256, ``shade_kernel.MAX_AO_SAMPLES``, by value; past it, entries that
form each tap's distance from ``ao_delta``); 40 taps in K1's twin against
JAX's mega kernel (interpret mode), 300 against JAX's ref backend.  The
entries themselves are held to the twin on the card by
tests/test_torch_kernel_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render  # noqa: E402
from raymarching_tpu.scene.compile import compile_tree  # noqa: E402
from raymarching_tpu.scene.csg import Box, ListNode, Mode, Sphere, bounds  # noqa: E402
from raymarching_tpu.scene.objects import Camera, Light  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.ops import shade_kernel as shk  # noqa: E402

# tests/test_mega.py:87
IMG_ATOL = 5e-4


def _world(lights):
    root = ListNode(Mode.UNION, [bounds(40.0), Sphere((0, 0, -5), 1.5),
                                 Box((0, -2, -5), (6, 0.5, 6))])
    return compile_tree(root, lights, Camera())


def _port_cfg(cfg) -> rt.RenderConfig:
    return rt.RenderConfig(**{f: getattr(cfg, f)
                              for f in cfg.__dataclass_fields__})


def test_33_lights_render_on_multi_and_ref_and_raise_on_cuda():
    """33 lights round the world, each a little shadowed: the port's
    multi and ref images against JAX's ref; the fused path raises."""
    lights = [Light((float(np.cos(a)) * 6, 3.0, -5 + float(np.sin(a)) * 6))
              for a in np.linspace(0, 6, 33)]
    plan, tables = _world(lights)
    cfg = RenderConfig(width=12, height=8, ssaa=1, iterations=60,
                       saturation=0.05)
    want = np.asarray(jax_render(plan, tables, cfg, backend="ref"))
    assert want.max() > 0
    for backend in ("multi", "ref"):
        img = rt.render_tables(plan, tables, _port_cfg(cfg),
                               backend=backend, device="cpu").numpy()
        np.testing.assert_allclose(img, want, rtol=0, atol=IMG_ATOL,
                                   err_msg=backend)
    assert shk.MAX_LIGHTS == 32
    with pytest.raises(ValueError, match="at most 32"):
        rt.render_tables(plan, tables, _port_cfg(cfg), device="cpu")


def test_40_ao_taps_match_jax_mega():
    """K1's extended twin with 40 AO taps (past the 32 the entries once
    held) against JAX's mega kernel; the card's entries take them."""
    plan, tables = _world([Light((5.0, 5.0, 0.0))])
    cfg = RenderConfig(width=12, height=8, ssaa=1, iterations=60,
                       ao_strength=0.8, ao_samples=40, ao_delta=0.05)
    want = np.asarray(jax_render(plan, tables, cfg, backend="mega",
                                 interpret=True))
    img = rt.render_tables(plan, tables, _port_cfg(cfg), device="cpu")
    np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=IMG_ATOL)
    assert (img.sum(-1) > 0).float().mean() > 0.3
    assert cfg.ao_samples <= shk.MAX_AO_SAMPLES == 256


def test_300_ao_taps_match_jax_ref():
    """300 AO taps (past the 256 the entries take by value) through K1's
    extended twin against JAX's ref backend."""
    plan, tables = _world([Light((5.0, 5.0, 0.0))])
    cfg = RenderConfig(width=12, height=8, ssaa=1, iterations=60,
                       ao_strength=0.8, ao_samples=300, ao_delta=0.05)
    want = np.asarray(jax_render(plan, tables, cfg, backend="ref"))
    img = rt.render_tables(plan, tables, _port_cfg(cfg), device="cpu")
    np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=IMG_ATOL)
    assert (img.sum(-1) > 0).float().mean() > 0.3
    # past MAX_AO_SAMPLES the entries take the count and ao_delta alone
    args = shk.ext_operands(plan, _port_cfg(cfg), 1, "cpu")[0]
    assert args[3] == 300 > shk.MAX_AO_SAMPLES and args[5] == 0.05
