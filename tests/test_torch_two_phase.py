"""The two-phase march of the port's fused backend (K3, K3, K4: their plain
twins on the CPU): twins of tests/test_mega.py's two-phase tests, and K4's
plain twin against the JAX shade kernel (``_compiled_shade_call``, Pallas
interpret mode, reached through the JAX two-phase path)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402
from raymarching_tpu.ops.pallas_render import pallas_render_rays  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.ops import march_kernel as mk  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
from raymarching_tpu_torch.ops import shade_kernel as shk  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402
from test_torch_render_kernel import CFG as MEGA_CFG  # noqa: E402
from test_torch_render_kernel import _mega_world, _rays  # noqa: E402

# tests/test_mega.py:121-163's configuration
CFG = MEGA_CFG.replace(ssaa=1)
FIELDS = ("prim_pos", "prim_aux", "prim_color", "light_pos")


@pytest.fixture(scope="module")
def world():
    plan, tables = _mega_world()
    one = rt.render_tables(plan, tables, CFG, device="cpu")
    return plan, tables, one


@pytest.mark.parametrize("k1", [8, 24, 48])
def test_two_phase_march_bit_identical(world, k1):
    plan, tables, one = world
    n3, n4 = mk.march_rays.launches, shk.shade_rays.launches
    two = rt.render_tables(plan, tables, CFG.replace(two_phase_k1=k1),
                           device="cpu")
    assert torch.equal(two, one) and one.max() > 0
    # CPU tensors take the plain twins
    assert (mk.march_rays.launches, shk.shade_rays.launches) == (n3, n4)


def test_two_phase_overflow_fallback_exact(world):
    """k1 = 1 leaves far more than the capacity unconverged: everything is
    marched again with the full budget; results stay exact.  (At this
    frame's 384 rays the default capacity, one 4,096-lane tile, holds
    every ray; a one-sublane tile makes it 128.)"""
    plan, tables, one = world
    cfg = CFG.replace(two_phase_k1=1, tile_sublanes=1)
    tt = tables_to_torch(tables, "cpu")
    origin, dirs = _rays(tables, CFG)
    left = ~mk.march_rays(plan, cfg, tt, torch.as_tensor(origin),
                          torch.as_tensor(dirs), iterations=1).converged
    assert int(left.sum()) > rk.phase2_capacity(cfg, dirs.shape[0])
    assert torch.equal(rt.render_tables(plan, tables, cfg, device="cpu"), one)


@pytest.mark.parametrize("k1", [1, 8, 24, 79])
def test_two_phase_ray_outputs_equal_one_march(world, k1):
    """Hit points, SDs, convergence and the shading, ray by ray, also where
    every ray converges in phase 1 or none does."""
    plan, tables, _ = world
    tt = tables_to_torch(tables, "cpu")
    origin, dirs = (torch.as_tensor(v) for v in _rays(tables, CFG))
    one = rk.render_rays(plan, CFG, tt, origin, dirs)
    two = rk.render_rays(plan, CFG.replace(two_phase_k1=k1), tt, origin, dirs)
    for name, a, b in zip(one._fields, two, one):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # out of range: one kernel, as the JAX condition 0 < k1 < iterations
    for k in (0, CFG.iterations, CFG.iterations + 5):
        out = rk.render_rays(plan, CFG.replace(two_phase_k1=k), tt, origin,
                             dirs)
        assert torch.equal(out.light, one.light)


def test_phase2_capacity():
    cfg = RenderConfig(tile_sublanes=32)
    assert rk.phase2_capacity(cfg, 1 << 20) == 1 << 17      # R / 8
    assert rk.phase2_capacity(cfg, 10_000) == 4096          # one tile
    assert rk.phase2_capacity(cfg, 384) == 384              # all the rays


def test_two_phase_gradients_match(world):
    plan, tables, _ = world
    cfg = CFG.replace(two_phase_k1=24)
    grads = []
    for c in (cfg, cfg.replace(two_phase_k1=0)):
        tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
        img = rt.render_tables(plan, tt, c, differentiable=True, device="cpu")
        (img * img).mean().backward()
        grads.append([getattr(tt, f).grad.numpy() for f in FIELDS])
    for field, a, b in zip(FIELDS, *grads):
        assert np.abs(b).max() > 0 or field == "light_pos"
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                   err_msg=f"two-phase grad {field}")


def test_two_phase_image_matches_jax_two_phase(world):
    plan, tables, _ = world
    cfg = CFG.replace(two_phase_k1=24)
    want = np.asarray(jax_render_tables(plan, tables, cfg, backend="mega",
                                        interpret=True))
    got = rt.render_tables(plan, tables, cfg, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("off", [None, "shade_skip_black", "shadow_sat_skip",
                                 "shadows"])
def test_shade_twin_matches_jax_shade_kernel(world, off):
    """The JAX two-phase path shades its merged hit points with
    ``_compiled_shade_call``; K4's plain twin on those very hit points
    gives its colour winners, shadow bits and light."""
    plan, tables, _ = world
    cfg = CFG.replace(two_phase_k1=24, **({off: False} if off else {}))
    origin, dirs = _rays(tables, cfg)
    p, sd, _, cidx, light, smask = (np.array(v) for v in pallas_render_rays(
        plan, cfg, jnp.asarray(origin), jnp.asarray(dirs), tables,
        interpret=True)[:6])
    before = shk.shade_rays.launches
    out = shk.shade_rays(plan, cfg, tables_to_torch(tables, "cpu"),
                         torch.as_tensor(p), torch.as_tensor(sd),
                         torch.as_tensor(dirs))
    assert shk.shade_rays.launches == before
    assert out.cidx.dtype == torch.int32 and out.smask.dtype == torch.int32
    # a hit whose FD stencil straddles an edge turns the last bits of the
    # fold into ~1e-3 of light or a flipped shadow bit: such a ray counts
    # as disagreeing (tests/test_torch_render_kernel.py)
    agree = ((out.cidx.numpy() == cidx) & (out.smask.numpy() == smask)
             & (np.abs(out.light.numpy() - light) <= 5e-4))
    assert agree.mean() >= 0.995, f"{(~agree).sum()} rays disagree"
    assert (cidx >= 0).mean() > 0.5
    if off == "shadows":
        assert not out.smask.any()
    else:
        assert out.smask.any()
