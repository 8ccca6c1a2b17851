"""Soft shadows and ambient occlusion in the port against the JAX package,
on the CPU (the kernels' plain twins), in the world of tests/test_softao.py
(a sphere over a floor, two lights, 24x16 SSAA 2, 80 iterations): the
``ref`` oracle against JAX's ``ref`` (the penumbra's t summed step by
step), the ``cuda`` backend's twin against JAX's ``mega`` kernel in
interpret mode (t projected, as in the kernels), k = 0 and AO 0 the
reference path bit for bit, a huge k the hard shadows, two-phase equal to
one kernel, and the gradients of the FD, analytic and fused analytic
backwards, with the saved factors replayed as constants, against JAX's
``mega`` gradients.

The JAX side is the expensive half (a ``mega`` render in interpret mode
takes seconds here): each JAX image and gradient is computed once, in a
module fixture, and shared by the port's cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402
from raymarching_tpu.scene.compile import SceneTables, compile_tree  # noqa: E402
from raymarching_tpu.scene.csg import Box, ListNode, Mode, Sphere, bounds  # noqa: E402
from raymarching_tpu.scene.generators import death_star  # noqa: E402
from raymarching_tpu.scene.objects import Camera, Light  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.ops import render_op  # noqa: E402
from raymarching_tpu_torch.ops import shade_kernel as shk  # noqa: E402
from raymarching_tpu_torch.ops.render_kernel import (render_rays,  # noqa: E402
                                                     render_rays_plain)
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

FIELDS = SceneTables._fields
CFG = RenderConfig(width=24, height=16, ssaa=2, iterations=80,
                   shadows=True, normal_mode="fd")
# tests/test_softao.py's tolerances: images of mega against ref 1e-4 (the
# two soft-shadow arithmetics, summed and projected t, differ by ulps),
# gradients tests/test_mega.py:62's
IMG_ATOL = 1e-4
RTOL, ATOL_SCALE = 0.02, 0.005
# (AO as tests/test_softao.py's darkening case: the default taps barely
# reach the floor in this world)
MODES = {"soft": dict(soft_shadow_k=8.0),
         "ao": dict(ao_strength=2.0, ao_delta=0.3),
         "both": dict(soft_shadow_k=4.0, ao_strength=0.7)}


def _world(generator: bool = False):
    """tests/test_softao.py's world; with ``generator`` its fused world (a
    DeathStar beside the sphere, one light)."""
    leaves = [bounds(60.0),
              Sphere((0.0, 0.0, -6.0), 1.8, color=(0.9, 0.4, 0.2))]
    if generator:
        leaves.append(death_star((2.8, 0.5, -5.0), 1.0, color=(0.3, 0.4, 0.9)))
    leaves.append(Box((0.0, -3.0, -6.0), (10.0, 1.0, 10.0),
                      color=(0.6, 0.6, 0.9)))
    lights = [Light((6.0, 8.0, 4.0))]
    if not generator:
        lights.append(Light((-5.0, 6.0, 0.0)))
    return compile_tree(ListNode(Mode.UNION, leaves), lights,
                        Camera(position=(0, 2, 6), fov=55.0))


def _port(cfg: RenderConfig) -> rt.RenderConfig:
    return rt.RenderConfig(**{f: getattr(cfg, f)
                              for f in cfg.__dataclass_fields__})


def _img(plan, tables, cfg, backend="cuda"):
    return rt.render_tables(plan, tables, _port(cfg), backend=backend,
                            device="cpu").numpy()


@pytest.fixture(scope="module")
def world():
    return _world()


@pytest.fixture(scope="module")
def jax_images(world):
    """JAX's ref image of each mode and its mega image (interpret mode) of
    soft shadows with AO."""
    plan, tables = world
    ref = {m: np.asarray(jax_render_tables(plan, tables, CFG.replace(**ch),
                                           backend="ref"))
           for m, ch in MODES.items()}
    mega = np.asarray(jax_render_tables(plan, tables,
                                        CFG.replace(**MODES["both"]),
                                        backend="mega", interpret=True))
    return ref, mega


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ref_matches_jax_ref(world, jax_images, mode):
    """The port's oracle (soft_shadow_factor with t summed step by step,
    ambient_occlusion) against JAX's, and the image moves off the hard
    shadows' by a real penumbra or occlusion."""
    plan, tables = world
    cfg = CFG.replace(**MODES[mode])
    img = _img(plan, tables, cfg, "ref")
    np.testing.assert_allclose(img, jax_images[0][mode], atol=IMG_ATOL)
    assert np.abs(img - _img(plan, tables, CFG, "ref")).max() > 5e-3


@pytest.mark.parametrize("path", ["cuda", "two-phase", "multi"])
def test_cuda_twin_matches_jax_mega(world, jax_images, path):
    """K1's plain twin (the penumbra tracked inside the shadow march with t
    projected, the AO taps after the clamp) against JAX's mega kernel in
    interpret mode, soft shadows with AO; the two-phase path (K3, K3, K4's
    extended twin) gives the one kernel's image bit for bit, and ``multi``
    routes soft shadows and AO to ``cuda`` as JAX routes pallas to mega."""
    plan, tables = world
    cfg = CFG.replace(**MODES["both"])
    c = cfg.replace(two_phase_k1=16) if path == "two-phase" else cfg
    img = _img(plan, tables, c, "multi" if path == "multi" else "cuda")
    np.testing.assert_allclose(img, jax_images[1], atol=IMG_ATOL)
    if path != "cuda":
        assert np.array_equal(img, _img(plan, tables, cfg))


@pytest.mark.parametrize("mode", ["soft", "ao"])
def test_cuda_twin_matches_jax_ref(world, jax_images, mode):
    """The two soft-shadow arithmetics (the kernels' projected t against
    the oracle's summed t) at tests/test_softao.py's cross-path
    tolerance."""
    plan, tables = world
    img = _img(plan, tables, CFG.replace(**MODES[mode]))
    np.testing.assert_allclose(img, jax_images[0][mode], atol=IMG_ATOL)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_zero_k_and_ao_is_the_reference_path(world, backend, monkeypatch):
    """soft_shadow_k = 0 and ao_strength = 0 are the reference shading bit
    for bit, and the fused path takes the reference entries (no extended
    twin runs)."""
    plan, tables = world
    base = _img(plan, tables, CFG, backend)
    assert not shk.extended(plan, _port(CFG))
    off = _img(plan, tables, CFG.replace(soft_shadow_k=0.0, ao_strength=0.0),
               backend)
    assert np.array_equal(base, off)
    # without shadows soft_shadow_k has nothing to soften
    flat = CFG.replace(shadows=False)
    assert np.array_equal(_img(plan, tables, flat, backend),
                          _img(plan, tables, flat.replace(soft_shadow_k=8.0),
                               backend))


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_huge_k_converges_to_hard_shadow(world, backend):
    plan, tables = world
    hard = _img(plan, tables, CFG, backend)
    soft = _img(plan, tables, CFG.replace(soft_shadow_k=1e6), backend)
    np.testing.assert_allclose(soft, hard, atol=1e-5)


def test_ao_darkens_and_factors_come_out(world):
    """AO scales the clamped light by a factor in [0, 1]; K1's twin hands
    the factors out (sfac [L, R] zero where a light is shadowed, aofac
    [R]) and K4's twin on K1's hits gives the same bits."""
    plan, tables = world
    cfg = _port(CFG.replace(soft_shadow_k=4.0, ao_strength=2.0,
                            ao_delta=0.3))
    tt = tables_to_torch(tables, "cpu")
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    out, fac = render_rays(plan, cfg, tt, origin, dirs, save_factors=True)
    assert fac.sfac.shape == (2, dirs.shape[0])
    assert fac.aofac.shape == (dirs.shape[0],)
    assert ((fac.aofac >= 0) & (fac.aofac <= 1)).all()
    assert fac.aofac.min() < 0.95
    for li in range(2):
        shadowed = ((out.smask >> li) & 1) == 1
        assert (fac.sfac[li][shadowed] == 0).all()
    assert ((fac.sfac > 0) & (fac.sfac < 1)).any()
    o4, f4 = shk.shade_rays_plain(plan, cfg, tt, out.p, out.sd, dirs,
                                  save_factors=True)
    for a, b in zip((*o4, *f4), (out.cidx, out.light, out.smask, *fac)):
        assert torch.equal(a, b)
    base = render_rays_plain(plan, cfg.replace(ao_strength=0.0), tt,
                             origin, dirs)
    assert (out.light <= base.light + 1e-6).all()


GRAD_CASES = {"fd": dict(normal_mode="fd"),
              "analytic": dict(normal_mode="analytic"),
              "fused-analytic": dict(normal_mode="analytic",
                                     fused_generators=True)}


@pytest.fixture(scope="module", params=sorted(GRAD_CASES))
def grads(request):
    """JAX's mega gradients (interpret mode) of mean(img^2) with soft
    shadows (k 6) and AO (0.8), and the port's through FusedRender."""
    case = request.param
    plan, tables = _world(generator=case == "fused-analytic")
    cfg = CFG.replace(soft_shadow_k=6.0, ao_strength=0.8, **GRAD_CASES[case])
    want = jax.grad(lambda t: jnp.mean(jax_render_tables(
        plan, t, cfg, backend="mega", interpret=True,
        differentiable=True) ** 2))(tables)
    tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
    img = rt.render_tables(plan, tt, _port(cfg), differentiable=True,
                           device="cpu")
    got = torch.autograd.grad(torch.mean(img * img), list(tt),
                              allow_unused=True, materialize_grads=True)
    return ({f: v.numpy().astype(np.float64) for f, v in zip(FIELDS, got)},
            {f: np.asarray(getattr(want, f), np.float64) for f in FIELDS})


@pytest.mark.parametrize("field", ["prim_pos", "prim_aux", "prim_color",
                                   "light_pos", "cam_position",
                                   "cam_direction", "cam_fov"])
def test_soft_ao_gradients_match_jax_mega(grads, field):
    """The FD backward (one K2 stencil launch on the card), the analytic
    one and the fused analytic one (the winner residuals, no launch), each
    replaying K1's penumbra and occlusion factors as constants, against
    JAX's mega backward at tests/test_mega.py:62's tolerance."""
    got, want = grads
    a, b = got[field], want[field]
    assert np.isfinite(a).all()
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=field)


def test_fused_analytic_backward_replays_saved_factors(monkeypatch):
    """The fused analytic backward with the forward's residuals evaluates
    nothing, soft shadows and AO on; the factors it replays are K1's."""
    plan, tables = _world(generator=True)
    cfg = _port(CFG.replace(soft_shadow_k=6.0, ao_strength=0.8,
                            normal_mode="analytic", fused_generators=True))
    calls = []
    for name in ("winner_eval", "fused_winner_eval", "stencil_eval"):
        fn = getattr(render_op, name)
        monkeypatch.setattr(render_op, name,
                            lambda *a, _f=fn, **k: calls.append(1) or _f(*a,
                                                                        **k))
    tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
    img = rt.render_tables(plan, tt, cfg, differentiable=True, device="cpu")
    g = torch.autograd.grad(torch.mean(img * img), tt.prim_pos)[0]
    assert calls == [] and torch.isfinite(g).all() and g.abs().max() > 0
