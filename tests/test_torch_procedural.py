"""Procedural fractal leaves (the Mandelbox, Mandelbulb and Julia DEs) in
the port against the JAX package, on the CPU: the DEs and their gradients
against ``core.sdf``'s and the kernels' forward-mode sweeps (y-axis and
centre points included), the kernels' plain twin ``kernel_fold`` in all
five of K2's modes against the JAX surface kernel (Pallas interpret mode),
the size cotangent of the winner scatter against autograd, images of the
``cuda`` twin, ``multi`` and ``ref`` against JAX's ``ref`` and ``mega``
(the scenes/*.txt files render through every entry point in
tests/test_torch_cli_serve.py),
the fused backward's gradients (exact FD, exact analytic, fused analytic)
against JAX's ``mega`` backward, and a two-step fit.  The kernels
themselves are held to their twins on the card by
tests/test_torch_kernel_cuda.py.

The JAX side is the expensive half (a ``mega`` render in interpret mode
compiles the whole unrolled fractal iteration): each JAX result is computed
once, in a module fixture, on small worlds with few fractal iterations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402
from raymarching_tpu.core import sdf as jsdf  # noqa: E402
from raymarching_tpu.ops import pallas_march as pm  # noqa: E402
from raymarching_tpu.ops.pallas_march import pallas_surface_eval  # noqa: E402
from raymarching_tpu.scene.compile import SceneTables, compile_tree  # noqa: E402
from raymarching_tpu.scene.csg import (Box, Julia, ListNode,  # noqa: E402
                                       Mandelbox, Mandelbulb, Mode, bounds)
from raymarching_tpu.scene.objects import Camera, Light  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.core import proc as tproc  # noqa: E402
from raymarching_tpu_torch.core.sdf import LeafCount, scene_sd  # noqa: E402
from raymarching_tpu_torch.ops import scene_vjp as tvjp  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.tables import (scene_operands,  # noqa: E402
                                          tables_to_torch)
from test_scene_vjp import _tie_free  # noqa: E402

FIELDS = SceneTables._fields
KINDS = ("mb", "bulb", "julia")
# one leaf of each kind, with scenes/*.txt's parameters
LEAVES = {"mb": Mandelbox((0.0, 0.0, -8.0), 1.0, 2.0, 9),
          "bulb": Mandelbulb((0.0, 0.0, -6.0), 1.5, 8),
          "julia": Julia((0.0, 0.0, -5.0), 1.3, (-0.2, 0.6, 0.2, 0.2), 11)}
JAX_SD = {"mb": jsdf.mandelbox_sd, "bulb": jsdf.mandelbulb_sd,
          "julia": jsdf.julia_sd}
JAX_GRAD = {"mb": pm._mandelbox_sd_grad, "bulb": pm._mandelbulb_sd_grad,
            "julia": pm._julia_sd_grad}
# tests/test_mandelbulb.py's tolerances: the DE (:76) and its gradient
# (:91, 8th-degree recurrences amplify float32 roundoff between two orders
# of operations)
SD_RTOL, G_RTOL = 1e-5, 2e-3
# images against JAX (tests/test_mandelbulb.py:180-182) and gradients
# against JAX's mega backward (:288).  An FD normal on a fractal's crease
# turns an ulp of SD into a visible shade: in the Mandelbox world below
# JAX's own mega and ref images differ by 4.7e-3 at one pixel of 192, so
# the images are held to IMG_ATOL on IMG_SHARE of the pixels and to ten
# times it everywhere (the repo's agreement-share rule for cross-package
# images).
IMG_ATOL, IMG_SHARE = 1e-3, 0.99
GRAD_RTOL, GRAD_ATOL_SCALE = 0.05, 0.01
CFG = RenderConfig(width=16, height=12, ssaa=1, iterations=100)


def _param(leaf):
    if isinstance(leaf, Mandelbox):
        return leaf.scale
    if isinstance(leaf, Mandelbulb):
        return float(leaf.power)
    return tuple(leaf.c)


N_AXIS = 5


def _points(leaf, n=192, seed=0):
    """Seeded points round the leaf, then N_AXIS points on its local
    y-axis, its centre among them (the Mandelbulb's 0/0 and every DE's
    fixed point): kinks of the folds, where the two packages may take
    other subgradients (tests/test_mandelbulb.py:99 holds them finite)."""
    rng = np.random.default_rng(seed)
    c = np.asarray(leaf.position, np.float32)
    p = (rng.normal(size=(n, 3)) * leaf.size + c).astype(np.float32)
    axis = np.array([[c[0], c[1] + dy * leaf.size, c[2]] for dy in
                     (-2.0, -0.5, 0.0, 0.4, 1.5)], np.float32)
    return np.concatenate([p, axis])


def _port_de(kind, pts, grad=False):
    leaf = LEAVES[kind]
    spec = (0, kind, _param(leaf), leaf.iterations)
    c = torch.tensor(leaf.position, dtype=torch.float32)
    s = torch.tensor(leaf.size, dtype=torch.float32)
    p = torch.as_tensor(pts).requires_grad_(grad)
    return spec, c, s, p, tproc.proc_sd(spec, p, c, s)


@pytest.mark.parametrize("kind", KINDS)
def test_de_values_match_jax(kind):
    leaf = LEAVES[kind]
    pts = _points(leaf)
    *_, sd = _port_de(kind, pts)
    want = np.asarray(JAX_SD[kind](
        jnp.asarray(pts), jnp.asarray(leaf.position, jnp.float32),
        jnp.float32(leaf.size), _param(leaf), leaf.iterations))
    assert np.isfinite(sd.numpy()).all()
    np.testing.assert_allclose(sd.numpy(), want, rtol=SD_RTOL, atol=SD_RTOL)


@pytest.mark.parametrize("kind", KINDS)
def test_de_gradients_match_jax(kind):
    """Autograd of the port's DE against jax.grad of JAX's, and the port's
    forward-mode sweep (the kernels' gradient) against JAX's kernel sweep;
    finite on the y-axis and at the centre."""
    leaf = LEAVES[kind]
    pts = _points(leaf, seed=1)
    spec, c, s, p, sd = _port_de(kind, pts, grad=True)
    (g_ad,) = torch.autograd.grad(sd.sum(), p)
    c_j, s_j = jnp.asarray(leaf.position, jnp.float32), jnp.float32(leaf.size)
    want = np.asarray(jax.vmap(jax.grad(lambda q: JAX_SD[kind](
        q[None], c_j, s_j, _param(leaf), leaf.iterations)[0]))(
            jnp.asarray(pts)))
    assert np.isfinite(g_ad.numpy()).all()
    np.testing.assert_allclose(g_ad.numpy()[:-N_AXIS], want[:-N_AXIS],
                               rtol=G_RTOL, atol=G_RTOL)
    jet = tproc.proc_grad(spec, p.detach(), c, s).numpy()
    tbl = jnp.asarray(np.array([[*leaf.position, leaf.size, 0.0, 0.0]],
                               np.float32))
    _, gx, gy, gz = JAX_GRAD[kind](tbl, 0, *(jnp.asarray(pts[:, a])
                                             for a in range(3)),
                                   _param(leaf), leaf.iterations)
    assert np.isfinite(jet).all()
    np.testing.assert_allclose(jet[:-N_AXIS],
                               np.stack([gx, gy, gz], -1)[:-N_AXIS],
                               rtol=G_RTOL, atol=G_RTOL)


def _world(kinds=KINDS, iters=None, generator=False):
    """A floor and the fractals ``kinds`` side by side (with ``iters`` each
    its iteration count, to keep JAX's interpret mode small), two lights;
    with ``generator`` a Menger sponge beside them (fused generators)."""
    from raymarching_tpu.scene.generators import menger_sponge
    xs = {"mb": -2.6, "bulb": 0.0, "julia": 2.6}
    leaves = [bounds(60.0), Box((0.0, -2.2, -5.0), (14.0, 0.5, 14.0),
                                color=(0.6, 0.6, 0.9))]
    for k in kinds:
        leaf = LEAVES[k]
        pos = (xs[k] if len(kinds) > 1 else 0.0, 0.0, -5.0)
        n = iters or leaf.iterations
        leaves.append(
            Mandelbox(pos, 1.0, 2.0, n, color=(0.9, 0.75, 0.45))
            if k == "mb" else
            Mandelbulb(pos, 1.2, n, color=(0.45, 0.7, 0.95)) if k == "bulb"
            else Julia(pos, 1.1, leaf.c, n, color=(0.9, 0.55, 0.25)))
    if generator:
        leaves.append(menger_sponge((2.4, -1.0, -6.5), 1.6, 2))
    return compile_tree(ListNode(Mode.UNION, leaves),
                        [Light((5.0, 8.0, 4.0)), Light((-4.0, 5.0, 2.0))],
                        Camera(position=(0.0, 1.0, 0.0), fov=45.0))


# JAX flags of pallas_surface_eval for each of K2's modes
JAX_MODE = {sk.SD: dict(with_color=False, with_normal=False),
            sk.WINNER: dict(with_color=True, with_normal=False),
            sk.FD_GRAD: dict(with_color=False, with_normal=True),
            sk.COMBINED: dict(with_color=True, with_normal=True,
                              analytic=True),
            sk.ANALYTIC: dict(with_color=False, with_normal=True,
                              analytic=True)}


@pytest.fixture(scope="module")
def surface_world():
    plan, tables = _world(iters=3)
    p = np.random.default_rng(2).uniform(
        [-4.0, -1.8, -7.0], [4.0, 1.8, -3.0], (256, 3)).astype(np.float32)
    clean = np.asarray(_tie_free(plan, tables, jnp.asarray(p)))
    return plan, tables, p, clean


@pytest.mark.parametrize("mode", sorted(JAX_MODE))
def test_kernel_fold_matches_jax_surface_kernel(surface_world, mode):
    """K2's plain twin (core.sdf.kernel_fold: the value fold, the winner
    fold, the jet sweep of a procedural winner) against JAX's surface
    kernel in interpret mode, off the tie sets."""
    plan, tables, p, clean = surface_world
    sd_j, w_j, g_j = (None if v is None else np.asarray(v) for v in
                      pallas_surface_eval(plan.kernel, CFG.fd_h,
                                          CFG.tile_sublanes, jnp.asarray(p),
                                          tables, interpret=True,
                                          **JAX_MODE[mode]))
    tt = tables_to_torch(tables, "cpu")
    sd, w, g = sk.surface_eval(plan, tt, torch.as_tensor(p), mode=mode,
                               fd_h=CFG.fd_h)
    assert clean.mean() > 0.9
    np.testing.assert_allclose(sd.numpy(), sd_j, rtol=SD_RTOL, atol=SD_RTOL)
    if w_j is not None:
        np.testing.assert_array_equal(w.numpy()[clean], w_j[clean])
    if g_j is None:
        return
    g = g.numpy()
    assert np.isfinite(g).all()
    if mode == sk.FD_GRAD:
        # an ulp of SD over 2 fd_h: 4 ulps of |SD| per point
        atol = np.maximum(1e-3, 4 * np.spacing(np.abs(sd_j)) / (2 * CFG.fd_h))
        assert (np.abs(g - g_j)[clean] <= atol[clean, None]).all()
    else:
        np.testing.assert_allclose(g[clean], g_j[clean], rtol=G_RTOL,
                                   atol=G_RTOL)
    # every procedural winner was seen
    if mode == sk.COMBINED:
        assert {leaf for leaf, *_ in plan.proc} <= set(w.numpy().tolist())


def test_packing_and_leaf_count(surface_world):
    """The procedural runs and rows the kernels read, and LeafCount's
    operations: a procedural leaf evaluation costs its DE's count."""
    plan, tables, p, _ = surface_world
    tt = tables_to_torch(tables, "cpu")
    ops = scene_operands(plan, tt, "cpu")
    P = tt.prim_pos.shape[0]
    assert ops.proc == 1 and ops.args()[-1] == 2 + ops.fused
    assert ops.table.shape == (P + len(plan.proc), 8)
    types = {int(r[1]): int(r[0]) for r in ops.runs.tolist()}
    for k, (leaf, kind, param, iters) in enumerate(plan.proc):
        assert types[leaf] == {"mb": 3, "bulb": 4, "julia": 5}[kind]
        assert ops.table[leaf, 6] == iters and ops.table[leaf, 7] == P + k
        want = param if kind == "julia" else (param, 0.0, 0.0, 0.0)
        np.testing.assert_array_equal(ops.table[P + k, :4].numpy(),
                                      np.float32(want))
    q = torch.as_tensor(p[:16])
    with LeafCount() as count:
        sk.surface_eval(plan, tt, q, mode=sk.SD)
    extra = sum(tproc.value_ops(kind, iters) - 12
                for (_, kind, _, iters) in plan.proc)
    assert count.ops == 12 * count.leaves + 16 * extra


def test_size_cotangent_matches_autograd(surface_world):
    """The winner scatter's procedural size column (homogeneity: d scene /
    ds = (scene - g . (p - c)) / s) and position column against autograd
    of sum(u * scene_sd) at fixed points, and against JAX's scatter."""
    from raymarching_tpu.ops import scene_vjp as jvjp
    plan, tables, p, clean = surface_world
    p = p[clean]
    u = np.random.default_rng(11).uniform(-1, 1, p.shape[0]).astype(
        np.float32)
    tt = tables_to_torch(tables, "cpu", requires_grad=("prim_pos",
                                                       "prim_aux"))
    q = torch.as_tensor(p)
    sd, widx, g = sk.surface_eval(plan, tt, q)
    got = tvjp.theta_cotangents(plan, tt, widx, g, torch.as_tensor(u), sd, q)
    with pytest.raises(ValueError, match="sd and p"):
        tvjp.theta_cotangents(plan, tt, widx, g, torch.as_tensor(u))
    want = torch.autograd.grad((torch.as_tensor(u) * scene_sd(plan, tt, q)
                                ).sum(), (tt.prim_pos, tt.prim_aux))
    jax_ct = jvjp.theta_cotangents(plan, tables, jnp.asarray(widx.numpy()),
                                   jnp.asarray(g.numpy()), jnp.asarray(u),
                                   sd=jnp.asarray(sd.numpy()),
                                   p=jnp.asarray(p))
    for a, b, j in zip(got, want, (jax_ct.prim_pos, jax_ct.prim_aux)):
        a, b = a.detach().numpy(), b.numpy()
        scale = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(a, b, rtol=G_RTOL, atol=G_RTOL * scale)
        np.testing.assert_allclose(a, np.asarray(j), rtol=1e-4,
                                   atol=1e-5 * scale)
    leaves = [leaf for leaf, *_ in plan.proc]
    assert (got[1][leaves, 0].abs() > 0).all()


def _port_cfg(cfg: RenderConfig) -> rt.RenderConfig:
    return rt.RenderConfig(**{f: getattr(cfg, f)
                              for f in cfg.__dataclass_fields__})


@pytest.fixture(scope="module", params=KINDS)
def images(request):
    """A world of one fractal (few iterations): JAX's ref image and its
    mega image in interpret mode, and the port's images of each backend."""
    plan, tables = _world((request.param,), iters=3)
    cfg = CFG.replace(iterations=60)
    want = {b: np.asarray(jax_render_tables(plan, tables, cfg, backend=b,
                                            interpret=b == "mega"))
            for b in ("ref", "mega")}
    got = {b: rt.render_tables(plan, tables, _port_cfg(cfg), backend=b,
                               device="cpu").numpy()
           for b in ("cuda", "multi", "ref")}
    return want, got


@pytest.mark.parametrize("backend", ["cuda", "multi", "ref"])
def test_images_match_jax(images, backend):
    """K1's plain twin (the kernels' value and winner folds with the
    procedural runs), the multi-kernel backend and the ref oracle against
    JAX's ref and its mega kernel in interpret mode."""
    want, got = images
    img = got[backend]
    assert np.isfinite(img).all() and (img.sum(-1) > 0).mean() > 0.2
    for b in ("ref", "mega"):
        diff = np.abs(img - want[b]).max(axis=-1)
        assert diff.max() <= 10 * IMG_ATOL, (b, diff.max())
        assert (diff <= IMG_ATOL).mean() >= IMG_SHARE, b


GRAD_CASES = {"fd": dict(normal_mode="fd"),
              "analytic": dict(normal_mode="analytic"),
              "fused-analytic": dict(normal_mode="analytic",
                                     fused_generators=True)}


@pytest.fixture(scope="module", params=sorted(GRAD_CASES))
def grads(request):
    """JAX's mega gradients (interpret mode) of mean(img^2) on a Julia
    world (with a Menger sponge beside it in the fused case), and the
    port's through FusedRender: the exact FD backward (the stencil scatter
    with the size columns), the exact analytic one (the replay of the
    normal, the implicit-function route through K2's combined mode) and
    the fused analytic one (the replay on the fused field)."""
    case = request.param
    plan, tables = _world(("julia",), iters=3,
                          generator=case == "fused-analytic")
    cfg = CFG.replace(iterations=60, shadows=False, **GRAD_CASES[case])
    want = jax.grad(lambda t: jnp.mean(jax_render_tables(
        plan, t, cfg, backend="mega", interpret=True,
        differentiable=True) ** 2))(tables)
    tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
    img = rt.render_tables(plan, tt, _port_cfg(cfg), differentiable=True,
                           device="cpu")
    got = torch.autograd.grad(torch.mean(img * img), list(tt),
                              allow_unused=True, materialize_grads=True)
    return (plan, {f: v.numpy().astype(np.float64) for f, v in
                   zip(FIELDS, got)},
            {f: np.asarray(getattr(want, f), np.float64) for f in FIELDS})


@pytest.mark.parametrize("field", ["prim_pos", "prim_aux", "prim_color",
                                   "light_pos", "cam_position"])
def test_gradients_match_jax_mega(grads, field):
    """The port's backward against JAX's mega backward (without shadows,
    as tests/test_mandelbulb.py's gradient configuration), every field at
    tests/test_mandelbulb.py:288's tolerance; the fractal leaf's rows get
    a gradient."""
    plan, got, want = grads
    a, b = got[field], want[field]
    assert np.isfinite(a).all()
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SCALE * scale, err_msg=field)
    if field in ("prim_pos", "prim_aux"):
        (leaf, *_), = plan.proc
        assert np.abs(a[leaf]).max() > 0


def test_fit_julia_two_steps(scenes_dir):
    """Two Adam steps of ``fit`` on scenes/julia.txt with the Julia leaf
    moved and resized: finite losses, and the leaf's rows move."""
    plan, tables = rt.compile_scene(rt.load_scene(str(scenes_dir /
                                                      "julia.txt")))
    cfg = rt.RenderConfig(width=16, height=12, ssaa=1, iterations=100)
    target = rt.render_tables(plan, tables, cfg, device="cpu")
    (leaf, *_), = plan.proc
    pos, aux = tables.prim_pos.copy(), tables.prim_aux.copy()
    pos[leaf] += (0.1, -0.05, 0.0)
    aux[leaf, 0] *= 1.05
    start = tables._replace(prim_pos=pos, prim_aux=aux)
    res = rt.fit(plan, start, target, cfg, device="cpu", steps=2, lr=1e-2,
                 trainable=("prim_pos", "prim_aux"))
    assert res.steps == 2 and np.isfinite(res.losses).all()
    assert res.losses[0] > 0
    assert not np.array_equal(res.tables.prim_pos[leaf].numpy(), pos[leaf])
    assert res.tables.prim_aux[leaf, 0].item() != aux[leaf, 0]


def test_pack_plan_refuses_unknown_run_types(scenes_dir):
    """The kernels' folds take the dense types and the procedural ones and
    nothing else (fold.cuh's switches fold no other type): pack_plan
    raises on any other run type instead of packing it."""
    import dataclasses
    from raymarching_tpu_torch.tables import pack_plan
    plan, _ = rt.compile_scene(rt.load_scene(str(scenes_dir / "julia.txt")))
    kp = plan.kernel
    g = kp.groups[-1]
    bad = dataclasses.replace(g, runs=g.runs[:-1] + ((7,) + g.runs[-1][1:],))
    with pytest.raises(ValueError, match="run type"):
        pack_plan(dataclasses.replace(kp, groups=kp.groups[:-1] + (bad,)))


@pytest.mark.parametrize("change", [
    dict(reflect_strength=0.3, reflect_bounces=1),
    dict(reflect_strength=0.3, reflect_bounces=1, normal_mode="analytic"),
    dict(soft_shadow_k=6.0, ao_strength=0.8, normal_mode="analytic"),
    dict(aperture=0.2, focus_dist=5.0)])
def test_fractal_with_extensions_trains(change):
    """Mirror bounces (the anchored replay through leaf_sd's procedural
    column), soft shadows and AO, and a thin lens on a fractal world: the
    differentiable render is finite and the fractal leaf's rows get a
    gradient."""
    plan, tables = _world(("julia",), iters=3)
    cfg = _port_cfg(CFG.replace(width=12, height=8, iterations=60, **change))
    tt = tables_to_torch(tables, "cpu", requires_grad=("prim_pos",
                                                       "prim_aux"))
    img = rt.render_tables(plan, tt, cfg, differentiable=True, device="cpu")
    assert torch.isfinite(img).all() and img.max() > 0
    gp, ga = torch.autograd.grad(torch.mean(img * img),
                                 (tt.prim_pos, tt.prim_aux))
    (leaf, *_), = plan.proc
    assert torch.isfinite(gp).all() and torch.isfinite(ga).all()
    assert gp[leaf].abs().max() > 0 and ga[leaf, 0] != 0
