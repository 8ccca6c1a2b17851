"""The analytic-normal regime of the port against the JAX package, on the
CPU (the kernels' plain twins): K2's gradient-only analytic mode against
JAX's gradient-only ``pallas_surface_eval`` (interpret mode), the winner
Hessian chain and the analytic normal's backward against JAX's, the
``ref``, ``cuda`` and ``multi`` images against JAX's jnp analytic render,
end-to-end gradients of every SceneTables field against JAX's, the winner
residuals the fused forward saves, the backward that launches no kernel
with them, and a logged ``fit`` step.  The kernels themselves are held to
these twins on the card by tests/test_torch_kernel_cuda.py."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402
from raymarching_tpu.ops import scene_vjp as jvjp  # noqa: E402
from raymarching_tpu.ops.pallas_march import pallas_surface_eval  # noqa: E402
from raymarching_tpu.scene.compile import SceneTables, compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
from raymarching_tpu_torch.ops import render_op  # noqa: E402
from raymarching_tpu_torch.ops import scene_vjp as tvjp  # noqa: E402
from raymarching_tpu_torch.ops import shade_kernel as shk  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.ops.normal_op import normal_op  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402
from raymarching_tpu_torch.utils import structlog  # noqa: E402
from test_scene_vjp import _points, _tie_free, _world  # noqa: E402
from test_torch_surface import _demo_points  # noqa: E402

FIELDS = SceneTables._fields
# tests/test_mega.py:176-177: the analytic image rule (share of pixels
# under IMG_ATOL, median under IMG_MEDIAN) and :198-200 the gradient rule
IMG_ATOL, IMG_SHARE, IMG_MEDIAN = 5e-3, 0.99, 1e-4
RTOL, ATOL_SCALE = 0.02, 0.005
# tests/test_torch_surface.py's SD and gradient tolerances: a sphere's
# (p - c) / |p - c| comes out of XLA's CPU code an ulp or two off PyTorch's
SD_RTOL, SD_ATOL, G_ATOL = 5e-6, 1e-5, 1e-6
GREY = 0.25
CFGS = {
    "world": RenderConfig(width=16, height=16, ssaa=1, iterations=60,
                          shadows=True, normal_mode="analytic"),
    "demo": RenderConfig(width=24, height=16, ssaa=1, iterations=80,
                         normal_mode="analytic"),
}


def _scene(name, scenes_dir):
    if name == "world":
        return _world()
    return compile_scene(load_scene(str(scenes_dir / "demo.txt")))


def _scene_points(name):
    return np.array(_points()) if name == "world" else _demo_points()


@pytest.fixture(scope="module", params=sorted(CFGS))
def case(request, scenes_dir):
    plan, tables = _scene(request.param, scenes_dir)
    return request.param, plan, tables, CFGS[request.param]


def test_analytic_mode_matches_jax_gradient_only_kernel(case):
    """K2's gradient-only analytic mode (its plain twin) against JAX's
    gradient-only fold (_scene_sd_grad_tile: the gradient carried through
    every select, the lattice collapse's own gradient on the sponge) off
    the tie sets; SD and gradient are the combined mode's, bitwise."""
    name, plan, tables, cfg = case
    p = _scene_points(name)
    sd_j, w_j, g_j = pallas_surface_eval(
        plan.kernel, cfg.fd_h, cfg.tile_sublanes, jnp.asarray(p), tables,
        with_color=False, with_normal=True, analytic=True, interpret=True)
    assert w_j is None
    tt = tables_to_torch(tables, "cpu")
    before = sk.surface_eval.launches
    sd, w, g = sk.surface_eval(plan, tt, torch.as_tensor(p), mode=sk.ANALYTIC)
    assert sk.surface_eval.launches == before and w is None
    np.testing.assert_allclose(sd.numpy(), np.asarray(sd_j), rtol=SD_RTOL,
                               atol=SD_ATOL)
    clean = np.asarray(_tie_free(plan, tables, jnp.asarray(p)))
    assert clean.mean() > 0.9
    np.testing.assert_allclose(g.numpy()[clean], np.asarray(g_j)[clean],
                               rtol=0, atol=G_ATOL)
    sd_c, _, g_c = sk.surface_eval(plan, tt, torch.as_tensor(p))
    assert torch.equal(sd, sd_c) and torch.equal(g, g_c)
    # the leaf fold gives the same bits (its winner may be another cross
    # of a tie class, whose gradient is the same)
    sd_l, _, g_l = sk.surface_eval(plan, tt, torch.as_tensor(p),
                                   mode=sk.ANALYTIC, collapse=False)
    assert torch.equal(sd, sd_l) and torch.equal(g, g_l)


def test_winner_hessian_chain_matches_jax(case):
    """The closed-form winner Hessian chain on the same (widx, g, gbar,
    sd), and the analytic normal's backward (one combined launch, the
    chain, one scatter) against JAX's analytic_normal_bwd."""
    name, plan, tables, cfg = case
    p = _scene_points(name)
    gbar = np.random.default_rng(3).normal(size=p.shape).astype(np.float32)
    sd, widx, g = jvjp.winner_eval(plan, cfg, jnp.asarray(p), tables, True)
    want = jvjp.winner_hessian_chain(plan, tables, widx, g,
                                     jnp.asarray(gbar), sd)
    tt = tables_to_torch(tables, "cpu")
    got = tvjp.winner_hessian_chain(
        plan, tt, *(torch.as_tensor(np.array(v)) for v in (widx, g)),
        torch.as_tensor(gbar), torch.as_tensor(np.array(sd)))
    for a, b in zip(got, want):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * scale)
    assert (got[2] >= 0).any() and (got[2] < 0).any()
    pb_j, tb_j = jvjp.analytic_normal_bwd(plan, cfg, True, jnp.asarray(p),
                                          tables, jnp.asarray(gbar))
    pb_t, pos_t = tvjp.analytic_normal_bwd(plan, tt, torch.as_tensor(p),
                                           torch.as_tensor(gbar))
    clean = np.asarray(_tie_free(plan, tables, jnp.asarray(p)))
    np.testing.assert_allclose(pb_t.numpy()[clean], np.asarray(pb_j)[clean],
                               rtol=1e-5, atol=1e-6)
    pos_j = np.asarray(tb_j.prim_pos)
    np.testing.assert_allclose(pos_t.numpy(), pos_j, rtol=1e-4,
                               atol=1e-5 * max(np.abs(pos_j).max(), 1e-8))


@pytest.mark.parametrize("backend", ["ref", "cuda", "multi"])
def test_analytic_images_match_jax_jnp(case, backend):
    """Every backend's analytic image against JAX's jnp analytic render
    (autodiff of the field), by tests/test_mega.py's agreement rule: the
    kernels' winner is first-wins where jnp splits ties."""
    name, plan, tables, cfg = case
    want = np.asarray(jax_render_tables(plan, tables, cfg, backend="jnp"))
    img = rt.render_tables(plan, tables, cfg, backend=backend, device="cpu")
    diff = np.abs(img.numpy() - want).max(axis=-1)
    assert (diff < IMG_ATOL).mean() > IMG_SHARE, (diff >= IMG_ATOL).sum()
    assert np.median(diff) < IMG_MEDIAN
    assert img.max() > 0
    # and it is the analytic regime: the FD image differs somewhere
    fd = rt.render_tables(plan, tables, cfg.replace(normal_mode="fd"),
                          backend=backend, device="cpu")
    assert not torch.equal(img, fd)


@pytest.fixture(scope="module")
def grads(case):
    name, plan, tables, cfg = case

    @jax.jit
    def jax_grads(t):
        img, vjp = jax.vjp(lambda t_: jax_render_tables(
            plan, t_, cfg, backend="jnp", differentiable=True), t)
        return [vjp(2.0 * (img - y) / img.size)[0] for y in (0.0, GREY)]

    want = [[np.asarray(v, np.float64) for v in g]
            for g in jax_grads(tables)]
    got = {}
    for backend in ("cuda", "multi"):
        tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
        img = rt.render_tables(plan, tt, cfg, backend=backend,
                               differentiable=True, device="cpu")
        got[backend] = []
        for y in (0.0, GREY):
            g = torch.autograd.grad(torch.mean((img - y) ** 2), tt,
                                    retain_graph=True, allow_unused=True,
                                    materialize_grads=True)
            got[backend].append([v.numpy().astype(np.float64) for v in g])
    return name, plan, got, want


def _carve_rows(plan):
    g = max(plan.kernel.groups, key=lambda g: g.count)
    return slice(g.start + 1, g.start + g.count)


@pytest.mark.parametrize("backend", ["cuda", "multi"])
@pytest.mark.parametrize("loss", ["img^2", "grey"])
@pytest.mark.parametrize("field", FIELDS)
def test_analytic_gradients_match_jax_jnp(grads, field, loss, backend):
    """tests/test_torch_grad.py's comparison in the analytic regime: the
    fused backward (winner residuals, Hessian chain, two scatters) and the
    multi-kernel one (NormalOp's analytic branch) against JAX's jnp
    reverse-over-reverse gradients, at tests/test_mega.py:198-200's
    tolerance; the sponge rows as one sum (their crosses tie, and the
    analytic regime's position gradients are small enough for a split
    tie to show: the world's prim_pos scale is 1.8e-3 here against 0.53
    with FD normals)."""
    name, plan, got, want = grads
    k = ("img^2", "grey").index(loss)
    a, b = got[backend][k][FIELDS.index(field)], want[k][FIELDS.index(field)]
    assert np.isfinite(a).all()
    scale = max(np.abs(b).max(), 1e-8)
    if field in ("prim_pos", "prim_aux"):
        carve = _carve_rows(plan)
        np.testing.assert_allclose(a[carve].sum(axis=0), b[carve].sum(axis=0),
                                   rtol=RTOL, atol=ATOL_SCALE * scale,
                                   err_msg=f"{field} carve sum")
        a = np.delete(a, np.arange(a.shape[0])[carve], axis=0)
        b = np.delete(b, np.arange(b.shape[0])[carve], axis=0)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=field)


def _rays(plan, tables, cfg):
    tt = tables_to_torch(tables, "cpu")
    origin, dirs = cam.generate_rays(tt, cfg)
    return tt, origin, dirs.reshape(-1, 3)


@pytest.mark.parametrize("two_phase", [0, 8])
def test_saved_residuals_equal_a_fresh_winner_eval(case, two_phase):
    """The winner residuals of K1's twin (and of K4's, on the two-phase
    path) are bitwise those of a fresh K2 combined evaluation at the hit
    points, and the rest of the outputs those of a render without them."""
    name, plan, tables, cfg = case
    cfg = cfg.replace(two_phase_k1=two_phase)
    tt, origin, dirs = _rays(plan, tables, cfg)
    out, winner = rk.render_rays(plan, cfg, tt, origin, dirs,
                                 save_winner=True)
    assert isinstance(winner, shk.Winner)
    for a, b in zip(out, rk.render_rays(plan, cfg, tt, origin, dirs)):
        assert torch.equal(a, b)
    fresh = tvjp.winner_eval(plan, tt, out.p)
    for a, b in zip(winner, fresh):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (winner.widx >= 0).all()
    sh, w4 = shk.shade_rays(plan, cfg, tt, out.p, out.sd, dirs,
                            save_winner=True)
    for a, b in zip((*sh, *w4), (out.cidx, out.light, out.smask, *winner)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="analytic"):
        rk.render_rays(plan, cfg.replace(normal_mode="fd"), tt, origin, dirs,
                       save_winner=True)


def test_fused_backward_with_residuals_evaluates_nothing(case, monkeypatch):
    """With the forward's residuals the fused analytic backward calls no
    scene evaluation (on the card: launches no kernel); without them it
    calls winner_eval once, and the gradients are the same bits."""
    name, plan, tables, cfg = case
    calls = []

    def counted(fn):
        def wrapper(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(render_op, "winner_eval",
                        counted(render_op.winner_eval))
    monkeypatch.setattr(render_op, "stencil_eval",
                        counted(render_op.stencil_eval))
    grads = {}
    for save in (True, False):
        monkeypatch.setattr(render_op, "SAVE_WINNER", save)
        calls.clear()
        tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
        img = rt.render_tables(plan, tt, cfg, differentiable=True,
                               device="cpu")
        grads[save] = torch.autograd.grad(
            torch.mean((img - GREY) ** 2), list(tt), allow_unused=True,
            materialize_grads=True)
        assert calls == ([] if save else ["winner_eval"])
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)
    assert grads[True][FIELDS.index("prim_pos")].abs().max() > 0


def test_normal_op_analytic_forward_and_backward(case):
    """NormalOp's analytic branch: forward K2's analytic mode, backward the
    Hessian chain, against autograd through the plain twin's winner
    gradient field (flat boxes and crosses, curved spheres) off ties."""
    name, plan, tables, cfg = case
    p = torch.as_tensor(_scene_points(name))
    clean = torch.as_tensor(np.array(_tie_free(plan, tables,
                                               jnp.asarray(p.numpy()))))
    p = p[clean]
    tt = tables_to_torch(tables, "cpu", requires_grad=("prim_pos",))
    q = p.clone().requires_grad_()
    g = normal_op(plan, cfg, tt, q)
    assert torch.equal(g.detach(), sk.surface_eval(
        plan, tt, p, mode=sk.ANALYTIC)[2])
    gbar = torch.as_tensor(np.random.default_rng(4).normal(
        size=tuple(p.shape)).astype(np.float32))
    p_bar, pos_bar = torch.autograd.grad(g, (q, tt.prim_pos), gbar)
    want_p, want_pos = tvjp.analytic_normal_bwd(plan, tt, p, gbar)
    assert torch.equal(p_bar, want_p) and torch.equal(pos_bar, want_pos)
    # a sphere winner: H gbar = (gbar - u u.gbar) / |p - c|
    P = tt.prim_pos.shape[0]
    _, widx, g0 = sk.surface_eval(plan, tt, p)
    sph = torch.as_tensor(tvjp.leaf_statics(plan)[1][:P])[widx.long()]
    assert sph.any() and (~sph).any()
    assert torch.equal(p_bar[~sph], torch.zeros_like(p_bar[~sph]))
    c = tt.prim_pos.detach()[widx.long()]
    r = (p - c).norm(dim=-1, keepdim=True)
    u = (p - c) / r
    h = (gbar - u * (u * gbar).sum(-1, keepdim=True)) / r
    se = torch.as_tensor(tvjp.leaf_statics(plan)[0][:P])[widx.long()]
    torch.testing.assert_close(p_bar[sph], (se[:, None] * h)[sph],
                               rtol=1e-4, atol=1e-5)


def test_fit_logs_an_analytic_step(case, monkeypatch):
    """``fit`` with analytic normals runs and logs its steps, the loss
    falls on the colours, and only the trainable field moves."""
    name, plan, tables, cfg = case
    target = rt.render_tables(plan, tables, cfg, device="cpu")
    col = np.array(tables.prim_color)
    col[:] = np.clip(col * 0.7 + 0.1, 0.0, 1.0)
    start = tables._replace(prim_color=col)
    monkeypatch.setattr(structlog, "_default", None)
    buf = io.StringIO()
    structlog.configure(stream=buf)
    try:
        res = rt.fit(plan, start, target, cfg, device="cpu", steps=2,
                     lr=5e-2, trainable=("prim_color", "prim_pos"))
    finally:
        structlog.get_logger().close()
    steps = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    steps = [r for r in steps if r["event"] == "fit_step"]
    assert [r["step"] for r in steps] == [0, 1]
    assert [r["loss"] for r in steps] == res.losses
    assert res.losses[1] < res.losses[0]
    np.testing.assert_array_equal(res.tables.prim_aux.numpy(),
                                  np.asarray(tables.prim_aux))
