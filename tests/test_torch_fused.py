"""Fused generators (``RenderConfig.fused_generators``) in the port against
the JAX package, on the CPU (the kernels' plain twins): the fused fold in
every K2 mode against JAX's fused ``pallas_surface_eval`` (interpret
mode), extended winner ids included; ``scene_sd_fused`` and its autograd
gradients against JAX's, the DeathStar radius rule among them; the fused
winner algebra (``fused_theta_cotangents``, ``fused_winner_hessian_chain``)
on JAX's own winner outputs; the two bitwise traps of the carve (rounding
half to even, sizes a staged scene holds halved); and the operation count
of the fused carve.  Images and gradients of whole renders are in
tests/test_torch_fused_render.py; the kernels themselves are held to these
twins on the card by tests/test_torch_kernel_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu.core import sdf as jsdf  # noqa: E402
from raymarching_tpu.ops import scene_vjp as jvjp  # noqa: E402
from raymarching_tpu.ops.pallas_march import pallas_surface_eval  # noqa: E402
from raymarching_tpu.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene, parse_scene  # noqa: E402
from raymarching_tpu_torch.core import sdf as tsdf  # noqa: E402
from raymarching_tpu_torch.ops import scene_vjp as tvjp  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.tables import (fused_groups,  # noqa: E402
                                          pack_plan, tables_to_torch)
from raymarching_tpu import RenderConfig  # noqa: E402

# tests/test_fused_menger.py:73's tolerance for the fused field's values
# (XLA's CPU code and PyTorch's round a few values an ulp apart)
SD_RTOL, SD_ATOL = 5e-6, 1e-5
# the winners' gradients: one-hot signs, and a sphere's unit vector an ulp
# or two apart
G_ATOL = 1e-6
FD_H = 1e-3
DEATHSTAR = "Bounds 40\nLight 5 8 4\nColor 0.3 0.4 0.9\nDeathStar 0 0 -6 2\n"
SCENES = ("demo", "config3", "config4", "menger4", "deathstar")
N = 1500


def _compiled(name, scenes_dir):
    if name == "deathstar":
        return compile_scene(parse_scene(DEATHSTAR))
    return compile_scene(load_scene(str(scenes_dir / f"{name}.txt")))


def _points(plan, tables, n=N, seed=0):
    """Seeded points: a third in a box round each fused generator's base
    (1.3 times its size), the rest over the scene's small objects."""
    rng = np.random.default_rng(seed)
    pos, aux = np.asarray(tables.prim_pos), np.asarray(tables.prim_aux)
    gens = [g for g in plan.kernel.groups if g.fused is not None]
    parts = []
    for g in gens:
        c, s = pos[g.start], aux[g.start, 0]
        reach = 1.3 * s if g.fused[0] == "menger" else 3.0 * s
        parts.append(rng.uniform(c - reach, c + reach,
                                 (n // (3 * len(gens)), 3)))
    small = aux[:, 0] < 50
    lo, hi = pos[small].min(0) - 2, pos[small].max(0) + 2
    parts.append(rng.uniform(lo, hi, (n - sum(len(q) for q in parts), 3)))
    return np.concatenate(parts).astype(np.float32)


def _menger_levels(tt, row, levels, p):
    """[N, levels]: the cross of each level of the folded sponge alone, at
    the point folded into that level's cell (the terms of the carve's
    min)."""
    q = p - tt.prim_pos[row]
    pitch = tt.prim_aux[row, 0] / 3.0
    out = []
    for k in range(levels):
        b = q.abs() - pitch * 0.5
        out.append(tsdf.med3(b[:, 0], b[:, 1], b[:, 2]))
        cell = torch.clamp(torch.round(q / pitch), -1.0, 1.0)
        q = q - cell * pitch
        pitch = pitch / 3.0
    return torch.stack(out, dim=1)


def _tie_free(plan, tables, p, eps=1e-5):
    """Points at which one candidate alone attains the fused field: no
    second leaf of an exact group, and neither a fused group's base and
    carve nor two levels of its folded sponge, within ``eps``."""
    tt = tables_to_torch(tables, "cpu")
    q = torch.as_tensor(p)
    sd = tsdf.scene_sd_fused(plan, tt, q).abs()
    cands = []
    for g in plan.kernel.groups:
        if g.fused is None:
            rows = np.arange(g.start, g.start + g.count)
            cands.append(tsdf.leaf_sd(plan, tt, q, rows).abs())
            continue
        cands.append(tsdf.leaf_sd(plan, tt, q, [g.start]).abs())
        run = tuple(int(v) for v in pack_plan(plan.kernel, True).runs[
            int(pack_plan(plan.kernel, True).groups[
                plan.kernel.groups.index(g)][1]) + 1])
        if g.fused[0] == "deathstar":
            cands.append(tsdf._fused_carve(run, tt, q).abs()[:, None])
            continue
        cands.append(_menger_levels(tt, g.start, g.fused[1], q).abs())
    close = (torch.cat(cands, dim=1) - sd[:, None]).abs() < eps
    return (close.sum(dim=1) <= 1).numpy()


@pytest.fixture(scope="module", params=SCENES)
def case(request, scenes_dir):
    plan, tables = _compiled(request.param, scenes_dir)
    assert fused_groups(plan.kernel)
    return request.param, plan, tables, _points(plan, tables)


MODE_FLAGS = {sk.COMBINED: (True, True, True), sk.SD: (False, False, False),
              sk.WINNER: (True, False, False),
              sk.FD_GRAD: (False, True, False),
              sk.ANALYTIC: (False, True, True)}


@pytest.mark.parametrize("mode", sk.MODES)
def test_fused_modes_match_jax_surface_kernel(case, mode):
    """K2's plain twin on the fused field in each of its five modes against
    JAX's fused surface kernel in interpret mode: SD at tests
    /test_fused_menger.py:73's tolerance, winners (extended carve ids in
    the combined mode, base leaves in the winner mode) equal off tie sets,
    gradients equal where the winners are (FD: 4 ulps of SD over 2 h)."""
    name, plan, tables, p = case
    with_color, with_normal, analytic = MODE_FLAGS[mode]
    sd_j, w_j, g_j = pallas_surface_eval(
        plan.kernel, FD_H, 8, jnp.asarray(p), tables, with_color=with_color,
        with_normal=with_normal, fused=True, analytic=analytic,
        interpret=True)
    tt = tables_to_torch(tables, "cpu")
    sd, w, g = sk.surface_eval(plan, tt, torch.as_tensor(p), mode=mode,
                               fd_h=FD_H, fused=True)
    np.testing.assert_allclose(sd.numpy(), np.asarray(sd_j), rtol=SD_RTOL,
                               atol=SD_ATOL)
    assert (w is None) == (w_j is None) and (g is None) == (g_j is None)
    clean = _tie_free(plan, tables, p)
    assert clean.mean() > 0.9, clean.mean()
    P = plan.num_primitives
    if w is not None:
        w, w_j = w.numpy(), np.asarray(w_j)
        np.testing.assert_array_equal(w[clean], w_j[clean])
        if mode == sk.COMBINED:
            assert (w >= P).any() and (w < P).any(), "no carve winner"
        else:
            assert (w < P).all()
    if g is not None:
        g, g_j = g.numpy(), np.asarray(g_j)
        atol = (G_ATOL if analytic else max(
            4 * float(np.spacing(np.abs(sd.numpy()).max())) / (2 * FD_H),
            1e-3))
        np.testing.assert_allclose(g[clean], g_j[clean], rtol=0, atol=atol)


def test_fused_field_is_the_fused_fold(case):
    """``scene_sd_fused`` (JAX's mirror, with its floor) and the twin of
    the kernels' fused fold give the same field; both equal JAX's."""
    name, plan, tables, p = case
    tt = tables_to_torch(tables, "cpu")
    q = torch.as_tensor(p)
    mirror = tsdf.scene_sd_fused(plan, tt, q).numpy()
    fold = tsdf.kernel_fold(plan, tt, q, fused=True)[0].numpy()
    want = np.asarray(jsdf.scene_sd_fused(plan, tables, jnp.asarray(p)))
    np.testing.assert_allclose(mirror, want, rtol=SD_RTOL, atol=SD_ATOL)
    np.testing.assert_allclose(fold, mirror, rtol=0, atol=1e-6)
    # a folded sponge is another field than its cross table away from the
    # surface (a DeathStar's derived carve is its carve row's sphere)
    exact = tsdf.kernel_fold(plan, tt, q)[0].numpy()
    if any(g.fused[0] == "menger" for g in fused_groups(plan.kernel)):
        assert not np.array_equal(fold, exact)


def test_scene_sd_fused_gradients_match_jax(case):
    """Autograd through ``scene_sd_fused`` against jax.grad of JAX's, for
    the points and every row of prim_pos and prim_aux: the generators'
    gradients land on their base rows, none on their carve rows."""
    name, plan, tables, p = case
    p = p[:400]
    w = np.random.default_rng(7).normal(size=p.shape[0]).astype(np.float32)

    def jloss(pos, aux, q):
        t = tables._replace(prim_pos=pos, prim_aux=aux)
        return jnp.sum(jnp.asarray(w) * jsdf.scene_sd_fused(plan, t, q))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(tables.prim_pos), jnp.asarray(tables.prim_aux),
        jnp.asarray(p))
    tt = tables_to_torch(tables, "cpu", requires_grad=("prim_pos",
                                                       "prim_aux"))
    q = torch.as_tensor(p).requires_grad_()
    f = tsdf.scene_sd_fused(plan, tt, q)
    got = torch.autograd.grad((torch.as_tensor(w) * f).sum(),
                              (tt.prim_pos, tt.prim_aux, q))
    for what, a, b in zip(("prim_pos", "prim_aux", "p"), got, want):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=what)
    for g in plan.kernel.groups:
        if g.fused is not None:
            carve = slice(g.start + 1, g.start + g.count)
            assert got[0][carve].abs().max() == 0
            assert got[1][carve].abs().max() == 0


def test_deathstar_radius_rule(scenes_dir):
    """tests/test_fused_deathstar.py:89-129 on the port: d field / d radius
    through the fused field includes the carve's 1.5 r centre offset (it
    matches central differences of the field and differs from the exact
    table's), and the carve row takes no cotangent."""
    plan, tables = _compiled("deathstar", scenes_dir)
    g = next(g for g in plan.kernel.groups if g.fused is not None)
    base = g.start
    p = torch.tensor([[1.6, 0.2, -6.0]])

    def f_of_r(r, fn):
        aux = torch.as_tensor(np.array(tables.prim_aux))
        aux = aux.index_put((torch.tensor([base]), torch.tensor([0])), r)
        tt = tables_to_torch(tables, "cpu")._replace(prim_aux=aux)
        return fn(plan, tt, p)[0]

    r0 = torch.tensor(float(tables.prim_aux[base, 0]), requires_grad=True)
    fused = lambda pl, tt, q: tsdf.scene_sd_fused(pl, tt, q)  # noqa: E731
    (gr,) = torch.autograd.grad(f_of_r(r0.reshape(1), fused), r0)
    h = 1e-3
    fd = (f_of_r(torch.tensor([r0.item() + h]), fused)
          - f_of_r(torch.tensor([r0.item() - h]), fused)) / (2 * h)
    np.testing.assert_allclose(float(gr), float(fd), atol=1e-3)
    jgr = jax.grad(lambda r: jsdf.scene_sd_fused(
        plan, tables._replace(prim_aux=jnp.asarray(tables.prim_aux).at[
            base, 0].set(r)), jnp.asarray(p.numpy()))[0])(
        jnp.float32(r0.item()))
    np.testing.assert_allclose(float(gr), float(jgr), rtol=1e-5, atol=1e-6)
    exact = lambda pl, tt, q: tsdf.scene_sd(pl, tt, q)  # noqa: E731
    r1 = r0.detach().clone().requires_grad_()
    (gx,) = torch.autograd.grad(f_of_r(r1.reshape(1), exact), r1)
    assert abs(float(gx) - float(gr)) >= 0.4


def _jax_winners(plan, tables, p):
    cfg = RenderConfig(tile_sublanes=8)
    return jvjp.fused_winner_eval(plan, cfg, jnp.asarray(p), tables, True)


def test_fused_theta_cotangents_match_jax(case):
    """``fused_theta_cotangents`` on JAX's own (widx, g, sd) at the points:
    extended rows fold onto the base rows by translation, the Menger size
    by homogeneity, the DeathStar radius by -sum u + 1.5 sum u g_x."""
    name, plan, tables, p = case
    sd, widx, g = _jax_winners(plan, tables, p)
    u = np.random.default_rng(5).normal(size=p.shape[0]).astype(np.float32)
    want = jvjp.fused_theta_cotangents(plan, tables, widx, g, jnp.asarray(u),
                                       sd, jnp.asarray(p))
    tt = tables_to_torch(tables, "cpu")
    got = tvjp.fused_theta_cotangents(
        plan, tt, *(torch.as_tensor(np.array(v)) for v in (widx, g)),
        torch.as_tensor(u), torch.as_tensor(np.array(sd)),
        torch.as_tensor(p))
    assert (np.asarray(widx) >= plan.num_primitives).any()
    for what, a, b in zip(("prim_pos", "prim_aux"), got,
                          (want.prim_pos, want.prim_aux)):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=what)


def test_fused_winner_hessian_chain_matches_jax(case):
    """``fused_winner_hessian_chain`` on JAX's own winners: the sphere
    leaves and the DeathStar's derived carve sphere are curved, the folded
    Menger crosses flat; p_bar and the reduced prim_pos, prim_aux
    cotangents."""
    name, plan, tables, p = case
    sd, widx, g = _jax_winners(plan, tables, p)
    gbar = np.random.default_rng(6).normal(size=p.shape).astype(np.float32)
    want = jvjp.fused_winner_hessian_chain(plan, tables, widx, g,
                                           jnp.asarray(gbar), sd)
    tt = tables_to_torch(tables, "cpu")
    got = tvjp.fused_winner_hessian_chain(
        plan, tt, *(torch.as_tensor(np.array(v)) for v in (widx, g)),
        torch.as_tensor(gbar), torch.as_tensor(np.array(sd)))
    for what, a, b in zip(("p_bar", "prim_pos", "prim_aux"), got, want):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=what)
    if name in ("demo", "config3", "deathstar"):
        assert got[2].abs().max() > 0      # a DeathStar carve's radius


def test_fused_analytic_normal_bwd_is_one_winner_eval_and_the_chain(case):
    """The fused analytic normal's backward is the chain on one fused
    combined evaluation, and equals JAX's."""
    name, plan, tables, p = case
    p = p[:500]
    gbar = np.random.default_rng(8).normal(size=p.shape).astype(np.float32)
    tt = tables_to_torch(tables, "cpu")
    got = tvjp.fused_analytic_normal_bwd(plan, tt, torch.as_tensor(p),
                                         torch.as_tensor(gbar))
    sd, widx, g = tvjp.fused_winner_eval(plan, tt, torch.as_tensor(p))
    again = tvjp.fused_winner_hessian_chain(plan, tt, widx, g,
                                            torch.as_tensor(gbar), sd)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    pb_j, tb_j = jvjp.fused_analytic_normal_bwd(
        plan, RenderConfig(tile_sublanes=8), True, jnp.asarray(p), tables,
        jnp.asarray(gbar))
    clean = _tie_free(plan, tables, p)
    np.testing.assert_allclose(got[0].numpy()[clean], np.asarray(pb_j)[clean],
                               rtol=1e-4, atol=1e-5)


def test_carve_rounds_half_to_even():
    """The fold's cell is round(q / pitch) half to even (jnp.round, CUDA's
    rintf; roundf would round away from zero): at q / pitch = 0.5 the
    point stays in the centre cell, and the carve equals JAX's there."""
    tree = "Bounds 40\nLight 5 8 4\nMengerSponge 0 0 0 9 2\n"
    plan, tables = compile_scene(parse_scene(tree))
    g = next(g for g in plan.kernel.groups if g.fused is not None)
    s = float(tables.prim_aux[g.start, 0])
    pitch = np.float32(s) / np.float32(3.0)
    # q / pitch exactly 0.5 and 1.5 on x (both ties), inside the sponge
    q = np.array([[0.5 * pitch, 0.1, 0.2], [1.5 * pitch, 0.2, 0.1],
                  [-0.5 * pitch, 0.3, 0.0]], np.float32)
    assert (q[:, 0] / pitch == np.array([0.5, 1.5, -0.5], np.float32)).all()
    p = q + np.asarray(tables.prim_pos)[g.start]
    run = (2, g.start, 0, 0)
    tt = tables_to_torch(tables, "cpu")
    got = tsdf._fused_carve(run, tt, torch.as_tensor(p)).numpy()
    want = np.asarray(jsdf._menger_carve_jnp(tables, g.start, 2,
                                             jnp.asarray(p)))
    np.testing.assert_array_equal(got, want)
    # rounding half away from zero folds into another cell: another value
    away = torch.as_tensor(p) - tt.prim_pos[g.start]
    cell = torch.clamp(torch.sign(away / pitch) * torch.floor(
        (away / pitch).abs() + 0.5), -1.0, 1.0)
    assert not torch.equal(cell, torch.clamp(torch.round(away / pitch),
                                             -1.0, 1.0))


def test_carve_size_from_a_halved_row_is_exact(case):
    """A staged scene holds box sizes halved; the Menger carve takes its
    size back as 2 h, which is the row's size bit for bit, where h / 1.5
    would not be: the base rows of every scene's sponges."""
    name, plan, tables, p = case
    aux = np.asarray(tables.prim_aux, np.float32)
    for g in plan.kernel.groups:
        if g.fused is not None and g.fused[0] == "menger":
            s = aux[g.start, 0]
            h = s * np.float32(0.5)
            assert np.float32(2.0) * h == s
            assert (np.float32(2.0) * h) / np.float32(3.0) == s / np.float32(3.0)


def test_leaf_count_counts_the_fused_carve(case):
    """``LeafCount`` on the fused fold: each point pays its generators' base
    leaves, and the carve's operations where the cull keeps the group."""
    name, plan, tables, p = case
    tt = tables_to_torch(tables, "cpu")
    q = torch.as_tensor(p)
    with tsdf.LeafCount() as c:
        tsdf.kernel_fold(plan, tt, q, fused=True)
    with tsdf.LeafCount() as e:
        tsdf.kernel_fold(plan, tt, q, collapse=False)
    assert c.points == e.points == p.shape[0]
    assert c.leaves < e.leaves
    assert c.ops > tsdf.OPS_PER_LEAF * c.leaves
    gens = fused_groups(plan.kernel)
    most = sum(tsdf.fused_carve_ops(g) for g in gens) * p.shape[0]
    assert c.ops - tsdf.OPS_PER_LEAF * c.leaves <= most
