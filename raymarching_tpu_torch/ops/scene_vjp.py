"""Winner algebra of the backwards: stencil, cotangents, scatter.

Counterpart of ``raymarching_tpu.ops.scene_vjp`` (the two-level part: the
FD stencil and the analytic normal's winner Hessian on exact tables, and
the fused generator field's winner algebra with its extended winner ids)
and of ``ops.march_op.ift_ray_weights``.  Through every
min/max fold the scene SDF is a.e. ``sign_eff * sd_w`` for one winning
leaf w with a static path sign, so K2's (sd, winner, gradient) per point
turn every parameter cotangent into a per-point formula and one
scatter-add onto the leaf rows:

    d scene / d centre_w = -g,   d scene / d radius_w = -sign_eff[w],
    d scene / d size_w,a = -sign_eff[w] * |g_a| / 2.

Ties go wholly to the first minimal leaf (strict <), the reference's
binary-fold rule; the JAX ``jnp`` route splits them evenly.  Tied leaves
have identical fields, so sums over a tie class agree.

The JAX package reduces with blocked one-hot matmuls (``_segment_add``,
``_gather_rows``, and for the fused field ``_segment_add_rows`` over the
static candidate rows of ``_fused_candidates``), a workaround for the
TPU's slow scatter; here the reduction is ``ops.segment_kernel`` (on the
card a kernel that merges a warp's rows by leaf in float64 and adds them
with float atomics, so the order of the sum changes from run to run; on
the CPU ``index_add_``) and the gather ``index_select``, both by id, so no
candidate set is needed.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..scene.compile import ScenePlan, SceneTables
from ..scene.csg import PrimType

from ..core.sdf import leaf_signs, require_kernel_form
from ..tables import ext_base, fused_groups
from .segment_kernel import segment_sum, theta_sum
from .surface_kernel import COMBINED, surface_eval, surface_stencil

# |grad f . d| can vanish at grazing incidence: the sign-preserving floor
# of march_op._DENOM_EPS
DENOM_EPS = 1e-6
# Rays (or points) a slice of the backwards that replay the field under
# autograd (the mirror-bounce chain, the procedural normal): their
# evaluations hold [rays, leaves] tensors, so a full-width step replays a
# slice at a time.  The demo at 512x512 SSAA 2 with one bounce and FD
# normals, NVIDIA H100 80GB HBM3 at 700 W: 5.5 s and 3.4 GiB at 16,384
# rays a slice, 3.4 s and 13.1 GiB at 65,536, 3.3 s and 50.5 GiB at
# 262,144 (two bounces: 5.0 s and 19.4 GiB at 65,536; the larger slice
# ran out of memory).
REPLAY_RAYS = 65536


def replay_slice(plan: ScenePlan, n: int) -> int:
    """Points a slice of the normal's replay under autograd at n points:
    ``REPLAY_RAYS`` with procedural leaves (a fractal's unrolled iterations
    under autograd, twice over with analytic normals), else all n at once.
    A slice pays the field's graph on the host again: the fused FD fit
    step on the demo at 512x512 SSAA 2, NVIDIA H100 80GB HBM3 at 700 W
    (``chip_smoke.py --fused-fd-step``), replays in 82-98 ms and 2.71 GiB
    whole and in 1038-1278 ms and 0.22 GiB in 16 slices."""
    return REPLAY_RAYS if plan.proc else max(n, 1)


@functools.lru_cache(maxsize=64)
def leaf_statics(plan: ScenePlan) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Per-leaf (sign_eff [P] float32, is_sphere [P] bool, is_proc [P]
    bool) of a plan of any depth (scene_vjp._leaf_statics): sign_eff is
    ``core.sdf.leaf_signs``' path sign, is_proc marks the procedural
    fractal leaves; a leafless plan gets one pad row."""
    sign_eff = leaf_signs(plan)
    ptype = np.asarray(plan.prim_type, np.int32)
    is_sphere = np.zeros(sign_eff.shape, bool)
    is_sphere[:plan.num_primitives] = ptype == int(PrimType.SPHERE)
    is_proc = np.zeros(sign_eff.shape, bool)
    is_proc[:plan.num_primitives] = ptype >= int(PrimType.MANDELBOX)
    return sign_eff, is_sphere, is_proc


def winner_eval(plan: ScenePlan, tables: SceneTables, p: torch.Tensor
                ) -> tuple:
    """(sd [R], winner leaf [R] int32, d scene / dp [R, 3]) at points
    p [R, 3]: one K2 launch in its combined mode (scene_vjp.winner_eval)."""
    return surface_eval(plan, tables, p, mode=COMBINED)


def stencil_eval(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                 p: torch.Tensor, *, center: bool, collapse: bool = True
                 ) -> tuple:
    """Winner evaluation at ``surface_kernel.stencil_points`` of every
    point p [R, 3] in ONE K2 launch -> (sd [K, R], widx [K, R], g [K, R, 3]); the kernel
    makes the stencil points itself (``surface_stencil``)."""
    return surface_stencil(plan, tables, p, cfg.fd_h, center=center,
                           collapse=collapse)


def fd_stencil_cotangents(cfg: RenderConfig, nbar: torch.Tensor
                          ) -> torch.Tensor:
    """Per-stencil-row SD cotangents of g_a = (f(p + h e_a) -
    f(p - h e_a)) / 2h, in stencil_eval's row order (+x +y +z -x -y -z):
    nbar [R, 3] -> u [6, R]."""
    inv = 1.0 / (2.0 * cfg.fd_h)
    return torch.cat([nbar.t() * inv, -nbar.t() * inv])


def ift_ray_weights(t_bar: torch.Tensor, denom: torch.Tensor,
                    damping: float) -> torch.Tensor:
    """The implicit-function cotangent w = -t_bar / (grad f . d) per ray:
    with ``damping`` > 0 the Tikhonov-damped -t_bar * denom / (denom^2 +
    damping^2), else 1/denom with |denom| floored at DENOM_EPS, sign kept."""
    if damping > 0.0:
        return -t_bar * denom / (denom * denom + damping * damping)
    small = denom.abs() < DENOM_EPS
    floor = torch.where(denom < 0, -DENOM_EPS, DENOM_EPS)
    return -t_bar / torch.where(small, floor, denom)


def segment_add(idx: torch.Tensor, vals: torch.Tensor, P: int
                ) -> torch.Tensor:
    """[P, C] sums of the rows of vals [R, C] by idx [R] (negative:
    dropped), scene_vjp._segment_add: ``segment_kernel.segment_sum``, the
    segment kernel on the card (vals float32) and ``index_add_`` on the
    CPU, so no host sync filters the misses.

    The sums are taken in float64 and rounded once to vals' dtype.  A
    leaf's stencil rows carry cotangents of +-1 / 2 fd_h that cancel to a
    far smaller sum, so a float32 sum keeps an error of the terms' size,
    and the card's atomics reorder it from run to run: in float32 the
    card's and the CPU's gradients of one render differed by more than
    tests/test_mega.py's tolerance."""
    return segment_sum(idx, vals, P).to(vals.dtype)


def merge_factor(idx: torch.Tensor) -> float:
    """How many rows the segment kernel sums into each of its adds, on
    average: the rows of idx [...] with an id >= 0 over the sum, across
    idx's 32-row chunks (a warp's rows), of the distinct ids >= 0 in each
    chunk; 0.0 where no row has one.  Computed with torch ops on idx's
    device, for measurements: no path of the backwards calls it."""
    ids = idx.reshape(-1).long()
    valid = int((ids >= 0).sum())
    if not valid:
        return 0.0
    pad = ids.new_full(((-ids.numel()) % 32,), -1)
    chunks = torch.cat([ids, pad]).reshape(-1, 32).sort(dim=1).values
    first = torch.ones_like(chunks, dtype=torch.bool)
    first[:, 1:] = chunks[:, 1:] != chunks[:, :-1]
    return valid / int((first & (chunks >= 0)).sum())


def gather_rows(idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """rows[idx] [R, C] for idx [R] into rows [P, C], zero rows where idx
    is negative (scene_vjp._gather_rows): one ``index_select`` from the
    table with a zero row appended.  The winner colours of the blend and
    the replay, and the winner statics of the Hessian chain; under
    autograd its cotangent is one row scatter."""
    P = rows.shape[0]
    table = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    return table.index_select(0, torch.where(idx < 0, P, idx).long())


def theta_cotangents(plan: ScenePlan, tables: SceneTables, widx: torch.Tensor,
                     g: torch.Tensor, u: torch.Tensor,
                     sd: Optional[torch.Tensor] = None,
                     p: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter per-point winner cotangents onto the leaf rows.

    widx [...] winner leaf (negative: none), g [..., 3] d scene / dp,
    u [...] the cotangent on the scene SD -> (prim_pos cotangent [P, 3],
    prim_aux cotangent [P, 3]).  Each point adds the columns
    [-u g, -u, -u |g| / 2] to its winner's row; sign_eff and the
    sphere/box split are applied per leaf after the sum (they are shared
    by every point that lands on a leaf, and +-1 factors commute exactly
    with the sum).  The columns are float32 and their sums float64
    (``segment_add``): on the card the segment kernel's theta entry makes
    the columns in registers from widx, g and u
    (``segment_kernel.theta_sum``), on the CPU ``index_add_`` sums them.

    A plan with procedural leaves also needs the scene SD sd [...] and the
    points p [..., 3] (the winner pass has both): a fractal's DE is
    homogeneous, DE(p; c, s) = s U((p - c) / s), so d scene / ds =
    (scene - g . (p - c)) / s, two more columns -u sd and -u g.p and, per
    leaf, (col8 - col7 - c . sum(-u g)) / s (scene_vjp.theta_cotangents'
    procedural columns; the sums float64 like the rest)."""
    P = tables.prim_pos.shape[0]
    sign_eff, is_sphere, is_proc = leaf_statics(plan)
    has_proc = bool(plan.proc)
    if has_proc and (sd is None or p is None):
        raise ValueError("a plan with procedural leaves needs sd and p for "
                         "theta_cotangents")
    red = theta_sum(widx, g, u, P, *((sd, p) if has_proc else ()))
    se = torch.as_tensor(sign_eff[:P], device=red.device)[:, None]
    sph = torch.as_tensor(is_sphere[:P], device=red.device)[:, None]
    aux_sphere = torch.cat([red[:, 3:4], torch.zeros_like(red[:, :2])], dim=1)
    gaux = se * torch.where(sph, aux_sphere, red[:, 4:7])
    if has_proc:
        proc = torch.as_tensor(is_proc[:P], device=red.device)
        s = tables.prim_aux.detach()[:, 0].double()
        s_safe = torch.where(proc, s, torch.ones_like(s))
        size = (red[:, 8] - red[:, 7] - (tables.prim_pos.detach().double()
                                         * red[:, :3]).sum(dim=1)) / s_safe
        gaux = torch.where(proc[:, None], torch.cat(
            [size[:, None], torch.zeros_like(red[:, :2])], dim=1), gaux)
    return red[:, :3].to(g.dtype), gaux.to(g.dtype)


def stencil_theta_cotangents(plan: ScenePlan, tables: SceneTables,
                             widx: torch.Tensor, g: torch.Tensor,
                             u: torch.Tensor,
                             sd: Optional[torch.Tensor] = None,
                             q: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``theta_cotangents`` over a leading stencil axis: widx, u [K, R],
    g [K, R, 3] (with procedural leaves also the stencil SDs sd [K, R] and
    points q [K, R, 3]) -> one (prim_pos, prim_aux) cotangent pair.  The
    scatter is linear in its rows, so the stencil axis flattens in, and
    the K rows of one point, whose cotangents of +-1 / 2 fd_h nearly
    cancel, meet in ``segment_add``'s float64 sums."""
    K = widx.shape[0]
    return theta_cotangents(plan, tables, widx.reshape(-1),
                            g.reshape(K * g.shape[1], 3), u.reshape(-1),
                            None if sd is None else sd.reshape(-1),
                            None if q is None else q.reshape(-1, 3))


def winner_hessian_chain(plan: ScenePlan, tables: SceneTables,
                         widx: torch.Tensor, g: torch.Tensor,
                         gbar: torch.Tensor, sd: torch.Tensor) -> tuple:
    """The a.e. VJP of the analytic normal's primal, the winner-gradient
    field g(p) (scene_vjp.winner_hessian_chain).  Away from fold switches
    g = sign_eff * grad sd_w, so dg/dp = sign_eff H_w and dg/d centre_w =
    -sign_eff H_w, with the winner's Hessian in closed form: a sphere's
    H = (I - u u^T) / |p - c|, u the unit vector from its centre, and
    |p - c| = radius + sign_eff * scene sd by the winner's own identity;
    boxes and crosses are flat (their gradient is a one-hot sign, H = 0
    a.e.).  Radii and sizes do not move g, so prim_pos is the only
    parameter that gets a cotangent.

    widx [R], g, gbar [R, 3], sd [R] -> (p_bar [R, 3], rows [R, 3],
    idx [R]): ``segment_add(idx, rows, P)`` is the prim_pos cotangent
    (rows = -p_bar on sphere winners; idx -1 elsewhere, dropped)."""
    P = tables.prim_pos.shape[0]
    sign_eff, is_sphere, _ = leaf_statics(plan)
    dev = g.device
    stats = torch.stack([
        torch.as_tensor(sign_eff[:P], device=dev),
        tables.prim_aux[:, 0].detach(),
        torch.as_tensor(is_sphere[:P], dtype=g.dtype, device=dev)], dim=1)
    st = gather_rows(widx, stats)               # zeros where nothing won
    se, r, sph = st[:, 0], st[:, 1], st[:, 2] > 0.5
    u = se[:, None] * g
    dist = torch.clamp_min(r + se * sd, 1e-12)[:, None]
    hg = (gbar - u * (u * gbar).sum(dim=-1, keepdim=True)) / dist
    # a miss's sd may be inf (0 * inf in dist): the select drops it
    p_bar = torch.where(sph[:, None], se[:, None] * hg,
                        torch.zeros((), dtype=g.dtype, device=dev))
    return p_bar, -p_bar, torch.where(sph, widx, -1)


def analytic_normal_bwd(plan: ScenePlan, tables: SceneTables,
                        p: torch.Tensor, gbar: torch.Tensor,
                        need_theta: bool = True) -> tuple:
    """VJP of the analytic normal at points p [R, 3] for its cotangent
    gbar [R, 3] (scene_vjp.analytic_normal_bwd): one K2 launch in its
    combined mode, the winner Hessian chain and, when ``need_theta``, one
    ``segment_add`` -> (p_bar [R, 3], prim_pos cotangent [P, 3] or
    None)."""
    sd, widx, g = winner_eval(plan, tables, p)
    p_bar, rows, idx = winner_hessian_chain(plan, tables, widx, g, gbar, sd)
    pos_bar = (segment_add(idx, rows, tables.prim_pos.shape[0])
               if need_theta else None)
    return p_bar, pos_bar


# Kinds of the P + F winner rows of the fused field (scene_vjp
# ._fused_statics): a flat leaf (box, cross), a sphere leaf, a Menger carve
# (a folded cross: flat, its size by homogeneity) and a DeathStar carve (a
# sphere centred 1.5 r along x from its base).
K_FLAT, K_SPHERE, K_MENGER_CARVE, K_DS_CARVE = 0, 1, 2, 3


@functools.lru_cache(maxsize=64)
def fused_statics(plan: ScenePlan) -> tuple:
    """(kind [P + F] int32, sigma [P + F] float32, base_row [P + F] int64,
    P, F) over the winner rows of the fused field (scene_vjp
    ._fused_statics): the P leaves, then the extended id P + k of the k-th
    fused group.  sigma: g = sigma * unit(p - c) on curved rows (a leaf's
    path sign; -1 for a DeathStar carve, whose group is -carve there);
    base_row: the table row a winner row's cotangents land on (itself, or
    the generator's base leaf)."""
    kp = require_kernel_form(plan)
    sign_eff, is_sphere, _ = leaf_statics(plan)
    P = plan.num_primitives
    generators = fused_groups(kp)
    if generators and ext_base(kp) != P:
        raise ValueError("the fused plan's extended ids do not start at P")
    F = len(generators)
    kind = np.zeros(P + F, np.int32)
    kind[:P][is_sphere[:P]] = K_SPHERE
    sigma = np.ones(P + F, np.float32)
    sigma[:P] = sign_eff[:P]
    base_row = np.arange(P + F, dtype=np.int64)
    for k, g in enumerate(generators):
        base_row[P + k] = g.start
        if g.fused[0] == "deathstar":
            kind[P + k] = K_DS_CARVE
            sigma[P + k] = -1.0
        else:
            kind[P + k] = K_MENGER_CARVE
    return kind, sigma, base_row, P, F


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def fused_winner_eval(plan: ScenePlan, tables: SceneTables, p: torch.Tensor
                      ) -> tuple:
    """(sd [R], winner [R] int32, d scene / dp [R, 3]) of the fused field
    at p [R, 3], the winner an extended id P + k where a generator's carve
    wins: one K2 launch in its fused combined mode
    (scene_vjp.fused_winner_eval)."""
    return surface_eval(plan, tables, p, mode=COMBINED, fused=True)


def fused_theta_cotangents(plan: ScenePlan, tables: SceneTables,
                           widx: torch.Tensor, g: torch.Tensor,
                           u: torch.Tensor, sd: torch.Tensor,
                           p: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``theta_cotangents`` for the fused field (scene_vjp
    .fused_theta_cotangents): each point adds [-u g, -u, -u |g| / 2,
    -u sd, -u g.p] to its winner's row of P + F; leaf rows take the
    exact-table formulas, and a carve row lands on its base row: the
    position by translation (the same -u g), a Menger carve's size by
    degree-1 homogeneity (gval = -s carve((p - c) / s): (sum -u g.p - sum
    -u sd - c . sum -u g) / s) and a DeathStar carve's radius by its
    derived centre (d gval / dr = 1 - 1.5 g_x: -sum -u + 1.5 sum -u g_x).
    -> (prim_pos cotangent [P, 3], prim_aux cotangent [P, 3])."""
    kind, sigma, base_row, P, F = fused_statics(plan)
    red = theta_sum(widx, g, u, P + F, sd, p)                # [P + F, 9]
    kind_t = _on(kind, red)[:, None]
    sig = _on(sigma, red).double()[:, None]
    rows = _on(base_row, red)
    zeros2 = torch.zeros_like(red[:, :2])
    gpos_ext = red[:, :3]
    gaux = torch.where(kind_t == K_SPHERE,
                       sig * torch.cat([red[:, 3:4], zeros2], dim=1),
                       sig * red[:, 4:7])
    c_ext = tables.prim_pos.detach()[rows].double()
    s_ext = tables.prim_aux.detach()[rows, 0].double()
    s_safe = torch.where(s_ext != 0.0, s_ext, torch.ones_like(s_ext))
    size_cot = (red[:, 8] - red[:, 7] - (c_ext * gpos_ext).sum(dim=1)
                ) / s_safe
    gaux = torch.where(kind_t == K_MENGER_CARVE,
                       torch.cat([size_cot[:, None], zeros2], dim=1), gaux)
    ds_cot = -red[:, 3] + 1.5 * red[:, 0]
    gaux = torch.where(kind_t == K_DS_CARVE,
                       torch.cat([ds_cot[:, None], zeros2], dim=1), gaux)
    out = torch.zeros((P, 6), dtype=red.dtype, device=red.device)
    out.index_add_(0, rows, torch.cat([gpos_ext, gaux], dim=1))
    out = out.to(g.dtype)
    return out[:, :3], out[:, 3:]


def fused_winner_hessian_chain(plan: ScenePlan, tables: SceneTables,
                               widx: torch.Tensor, g: torch.Tensor,
                               gbar: torch.Tensor, sd: torch.Tensor
                               ) -> tuple:
    """``winner_hessian_chain`` for the fused field (scene_vjp
    .fused_winner_hessian_chain): the curved winners are sphere leaves and
    DeathStar carves, whose sphere is centred at c + 1.5 r e_x; Menger
    carves are folded crosses, flat.  With u = sigma g and |p - c| =
    r + sigma sd from the winner's own identity, p_bar = sigma H gbar,
    the centre gets -p_bar and a carve's radius 1.5 times its x.
    widx [R], g, gbar [R, 3], sd [R] -> (p_bar [R, 3], prim_pos cotangent
    [P, 3], prim_aux cotangent [P, 3]), reduced onto the base rows."""
    kind, sigma, base_row, P, F = fused_statics(plan)
    dev = g.device
    rows = _on(base_row, g)
    stats = torch.stack([
        _on(sigma, g), tables.prim_aux.detach()[rows, 0],
        _on(kind == K_SPHERE, g).to(g.dtype),
        _on(kind == K_DS_CARVE, g).to(g.dtype)], dim=1)
    st = gather_rows(widx, stats)               # zeros where nothing won
    sg, r, sph, dsc = st[:, 0], st[:, 1], st[:, 2] > 0.5, st[:, 3] > 0.5
    curved = sph | dsc
    u = sg[:, None] * g
    dist = torch.clamp_min(r + sg * sd, 1e-12)[:, None]
    hg = (gbar - u * (u * gbar).sum(dim=-1, keepdim=True)) / dist
    zero = torch.zeros((), dtype=g.dtype, device=dev)
    # a miss's sd may be inf (0 * inf in dist): the select drops it
    p_bar = torch.where(curved[:, None], sg[:, None] * hg, zero)
    pos_rows = -p_bar
    aux0 = torch.where(dsc, 1.5 * pos_rows[:, 0], zero)
    red = segment_sum(torch.where(curved, widx, -1),
                      torch.cat([pos_rows, aux0[:, None]], dim=1), P + F)
    out = torch.zeros((P, 4), dtype=red.dtype, device=dev)
    out.index_add_(0, rows, red)
    out = out.to(g.dtype)
    aux_bar = torch.cat([out[:, 3:], torch.zeros_like(out[:, :2])], dim=1)
    return p_bar, out[:, :3], aux_bar


def fused_analytic_normal_bwd(plan: ScenePlan, tables: SceneTables,
                              p: torch.Tensor, gbar: torch.Tensor) -> tuple:
    """VJP of the fused field's analytic normal at p [R, 3] for gbar
    [R, 3] (scene_vjp.fused_analytic_normal_bwd): one fused K2 combined
    launch and the closed-form chain -> (p_bar [R, 3], prim_pos
    cotangent [P, 3], prim_aux cotangent [P, 3])."""
    sd, widx, g = fused_winner_eval(plan, tables, p)
    return fused_winner_hessian_chain(plan, tables, widx, g, gbar, sd)
