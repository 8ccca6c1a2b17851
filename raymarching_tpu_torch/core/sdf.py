"""Scene distance field in plain PyTorch.

Port of ``raymarching_tpu.core.sdf``: every leaf primitive evaluated at
once into a [points, P] matrix, then the static folds of the compiled
plan.  Two folds:

  * :func:`scene_sd` / :func:`scene_surface` — the generic post-order fold
    over ``ScenePlan.lists`` (the JAX oracle's ``_fold_values``), with the
    reference's first-wins colour winner (body.cpp:12-14).
  * :func:`kernel_fold` — the two-level kernel normal form the render
    and surface kernels walk (``pallas_march._scene_sd_tile``,
    ``_scene_sd_idx_tile`` and ``_scene_sd_idx_grad_tile``): per group
    gsign * min(scale * leaf), then a strict-< root fold, so ties keep the
    earliest leaf; optionally the winner's gradient (:func:`prim_sd_grad`).

The leaf matrix is built in blocks of at most ``_LEAF_BUDGET`` elements so
the plain path's working set stays bounded at any ray count.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from raymarching_tpu.scene.compile import KIND_LEAF, MIN, KernelPlan, ScenePlan, SceneTables
from raymarching_tpu.scene.csg import PrimType

# Elements of one [points, P] leaf block (x3 for the per-axis offsets).
_LEAF_BUDGET = 1 << 25


def med3(a, b, c):
    """Median of three as the min/max network (pallas_march._med3): exactly
    monotone per argument, unlike the reference's sum - min - max."""
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def leaf_sd(plan: ScenePlan, tables: SceneTables, p: torch.Tensor) -> torch.Tensor:
    """Signed distances of every leaf: p [N, 3] -> [N, P] (body.cpp:32-57)."""
    if plan.proc:
        raise NotImplementedError(
            "procedural leaves are not ported yet (ROADMAP Queue 1 item 10)")
    d = p[:, None, :] - tables.prim_pos                  # [N, P, 3]
    b = d.abs() - tables.prim_aux * 0.5
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    box = torch.maximum(torch.maximum(bx, by), bz)
    cross = med3(bx, by, bz)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    # the JAX oracle's 1e-24 floor (value-neutral for distances >= 1e-12)
    sphere = (torch.sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-24))
              - tables.prim_aux[:, 0])
    t = torch.as_tensor(np.asarray(plan.prim_type, np.int32), device=p.device)
    return torch.where(t == int(PrimType.SPHERE), sphere,
                       torch.where(t == int(PrimType.BOX), box, cross))


def _blocked(fn: Callable, num_prims: int, p: torch.Tensor):
    """Apply ``fn`` to p [..., 3] in row blocks that bound the leaf matrix;
    ``fn`` maps [n, 3] to a tensor or a tuple of tensors of leading dim n."""
    flat = p.reshape(-1, 3)
    rows = max(1, _LEAF_BUDGET // max(num_prims, 1))
    parts = [fn(flat[i:i + rows]) for i in range(0, flat.shape[0], rows)]
    lead = p.shape[:-1]
    if not parts:
        parts = [fn(flat)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(col).reshape(lead + col[0].shape[1:])
                     for col in zip(*parts))
    return torch.cat(parts).reshape(lead + parts[0].shape[1:])


def _fold_values(plan: ScenePlan, leaf: torch.Tensor, with_color: bool):
    """The static post-order fold (core.sdf._fold_values).  leaf [N, P] ->
    (sd [N], colour leaf index [N] int32 or None; -1 = empty list)."""
    n = leaf.shape[0]
    results = []
    for lp in plan.lists:
        if not lp.entries:
            results.append((torch.full((n,), float("inf"), device=leaf.device),
                            torch.full((n,), -1, dtype=torch.int32,
                                       device=leaf.device)))
            continue
        vals, idxs = [], []
        for kind, idx, neg in lp.entries:
            if kind == KIND_LEAF:
                v = leaf[:, idx]
                ci = torch.full((n,), idx, dtype=torch.int32, device=leaf.device)
            else:
                v, ci = results[idx]
            vals.append(-v if neg else v)
            idxs.append(ci)
        stack = torch.stack(vals, dim=-1)
        # argmin/argmax return the first extremum: the reference's left
        # fold with first-operand-wins ties
        k = stack.argmin(-1) if lp.op == MIN else stack.argmax(-1)
        sd = stack.gather(-1, k[:, None])[:, 0]
        ci = torch.stack(idxs, dim=-1).gather(-1, k[:, None])[:, 0]
        results.append((sd, ci))
    sd, ci = results[-1]
    return sd, (ci if with_color else None)


def scene_sd(plan: ScenePlan, tables: SceneTables, p: torch.Tensor) -> torch.Tensor:
    """Scene signed distance at p [..., 3] -> [...]."""
    return _blocked(lambda q: _fold_values(plan, leaf_sd(plan, tables, q),
                                           False)[0],
                    plan.num_primitives, p)


def scene_surface(plan: ScenePlan, tables: SceneTables, p: torch.Tensor):
    """Scene signed distance and surface colour at p: ([...], [..., 3])."""
    sd, ci = _blocked(lambda q: _fold_values(plan, leaf_sd(plan, tables, q),
                                             True),
                      plan.num_primitives, p)
    safe = ci.clamp(0, tables.prim_color.shape[0] - 1).long()
    color = torch.where((ci >= 0)[..., None], tables.prim_color[safe],
                        torch.zeros((), device=p.device))
    return sd, color


def prim_sd_grad(ptype: torch.Tensor, pos: torch.Tensor, aux: torch.Tensor,
                 p: torch.Tensor) -> torch.Tensor:
    """d leaf sd / dp of one leaf per point (pallas_march._prim_sd_grad):
    ``ptype`` [N] PrimType codes, ``pos``/``aux`` [N, 3] the leaf's rows,
    p [N, 3] -> [N, 3].  Hand-derived a.e. gradients: sphere
    (p - c) / max(|p - c|, 1e-30); box one-hot sign(p - c) on the first
    argmax axis of |p - c| - size/2 (ties to x, then y); cross the same on
    the median axis."""
    d = p - pos
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    sphere = d * (1.0 / torch.clamp_min(r, 1e-30))[:, None]
    b = d.abs() - aux * 0.5
    bx, by, bz = b[:, 0], b[:, 1], b[:, 2]
    max_x = bx >= torch.maximum(by, bz)
    max_y = ~max_x & (by >= bz)
    min_x = bx <= torch.minimum(by, bz)
    min_y = ~min_x & (by <= bz)
    med_x = ~(max_x | min_x)
    med_y = ~(max_y | min_y | med_x)
    box = torch.stack([max_x, max_y, ~(max_x | max_y)], dim=-1)
    cross = torch.stack([med_x, med_y, ~(med_x | med_y)], dim=-1)
    t = ptype[:, None]
    axis = torch.where(t == int(PrimType.BOX), box, cross)
    flat = torch.where(axis, torch.sign(d), torch.zeros((), device=p.device))
    return torch.where(t == int(PrimType.SPHERE), sphere, flat)


def _kernel_fold_block(plan: ScenePlan, tables: SceneTables, p, with_idx,
                       with_grad):
    kp: KernelPlan = plan.kernel
    leaf = leaf_sd(plan, tables, p)
    n = leaf.shape[0]
    rsign = 1.0 if kp.root_op == MIN else -1.0
    running = torch.full((n,), float("inf"), device=p.device)
    ridx = torch.full((n,), -1, dtype=torch.int32, device=p.device)
    for g in kp.groups:
        scales = torch.as_tensor(np.asarray(g.scales, np.float32), device=p.device)
        seg = leaf[:, g.start:g.start + g.count] * scales
        # torch.min over a dim returns the first minimal index: the
        # strict-< leaf fold's winner
        gmin, k = seg.min(dim=-1)
        v = rsign * (float(g.gsign) * gmin)
        better = v < running
        running = torch.where(better, v, running)
        if with_idx or with_grad:
            ridx = torch.where(better, (k + g.start).to(torch.int32), ridx)
    if not with_grad:
        return rsign * running, ridx
    # Only the winner's gradient survives the fold's selects, and sign
    # flips are exact: the winning leaf's gradient times its path sign
    # gsign * scale (the root's rsign cancels) is the fold's, bitwise.
    sign_eff = torch.as_tensor(leaf_signs(plan), device=p.device)
    ptype = torch.zeros(sign_eff.shape, dtype=torch.int64, device=p.device)
    ptype[:plan.num_primitives] = torch.as_tensor(plan.prim_type)
    w = ridx.clamp_min(0).long()
    g = sign_eff[w][:, None] * prim_sd_grad(ptype[w], tables.prim_pos[w],
                                            tables.prim_aux[w], p)
    g = torch.where((ridx >= 0)[:, None], g, torch.zeros((), device=p.device))
    return rsign * running, ridx, g


@functools.lru_cache(maxsize=64)
def leaf_signs(plan: ScenePlan) -> np.ndarray:
    """[P] float32 path sign gsign * scale of every leaf of a two-level
    plan: min/max folds select but never scale, so for the winning leaf
    scene = sign * leaf sd (the root's rsign cancels in the chain rule).
    A leafless plan gets one zero row, as its tables have one pad row."""
    sign = np.zeros(max(plan.num_primitives, 1), np.float32)
    for g in plan.kernel.groups:
        for (_, start, count, scale) in g.runs:
            sign[start:start + count] = float(g.gsign * scale)
    return sign


def kernel_fold(plan: ScenePlan, tables: SceneTables, p: torch.Tensor,
                with_idx: bool = False, *, with_grad: bool = False) -> tuple:
    """The two-level kernel-form fold at p [..., 3] -> (sd [...], winner
    leaf id [...] int32, -1 where nothing won; None unless ``with_idx``),
    or with ``with_grad`` (sd, winner, d scene / dp [..., 3], zero where
    nothing won): the combined mode of the JAX surface kernel.

    The DIFFERENCE base-bound cull and the JAX kernel's lattice and chunk
    collapses leave every value and winner unchanged, so the plain fold
    skips none of them."""
    if plan.kernel is None:
        raise NotImplementedError(
            "depth > 2 scenes are not ported yet (ROADMAP Queue 2, D8)")
    out = _blocked(lambda q: _kernel_fold_block(plan, tables, q, with_idx,
                                                with_grad),
                   plan.num_primitives, p)
    if with_grad:
        return out
    sd, idx = out
    return sd, (idx if with_idx else None)
