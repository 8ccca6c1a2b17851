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
    Its value fold and its winner-and-gradient fold have a second plain
    form, the exact Menger lattice collapse (``pallas_march
    ._menger_carve_lattice`` and ``_menger_carve_lattice_idx_grad``), read
    from the very descriptor stream the CUDA kernels walk
    (``tables.pack_plan``).  With ``fused`` it is the kernels' fused
    generator field (``RenderConfig.fused_generators``): a generator
    group's carve computed from its base row (``_fused_carve``).
  * :func:`scene_sd_fused` — the fused field as JAX's
    ``core.sdf.scene_sd_fused`` writes it, for autograd: the field the
    fused FD backward and the multi-kernel backend's implicit-function
    backward differentiate.

The leaf matrix is built in blocks of at most ``_LEAF_BUDGET`` elements so
the plain path's working set stays bounded at any ray count.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..scene.compile import KIND_LEAF, MIN, KernelPlan, ScenePlan, SceneTables
from ..scene.csg import PrimType

# Elements of one [points, P] leaf block (x3 for the per-axis offsets).
_LEAF_BUDGET = 1 << 25


def med3(a, b, c):
    """Median of three as the min/max network (pallas_march._med3): exactly
    monotone per argument, unlike the reference's sum - min - max."""
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def leaf_sd(plan: ScenePlan, tables: SceneTables, p: torch.Tensor,
            leaves=None) -> torch.Tensor:
    """Signed distances of every leaf: p [N, 3] -> [N, P] (body.cpp:32-57);
    with ``leaves`` (an index array) of those leaves only."""
    if plan.proc:
        raise NotImplementedError(
            "procedural leaves are not ported yet (ROADMAP Queue 1 item 10)")
    pos, aux = tables.prim_pos, tables.prim_aux
    ptype = np.asarray(plan.prim_type, np.int32)
    if leaves is not None:
        rows = torch.as_tensor(leaves, device=p.device)
        pos, aux, ptype = pos[rows], aux[rows], ptype[leaves]
    d = p[:, None, :] - pos                              # [N, P, 3]
    b = d.abs() - aux * 0.5
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    box = torch.maximum(torch.maximum(bx, by), bz)
    cross = med3(bx, by, bz)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    # the JAX oracle's 1e-24 floor (value-neutral for distances >= 1e-12)
    sphere = (torch.sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-24))
              - aux[:, 0])
    t = torch.as_tensor(ptype, device=p.device)
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


# Operations of the fold, for a roofline bound: a leaf evaluation is at
# least 12 (the sphere: 3 sub, 3 mul, 2 add, sqrt, sub, scale, min).  The
# collapsed carve needs 3 for each distinct axis excess |p - c| - h (sub,
# abs, sub), 1 min for each member of a distinct x-set, and 5 for each
# column (the 4 min/max of the median and the running min).  The collapse
# that also carries the winner's row adds one select to each x-set member
# and to each column.
OPS_PER_LEAF, OPS_PER_EXCESS, OPS_PER_XSET_MEMBER, OPS_PER_COLUMN = 12, 3, 1, 5
OPS_PER_WINNER_SELECT = 1
# A fused generator's carve (csrc/fold.cuh's fused_carve) and its min with
# the base: the DeathStar sphere 13 (the derived centre 2, the sphere 10,
# the min); the folded Menger union 5 (the offset from the centre 3, the
# first pitch, the min with the base), 12 a level (a cross: 3 abs, 3 sub,
# the half-size, 4 min/max of the median, the running min) and 19 between
# levels (per axis a division, round, clip's min and max, a product and a
# difference; the next pitch).
OPS_DEATHSTAR_CARVE = 13
OPS_MENGER_SETUP, OPS_PER_MENGER_LEVEL, OPS_PER_MENGER_FOLD = 5, 12, 19


def fused_carve_ops(g) -> int:
    """Operations of fused group ``g``'s carve at one point."""
    if g.fused[0] == "deathstar":
        return OPS_DEATHSTAR_CARVE
    levels = g.fused[1]
    return (OPS_MENGER_SETUP + OPS_PER_MENGER_LEVEL * levels
            + OPS_PER_MENGER_FOLD * (levels - 1))


class LeafCount:
    """Counts the work the CUDA kernels' fold (csrc/fold.cuh) does for the
    points that pass through ``kernel_fold`` while the context is open:
    every leaf of a group, less the carve of a cullable DIFFERENCE group at
    points where its base bound already reaches the running minimum.
    Where the fold takes the lattice collapse, a surviving point's carve
    counts its single-cross levels as leaves and every other level as
    operations: 3 for each distinct axis excess, 1 for each member of a
    distinct x-set and 5 for each column (OPS_PER_EXCESS,
    OPS_PER_XSET_MEMBER, OPS_PER_COLUMN; a leaf is OPS_PER_LEAF = 12), and
    in the winner-and-gradient fold one select more for each member and
    column (OPS_PER_WINNER_SELECT).  A fused generator group counts its
    base leaf, and where the cull keeps it its carve's operations
    (``fused_carve_ops``; one select more in the winner-and-gradient
    fold).
    The plain twin itself may evaluate more; this is the count of what
    the kernels' data needs.

        with LeafCount() as c:
            render_rays_plain(...)
        c.leaves, c.ops, c.points

    ``leaves``: leaf evaluations; ``ops``: OPS_PER_LEAF for each of them
    plus the collapsed levels' operations.
    """

    _open: list = []

    def __init__(self):
        self._leaves = []
        self._collapsed = []
        self.points = 0

    def __enter__(self):
        LeafCount._open.append(self)
        return self

    def __exit__(self, *exc):
        LeafCount._open.remove(self)
        return False

    @property
    def leaves(self) -> int:
        return int(sum(int(t.item()) for t in self._leaves))

    @property
    def ops(self) -> int:
        return OPS_PER_LEAF * self.leaves + int(
            sum(int(t.item()) for t in self._collapsed))


def _base_leaves(g) -> int:
    """Leaves in the leading base (scale -1) runs of group ``g``."""
    n = 0
    for (_, _, count, scale) in g.runs:
        if scale != -1:
            break
        n += count
    return n


def carve_folded(plan: ScenePlan, tables: SceneTables,
                 p: torch.Tensor) -> torch.Tensor:
    """bool [N]: the points of p [N, 3] at which the kernels' fold goes on
    to the carve of a cullable group, i.e. where its base bound does not
    reach the running minimum (fold.cuh's test).  An instrument, like
    ``LeafCount``: a warp pays for a carve when any of its lanes does."""
    from ..tables import is_cullable

    kp: KernelPlan = plan.kernel
    rsign = 1.0 if kp.root_op == MIN else -1.0
    out = []
    for q in p.split(max(1, _LEAF_BUDGET // max(plan.num_primitives, 1))):
        leaf = leaf_sd(plan, tables, q)
        running = torch.full(q.shape[:1], float("inf"), device=p.device)
        any_kept = torch.zeros(q.shape[:1], dtype=torch.bool, device=p.device)
        for g in kp.groups:
            scales = torch.as_tensor(np.asarray(g.scales, np.float32),
                                     device=p.device)
            seg = leaf[:, g.start:g.start + g.count] * scales
            nb = _base_leaves(g)
            if is_cullable(kp, g) and nb < g.count:
                any_kept |= -seg[:, :nb].min(dim=-1).values < running
            running = torch.minimum(
                running, rsign * (float(g.gsign) * seg.min(dim=-1).values))
        out.append(any_kept)
    return torch.cat(out)


class _Level(NamedTuple):
    """One level of a collapse block, decoded into index arrays."""

    size_row: int                   # the single cross, or the size's row
    members: Optional[list] = None  # per x-set its member rows; None: single
    col_xset: Optional[np.ndarray] = None   # per column its x-set
    col_y: Optional[np.ndarray] = None      # per column the row of its y
    col_z: Optional[np.ndarray] = None      # per column the row of its z
    # per column the table row of its cross at each member of its x-set,
    # padded with -1 to the widest x-set
    col_rows: Optional[np.ndarray] = None


class _Block(NamedTuple):
    """A group's collapse block: its levels, how many of them are a single
    cross (counted as leaves), the operations of the others in the value
    fold and in the fold that carries the winner's row, and the most
    columns a level has."""

    levels: list
    singles: int
    ops: int
    ops_idx: int
    widest: int


def _decode_block(lat: np.ndarray, off: int) -> _Block:
    """The collapse block at ``off`` of the packed stream the kernels walk
    (``tables.PackedPlan.lattice`` has the layout)."""
    levels, singles, ops, ops_idx, widest = [], 0, 0, 0, 0
    n_levels, roff = int(lat[off]), int(lat[off + 1])
    off += 2
    for _ in range(n_levels):
        n_xsets, size_row = int(lat[off]), int(lat[off + 1])
        off += 2
        if n_xsets == 0:
            levels.append(_Level(size_row))
            singles += 1
            roff += 1
            continue
        members, col_xset, col_y, col_z, col_rows = [], [], [], [], []
        for xs in range(n_xsets):
            n_mem, n_col = int(lat[off]), int(lat[off + 1])
            off += 2
            members.append(lat[off:off + n_mem])
            cols = lat[off + n_mem:off + n_mem + 2 * n_col].reshape(n_col, 2)
            off += n_mem + 2 * n_col
            col_xset += [xs] * n_col
            col_y.append(cols[:, 0])
            col_z.append(cols[:, 1])
            col_rows.append(lat[roff:roff + n_mem * n_col].reshape(n_col,
                                                                   n_mem))
            roff += n_mem * n_col
        col_y, col_z = np.concatenate(col_y), np.concatenate(col_z)
        width = max(len(m) for m in members)
        col_rows = np.concatenate([np.pad(r, ((0, 0), (0, width - r.shape[1])),
                                          constant_values=-1)
                                   for r in col_rows])
        distinct = sum(len(set(rows.tolist())) for rows in
                       (np.concatenate(members), col_y, col_z))
        n_members = sum(len(m) for m in members)
        ops += (OPS_PER_EXCESS * distinct + OPS_PER_XSET_MEMBER * n_members
                + OPS_PER_COLUMN * len(col_y))
        ops_idx += OPS_PER_WINNER_SELECT * (n_members + len(col_y))
        widest = max(widest, len(col_y))
        levels.append(_Level(size_row, members, np.asarray(col_xset), col_y,
                             col_z, col_rows))
    return _Block(levels, singles, ops, ops + ops_idx, widest)


class _FoldLayout(NamedTuple):
    """What the plain fold evaluates leaf by leaf: ``leaves`` are the rows
    of its leaf matrix (None: every leaf), group g's columns start at
    ``first[g]`` and are ``folded[g]`` wide, ``blocks`` maps a collapsing
    group to its block, and ``carves`` a fused group to (its carve run:
    Menger levels or 0, base row, 0, extended winner id; its carve's
    operations)."""

    leaves: Optional[np.ndarray]
    first: tuple
    folded: tuple
    blocks: dict
    carves: dict


@functools.lru_cache(maxsize=128)
def _fold_layout(kp: KernelPlan, collapse: bool,
                 fused: bool = False) -> _FoldLayout:
    """The leaf fold's layout, or with ``collapse`` the one in which each
    collapsing group keeps its base leaves only; with ``fused`` a
    generator group keeps its base leaf (the fused packing's)."""
    from ..tables import GROUP_FUSED, pack_plan

    blocks, carves = {}, {}
    packed = pack_plan(kp, fused)
    if fused:
        runs = packed.runs.numpy()
        for gi, (_, first, n_runs, kind) in enumerate(packed.groups.numpy()):
            if kind == GROUP_FUSED:
                carves[gi] = (tuple(int(v) for v in runs[first + n_runs]),
                              fused_carve_ops(kp.groups[gi]))
    if collapse:
        lat = packed.lattice.numpy().astype(np.int64)
        blocks = {gi: _decode_block(lat, int(lat[gi]))
                  for gi in range(len(kp.groups)) if lat[gi] != 0}
    if not blocks and not carves:
        return _FoldLayout(None, tuple(g.start for g in kp.groups),
                           tuple(g.count for g in kp.groups), blocks, carves)
    folded = tuple(_base_leaves(g) if gi in blocks or gi in carves
                   else g.count for gi, g in enumerate(kp.groups))
    leaves = np.concatenate([np.arange(g.start, g.start + n)
                             for g, n in zip(kp.groups, folded)])
    first = tuple(int(v) for v in np.cumsum((0,) + folded[:-1]))
    return _FoldLayout(leaves, first, folded, blocks, carves)


def _fused_carve(carve: tuple, tables: SceneTables, p: torch.Tensor,
                 with_grad: bool = False):
    """A fused group's carve at p [N, 3] -> [N], or with ``with_grad``
    ([N], d carve / dp [N, 3]): the arithmetic of fold.cuh's fused_carve
    and winner_carve_grad (pallas_march._fused_carve, _fused_carve_grad),
    from the base row alone.  ``carve`` is the carve run of the fused
    packing: (Menger levels, or 0 for the DeathStar's derived sphere; the
    base row; 0; the extended winner id)."""
    levels, row = carve[0], carve[1]
    pos, aux = tables.prim_pos[row], tables.prim_aux[row]
    if levels == 0:
        r = aux[0]
        dx = p[:, 0] - (pos[0] + 1.5 * r)
        dy, dz = p[:, 1] - pos[1], p[:, 2] - pos[2]
        d = torch.sqrt(dx * dx + dy * dy + dz * dz)
        if not with_grad:
            return d - r
        inv = 1.0 / torch.clamp_min(d, 1e-30)
        return d - r, torch.stack([dx * inv, dy * inv, dz * inv], dim=-1)
    q = p - pos
    # a tensor divisor: PyTorch divides a CUDA tensor by a Python number as
    # a product with its reciprocal, which is not the kernels' s / 3
    three = torch.full((), 3.0, dtype=p.dtype, device=p.device)
    pitch = aux[0] / three
    best = torch.full(p.shape[:1], float("inf"), device=p.device)
    g = torch.zeros_like(p)
    for k in range(levels):
        b = q.abs() - pitch * 0.5
        bx, by, bz = b[:, 0], b[:, 1], b[:, 2]
        sd = med3(bx, by, bz)
        if with_grad:
            # the winning level's cross: strict <, its median axis
            max_x = bx >= torch.maximum(by, bz)
            max_y = ~max_x & (by >= bz)
            min_x = bx <= torch.minimum(by, bz)
            min_y = ~min_x & (by <= bz)
            med_x = ~(max_x | min_x)
            med_y = ~(max_y | min_y | med_x)
            axis = torch.stack([med_x, med_y, ~(med_x | med_y)], dim=-1)
            cg = torch.where(axis, torch.sign(q),
                             torch.zeros((), device=p.device))
            g = torch.where((sd < best)[:, None], cg, g)
        best = torch.minimum(best, sd)
        if k + 1 < levels:
            # round half to even (jnp.round, rintf), clip to one cell
            cell = torch.clamp(torch.round(q / pitch), -1.0, 1.0)
            q = q - cell * pitch
            pitch = pitch / three
    return (best, g) if with_grad else best


def _lattice_carve(levels, tables: SceneTables, p: torch.Tensor):
    """min over a collapsing group's carve crosses at p [N, 3] -> [N]: the
    arithmetic of fold.cuh's lattice_carve (pallas_march
    ._menger_carve_lattice).  Bitwise equal to the leaf fold while
    ``tables.lattice_ok`` holds: a min returns one of its inputs, and the
    cross SDF, a median, is monotone in each axis excess."""
    pos, aux = tables.prim_pos, tables.prim_aux
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    best = torch.full(p.shape[:1], float("inf"), device=p.device)
    for lv in levels:
        if lv.members is None:      # a level of one cross
            b = (p - pos[lv.size_row]).abs() - aux[lv.size_row] * 0.5
            best = torch.minimum(best, med3(b[:, 0], b[:, 1], b[:, 2]))
            continue
        hx, hy, hz = aux[lv.size_row] * 0.5
        a = torch.stack([((px - pos[m, 0]).abs() - hx).min(dim=1).values
                         for m in lv.members], dim=1)      # [N, x-sets]
        by = (py - pos[lv.col_y, 1]).abs() - hy            # [N, columns]
        bz = (pz - pos[lv.col_z, 2]).abs() - hz
        best = torch.minimum(
            best, med3(a[:, lv.col_xset], by, bz).min(dim=1).values)
    return best


def _lattice_carve_idx(levels, tables: SceneTables, p: torch.Tensor):
    """(min over a collapsing group's carve crosses, table row of the
    cross that attains it) at p [N, 3] -> ([N], [N] int64): the
    arithmetic and the winner of fold.cuh's lattice_carve_idx
    (pallas_march._menger_carve_lattice_idx_grad).  The value is
    ``_lattice_carve``'s.  The winner is the first minimal cross in the
    stream's order: an x-set keeps its first minimal member, a level its
    first minimal column (``torch.min`` over a dim returns the first
    minimal index), and a later level wins only with strict <."""
    pos, aux = tables.prim_pos, tables.prim_aux
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    best = torch.full(p.shape[:1], float("inf"), device=p.device)
    brow = torch.zeros(p.shape[:1], dtype=torch.int64, device=p.device)
    for lv in levels:
        if lv.members is None:      # a level of one cross
            b = (p - pos[lv.size_row]).abs() - aux[lv.size_row] * 0.5
            sd = med3(b[:, 0], b[:, 1], b[:, 2])
            row = torch.full_like(brow, lv.size_row)
        else:
            hx, hy, hz = aux[lv.size_row] * 0.5
            mins = [((px - pos[m, 0]).abs() - hx).min(dim=1)
                    for m in lv.members]
            a = torch.stack([m.values for m in mins], dim=1)  # [N, x-sets]
            member = torch.stack([m.indices for m in mins], dim=1)
            by = (py - pos[lv.col_y, 1]).abs() - hy           # [N, columns]
            bz = (pz - pos[lv.col_z, 2]).abs() - hz
            sd, col = med3(a[:, lv.col_xset], by, bz).min(dim=1)
            xset = torch.as_tensor(lv.col_xset, device=p.device)[col]
            rows = torch.as_tensor(lv.col_rows, device=p.device)
            row = rows[col, member.gather(1, xset[:, None])[:, 0]]
        take = sd < best
        best = torch.where(take, sd, best)
        brow = torch.where(take, row, brow)
    return best, brow


def _kernel_fold_block(plan: ScenePlan, tables: SceneTables, p, with_idx,
                       with_grad, collapse, fused=False):
    from ..tables import is_cullable

    kp: KernelPlan = plan.kernel
    layout = _fold_layout(kp, collapse, fused)
    blocks, carves = layout.blocks, layout.carves
    carve_grads = []
    leaf = leaf_sd(plan, tables, p, layout.leaves)
    n = leaf.shape[0]
    rsign = 1.0 if kp.root_op == MIN else -1.0
    running = torch.full((n,), float("inf"), device=p.device)
    ridx = torch.full((n,), -1, dtype=torch.int32, device=p.device)
    counted = torch.zeros((), dtype=torch.int64, device=p.device)
    collapsed = torch.zeros((), dtype=torch.int64, device=p.device)
    for gi, g in enumerate(kp.groups):
        first, folded = layout.first[gi], layout.folded[gi]
        scales = torch.as_tensor(np.asarray(g.scales[:folded], np.float32),
                                 device=p.device)
        seg = leaf[:, first:first + folded] * scales
        if LeafCount._open:
            cullable = is_cullable(kp, g) or gi in carves
            nb = _base_leaves(g) if cullable else g.count
            counted += n * nb
            if nb < g.count:
                kept = (-seg[:, :nb].min(dim=-1).values < running).sum()
                if gi in carves:
                    collapsed += kept * (carves[gi][1] + (
                        OPS_PER_WINNER_SELECT if with_grad else 0))
                elif gi in blocks:
                    counted += kept * blocks[gi].singles
                    collapsed += kept * (blocks[gi].ops_idx if with_grad
                                         else blocks[gi].ops)
                else:
                    counted += kept * (g.count - nb)
        # torch.min over a dim returns the first minimal index: the
        # strict-< leaf fold's winner
        gmin, k = seg.min(dim=-1)
        k = k + g.start
        if gi in carves:
            # max(base, -carve): the base wins ties; the colour winner
            # stays the base leaf, the gradient fold's names the carve
            run = carves[gi][0]
            if with_grad:
                cm, cg = _fused_carve(run, tables, p, with_grad=True)
                k = torch.where(cm < gmin, run[3], k)
                carve_grads.append((run[3], cg))
            else:
                cm = _fused_carve(run, tables, p)
            gmin = torch.minimum(gmin, cm)
        elif gi in blocks and with_grad:
            # the base leaves are earlier in the table: they win ties
            cm, crow = _lattice_carve_idx(blocks[gi].levels, tables, p)
            k = torch.where(cm < gmin, crow, k)
            gmin = torch.minimum(gmin, cm)
        elif gi in blocks:
            gmin = torch.minimum(
                gmin, _lattice_carve(blocks[gi].levels, tables, p))
        v = rsign * (float(g.gsign) * gmin)
        better = v < running
        running = torch.where(better, v, running)
        if with_idx or with_grad:
            ridx = torch.where(better, k.to(torch.int32), ridx)
    for c in LeafCount._open:
        c._leaves.append(counted)
        c._collapsed.append(collapsed)
        c.points += n
    if not with_grad:
        return rsign * running, ridx
    # Only the winner's gradient survives the fold's selects, and sign
    # flips are exact: the winning leaf's gradient times its path sign
    # gsign * scale (the root's rsign cancels) is the fold's, bitwise.
    sign_eff = torch.as_tensor(leaf_signs(plan), device=p.device)
    ptype = torch.zeros(sign_eff.shape, dtype=torch.int64, device=p.device)
    ptype[:plan.num_primitives] = torch.as_tensor(plan.prim_type)
    dense = (ridx >= 0) & (ridx < sign_eff.shape[0])
    w = torch.where(dense, ridx, 0).long()
    g = sign_eff[w][:, None] * prim_sd_grad(ptype[w], tables.prim_pos[w],
                                            tables.prim_aux[w], p)
    g = torch.where(dense[:, None], g, torch.zeros((), device=p.device))
    # a carve's path sign is -1: the group is max(base, -carve)
    for ext, cg in carve_grads:
        g = torch.where((ridx == ext)[:, None], -cg, g)
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
                with_idx: bool = False, *, with_grad: bool = False,
                collapse: bool = True, fused: bool = False) -> tuple:
    """The two-level kernel-form fold at p [..., 3] -> (sd [...], winner
    leaf id [...] int32, -1 where nothing won; None unless ``with_idx``),
    or with ``with_grad`` (sd, winner, d scene / dp [..., 3], zero where
    nothing won): the combined mode of the JAX surface kernel.  Less its
    winner it is also the gradient-only analytic mode and the analytic
    normal of the render kernels (the winner's gradient, which is the one
    JAX's gradient-carrying fold ``_scene_sd_grad_tile`` keeps off ties).

    With ``collapse`` the value fold (neither ``with_idx`` nor
    ``with_grad``) and the ``with_grad`` fold take a Menger group's carve
    through the lattice collapse while ``tables.lattice_ok`` holds for the
    live tables, as the CUDA folds do; there the ``with_grad`` winner is
    the first minimal cross in the collapse stream's order, which on a
    tie between crosses may be another member of the tie class than the
    leaf fold's.  The colour winner (``with_idx``) stays leaf by leaf, as
    the kernels' does.  The collapse and the DIFFERENCE base-bound cull
    leave every value unchanged, so the twin applies no cull.

    With ``fused`` the fold is the kernels' fused generator field (the
    fused packing of ``tables.pack_plan``): a generator group is max(base,
    -carve) with its carve from the base row (``_fused_carve``, no floor
    under the DeathStar's square root, as in the kernels); its colour
    winner is the base leaf, and in the ``with_grad`` fold a carve that
    wins reports the extended winner id P + ordinal
    (``_scene_sd_idx_grad_tile``) with the carve's gradient, negated."""
    if plan.kernel is None:
        raise NotImplementedError(
            "depth > 2 scenes are not ported yet (ROADMAP Queue 2, D8)")
    if collapse:
        from ..tables import lattice_ok

        flag = (lattice_ok(plan.kernel, tables, fused=True) if fused
                else lattice_ok(plan.kernel, tables))
        collapse = (with_grad or not with_idx) and bool(flag)
    # the collapsed crosses leave the leaf matrix; a level's columns (its
    # two axis excesses) are the widest tensors then
    layout = _fold_layout(plan.kernel, collapse, fused)
    width = sum(layout.folded) + 2 * max(
        (b.widest for b in layout.blocks.values()), default=0)
    out = _blocked(lambda q: _kernel_fold_block(plan, tables, q, with_idx,
                                                with_grad, collapse, fused),
                   width, p)
    if with_grad:
        return out
    sd, idx = out
    return sd, (idx if with_idx else None)


def _menger_carve_ad(pos, size, levels: int, p: torch.Tensor) -> torch.Tensor:
    """JAX's core.sdf._menger_carve_jnp: the space-folded Menger union, a
    function of the base box's centre ``pos`` [3] and size ``size`` under
    autograd (round and clip have zero gradient)."""
    q = p - pos
    pitch = size / 3.0
    carve = torch.full(p.shape[:-1], float("inf"), dtype=p.dtype,
                       device=p.device)
    for k in range(levels):
        b = q.abs() - pitch * 0.5
        carve = torch.minimum(carve, med3(b[..., 0], b[..., 1], b[..., 2]))
        if k + 1 < levels:
            cell = torch.clamp(torch.round(q / pitch), -1.0, 1.0)
            q = q - cell * pitch
            pitch = pitch / 3.0
    return carve


def _deathstar_carve_ad(pos, r, p: torch.Tensor) -> torch.Tensor:
    """JAX's core.sdf._deathstar_carve_jnp: the sphere derived from the base
    row (centre + 1.5 r in x, radius r), with the 1e-24 floor under the
    square root."""
    shift = torch.stack([1.5 * r, torch.zeros_like(r), torch.zeros_like(r)])
    d = p - (pos + shift)
    return torch.sqrt(torch.clamp_min((d * d).sum(dim=-1), 1e-24)) - r


def scene_sd_fused(plan: ScenePlan, tables: SceneTables,
                   p: torch.Tensor) -> torch.Tensor:
    """The fused generator field at p [..., 3] as JAX's
    ``core.sdf.scene_sd_fused`` writes it, differentiable in ``tables``
    and p: a Menger group is max(box, -folded carve) and a DeathStar group
    max(sphere, -derived carve), both functions of the base row alone, so
    gradients reach the generator's own position and size and never the
    carve rows; every other group is its exact leaf fold.  The field the
    fused FD backward and the multi-kernel backend's implicit-function
    backward differentiate (the kernels evaluate the same field; this one
    keeps JAX's floor under the DeathStar's square root)."""
    from ..tables import fused_groups

    kp: KernelPlan = plan.kernel
    if kp is None:
        raise NotImplementedError(
            "depth > 2 scenes are not ported yet (ROADMAP Queue 2, D8)")
    fused_groups(kp)                    # the form the kernels take
    rsign = 1.0 if kp.root_op == MIN else -1.0
    flat = p.reshape(-1, 3)
    running = torch.full(flat.shape[:1], float("inf"), dtype=p.dtype,
                         device=p.device)
    for g in kp.groups:
        if g.fused is not None:
            base = leaf_sd(plan, tables, flat, [g.start])[:, 0]
            pos, aux = tables.prim_pos[g.start], tables.prim_aux[g.start]
            carve = (_deathstar_carve_ad(pos, aux[0], flat)
                     if g.fused[0] == "deathstar"
                     else _menger_carve_ad(pos, aux[0], g.fused[1], flat))
            gval = torch.maximum(base, -carve)
        else:
            rows = np.arange(g.start, g.start + g.count)
            scales = torch.as_tensor(np.asarray(g.scales, np.float32),
                                     device=p.device)
            gmin = (leaf_sd(plan, tables, flat, rows) * scales).min(dim=-1)[0]
            gval = float(g.gsign) * gmin
        running = torch.minimum(running, rsign * gval)
    return (rsign * running).reshape(p.shape[:-1])
