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

The culls of the kernels' folds (pallas_march's D5, the wide-UNION chunk
cull, and D4, the deep-sponge subtree walks; ``tables.cull_blocks``) are
exact: a skipped chunk or cell cannot win a strict-< selection.  So
``kernel_fold``'s values and winners are the same with and without them,
and the twin has both forms: with ``cull`` (the default, ``CULL``) it
takes the kernels' per-lane skip decisions in the kernels' walk order,
masking what they skip, and ``LeafCount`` counts the chunks and cells
tested and skipped and the leaves actually folded; without, every leaf
folds.  A culled kernel is bitwise both.

A procedural fractal leaf (``plan.proc``: Mandelbox, Mandelbulb, Julia) is
a column of its own in the leaf matrix (``core.proc``'s DEs), and in
``kernel_fold``'s gradient form a procedural winner's gradient is its
forward-mode sweep, the kernels' arithmetic (no autograd).

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
from .proc import grad_ops, proc_grad, proc_sd, value_ops

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
    with ``leaves`` (an index array) of those leaves only.  Each primitive
    type is evaluated on its own leaves only (the columns are put back in
    leaf order), so a sponge's crosses cost one SDF each, under autograd
    too; a procedural leaf (``plan.proc``) is its own column
    (``core.proc``)."""
    pos, aux = tables.prim_pos, tables.prim_aux
    ids = np.arange(plan.num_primitives) if leaves is None else \
        np.asarray(leaves, np.int64)
    ptype = np.asarray(plan.prim_type, np.int32)[ids]
    if leaves is not None:
        rows = torch.as_tensor(leaves, device=p.device)
        pos, aux = pos[rows], aux[rows]
    kinds = np.unique(ptype)
    if len(kinds) <= 1 and not plan.proc:   # one type, or no leaves: [N, 0]
        return _prim_sd(int(kinds[0]) if len(kinds) else int(PrimType.BOX),
                        p, pos, aux)
    specs = proc_specs(plan)
    parts, order = [], []
    for kind in kinds:
        rows_k = np.nonzero(ptype == kind)[0]
        if kind >= int(PrimType.MANDELBOX):
            parts += [proc_sd(specs[int(ids[r])], p, pos[r], aux[r, 0])[:, None]
                      for r in rows_k]
        else:
            r = torch.as_tensor(rows_k, device=p.device)
            parts.append(_prim_sd(int(kind), p, pos[r], aux[r]))
        order.append(rows_k)
    back = torch.as_tensor(np.argsort(np.concatenate(order)), device=p.device)
    return torch.cat(parts, dim=1).index_select(1, back)


@functools.lru_cache(maxsize=64)
def proc_specs(plan) -> dict:
    """leaf -> its ``plan.proc`` entry (leaf, kind, param, iters)."""
    return {int(spec[0]): spec for spec in plan.proc}


def _proc_ops(plan: ScenePlan, lo: int, hi: int) -> int:
    """Operations the procedural leaves lo <= leaf < hi take beyond
    OPS_PER_LEAF each, in one value evaluation of every one of them."""
    return sum(value_ops(kind, iters) - OPS_PER_LEAF
               for (leaf, kind, _, iters) in plan.proc if lo <= leaf < hi)


def _prim_sd(kind: int, p: torch.Tensor, pos: torch.Tensor,
             aux: torch.Tensor) -> torch.Tensor:
    """[N, K] signed distances of K leaves of one primitive type (any
    type but a sphere or a box is a cross)."""
    d = p[:, None, :] - pos                              # [N, K, 3]
    if kind == int(PrimType.SPHERE):
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        # the JAX oracle's 1e-24 floor (value-neutral for distances >= 1e-12)
        return (torch.sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz,
                                           1e-24)) - aux[:, 0])
    b = d.abs() - aux * 0.5
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    if kind == int(PrimType.BOX):
        return torch.maximum(torch.maximum(bx, by), bz)
    return med3(bx, by, bz)


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
    (sd [N], colour leaf index [N] int32 or None; -1 = empty list).

    A list's operands are taken from the leaf matrix with one
    ``index_select`` (its leaves) and put in entry order with another, so
    that autograd's backward of a wide list is one scatter, not one
    [N, P] buffer per leaf; the values and the winner are the left fold's
    all the same."""
    n, dev = leaf.shape[0], leaf.device
    results = []
    for lp in plan.lists:
        if not lp.entries:
            results.append((torch.full((n,), float("inf"), device=dev),
                            torch.full((n,), -1, dtype=torch.int32,
                                       device=dev)))
            continue
        leaves = [idx for kind, idx, _ in lp.entries if kind == KIND_LEAF]
        subs = [idx for kind, idx, _ in lp.entries if kind != KIND_LEAF]
        # position of each entry in [leaves..., sub-lists...]
        order, nl, ns = [], 0, len(leaves)
        for kind, _, _ in lp.entries:
            if kind == KIND_LEAF:
                order.append(nl)
                nl += 1
            else:
                order.append(ns)
                ns += 1
        cols = [leaf.index_select(1, torch.tensor(leaves, device=dev))] \
            if leaves else []
        cols += [results[i][0][:, None] for i in subs]
        stack = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
        if order != list(range(len(order))):
            stack = stack.index_select(1, torch.tensor(order, device=dev))
        neg = torch.tensor([e[2] for e in lp.entries], device=dev)
        if bool(neg.any()):
            stack = torch.where(neg, -stack, stack)
        # argmin/argmax return the first extremum: the reference's left
        # fold with first-operand-wins ties
        k = stack.argmin(-1) if lp.op == MIN else stack.argmax(-1)
        sd = stack.gather(-1, k[:, None])[:, 0]
        ci = None
        if with_color:
            ids = [torch.tensor(leaves, dtype=torch.int32,
                                device=dev).expand(n, -1)] if leaves else []
            ids += [results[i][1][:, None] for i in subs]
            ids = torch.cat(ids, dim=1) if len(ids) > 1 else ids[0]
            if order != list(range(len(order))):
                ids = ids.index_select(1, torch.tensor(order, device=dev))
            ci = ids.gather(-1, k[:, None])[:, 0]
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
# The culls (csrc/fold.cuh): a chunk's test, max over three axis excesses
# against the running value (3 sub, 3 abs, 3 sub, 2 max, the compare); a
# Menger cell's, the median of three margin excesses from its centre (3
# products and sums, 3 sub, 3 abs, 3 sub, the median's 4, the compare);
# the two-level collapse of one level-1 subtree (its root cross a leaf's
# 12, 27 level-2 and 81 level-3 axis excesses, 2 + 8 x 5 for level 2's
# eight columns, 11 + 64 x 5 for level 3's pairs).
OPS_PER_CHUNK_TEST, OPS_PER_CELL_TEST = 12, 20
OPS_SUBTREE_COLLAPSE = 12 + 27 + 81 + 42 + 331

# Whether kernel_fold takes the kernels' culls (its ``cull`` default).
CULL = True


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
    fold).  A procedural leaf counts as a leaf plus the rest of its
    iterated DE's operations (``core.proc.value_ops``), and in the
    winner-and-gradient fold a point it wins adds its gradient sweep
    (``core.proc.grad_ops``).
    The plain twin itself may evaluate more; this is the count of what
    the kernels' data needs.

        with LeafCount() as c:
            render_rays_plain(...)
        c.leaves, c.ops, c.points

    ``leaves``: leaf evaluations; ``ops``: OPS_PER_LEAF for each of them
    plus the collapsed levels' and the procedural leaves' operations.
    With the culls (``kernel_fold(cull=True)``) ``leaves`` are the leaves
    the culled fold actually folds, ``ops`` adds each chunk and cell test
    and subtree collapse, and ``chunks_tested``, ``chunks_skipped``,
    ``cells_tested`` and ``cells_skipped`` count D5's chunk tests and D4's
    cell tests (level-1 margins, the value bound, level-2 margins), each
    at the points that reach it.
    """

    _open: list = []

    def __init__(self):
        self._leaves = []
        self._collapsed = []
        self._tests = []
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

    def _test_sum(self, k: int) -> int:
        return int(sum(int(t[k].item()) for t in self._tests))

    @property
    def chunks_tested(self) -> int:
        return self._test_sum(0)

    @property
    def chunks_skipped(self) -> int:
        return self._test_sum(1)

    @property
    def cells_tested(self) -> int:
        return self._test_sum(2)

    @property
    def cells_skipped(self) -> int:
        return self._test_sum(3)


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
                 fused: bool = False, winner: bool = False) -> _FoldLayout:
    """The leaf fold's layout, or with ``collapse`` the one in which each
    collapsing group keeps its base leaves only; with ``fused`` a
    generator group keeps its base leaf (the fused packing's).  With
    ``winner`` (the winner-and-gradient fold) a group whose lattice is too
    wide for the winner collapse (``tables.lattice_idx_ok``) keeps every
    leaf, as the kernels' PathWinner fold does."""
    from ..tables import GROUP_FUSED, lattice_idx_ok, pack_plan

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
                  for gi in range(len(kp.groups)) if lat[gi] != 0
                  and (not winner or lattice_idx_ok(kp.groups[gi]))}
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


class _Cull(NamedTuple):
    """What the culled twin reads: the cull blocks by group
    (``tables.cull_blocks``), the cull rows (``tables.cull_rows``) and
    their first table row, and whether the subtree collapse's flag
    holds."""

    blocks: dict
    rows: torch.Tensor
    row0: int
    sub_ok: bool


@functools.lru_cache(maxsize=64)
def _cull_blocks(kp: KernelPlan, fused: bool):
    """(cull blocks by group, first cull row) of the packing, or None."""
    from ..tables import cull_blocks, pack_plan

    packed = pack_plan(kp, fused)
    if not packed.cull:
        return None
    return cull_blocks(kp, fused, packed.cull_row), packed.cull_row


# The last _cull_context: its key, the tensors it was built from with their
# versions, and the context (a march asks for the same one at every step).
_LAST_CULL: list = [None]


def _cull_context(kp: KernelPlan, tables: SceneTables, fused: bool,
                  collapse: bool) -> Optional[_Cull]:
    """The culled twin's inputs for one ``kernel_fold`` call, from the live
    tables as ``tables.scene_operands`` builds the kernels'; None when the
    plan takes no cull.  Kept while the same tensors, unmodified in place,
    come back."""
    from ..tables import cull_rows, subtree_collapse_ok

    static = _cull_blocks(kp, fused)
    if static is None:
        return None
    live = (tables.prim_pos, tables.prim_aux, tables.cam_position)
    key = (kp, fused, bool(collapse))
    last = _LAST_CULL[0]
    if (last is not None and last[0] == key
            and all(a is b and v == b._version
                    for a, v, b in zip(last[1], last[2], live))):
        return last[3]
    blocks, row0 = static
    rows = cull_rows(kp, tables)
    sub_ok = bool(collapse) and bool(subtree_collapse_ok(kp, tables))
    ctx = _Cull(blocks, rows, row0, sub_ok)
    _LAST_CULL[0] = (key, live, tuple(t._version for t in live), ctx)
    return ctx


def _walk_fold(m, k, lb, init, winner: bool):
    """The culled fold of a walk's items at every point at once: ``m``
    [N, I] the items' minima in walk order (``k`` [N, I] the column of
    each one's first minimal leaf), ``lb`` [N, I] the bound an item is
    skipped behind (-inf: never), ``init`` the carry before the walk.  An
    item is skipped where its bound reaches the running value before it;
    skips are exact, so that running value is the prefix minimum of every
    earlier item, and the decisions need no sequential loop.  -> (value
    [N], its column [N] or None, skipped [N, I])."""
    v0 = init[0] if winner else init
    prefix = torch.cat([v0[:, None], m[:, :-1]], dim=1).cummin(dim=1).values
    skip = lb >= prefix
    masked = torch.where(skip, torch.full_like(m, float("inf")), m)
    best, at = masked.min(dim=1)
    if not winner:
        return torch.minimum(v0, best), None, skip
    better = best < v0
    col = k.gather(1, at[:, None])[:, 0]
    return (torch.where(better, best, v0), torch.where(better, col, init[1]),
            skip)


def _chunk_group(seg, g, blk, cull: _Cull, p, running, ridx, ordered: bool,
                 winner: bool, tally):
    """D5 (pallas_march._bvh_group_fold): a chunked group (gsign +1 under
    a MIN root) folded straight into the root's (running, ridx), its runs
    in run order; a chunked run's chunks in the order rows' order in the
    value fold (``ordered``), else in leaf order, each skipped at the
    points whose lower bound max_a(|p_a - c_a| - h_a) over its live box
    reaches the running value.  ``tally``: leaves folded, chunks tested
    and skipped."""
    n = seg.shape[0]
    ms, ks, lbs, sizes = [], [], [], []
    col = 0
    for ri, run in enumerate(g.runs):
        brow, nch, clen, uni, obase = blk[5 * ri:5 * ri + 5]
        count = run[2]
        if nch == 0:
            m, k = seg[:, col:col + count].min(dim=1)
            ms.append(m[:, None])
            ks.append((k + col)[:, None])
            lbs.append(torch.full((n, 1), float("-inf"), device=p.device))
            sizes.append(torch.full((1,), count, device=p.device))
            col += count
            continue
        o = torch.arange(nch, device=p.device)
        if ordered and obase >= 0:
            o0 = obase - cull.row0
            o = torch.cat([cull.rows[o0:o0 + uni, 0].long(), o[uni:]])
        full = (count // clen) * clen
        m, k = seg[:, col:col + full].reshape(n, -1, clen).min(dim=2)
        k = k + col + clen * torch.arange(m.shape[1], device=p.device)
        if full < count:
            mt, kt = seg[:, col + full:col + count].min(dim=1)
            m = torch.cat([m, mt[:, None]], dim=1)
            k = torch.cat([k, (kt + col + full)[:, None]], dim=1)
        b = cull.rows[brow - cull.row0:brow - cull.row0 + nch]
        e = (p[:, None, :] - b[None, :, :3]).abs() - b[None, :, 3:6]
        lb = torch.maximum(torch.maximum(e[..., 0], e[..., 1]), e[..., 2])
        ms.append(m[:, o])
        ks.append(k[:, o])
        lbs.append(lb[:, o])
        sizes.append(torch.clamp(count - o * clen, max=clen))
        col += count
    m, k, lb = torch.cat(ms, 1), torch.cat(ks, 1), torch.cat(lbs, 1)
    init = (running, ridx.long() - g.start) if winner else running
    v, kk, skip = _walk_fold(m, k, lb, init, winner)
    tested = lb > float("-inf")
    tally[0] += (~skip * torch.cat(sizes)[None, :]).sum()
    tally[1] += tested.sum()
    tally[2] += (skip & tested).sum()
    if not winner:
        return v, ridx
    return v, (kk + g.start).to(torch.int32)


def _subtree_route(gi: int, blk, layout: _FoldLayout, has_lattice: bool,
                   with_idx: bool, with_grad: bool, sub_ok: bool):
    """Which walk the kernels' fold takes for deep-sponge group ``gi``
    (pallas_march's routing): None for the leaf fold or the lattice
    collapse, else "margin" (the margin walk, iters >= 5), "vbound" (the
    value-bound walk of the winner folds, iters 4 while the subtree flag
    holds) or "collapsed" (the value folds' per-subtree collapse, iters 4
    with no lattice while the flag holds)."""
    from ..tables import SUBTREE_COLLAPSES, SUBTREE_WALK

    flags = blk[0]
    if gi in layout.blocks or not flags & SUBTREE_WALK:
        return None
    value = not (with_idx or with_grad)
    if value and has_lattice:
        return None
    if flags & SUBTREE_COLLAPSES:
        return ("collapsed" if value else "vbound") if sub_ok else None
    return "margin"


@functools.lru_cache(maxsize=8)
def _menger_offsets_on(device: torch.device) -> torch.Tensor:
    """[20, 3] float32 Menger cell offsets on ``device`` (cached, shared)."""
    from ..scene.generators import _MENGER_OFFSETS
    return torch.tensor(_MENGER_OFFSETS, dtype=torch.float32, device=device)


def _subtree_walk(seg, blk, tables: SceneTables, p, carry, kept, route,
                  winner: bool, tally):
    """D4's walks over the carve of a deep-sponge group (the columns of
    ``seg`` from its root row), from the carry of its base leaves, at the
    points ``kept`` by the group's base-bound cull
    (pallas_march._menger_subtree_fold, _menger_level2_walk,
    _menger_subtree_vbound_fold, _menger_subtree_collapsed): the level-0
    cross, then the 20 level-1 subtrees, each skipped where the median of
    its cell's margin excesses reaches the running value; in "vbound" a
    margin-live subtree is skipped too where its collapsed minimum does (the
    kernels' collapse is bitwise its leaf minimum while the flag holds); a
    live subtree folds its root cross, then its 20 child cells behind the
    margin at their scale.  The walk's items (the level-0 cross, then per
    subtree its root cross and its cells, or its whole carve without the
    recursion) fold by ``_walk_fold``.  ``tally``: leaves folded, further
    operations, cells tested and skipped."""
    from ..tables import SUBTREE_RECURSES

    flags, root, T, _off_row = blk
    n = seg.shape[0]
    f32 = dict(dtype=p.dtype, device=p.device)
    nk = kept.sum()
    tally[0] += nk
    sub = seg[:, 2:2 + 20 * T].reshape(n, 20, T)
    if route == "collapsed":
        tally[1] += nk * 20 * OPS_SUBTREE_COLLAPSE
        m, k = seg[:, 1:2 + 20 * T].min(dim=1)
        v, kk, _ = _walk_fold(m[:, None], (k + 1)[:, None],
                              torch.where(kept, float("-inf"),
                                          float("inf"))[:, None],
                              carry, winner)
        return (v, kk) if winner else v

    def bound(centres, margin):
        """[N, C] medians of the margin excesses of cells at ``centres``
        [C, 3]."""
        e = (p[:, None, :] - centres[None]).abs() - margin
        return med3(e[..., 0], e[..., 1], e[..., 2])

    offs = _menger_offsets_on(p.device)
    s = tables.prim_aux[root, 0]
    # float32 products with float32(1/3) and float32(2/9), as the kernels'
    third = s * (1.0 / 3.0)
    ninth = third * (1.0 / 3.0)
    centre1 = tables.prim_pos[root][None] + offs * third          # [20, 3]
    lb1 = bound(centre1, s * (2.0 / 9.0))                         # [N, 20]
    never = torch.full((n, 1), float("-inf"), **f32)
    cols = 2 + T * torch.arange(20, device=p.device)
    if flags & SUBTREE_RECURSES:
        sub2 = (T - 1) // 20
        cm, ck = sub[:, :, 1:].reshape(n, 20, 20, sub2).min(dim=3)
        centre2 = centre1[:, None] + offs[None] * ninth           # [20, 20, 3]
        lb2 = bound(centre2.reshape(-1, 3), third * (2.0 / 9.0)).reshape(
            n, 20, 20)
        m = torch.cat([sub[:, :, :1], cm], dim=2)                 # [N, 20, 21]
        k = torch.cat([torch.zeros_like(ck[:, :, :1]),
                       1 + sub2 * torch.arange(20, device=p.device) + ck],
                      dim=2) + cols[None, :, None]
        per = 21
    else:
        m, k = sub.min(dim=2)
        m, k = m[:, :, None], (k + cols[None, :])[:, :, None]
        per = 1
    # the items in walk order, and the running value before each one
    items = torch.cat([seg[:, 1:2], m.reshape(n, -1)], dim=1)
    v0 = carry[0] if winner else carry
    prefix = torch.cat([v0[:, None], items[:, :-1]], dim=1).cummin(
        dim=1).values[:, 1:].reshape(n, 20, per)
    dead1 = lb1 >= prefix[:, :, 0]                 # level-1 margin
    live1 = kept[:, None] & ~dead1
    tally[2] += 20 * nk
    tally[3] += 20 * nk - live1.sum()
    if route == "vbound":
        nl = live1.sum()
        tally[1] += nl * OPS_SUBTREE_COLLAPSE
        dead1 = dead1 | (sub.min(dim=2).values >= prefix[:, :, 0])
        live1 = kept[:, None] & ~dead1
        tally[2] += nl
        tally[3] += nl - live1.sum()
    skip = dead1[:, :, None].expand(n, 20, per).clone()
    tally[0] += live1.sum() * (1 if per == 21 else T)
    if per == 21:
        dead2 = lb2 >= prefix[:, :, 1:]
        live2 = live1[:, :, None] & ~dead2
        tally[2] += 20 * live1.sum()
        tally[3] += 20 * live1.sum() - live2.sum()
        tally[0] += live2.sum() * sub2
        skip[:, :, 1:] |= dead2
    lb = torch.where(skip.reshape(n, -1), float("inf"), float("-inf"))
    lb = torch.where(kept[:, None], torch.cat([never, lb], dim=1),
                     float("inf"))
    v, kk, _ = _walk_fold(items, torch.cat(
        [torch.ones_like(k[:, :1, 0]), k.reshape(n, -1)], dim=1), lb, carry,
        winner)
    return (v, kk) if winner else v


def _kernel_fold_block(plan: ScenePlan, tables: SceneTables, p, with_idx,
                       with_grad, collapse, fused=False, cull=None):
    from ..tables import collapses, is_cullable

    kp: KernelPlan = plan.kernel
    layout = _fold_layout(kp, collapse, fused, winner=with_grad)
    blocks, carves = layout.blocks, layout.carves
    carve_grads = []
    leaf = leaf_sd(plan, tables, p, layout.leaves)
    n = leaf.shape[0]
    rsign = 1.0 if kp.root_op == MIN else -1.0
    running = torch.full((n,), float("inf"), device=p.device)
    ridx = torch.full((n,), -1, dtype=torch.int32, device=p.device)
    counted = torch.zeros((), dtype=torch.int64, device=p.device)
    collapsed = torch.zeros((), dtype=torch.int64, device=p.device)
    # chunks tested and skipped, cells tested and skipped
    tests = [torch.zeros((), dtype=torch.int64, device=p.device)
             for _ in range(4)]
    winner = with_idx or with_grad
    for gi, g in enumerate(kp.groups):
        first, folded = layout.first[gi], layout.folded[gi]
        scales = torch.as_tensor(np.asarray(g.scales[:folded], np.float32),
                                 device=p.device)
        seg = leaf[:, first:first + folded] * scales
        blk = cull.blocks.get(gi) if cull is not None else None
        if blk is not None and g.bvh is not None:
            tally = [counted, tests[0], tests[1]]
            running, ridx = _chunk_group(seg, g, blk, cull, p, running,
                                         ridx, not winner, winner, tally)
            counted, tests[0], tests[1] = tally
            continue
        route = None if blk is None else _subtree_route(
            gi, blk, layout, collapses(kp, g), with_idx, with_grad,
            cull.sub_ok)
        if route is not None:
            nb = _base_leaves(g)
            base = seg[:, :nb].min(dim=1)
            carry = tuple(base) if winner else base.values
            kept = ~(-base.values >= running)
            tally = [counted + n * nb, collapsed, tests[2], tests[3]]
            carry = _subtree_walk(seg, blk, tables, p, carry, kept, route,
                                  winner, tally)
            counted, collapsed, tests[2], tests[3] = tally
            gmin, k = carry if winner else (carry, None)
            v = rsign * (float(g.gsign) * gmin)
            better = v < running
            running = torch.where(better, v, running)
            if winner:
                ridx = torch.where(better, (k + g.start).to(torch.int32),
                                   ridx)
            continue
        if LeafCount._open:
            cullable = is_cullable(kp, g) or gi in carves
            nb = _base_leaves(g) if cullable else g.count
            counted += n * nb
            collapsed += n * _proc_ops(plan, g.start, g.start + nb)
            if nb < g.count:
                kept = (-seg[:, :nb].min(dim=-1).values < running).sum()
                collapsed += kept * _proc_ops(plan, g.start + nb,
                                              g.start + g.count)
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
    _count(plan, n, counted, collapsed, ridx if with_grad else None, tests)
    if not with_grad:
        return rsign * running, ridx
    g = _winner_gradient(plan, tables, p, ridx)
    # a carve's path sign is -1: the group is max(base, -carve)
    for ext, cg in carve_grads:
        g = torch.where((ridx == ext)[:, None], -cg, g)
    return rsign * running, ridx, g


def _count(plan: ScenePlan, n: int, counted, collapsed, ridx,
           tests=None) -> None:
    """Hand one fold's leaf evaluations and further operations to every
    open LeafCount; with the winners ``ridx`` of a gradient fold, a
    procedural winner's gradient sweep too; ``tests``: the chunks and
    cells tested and skipped, whose tests add their operations."""
    if not LeafCount._open:
        return
    if ridx is not None:
        for (leaf, kind, _, iters) in plan.proc:
            collapsed = collapsed + (ridx == leaf).sum() * grad_ops(kind,
                                                                   iters)
    if tests is not None:
        tests = torch.stack(tests)
        collapsed = (collapsed + OPS_PER_CHUNK_TEST * tests[0]
                     + OPS_PER_CELL_TEST * tests[2])
    for c in LeafCount._open:
        c._leaves.append(counted)
        c._collapsed.append(collapsed)
        if tests is not None:
            c._tests.append(tests)
        c.points += n


def _winner_gradient(plan: ScenePlan, tables: SceneTables, p: torch.Tensor,
                    ridx: torch.Tensor) -> torch.Tensor:
    """d scene / dp [N, 3] at p [N, 3] from the fold's winning leaves ridx
    [N] (-1, or an extended id: zero).  Only the winner's gradient survives
    the fold's selects, and sign flips are exact: the winning leaf's
    gradient times its path sign (``leaf_signs``) is the fold's, bitwise;
    a procedural winner's is its forward-mode sweep."""
    sign_eff = torch.as_tensor(leaf_signs(plan), device=p.device)
    ptype = torch.zeros(sign_eff.shape, dtype=torch.int64, device=p.device)
    ptype[:plan.num_primitives] = torch.as_tensor(plan.prim_type)
    dense = (ridx >= 0) & (ridx < sign_eff.shape[0])
    w = torch.where(dense, ridx, 0).long()
    g = sign_eff[w][:, None] * prim_sd_grad(ptype[w], tables.prim_pos[w],
                                            tables.prim_aux[w], p)
    g = torch.where(dense[:, None], g, torch.zeros((), device=p.device))
    # a procedural winner's gradient is its forward-mode sweep
    for spec in plan.proc:
        sel = (ridx == spec[0]).nonzero()[:, 0]
        if sel.numel():
            lg = proc_grad(spec, p[sel], tables.prim_pos[spec[0]],
                           tables.prim_aux[spec[0], 0])
            g = g.index_put((sel,), sign_eff[spec[0]] * lg)
    return g


@functools.lru_cache(maxsize=64)
def leaf_signs(plan: ScenePlan) -> np.ndarray:
    """[P] float32 path sign of every leaf: min/max folds select but never
    scale, so for the winning leaf scene = sign * leaf sd.  In a two-level
    plan it is gsign * scale (the root's rsign cancels in the chain rule);
    in a deeper one the product of the negation flags from the root to the
    leaf, walked top-down over the post-order lists (JAX
    scene_vjp._leaf_statics).  A leafless plan gets one zero row, as its
    tables have one pad row."""
    sign = np.zeros(max(plan.num_primitives, 1), np.float32)
    if plan.kernel is not None:
        for g in plan.kernel.groups:
            for (_, start, count, scale) in g.runs:
                sign[start:start + count] = float(g.gsign * scale)
        return sign
    ctx = [0.0] * len(plan.lists)
    ctx[-1] = 1.0
    for li in range(len(plan.lists) - 1, -1, -1):
        for (kind, idx, neg) in plan.lists[li].entries:
            s = ctx[li] * (-1.0 if neg else 1.0)
            if kind == KIND_LEAF:
                sign[idx] = s
            else:
                ctx[idx] = s
    return sign


def _deep_fold_block(plan: ScenePlan, tables: SceneTables, p: torch.Tensor,
                     with_idx: bool, with_grad: bool):
    """``kernel_fold`` of a plan with no two-level form at p [N, 3]: the
    program of ``tables.pack_deep`` walked as csrc/fold.cuh's deep folds
    walk it, one accumulator a list open, over the leaf matrix."""
    from ..tables import (DEEP_CLOSE, DEEP_FIRST, DEEP_MIN, DEEP_NEG,
                          DEEP_OPEN, pack_deep)

    packed = pack_deep(plan)
    runs = packed.runs.numpy()
    leaf = leaf_sd(plan, tables, p)
    n, dev = leaf.shape[0], p.device
    inf = torch.full((n,), float("inf"), device=dev)
    none = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack = [(inf, none)]
    for code, first, n_runs, flags in packed.groups.numpy().tolist():
        if code == DEEP_OPEN:
            stack.append((inf, none))
            continue
        if code == DEEP_CLOSE:
            v, k = stack.pop()
            if flags & DEEP_NEG:
                v = -v
        else:
            # one entry's runs: consecutive leaves of one scale; the min
            # over a dim returns the first minimal index, the strict-<
            # fold's winner, which stays -1 while nothing beats inf
            lo = int(runs[first, 1])
            hi = int(runs[first + n_runs - 1, 1] + runs[first + n_runs - 1, 2])
            m, k = (leaf[:, lo:hi] * float(runs[first, 3])).min(dim=1)
            k = torch.where(m < inf, (k + lo).to(torch.int32), none)
            v = m if flags & DEEP_MIN else -m
        if flags & DEEP_FIRST:
            stack[-1] = (v, k)
            continue
        acc, ak = stack[-1]
        better = v < acc if flags & DEEP_MIN else v > acc
        stack[-1] = (torch.where(better, v, acc), torch.where(better, k, ak))
    sd, ridx = stack[0]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    _count(plan, n, zero + n * plan.num_primitives,
           zero + n * _proc_ops(plan, 0, plan.num_primitives),
           ridx if with_grad else None)
    if not with_grad:
        return sd, ridx
    return sd, ridx, _winner_gradient(plan, tables, p, ridx)


def kernel_fold(plan: ScenePlan, tables: SceneTables, p: torch.Tensor,
                with_idx: bool = False, *, with_grad: bool = False,
                collapse: bool = True, fused: bool = False,
                cull: Optional[bool] = None) -> tuple:
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
    leave every value unchanged, so the twin applies no base-bound cull
    (``LeafCount`` counts it).

    With ``fused`` the fold is the kernels' fused generator field (the
    fused packing of ``tables.pack_plan``): a generator group is max(base,
    -carve) with its carve from the base row (``_fused_carve``, no floor
    under the DeathStar's square root, as in the kernels); its colour
    winner is the base leaf, and in the ``with_grad`` fold a carve that
    wins reports the extended winner id P + ordinal
    (``_scene_sd_idx_grad_tile``) with the carve's gradient, negated.

    With ``cull`` (default ``CULL``) the fold takes the kernels' culls
    of D5 and D4 in their walk order (see the module docstring): the same
    values and winners, the kernels' skip decisions and counts.  A
    sponge too wide for the winner collapse (iters 4) takes, in the
    ``with_idx`` and ``with_grad`` folds, the value-bound subtree walk
    while ``tables.subtree_collapse_ok`` holds, else the leaf fold: its
    ``with_grad`` winner is the leaf fold's first-wins winner."""
    if cull is None:
        cull = CULL
    if plan.kernel is None:
        out = _blocked(lambda q: _deep_fold_block(plan, tables, q, with_idx,
                                                  with_grad),
                       plan.num_primitives, p)
        return out if with_grad else (out[0], out[1] if with_idx else None)
    ctx = (_cull_context(plan.kernel, tables, fused, collapse) if cull
           else None)
    if collapse:
        from ..tables import lattice_ok

        flag = (lattice_ok(plan.kernel, tables, fused=True) if fused
                else lattice_ok(plan.kernel, tables))
        collapse = (with_grad or not with_idx) and bool(flag)
    # the collapsed crosses leave the leaf matrix; a level's columns (its
    # two axis excesses) are the widest tensors then
    layout = _fold_layout(plan.kernel, collapse, fused, winner=with_grad)
    width = sum(layout.folded) + 2 * max(
        (b.widest for b in layout.blocks.values()), default=0)
    out = _blocked(lambda q: _kernel_fold_block(plan, tables, q, with_idx,
                                                with_grad, collapse, fused,
                                                ctx),
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


def require_kernel_form(plan: ScenePlan) -> KernelPlan:
    """``plan.kernel``, or ValueError for a plan with none: the fused
    generator field is defined on the two-level form only.  The JAX
    package's fused backwards assert the same (``core.sdf.scene_sd_fused``:
    "fused evaluation requires kernel normal form"); its kernels render
    such a plan's exact field, and so do the port's."""
    if plan.kernel is None:
        raise ValueError(
            "fused generators differentiate on the two-level kernel form "
            "only; this plan has lists nested deeper (its fused render is "
            "the exact field, as in the JAX package, whose fused backward "
            "asserts 'fused evaluation requires kernel normal form'): "
            "differentiate with fused_generators=False")
    return plan.kernel


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

    kp: KernelPlan = require_kernel_form(plan)
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
