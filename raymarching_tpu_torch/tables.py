"""Scene tables on a torch device, in the layout the render kernel reads.

Counterpart of ``raymarching_tpu.ops.pallas_march._build_table`` (the
primitive rows) and of the light rows built in
``raymarching_tpu.ops.pallas_render.pallas_render_rays``.  ``SceneTables``
(the parameters) and ``KernelPlan`` (the static structure) are the port's
own classes (``scene.compile``), field for field the JAX package's;
``tables_to_torch`` and ``tables_to_numpy`` read any object with those
field names, so parameters cross between the two packages without either
importing the other.

The kernels fold the two-level plan by walking small int32 descriptor
tables instead of code generated per scene, so one build serves every
scene.  ``pack_plan`` also packs ``GroupPlan.lattice`` into an int32
stream for the exact Menger lattice collapse
(``pallas_march._menger_carve_lattice`` and, with the winner rows,
``_menger_carve_lattice_idx_grad``), and ``lattice_ok`` is the JAX
table's flag row: a one-element tensor that stays on the device and tells
the kernels whether the live rows still share the lattice's coordinates.
``pack_plan(kp, fused=True)`` is the packing of
``RenderConfig.fused_generators`` (pallas_march's D6): a generator group
keeps its base leaf and a carve descriptor, and the kernels evaluate its
carve from the base row.  A procedural fractal leaf's run has its own
type (``PROC_TYPES``), and ``scene_operands`` appends one procedural row a
leaf (its fold scale or Julia constant) that the leaf's row points to
beside its iteration count (pallas_march's D7).

The culls of pallas_march's D5 (the wide-UNION chunk cull,
``_bvh_group_fold``) and D4 (the deep-sponge subtree walks,
``_menger_subtree_fold`` and its kin) read rows that ``cull_rows``
computes from the live tables at every call, as the JAX table's
``_build_table`` does: one live bounding box a chunk, the 20 Menger
offset rows, and the nearest-camera chunk order.  ``scene_operands``
appends them to the table, and ``pack_plan`` describes each culled group
in the collapse stream (see ``PackedPlan``); the kernels then take their
``Cull<S>`` view.  The flag gains ``subtree_collapse_ok``, the JAX flag
row's column 1.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .scene.compile import (KIND_LIST, MIN, KernelPlan, ScenePlan,
                            SceneTables, iter_bvh_chunks)
from .scene.generators import _MENGER_OFFSETS
from .utils.timing import span

# DIFFERENCE groups at least this large get the base-bound cull
# (the rule of pallas_march._scene_sd_tile, _CULL_MIN_GROUP).
CULL_MIN_GROUP = 8

# The fourth field of a group descriptor: 0 an exact group the kernels fold
# leaf by leaf, 1 one that also takes the base-bound cull, GROUP_FUSED a
# fused generator group (csrc/fold.cuh's kGroupFused).
GROUP_FUSED = 2

# The prim type of a fused generator's base leaf, the leaf at g.start
# (pallas_march._FUSED_BASE_TYPE).
FUSED_BASE_TYPE = {"menger": 1, "deathstar": 0}     # BOX, SPHERE

# The run types the kernels' folds take (csrc/fold.cuh's fold_run):
# scene.csg.PrimType's sphere, box and cross, and the procedural leaves
# (csrc/proc.cuh), whose ScenePlan.proc kinds map to their prim types.
DENSE_TYPES = (0, 1, 2)
PROC_TYPES = {"mb": 3, "bulb": 4, "julia": 5}


class PackedPlan(NamedTuple):
    """A ``KernelPlan`` as int32 descriptor tensors (on the host).

    ``groups`` [G, 4]: gsign, first run, number of runs, and 0, 1 (the
    base-bound cull) or GROUP_FUSED.
    ``runs`` [N, 4]: prim type, first leaf, leaf count, scale (+-1).  In
    the fused packing a generator group's runs are its base leaf (scale
    -1), and the run after them is its carve: (Menger levels, or 0 for a
    DeathStar; the base row; 0; the extended winner id P + ordinal, P the
    plan's leaf count and ordinal the group's place among the fused
    groups).  Its ``lattice`` entry is 0.
    ``lattice`` [max(G, 1) + ...]: entry g is the offset in this stream of
    group g's collapse block, 0 where it has none.  A block is the number
    of levels and the offset of the block's winner rows, then per level
    ``n_xsets, size_row``: with ``n_xsets`` 0 the level is the one cross
    ``size_row``; else ``size_row`` is the row every cross of the level
    shares its size with, and per distinct x-set follow ``n_members,
    n_columns``, the members' representative rows (their x coordinate is
    read), and per column of that x-set the representative rows of its y
    and of its z coordinate.  The winner rows follow the levels, in the
    order the levels, x-sets and columns are walked: one row for a level
    of one cross, and per column the table row of its cross at each member
    of its x-set (``n_members`` rows, in the members' order).  A kernel
    that stages the stream resolves the representative rows to their
    coordinates and leaves the winner rows as they are.
    ``members`` [2, 6 M] int64, for ``lattice_ok``: for each of the M
    lattice crosses the element (8 row + column, an index into the
    flattened ``build_table`` rows) of its x, y, z coordinate and its
    three sizes, over the element of the row that represents each; M = 0
    without a lattice.
    ``proc_leaves`` [K] int64, ``proc_iters`` [K] float32 and
    ``proc_params`` [K, 8] float32, for ``scene_operands``: the plan's K
    procedural leaves (``KernelPlan.proc``, whose runs have type
    PROC_TYPES[kind]), each one's iteration count, and its procedural row:
    the Mandelbox's fold scale, the Mandelbulb's power or the Julia
    constant in the first four columns.
    ``cull`` is 1 when a group takes a cull of D5 or D4 (``cull_blocks``),
    and ``cull_row`` is then the first row of ``cull_rows`` in the table
    the kernels read: P + K, past the leaves and the procedural rows.  The
    stream then holds, after the G collapse offsets, G cull offsets (0: no
    cull block) and the cull blocks, and the collapse blocks after them.
    A chunked group's block is five entries a run of the group, in run
    order: the run's first bound row, its chunk count (0: the run is not
    chunked), the chunk length, the uniform prefix (``uniform_prefix``)
    and its first order row, or -1 when it has none.  A deep-sponge
    group's block is four: its flags (SUBTREE_WALK, SUBTREE_COLLAPSES,
    SUBTREE_RECURSES, WINNER_LEAF_FOLD), its root row, the crosses a
    level-1 subtree holds and the first Menger offset row, or -1.
    """

    root_op: int
    groups: torch.Tensor
    runs: torch.Tensor
    lattice: torch.Tensor
    members: torch.Tensor
    proc_leaves: torch.Tensor
    proc_iters: torch.Tensor
    proc_params: torch.Tensor
    cull: int = 0
    cull_row: int = 0


def tables_to_torch(tables, device,
                    requires_grad: Sequence[str] = ()) -> SceneTables:
    """The port's ``SceneTables`` with every field a float32 tensor on
    ``device``.  ``tables`` is any object with the SceneTables field names
    (the port's class or the JAX package's; numpy arrays or tensors, no
    copy where they already match).  The fields named in ``requires_grad``
    become fresh leaf tensors that require grad: copies, so an optimizer's
    in-place update never writes into the caller's arrays."""
    unknown = set(requires_grad) - set(SceneTables._fields)
    if unknown:
        raise ValueError(f"unknown SceneTables fields {sorted(unknown)}")
    out = []
    device = torch.device(device)
    for name in SceneTables._fields:
        v = getattr(tables, name)
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
        t = torch.as_tensor(v, dtype=torch.float32, device=device)
        if name in requires_grad:
            t = t.detach().clone().requires_grad_()
        out.append(t)
    return SceneTables(*out)


def tables_to_numpy(tables) -> SceneTables:
    """``SceneTables`` of float32 host arrays from any object with its
    field names: what a checkpoint stores, and what the JAX package takes
    field by field (``JaxSceneTables(**t._asdict())``)."""
    return SceneTables(*(np.asarray(
        torch.as_tensor(getattr(tables, name)).detach().cpu(), np.float32)
        for name in SceneTables._fields))


def build_table(tables: SceneTables) -> torch.Tensor:
    """[P, 8] primitive rows: centre xyz, aux xyz, two pad columns (the
    body rows of the JAX kernel table)."""
    pos = tables.prim_pos
    pad = torch.zeros((pos.shape[0], 2), dtype=pos.dtype, device=pos.device)
    return torch.cat([pos, tables.prim_aux, pad], dim=1).contiguous()


def light_rows(tables: SceneTables) -> torch.Tensor:
    """[L, 8] light rows: position xyz, pad, colour rgb, pad."""
    pos = tables.light_pos
    pad = torch.zeros((pos.shape[0], 1), dtype=pos.dtype, device=pos.device)
    return torch.cat([pos, pad, tables.light_color, pad], dim=1).contiguous()


def is_cullable(kp: KernelPlan, g) -> bool:
    """Whether group ``g`` takes the exact DIFFERENCE base-bound cull:
    gsign -1 under a MIN root, with base (scale -1) runs, and at least
    CULL_MIN_GROUP leaves (pallas_march.py, _scene_sd_tile)."""
    has_base = any(r[3] == -1 for r in g.runs)
    return (g.gsign == -1 and kp.root_op == MIN and has_base
            and g.count >= CULL_MIN_GROUP)


def fused_groups(kp: KernelPlan) -> list:
    """The groups that the fused packing evaluates by their generator, in
    plan order: the position of one in this list is its ordinal, and its
    extended winner id is ``ext_base(kp)`` plus that (scene_vjp
    ._fused_statics).  Raises NotImplementedError for a fused group that is
    not a DIFFERENCE of one base leaf under a MIN root (the reference
    grammar makes none; JAX folds such a group differently in its value
    fold and its winner folds)."""
    out = [g for g in kp.groups if g.fused is not None]
    for g in out:
        base = [r for r in g.runs if r[3] == -1]
        if (kp.root_op != MIN or g.gsign != -1 or len(base) != 1
                or base[0] != g.runs[0] or base[0][1:3] != (g.start, 1)
                or base[0][0] != FUSED_BASE_TYPE[g.fused[0]]):
            raise NotImplementedError(
                f"fused generator group {g.fused} not of the form "
                "max(base leaf, -carve) under a MIN root")
    return out


def ext_base(kp: KernelPlan) -> int:
    """P, the first extended winner id: the row past the plan's leaves
    (pallas_march._flag_row)."""
    g = kp.groups[-1]
    return g.start + g.count


def collapses(kp: KernelPlan, g) -> bool:
    """Whether group ``g``'s carve takes the lattice collapse while the
    flag holds: a Menger lattice on a DIFFERENCE group under a MIN root
    (the case pallas_march._scene_sd_tile collapses), which is always
    cullable."""
    return g.lattice is not None and is_cullable(kp, g)


# D4's routing (pallas_march._use_subtree and its predicates): an exact
# Menger carve of at least SUBTREE_MIN_COUNT leaves whose lattice is absent
# or too wide for the winner collapse (a level of more than
# LATTICE_IDX_MAX_COLS columns) takes the level-1 subtree walk; a subtree
# recurses into its 20 child cells when each holds at least
# SUBTREE_RECURSE_MIN crosses.
SUBTREE_MIN_COUNT = 1024
SUBTREE_RECURSE_MIN = 21
LATTICE_IDX_MAX_COLS = 128
# A deep-sponge group's flags in its cull block (csrc/fold.cuh): it takes
# the subtree walk; its subtrees hold 421 crosses, the two-level collapse
# (iters 4); they recurse into their child cells; its winner folds take
# the leaf fold or the walk, not the lattice winner collapse.
SUBTREE_WALK, SUBTREE_COLLAPSES, SUBTREE_RECURSES, WINNER_LEAF_FOLD = \
    1, 2, 4, 8


def menger_subtrees(g):
    """(crosses a level-1 subtree holds, ((offset, first row), ...) of the
    20 subtrees) of a Menger group's carve, or None
    (pallas_march._menger_subtrees): menger provenance, iters >= 2, and
    the rows 1 + 1 + 20 T with unit scales past the base."""
    if g.fused is None or g.fused[0] != "menger" or g.fused[1] < 2:
        return None
    T = sum(20 ** k for k in range(g.fused[1] - 1))
    if g.count != 2 + 20 * T or any(s != 1 for s in g.scales[1:]):
        return None
    return T, tuple((off, g.start + 2 + j * T)
                    for j, off in enumerate(_MENGER_OFFSETS))


def subtree_recurses(g) -> bool:
    """pallas_march._subtree_recurses: each child cell holds at least
    SUBTREE_RECURSE_MIN crosses."""
    sub = menger_subtrees(g)
    return (sub is not None and (sub[0] - 1) % 20 == 0
            and (sub[0] - 1) // 20 >= SUBTREE_RECURSE_MIN)


def subtree_collapses(g) -> bool:
    """pallas_march._subtree_collapses: iters 4, a subtree of 421
    crosses (its root and two collapsible levels)."""
    sub = menger_subtrees(g)
    return sub is not None and sub[0] == 421


def lattice_idx_ok(g) -> bool:
    """pallas_march._lattice_idx_ok: a lattice whose every level has at
    most LATTICE_IDX_MAX_COLS columns (the winner collapse's reach)."""
    return g.lattice is not None and all(
        len(level) == 1 or len(level[4]) <= LATTICE_IDX_MAX_COLS
        for level in g.lattice)


def use_subtree(g) -> bool:
    """pallas_march._use_subtree: the group's carve takes the subtree
    walk in the winner folds, and in the value folds when it has no
    lattice."""
    return ((g.lattice is None or not lattice_idx_ok(g))
            and g.count >= SUBTREE_MIN_COUNT
            and menger_subtrees(g) is not None)


def needs_menger_offsets(kp) -> bool:
    """pallas_march._needs_menger_offsets: some group's walk recurses, so
    the table carries the 20 Menger offset rows."""
    return any(use_subtree(g) and subtree_recurses(g)
               for g in getattr(kp, "groups", ()))


def uniform_prefix(chunks) -> int:
    """pallas_march._uniform_prefix: the length of a chunk list's leading
    span (s0 + k c0, c0), the chunks the ordered walk may reorder."""
    s0, c0 = chunks[0]
    uni = 0
    while uni < len(chunks) and chunks[uni] == (s0 + uni * c0, c0):
        uni += 1
    return uni


def bvh_order_spans(kp) -> tuple:
    """pallas_march.iter_bvh_order_spans: ((group, run, uniform length),
    ...) of the chunk spans that get order rows (three chunks or more)."""
    out = []
    for gi, g in enumerate(getattr(kp, "groups", ())):
        for ri, chunks in (g.bvh or ()):
            uni = uniform_prefix(chunks)
            if uni >= 3:
                out.append((gi, ri, uni))
    return tuple(out)


def has_cull(kp) -> bool:
    """Whether a two-level plan takes any cull of D5 or D4: a chunked
    group, or a cullable sponge whose winner folds leave the lattice."""
    return any(g.bvh is not None for g in kp.groups) or any(
        is_cullable(kp, g) and (use_subtree(g) or collapses(kp, g)
                                and not lattice_idx_ok(g))
        for g in kp.groups)


def cull_blocks(kp: KernelPlan, fused: bool, row0: int) -> dict:
    """group index -> its cull block (see ``PackedPlan``), with the cull
    rows from table row ``row0``.  In the fused packing a generator group
    evaluates its carve from the base row and takes no subtree walk."""
    chunks = iter_bvh_chunks(kp)
    off_row = row0 + len(chunks)
    order_row = off_row + (20 if needs_menger_offsets(kp) else 0)
    spans = {(gi, ri): uni for gi, ri, uni in bvh_order_spans(kp)}
    blocks, brow = {}, row0
    for gi, g in enumerate(kp.groups):
        if g.bvh is not None:
            by_run = dict(g.bvh)
            blk = []
            for ri in range(len(g.runs)):
                ch = by_run.get(ri)
                if ch is None:
                    blk.extend((0, 0, 0, 0, -1))
                    continue
                uni = uniform_prefix(ch)
                order = -1
                if (gi, ri) in spans:
                    order = order_row
                    order_row += spans[(gi, ri)]
                blk.extend((brow, len(ch), ch[0][1], uni, order))
                brow += len(ch)
            blocks[gi] = blk
            continue
        if fused and g.fused is not None or not is_cullable(kp, g):
            continue
        flags = 0
        if use_subtree(g):
            flags |= SUBTREE_WALK
            if subtree_collapses(g):
                flags |= SUBTREE_COLLAPSES
            if subtree_recurses(g):
                flags |= SUBTREE_RECURSES
        if collapses(kp, g) and not lattice_idx_ok(g):
            flags |= WINNER_LEAF_FOLD
        if flags:
            sub = menger_subtrees(g)
            blocks[gi] = [flags, g.start, sub[0] if sub else 0,
                          off_row if flags & SUBTREE_RECURSES else -1]
    return blocks


def _chunk_spans(kp) -> tuple:
    """The chunked runs' leaves as spans of equal chunks, in
    ``iter_bvh_chunks`` order: (prim type, first leaf, chunk count, chunk
    length), a run's uniform prefix one span and each chunk past it one
    more."""
    out = []
    for g in kp.groups:
        for ri, chunks in (g.bvh or ()):
            ptype = g.runs[ri][0]
            uni = uniform_prefix(chunks)
            out.append((ptype, chunks[0][0], uni, chunks[0][1]))
            out.extend((ptype, s, 1, c) for (s, c) in chunks[uni:])
    return tuple(out)


def cull_rows(kp: KernelPlan, tables: SceneTables) -> torch.Tensor:
    """[B + 20? + O, 8] float32 rows on the tables' device, as JAX's
    ``_build_table`` appends them after its flag row: per chunk
    (``iter_bvh_chunks`` order) its live bounding box [cx cy cz hx hy hz 0
    0] (centre +- radius for a sphere, +- half size for a box); the 20
    Menger offset rows [ox oy oz 0 ...] when a walk recurses; per
    ordered span the chunk ordinals nearest the camera first (column 0;
    a stable sort of the squared distances from the chunks' centres).
    A run's equal chunks take one reduction."""
    pos, aux = tables.prim_pos, tables.prim_aux
    f32 = dict(dtype=pos.dtype, device=pos.device)
    parts, centres = [], None
    with torch.no_grad():
        spans = _chunk_spans(kp)
        if spans:
            lo, hi = [], []
            for (ptype, s, n, c) in spans:
                p = pos[s:s + n * c].reshape(n, c, 3)
                e = (aux[s:s + n * c, 0:1].expand(n * c, 3) if ptype == 0
                     else aux[s:s + n * c] * 0.5).reshape(n, c, 3)
                lo.append((p - e).min(dim=1).values)
                hi.append((p + e).max(dim=1).values)
            lo, hi = torch.cat(lo), torch.cat(hi)
            centres = (lo + hi) * 0.5
            parts.append(torch.cat([centres, (hi - lo) * 0.5,
                                    torch.zeros((lo.shape[0], 2), **f32)],
                                   dim=1))
        if needs_menger_offsets(kp):
            parts.append(_menger_offset_rows(pos.device))
        order = bvh_order_spans(kp)
        if order:
            d = ((centres - tables.cam_position[None, :]) ** 2).sum(dim=1)
            first, base = {}, 0
            for gi, g in enumerate(kp.groups):
                for ri, ch in (g.bvh or ()):
                    first[(gi, ri)] = base
                    base += len(ch)
            for (gi, ri, uni) in order:
                o = first[(gi, ri)]
                rows = torch.zeros((uni, 8), **f32)
                rows[:, 0] = torch.argsort(d[o:o + uni], stable=True).to(
                    pos.dtype)
                parts.append(rows)
        if not parts:
            return torch.zeros((0, 8), **f32)
        return torch.cat(parts).contiguous()


@functools.lru_cache(maxsize=8)
def _menger_offset_rows(device: torch.device) -> torch.Tensor:
    """The 20 Menger offset rows on ``device`` (cached, shared)."""
    offs = torch.zeros((20, 8), dtype=torch.float32)
    offs[:, :3] = torch.tensor(_MENGER_OFFSETS, dtype=torch.float32)
    return offs.to(device)


@functools.lru_cache(maxsize=16)
def _subtree_checks(kp, device: torch.device) -> tuple:
    """Per group that takes the two-level subtree collapse, the index
    tensors of ``subtree_collapse_ok``'s checks on ``device`` (cached): the
    root row, the level-1, -2 and -3 rows [20], [20, 20], [20, 20, 20],
    per axis the level-2 and -3 representative rows, the offsets."""
    out = []
    offs = np.asarray(_MENGER_OFFSETS)
    reps = [{} for _ in range(3)]
    for j, off in enumerate(_MENGER_OFFSETS):
        for a in range(3):
            reps[a].setdefault(off[a], j)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    for g in kp.groups:
        if not (use_subtree(g) and subtree_collapses(g)):
            continue
        T = menger_subtrees(g)[0]
        b0 = g.start + 2 + np.arange(20) * T
        r2 = b0[:, None] + 1 + np.arange(20) * 21
        r3 = r2[:, :, None] + 1 + np.arange(20)
        rep = []
        for a in range(3):
            repj = np.array([reps[a][v] for v in offs[:, a]])
            rep.append((t(b0[:, None] + 1 + repj[None, :] * 21),
                        t(b0[:, None, None] + 1 + repj[None, :, None] * 21
                          + 1 + repj[None, None, :])))
        out.append((g.start, t(b0), t(r2), t(r3), tuple(rep),
                    t(offs.astype(np.float32))))
    return tuple(out)


def subtree_collapse_ok(kp, tables: SceneTables) -> torch.Tensor:
    """One-element int32 tensor on the tables' device: 1 while the live
    rows of every sponge that takes the two-level subtree collapse
    (``use_subtree`` and ``subtree_collapses``) still share each
    subtree's per-level coordinates and sizes, and sit within s / 72 of
    the generated lattice (pallas_march.subtree_collapse_ok, the JAX flag
    row's column 1: the skip bounds of the walks derive the cells from
    the group's root row).  0 without such a group, and for a deep plan.
    Computed outside the kernels, like ``lattice_ok``."""
    pos = tables.prim_pos
    dev = pos.device
    if getattr(kp, "groups", None) is None:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    checks = _subtree_checks(kp, dev)
    if not checks:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    aux = tables.prim_aux
    ok = torch.ones((), dtype=torch.bool, device=dev)
    with torch.no_grad():
        for (start, b0, r2, r3, rep, offs) in checks:
            for a, (rep2, rep3) in enumerate(rep):
                ok &= (pos[r2, a] == pos[rep2, a]).all()
                ok &= (pos[r3, a] == pos[rep3, a]).all()
            ok &= (aux[r2] == aux[r2[:, :1]]).all()
            ok &= (aux[r3] == aux[r3[:, :1, :1]]).all()
            root = pos[start]
            s = aux[start, 0]
            third = s * (1.0 / 3.0)
            ninth = third * (1.0 / 3.0)
            tw7 = ninth * (1.0 / 3.0)
            q1 = root[None] + offs * third
            q2 = q1[:, None] + offs[None] * ninth
            q3 = q2[:, :, None] + offs[None, None] * tw7
            tol = s * (1.0 / 72.0)
            ok &= ((pos[b0] - q1).abs() <= tol).all()
            ok &= ((pos[r2] - q2).abs() <= tol).all()
            ok &= ((pos[r3] - q3).abs() <= tol).all()
            ok &= ((aux[b0] - ninth).abs() <= tol).all()
            ok &= ((aux[r2] - tw7).abs() <= tol).all()
            ok &= ((aux[r3] - tw7 * (1.0 / 3.0)).abs() <= tol).all()
    return ok.to(torch.int32).reshape(1)


def _pack_lattice(g, stream: list, members: list) -> None:
    """Append group ``g``'s collapse block and its winner rows to
    ``stream`` and, per cross, its six (own element, representative's
    element) pairs to ``members``."""
    stream.extend((len(g.lattice), 0))
    rows_at = len(stream) - 1
    winner_rows = []
    for level in g.lattice:
        if len(level) == 1:
            stream.extend((0, level[0]))
            winner_rows.append(level[0])
            continue
        xs_reps, ys_reps, zs_reps, size_rep, columns, level_members = level
        # columns share x-sets: one minimum per distinct sorted set
        # (_menger_carve_lattice), first appearance first
        xsets = {}
        for (iy, iz, ixs, rows) in columns:
            by_ix = sorted(zip(ixs, rows))
            xsets.setdefault(tuple(ix for ix, _ in by_ix), []).append(
                (iy, iz, [row for _, row in by_ix]))
        stream.extend((len(xsets), size_rep))
        for key, cols in xsets.items():
            stream.extend((len(key), len(cols)))
            stream.extend(xs_reps[ix] for ix in key)
            for (iy, iz, rows) in cols:
                stream.extend((ys_reps[iy], zs_reps[iz]))
                winner_rows.extend(rows)
        for (row, ix, iy, iz) in level_members:
            reps = (xs_reps[ix], ys_reps[iy], zs_reps[iz]) + (size_rep,) * 3
            members.extend((8 * row + col, 8 * rep + col)
                           for col, rep in enumerate(reps))
    stream[rows_at] = len(stream)
    stream.extend(winner_rows)


@functools.lru_cache(maxsize=64)
def pack_plan(kp: KernelPlan, fused: bool = False) -> PackedPlan:
    """Flatten ``kp.groups`` into descriptor tensors (cached per plan and
    ``fused``; the returned tensors are shared, so callers must not write
    to them).  With ``fused``, generator groups take the fused packing."""
    groups, runs = [], []
    lattice, members = [0] * max(len(kp.groups), 1), []
    ordinals = ({id(g): k for k, g in enumerate(fused_groups(kp))}
                if fused else {})
    cull = kp.groups and has_cull(kp)
    cull_row = ext_base(kp) + len(kp.proc) if cull else 0
    blocks = cull_blocks(kp, fused, cull_row) if cull else {}
    if blocks:
        # G cull offsets after the G collapse offsets, then the blocks;
        # the collapse blocks follow
        G = len(kp.groups)
        lattice = [0] * (2 * G)
        for gi, blk in blocks.items():
            lattice[G + gi] = len(lattice)
            lattice.extend(blk)
    for gi, g in enumerate(kp.groups):
        ordinal = ordinals.get(id(g))
        if ordinal is not None:
            groups.append((g.gsign, len(runs), 1, GROUP_FUSED))
            kind = g.fused[0]
            runs.append(tuple(int(v) for v in g.runs[0]))
            runs.append((g.fused[1] if kind == "menger" else 0, g.start, 0,
                         ext_base(kp) + ordinal))
            continue
        if collapses(kp, g):
            lattice[gi] = len(lattice)
            _pack_lattice(g, lattice, members)
        cull = is_cullable(kp, g)
        scales = [r[3] for r in g.runs]
        if cull and 1 in scales and -1 in scales[scales.index(1):]:
            # the kernel folds the leading base runs, tests the bound, then
            # folds the rest; a base run after a carve run would reorder
            # the first-wins winner fold
            raise NotImplementedError(
                "cullable group with a base run after a carve run")
        groups.append((g.gsign, len(runs), len(g.runs), int(cull)))
        for (ptype, start, count, scale) in g.runs:
            # a procedural run's type is (kind, param, iters): leaves with
            # other parameters are other runs (compile._kernel_normal_form)
            ptype = PROC_TYPES[ptype[0]] if isinstance(ptype, tuple) else ptype
            if ptype not in DENSE_TYPES + tuple(PROC_TYPES.values()):
                raise ValueError(f"pack_plan: run type {ptype!r} is none "
                                 "the kernels fold")
            runs.append((int(ptype), start, count, scale))
    return PackedPlan(
        int(kp.root_op), _as_i32(groups), _as_i32(runs),
        torch.tensor(np.asarray(lattice, np.int32)),
        torch.tensor(np.asarray(members, np.int64).reshape(-1, 2).T.copy()),
        *_proc_fields(kp.proc), int(bool(blocks)),
        cull_row if blocks else 0)


def _as_i32(rows) -> torch.Tensor:
    """[n, 4] int32 descriptors."""
    return torch.tensor(np.asarray(rows, np.int32).reshape(-1, 4))


def _proc_fields(proc) -> tuple:
    """``PackedPlan``'s proc_leaves, proc_iters and proc_params of a plan's
    ``proc`` entries."""
    params = np.zeros((len(proc), 8), np.float32)
    for k, (_, kind, param, _) in enumerate(proc):
        params[k, :4] = (tuple(param) if kind == "julia"
                         else (param, 0.0, 0.0, 0.0))
    return (torch.tensor([leaf for (leaf, _, _, _) in proc],
                         dtype=torch.int64),
            torch.tensor([float(it) for (_, _, _, it) in proc],
                         dtype=torch.float32),
            torch.from_numpy(params))


# The deep program's instructions (csrc/fold.cuh's deep folds): an entry
# of one or more leaf runs, the opening of a sub-list, its closing.
DEEP_RUNS, DEEP_OPEN, DEEP_CLOSE = 0, 1, 2
# An entry's flags: its list folds with MIN (else MAX), it is the list's
# first entry (taken as it is), it is negated (a closed sub-list's value).
DEEP_MIN, DEEP_FIRST, DEEP_NEG = 1, 2, 4
# Lists open at once in the deep fold, the root's included, that its
# per-thread stack holds (csrc/fold.cuh's kDeepLevels); a plan that nests
# more takes the kernels' DeepSpill view, whose deeper levels live in a
# device buffer of SPILL_WORDS words a level and a thread after
# SPILL_HEADER words (the first of them the collapse flag, 0).
DEEP_LEVELS = 16
SPILL_HEADER, SPILL_WORDS = 32, 8


_RUN = 2  # a coalesced run of leaves


@functools.lru_cache(maxsize=None)
def _coalesced_entries(lp) -> tuple:
    """A list's entries with consecutive same-negation leaves merged into
    (_RUN, first leaf, count, neg) items; a sub-list is (KIND_LIST, its
    index, 0, neg) (core.sdf._coalesced_entries of the JAX package).
    Entry order, and so the first-wins winner, is kept."""
    items = []
    for kind, idx, neg in lp.entries:
        if (kind != KIND_LIST and items and items[-1][0] == _RUN
                and items[-1][3] == neg
                and items[-1][1] + items[-1][2] == idx):
            items[-1] = (_RUN, items[-1][1], items[-1][2] + 1, neg)
        elif kind != KIND_LIST:
            items.append((_RUN, idx, 1, neg))
        else:
            items.append((KIND_LIST, idx, 0, neg))
    return tuple(items)


def _deep_depth(plan: ScenePlan) -> int:
    """Lists open at once when the deep fold walks ``plan``: 1 for a root
    of leaves, 3 for a depth-3 tree."""
    depth = [1] * len(plan.lists)
    for li, lp in enumerate(plan.lists):    # post-order: children first
        for kind, idx, _ in lp.entries:
            if kind == KIND_LIST:
                depth[li] = max(depth[li], 1 + depth[idx])
    return depth[-1] if depth else 1


@functools.lru_cache(maxsize=64)
def pack_deep(plan: ScenePlan) -> PackedPlan:
    """The descriptor tensors of a plan with no two-level form
    (``plan.kernel is None``; pallas_march's D8, ``_scene_generic_tile``),
    cached per plan like ``pack_plan``'s.

    ``groups`` [I, 4] is a program, walked depth first from the root's
    entries: per entry of a list, in entry order (``_coalesced_entries``:
    consecutive leaves of one negation are one entry), either
    (DEEP_RUNS, first run, number of runs, flags), the entry's leaves
    split into runs of one kernel run type (pallas_march._type_segments),
    or (DEEP_OPEN, 0, 0, 0), the sub-list's own entries, and (DEEP_CLOSE,
    0, 0, flags).  Flags: DEEP_MIN when the list that holds the entry
    folds with MIN, DEEP_FIRST on its first entry, DEEP_NEG on a negated
    sub-list.  ``runs`` [N, 4] are (run type, first leaf, leaf count,
    scale): scale is the entry's sign under a MIN list and its opposite
    under a MAX one, which the fold takes as -min(-x).  ``lattice`` is one
    0 an instruction (no collapse: the kernels' staging reads an entry a
    descriptor), ``members`` empty; the procedural fields are
    ``pack_plan``'s.  Lists may nest to any depth (``spill_levels``)."""
    prog, runs = [], []
    proc = {int(leaf): PROC_TYPES[kind] for (leaf, kind, _, _) in plan.proc}

    def emit(li: int) -> None:
        lp = plan.lists[li]
        for e, (kind, idx, count, neg) in enumerate(_coalesced_entries(lp)):
            flags = ((DEEP_MIN if lp.op == MIN else 0)
                     | (DEEP_FIRST if e == 0 else 0))
            if kind == KIND_LIST:
                prog.append((DEEP_OPEN, 0, 0, 0))
                emit(idx)
                prog.append((DEEP_CLOSE, 0, 0,
                             flags | (DEEP_NEG if neg else 0)))
                continue
            sign = -1 if neg else 1
            scale = sign if lp.op == MIN else -sign
            first = len(runs)
            for leaf in range(idx, idx + count):
                t = proc.get(leaf, int(plan.prim_type[leaf]))
                if len(runs) > first and runs[-1][0] == t:
                    runs[-1] = (t, runs[-1][1], runs[-1][2] + 1, scale)
                else:
                    runs.append((t, leaf, 1, scale))
            prog.append((DEEP_RUNS, first, len(runs) - first, flags))

    if plan.lists:
        emit(len(plan.lists) - 1)
    root = plan.lists[-1].op if plan.lists else MIN
    return PackedPlan(
        int(root), _as_i32(prog), _as_i32(runs),
        torch.zeros(max(len(prog), 1), dtype=torch.int32),
        torch.zeros((2, 0), dtype=torch.int64), *_proc_fields(plan.proc))


def spill_levels(plan: ScenePlan) -> int:
    """Levels of the deep fold's stack past DEEP_LEVELS that ``plan``
    needs: 0 for a two-level plan and a deep one nesting at most
    DEEP_LEVELS lists."""
    return 0 if plan.kernel is not None else max(
        _deep_depth(plan) - DEEP_LEVELS, 0)


def _spill_buffer(levels: int, device: torch.device) -> torch.Tensor:
    """The DeepSpill view's buffer on a CUDA device: SPILL_HEADER words,
    the first 0 (the collapse flag the kernels read from it), then
    ``levels`` levels of SPILL_WORDS words for each thread the card holds
    at once (a persistent grid has no more)."""
    props = torch.cuda.get_device_properties(device)
    threads = props.multi_processor_count * getattr(
        props, "max_threads_per_multi_processor", 2048)
    buf = torch.empty(SPILL_HEADER + levels * SPILL_WORDS * threads,
                      dtype=torch.int32, device=device)
    buf[:SPILL_HEADER].zero_()
    return buf


def _moved(packed: PackedPlan, device: torch.device) -> PackedPlan:
    return packed._replace(**{
        name: getattr(packed, name).to(device)
        for name in ("groups", "runs", "lattice", "members", "proc_leaves",
                     "proc_iters", "proc_params")})


@functools.lru_cache(maxsize=64)
def _packed_on(kp: KernelPlan, device: torch.device,
               fused: bool = False) -> PackedPlan:
    """``pack_plan(kp, fused)`` with its tensors on ``device`` (cached,
    shared)."""
    return _moved(pack_plan(kp, fused), device)


@functools.lru_cache(maxsize=64)
def _deep_on(plan: ScenePlan, device: torch.device) -> PackedPlan:
    """``pack_deep(plan)`` with its tensors on ``device`` (cached,
    shared)."""
    return _moved(pack_deep(plan), device)


def _table_flag(kp, table: torch.Tensor, fused: bool = False
                ) -> torch.Tensor:
    """``lattice_ok`` from the [P, 8] primitive rows: one gather over a
    static index array and one comparison."""
    if getattr(kp, "groups", None) is None:     # a generic ScenePlan
        return torch.zeros(1, dtype=torch.int32, device=table.device)
    members = _packed_on(kp, table.device, fused).members
    if members.numel() == 0:
        return torch.zeros(1, dtype=torch.int32, device=table.device)
    with torch.no_grad():
        own, rep = table.reshape(-1).index_select(
            0, members.reshape(-1)).view(2, -1)
        return (own == rep).all().to(torch.int32).reshape(1)


def lattice_ok(kp, tables: SceneTables, fused: bool = False
               ) -> torch.Tensor:
    """One-element int32 tensor on the tables' device, 1 while the live
    rows still satisfy every collapsing group's shared-coordinate structure
    (pallas_march.lattice_ok), 0 otherwise or when nothing collapses (in
    the fused packing, ``fused``, no generator group collapses).
    Nothing comes back to the host, so a kernel reads the flag without a
    synchronisation.  Generated scenes pass bitwise; a table whose cross
    rows an optimizer has moved drops every kernel and twin to the plain
    leaf fold."""
    with torch.no_grad():
        return _table_flag(kp, build_table(tables), fused)


# A scene whose rows, descriptors and lights fit this many bytes is staged
# in each block's shared memory by all four kernels; a larger one
# (menger4) is read from device memory by the same kernels' other
# instantiation.  64 KB leaves room for three blocks on an SM.
SHARED_SCENE_BYTES = 64 * 1024


class SceneOperands(NamedTuple):
    """What every kernel's scene argument is built from, on one device.

    With procedural leaves the table has K rows more, one a procedural
    leaf (``PackedPlan.proc_params``), and such a leaf's own row holds its
    iteration count and the index of its procedural row in its two last
    columns (build_table's pad columns)."""

    table: torch.Tensor     # [P (+ K), 8] float32 primitive rows
    groups: torch.Tensor    # [G, 4] int32
    runs: torch.Tensor      # [N, 4] int32
    lattice: torch.Tensor   # int32 collapse stream
    flag: torch.Tensor      # [1] int32: the collapse may be taken;
    #                         [2] with a cull: and subtree_collapse_ok
    root_min: int           # 1 when the root folds with MIN
    fused: int = 0          # 1: the fused packing (fused generators)
    proc: int = 0           # 1: the plan has procedural leaves
    deep: int = 0           # 1: pack_deep's program (no two-level form)
    spill: int = 0          # 1: a deep plan past DEEP_LEVELS (DeepSpill)
    cull: int = 0           # 1: a group takes a cull of D5 or D4 (Cull)

    def args(self) -> tuple:
        """The leading arguments of every C entry point: five pointers,
        then the row, group, run and stream counts, root_min and the scene
        view (csrc/persist.cuh's on_view: fused + 2 proc + 4 deep + 8
        spill + 16 cull)."""
        return (self.table.data_ptr(), self.groups.data_ptr(),
                self.runs.data_ptr(), self.lattice.data_ptr(),
                self.flag.data_ptr(), self.table.shape[0],
                self.groups.shape[0], self.runs.shape[0],
                self.lattice.shape[0], self.root_min,
                self.fused + 2 * self.proc + 4 * self.deep + 8 * self.spill
                + 16 * self.cull)

    def nbytes(self, n_lights: int = 0) -> int:
        """Bytes a block stages when the scene goes to shared memory."""
        return (32 * (self.table.shape[0] + n_lights)
                + 16 * (self.groups.shape[0] + self.runs.shape[0])
                + 4 * self.lattice.shape[0])


def scene_operands(plan, tables: SceneTables, device,
                   collapse: bool = True, fused: bool = False
                   ) -> SceneOperands:
    """The scene as the kernels read it, on ``device``: the exact packing,
    or with ``fused`` the fused one (``RenderConfig.fused_generators``).
    With ``collapse`` the flag is ``lattice_ok`` of the live tables, else 0
    (the plain leaf fold).  A plan with no two-level form takes
    ``pack_deep``'s program whatever ``fused`` says (the JAX kernels
    evaluate such a plan's exact field, fused generators or not), with the
    flag 0; on a CUDA device, a deep plan nesting more than DEEP_LEVELS
    lists has its flag at the head of its stack's spill buffer
    (``_spill_buffer``), and ``spill`` 1.  A plan with a cull of D5 or D4
    (``PackedPlan.cull``) has ``cull_rows`` appended to its table and its
    flag's second element ``subtree_collapse_ok`` (0 without
    ``collapse``), and ``cull`` 1.  The caller keeps the tensors alive
    across its launch."""
    with span("rt.scene_operands"):
        deep = plan.kernel is None
        fused = bool(fused) and not deep
        packed = (_deep_on(plan, torch.device(device)) if deep else
                  _packed_on(plan.kernel, torch.device(device), fused))
        with torch.no_grad():
            table = build_table(tables)
            levels = spill_levels(plan) if table.device.type == "cuda" else 0
            flag = (_table_flag(plan.kernel, table, fused)
                    if collapse and not deep
                    else _spill_buffer(levels, table.device) if levels
                    else torch.zeros(1, dtype=torch.int32, device=device))
            K = packed.proc_leaves.shape[0]
            if K:
                rows = table.shape[0] + torch.arange(K, dtype=torch.float32,
                                                     device=table.device)
                table[packed.proc_leaves, 6] = packed.proc_iters
                table[packed.proc_leaves, 7] = rows
                table = torch.cat([table, packed.proc_params])
            if packed.cull:
                if table.shape[0] != packed.cull_row:
                    raise ValueError(
                        f"scene_operands: {table.shape[0]} table rows, the "
                        f"plan places its cull rows at {packed.cull_row}")
                table = torch.cat([table, cull_rows(plan.kernel, tables)])
                flag = torch.cat([flag,
                                  subtree_collapse_ok(plan.kernel, tables)
                                  if collapse else torch.zeros_like(flag)])
            ops = SceneOperands(table, packed.groups, packed.runs,
                                packed.lattice, flag,
                                int(packed.root_op == MIN), int(fused),
                                int(K > 0), int(deep), int(levels > 0),
                                packed.cull)
        for name in ("groups", "runs", "lattice", "flag"):
            t = getattr(ops, name)
            if (t.dtype != torch.int32 or not t.is_contiguous()
                    or t.device != ops.table.device):
                raise ValueError(f"scene_operands: {name} must be contiguous "
                                 f"int32 on {ops.table.device}")
        return ops
