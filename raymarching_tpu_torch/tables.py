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
beside its iteration count (pallas_march's D7).  The JAX table's
chunk-bound, Menger-offset and order rows feed culls the port does not
have and are not built.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .scene.compile import KIND_LIST, MIN, KernelPlan, ScenePlan, SceneTables

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
    """

    root_op: int
    groups: torch.Tensor
    runs: torch.Tensor
    lattice: torch.Tensor
    members: torch.Tensor
    proc_leaves: torch.Tensor
    proc_iters: torch.Tensor
    proc_params: torch.Tensor


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
        *_proc_fields(kp.proc))


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
    flag: torch.Tensor      # [1] int32: the collapse may be taken
    root_min: int           # 1 when the root folds with MIN
    fused: int = 0          # 1: the fused packing (fused generators)
    proc: int = 0           # 1: the plan has procedural leaves
    deep: int = 0           # 1: pack_deep's program (no two-level form)
    spill: int = 0          # 1: a deep plan past DEEP_LEVELS (DeepSpill)

    def args(self) -> tuple:
        """The leading arguments of every C entry point: five pointers,
        then the row, group, run and stream counts, root_min and the scene
        view (csrc/persist.cuh's on_view: fused + 2 proc + 4 deep + 8
        spill)."""
        return (self.table.data_ptr(), self.groups.data_ptr(),
                self.runs.data_ptr(), self.lattice.data_ptr(),
                self.flag.data_ptr(), self.table.shape[0],
                self.groups.shape[0], self.runs.shape[0],
                self.lattice.shape[0], self.root_min,
                self.fused + 2 * self.proc + 4 * self.deep + 8 * self.spill)

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
    (``_spill_buffer``), and ``spill`` 1.  The caller keeps the tensors
    alive across its launch."""
    deep = plan.kernel is None
    fused = bool(fused) and not deep
    packed = (_deep_on(plan, torch.device(device)) if deep else
              _packed_on(plan.kernel, torch.device(device), fused))
    with torch.no_grad():
        table = build_table(tables)
        levels = spill_levels(plan) if table.device.type == "cuda" else 0
        flag = (_table_flag(plan.kernel, table, fused) if collapse and not deep
                else _spill_buffer(levels, table.device) if levels
                else torch.zeros(1, dtype=torch.int32, device=device))
        K = packed.proc_leaves.shape[0]
        if K:
            rows = table.shape[0] + torch.arange(K, dtype=torch.float32,
                                                 device=table.device)
            table[packed.proc_leaves, 6] = packed.proc_iters
            table[packed.proc_leaves, 7] = rows
            table = torch.cat([table, packed.proc_params])
        ops = SceneOperands(table, packed.groups, packed.runs,
                            packed.lattice, flag,
                            int(packed.root_op == MIN), int(fused),
                            int(K > 0), int(deep), int(levels > 0))
    for name in ("groups", "runs", "lattice", "flag"):
        t = getattr(ops, name)
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.device != ops.table.device):
            raise ValueError(f"scene_operands: {name} must be contiguous "
                             f"int32 on {ops.table.device}")
    return ops
