"""Scene tables on a torch device, in the layout the render kernel reads.

Counterpart of ``raymarching_tpu.ops.pallas_march._build_table`` (the
primitive rows) and of the light rows built in
``raymarching_tpu.ops.pallas_render.pallas_render_rays``.  ``SceneTables``
(the parameters) and ``KernelPlan`` (the static structure) are the port's
own classes (``scene.compile``), field for field the JAX package's;
``tables_to_torch`` and ``tables_to_numpy`` read any object with those
field names, so parameters cross between the two packages without either
importing the other.

The kernel folds the two-level plan by walking small int32 descriptor
tables instead of code generated per scene, so one build serves every
scene.  The JAX table's flag, chunk-bound, Menger-offset and order rows
feed its lattice collapse and culls; the port's kernel folds the plain
leaf runs (bitwise equal by construction) and does not build them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .scene.compile import MIN, KernelPlan, SceneTables

# DIFFERENCE groups at least this large get the base-bound cull
# (the rule of pallas_march._scene_sd_tile, _CULL_MIN_GROUP).
CULL_MIN_GROUP = 8


class PackedPlan(NamedTuple):
    """A ``KernelPlan`` as int32 descriptor tensors (on the host).

    ``groups`` [G, 4]: gsign, first run, number of runs, cullable bit.
    ``runs`` [N, 4]: prim type, first leaf, leaf count, scale (+-1).
    """

    root_op: int
    groups: torch.Tensor
    runs: torch.Tensor


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


@functools.lru_cache(maxsize=64)
def pack_plan(kp: KernelPlan) -> PackedPlan:
    """Flatten ``kp.groups`` into descriptor tensors (cached per plan; the
    returned tensors are shared, so callers must not write to them)."""
    groups, runs = [], []
    for g in kp.groups:
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
            if isinstance(ptype, tuple):
                raise NotImplementedError(
                    "procedural leaves are not ported yet (ROADMAP Queue 1 "
                    "item 10)")
            runs.append((int(ptype), start, count, scale))
    as_i32 = lambda rows: torch.tensor(  # noqa: E731
        np.asarray(rows, np.int32).reshape(-1, 4))
    return PackedPlan(int(kp.root_op), as_i32(groups), as_i32(runs))


def scene_operands(plan, tables: SceneTables, device) -> tuple:
    """What every kernel's ``Scene`` argument is built from, on ``device``:
    (primitive rows [P, 8], groups [G, 4], runs [N, 4], root_min 0/1).
    The caller keeps the tensors alive across its launch."""
    packed = pack_plan(plan.kernel)
    with torch.no_grad():
        return (build_table(tables), packed.groups.to(device),
                packed.runs.to(device), int(packed.root_op == MIN))
