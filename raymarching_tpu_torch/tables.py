"""Scene tables on a torch device, in the layout the render kernel reads.

Counterpart of ``raymarching_tpu.ops.pallas_march._build_table`` (the
primitive rows) and of the light rows built in
``raymarching_tpu.ops.pallas_render.pallas_render_rays``.  The JAX
package's ``SceneTables`` (numpy) and ``KernelPlan`` (static structure)
are the contract between the two packages: this module only changes where
they live and how the plan is encoded.

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

from raymarching_tpu.scene.compile import MIN, KernelPlan, SceneTables

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


def tables_to_torch(tables: SceneTables, device,
                    requires_grad: Sequence[str] = ()) -> SceneTables:
    """The same ``SceneTables`` with every field a float32 tensor on
    ``device`` (numpy arrays or tensors in, no copy where they already
    match).  The fields named in ``requires_grad`` become fresh leaf
    tensors that require grad: copies, so an optimizer's in-place update
    never writes into the caller's arrays."""
    unknown = set(requires_grad) - set(SceneTables._fields)
    if unknown:
        raise ValueError(f"unknown SceneTables fields {sorted(unknown)}")
    out = []
    device = torch.device(device)
    for name, v in zip(SceneTables._fields, tables):
        t = torch.as_tensor(v, dtype=torch.float32, device=device)
        if name in requires_grad:
            t = t.detach().clone().requires_grad_()
        out.append(t)
    return SceneTables(*out)


def tables_to_numpy(tables: SceneTables) -> SceneTables:
    """The JAX package's numpy ``SceneTables`` (float32 host arrays) of
    the port's tables, so either package can render or resume a fit."""
    return SceneTables(*(np.asarray(torch.as_tensor(v).detach().cpu(),
                                    np.float32) for v in tables))


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
