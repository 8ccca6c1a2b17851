"""K2, the surface kernel's combined mode: wrapper and plain twin.

Counterpart of ``raymarching_tpu.ops.pallas_march.pallas_surface_eval``
with ``with_color=with_normal=analytic=True, fused=False``, the mode the
exact-FD backward's stencil evaluation uses: per point the scene SD, the
first-wins winning leaf and the winner's gradient.  The kernel is
``csrc/surface_kernel.cu``; ``surface_eval_plain`` computes the same thing
in plain PyTorch (``core.sdf.kernel_fold``) and is what a CPU tensor gets.
A CUDA tensor always goes to the kernel: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from raymarching_tpu.scene.compile import MIN, ScenePlan, SceneTables

from ..core.sdf import kernel_fold
from ..tables import build_table, pack_plan
from . import build

Surface = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def surface_eval_plain(plan: ScenePlan, tables: SceneTables,
                       q: torch.Tensor) -> Surface:
    """K2 in plain PyTorch: q [N, 3] -> (sd [N], winner leaf [N] int32,
    -1 where nothing won, d scene / dp [N, 3])."""
    with torch.no_grad():
        return kernel_fold(plan, tables, q, with_grad=True)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/surface_kernel.cu, built on first use, its entry point bound."""
    lib = build.load_library("surface_kernel")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rt_surface_eval.argtypes = ([ptr] * 3 + [i32] * 2 + [ptr] * 3
                                    + [ctypes.c_int64, ptr])
    lib.rt_surface_eval.restype = i32
    return lib


def surface_eval(plan: ScenePlan, tables: SceneTables,
                 q: torch.Tensor) -> Surface:
    """Scene SD, winner leaf and winner gradient at points q [N, 3];
    ``tables`` is a SceneTables of tensors on q's device.  CPU tensors
    take the plain twin; CUDA tensors launch K2."""
    dev = q.device
    if dev.type == "cpu":
        return surface_eval_plain(plan, tables, q)
    if dev.type != "cuda":
        raise ValueError(f"surface_eval: unsupported device {dev}")
    if plan.kernel is None:
        raise NotImplementedError(
            "not ported yet: depth > 2 scenes (ROADMAP Queue 2, D8)")
    if q.dtype != torch.float32 or q.dim() != 2 or q.shape[1] != 3:
        raise ValueError(f"surface_eval: q must be float32 [N, 3], got "
                         f"{q.dtype} {tuple(q.shape)}")
    if any(t.device != dev or t.dtype != torch.float32 for t in tables):
        raise ValueError(f"surface_eval: tables must be float32 on {dev}")

    lib = _library()
    packed = pack_plan(plan.kernel)
    N = q.shape[0]
    with torch.no_grad():
        groups = packed.groups.to(dev)
        runs = packed.runs.to(dev)
        tbl = build_table(tables)
        q_soa = q.t().contiguous()
        out = torch.empty((4, N), dtype=torch.float32, device=dev)
        widx = torch.empty((N,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rt_surface_eval(
            tbl.data_ptr(), groups.data_ptr(), runs.data_ptr(),
            groups.shape[0], int(packed.root_op == MIN), q_soa.data_ptr(),
            out.data_ptr(), widx.data_ptr(), N, stream)
    build.check(lib, code, "surface kernel launch")
    if N:    # the C entry point launches nothing for zero points
        surface_eval.launches += 1
    return out[0], widx, out[1:].t()


surface_eval.launches = 0
