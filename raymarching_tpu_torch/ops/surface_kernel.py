"""K2, the surface kernel: wrapper and plain twins of its four modes.

Counterpart of ``raymarching_tpu.ops.pallas_march.pallas_surface_eval``,
not fused.  Per point of q [N, 3], by ``mode``:

  * ``COMBINED`` (JAX: with_color, with_normal, analytic) — the scene SD,
    the first-wins winning leaf and the winner's gradient: the mode of the
    backward passes' stencil and hit-point evaluations;
  * ``SD`` — the scene SD alone;
  * ``WINNER`` (with_color) — the SD and the winning leaf: the multi-kernel
    backend's colour lookup;
  * ``FD_GRAD`` (with_normal) — the SD and the central-difference gradient
    (f(p + h e_a) - f(p - h e_a)) * (1 / 2h): the multi-kernel backend's
    normals.

The gradient-only analytic mode and every fused-generator mode are not
ported yet (ROADMAP Queue 1 items 7 and 8).  The kernel is
``csrc/surface_kernel.cu``; ``surface_eval_plain`` computes each mode in
plain PyTorch and is what a CPU tensor gets.  A CUDA tensor always goes to
the kernel: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..core.sdf import kernel_fold
from ..core.shading import fd_stencil
from ..scene.compile import ScenePlan, SceneTables
from ..tables import scene_operands
from . import build

# mode codes, shared with csrc/surface_kernel.cu
COMBINED, SD, WINNER, FD_GRAD = 0, 1, 2, 3
MODES = (COMBINED, SD, WINNER, FD_GRAD)

Surface = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def _check_mode(mode: int, fd_h: Optional[float]) -> None:
    if mode not in MODES:
        raise ValueError(f"surface_eval: unknown mode {mode!r}")
    if mode == FD_GRAD and not fd_h:
        raise ValueError("surface_eval: the FD_GRAD mode needs fd_h > 0")


def surface_eval_plain(plan: ScenePlan, tables: SceneTables, q: torch.Tensor,
                       *, mode: int = COMBINED,
                       fd_h: Optional[float] = None,
                       collapse: bool = True) -> Surface:
    """K2 in plain PyTorch: q [N, 3] -> (sd [N], winner leaf [N] int32 or
    None, gradient [N, 3] or None), the parts ``mode`` computes; the
    winner is -1 and the combined mode's gradient zero where nothing won.
    ``collapse`` reaches the value modes (SD, FD_GRAD); the winner modes
    fold leaf by leaf."""
    _check_mode(mode, fd_h)
    with torch.no_grad():
        if mode == COMBINED:
            return kernel_fold(plan, tables, q, with_grad=True)
        if mode == WINNER:
            sd, widx = kernel_fold(plan, tables, q, with_idx=True)
            return sd, widx, None
        sd_fn = lambda p: kernel_fold(  # noqa: E731
            plan, tables, p, collapse=collapse)[0]
        sd = sd_fn(q)
        if mode == SD:
            return sd, None, None
        # the difference first, then one multiplication by 1 / 2h
        return sd, None, fd_stencil(sd_fn, q, fd_h) * (1.0 / (2.0 * fd_h))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/surface_kernel.cu, built on first use, its entry point bound."""
    lib = build.load_library("surface_kernel")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_surface_eval.argtypes = ([ptr] * 5 + [i32] * 6 + [f32] * 2
                                    + [ptr] * 3 + [ctypes.c_int64, ptr])
    lib.rt_surface_eval.restype = i32
    return lib


def surface_eval(plan: ScenePlan, tables: SceneTables, q: torch.Tensor, *,
                 mode: int = COMBINED, fd_h: Optional[float] = None,
                 collapse: bool = True) -> Surface:
    """The scene at points q [N, 3] in ``mode`` -> (sd, winner or None,
    gradient or None), as ``surface_eval_plain``; ``tables`` is a
    SceneTables of tensors on q's device.  CPU tensors take the plain
    twin; CUDA tensors launch K2.  Forward only."""
    dev = q.device
    if dev.type == "cpu":
        return surface_eval_plain(plan, tables, q, mode=mode, fd_h=fd_h,
                                  collapse=collapse)
    if dev.type != "cuda":
        raise ValueError(f"surface_eval: unsupported device {dev}")
    _check_mode(mode, fd_h)
    if plan.kernel is None:
        raise NotImplementedError(
            "not ported yet: depth > 2 scenes (ROADMAP Queue 2, D8)")
    if q.dtype != torch.float32 or q.dim() != 2 or q.shape[1] != 3:
        raise ValueError(f"surface_eval: q must be float32 [N, 3], got "
                         f"{q.dtype} {tuple(q.shape)}")
    if any(t.device != dev or t.dtype != torch.float32 for t in tables):
        raise ValueError(f"surface_eval: tables must be float32 on {dev}")

    lib = _library()
    N = q.shape[0]
    scene = scene_operands(plan, tables, dev, collapse)
    with_grad = mode in (COMBINED, FD_GRAD)
    with_idx = mode in (COMBINED, WINNER)
    with torch.no_grad():
        q_soa = q.t().contiguous()
        out = torch.empty((4 if with_grad else 1, N), dtype=torch.float32,
                          device=dev)
        widx = (torch.empty((N,), dtype=torch.int32, device=dev)
                if with_idx else None)
    h = float(fd_h or 0.0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rt_surface_eval(
            *scene.args(), mode, h,
            1.0 / (2.0 * h) if mode == FD_GRAD else 0.0, q_soa.data_ptr(),
            out.data_ptr(), widx.data_ptr() if with_idx else None, N, stream)
    build.check(lib, code, "surface kernel launch")
    if N:    # the C entry point launches nothing for zero points
        surface_eval.launches += 1
    return out[0], widx, (out[1:].t() if with_grad else None)


surface_eval.launches = 0
