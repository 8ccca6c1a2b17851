"""K2, the surface kernel: wrapper and plain twins of its five modes.

Counterpart of ``raymarching_tpu.ops.pallas_march.pallas_surface_eval``,
on exact tables and with fused generators.  Per point of q [N, 3], by
``mode``:

  * ``COMBINED`` (JAX: with_color, with_normal, analytic) — the scene SD,
    the first-wins winning leaf and the winner's gradient: the mode of the
    backward passes' stencil and hit-point evaluations;
  * ``SD`` — the scene SD alone;
  * ``WINNER`` (with_color) — the SD and the winning leaf: the multi-kernel
    backend's colour lookup;
  * ``FD_GRAD`` (with_normal) — the SD and the central-difference gradient
    (f(p + h e_a) - f(p - h e_a)) * (1 / 2h): the multi-kernel backend's
    normals;
  * ``ANALYTIC`` (with_normal, analytic) — the SD and the winner's
    gradient, no winner: the multi-kernel backend's analytic normals.  It
    is the combined mode's fold less its winner output, so its SD and
    gradient are the combined mode's, bitwise (JAX carries the gradient
    through every select instead; off tie sets the two agree).

With ``fused`` (JAX's ``fused=True``, ``RenderConfig.fused_generators``)
every mode evaluates the fused generator field: the WINNER mode names a
generator's base leaf, and the COMBINED mode a carve that wins by its
extended winner id P + ordinal (``tables.fused_groups``), with the
carve's gradient.  The kernel is ``csrc/surface_kernel.cu``;
``surface_eval_plain`` computes each mode in plain PyTorch and is what a
CPU tensor gets.  A CUDA tensor always goes to the kernel: a build or
launch failure raises.

``surface_stencil`` is the kernel's second entry: the combined mode over
the FD stencils of hit points, each stencil point made inside the kernel,
so the exact FD backward passes hand over 12 bytes a hit and no stencil
tensor (exact tables only: the fused FD backward differentiates
``core.sdf.scene_sd_fused`` under autograd, as JAX's does).

Keywords for measurements, the same bits either way: ``collapse`` (the
exact Menger lattice collapse in the SD, FD_GRAD, COMBINED and ANALYTIC
folds, while ``tables.lattice_ok`` holds; the WINNER mode is the colour
winner and folds leaf by leaf) and ``multipoint`` (FD_GRAD's seven points
in one walk of the scene instead of seven; the twins' arithmetic per point
is the same, so they take no such keyword).  ``surface_eval.launches``
counts the launches of both entries.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..core.sdf import kernel_fold
from ..core.shading import fd_stencil
from .. import tables as scene_tables
from ..scene.compile import ScenePlan, SceneTables
from . import build

# mode codes, shared with csrc/surface_kernel.cu
COMBINED, SD, WINNER, FD_GRAD, ANALYTIC = 0, 1, 2, 3, 4
MODES = (COMBINED, SD, WINNER, FD_GRAD, ANALYTIC)

Surface = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def _check_mode(mode: int, fd_h: Optional[float]) -> None:
    if mode not in MODES:
        raise ValueError(f"surface_eval: unknown mode {mode!r}")
    if mode == FD_GRAD and not fd_h:
        raise ValueError("surface_eval: the FD_GRAD mode needs fd_h > 0")


def surface_eval_plain(plan: ScenePlan, tables: SceneTables, q: torch.Tensor,
                       *, mode: int = COMBINED,
                       fd_h: Optional[float] = None,
                       collapse: bool = True, fused: bool = False) -> Surface:
    """K2 in plain PyTorch: q [N, 3] -> (sd [N], winner leaf [N] int32 or
    None, gradient [N, 3] or None), the parts ``mode`` computes; the
    winner is -1 and the gradient of the COMBINED and ANALYTIC modes zero
    where nothing won.  ``collapse`` reaches every mode but WINNER, which
    folds leaf by leaf; ``fused``: the fused generator field."""
    _check_mode(mode, fd_h)
    with torch.no_grad():
        if mode in (COMBINED, ANALYTIC):
            sd, widx, g = kernel_fold(plan, tables, q, with_grad=True,
                                      collapse=collapse, fused=fused)
            return sd, (widx if mode == COMBINED else None), g
        if mode == WINNER:
            sd, widx = kernel_fold(plan, tables, q, with_idx=True,
                                   fused=fused)
            return sd, widx, None
        sd_fn = lambda p: kernel_fold(  # noqa: E731
            plan, tables, p, collapse=collapse, fused=fused)[0]
        sd = sd_fn(q)
        if mode == SD:
            return sd, None, None
        # the difference first, then one multiplication by 1 / 2h
        return sd, None, fd_stencil(sd_fn, q, fd_h) * (1.0 / (2.0 * fd_h))


def stencil_points(p: torch.Tensor, h: float, *, center: bool
                   ) -> torch.Tensor:
    """The FD stencil of every point p [R, 3] -> [K, R, 3]: K = 7 with
    ``center`` (row 0 = p, rows 1+a / 4+a = p +- h e_a), else 6 (rows
    a / 3+a = p +- h e_a).  Rows are grouped by offset, so neighbouring
    points stay neighbours (warp coherence of the fold's culls)."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device) * h
    offs = torch.cat(([torch.zeros((1, 3), dtype=p.dtype, device=p.device)]
                      if center else []) + [eye, -eye])
    return p[None, :, :] + offs[:, None, :]


def surface_stencil_plain(plan: ScenePlan, tables: SceneTables,
                          p: torch.Tensor, h: float, *, center: bool,
                          collapse: bool = True) -> tuple:
    """K2's stencil entry in plain PyTorch: the combined mode at
    ``stencil_points`` of p [R, 3] -> (sd [K, R], widx [K, R],
    g [K, R, 3])."""
    q = stencil_points(p, h, center=center)
    K, R = q.shape[:2]
    sd, widx, g = surface_eval_plain(plan, tables, q.reshape(-1, 3),
                                     collapse=collapse)
    return sd.reshape(K, R), widx.reshape(K, R), g.reshape(K, R, 3)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/surface_kernel.cu, built on first use, its entry points bound."""
    lib = build.load_library("surface_kernel")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_surface_eval.argtypes = ([ptr] * 5 + [i32] * 9 + [f32] * 2
                                    + [ptr] * 4 + [ctypes.c_int64, ptr])
    lib.rt_surface_eval.restype = i32
    lib.rt_surface_stencil.argtypes = ([ptr] * 5 + [i32] * 8 + [f32]
                                       + [ptr] * 4 + [ctypes.c_int64, ptr])
    lib.rt_surface_stencil.restype = i32
    return lib


def _check_inputs(what: str, plan: ScenePlan, tables: SceneTables,
                  q: torch.Tensor) -> None:
    """Raise on what K2 does not take: q float32 [N, 3] on a CUDA device
    that also holds float32 tables."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if q.dtype != torch.float32 or q.dim() != 2 or q.shape[1] != 3:
        raise ValueError(f"{what}: points must be float32 [N, 3], got "
                         f"{q.dtype} {tuple(q.shape)}")
    if any(t.device != dev or t.dtype != torch.float32 for t in tables):
        raise ValueError(f"{what}: tables must be float32 on {dev}")


def surface_eval(plan: ScenePlan, tables: SceneTables, q: torch.Tensor, *,
                 mode: int = COMBINED, fd_h: Optional[float] = None,
                 collapse: bool = True, multipoint: bool = True,
                 fused: bool = False) -> Surface:
    """The scene at points q [N, 3] in ``mode`` -> (sd, winner or None,
    gradient or None), as ``surface_eval_plain``; ``tables`` is a
    SceneTables of tensors on q's device.  CPU tensors take the plain
    twin; CUDA tensors launch K2.  Forward only."""
    dev = q.device
    if dev.type == "cpu":
        return surface_eval_plain(plan, tables, q, mode=mode, fd_h=fd_h,
                                  collapse=collapse, fused=fused)
    _check_inputs("surface_eval", plan, tables, q)
    _check_mode(mode, fd_h)

    lib = _library()
    N = q.shape[0]
    scene = scene_tables.scene_operands(plan, tables, dev, collapse, fused)
    shared = scene.nbytes() <= scene_tables.SHARED_SCENE_BYTES
    with_grad = mode in (COMBINED, FD_GRAD, ANALYTIC)
    with_idx = mode in (COMBINED, WINNER)
    with torch.no_grad():
        q_soa = q.t().contiguous()
        out = torch.empty((4 if with_grad else 1, N), dtype=torch.float32,
                          device=dev)
        widx = (torch.empty((N,), dtype=torch.int32, device=dev)
                if with_idx else None)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
    h = float(fd_h or 0.0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rt_surface_eval(
            *scene.args(), int(shared), mode, int(multipoint), h,
            1.0 / (2.0 * h) if mode == FD_GRAD else 0.0, q_soa.data_ptr(),
            out.data_ptr(), widx.data_ptr() if with_idx else None,
            counter.data_ptr(), N, stream)
    build.check(lib, code, "surface kernel launch")
    if N:    # the C entry point launches nothing for zero points
        surface_eval.launches += 1
    return out[0], widx, (out[1:].t() if with_grad else None)


surface_eval.launches = 0


def surface_stencil(plan: ScenePlan, tables: SceneTables, p: torch.Tensor,
                    h: float, *, center: bool, collapse: bool = True
                    ) -> tuple:
    """The combined mode at the FD stencil of every hit p [R, 3] in ONE
    K2 launch -> (sd [K, R], widx [K, R], g [K, R, 3]), K = 7 with
    ``center`` else 6, rows in ``stencil_points``' order.  CPU tensors
    take ``surface_stencil_plain``.  On the card the kernel makes each
    stencil point in registers from the hit: no stencil tensor is built
    and nothing is transposed (a hit tensor that is a transposed [3, R]
    view, as K1's and K3's hit points are, is read in place).  Forward
    only."""
    dev = p.device
    if dev.type == "cpu":
        return surface_stencil_plain(plan, tables, p, h, center=center,
                                     collapse=collapse)
    _check_inputs("surface_stencil", plan, tables, p)

    lib = _library()
    R, K = p.shape[0], 7 if center else 6
    scene = scene_tables.scene_operands(plan, tables, dev, collapse)
    shared = scene.nbytes() <= scene_tables.SHARED_SCENE_BYTES
    with torch.no_grad():
        p_soa = p.t().contiguous()
        out = torch.empty((4, K, R), dtype=torch.float32, device=dev)
        widx = torch.empty((K, R), dtype=torch.int32, device=dev)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rt_surface_stencil(
            *scene.args(), int(shared), int(center), float(h),
            p_soa.data_ptr(), out.data_ptr(), widx.data_ptr(),
            counter.data_ptr(), R, stream)
    build.check(lib, code, "surface kernel stencil launch")
    if R:    # the C entry point launches nothing for zero hits
        surface_eval.launches += 1
    return out[0], widx, out[1:].permute(1, 2, 0)
