"""K3, the standalone march: wrapper and plain twin.

Counterpart of ``raymarching_tpu.ops.pallas_march.pallas_march``: march a
flat batch of rays for up to ``iterations`` scene evaluations; with
``tmax`` each ray also stops once its projected distance (p - o) . d
reaches its own limit (shadow rays stop at the light); with
``with_steps`` each ray's evaluations are counted.  The kernel is
``csrc/march_kernel.cu``; ``march_rays_plain`` computes the same thing in
plain PyTorch (``core.march.march`` over the kernel-form fold) and is what
a CPU tensor gets.  A CUDA tensor always goes to the kernel: a build or
launch failure raises.  ``collapse`` (default on) lets the scene fold take
the exact Menger lattice collapse while the live tables allow it; off, the
kernel and the twin fold every leaf: the same bits either way.  With
``cfg.fused_generators`` the march is on the fused generator field.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..config import RenderConfig
from ..core.march import MarchResult, march
from ..core.sdf import kernel_fold
from ..scene.compile import ScenePlan, SceneTables
from .. import tables as scene_tables
from . import build


def march_rays_plain(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                     origin: torch.Tensor, dirs: torch.Tensor, *,
                     iterations: Optional[int] = None,
                     tmax: Optional[torch.Tensor] = None,
                     with_steps: bool = False, collapse: bool = True):
    """K3 in plain PyTorch, the same arithmetic in the same order: origin
    [3] or [R, 3], dirs [R, 3], tmax [R] or None -> MarchResult, or
    (MarchResult, steps [R] int32) with ``with_steps``."""
    its = cfg.iterations if iterations is None else iterations
    with torch.no_grad():
        sd_fn = lambda q: kernel_fold(  # noqa: E731
            plan, tables, q, collapse=collapse,
            fused=cfg.fused_generators)[0]
        return march(sd_fn, origin, dirs, its, cfg.surface_precision,
                     tmax=tmax, project_t=True, with_steps=with_steps)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/march_kernel.cu, built on first use, its entry point bound."""
    lib = build.load_library("march_kernel")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_march_rays.argtypes = ([ptr] * 5 + [i32] * 8 + [f32, ptr]
                                  + [f32] * 3 + [ptr] * 5
                                  + [ctypes.c_int64, ptr])
    lib.rt_march_rays.restype = i32
    return lib


def march_rays(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
               origin: torch.Tensor, dirs: torch.Tensor, *,
               iterations: Optional[int] = None,
               tmax: Optional[torch.Tensor] = None,
               with_steps: bool = False, collapse: bool = True):
    """March rays ``dirs`` [R, 3] from ``origin`` [3] or [R, 3] for up to
    ``iterations`` evaluations (default ``cfg.iterations``) ->
    MarchResult(position [R, 3], sd [R], converged [R]), or (MarchResult,
    steps [R] int32) with ``with_steps``.  ``tmax`` [R]: per-ray distance
    limit.  ``tables`` is a SceneTables of tensors on the rays' device.
    CPU tensors take the plain twin; CUDA tensors launch K3.  Forward
    only (``ops.march_op.MarchOp`` differentiates it)."""
    dev = dirs.device
    if dev.type == "cpu":
        return march_rays_plain(plan, cfg, tables, origin, dirs,
                                iterations=iterations, tmax=tmax,
                                with_steps=with_steps, collapse=collapse)
    if dev.type != "cuda":
        raise ValueError(f"march_rays: unsupported device {dev}")
    if plan.kernel is None:
        raise NotImplementedError(
            "not ported yet: depth > 2 scenes (ROADMAP Queue 2, D8)")
    its = cfg.iterations if iterations is None else int(iterations)
    R = dirs.shape[0]
    tensors = [origin, dirs, *tables] + ([tmax] if tmax is not None else [])
    if any(t.device != dev or t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"march_rays: every tensor must be float32 on {dev}")
    if (dirs.shape != (R, 3) or origin.shape not in ((3,), (R, 3))
            or (tmax is not None and tmax.shape != (R,))):
        raise ValueError(f"march_rays: dirs {tuple(dirs.shape)}, origin "
                         f"{tuple(origin.shape)}, tmax "
                         f"{None if tmax is None else tuple(tmax.shape)}")

    lib = _library()
    scene = scene_tables.scene_operands(plan, tables, dev, collapse,
                                        cfg.fused_generators)
    shared = scene.nbytes() <= scene_tables.SHARED_SCENE_BYTES
    with torch.no_grad():
        dirs_soa = dirs.t().contiguous()
        if origin.dim() == 2:
            org_soa, o3 = origin.t().contiguous(), (0.0, 0.0, 0.0)
        else:
            org_soa, o3 = None, tuple(float(v) for v in origin.tolist())
        tmax_c = tmax.contiguous() if tmax is not None else None
        out = torch.empty((5, R), dtype=torch.float32, device=dev)
        steps = (torch.empty((R,), dtype=torch.int32, device=dev)
                 if with_steps else None)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rt_march_rays(
            *scene.args(), int(shared), its, cfg.surface_precision,
            org_soa.data_ptr() if org_soa is not None else None, *o3,
            dirs_soa.data_ptr(),
            tmax_c.data_ptr() if tmax_c is not None else None,
            out.data_ptr(), steps.data_ptr() if with_steps else None,
            counter.data_ptr(), R, stream)
    build.check(lib, code, "march kernel launch")
    if R:    # the C entry point launches nothing for zero rays
        march_rays.launches += 1
    sd = out[3]
    res = MarchResult(position=out[:3].t(), sd=sd,
                      converged=(out[4] > 0.5) & (sd < cfg.surface_precision))
    return (res, steps) if with_steps else res


march_rays.launches = 0
