"""K1, the fused forward render: wrapper, plain twin and colour blend.

Counterpart of ``raymarching_tpu.ops.pallas_render.pallas_render_rays``
(primary outputs) and of ``_blend_bounces`` without bounces.  The kernel is
``csrc/render_kernel.cu``; ``render_rays_plain`` computes the same thing
in plain PyTorch from the ``core`` modules and is what a CPU tensor gets.
A CUDA tensor always goes to the kernel: a build or launch failure raises.

The normal is a compile-time choice of the kernel: FD, or with
``cfg.normal_mode="analytic"`` the combined fold's winner gradient (JAX
``_scene_sd_idx_grad_tile``), which with ``save_winner`` also writes the
winner residuals (``shade_kernel.Winner``) that the fused analytic
backward reads instead of launching a kernel.  So is the field:
``cfg.fused_generators`` launches the kernel's fused-generator
instantiation on the fused packing (``tables.pack_plan(kp, fused=True)``),
whose residuals may name a carve by its extended winner id P + ordinal.

With ``0 < cfg.two_phase_k1 < cfg.iterations`` the same outputs come from
three launches instead of one (``pallas_render._two_phase_march`` and the
shade call): K3 (``ops.march_kernel``) for ``k1`` steps over every ray, K3
again for the rest of the budget over the unconverged tail packed densely,
then K4 (``ops.shade_kernel``) on the merged hit points.  The march is
memoryless given a ray's position, so the outputs are K1's bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..core.march import MarchResult, march
from ..core.sdf import kernel_fold
from ..scene.compile import ScenePlan, SceneTables
from .. import tables as scene_tables
from ..tables import fused_groups
from . import build
from .march_kernel import march_rays
from .scene_vjp import gather_rows
from .shade_kernel import (MAX_LIGHTS, check_normal_mode, ptr_or_none,
                           shade_operands, shade_rays, shade_rays_plain,
                           winner_buffers, winner_of)

# Phase-2 capacity as a fraction of the rays (pallas_render
# ._PHASE2_CAP_FRAC): with more rays than that still marching after phase 1,
# everything is marched again with the full budget.
PHASE2_CAP_FRAC = 8


class RayOutputs(NamedTuple):
    """K1's primary outputs for R rays (the backward's residuals)."""

    p: torch.Tensor      # [R, 3] hit point (after the final step)
    sd: torch.Tensor     # [R] SD at the pre-step point
    done: torch.Tensor   # [R] bool: converged (done and sd < eps)
    cidx: torch.Tensor   # [R] int32 colour winner leaf, -1 = none
    light: torch.Tensor  # [R] clamped Lambert term
    smask: torch.Tensor  # [R] int32, bit l set = light l shadowed


def check_supported(plan: ScenePlan, cfg: RenderConfig) -> None:
    """Raise NotImplementedError for anything outside the ported slice."""
    todo = None
    if plan.kernel is None:
        todo = "depth > 2 scenes (ROADMAP Queue 2, D8)"
    elif plan.proc:
        todo = "procedural leaves (ROADMAP Queue 1 item 10)"
    elif plan.colored_lights:
        todo = "coloured lights (ROADMAP Queue 1 item 9)"
    elif cfg.soft_shadow_k > 0.0 or cfg.ao_strength > 0.0:
        todo = "soft shadows and AO (ROADMAP Queue 1 item 9)"
    elif cfg.reflect_strength > 0.0:
        todo = "mirror bounces (ROADMAP Queue 1 item 9)"
    elif cfg.aperture > 0.0:
        todo = "depth of field (ROADMAP Queue 1 item 9)"
    elif cfg.serve_raygen:
        todo = "in-kernel serve raygen (ROADMAP Queue 1 item 9)"
    elif plan.num_lights > MAX_LIGHTS:
        todo = f"more than {MAX_LIGHTS} lights"
    if todo is not None:
        raise NotImplementedError(f"not ported yet: {todo}")
    check_normal_mode(cfg, False)
    if cfg.fused_generators:
        fused_groups(plan.kernel)       # the generator form the kernels take


def render_rays_plain(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                      origin: torch.Tensor, dirs: torch.Tensor,
                      collapse: bool = True, save_winner: bool = False):
    """K1 in plain PyTorch, the same arithmetic in the same order: the
    march over the kernel-form fold, then K4's plain twin on its hit
    points (one march whatever ``cfg.two_phase_k1`` says: this is the
    twin of the one kernel).  origin [3] or [R, 3], dirs [R, 3] ->
    RayOutputs, or with ``save_winner`` (RayOutputs, Winner)."""
    check_supported(plan, cfg)
    check_normal_mode(cfg, save_winner)
    with torch.no_grad():
        sd_fn = lambda q: kernel_fold(  # noqa: E731
            plan, tables, q, collapse=collapse,
            fused=cfg.fused_generators)[0]
        hit = march(sd_fn, origin, dirs, cfg.iterations,
                    cfg.surface_precision)
    return _ray_outputs(hit, shade_rays_plain(
        plan, cfg, tables, hit.position, hit.sd, dirs, collapse, save_winner),
        save_winner)


def _ray_outputs(hit: MarchResult, shaded, save_winner: bool):
    """RayOutputs of a march and its shading, and with ``save_winner`` the
    shading's winner residuals beside them."""
    if not save_winner:
        return RayOutputs(hit.position, hit.sd, hit.converged, *shaded)
    sh, winner = shaded
    return RayOutputs(hit.position, hit.sd, hit.converged, *sh), winner


def phase2_capacity(cfg: RenderConfig, R: int) -> int:
    """Most rays the second phase takes: an eighth of the rays, and at
    least one tile of the JAX kernels (tile_sublanes * 128 lanes)."""
    return max(R // PHASE2_CAP_FRAC, min(R, cfg.tile_sublanes * 128))


def two_phase_march(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                    origin: torch.Tensor, dirs: torch.Tensor,
                    collapse: bool = True) -> MarchResult:
    """March all rays ``cfg.two_phase_k1`` steps, then only the rays still
    marching, packed densely, for the rest of the budget
    (pallas_render._two_phase_march).  Exact: each ray's trajectory and its
    cap of ``cfg.iterations`` evaluations are those of one march.

    The JAX code needs static shapes: it sorts the unconverged lanes to
    the front (a stable argsort), marches a block of fixed capacity and
    chooses the overflow branch on the device.  Shapes are dynamic here, so
    the second phase takes exactly the unconverged lanes, in the order the
    stable sort gives them (ascending index), and the host reads their
    count to choose the branch, which costs one synchronisation."""
    k1 = cfg.two_phase_k1
    res1 = march_rays(plan, cfg, tables, origin, dirs, iterations=k1,
                      collapse=collapse)
    # primary marches have no tmax, so unconverged is "still marching"
    sel = (~res1.converged).nonzero().squeeze(1)
    if sel.numel() == 0:
        return res1
    if sel.numel() > phase2_capacity(cfg, dirs.shape[0]):
        return march_rays(plan, cfg, tables, origin, dirs, collapse=collapse)
    res2 = march_rays(plan, cfg, tables, res1.position[sel], dirs[sel],
                      iterations=cfg.iterations - k1, collapse=collapse)
    p, sd, conv = (v.clone() for v in res1)
    p[sel], sd[sel], conv[sel] = res2
    return MarchResult(p, sd, conv)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/render_kernel.cu, built on first use, its entry point bound."""
    lib = build.load_library("render_kernel")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_render_rays.argtypes = (
        [ptr] * 5 + [i32] * 6 + [ptr] * 2 + [i32] * 7 + [f32] * 4
        + [ptr, f32, f32, f32] + [ptr] * 6 + [ctypes.c_int64, ptr])
    lib.rt_render_rays.restype = i32
    return lib


@torch.no_grad()
def render_rays(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                origin: torch.Tensor, dirs: torch.Tensor,
                collapse: bool = True, save_winner: bool = False):
    """Fused forward for rays ``dirs`` [R, 3] from ``origin`` [3] or
    [R, 3]; ``tables`` is a SceneTables of tensors on the rays' device.
    -> RayOutputs, or with ``save_winner`` (analytic normals)
    (RayOutputs, Winner).  CPU tensors take the plain twin; CUDA tensors
    launch K1, or with ``cfg.two_phase_k1`` set K3, K3 and K4 (their
    plain twins on the CPU).  Forward only: it records no autograd graph
    (``ops.render_op.FusedRender`` differentiates it).  ``collapse``: the
    scene fold may take the exact Menger lattice collapse (the same bits
    as the leaf fold, which ``collapse=False`` keeps)."""
    dev = dirs.device
    check_supported(plan, cfg)
    analytic = check_normal_mode(cfg, save_winner)
    if 0 < cfg.two_phase_k1 < cfg.iterations:
        hit = two_phase_march(plan, cfg, tables, origin, dirs, collapse)
        return _ray_outputs(hit, shade_rays(
            plan, cfg, tables, hit.position, hit.sd, dirs, collapse,
            save_winner), save_winner)
    if dev.type == "cpu":
        return render_rays_plain(plan, cfg, tables, origin, dirs, collapse,
                                 save_winner)
    if dev.type != "cuda":
        raise ValueError(f"render_rays: unsupported device {dev}")
    tensors = [origin, dirs, *tables]
    if any(t.device != dev or t.dtype != torch.float32 for t in tensors):
        raise ValueError("render_rays: every tensor must be float32 on "
                         f"{dev}")
    R = dirs.shape[0]
    if dirs.shape != (R, 3) or origin.shape not in ((3,), (R, 3)):
        raise ValueError(f"render_rays: dirs {tuple(dirs.shape)}, origin "
                         f"{tuple(origin.shape)}")

    lib = _library()
    scene = scene_tables.scene_operands(plan, tables, dev, collapse,
                                        cfg.fused_generators)
    lights, black_t, shade_args = shade_operands(plan, cfg, tables, dev)
    shared = (scene.nbytes(plan.num_lights)
              <= scene_tables.SHARED_SCENE_BYTES)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    dirs_soa = dirs.t().contiguous()
    if origin.dim() == 2:
        org_soa, o3 = origin.t().contiguous(), (0.0, 0.0, 0.0)
    else:
        org_soa, o3 = None, tuple(float(v) for v in origin.tolist())
    out = torch.empty((6, R), dtype=torch.float32, device=dev)
    iout = torch.empty((2, R), dtype=torch.int32, device=dev)
    wres, widx = winner_buffers(R, dev, save_winner)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rt_render_rays(
            *scene.args(), lights.data_ptr(), black_t.data_ptr(), int(shared),
            int(analytic), *shade_args, ptr_or_none(org_soa), *o3,
            dirs_soa.data_ptr(), out.data_ptr(), iout.data_ptr(),
            ptr_or_none(wres), ptr_or_none(widx), counter.data_ptr(), R,
            stream)
    build.check(lib, code, "render kernel launch")
    if R:    # the C entry point launches nothing for zero rays
        render_rays.launches += 1
    sd = out[3]
    ray = RayOutputs(p=out[:3].t(), sd=sd,
                     done=(out[4] > 0.5) & (sd < cfg.surface_precision),
                     cidx=iout[0], light=out[5], smask=iout[1])
    return (ray, winner_of(wres, widx)) if save_winner else ray


render_rays.launches = 0


def blend(cidx: torch.Tensor, light: torch.Tensor,
          prim_color: torch.Tensor) -> torch.Tensor:
    """Ray colours [R, 3] = light * winner colour, misses black."""
    return light[:, None] * gather_rows(cidx, prim_color)
