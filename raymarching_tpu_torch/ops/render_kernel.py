"""K1, the fused forward render: wrapper, plain twin and colour blend.

Counterpart of ``raymarching_tpu.ops.pallas_render.pallas_render_rays``
(primary outputs) and of ``_blend_bounces`` without bounces.  The kernel is
``csrc/render_kernel.cu``; ``render_rays_plain`` computes the same thing
in plain PyTorch from the ``core`` modules and is what a CPU tensor gets.
A CUDA tensor always goes to the kernel: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from raymarching_tpu.config import RenderConfig
from raymarching_tpu.scene.compile import MIN, ScenePlan, SceneTables

from ..core.march import MAX_STEP, dot3, march
from ..core.sdf import kernel_fold
from ..core.shading import TINY, fd_stencil
from ..tables import build_table, light_rows, pack_plan
from . import build

# Shadow outcomes travel as bits of an int32 mask.
MAX_LIGHTS = 32


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
    elif cfg.fused_generators:
        todo = "fused generators (ROADMAP Queue 1 item 8)"
    elif cfg.normal_mode != "fd":
        todo = f"normal_mode={cfg.normal_mode!r} (ROADMAP Queue 1 item 7)"
    elif cfg.soft_shadow_k > 0.0 or cfg.ao_strength > 0.0:
        todo = "soft shadows and AO (ROADMAP Queue 1 item 9)"
    elif cfg.reflect_strength > 0.0:
        todo = "mirror bounces (ROADMAP Queue 1 item 9)"
    elif cfg.aperture > 0.0:
        todo = "depth of field (ROADMAP Queue 1 item 9)"
    elif cfg.two_phase_k1 > 0:
        todo = "the two-phase march (ROADMAP Queue 1 item 11)"
    elif cfg.serve_raygen:
        todo = "in-kernel serve raygen (ROADMAP Queue 1 item 9)"
    elif plan.num_lights > MAX_LIGHTS:
        todo = f"more than {MAX_LIGHTS} lights"
    if todo is not None:
        raise NotImplementedError(f"not ported yet: {todo}")


def black_skip_ids(plan: ScenePlan, cfg: RenderConfig,
                   tables: SceneTables) -> Tuple[int, ...]:
    """Leaf ids of the black-lane shadow skip, or () when it is off: the
    plan's compile-time black primitives, used only while their live
    colour rows are still black (pallas_render.black_skip_ids plus the
    runtime gate)."""
    ids = tuple(plan.kernel.black_prims)
    if not (ids and cfg.shade_skip_black and cfg.shadows):
        return ()
    rows = tables.prim_color[list(ids)]
    return ids if bool((rows == 0.0).all()) else ()


def render_rays_plain(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                      origin: torch.Tensor, dirs: torch.Tensor) -> RayOutputs:
    """K1 in plain PyTorch, the same arithmetic in the same order: the
    kernel-form fold, the shadow march measured by projection and stopped
    at the light, both shadow skips, the unscaled FD stencil normalised
    with a tiny floor.  origin [3] or [R, 3], dirs [R, 3]."""
    check_supported(plan, cfg)
    eps = cfg.surface_precision
    sd_fn = lambda q: kernel_fold(plan, tables, q)[0]  # noqa: E731

    hit = march(sd_fn, origin, dirs, cfg.iterations, eps)
    p, sd = hit.position, hit.sd
    back = torch.clamp_max(sd, MAX_STEP)
    _, cidx = kernel_fold(plan, tables, p - back[:, None] * dirs, with_idx=True)

    skip = torch.zeros_like(hit.converged)
    black = black_skip_ids(plan, cfg, tables)
    if black:
        skip = cidx < 0
        for k in black:
            skip = skip | (cidx == k)

    g = fd_stencil(sd_fn, p, cfg.fd_h)
    inv = 1.0 / torch.clamp_min(torch.sqrt(dot3(g, g)), TINY)
    n = g * inv[:, None]

    L = plan.num_lights
    dirs_l, lamb_l = [], []
    for li in range(L):
        r = tables.light_pos[li] - p
        r = r * (1.0 / torch.clamp_min(torch.sqrt(dot3(r, r)), TINY))[:, None]
        dirs_l.append(r)
        lamb_l.append(dot3(n, r))
    if cfg.shadows and cfg.shadow_sat_skip and L > 0:
        upper = torch.zeros_like(sd)
        for lamb in lamb_l:
            upper = upper + torch.clamp_min(lamb, 0.0)
        skip = skip | (upper < cfg.saturation)

    off = cfg.surface_precision + cfg.offset_precision
    total = torch.zeros_like(sd)
    smask = torch.zeros(sd.shape, dtype=torch.int32, device=sd.device)
    for li in range(L):
        lamb = lamb_l[li]
        if cfg.shadows:
            lp = tables.light_pos[li]
            s = p + n * off
            t = lp - s
            tmax = torch.sqrt(dot3(t, t))
            q = march(sd_fn, s, dirs_l[li], cfg.iterations, eps, tmax=tmax,
                      init_done=skip, project_t=True).position
            passed = dot3(lp - q, dirs_l[li]) <= 0
            smask = smask | torch.where(passed, 0, 1 << li).to(torch.int32)
            lamb = torch.where(passed, lamb, 0.0)
        total = total + lamb
    light = torch.clamp(total, cfg.saturation, 1.0)
    return RayOutputs(p, sd, hit.converged, cidx, light, smask)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/render_kernel.cu, built on first use, its entry point bound."""
    lib = build.load_library("render_kernel")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_render_rays.argtypes = (
        [ptr] * 5 + [i32] * 7 + [f32] * 4 + [ptr, f32, f32, f32]
        + [ptr, ptr, ptr, ctypes.c_int64, ptr])
    lib.rt_render_rays.restype = i32
    return lib


@torch.no_grad()
def render_rays(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                origin: torch.Tensor, dirs: torch.Tensor) -> RayOutputs:
    """Fused forward for rays ``dirs`` [R, 3] from ``origin`` [3] or
    [R, 3]; ``tables`` is a SceneTables of tensors on the rays' device.
    CPU tensors take the plain twin; CUDA tensors launch K1.  Forward
    only: it records no autograd graph (``ops.render_op.FusedRender``
    differentiates it)."""
    dev = dirs.device
    if dev.type == "cpu":
        return render_rays_plain(plan, cfg, tables, origin, dirs)
    if dev.type != "cuda":
        raise ValueError(f"render_rays: unsupported device {dev}")
    check_supported(plan, cfg)
    tensors = [origin, dirs, *tables]
    if any(t.device != dev or t.dtype != torch.float32 for t in tensors):
        raise ValueError("render_rays: every tensor must be float32 on "
                         f"{dev}")
    R = dirs.shape[0]
    if dirs.shape != (R, 3) or origin.shape not in ((3,), (R, 3)):
        raise ValueError(f"render_rays: dirs {tuple(dirs.shape)}, origin "
                         f"{tuple(origin.shape)}")

    lib = _library()
    packed = pack_plan(plan.kernel)
    groups = packed.groups.to(dev)
    runs = packed.runs.to(dev)
    tbl = build_table(tables)
    lights = light_rows(tables)
    black = black_skip_ids(plan, cfg, tables)
    black_t = torch.tensor(black or (0,), dtype=torch.int32, device=dev)
    dirs_soa = dirs.t().contiguous()
    if origin.dim() == 2:
        org_soa, o3 = origin.t().contiguous(), (0.0, 0.0, 0.0)
    else:
        org_soa, o3 = None, tuple(float(v) for v in origin.tolist())
    out = torch.empty((6, R), dtype=torch.float32, device=dev)
    iout = torch.empty((2, R), dtype=torch.int32, device=dev)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rt_render_rays(
            tbl.data_ptr(), lights.data_ptr(), groups.data_ptr(),
            runs.data_ptr(), black_t.data_ptr(), groups.shape[0],
            int(packed.root_op == MIN), plan.num_lights,
            len(black) if black else -1, int(cfg.shadows),
            int(cfg.shadow_sat_skip), cfg.iterations, cfg.surface_precision,
            cfg.surface_precision + cfg.offset_precision, cfg.saturation,
            cfg.fd_h, org_soa.data_ptr() if org_soa is not None else None,
            *o3, dirs_soa.data_ptr(), out.data_ptr(), iout.data_ptr(), R,
            stream)
    build.check(lib, code, "render kernel launch")
    if R:    # the C entry point launches nothing for zero rays
        render_rays.launches += 1
    sd = out[3]
    return RayOutputs(p=out[:3].t(), sd=sd,
                      done=(out[4] > 0.5) & (sd < cfg.surface_precision),
                      cidx=iout[0], light=out[5], smask=iout[1])


render_rays.launches = 0


def winner_colors(cidx: torch.Tensor, prim_color: torch.Tensor
                  ) -> torch.Tensor:
    """Colours [R, 3] of the winner leaves, misses black: a row gather
    from the colour table with one zero row appended."""
    P = prim_color.shape[0]
    table = torch.cat([prim_color, prim_color.new_zeros(1, 3)])
    idx = torch.where(cidx < 0, P, cidx).long()
    return table.index_select(0, idx)


def blend(cidx: torch.Tensor, light: torch.Tensor,
          prim_color: torch.Tensor) -> torch.Tensor:
    """Ray colours [R, 3] = light * winner colour, misses black."""
    return light[:, None] * winner_colors(cidx, prim_color)
