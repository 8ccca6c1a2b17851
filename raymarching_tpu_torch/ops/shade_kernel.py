"""K4, the shade kernel: wrapper and plain twin.

Counterpart of ``raymarching_tpu.ops.pallas_render._shade_kernel`` (the
``_compiled_shade_call`` of the two-phase path) for the ported shading
set: K1's shade body on hit points that come in.  In (p, sd, dirs), out
(colour winner, clamped Lambert term, shadow mask): FD or analytic
normals (``cfg.normal_mode``) on exact tables or with fused generators
(``cfg.fused_generators``), hard shadows that stop at the light, both
shadow skips with the black-lane gate, white lights.  With
``save_winner`` (analytic normals only) the winner residuals of the
normal come out too (``Winner``; JAX's ``save_winner``), which make the
fused analytic backward launch no kernel.  The kernel is
``csrc/shade_kernel.cu``;
``shade_rays_plain`` computes the same thing in plain PyTorch (it is the
second half of K1's own twin) and is what a CPU tensor gets.  A CUDA
tensor always goes to the kernel: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import RenderConfig
from ..core.march import MAX_STEP, dot3, march
from ..core.sdf import kernel_fold
from ..core.shading import TINY, fd_stencil
from ..scene.compile import ScenePlan, SceneTables
from .. import tables as scene_tables
from ..tables import light_rows
from . import build

# Shadow outcomes travel as bits of an int32 mask.
MAX_LIGHTS = 32


class ShadeOutputs(NamedTuple):
    cidx: torch.Tensor   # [R] int32 colour winner leaf, -1 = none
    light: torch.Tensor  # [R] clamped Lambert term
    smask: torch.Tensor  # [R] int32, bit l set = light l shadowed


class Winner(NamedTuple):
    """Winner residuals of the analytic normal at the hit points
    (pallas_render._save_winner_engaged): the combined fold's SD, winning
    leaf and winner gradient there, bit for bit what K2's combined mode
    gives at the same points.  They travel beside RayOutputs and
    ShadeOutputs, not in them, so those stay tuples of six and three
    tensors."""

    sd: torch.Tensor     # [R] scene SD at the hit
    widx: torch.Tensor   # [R] int32 winning leaf, -1 = none
    g: torch.Tensor      # [R, 3] d scene / dp: the analytic normal's primal


def check_normal_mode(cfg: RenderConfig, save_winner: bool) -> bool:
    """Whether ``cfg`` asks for analytic normals; raises for a mode the
    port does not know and for residuals without analytic normals."""
    if cfg.normal_mode not in ("fd", "analytic"):
        raise NotImplementedError(
            f"not ported yet: normal_mode={cfg.normal_mode!r} (the port has "
            "'fd' and 'analytic')")
    analytic = cfg.normal_mode == "analytic"
    if save_winner and not analytic:
        raise ValueError("winner residuals need normal_mode='analytic'")
    return analytic


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


def shade_rays_plain(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                     p: torch.Tensor, sd: torch.Tensor, dirs: torch.Tensor,
                     collapse: bool = True, save_winner: bool = False):
    """K4 in plain PyTorch, the same arithmetic in the same order: the
    winner at the pre-step point p - min(sd, MAX_STEP) dirs, the unscaled
    FD stencil (or the combined fold's winner gradient) normalised with a
    tiny floor, the shadow march measured by projection and stopped at the
    light, both shadow skips.  p, dirs [R, 3], sd [R] -> ShadeOutputs, or
    with ``save_winner`` (ShadeOutputs, Winner)."""
    analytic = check_normal_mode(cfg, save_winner)
    eps = cfg.surface_precision
    fused = cfg.fused_generators
    with torch.no_grad():
        sd_fn = lambda q: kernel_fold(  # noqa: E731
            plan, tables, q, collapse=collapse, fused=fused)[0]
        back = torch.clamp_max(sd, MAX_STEP)
        _, cidx = kernel_fold(plan, tables, p - back[:, None] * dirs,
                              with_idx=True, fused=fused)

        skip = torch.zeros(sd.shape, dtype=torch.bool, device=sd.device)
        black = black_skip_ids(plan, cfg, tables)
        if black:
            skip = cidx < 0
            for k in black:
                skip = skip | (cidx == k)

        if analytic:
            # the combined fold at the hit (K2's combined mode): its
            # gradient is the normal, all three are the residuals
            winner = Winner(*kernel_fold(plan, tables, p, with_grad=True,
                                         collapse=collapse, fused=fused))
            g = winner.g
        else:
            g = fd_stencil(sd_fn, p, cfg.fd_h)
        inv = 1.0 / torch.clamp_min(torch.sqrt(dot3(g, g)), TINY)
        n = g * inv[:, None]

        L = plan.num_lights
        dirs_l, lamb_l = [], []
        for li in range(L):
            r = tables.light_pos[li] - p
            r = r * (1.0 / torch.clamp_min(torch.sqrt(dot3(r, r)),
                                           TINY))[:, None]
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
                q = march(sd_fn, s, dirs_l[li], cfg.iterations, eps,
                          tmax=tmax, init_done=skip, project_t=True).position
                passed = dot3(lp - q, dirs_l[li]) <= 0
                smask = smask | torch.where(passed, 0, 1 << li).to(torch.int32)
                lamb = torch.where(passed, lamb, 0.0)
            total = total + lamb
        light = torch.clamp(total, cfg.saturation, 1.0)
    out = ShadeOutputs(cidx, light, smask)
    return (out, winner) if save_winner else out


def shade_operands(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                   device) -> tuple:
    """The ``ShadeParams`` part of K1's and K4's C entry points: the
    tensors to keep alive across the launch (light rows, black ids) and
    the argument list from ``lights`` to ``fd_h``."""
    lights = light_rows(tables)
    black = black_skip_ids(plan, cfg, tables)
    black_t = torch.tensor(black or (0,), dtype=torch.int32, device=device)
    args = (plan.num_lights, len(black) if black else -1, int(cfg.shadows),
            int(cfg.shadow_sat_skip), cfg.iterations, cfg.surface_precision,
            cfg.surface_precision + cfg.offset_precision, cfg.saturation,
            cfg.fd_h)
    return lights, black_t, args


def winner_buffers(R: int, device, save_winner: bool) -> tuple:
    """The kernels' residual outputs: wres [4, R] float32 (sd, gx, gy, gz)
    and widx [R] int32, or (None, None) when none are asked for."""
    if not save_winner:
        return None, None
    return (torch.empty((4, R), dtype=torch.float32, device=device),
            torch.empty((R,), dtype=torch.int32, device=device))


def winner_of(wres: torch.Tensor, widx: torch.Tensor) -> Winner:
    """The Winner view of ``winner_buffers``' two tensors."""
    return Winner(sd=wres[0], widx=widx, g=wres[1:].t())


def ptr_or_none(t: Optional[torch.Tensor]):
    """A tensor's device pointer for a C entry point, or None (NULL)."""
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/shade_kernel.cu, built on first use, its entry point bound."""
    lib = build.load_library("shade_kernel")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_shade_rays.argtypes = ([ptr] * 5 + [i32] * 6 + [ptr] * 2
                                  + [i32] * 7 + [f32] * 4 + [ptr] * 6
                                  + [ctypes.c_int64, ptr])
    lib.rt_shade_rays.restype = i32
    return lib


@torch.no_grad()
def shade_rays(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
               p: torch.Tensor, sd: torch.Tensor, dirs: torch.Tensor,
               collapse: bool = True, save_winner: bool = False):
    """Shade hit points p [R, 3] of rays ``dirs`` [R, 3] whose march last
    evaluated ``sd`` [R]; ``tables`` is a SceneTables of tensors on the
    rays' device, and the configuration must be one ``ops.render_kernel
    .check_supported`` accepts.  -> ShadeOutputs, or with ``save_winner``
    (analytic normals) (ShadeOutputs, Winner).  CPU tensors take the
    plain twin; CUDA tensors launch K4.  Forward only."""
    dev = dirs.device
    if dev.type == "cpu":
        return shade_rays_plain(plan, cfg, tables, p, sd, dirs, collapse,
                                save_winner)
    if dev.type != "cuda":
        raise ValueError(f"shade_rays: unsupported device {dev}")
    R = dirs.shape[0]
    tensors = [p, sd, dirs, *tables]
    if any(t.device != dev or t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"shade_rays: every tensor must be float32 on {dev}")
    if dirs.shape != (R, 3) or p.shape != (R, 3) or sd.shape != (R,):
        raise ValueError(f"shade_rays: p {tuple(p.shape)}, sd "
                         f"{tuple(sd.shape)}, dirs {tuple(dirs.shape)}")
    if plan.num_lights > MAX_LIGHTS:
        raise NotImplementedError(f"not ported yet: more than {MAX_LIGHTS} "
                                  "lights")
    analytic = check_normal_mode(cfg, save_winner)

    lib = _library()
    scene = scene_tables.scene_operands(plan, tables, dev, collapse,
                                        cfg.fused_generators)
    lights, black_t, shade_args = shade_operands(plan, cfg, tables, dev)
    shared = (scene.nbytes(plan.num_lights)
              <= scene_tables.SHARED_SCENE_BYTES)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = torch.cat([p.t(), sd[None], dirs.t()]).contiguous()     # [7, R]
    light = torch.empty((R,), dtype=torch.float32, device=dev)
    iout = torch.empty((2, R), dtype=torch.int32, device=dev)
    wres, widx = winner_buffers(R, dev, save_winner)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rt_shade_rays(
            *scene.args(), lights.data_ptr(), black_t.data_ptr(), int(shared),
            int(analytic), *shade_args, rows.data_ptr(), light.data_ptr(),
            iout.data_ptr(), ptr_or_none(wres), ptr_or_none(widx),
            counter.data_ptr(), R, stream)
    build.check(lib, code, "shade kernel launch")
    if R:    # the C entry point launches nothing for zero rays
        shade_rays.launches += 1
    out = ShadeOutputs(cidx=iout[0], light=light, smask=iout[1])
    return (out, winner_of(wres, widx)) if save_winner else out


shade_rays.launches = 0
