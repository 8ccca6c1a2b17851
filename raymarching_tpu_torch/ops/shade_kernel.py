"""K4, the shade kernel: wrapper and plain twin.

Counterpart of ``raymarching_tpu.ops.pallas_render._shade_kernel`` (the
``_compiled_shade_call`` of the two-phase path) for the ported shading
set: K1's shade body on hit points that come in.  In (p, sd, dirs), out
(colour winner, clamped Lambert term, shadow mask): FD normals, hard
shadows that stop at the light, both shadow skips with the black-lane
gate, white lights.  The kernel is ``csrc/shade_kernel.cu``;
``shade_rays_plain`` computes the same thing in plain PyTorch (it is the
second half of K1's own twin) and is what a CPU tensor gets.  A CUDA
tensor always goes to the kernel: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

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
                     collapse: bool = True) -> ShadeOutputs:
    """K4 in plain PyTorch, the same arithmetic in the same order: the
    winner at the pre-step point p - min(sd, MAX_STEP) dirs, the unscaled
    FD stencil normalised with a tiny floor, the shadow march measured by
    projection and stopped at the light, both shadow skips.  p, dirs
    [R, 3], sd [R]."""
    eps = cfg.surface_precision
    with torch.no_grad():
        sd_fn = lambda q: kernel_fold(  # noqa: E731
            plan, tables, q, collapse=collapse)[0]
        back = torch.clamp_max(sd, MAX_STEP)
        _, cidx = kernel_fold(plan, tables, p - back[:, None] * dirs,
                              with_idx=True)

        skip = torch.zeros(sd.shape, dtype=torch.bool, device=sd.device)
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
    return ShadeOutputs(cidx, light, smask)


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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/shade_kernel.cu, built on first use, its entry point bound."""
    lib = build.load_library("shade_kernel")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_shade_rays.argtypes = ([ptr] * 5 + [i32] * 5 + [ptr] * 2
                                  + [i32] * 6 + [f32] * 4 + [ptr] * 4
                                  + [ctypes.c_int64, ptr])
    lib.rt_shade_rays.restype = i32
    return lib


@torch.no_grad()
def shade_rays(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
               p: torch.Tensor, sd: torch.Tensor, dirs: torch.Tensor,
               collapse: bool = True) -> ShadeOutputs:
    """Shade hit points p [R, 3] of rays ``dirs`` [R, 3] whose march last
    evaluated ``sd`` [R]; ``tables`` is a SceneTables of tensors on the
    rays' device, and the configuration must be one ``ops.render_kernel
    .check_supported`` accepts.  CPU tensors take the plain twin; CUDA
    tensors launch K4.  Forward only."""
    dev = dirs.device
    if dev.type == "cpu":
        return shade_rays_plain(plan, cfg, tables, p, sd, dirs, collapse)
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

    lib = _library()
    scene = scene_tables.scene_operands(plan, tables, dev, collapse)
    lights, black_t, shade_args = shade_operands(plan, cfg, tables, dev)
    shared = (scene.nbytes(plan.num_lights)
              <= scene_tables.SHARED_SCENE_BYTES)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = torch.cat([p.t(), sd[None], dirs.t()]).contiguous()     # [7, R]
    light = torch.empty((R,), dtype=torch.float32, device=dev)
    iout = torch.empty((2, R), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rt_shade_rays(
            *scene.args(), lights.data_ptr(), black_t.data_ptr(), int(shared),
            *shade_args, rows.data_ptr(), light.data_ptr(), iout.data_ptr(),
            counter.data_ptr(), R, stream)
    build.check(lib, code, "shade kernel launch")
    if R:    # the C entry point launches nothing for zero rays
        shade_rays.launches += 1
    return ShadeOutputs(cidx=iout[0], light=light, smask=iout[1])


shade_rays.launches = 0
