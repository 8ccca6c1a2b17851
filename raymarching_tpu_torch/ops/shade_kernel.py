"""K4, the shade kernel: wrapper and plain twin.

Counterpart of ``raymarching_tpu.ops.pallas_render._shade_kernel`` (the
``_compiled_shade_call`` of the two-phase path): K1's shade body on hit
points that come in.  In (p, sd, dirs), out (colour winner, clamped
Lambert term, shadow mask): FD or analytic normals (``cfg.normal_mode``)
on exact tables or with fused generators (``cfg.fused_generators``),
shadows that stop at the light, both shadow skips with the black-lane
gate.  With ``save_winner`` (analytic normals only) the winner residuals
of the normal come out too (``Winner``; JAX's ``save_winner``), which make
the fused analytic backward launch no kernel.

The shading extensions (``extended``: coloured lights, soft shadows,
ambient occlusion; ``_shade_body``'s branches) take the kernel's extended
entries (``csrc/shade_ext_kernel.cu``): the light term is [R, 3] with
coloured lights, and with ``save_factors`` the penumbra and occlusion
factors come out beside it (``Factors``; the backward replay reapplies
them).  The reference shading keeps the reference entries
(``csrc/shade_kernel.cu``).  ``shade_rays_plain`` computes the same thing
in plain PyTorch (it is the second half of K1's own twin) and is what a
CPU tensor gets.  A CUDA tensor always goes to a kernel: a build or
launch failure raises.
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

# Shadow outcomes travel as bits of an int32 mask, in K1 and K4 as in the
# JAX kernels (pallas_render._shade_body's smask), so the fused path takes
# at most 32 lights (JAX's mega kernel: 31, the bit 1 << 31 overflows its
# int32 constant).  The multi and ref paths keep no mask and take any count,
# as the JAX package's pallas and ref backends do.
MAX_LIGHTS = 32
# AO taps whose distances the extended entries take by value
# (csrc/shade.cuh kMaxAoSamples); past it their FarShadeExt instantiations
# form each distance from ao_delta.  Every count renders, on the card as in
# the plain twins, as the JAX kernels loop over any count.
MAX_AO_SAMPLES = 256


class ShadeOutputs(NamedTuple):
    cidx: torch.Tensor   # [R] int32 colour winner leaf, -1 = none
    light: torch.Tensor  # [R] clamped Lambert term; [R, 3] coloured lights
    smask: torch.Tensor  # [R] int32, bit l set = light l shadowed


class Factors(NamedTuple):
    """The stop-gradient factors of the shading extensions, which the
    backward replay reapplies as constants (pallas_render
    ._unpack_shade_outs' sfac and aofac).  They travel beside
    RayOutputs and ShadeOutputs, as Winner does."""

    sfac: Optional[torch.Tensor]   # [L, R] penumbra factor a light, or None
    aofac: Optional[torch.Tensor]  # [R] occlusion factor, or None


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


def check_lights(plan: ScenePlan) -> None:
    """Raise ValueError for more lights than the fused kernels' shadow
    mask holds (MAX_LIGHTS)."""
    if plan.num_lights > MAX_LIGHTS:
        raise ValueError(
            f"{plan.num_lights} lights: the fused kernels (K1, K4) keep a "
            f"light's shadow in a bit of an int32, so they take at most "
            f"{MAX_LIGHTS}, as the JAX package's mega kernel does; render "
            "with backend='multi' or 'ref', which take any count")


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


def extensions(plan: ScenePlan, cfg: RenderConfig) -> Tuple[bool, bool,
                                                              bool]:
    """Which shading extensions a render takes: (coloured lights, soft
    shadows, ambient occlusion), as pallas_render_rays decides them."""
    return (bool(plan.colored_lights),
            cfg.shadows and cfg.soft_shadow_k > 0.0,
            cfg.ao_strength > 0.0)


def extended(plan: ScenePlan, cfg: RenderConfig) -> bool:
    """Whether a render takes the kernels' extended shading entries."""
    return any(extensions(plan, cfg))


def bounce_count(cfg: RenderConfig) -> int:
    """Mirror bounces after the primary hit (pallas_render_rays'
    ``bounces``): ``cfg.reflect_bounces`` with ``reflect_strength > 0``,
    else none."""
    return max(cfg.reflect_bounces, 0) if cfg.reflect_strength > 0.0 else 0


def with_extras(out, winner, factors, save_winner: bool,
                save_factors: bool):
    """``out`` alone, or (out, Winner if asked, Factors if asked)."""
    extras = ((winner,) if save_winner else ()) + (
        (factors,) if save_factors else ())
    return (out, *extras) if extras else out


def ao_taps(cfg: RenderConfig) -> Tuple[list, list]:
    """AO tap distances i ao_delta and weights 2^-i, i = 1..ao_samples:
    doubles, which the kernels and the twin round once to float32 as the
    JAX kernel rounds its Python constants (past MAX_AO_SAMPLES taps the
    kernels form the same distances from ``ao_delta``)."""
    n = cfg.ao_samples
    return ([i * cfg.ao_delta for i in range(1, n + 1)],
            [2.0 ** -i for i in range(1, n + 1)])


def black_skip_ids(plan: ScenePlan, cfg: RenderConfig,
                   tables: SceneTables) -> Tuple[int, ...]:
    """Leaf ids of the black-lane shadow skip, or () when it is off: the
    plan's compile-time black primitives, used only while their live
    colour rows are still black (pallas_render.black_skip_ids plus the
    runtime gate).  Off with mirror bounces, as pallas_render_rays passes
    no black ids then: a black hit still shades its bounces' origins."""
    # a plan with no two-level form has none (pallas_render
    # .black_skip_ids: getattr(kernel_key(plan), "black_prims", ()))
    ids = tuple(getattr(plan.kernel, "black_prims", ()))
    if not (ids and cfg.shade_skip_black and cfg.shadows
            and not bounce_count(cfg)):
        return ()
    rows = tables.prim_color[list(ids)]
    return ids if bool((rows == 0.0).all()) else ()


def shade_rays_plain(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                     p: torch.Tensor, sd: torch.Tensor, dirs: torch.Tensor,
                     collapse: bool = True, save_winner: bool = False,
                     save_factors: bool = False):
    """K4 in plain PyTorch, the same arithmetic in the same order: the
    winner at the pre-step point p - min(sd, MAX_STEP) dirs, the unscaled
    FD stencil (or the combined fold's winner gradient) normalised with a
    tiny floor, the shadow march measured by projection and stopped at the
    light, both shadow skips (the saturation floor's not with coloured
    lights), and the extensions: the penumbra tracker inside the shadow
    march, the coloured sum, the per-channel clamp, the AO taps.
    p, dirs [R, 3], sd [R] -> ShadeOutputs, or with ``save_winner`` or
    ``save_factors`` (ShadeOutputs, Winner if asked, Factors if asked)."""
    out, winner, factors, _ = shade_plain(plan, cfg, tables, p, sd, dirs,
                                          collapse, save_winner)
    return with_extras(out, winner, factors, save_winner, save_factors)


def shade_plain(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                p: torch.Tensor, sd: torch.Tensor, dirs: torch.Tensor,
                collapse: bool = True, save_winner: bool = False) -> tuple:
    """``shade_rays_plain``'s work -> (ShadeOutputs, Winner or None,
    Factors, the unit normal n [R, 3]): K1's bounce twin reflects off n."""
    analytic = check_normal_mode(cfg, save_winner)
    colored, soft, ao = extensions(plan, cfg)
    eps = cfg.surface_precision
    fused = cfg.fused_generators
    f32 = dict(dtype=torch.float32, device=sd.device)
    winner = None
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
        if cfg.shadows and cfg.shadow_sat_skip and L > 0 and not colored:
            upper = torch.zeros_like(sd)
            for lamb in lamb_l:
                upper = upper + torch.clamp_min(lamb, 0.0)
            skip = skip | (upper < cfg.saturation)

        off = cfg.surface_precision + cfg.offset_precision
        total = [torch.zeros_like(sd) for _ in range(3 if colored else 1)]
        smask = torch.zeros(sd.shape, dtype=torch.int32, device=sd.device)
        sfac = []
        for li in range(L):
            lamb = lamb_l[li]
            if cfg.shadows:
                lp = tables.light_pos[li]
                s = p + n * off
                t = lp - s
                tmax = torch.sqrt(dot3(t, t))
                res = march(sd_fn, s, dirs_l[li], cfg.iterations, eps,
                            tmax=tmax, init_done=skip, project_t=True,
                            soft_k=cfg.soft_shadow_k if soft else None)
                q = (res[0] if soft else res).position
                passed = dot3(lp - q, dirs_l[li]) <= 0
                smask = smask | torch.where(passed, 0, 1 << li).to(torch.int32)
                if soft:
                    fac = torch.where(passed, res[1], torch.zeros((), **f32))
                    sfac.append(fac)
                    lamb = lamb * fac
                else:
                    lamb = torch.where(passed, lamb, 0.0)
            if colored:
                col = tables.light_color[li]
                total = [t_ + lamb * col[c] for c, t_ in enumerate(total)]
            else:
                total = [total[0] + lamb]
        light = torch.stack([torch.clamp(t_, cfg.saturation, 1.0)
                             for t_ in total], dim=-1)
        aofac = None
        if ao:
            occ = torch.zeros_like(sd)
            for d, w in zip(*ao_taps(cfg)):
                d = torch.tensor(d, **f32)
                occ = occ + w * (d - sd_fn(p + d * n))
            aofac = torch.clamp(1.0 - cfg.ao_strength * occ, 0.0, 1.0)
            light = light * aofac[:, None]
        light = light if colored else light[:, 0]
    factors = Factors(
        (torch.stack(sfac) if sfac else torch.zeros((0,) + sd.shape, **f32))
        if soft else None, aofac)
    return ShadeOutputs(cidx, light, smask), winner, factors, n


def shade_operands(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                   device) -> tuple:
    """The ``ShadeParams`` part of K1's and K4's C entry points: the
    tensors to keep alive across the launch (light rows, black ids) and
    the argument list from ``lights`` to ``fd_h``.  With coloured lights
    the saturation-floor skip is off (no bound holds per channel)."""
    lights = light_rows(tables)
    black = black_skip_ids(plan, cfg, tables)
    black_t = torch.tensor(black or (0,), dtype=torch.int32, device=device)
    sat_skip = cfg.shadow_sat_skip and not plan.colored_lights
    args = (plan.num_lights, len(black) if black else -1, int(cfg.shadows),
            int(sat_skip), cfg.iterations, cfg.surface_precision,
            cfg.surface_precision + cfg.offset_precision, cfg.saturation,
            cfg.fd_h)
    return lights, black_t, args


def ext_operands(plan: ScenePlan, cfg: RenderConfig, R: int, device,
                 sets: int = 1):
    """The extended entries' arguments from ``soft_k`` to ``ao_delta`` and
    their outputs: (args, light [C, R] (C = 3 with coloured lights, else
    1), sfac [L, R] or None, aofac [R] or None); with ``sets`` > 1 (K1's
    bounce entries: one shade set for the primary hit and one a bounce)
    that many of each, one after the other: light [sets C, R], sfac
    [sets L, R], aofac [sets R]."""
    colored, soft, ao = extensions(plan, cfg)
    d, _ = ao_taps(cfg) if ao else ([], [])
    # the distances by value up to MAX_AO_SAMPLES taps, else ao_delta alone
    ao_d = (ctypes.c_float * max(len(d), 1))(
        *(d if len(d) <= MAX_AO_SAMPLES else ()))
    # no lights, no penumbra to track
    soft = soft and plan.num_lights > 0
    args = (cfg.soft_shadow_k if soft else 0.0, int(colored),
            cfg.ao_strength if ao else 0.0, len(d), ao_d,
            float(cfg.ao_delta))
    f32 = dict(dtype=torch.float32, device=device)
    return (args, torch.empty((sets * (3 if colored else 1), R), **f32),
            torch.empty((sets * plan.num_lights, R), **f32) if soft else None,
            torch.empty((sets * R,), **f32) if ao else None)


def light_of(light: torch.Tensor) -> torch.Tensor:
    """The light term of an extended launch's [C, R] buffer: [R, 3] or
    [R]."""
    return light.t() if light.shape[0] == 3 else light[0]


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


# ctypes argument types of ShadeParams' C arguments, from ``tbl`` to
# ``fd_h``, and of the extensions' from ``soft_k`` to ``ao_delta``
_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SHADE_ARGTYPES = [_PTR] * 5 + [_I32] * 6 + [_PTR] * 2 + [_I32] * 7 + [_F32] * 4
EXT_ARGTYPES = [_F32, _I32, _F32, _I32, ctypes.POINTER(_F32),
                ctypes.c_double]


@functools.lru_cache(maxsize=None)
def _library(ext: bool = False) -> ctypes.CDLL:
    """csrc/shade_kernel.cu (or with ``ext`` csrc/shade_ext_kernel.cu),
    built on first use, its entry point bound."""
    if ext:
        lib = build.load_library("shade_ext_kernel")
        lib.rt_shade_rays_ext.argtypes = (SHADE_ARGTYPES + EXT_ARGTYPES
                                          + [_PTR] * 8 + [ctypes.c_int64,
                                                          _PTR])
        lib.rt_shade_rays_ext.restype = _I32
        return lib
    lib = build.load_library("shade_kernel")
    lib.rt_shade_rays.argtypes = (SHADE_ARGTYPES + [_PTR] * 6
                                  + [ctypes.c_int64, _PTR])
    lib.rt_shade_rays.restype = _I32
    return lib


@torch.no_grad()
def shade_rays(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
               p: torch.Tensor, sd: torch.Tensor, dirs: torch.Tensor,
               collapse: bool = True, save_winner: bool = False,
               save_factors: bool = False):
    """Shade hit points p [R, 3] of rays ``dirs`` [R, 3] whose march last
    evaluated ``sd`` [R]; ``tables`` is a SceneTables of tensors on the
    rays' device, and the configuration must be one ``ops.render_kernel
    .check_supported`` accepts.  -> ShadeOutputs, or with ``save_winner``
    (analytic normals) or ``save_factors`` (ShadeOutputs, Winner if asked,
    Factors if asked).  CPU tensors take the plain twin; CUDA tensors
    launch K4 (its extended entry when ``extended``).  Forward only."""
    dev = dirs.device
    if dev.type == "cpu":
        return shade_rays_plain(plan, cfg, tables, p, sd, dirs, collapse,
                                save_winner, save_factors)
    if dev.type != "cuda":
        raise ValueError(f"shade_rays: unsupported device {dev}")
    R = dirs.shape[0]
    tensors = [p, sd, dirs, *tables]
    if any(t.device != dev or t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"shade_rays: every tensor must be float32 on {dev}")
    if dirs.shape != (R, 3) or p.shape != (R, 3) or sd.shape != (R,):
        raise ValueError(f"shade_rays: p {tuple(p.shape)}, sd "
                         f"{tuple(sd.shape)}, dirs {tuple(dirs.shape)}")
    check_lights(plan)
    analytic = check_normal_mode(cfg, save_winner)

    ext = extended(plan, cfg)
    lib = _library(ext)
    scene = scene_tables.scene_operands(plan, tables, dev, collapse,
                                        cfg.fused_generators)
    lights, black_t, shade_args = shade_operands(plan, cfg, tables, dev)
    shared = (scene.nbytes(plan.num_lights)
              <= scene_tables.SHARED_SCENE_BYTES)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = torch.cat([p.t(), sd[None], dirs.t()]).contiguous()     # [7, R]
    iout = torch.empty((2, R), dtype=torch.int32, device=dev)
    wres, widx = winner_buffers(R, dev, save_winner)
    head = (*scene.args(), lights.data_ptr(), black_t.data_ptr(),
            int(shared), int(analytic), *shade_args)
    sfac = aofac = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if ext:
            ext_args, light, sfac, aofac = ext_operands(plan, cfg, R, dev)
            code = lib.rt_shade_rays_ext(
                *head, *ext_args, rows.data_ptr(), light.data_ptr(),
                iout.data_ptr(), ptr_or_none(wres), ptr_or_none(widx),
                ptr_or_none(sfac), ptr_or_none(aofac), counter.data_ptr(), R,
                stream)
            light = light_of(light)
        else:
            light = torch.empty((R,), dtype=torch.float32, device=dev)
            code = lib.rt_shade_rays(
                *head, rows.data_ptr(), light.data_ptr(), iout.data_ptr(),
                ptr_or_none(wres), ptr_or_none(widx), counter.data_ptr(), R,
                stream)
    build.check(lib, code, "shade kernel launch")
    if R:    # the C entry points launch nothing for zero rays
        shade_rays.launches += 1
        shade_rays.entry_launches["shade_ext_kernel" if ext
                                  else "shade_kernel"] += 1
    out = ShadeOutputs(cidx=iout[0], light=light, smask=iout[1])
    return with_extras(out, winner_of(wres, widx) if save_winner else None,
                       Factors(sfac, aofac), save_winner, save_factors)


# K4's launches, and by source (the reference and the extended entries)
shade_rays.launches = 0
shade_rays.entry_launches = {"shade_kernel": 0, "shade_ext_kernel": 0}
