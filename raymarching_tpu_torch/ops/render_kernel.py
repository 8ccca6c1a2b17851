"""K1, the fused forward render: wrapper, plain twin and colour blend.

Counterpart of ``raymarching_tpu.ops.pallas_render.pallas_render_rays``
and of ``_blend_bounces``.  The kernel is
``csrc/render_kernel.cu``; ``render_rays_plain`` computes the same thing
in plain PyTorch from the ``core`` modules and is what a CPU tensor gets.
A CUDA tensor always goes to the kernel: a build or launch failure raises.

The shading extensions (coloured lights, soft shadows, ambient occlusion;
``shade_kernel.extended``) launch the kernel's extended entries
(``csrc/render_ext_kernel.cu``): the light term is [R, 3] with coloured
lights, and ``save_factors`` returns the penumbra and occlusion factors
(``shade_kernel.Factors``) beside the outputs.  ``render_raygen`` is the
serving path (``pallas_render.serve_render_chunk``): K1's raygen entries
(``csrc/render_raygen_kernel.cu``) compute the primary directions of a
chunk of the frame from the ray index; its twin is
``core.camera.raygen_dirs`` and this module's plain twin.  Mirror bounces
(``cfg.reflect_strength > 0``) launch K1's bounce entries
(``csrc/render_bounce_kernel.cu``, both ray sources): every bounce's shade
set and hit come out as BounceOutputs, ``blend`` mixes the sets, and
``ops.render_op`` replays the chain for the backward.

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
from typing import NamedTuple, Optional

import torch

from ..config import RenderConfig
from ..core import camera as cam
from ..core.march import MarchResult, dot3, march
from ..core.sdf import kernel_fold
from ..scene.compile import ScenePlan, SceneTables
from .. import tables as scene_tables
from ..tables import fused_groups
from ..utils.timing import span
from . import build
from .march_kernel import march_rays
from .scene_vjp import gather_rows
from .shade_kernel import (EXT_ARGTYPES, ShadeOutputs, SHADE_ARGTYPES, Factors,
                           bounce_count, check_lights, check_normal_mode,
                           ext_operands,
                           extended, light_of, ptr_or_none, shade_operands,
                           shade_plain, shade_rays, shade_rays_plain,
                           winner_buffers, winner_of, with_extras)

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
    light: torch.Tensor  # [R] clamped Lambert term; [R, 3] coloured lights
    smask: torch.Tensor  # [R] int32, bit l set = light l shadowed


class BounceOutputs(NamedTuple):
    """One mirror bounce's outputs for R rays (pallas_render_rays' ninth
    element, one entry a bounce): its shade set, blended by ``blend``, and
    its hit, the anchor of the backward's replay (``ops.render_op``)."""

    cidx: torch.Tensor   # [R] int32 colour winner leaf, -1 = none
    light: torch.Tensor  # [R] clamped Lambert term; [R, 3] coloured lights
    smask: torch.Tensor  # [R] int32 shadow bits
    sfac: Optional[torch.Tensor]   # [L, R] penumbra factors, or None
    aofac: Optional[torch.Tensor]  # [R] occlusion factor, or None
    p: torch.Tensor      # [R, 3] the bounce march's hit point
    sd: torch.Tensor     # [R] SD at its pre-step point
    done: torch.Tensor   # [R] bool: converged (done and sd < eps)


def check_supported(plan: ScenePlan, cfg: RenderConfig,
                    backend: str = "cuda") -> None:
    """Raise NotImplementedError for anything outside the ported slice, and
    ValueError for more lights than the fused path (``backend`` "cuda")
    holds.  A plan with no two-level form (depth > 2) renders in every
    regime: the kernels' deep view, which evaluates its exact field with
    fused generators too, as the JAX kernels' generic evaluator does."""
    if backend == "cuda":
        check_lights(plan)
    check_normal_mode(cfg, False)
    if cfg.fused_generators and plan.kernel is not None:
        fused_groups(plan.kernel)       # the generator form the kernels take


def render_rays_plain(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                      origin: torch.Tensor, dirs: torch.Tensor,
                      collapse: bool = True, save_winner: bool = False,
                      save_factors: bool = False):
    """K1 in plain PyTorch, the same arithmetic in the same order: the
    march over the kernel-form fold, then K4's plain twin on its hit
    points (one march whatever ``cfg.two_phase_k1`` says: this is the
    twin of the one kernel).  origin [3] or [R, 3], dirs [R, 3] ->
    RayOutputs, or with ``save_winner`` or ``save_factors`` (RayOutputs,
    Winner if asked, Factors if asked).

    With mirror bounces (``shade_kernel.bounce_count``) the twin of K1's
    bounce entries: after the primary shade, per bounce, d - (2 (d . n)) n
    off the shade's unit normal, the origin p + n (surface_eps +
    offset_eps), march and shade again (pallas_render._render_kernel
    :284-309, black-lane skip off); a tuple of BounceOutputs, one a
    bounce, comes last."""
    check_supported(plan, cfg)
    check_normal_mode(cfg, save_winner)
    B = _check_bounces(cfg, save_winner)
    with torch.no_grad():
        sd_fn = lambda q: kernel_fold(  # noqa: E731
            plan, tables, q, collapse=collapse,
            fused=cfg.fused_generators)[0]
        hit = march(sd_fn, origin, dirs, cfg.iterations,
                    cfg.surface_precision)
        if not B:
            return _ray_outputs(hit, shade_rays_plain(
                plan, cfg, tables, hit.position, hit.sd, dirs, collapse,
                save_winner, save_factors))
        sh, _, factors, n = shade_plain(plan, cfg, tables, hit.position,
                                        hit.sd, dirs, collapse)
        bounces = []
        off = cfg.surface_precision + cfg.offset_precision
        p, d = hit.position, dirs
        for _ in range(B):
            t = 2.0 * dot3(d, n)
            d = d - t[:, None] * n
            hb = march(sd_fn, p + n * off, d, cfg.iterations,
                       cfg.surface_precision)
            shb, _, fb, n = shade_plain(plan, cfg, tables, hb.position,
                                        hb.sd, d, collapse)
            bounces.append(BounceOutputs(*shb, *fb, *hb))
            p = hb.position
    ray = RayOutputs(hit.position, hit.sd, hit.converged, *sh)
    return (ray, *((factors,) if save_factors else ()), tuple(bounces))


def _check_bounces(cfg: RenderConfig, save_winner: bool) -> int:
    """The bounce count; raises for winner residuals with bounces (the
    replay backward owns bounce chains, as pallas_render_rays asserts)."""
    B = bounce_count(cfg)
    if B and save_winner:
        raise ValueError("winner residuals are reflection-free: no "
                         "save_winner with mirror bounces")
    return B


def _ray_outputs(hit: MarchResult, shaded):
    """RayOutputs of a march and its shading, with the shading's extras
    (winner residuals, factors) beside them when it returned any."""
    if isinstance(shaded, ShadeOutputs):
        return RayOutputs(hit.position, hit.sd, hit.converged, *shaded)
    sh, *extras = shaded
    return (RayOutputs(hit.position, hit.sd, hit.converged, *sh), *extras)


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
def _library(name: str = "render_kernel") -> ctypes.CDLL:
    """One of K1's sources (render_kernel, render_ext_kernel,
    render_raygen_kernel, render_bounce_kernel), built on first use, its
    entry point bound."""
    lib = build.load_library(name)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    rays = [ptr, f32, f32, f32, ptr]            # org, ox, oy, oz, dirs
    tail = [ctypes.c_int64, ptr]                # R, stream
    if name == "render_kernel":
        fn = lib.rt_render_rays
        fn.argtypes = SHADE_ARGTYPES + rays + [ptr] * 5 + tail
    elif name == "render_ext_kernel":
        fn = lib.rt_render_rays_ext
        fn.argtypes = SHADE_ARGTYPES + EXT_ARGTYPES + rays + [ptr] * 8 + tail
    elif name == "render_bounce_kernel":
        fn = lib.rt_render_bounce
        fn.argtypes = (SHADE_ARGTYPES + EXT_ARGTYPES + [i32] * 7 + [f32] * 3
                       + [ptr, ctypes.c_int64] + rays + [ptr] * 6 + tail)
    else:
        fn = lib.rt_render_raygen
        fn.argtypes = (SHADE_ARGTYPES + [i32] + EXT_ARGTYPES + [i32] * 5
                       + [f32] * 3 + [ptr, ctypes.c_int64] + [ptr] * 8
                       + tail)
    fn.restype = i32
    return lib


def _launch_head(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                 dev, collapse: bool, analytic: bool) -> tuple:
    """The C entry points' arguments from ``tbl`` to ``fd_h`` and the
    tensors they point into (kept alive across the launch)."""
    scene = scene_tables.scene_operands(plan, tables, dev, collapse,
                                        cfg.fused_generators)
    lights, black_t, shade_args = shade_operands(plan, cfg, tables, dev)
    shared = (scene.nbytes(plan.num_lights)
              <= scene_tables.SHARED_SCENE_BYTES)
    head = (*scene.args(), lights.data_ptr(), black_t.data_ptr(),
            int(shared), int(analytic), *shade_args)
    return head, (scene, lights, black_t)


@torch.no_grad()
def render_rays(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                origin: torch.Tensor, dirs: torch.Tensor,
                collapse: bool = True, save_winner: bool = False,
                save_factors: bool = False):
    """Fused forward for rays ``dirs`` [R, 3] from ``origin`` [3] or
    [R, 3]; ``tables`` is a SceneTables of tensors on the rays' device.
    -> RayOutputs, or with ``save_winner`` (analytic normals) or
    ``save_factors`` (RayOutputs, Winner if asked, Factors if asked).
    With mirror bounces (``shade_kernel.bounce_count``) a tuple of
    BounceOutputs, one a bounce, comes last, and winner residuals are
    refused.  CPU tensors take the plain twin; CUDA tensors launch K1 (its
    extended entry when ``shade_kernel.extended``, its bounce entry with
    bounces), or with ``cfg.two_phase_k1`` set (and no bounces) K3, K3 and
    K4 (their plain twins on the CPU).  Forward only: it
    records no autograd graph (``ops.render_op.FusedRender``
    differentiates it).  ``collapse``: the scene fold may take the exact
    Menger lattice collapse (the same bits as the leaf fold, which
    ``collapse=False`` keeps)."""
    with span("rt.k1"):
        dev = dirs.device
        check_supported(plan, cfg)
        analytic = check_normal_mode(cfg, save_winner)
        B = _check_bounces(cfg, save_winner)
        if 0 < cfg.two_phase_k1 < cfg.iterations and not B:
            hit = two_phase_march(plan, cfg, tables, origin, dirs, collapse)
            return _ray_outputs(hit, shade_rays(
                plan, cfg, tables, hit.position, hit.sd, dirs, collapse,
                save_winner, save_factors))
        if dev.type == "cpu":
            return render_rays_plain(plan, cfg, tables, origin, dirs, collapse,
                                     save_winner, save_factors)
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

        dirs_soa = dirs.t().contiguous()
        if origin.dim() == 2:
            org_soa, o3 = origin.t().contiguous(), (0.0, 0.0, 0.0)
        else:
            org_soa, o3 = None, tuple(float(v) for v in origin.tolist())
        rays = (ptr_or_none(org_soa), *o3, dirs_soa.data_ptr())
        if B:
            res = _bounce_launch(plan, cfg, tables, dev, R, collapse, analytic,
                                 B, (0,) * 6 + (0.0,) * 3 + (None, 0), rays)
            if R:    # the C entry point launches nothing for zero rays
                render_rays.launches += 1
                render_rays.entry_launches["render_bounce_kernel"] += 1
            return _bounce_outputs(res, save_factors)
        ext = extended(plan, cfg)
        name = "render_ext_kernel" if ext else "render_kernel"
        lib = _library(name)
        head, _keep = _launch_head(plan, cfg, tables, dev, collapse, analytic)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        out = torch.empty((6, R), dtype=torch.float32, device=dev)
        iout = torch.empty((2, R), dtype=torch.int32, device=dev)
        wres, widx = winner_buffers(R, dev, save_winner)
        outs = (out.data_ptr(), iout.data_ptr(), ptr_or_none(wres),
                ptr_or_none(widx))
        sfac = aofac = None
        light = out[5]

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if ext:
                ext_args, light, sfac, aofac = ext_operands(plan, cfg, R, dev)
                code = lib.rt_render_rays_ext(
                    *head, *ext_args, *rays, *outs, light.data_ptr(),
                    ptr_or_none(sfac), ptr_or_none(aofac), counter.data_ptr(),
                    R, stream)
                light = light_of(light)
            else:
                code = lib.rt_render_rays(*head, *rays, *outs,
                                          counter.data_ptr(), R, stream)
        build.check(lib, code, "render kernel launch")
        if R:    # the C entry points launch nothing for zero rays
            render_rays.launches += 1
            render_rays.entry_launches[name] += 1
        return _outputs(cfg, out, iout, light, wres, widx,
                        Factors(sfac, aofac), save_winner, save_factors)


# K1's launches, and by source (the reference, the extended and the bounce
# entries); the raygen entries count in render_raygen's
render_rays.launches = 0
render_rays.entry_launches = {"render_kernel": 0, "render_ext_kernel": 0,
                              "render_bounce_kernel": 0}


def _bounce_launch(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                   dev, R: int, collapse: bool, analytic: bool, B: int,
                   camera: tuple, rays: tuple) -> list:
    """Launch K1's bounce entry (csrc/render_bounce_kernel.cu) over R rays
    with B bounces: ``camera`` is rt_render_bounce's arguments from
    ``raygen`` to ``base`` (raygen 0: the rays are ``rays``, org to dirs).
    -> one (RayOutputs, Factors) for the primary hit and one for each
    bounce, views of the launch's buffers."""
    lib = _library("render_bounce_kernel")
    head, _keep = _launch_head(plan, cfg, tables, dev, collapse, analytic)
    sets = 1 + B
    ext_args, light, sfac, aofac = ext_operands(plan, cfg, R, dev, sets)
    C, L = light.shape[0] // sets, plan.num_lights
    out = torch.empty((5 * sets, R), dtype=torch.float32, device=dev)
    iout = torch.empty((2 * sets, R), dtype=torch.int32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rt_render_bounce(
            *head, *ext_args, B, *camera, *rays, out.data_ptr(),
            iout.data_ptr(), light.data_ptr(), ptr_or_none(sfac),
            ptr_or_none(aofac), counter.data_ptr(), R, stream)
    build.check(lib, code, "render kernel bounce launch")
    res = []
    for b in range(sets):
        o, sd = out[5 * b:5 * b + 5], out[5 * b + 3]
        res.append((RayOutputs(
            p=o[:3].t(), sd=sd, done=(o[4] > 0.5) & (sd < cfg.surface_precision),
            cidx=iout[2 * b], light=light_of(light[C * b:C * (b + 1)]),
            smask=iout[2 * b + 1]), Factors(
                None if sfac is None else sfac[L * b:L * (b + 1)],
                None if aofac is None else aofac[R * b:R * (b + 1)])))
    return res


def _bounce_outputs(res: list, save_factors: bool) -> tuple:
    """``_bounce_launch``'s sets as render_rays returns them: RayOutputs,
    Factors if asked, then a BounceOutputs a bounce."""
    (ray, factors), rest = res[0], res[1:]
    bounces = tuple(BounceOutputs(o.cidx, o.light, o.smask, *f, o.p, o.sd,
                                  o.done) for o, f in rest)
    return (ray, *((factors,) if save_factors else ()), bounces)


def _outputs(cfg, out, iout, light, wres, widx, factors, save_winner,
             save_factors):
    """K1's outputs from its launch buffers, with the extras asked for."""
    sd = out[3]
    ray = RayOutputs(p=out[:3].t(), sd=sd,
                     done=(out[4] > 0.5) & (sd < cfg.surface_precision),
                     cidx=iout[0], light=light, smask=iout[1])
    return with_extras(ray, winner_of(wres, widx) if save_winner else None,
                       factors, save_winner, save_factors)


def render_raygen_plain(plan: ScenePlan, cfg: RenderConfig,
                        tables: SceneTables, base: int, n: int,
                        collapse: bool = True, save_winner: bool = False,
                        save_factors: bool = False, block: tuple = (0, 0)):
    """K1's raygen entry in plain PyTorch: the directions of rays base ..
    base + n - 1 of the frame (in block order with ``block``) by
    ``core.camera.raygen_dirs``, then K1's plain twin on them from the
    camera position."""
    dirs = cam.raygen_dirs(cam.serve_cam_rows(tables, cfg), cfg, base, n,
                           block)
    return render_rays_plain(plan, cfg, tables, tables.cam_position, dirs,
                             collapse, save_winner, save_factors)


@torch.no_grad()
def render_raygen(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                  base: int, n: int, collapse: bool = True,
                  save_winner: bool = False, save_factors: bool = False,
                  block: tuple = (0, 0)):
    """K1 on rays base .. base + n - 1 of the frame (scan order, the
    order of ``core.camera.generate_rays``, or with ``block`` = (bh, bw)
    block order, ``core.order.to_blocked``'s), their directions computed
    in the kernel from the ray index (``pallas_render.serve_render_chunk``;
    the serving path of ``api.render_tables``): no direction tensor and
    no camera pass.  Returns what ``render_rays`` returns.  CPU tensors
    take ``render_raygen_plain``; CUDA tensors launch K1's raygen entry
    (with the shading extensions when ``shade_kernel.extended``; with
    bounces the raygen form of the bounce entry), always one kernel
    (``cfg.two_phase_k1`` is not taken, as in the JAX path).  Forward
    only."""
    with span("rt.k1"):
        dev = tables.cam_position.device
        check_supported(plan, cfg)
        analytic = check_normal_mode(cfg, save_winner)
        B = _check_bounces(cfg, save_winner)
        bh, bw = block
        if (bh, bw) != (0, 0) and not (bh > 0 and bw > 0
                                       and cfg.height % bh == 0
                                       and cfg.width % bw == 0):
            raise ValueError(f"render_raygen: block {block} does not tile a "
                             f"{cfg.width}x{cfg.height} frame")
        if dev.type == "cpu":
            return render_raygen_plain(plan, cfg, tables, base, n, collapse,
                                       save_winner, save_factors, block)
        if dev.type != "cuda":
            raise ValueError(f"render_raygen: unsupported device {dev}")
        if any(t.device != dev or t.dtype != torch.float32 for t in tables):
            raise ValueError("render_raygen: every tensor must be float32 on "
                             f"{dev}")
        if base < 0 or n < 0:
            raise ValueError(f"render_raygen: rays {base} + {n}")
        # the kernel reads the camera rows on the device: no host copy, no wait
        rows = cam.serve_cam_rows(tables, cfg).contiguous()
        recip = [1.0 / cfg.ssaa, 1.0 / cfg.width, 1.0 / cfg.height]
        if B:
            res = _bounce_launch(
                plan, cfg, tables, dev, n, collapse, analytic, B,
                (1, cfg.width, cfg.height, cfg.ssaa, bh, bw, *recip,
                 rows.data_ptr(), base), (None, 0.0, 0.0, 0.0, None))
            if n:    # the C entry point launches nothing for zero rays
                render_raygen.launches += 1
                render_raygen.entry_launches["render_bounce_kernel"] += 1
            return _bounce_outputs(res, save_factors)
        ext = extended(plan, cfg)
        lib = _library("render_raygen_kernel")
        head, _keep = _launch_head(plan, cfg, tables, dev, collapse, analytic)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        out = torch.empty((6, n), dtype=torch.float32, device=dev)
        iout = torch.empty((2, n), dtype=torch.int32, device=dev)
        wres, widx = winner_buffers(n, dev, save_winner)
        if ext:
            ext_args, light, sfac, aofac = ext_operands(plan, cfg, n, dev)
        else:
            ext_args = (0.0, 0, 0.0, 0, (ctypes.c_float * 1)(), 0.0)
            light, sfac, aofac = out[5:6], None, None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.rt_render_raygen(
                *head, int(ext), *ext_args, cfg.width, cfg.height, cfg.ssaa,
                bh, bw, *recip, rows.data_ptr(), base, out.data_ptr(),
                iout.data_ptr(),
                ptr_or_none(wres), ptr_or_none(widx),
                light.data_ptr() if ext else None, ptr_or_none(sfac),
                ptr_or_none(aofac), counter.data_ptr(), n, stream)
        build.check(lib, code, "render kernel raygen launch")
        if n:    # the C entry point launches nothing for zero rays
            render_raygen.launches += 1
            render_raygen.entry_launches["render_raygen_kernel"] += 1
        return _outputs(cfg, out, iout, light_of(light), wres, widx,
                        Factors(sfac, aofac), save_winner, save_factors)


# the raygen entries' launches, and by source (render_raygen_kernel, and
# the raygen form of the bounce entries in render_bounce_kernel)
render_raygen.launches = 0
render_raygen.entry_launches = {"render_raygen_kernel": 0,
                                "render_bounce_kernel": 0}


def blend(cidx: torch.Tensor, light: torch.Tensor, prim_color: torch.Tensor,
          bounces: tuple = (), strength: float = 0.0) -> torch.Tensor:
    """Ray colours [R, 3] = light * winner colour, misses black; ``light``
    [R] (white lights) or [R, 3] (coloured).  With mirror bounces
    (BounceOutputs, one a bounce; pallas_render._blend_bounces) the
    tinted-mirror blend with strength s:

        c_k = colour_k ((1 - s) light_k + s c_(k+1)),   the last c plain."""
    def lit(v):
        return v[:, None] if v.dim() == 1 else v

    def col(ci):
        return gather_rows(ci, prim_color)

    if not bounces:
        return lit(light) * col(cidx)
    s = strength
    c = lit(bounces[-1].light) * col(bounces[-1].cidx)
    for b in reversed(bounces[:-1]):
        c = col(b.cidx) * ((1.0 - s) * lit(b.light) + s * c)
    return col(cidx) * ((1.0 - s) * lit(light) + s * c)


def ray_colors(cfg: RenderConfig, res, prim_color: torch.Tensor
               ) -> torch.Tensor:
    """Colours [R, 3] of what ``render_rays`` or ``render_raygen`` returned
    for ``cfg`` (its bounces blended in, if any)."""
    out, *extras = (res,) if isinstance(res, RayOutputs) else res
    bounces = extras[-1] if bounce_count(cfg) else ()
    return blend(out.cidx, out.light, prim_color, bounces,
                 cfg.reflect_strength)
