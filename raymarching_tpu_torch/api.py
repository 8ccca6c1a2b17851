"""Rendering API of the port.

Backends (the JAX package's names in brackets):
  * ``"cuda"`` [``mega``] — the fused path: every ray through
    ``ops.render_kernel.render_rays``, which launches the K1 kernel on a
    CUDA device (K3, K3 and K4 with ``cfg.two_phase_k1``) and runs the
    plain twins on the CPU; then the colour blend and the SSAA mean.  With
    ``differentiable=True`` the rays go through
    ``ops.render_op.FusedRender`` (that forward; its backward is one K2
    launch over the FD stencils, or with analytic normals no launch at
    all: K1 saved the winner residuals), so gradients reach every
    SceneTables field that requires grad.  ``cfg.ray_chunk > 0`` renders
    the rays in chunks of that many, one after the other.  With
    ``cfg.serve_raygen`` a forward render is the serving path
    (``api._render_mega_serve``): K1's raygen entry per chunk computes the
    directions from the ray index, so there is no camera pass and no
    direction tensor; it has no backward, so ``differentiable=True``
    raises.
  * ``"multi"`` [``pallas``] — the multi-kernel path: ``core.render``'s
    pipeline with the hooks of ``make_render_hooks``: K3 marches the
    primary rays (``ops.march_op.MarchOp``) and, with a per-ray tmax, the
    shadow rays; K2 looks up colours (winner mode) and gives normals
    (``ops.normal_op.NormalOp``: its FD-gradient mode, or with analytic
    normals its gradient-only analytic mode); light and colour arithmetic
    is plain PyTorch under autograd.  Differentiable on every field.
  * ``"ref"`` [``ref``] — the plain PyTorch oracle
    ``core.render.render_image`` (analytic normals by autograd).  With
    ``differentiable=True`` it is the unrolled autodiff oracle: the
    primary march is ``core.march.march_scan`` (autograd through every
    step, checkpointed every ``core.march.REMAT_CHUNK`` steps) and each
    ``cfg.ray_chunk`` chunk is checkpointed; the shadow marches stay the
    early-exit ones (constants under autograd, as JAX stops their
    gradients, and the same bits).  Its image is bitwise the forward one,
    and gradients reach every field.
  * ``"torch"`` [``jnp``] — the same plain pipeline with one hook, the
    plain implicit-function march ``ops.march_op.PlainMarchOp`` (the
    early-exit forward; the backward autograd through ``core.sdf
    .scene_sd`` at the hit points); the shading is plain PyTorch under
    autograd.  Its image is bitwise ``ref``'s.

The shading extensions of the JAX package render on every backend and
train on ``cuda`` (and ``multi``): coloured lights (``LightColor``; the
light term per channel, ``light_color`` differentiable), soft shadows
(``cfg.soft_shadow_k``) and ambient occlusion (``cfg.ao_strength``); the
last two route ``multi`` to ``cuda``, as JAX routes ``pallas`` to
``mega``.

Both normal modes of ``RenderConfig.normal_mode`` ("fd", the default,
and "analytic") render on every backend and train on ``cuda`` and
``multi``, on exact tables and with ``RenderConfig.fused_generators``
(the kernels' fused generator field: Menger sponges by space folding,
DeathStars by their derived carve sphere, gradients to the generators'
own rows); the ``ref`` backend ignores ``fused_generators``, as JAX's
does.  ``render_aovs`` gives the compositing planes of one frame.

Mirror bounces (``cfg.reflect_strength``, ``cfg.reflect_bounces``) render
on every backend and train on ``cuda`` (K1's bounce entries; the backward
replays the bounce chain, ``ops.render_op.reflect_bwd``) and ``multi``
(the recursion of ``core.render.shade_rays`` through the hooks);
thin-lens depth of field (``cfg.aperture``, ``cfg.focus_dist``) renders
each frame as a bundle of per-ray lens origins, through ``render_rays`` on
``cuda`` and the hooks elsewhere.  ``render_rays`` renders any bundle of
rays on the fused path.

Frames past one render: ``render_tiled`` streams a frame through the
device a block of rows at a time into host memory,
``render_tiled_multihost`` gives each rank of a ``torch.distributed``
process group its own band of rows and gathers the frame once,
``render_frames``
renders a batch of camera poses in one stream of rays, and
``turntable_frames`` yields an orbit of the scene (the server's
``/animate`` and the CLI's ``--animate``).

Every entry point takes an explicit device; nothing picks one by itself.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import numpy as np
import torch

from .config import RenderConfig
from .scene.compile import ScenePlan, SceneTables, compile_scene
from .scene.parser import Scene

from .core import camera as cam
from .core.order import frame_blocks, from_blocked, to_blocked
from .core.march import dot3
from .core.render import render_image, shade_chunks
from .core.shading import TINY
from .ops.march_kernel import march_rays
from .ops.march_op import march_op, plain_march_op
from .ops.normal_op import normal_op
from .ops.render_kernel import (check_supported, ray_colors, render_raygen,
                                render_rays as render_kernel_rays)
from .ops.render_op import FusedRender
from .ops.scene_vjp import gather_rows
from .ops.shade_kernel import bounce_count
from .ops.surface_kernel import WINNER, surface_eval
from .tables import tables_to_torch
from .utils.timing import span

BACKENDS = ("cuda", "multi", "ref", "torch")


def resolve_backend(backend: str) -> str:
    """Validate a backend name ("cuda" | "multi" | "ref" | "torch")."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{', '.join(BACKENDS)}")
    return backend


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           "torch.cuda.is_available() is false")
    return device


def make_render_hooks(plan: ScenePlan, tables: SceneTables,
                      cfg: RenderConfig, backend: str) -> dict:
    """The hooks of ``core.render.render_image`` for ``backend``: none for
    ``"ref"``, the plain implicit-function march alone for ``"torch"``
    (JAX's ``jnp`` hooks), the four kernel hooks for ``"multi"``
    (raymarching_tpu.api.make_render_hooks), each on the fused generator
    field when ``cfg.fused_generators`` is set (``MarchOp`` then takes
    the implicit-function route through ``core.sdf.scene_sd_fused``).
    ``tables`` are tensors on the render's device."""
    backend = resolve_backend(backend)
    if backend == "ref":
        return {}
    if backend == "torch":
        return {"march_fn": lambda origin, dirs: plain_march_op(
            plan, cfg, tables, origin, dirs)}
    if backend != "multi":
        raise ValueError(f"backend {backend!r} renders through "
                         "ops.render_kernel, not through hooks")
    # The kernels that run outside an autograd.Function see detached
    # inputs and record nothing: their uses are boolean or piecewise
    # constant (shadow test, colour argmin).
    const = SceneTables(*(t.detach() for t in tables))

    def march_fn(origin, dirs):
        return march_op(plan, cfg, tables, origin, dirs)

    def shadow_fn(origin, dirs, tmax):
        with torch.no_grad():
            return march_rays(plan, cfg, const, origin.detach(),
                              dirs.detach(), tmax=tmax.detach())

    def surface_fn(p):
        with torch.no_grad():
            sd, cidx, _ = surface_eval(plan, const, p.detach(), mode=WINNER,
                                       fused=cfg.fused_generators)
        # the gather stays under autograd: the colour rows' gradient
        return sd, gather_rows(cidx, tables.prim_color)

    def normal_fn(p):
        return normal_op(plan, cfg, tables, p)

    return {"march_fn": march_fn, "shadow_fn": shadow_fn,
            "surface_fn": surface_fn, "normal_fn": normal_fn}


def route_backend(cfg: RenderConfig, backend: str) -> str:
    """``backend`` validated, and ``multi`` with soft shadows or AO routed
    to ``cuda``: the hooks carry no penumbra or occlusion factor, the
    fused kernel tracks them (raymarching_tpu.api.render_tables)."""
    backend = resolve_backend(backend)
    if backend == "multi" and (cfg.soft_shadow_k > 0.0
                               or cfg.ao_strength > 0.0):
        return "cuda"
    return backend


def render_tables(plan: ScenePlan, tables: SceneTables,
                  cfg: Optional[RenderConfig] = None, *,
                  backend: str = "cuda", differentiable: bool = False,
                  device) -> torch.Tensor:
    """Render compiled tables -> [H, W, 3] float32 on ``device``.

    With ``differentiable`` the image carries the autograd graph back to
    the fields of ``tables`` that are tensors requiring grad (see
    ``tables.tables_to_torch``); otherwise nothing is recorded."""
    with span("rt.render"):
        cfg = cfg or RenderConfig()
        backend = route_backend(cfg, backend)
        device = resolve_device(device)
        check_supported(plan, cfg, backend)
        serve = serves_in_kernel(cfg, backend)
        if serve and differentiable:
            raise ValueError(
                "serve_raygen renders forward only (its directions come from "
                "the kernel and have no backward, as in the JAX package): "
                "render with serve_raygen=False to differentiate")
        with torch.set_grad_enabled(differentiable
                                    and torch.is_grad_enabled()):
            tables = tables_to_torch(tables, device)
            return _render_rows(plan, tables, cfg, backend,
                                differentiable=differentiable, serve=serve)


def _render_rows(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                 backend: str, *, differentiable: bool = False,
                 row_range=None, serve: bool = False) -> torch.Tensor:
    """The frame [H, W, 3], or its rows ``row_range=(r0, n)`` [n, W, 3],
    on the device of ``tables`` (tensors), by ``backend`` (routed):
    ``render_tables``' path, and each rank's band in
    ``parallel.sharded.render_sharded``.  A band's rays are bitwise the
    whole frame's rows (``core.camera.generate_rays``), thin-lens rays
    included; ``serve`` (whole frames only) takes K1's raygen entry.
    ``differentiable``: the fused backward on ``cuda``, the unrolled
    oracle on ``ref``; ``multi`` and ``torch`` differentiate through
    their hooks whenever grad is enabled.  The rays go to the kernels in
    block order when ``core.order.resolve_ray_order`` says so (``auto``:
    on ``cuda``), the colours back in scan order: the same bits."""
    H, W, S = cfg.height, cfg.width, cfg.samples_per_pixel
    rows = H if row_range is None else row_range[1]
    oracle = differentiable and backend == "ref"
    hooks = (make_render_hooks(plan, tables, cfg, backend)
             if backend != "cuda" else None)
    blocks = frame_blocks(cfg, rows, backend)

    def ordered(x):
        return x if blocks is None else to_blocked(x, rows, W, S, *blocks)

    if cfg.aperture > 0.0:
        # thin-lens depth of field (api._render_dof): one bundle of per-ray
        # lens origins, the SSAA mean the lens integral; K1 with per-ray
        # origins on cuda, the hooks (whose marches take per-ray origins)
        # elsewhere
        with span("rt.camera"):
            o, d = cam.generate_rays_dof(tables, cfg, row_range)
            o, d = ordered(o.reshape(-1, 3)), ordered(d.reshape(-1, 3))
        diff = (oracle if hooks is not None else torch.is_grad_enabled()
                and any(t.requires_grad for t in (o, d, *tables)))
        colors = _colors(plan, tables, cfg, o, d, hooks, differentiable=diff)
    elif hooks is not None and blocks is None:
        return render_image(plan, tables, cfg, differentiable=oracle,
                            row_range=row_range, **hooks)
    elif serve:
        colors = _render_serve(plan, tables, cfg, blocks)
    else:
        with span("rt.camera"):
            origin, dirs = cam.generate_rays(tables, cfg, row_range)
            dirs = ordered(dirs.reshape(-1, 3))
        colors = _colors(plan, tables, cfg, origin, dirs, hooks,
                         differentiable=(differentiable if hooks is None
                                         else oracle))
    with span("rt.camera"):
        if blocks is not None:
            colors = from_blocked(colors, rows, W, S, *blocks)
        return colors.reshape(rows, W, S, 3).mean(dim=2)


def serves_in_kernel(cfg: RenderConfig, backend: str) -> bool:
    """Whether a render takes the in-kernel raygen serving path: asked for
    (``cfg.serve_raygen``), on the fused backend, and inside its envelope.
    Outside it the JAX package falls back to the standard raygen, and so
    does this: depth of field (``aperture > 0``, per-ray lens origins)
    needs the camera pass.  ``render_tables`` gives no per-ray origins,
    the JAX envelope's other bound.  Mirror bounces serve in the kernel
    too (K1's raygen bounce entry), as JAX's serve_render_chunk does."""
    return cfg.serve_raygen and backend == "cuda" and cfg.aperture == 0.0


def render_rays(plan: ScenePlan, tables: SceneTables, origins, dirs,
                cfg: Optional[RenderConfig] = None, *,
                device) -> torch.Tensor:
    """Colours [R, 3] (linear) of an arbitrary bundle of rays
    (raymarching_tpu.api.render_rays): ``dirs`` [R, 3] unit, ``origins``
    [R, 3] (a ray each) or [3] (shared), tensors or arrays.  The fused
    path (``render_tables``' ``cuda`` backend: K1 on a CUDA device, its
    plain twin on the CPU), ``cfg.ray_chunk`` rays a launch.
    Differentiable in ``tables``, ``origins`` and ``dirs`` through
    ``FusedRender`` when grad is enabled and any of them requires it."""
    cfg = cfg or RenderConfig()
    device = resolve_device(device)
    check_supported(plan, cfg)
    tables = tables_to_torch(tables, device)
    f32 = dict(dtype=torch.float32, device=device)
    origins = torch.as_tensor(origins, **f32)
    dirs = torch.as_tensor(dirs, **f32)
    R = dirs.shape[0]
    if dirs.shape != (R, 3) or origins.shape not in ((3,), (R, 3)):
        raise ValueError(f"render_rays: dirs {tuple(dirs.shape)}, origins "
                         f"{tuple(origins.shape)}")
    diff = torch.is_grad_enabled() and any(
        t.requires_grad for t in (origins, dirs, *tables))
    return (_colors(plan, tables, cfg, origins, dirs, differentiable=diff)
            if R else dirs.new_zeros((0, 3)))


def _render_serve(plan: ScenePlan, tables: SceneTables,
                  cfg: RenderConfig, blocks=None) -> torch.Tensor:
    """Colours [R, 3] of the frame's rays in scan order (generate_rays'
    order), or with ``blocks`` = (bh, bw) in block order, one K1 raygen
    launch per ``cfg.ray_chunk`` rays (api._render_mega_serve)."""
    R = cfg.rays_per_image
    chunk = cfg.ray_chunk if 0 < cfg.ray_chunk < R else R
    colors = []
    order = {} if blocks is None else {"block": blocks}
    for base in range(0, R, chunk):
        res = render_raygen(plan, cfg, tables, base, min(chunk, R - base),
                            **order)
        colors.append(ray_colors(cfg, res, tables.prim_color))
    return torch.cat(colors)


def _fused_colors(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                  origin: torch.Tensor, dirs: torch.Tensor,
                  differentiable: bool) -> torch.Tensor:
    """Colours [R, 3] of rays ``dirs`` [R, 3] through the fused path."""
    if differentiable:
        return FusedRender.apply(plan, cfg, origin, dirs, *tables)
    return ray_colors(cfg, render_kernel_rays(plan, cfg, tables, origin,
                                              dirs), tables.prim_color)


def render_tiled(plan: ScenePlan, tables: SceneTables,
                 cfg: Optional[RenderConfig] = None, *, row_block: int = 128,
                 backend: str = "cuda", row_start: int = 0,
                 num_rows: Optional[int] = None, device) -> np.ndarray:
    """Stream a frame through ``device`` ``row_block`` rows at a time ->
    host float32 [H, W, 3] (raymarching_tpu.api.render_tiled), or the
    band of ``num_rows`` rows from ``row_start`` -> [num_rows, W, 3].

    Only one block's rays and outputs live on the device at once, so a
    frame whose rays would not fit renders; rows land in host memory as
    each block finishes.  A block's rays are the whole frame's rows
    bitwise (``core.camera.generate_rays``' ``row_range``), thin-lens
    rays included, and each goes the way ``render_tables`` sends the
    frame's: K1 (``cuda``, ``cfg.ray_chunk`` rays a launch; per-ray lens
    origins with an aperture) or the hooks (``multi``, ``ref``,
    ``torch``); ``multi`` with soft shadows or AO goes to ``cuda``.  A
    block's rays take block order over the block's own rows
    (``core.order``, as ``render_tables``' frame does); there is no
    in-kernel raygen here: ``cfg.serve_raygen`` is not read.  Forward
    only."""
    cfg = cfg or RenderConfig()
    backend = route_backend(cfg, backend)
    device = resolve_device(device)
    check_supported(plan, cfg, backend)
    span = cfg.height if num_rows is None else num_rows
    if not (0 <= row_start and row_start + span <= cfg.height):
        raise ValueError(f"row band [{row_start}, {row_start + span}) "
                         f"outside frame height {cfg.height}")
    if row_block < 1:
        raise ValueError(f"row_block must be >= 1, got {row_block}")
    out = np.empty((span, cfg.width, 3), np.float32)
    with torch.no_grad():
        tables = tables_to_torch(tables, device)
        for r in range(row_start, row_start + span, row_block):
            n = min(row_block, row_start + span - r)
            out[r - row_start:r - row_start + n] = _render_rows(
                plan, tables, cfg, backend, row_range=(r, n)).cpu().numpy()
    return out


def render_tiled_multihost(plan: ScenePlan, tables: SceneTables,
                           cfg: Optional[RenderConfig] = None, *,
                           row_block: int = 128, backend: str = "cuda",
                           device) -> np.ndarray:
    """Each rank of the default ``torch.distributed`` process group
    streams its own contiguous band of rows through ``render_tiled``, then
    one all-gather gives every rank the frame -> host float32 [H, W, 3]
    (raymarching_tpu.api.render_tiled_multihost).  Rank p of P takes
    H // P rows, one more while p < H % P.  Under NCCL the bands are
    gathered on ``device``, under gloo on the host
    (``parallel.distributed.gather_rows``).  With no process group, or
    one rank, it is ``render_tiled``."""
    import torch.distributed as dist

    from .parallel.distributed import gather_rows
    cfg = cfg or RenderConfig()
    P = dist.get_world_size() if dist.is_initialized() else 1
    if P == 1:
        return render_tiled(plan, tables, cfg, row_block=row_block,
                            backend=backend, device=device)
    p = dist.get_rank()
    base, rem = divmod(cfg.height, P)
    n = base + (1 if p < rem else 0)
    mine = render_tiled(plan, tables, cfg, row_block=row_block,
                        backend=backend, row_start=p * base + min(p, rem),
                        num_rows=n, device=device)
    # the short bands padded by one row for the gather, trimmed after it
    band = torch.zeros((base + (1 if rem else 0), cfg.width, 3),
                       dtype=torch.float32, device=resolve_device(device))
    band[:n] = torch.from_numpy(mine)
    stacked = gather_rows(band[None]).cpu().numpy()
    return np.concatenate([stacked[q, :base + (1 if q < rem else 0)]
                           for q in range(P)], axis=0)


def _colors(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
            origin: torch.Tensor, dirs: torch.Tensor,
            hooks: Optional[dict] = None, *,
            differentiable: bool = False) -> torch.Tensor:
    """Colours [R, 3] of rays ``dirs`` [R, 3] (R > 0) from ``origin``
    [3] or [R, 3], ``cfg.ray_chunk`` rays at a time: the fused path
    (``FusedRender`` with ``differentiable``) when ``hooks`` is None, else
    ``core.render.shade_chunks`` with them (with ``differentiable`` the
    unrolled oracle)."""
    if hooks is not None:
        return shade_chunks(plan, tables, cfg, origin, dirs,
                            differentiable=differentiable, **hooks)
    R = dirs.shape[0]
    chunk = cfg.ray_chunk if 0 < cfg.ray_chunk < R else R
    return torch.cat([_fused_colors(
        plan, cfg, tables, origin if origin.dim() == 1 else
        origin[i:i + chunk], dirs[i:i + chunk], differentiable)
        for i in range(0, R, chunk)])


def render_frames(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                  positions, directions, *, device) -> torch.Tensor:
    """F camera poses -> [F, H, W, 3] on ``device``
    (raymarching_tpu.api.render_frames): every frame's rays in one stream
    through ``render_rays`` (K1 with an origin a ray, ``cfg.ray_chunk``
    rays a launch), so a batch of poses costs one launch, not F.
    ``positions`` and ``directions`` are [F, 3]; the other camera fields
    (up, fov) come from ``tables``.  Frame i is ``render_tables`` at pose
    i, bitwise (pinhole rays: ``generate_rays``)."""
    device = resolve_device(device)
    tables = tables_to_torch(tables, device)
    f32 = dict(dtype=torch.float32, device=device)
    positions = torch.as_tensor(positions, **f32)
    directions = torch.as_tensor(directions, **f32)
    F = positions.shape[0]
    if positions.shape != (F, 3) or directions.shape != (F, 3):
        raise ValueError(f"render_frames: positions {tuple(positions.shape)}"
                         f", directions {tuple(directions.shape)}")
    H, W, S = cfg.height, cfg.width, cfg.samples_per_pixel
    R = H * W * S
    origins, dirs = [], []
    for i in range(F):
        o, d = cam.generate_rays(tables._replace(
            cam_position=positions[i], cam_direction=directions[i]), cfg)
        origins.append(o.expand(R, 3))
        dirs.append(d.reshape(R, 3))
    colors = render_rays(plan, tables, torch.cat(origins), torch.cat(dirs),
                         cfg, device=device)
    return colors.reshape(F, H, W, S, 3).mean(dim=3)


def _host(x) -> np.ndarray:
    """A tables field as a host float32 array (tensor or array)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def turntable_poses(tables: SceneTables, frames: int, *,
                    orbit: Optional[float] = None, center=None) -> list:
    """The (position, direction) float32 [3] pairs of a turntable orbit
    (raymarching_tpu.api.turntable_frames' pose math, line by line): the
    camera circles in the xz plane about ``center`` (default the mean
    primitive position) at its starting radius and height, looking at
    the centre; ``orbit`` is the swept angle in radians (default a full
    turn).  A full loop leaves out its endpoint (frame N would be frame
    0); a partial sweep ends exactly at ``orbit``."""
    if orbit is None:
        orbit = 2.0 * math.pi
    prim_pos = _host(tables.prim_pos)
    if center is not None:
        center = np.asarray(center, np.float32)
    else:
        center = (prim_pos.mean(0) if prim_pos.shape[0]
                  else np.zeros(3, np.float32))
    p0 = _host(tables.cam_position) - center
    radius = float(np.hypot(p0[0], p0[2]))
    phi0 = math.atan2(float(p0[2]), float(p0[0]))
    two_pi = 2.0 * math.pi
    denom = (max(frames, 1) if abs(orbit) >= two_pi - 1e-9
             else max(frames - 1, 1))

    def pose(i):
        phi = phi0 + orbit * i / denom
        pos = center + np.array([radius * math.cos(phi), float(p0[1]),
                                 radius * math.sin(phi)], np.float32)
        look = center - pos
        nrm = float(np.linalg.norm(look))
        return pos, ((look / nrm) if nrm > 1e-6
                     else _host(tables.cam_direction))

    return [pose(i) for i in range(frames)]


def turntable_frames(plan: ScenePlan, tables: SceneTables,
                     cfg: RenderConfig, frames: int, *,
                     orbit: Optional[float] = None, center=None,
                     backend: str = "cuda", batch: int = 8,
                     device) -> Iterator[np.ndarray]:
    """Yield ``frames`` host float32 [H, W, 3] frames of a turntable orbit
    (raymarching_tpu.api.turntable_frames; the poses of
    ``turntable_poses``): behind the server's ``/animate`` and the CLI's
    ``--animate``.  On ``cuda``, ``batch`` poses at a time through
    ``render_frames`` (one stream of rays, K1); on ``multi`` and ``ref``
    one ``render_tables`` a frame."""
    backend = resolve_backend(backend)
    device = resolve_device(device)
    poses = turntable_poses(tables, frames, orbit=orbit, center=center)
    with torch.no_grad():
        tables = tables_to_torch(tables, device)
        if backend == "cuda":
            for b0 in range(0, frames, batch):
                ps, ds = zip(*poses[b0:b0 + batch])
                imgs = render_frames(plan, tables, cfg, np.stack(ps),
                                     np.stack(ds), device=device)
                yield from imgs.cpu().numpy()
        else:
            f32 = dict(dtype=torch.float32, device=device)
            for pos, d in poses:
                yield render_tables(plan, tables._replace(
                    cam_position=torch.as_tensor(pos, **f32),
                    cam_direction=torch.as_tensor(d, **f32)), cfg,
                    backend=backend, device=device).cpu().numpy()


def render(scene: Scene, cfg: Optional[RenderConfig] = None, *,
           backend: str = "cuda", differentiable: bool = False,
           device) -> torch.Tensor:
    """Parsed Scene -> [H, W, 3] image on ``device``."""
    plan, tables = compile_scene(scene)
    return render_tables(plan, tables, cfg, backend=backend,
                         differentiable=differentiable, device=device)


def render_ref(scene: Scene, cfg: Optional[RenderConfig] = None, *,
               device) -> torch.Tensor:
    """The plain PyTorch oracle render of a parsed Scene."""
    return render(scene, cfg, backend="ref", device=device)


def render_aovs(plan: ScenePlan, tables: SceneTables,
                cfg: Optional[RenderConfig] = None, *, device) -> dict:
    """The arbitrary output variables of one frame (raymarching_tpu.api
    .render_aovs), each a tensor on ``device``:

      color  [H, W, 3]  the beauty image (render_tables' fused backend)
      depth  [H, W]     mean ray distance t over converged SSAA samples,
                        +inf where none converged
      normal [H, W, 3]  SSAA mean of the unit normals, renormalised; zero
                        on a miss
      objid  [H, W]     int32 colour winner of the pixel's first sample
                        (-1: miss)
      hit    [H, W]     share of converged samples
      shadow [H, W, L]  per light, the shadowed share of converged samples

    One K1 launch with both shadow skips off (a skipped lane reads as
    shadowed, which would mark false shadow bands) and one K2 launch for
    the normal (``NormalOp``'s forward, the configuration's normal and
    field).  Not differentiable.  ``utils.gatecheck`` classifies a gate's
    offenders against these planes."""
    cfg = cfg or RenderConfig()
    device = resolve_device(device)
    check_supported(plan, cfg)
    H, W, S = cfg.height, cfg.width, cfg.samples_per_pixel
    with torch.no_grad():
        tables = tables_to_torch(tables, device)
        origin, dirs = cam.generate_rays(tables, cfg)
        flat = dirs.reshape(-1, 3)
        res = render_kernel_rays(plan, cfg.replace(shadow_sat_skip=False,
                                                   shade_skip_black=False),
                                 tables, origin, flat)
        out = res if bounce_count(cfg) == 0 else res[0]
        colors = ray_colors(cfg, res, tables.prim_color)
        conv = out.done
        g = normal_op(plan, cfg, tables, out.p)
        n = g / torch.sqrt(torch.clamp_min(dot3(g, g), TINY))[:, None]
        n = torch.where(conv[:, None], n, torch.zeros((), device=device))
        t = dot3(out.p - origin, flat) / dot3(flat, flat)
        conv_s = conv.reshape(H, W, S)
        n_conv = conv_s.sum(dim=2)
        hit = conv_s.float().mean(dim=2)
        t_s = torch.where(conv_s, t.reshape(H, W, S),
                          torch.zeros((), device=device))
        depth = torch.where(hit > 0.0,
                            t_s.sum(dim=2) / torch.clamp_min(n_conv, 1),
                            torch.full((), float("inf"), device=device))
        nm = torch.where(conv_s[..., None], n.reshape(H, W, S, 3),
                         torch.zeros((), device=device)).sum(dim=2)
        nsq = (nm * nm).sum(dim=-1, keepdim=True)
        normal = torch.where(hit[..., None] > 0.0,
                             nm / torch.sqrt(torch.clamp_min(nsq, TINY)),
                             torch.zeros((), device=device))
        objid = out.cidx.reshape(H, W, S)[..., 0].to(torch.int32)
        L = max(tables.light_pos.shape[0], 1)
        bits = (out.smask[:, None] >> torch.arange(
            L, dtype=torch.int32, device=device)) & 1
        bits_s = torch.where(conv_s[..., None], bits.reshape(H, W, S, L).float(),
                             torch.zeros((), device=device))
        shadow = bits_s.sum(dim=2) / torch.clamp_min(n_conv, 1)[..., None]
        return {"color": colors.reshape(H, W, S, 3).mean(dim=2),
                "depth": depth, "normal": normal, "objid": objid,
                "hit": hit, "shadow": shadow}
