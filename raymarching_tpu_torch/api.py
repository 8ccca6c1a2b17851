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
    the rays in chunks of that many, one after the other.
  * ``"multi"`` [``pallas``] — the multi-kernel path: ``core.render``'s
    pipeline with the hooks of ``make_render_hooks``: K3 marches the
    primary rays (``ops.march_op.MarchOp``) and, with a per-ray tmax, the
    shadow rays; K2 looks up colours (winner mode) and gives normals
    (``ops.normal_op.NormalOp``: its FD-gradient mode, or with analytic
    normals its gradient-only analytic mode); light and colour arithmetic
    is plain PyTorch under autograd.  Differentiable on every field.
  * ``"ref"`` [``ref``] — the plain PyTorch oracle
    ``core.render.render_image`` (analytic normals by autograd), forward
    only.

Both normal modes of ``RenderConfig.normal_mode`` ("fd", the default,
and "analytic") render on every backend and train on ``cuda`` and
``multi``, on exact tables and with ``RenderConfig.fused_generators``
(the kernels' fused generator field: Menger sponges by space folding,
DeathStars by their derived carve sphere, gradients to the generators'
own rows); the ``ref`` backend ignores ``fused_generators``, as JAX's
does.  ``render_aovs`` gives the compositing planes of one frame.

Every entry point takes an explicit device; nothing picks one by itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import RenderConfig
from .scene.compile import ScenePlan, SceneTables, compile_scene
from .scene.parser import Scene

from .core import camera as cam
from .core.march import dot3
from .core.render import render_image
from .core.shading import TINY
from .ops.march_kernel import march_rays
from .ops.march_op import march_op
from .ops.normal_op import normal_op
from .ops.render_kernel import blend, check_supported, render_rays
from .ops.render_op import FusedRender
from .ops.scene_vjp import gather_rows
from .ops.surface_kernel import WINNER, surface_eval
from .tables import tables_to_torch

BACKENDS = ("cuda", "multi", "ref")


def resolve_backend(backend: str) -> str:
    """Validate a backend name ("cuda" | "multi" | "ref")."""
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
    ``"ref"``, the four kernel hooks for ``"multi"``
    (raymarching_tpu.api.make_render_hooks), each on the fused generator
    field when ``cfg.fused_generators`` is set (``MarchOp`` then takes
    the implicit-function route through ``core.sdf.scene_sd_fused``).
    ``tables`` are tensors on the render's device."""
    backend = resolve_backend(backend)
    if backend == "ref":
        return {}
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


def render_tables(plan: ScenePlan, tables: SceneTables,
                  cfg: Optional[RenderConfig] = None, *,
                  backend: str = "cuda", differentiable: bool = False,
                  device) -> torch.Tensor:
    """Render compiled tables -> [H, W, 3] float32 on ``device``.

    With ``differentiable`` the image carries the autograd graph back to
    the fields of ``tables`` that are tensors requiring grad (see
    ``tables.tables_to_torch``); otherwise nothing is recorded."""
    cfg = cfg or RenderConfig()
    backend = resolve_backend(backend)
    if backend == "multi" and (cfg.soft_shadow_k > 0.0
                               or cfg.ao_strength > 0.0):
        # the hooks carry no penumbra or occlusion factor; the fused
        # kernel tracks them (raymarching_tpu.api.render_tables)
        backend = "cuda"
    device = resolve_device(device)
    check_supported(plan, cfg)
    if differentiable and backend == "ref":
        raise NotImplementedError(
            "not ported yet: the differentiable ref oracle (ROADMAP Queue 1 "
            "item 3); use backend='cuda'")
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        tables = tables_to_torch(tables, device)
        if backend != "cuda":
            return render_image(plan, tables, cfg, **make_render_hooks(
                plan, tables, cfg, backend))
        origin, dirs = cam.generate_rays(tables, cfg)
        dirs = dirs.reshape(-1, 3)
        R = dirs.shape[0]
        chunk = cfg.ray_chunk if 0 < cfg.ray_chunk < R else R
        colors = torch.cat([
            _fused_colors(plan, cfg, tables,
                          origin if origin.dim() == 1 else origin[i:i + chunk],
                          dirs[i:i + chunk], differentiable)
            for i in range(0, R, chunk)])
        S = cfg.samples_per_pixel
        return colors.reshape(cfg.height, cfg.width, S, 3).mean(dim=2)


def _fused_colors(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                  origin: torch.Tensor, dirs: torch.Tensor,
                  differentiable: bool) -> torch.Tensor:
    """Colours [R, 3] of rays ``dirs`` [R, 3] through the fused path."""
    if differentiable:
        return FusedRender.apply(plan, cfg, origin, dirs, *tables)
    out = render_rays(plan, cfg, tables, origin, dirs)
    return blend(out.cidx, out.light, tables.prim_color)


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
        out = render_rays(plan, cfg.replace(shadow_sat_skip=False,
                                            shade_skip_black=False),
                          tables, origin, flat)
        colors = blend(out.cidx, out.light, tables.prim_color)
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
