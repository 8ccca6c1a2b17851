"""The port's reference renderer (the ``ref`` backend): plain PyTorch.

Port of ``raymarching_tpu.core.render.render_image`` for the reference's
shading model: march -> surface colour at the pre-step point -> FD (or,
with ``normal_mode="analytic"``, autograd) normal -> hard-shadowed Lambert -> light * colour, then the mean of the k x k
SSAA samples (scene.cpp:26-32, render.cpp:82-120), with the JAX package's
shading extensions (coloured lights, soft shadows, ambient occlusion) and
mirror bounces when the scene or ``cfg`` asks for them.  It is the oracle the
kernel path is held to inside the port.  With the four hooks of
``api.make_render_hooks`` the same pipeline runs on the kernels: that is
the multi-kernel backend.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..config import RenderConfig
from ..scene.compile import ScenePlan, SceneTables

from . import camera as cam
from . import shading
from .march import MAX_STEP, dot3, march
from .sdf import scene_sd, scene_surface


def shade_rays(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
               origin: torch.Tensor, dirs: torch.Tensor, *,
               differentiable: bool = False,
               march_fn: Optional[Callable] = None,
               shadow_fn: Optional[Callable] = None,
               surface_fn: Optional[Callable] = None,
               normal_fn: Optional[Callable] = None,
               _bounces: Optional[int] = None) -> torch.Tensor:
    """Colours [N, 3] of rays ``dirs`` [N, 3] from ``origin`` [3] or
    [N, 3].  With ``cfg.reflect_strength`` s > 0, the tinted mirror of
    the JAX package (core.render._shade_rays): colour ((1 - s) light +
    s c_reflected), each bounce this same function (same hooks) from
    p + (surface_eps + offset_eps) n along d - 2 (d . n) n, for
    ``cfg.reflect_bounces`` levels, the last one plain.

    Optional hooks that replace the plain PyTorch stages (core.render
    ._shade_rays of the JAX package):
      march_fn(origin [N, 3], dirs) -> MarchResult     primary, differentiable
      shadow_fn(origin, dirs, tmax) -> MarchResult     forward only
      surface_fn(p) -> (sd, colour)                    colour lookup
      normal_fn(p) -> SDF gradient, not normalised     differentiable
    """
    sd_fn = lambda q: scene_sd(plan, tables, q)  # noqa: E731
    if march_fn is None:
        res = march(sd_fn, origin, dirs, cfg.iterations,
                    cfg.surface_precision, differentiable=differentiable)
    else:
        res = march_fn(origin.expand(dirs.shape), dirs)
    p_hit = res.position
    p_color = p_hit - torch.clamp_max(res.sd, MAX_STEP)[:, None] * dirs
    if surface_fn is None:
        _, color = scene_surface(plan, tables, p_color)
    else:
        _, color = surface_fn(p_color)
    if normal_fn is not None:
        g = normal_fn(p_hit)
    elif cfg.normal_mode == "analytic":
        graph = torch.is_grad_enabled() and (p_hit.requires_grad or any(
            t.requires_grad for t in tables))
        g = shading.normal_analytic(sd_fn, p_hit, graph=graph)
    else:
        g = shading.normal_fd(sd_fn, p_hit, cfg.fd_h)
    n = shading.normalize(g)
    # only the real lights: compile_tree pads a light-less scene with one
    # row that must never shade
    light = shading.lighting(
        sd_fn, tables.light_pos[:plan.num_lights], p_hit, n,
        iterations=cfg.iterations, surface_eps=cfg.surface_precision,
        offset_eps=cfg.offset_precision, saturation=cfg.saturation,
        shadows=cfg.shadows, shadow_fn=shadow_fn,
        light_colors=(tables.light_color[:plan.num_lights]
                      if plan.colored_lights else None),
        soft_shadow_k=cfg.soft_shadow_k, ao_strength=cfg.ao_strength,
        ao_samples=cfg.ao_samples, ao_delta=cfg.ao_delta)
    base = (light if plan.colored_lights else light[:, None]) * color
    s = cfg.reflect_strength
    bounces = cfg.reflect_bounces if _bounces is None else _bounces
    if s > 0.0 and bounces > 0:
        off = cfg.surface_precision + cfg.offset_precision
        rdir = dirs - 2.0 * dot3(dirs, n)[:, None] * n
        c_ref = shade_rays(plan, tables, cfg, p_hit + off * n, rdir,
                           differentiable=differentiable, march_fn=march_fn,
                           shadow_fn=shadow_fn, surface_fn=surface_fn,
                           normal_fn=normal_fn,
                           _bounces=bounces - 1)
        return (1.0 - s) * base + s * color * c_ref
    return base


def shade_chunks(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                 origin: torch.Tensor, dirs: torch.Tensor, *,
                 differentiable: bool = False, **hooks) -> torch.Tensor:
    """``shade_rays`` over rays ``dirs`` [R, 3] (R > 0) from ``origin``
    [3] or [R, 3], ``cfg.ray_chunk`` > 0 rays at a time (the same bits);
    with ``differentiable`` and grad enabled each chunk runs under
    ``torch.utils.checkpoint`` (JAX's ``lax.map(jax.checkpoint(...))``),
    so the backward holds one chunk's activations at a time and
    recomputes each chunk's forward, its march included, when it reaches
    it."""
    R = dirs.shape[0]
    chunk = cfg.ray_chunk if 0 < cfg.ray_chunk < R else R
    remat = differentiable and chunk < R and torch.is_grad_enabled()

    def shade(o, d):
        return shade_rays(plan, tables, cfg, o, d,
                          differentiable=differentiable, **hooks)

    parts = []
    for i in range(0, R, chunk):
        o = origin if origin.dim() == 1 else origin[i:i + chunk]
        parts.append(checkpoint(shade, o, dirs[i:i + chunk],
                                use_reentrant=False, preserve_rng_state=False)
                     if remat else shade(o, dirs[i:i + chunk]))
    return torch.cat(parts)


def render_image(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                 *, differentiable: bool = False, row_range=None,
                 **hooks) -> torch.Tensor:
    """Render the full frame -> [H, W, 3] float32 (linear, unclamped), or
    the rows ``row_range=(r0, n)`` of it -> [n, W, 3], their rays bitwise
    the whole frame's (``core.camera.generate_rays``); ``hooks`` are
    ``shade_rays``'s four, the rays shaded by ``shade_chunks``."""
    origin, dirs = cam.generate_rays(tables, cfg, row_range)
    colors = shade_chunks(plan, tables, cfg, origin, dirs.reshape(-1, 3),
                          differentiable=differentiable, **hooks)
    return colors.reshape(dirs.shape[0], cfg.width, cfg.samples_per_pixel,
                          3).mean(dim=2)
