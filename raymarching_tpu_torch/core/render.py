"""The port's reference renderer (the ``ref`` backend): plain PyTorch.

Port of ``raymarching_tpu.core.render.render_image`` for the reference's
shading model: march -> surface colour at the pre-step point -> FD (or,
with ``normal_mode="analytic"``, autograd) normal -> hard-shadowed Lambert -> light * colour, then the mean of the k x k
SSAA samples (scene.cpp:26-32, render.cpp:82-120).  It is the oracle the
kernel path is held to inside the port.  With the four hooks of
``api.make_render_hooks`` the same pipeline runs on the kernels: that is
the multi-kernel backend.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import RenderConfig
from ..scene.compile import ScenePlan, SceneTables

from . import camera as cam
from . import shading
from .march import MAX_STEP, march
from .sdf import scene_sd, scene_surface


def shade_rays(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
               origin: torch.Tensor, dirs: torch.Tensor, *,
               march_fn: Optional[Callable] = None,
               shadow_fn: Optional[Callable] = None,
               surface_fn: Optional[Callable] = None,
               normal_fn: Optional[Callable] = None) -> torch.Tensor:
    """Colours [N, 3] of rays ``dirs`` [N, 3] from ``origin`` [3] or
    [N, 3].

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
                    cfg.surface_precision)
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
        g = shading.normal_analytic(sd_fn, p_hit)
    else:
        g = shading.normal_fd(sd_fn, p_hit, cfg.fd_h)
    n = shading.normalize(g)
    # only the real lights: compile_tree pads a light-less scene with one
    # row that must never shade
    light = shading.lighting(
        sd_fn, tables.light_pos[:plan.num_lights], p_hit, n,
        iterations=cfg.iterations, surface_eps=cfg.surface_precision,
        offset_eps=cfg.offset_precision, saturation=cfg.saturation,
        shadows=cfg.shadows, shadow_fn=shadow_fn)
    return light[:, None] * color


def render_image(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                 **hooks) -> torch.Tensor:
    """Render the full frame -> [H, W, 3] float32 (linear, unclamped);
    ``hooks`` are ``shade_rays``'s four."""
    origin, dirs = cam.generate_rays(tables, cfg)
    S = cfg.samples_per_pixel
    colors = shade_rays(plan, tables, cfg, origin, dirs.reshape(-1, 3),
                        **hooks)
    return colors.reshape(cfg.height, cfg.width, S, 3).mean(dim=2)
