"""The port's reference renderer (the ``ref`` backend): plain PyTorch.

Port of ``raymarching_tpu.core.render.render_image`` for the reference's
shading model: march -> surface colour at the pre-step point -> FD normal
-> hard-shadowed Lambert -> light * colour, then the mean of the k x k
SSAA samples (scene.cpp:26-32, render.cpp:82-120).  It is the oracle the
kernel path is held to inside the port.
"""

from __future__ import annotations

import torch

from raymarching_tpu.config import RenderConfig
from raymarching_tpu.scene.compile import ScenePlan, SceneTables

from . import camera as cam
from . import shading
from .march import MAX_STEP, march
from .sdf import scene_sd, scene_surface


def shade_rays(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
               origin: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Colours [N, 3] of rays ``dirs`` [N, 3] from ``origin`` [3]."""
    sd_fn = lambda q: scene_sd(plan, tables, q)  # noqa: E731
    res = march(sd_fn, origin, dirs, cfg.iterations, cfg.surface_precision)
    p_hit = res.position
    p_color = p_hit - torch.clamp_max(res.sd, MAX_STEP)[:, None] * dirs
    _, color = scene_surface(plan, tables, p_color)
    n = shading.normalize(shading.normal_fd(sd_fn, p_hit, cfg.fd_h))
    # only the real lights: compile_tree pads a light-less scene with one
    # row that must never shade
    light = shading.lighting(
        sd_fn, tables.light_pos[:plan.num_lights], p_hit, n,
        iterations=cfg.iterations, surface_eps=cfg.surface_precision,
        offset_eps=cfg.offset_precision, saturation=cfg.saturation,
        shadows=cfg.shadows)
    return light[:, None] * color


def render_image(plan: ScenePlan, tables: SceneTables,
                 cfg: RenderConfig) -> torch.Tensor:
    """Render the full frame -> [H, W, 3] float32 (linear, unclamped)."""
    origin, dirs = cam.generate_rays(tables, cfg)
    S = cfg.samples_per_pixel
    colors = shade_rays(plan, tables, cfg, origin, dirs.reshape(-1, 3))
    return colors.reshape(cfg.height, cfg.width, S, 3).mean(dim=2)
