"""Rendering API of the port.

Backends:
  * ``"cuda"`` — the fused path (``raymarching_tpu.api._render_mega``):
    every ray through ``ops.render_kernel.render_rays``, which launches the
    K1 kernel on a CUDA device and runs its plain twin on the CPU; then the
    colour blend and the SSAA mean.
  * ``"ref"`` — the plain PyTorch oracle ``core.render.render_image``.

Every entry point takes an explicit device; nothing picks one by itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from raymarching_tpu.config import RenderConfig
from raymarching_tpu.scene.compile import ScenePlan, SceneTables, compile_scene
from raymarching_tpu.scene.parser import Scene

from .core import camera as cam
from .core.render import render_image
from .ops.render_kernel import blend, check_supported, render_rays
from .tables import tables_to_torch

BACKENDS = ("cuda", "ref")


def resolve_backend(backend: str) -> str:
    """Validate a backend name ("cuda" | "ref")."""
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


def render_tables(plan: ScenePlan, tables: SceneTables,
                  cfg: Optional[RenderConfig] = None, *,
                  backend: str = "cuda", device) -> torch.Tensor:
    """Render compiled tables -> [H, W, 3] float32 on ``device``."""
    cfg = cfg or RenderConfig()
    backend = resolve_backend(backend)
    device = resolve_device(device)
    check_supported(plan, cfg, tables)
    tables = tables_to_torch(tables, device)
    if backend == "ref":
        return render_image(plan, tables, cfg)
    origin, dirs = cam.generate_rays(tables, cfg)
    out = render_rays(plan, cfg, tables, origin, dirs.reshape(-1, 3))
    colors = blend(out.cidx, out.light, tables.prim_color)
    S = cfg.samples_per_pixel
    return colors.reshape(cfg.height, cfg.width, S, 3).mean(dim=2)


def render(scene: Scene, cfg: Optional[RenderConfig] = None, *,
           backend: str = "cuda", device) -> torch.Tensor:
    """Parsed Scene -> [H, W, 3] image on ``device``."""
    plan, tables = compile_scene(scene)
    return render_tables(plan, tables, cfg, backend=backend, device=device)


def render_ref(scene: Scene, cfg: Optional[RenderConfig] = None, *,
               device) -> torch.Tensor:
    """The plain PyTorch oracle render of a parsed Scene."""
    return render(scene, cfg, backend="ref", device=device)
