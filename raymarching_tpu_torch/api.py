"""Rendering API of the port.

Backends (the JAX package's names in brackets):
  * ``"cuda"`` [``mega``] — the fused path: every ray through
    ``ops.render_kernel.render_rays``, which launches the K1 kernel on a
    CUDA device (K3, K3 and K4 with ``cfg.two_phase_k1``) and runs the
    plain twins on the CPU; then the colour blend and the SSAA mean.  With
    ``differentiable=True`` the rays go through
    ``ops.render_op.FusedRender`` (that forward, exact-FD backward over
    K2), so gradients reach every SceneTables field that requires grad.
  * ``"multi"`` [``pallas``] — the multi-kernel path: ``core.render``'s
    pipeline with the hooks of ``make_render_hooks``: K3 marches the
    primary rays (``ops.march_op.MarchOp``) and, with a per-ray tmax, the
    shadow rays; K2 looks up colours (winner mode) and gives normals
    (``ops.normal_op.NormalOp``, FD mode); light and colour arithmetic is
    plain PyTorch under autograd.  Differentiable on every field.
  * ``"ref"`` [``ref``] — the plain PyTorch oracle
    ``core.render.render_image``, forward only.

Every entry point takes an explicit device; nothing picks one by itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import RenderConfig
from .scene.compile import ScenePlan, SceneTables, compile_scene
from .scene.parser import Scene

from .core import camera as cam
from .core.render import render_image
from .ops.march_kernel import march_rays
from .ops.march_op import march_op
from .ops.normal_op import normal_op
from .ops.render_kernel import (blend, check_supported, render_rays,
                                winner_colors)
from .ops.render_op import FusedRender
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
    (raymarching_tpu.api.make_render_hooks).  ``tables`` are tensors on
    the render's device."""
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
            sd, cidx, _ = surface_eval(plan, const, p.detach(), mode=WINNER)
        # the gather stays under autograd: the colour rows' gradient
        return sd, winner_colors(cidx, tables.prim_color)

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
        if differentiable:
            colors = FusedRender.apply(plan, cfg, origin, dirs, *tables)
        else:
            out = render_rays(plan, cfg, tables, origin, dirs)
            colors = blend(out.cidx, out.light, tables.prim_color)
        S = cfg.samples_per_pixel
        return colors.reshape(cfg.height, cfg.width, S, 3).mean(dim=2)


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
