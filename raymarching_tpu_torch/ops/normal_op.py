"""The differentiable FD normal: K2 forward, stencil backward.

Counterpart of ``raymarching_tpu.api._normal_op`` on its exact-table
finite-difference branch.  Forward: K2 in its ``FD_GRAD`` mode, g_a =
(f(p + h e_a) - f(p - h e_a)) / 2h.  Backward (``scene_vjp
.fd_normal_bwd``): ONE K2 launch in its combined mode over the six stencil
points of every point, the rows' SD cotangents +-g_bar_a / 2h, then
p_bar = sum of u * (d scene / dp) over the rows and one scatter of the
parameter cotangents.  The analytic, fused-generator and procedural
branches are not ported yet.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..scene.compile import ScenePlan, SceneTables
from .scene_vjp import (fd_stencil_cotangents, stencil_eval,
                        stencil_theta_cotangents)
from .surface_kernel import FD_GRAD, surface_eval


def check_supported(plan: ScenePlan, cfg: RenderConfig) -> None:
    """Raise NotImplementedError for ``_normal_op``'s other branches."""
    if cfg.normal_mode != "fd":
        raise NotImplementedError(
            f"not ported yet: normal_mode={cfg.normal_mode!r} (ROADMAP "
            "Queue 1 item 7)")
    if cfg.fused_generators:
        raise NotImplementedError(
            "not ported yet: fused generators (ROADMAP Queue 1 item 8)")
    if plan.proc:
        raise NotImplementedError(
            "not ported yet: procedural leaves (ROADMAP Queue 1 item 10)")


class NormalOp(torch.autograd.Function):
    """gradient [R, 3] (not normalised) = NormalOp.apply(plan, cfg, p,
    *tables) at points p [R, 3]; ``tables`` are the nine SceneTables
    fields, in order, on p's device."""

    @staticmethod
    def forward(ctx, plan: ScenePlan, cfg: RenderConfig, p, *fields):
        check_supported(plan, cfg)
        tables = SceneTables(*fields)
        _, _, g = surface_eval(plan, tables, p, mode=FD_GRAD, fd_h=cfg.fd_h)
        ctx.plan, ctx.cfg = plan, cfg
        ctx.save_for_backward(p, *fields)
        return g

    @staticmethod
    def backward(ctx, g_bar):
        plan, cfg = ctx.plan, ctx.cfg
        p, *fields = ctx.saved_tensors
        tables = SceneTables(*fields)
        # inputs: plan, cfg, p, then the fields in order
        need_p = ctx.needs_input_grad[2]
        need_theta = any(ctx.needs_input_grad[3:5])   # prim_pos, prim_aux
        if not (need_p or need_theta):
            return (None,) * (3 + len(fields))
        _, widx, g = stencil_eval(plan, cfg, tables, p, center=False)
        u = fd_stencil_cotangents(cfg, g_bar)                    # [6, R]
        p_bar = (u[..., None] * g).sum(dim=0)
        # the float64 scatter only when a geometry field asks for it
        pos_bar, aux_bar = (stencil_theta_cotangents(plan, tables, widx, g, u)
                            if need_theta else (None, None))
        grads = SceneTables(
            prim_pos=pos_bar, prim_aux=aux_bar, prim_color=None,
            light_pos=None, light_color=None, cam_position=None,
            cam_direction=None, cam_up=None, cam_fov=None)
        return (None, None, p_bar, *grads)


def normal_op(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
              p: torch.Tensor) -> torch.Tensor:
    """``NormalOp`` as a function of tables: the ``normal_fn`` hook of
    ``core.render.shade_rays``."""
    return NormalOp.apply(plan, cfg, p, *tables)
