"""The differentiable normal: K2 forward, winner-algebra backward.

Counterpart of ``raymarching_tpu.api._normal_op`` on its exact-table and
fused-generator branches, chosen by ``cfg.normal_mode`` and
``cfg.fused_generators``:

  * ``"fd"``: forward K2 in its ``FD_GRAD`` mode, g_a = (f(p + h e_a) -
    f(p - h e_a)) / 2h.  Backward (``scene_vjp.fd_normal_bwd``): ONE K2
    launch in its combined mode over the six stencil points of every
    point, the rows' SD cotangents +-g_bar_a / 2h, then p_bar = sum of
    u * (d scene / dp) over the rows and one scatter of the parameter
    cotangents.
  * ``"analytic"``: forward K2 in its ``ANALYTIC`` mode, the winner's
    gradient.  Backward (``scene_vjp.analytic_normal_bwd``, JAX
    ``api._normal_bwd``): ONE K2 launch in its combined mode at the
    points, the closed-form winner Hessian chain, one scatter onto
    prim_pos.
  * fused generators: the forward is K2's mode on the fused field.  With
    analytic normals the backward is ``scene_vjp
    .fused_analytic_normal_bwd`` (one fused combined launch, the chain on
    the fused field, its carve rows landing on the generators' base
    rows); with FD normals it is autograd through the FD normal of
    ``core.sdf.scene_sd_fused``, as JAX's replay is plain jnp.

The procedural branch is not ported yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..core.sdf import scene_sd_fused
from ..core.shading import normal_fd
from ..scene.compile import ScenePlan, SceneTables
from .scene_vjp import (analytic_normal_bwd, fd_stencil_cotangents,
                        fused_analytic_normal_bwd, stencil_eval,
                        stencil_theta_cotangents)
from .shade_kernel import check_normal_mode
from .surface_kernel import ANALYTIC, FD_GRAD, surface_eval


def check_supported(plan: ScenePlan, cfg: RenderConfig) -> None:
    """Raise NotImplementedError for ``_normal_op``'s other branches."""
    check_normal_mode(cfg, False)
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
        mode = ANALYTIC if cfg.normal_mode == "analytic" else FD_GRAD
        _, _, g = surface_eval(plan, tables, p, mode=mode, fd_h=cfg.fd_h,
                               fused=cfg.fused_generators)
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
        if cfg.fused_generators and cfg.normal_mode == "analytic":
            p_bar, pos_bar, aux_bar = fused_analytic_normal_bwd(
                plan, tables, p, g_bar)
        elif cfg.fused_generators:
            p_bar, pos_bar, aux_bar = _fused_fd_normal_bwd(plan, cfg, tables,
                                                           p, g_bar)
        elif cfg.normal_mode == "analytic":
            # radii and sizes do not move the winner's gradient
            p_bar, pos_bar = analytic_normal_bwd(plan, tables, p, g_bar,
                                                 need_theta)
            aux_bar = None
        else:
            _, widx, g = stencil_eval(plan, cfg, tables, p, center=False)
            u = fd_stencil_cotangents(cfg, g_bar)                # [6, R]
            p_bar = (u[..., None] * g).sum(dim=0)
            # the float64 scatter only when a geometry field asks for it
            pos_bar, aux_bar = (
                stencil_theta_cotangents(plan, tables, widx, g, u)
                if need_theta else (None, None))
        grads = SceneTables(
            prim_pos=pos_bar, prim_aux=aux_bar, prim_color=None,
            light_pos=None, light_color=None, cam_position=None,
            cam_direction=None, cam_up=None, cam_fov=None)
        return (None, None, p_bar, *grads)


def _fused_fd_normal_bwd(plan: ScenePlan, cfg: RenderConfig,
                         tables: SceneTables, p: torch.Tensor,
                         g_bar: torch.Tensor) -> tuple:
    """The VJP of the FD normal of the fused field, by autograd through
    ``core.shading.normal_fd`` of ``scene_sd_fused`` (api._normal_bwd's
    replay) -> (p_bar, prim_pos cotangent, prim_aux cotangent)."""
    with torch.enable_grad():
        pos = tables.prim_pos.detach().requires_grad_()
        aux = tables.prim_aux.detach().requires_grad_()
        q = p.detach().requires_grad_()
        tb = tables._replace(prim_pos=pos, prim_aux=aux)
        g = normal_fd(lambda x: scene_sd_fused(plan, tb, x), q, cfg.fd_h)
        return torch.autograd.grad(g, (q, pos, aux), g_bar,
                                   materialize_grads=True)


def normal_op(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
              p: torch.Tensor) -> torch.Tensor:
    """``NormalOp`` as a function of tables: the ``normal_fn`` hook of
    ``core.render.shade_rays``."""
    return NormalOp.apply(plan, cfg, p, *tables)
