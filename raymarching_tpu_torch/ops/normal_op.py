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
  * procedural fractal leaves (``plan.proc``): the forward is K2's mode
    on the plan's procedural view.  With FD normals on exact tables the
    backward is the stencil one, its scatter with the fractals' size
    columns; otherwise a fractal winner has no closed-form Hessian, and
    the backward is autograd through the normal estimator of the field
    (``core.sdf.scene_sd``, or ``scene_sd_fused`` with fused generators),
    JAX's ``api._normal_bwd`` replay, ``scene_vjp.replay_slice`` points
    a slice.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..core.sdf import require_kernel_form, scene_sd, scene_sd_fused
from ..core.shading import normal_analytic, normal_fd
from ..scene.compile import ScenePlan, SceneTables
from .scene_vjp import (analytic_normal_bwd, fd_stencil_cotangents,
                        fused_analytic_normal_bwd, replay_slice, stencil_eval,
                        stencil_theta_cotangents)
from .shade_kernel import check_normal_mode
from .surface_kernel import ANALYTIC, FD_GRAD, stencil_points, surface_eval


def check_supported(plan: ScenePlan, cfg: RenderConfig) -> None:
    """Raise NotImplementedError for ``_normal_op``'s other branches."""
    check_normal_mode(cfg, False)


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
        if cfg.fused_generators:
            require_kernel_form(plan)   # a deep plan's fused backward
        p, *fields = ctx.saved_tensors
        tables = SceneTables(*fields)
        # inputs: plan, cfg, p, then the fields in order
        need_p = ctx.needs_input_grad[2]
        need_theta = any(ctx.needs_input_grad[3:5])   # prim_pos, prim_aux
        if not (need_p or need_theta):
            return (None,) * (3 + len(fields))
        analytic = cfg.normal_mode == "analytic"
        if (cfg.fused_generators and not analytic) or (analytic
                                                       and plan.proc):
            p_bar, pos_bar, aux_bar = _replay_normal_bwd(plan, cfg, tables,
                                                         p, g_bar)
        elif cfg.fused_generators:
            p_bar, pos_bar, aux_bar = fused_analytic_normal_bwd(
                plan, tables, p, g_bar)
        elif analytic:
            # radii and sizes do not move the winner's gradient
            p_bar, pos_bar = analytic_normal_bwd(plan, tables, p, g_bar,
                                                 need_theta)
            aux_bar = None
        else:
            sd, widx, g = stencil_eval(plan, cfg, tables, p, center=False)
            u = fd_stencil_cotangents(cfg, g_bar)                # [6, R]
            p_bar = (u[..., None] * g).sum(dim=0)
            # the float64 scatter only when a geometry field asks for it;
            # a fractal's size column needs the stencil SDs and points
            pos_bar, aux_bar = (
                stencil_theta_cotangents(
                    plan, tables, widx, g, u, *((sd, stencil_points(
                        p, cfg.fd_h, center=False)) if plan.proc else ()))
                if need_theta else (None, None))
        grads = SceneTables(
            prim_pos=pos_bar, prim_aux=aux_bar, prim_color=None,
            light_pos=None, light_color=None, cam_position=None,
            cam_direction=None, cam_up=None, cam_fov=None)
        return (None, None, p_bar, *grads)


def _replay_normal_bwd(plan: ScenePlan, cfg: RenderConfig,
                       tables: SceneTables, p: torch.Tensor,
                       g_bar: torch.Tensor) -> tuple:
    """The VJP of the normal estimator by autograd (api._normal_bwd's
    replay): ``normal_fd`` or ``normal_analytic`` (with a graph) of
    ``scene_sd_fused`` with fused generators, else of ``scene_sd``,
    ``scene_vjp.replay_slice`` points a slice -> (p_bar, prim_pos
    cotangent, prim_aux cotangent)."""
    sdf = scene_sd_fused if cfg.fused_generators else scene_sd
    p_bar = torch.empty_like(p)
    pos_bar = torch.zeros_like(tables.prim_pos)
    aux_bar = torch.zeros_like(tables.prim_aux)
    n = replay_slice(plan, p.shape[0])
    for lo in range(0, p.shape[0], n):
        sl = slice(lo, lo + n)
        with torch.enable_grad():
            pos = tables.prim_pos.detach().requires_grad_()
            aux = tables.prim_aux.detach().requires_grad_()
            q = p[sl].detach().requires_grad_()
            tb = tables._replace(prim_pos=pos, prim_aux=aux)
            sd_one = lambda x: sdf(plan, tb, x)  # noqa: E731
            g = (normal_analytic(sd_one, q, graph=True)
                 if cfg.normal_mode == "analytic"
                 else normal_fd(sd_one, q, cfg.fd_h))
            p_bar[sl], pos_b, aux_b = torch.autograd.grad(
                g, (q, pos, aux), g_bar[sl], materialize_grads=True)
        pos_bar += pos_b
        aux_bar += aux_b
    return p_bar, pos_bar, aux_bar


def normal_op(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
              p: torch.Tensor) -> torch.Tensor:
    """``NormalOp`` as a function of tables: the ``normal_fn`` hook of
    ``core.render.shade_rays``."""
    return NormalOp.apply(plan, cfg, p, *tables)
