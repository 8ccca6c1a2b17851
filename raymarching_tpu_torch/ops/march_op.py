"""The differentiable march: K3 forward, implicit-function backward.

Counterpart of ``raymarching_tpu.ops.march_op.march_op`` with
``pallas_march.make_pallas_march`` as its forward and
``scene_vjp.make_march_bwd`` as its backward, on exact tables.  The hit
point is a root of f(o + t d, theta) = c, so by the implicit function
theorem

    dt / dtheta = -f_theta / (grad f . d),   dt / do = -grad f / (grad f . d),
    dt / dd = -t grad f / (grad f . d),

which costs ONE K2 launch at the hit points (the combined mode: SD,
winner, winner gradient) and one scatter, instead of a walk back through
up to ``iterations`` steps.  Rays that did not converge get zero implicit
gradients (t is held constant).  Dropped cotangents: ``sd`` only shifts
the colour-lookup point, and the colour gather is piecewise constant in
position; ``converged`` is boolean.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..core.march import MarchResult, dot3
from ..scene.compile import ScenePlan, SceneTables
from .march_kernel import march_rays
from .scene_vjp import ift_ray_weights, theta_cotangents
from .surface_kernel import surface_eval


class MarchOp(torch.autograd.Function):
    """position [R, 3], sd [R], converged [R] = MarchOp.apply(plan, cfg,
    origin, dirs, *tables) for rays ``dirs`` [R, 3] from ``origin``
    [R, 3]; ``tables`` are the nine SceneTables fields, in order, on the
    rays' device."""

    @staticmethod
    def forward(ctx, plan: ScenePlan, cfg: RenderConfig, origin, dirs,
                *fields):
        tables = SceneTables(*fields)
        res = march_rays(plan, cfg, tables, origin, dirs)
        t = dot3(res.position - origin, dirs) / dot3(dirs, dirs)
        ctx.plan, ctx.cfg = plan, cfg
        ctx.save_for_backward(res.position, res.converged, t, dirs, *fields)
        ctx.mark_non_differentiable(res.sd, res.converged)
        return res.position, res.sd, res.converged

    @staticmethod
    def backward(ctx, p_bar, _sd_bar, _conv_bar):
        plan, cfg = ctx.plan, ctx.cfg
        p_hit, converged, t, dirs, *fields = ctx.saved_tensors
        tables = SceneTables(*fields)
        # inputs: plan, cfg, origin, dirs, then the fields in order
        need_rays = any(ctx.needs_input_grad[2:4])
        need_theta = any(ctx.needs_input_grad[4:6])   # prim_pos, prim_aux
        if not (need_rays or need_theta):
            return (None,) * (4 + len(fields))
        # K2 in its combined mode at the hit points (scene_vjp.winner_eval)
        _, widx, g = surface_eval(plan, tables, p_hit)
        t_bar = torch.where(converged, dot3(p_bar, dirs),
                            torch.zeros((), device=p_bar.device))
        w = ift_ray_weights(t_bar, dot3(g, dirs), cfg.ift_damping)
        # the float64 scatter only when a geometry field asks for it
        pos_bar, aux_bar = (theta_cotangents(plan, tables, widx, g, w)
                            if need_theta else (None, None))
        o_bar = p_bar + w[:, None] * g
        d_bar = t[:, None] * o_bar
        grads = SceneTables(
            prim_pos=pos_bar, prim_aux=aux_bar, prim_color=None,
            light_pos=None, light_color=None, cam_position=None,
            cam_direction=None, cam_up=None, cam_fov=None)
        return (None, None, o_bar, d_bar, *grads)


def march_op(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
             origin: torch.Tensor, dirs: torch.Tensor) -> MarchResult:
    """``MarchOp`` as a function of tables: the ``march_fn`` hook of
    ``core.render.shade_rays``."""
    return MarchResult(*MarchOp.apply(plan, cfg, origin, dirs, *tables))
