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
up to ``iterations`` steps.  With fused generators grad f and f_theta come
from autograd through ``core.sdf.scene_sd_fused`` at the hit points, as
JAX's fused march differentiates the jnp field (``bwd_impl=None``).  Rays that did not converge get zero implicit
gradients (t is held constant).  Dropped cotangents: ``sd`` only shifts
the colour-lookup point, and the colour gather is piecewise constant in
position; ``converged`` is boolean.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..core.march import MarchResult, dot3
from ..core.sdf import scene_sd_fused
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
        t_bar = torch.where(converged, dot3(p_bar, dirs),
                            torch.zeros((), device=p_bar.device))
        if cfg.fused_generators:
            g, w, pos_bar, aux_bar = fused_ift(plan, cfg, tables, p_hit,
                                                dirs, t_bar)
        else:
            # K2 in its combined mode at the hit points (winner_eval)
            _, widx, g = surface_eval(plan, tables, p_hit)
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


def fused_ift(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
               p_hit: torch.Tensor, dirs: torch.Tensor, t_bar: torch.Tensor
               ) -> tuple:
    """The implicit-function pieces on the fused field, by autograd through
    ``scene_sd_fused`` at the hits -> (grad f [R, 3], w [R], prim_pos and
    prim_aux cotangents w f_theta): ``MarchOp``'s fused backward and the
    IFT route of ``FusedRender``'s fused FD backward."""
    with torch.enable_grad():
        pos = tables.prim_pos.detach().requires_grad_()
        aux = tables.prim_aux.detach().requires_grad_()
        q = p_hit.detach().requires_grad_()
        f = scene_sd_fused(plan, tables._replace(prim_pos=pos, prim_aux=aux),
                           q)
        (g,) = torch.autograd.grad(f, q, torch.ones_like(f),
                                   retain_graph=True)
        w = ift_ray_weights(t_bar, dot3(g, dirs), cfg.ift_damping)
        pos_bar, aux_bar = torch.autograd.grad(f, (pos, aux), w,
                                               materialize_grads=True)
    return g, w, pos_bar, aux_bar


def march_op(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
             origin: torch.Tensor, dirs: torch.Tensor) -> MarchResult:
    """``MarchOp`` as a function of tables: the ``march_fn`` hook of
    ``core.render.shade_rays``."""
    return MarchResult(*MarchOp.apply(plan, cfg, origin, dirs, *tables))
