"""The differentiable fused render: K1 forward, winner-algebra backward.

Counterpart of ``raymarching_tpu.ops.pallas_render.fused_render_op`` with
its ``_fused_fwd``, ``_exact_fd_bwd``, ``_exact_analytic_bwd`` and
``_fused_analytic_bwd`` rules and the fused-generator FD branch of
``_fused_bwd``, for the training configurations on exact tables and with
fused generators (FD or analytic normals, hard shadows, white lights).

Forward: K1 over every ray (``render_rays``) with the black-lane shadow
skip off, then the colour blend; with analytic normals K1 also writes the
winner residuals (sd0, widx0, g0) of its normal
(``_save_winner_engaged``).

FD backward, one K2 launch in all:

  1. ``stencil_eval`` over the 7-point stencil of every hit: the FD normal
     primal from the stencil SDs, and every d scene / dp and winner row.
  2. Autograd through the Lambert replay of ``normalize(gfd)`` times the
     winner colour, with the saved shadow bits; the colour cotangent goes
     onto the colour rows with ``index_add_``.
  3. The FD chain: p_bar += sum of the stencil rows' u_fd * g.
  4. The implicit-function weight w on the hit row, one
     ``theta_cotangents`` scatter over all 7 rows, and the origin and
     direction cotangents.

Analytic backward, no kernel launch when the forward saved the residuals
(else one K2 launch, ``winner_eval`` at the hits):

  1. The Lambert replay of ``normalize(g0)`` times the winner colour.
  2. The winner Hessian chain of g0 into p_bar
     (``scene_vjp.winner_hessian_chain``).
  3. The implicit-function weight w on g0, one ``theta_cotangents``
     scatter over the R winner rows, the Hessian rows ``segment_add``-ed
     onto prim_pos, and the origin and direction cotangents.

With fused generators (``cfg.fused_generators``) the analytic backward is
the same with the fused field's algebra (``_fused_analytic_bwd``): the
residuals may name a carve by its extended winner id, and
``fused_winner_hessian_chain`` and ``fused_theta_cotangents`` land its
cotangents on the generator's base row; no kernel launch with the
residuals, one fused ``winner_eval`` without.  The fused FD backward is
JAX's: autograd through the Lambert replay of the FD normal of
``core.sdf.scene_sd_fused`` and through its implicit-function route,
plain PyTorch as JAX's is plain jnp (no kernel launch).

Camera gradients flow on from ``origin``/``dirs`` through
``core.camera.generate_rays`` under ordinary autograd.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..scene.compile import ScenePlan, SceneTables

from ..core.march import dot3
from ..core.sdf import scene_sd_fused
from ..core.shading import lambert_replay, normal_fd, normalize
from .march_op import fused_ift
from .render_kernel import blend, render_rays
from .scene_vjp import (fd_stencil_cotangents, fused_theta_cotangents,
                        fused_winner_eval, fused_winner_hessian_chain,
                        gather_rows, ift_ray_weights, segment_add,
                        stencil_eval, theta_cotangents, winner_eval,
                        winner_hessian_chain)

# The analytic forward saves K1's winner residuals, so its backward
# launches no kernel; False makes the backward launch winner_eval instead
# (the path of a forward that has none; tests and measurements).
SAVE_WINNER = True


class FusedRender(torch.autograd.Function):
    """colours [R, 3] = FusedRender.apply(plan, cfg, origin, dirs, *tables)
    for rays ``dirs`` [R, 3] from ``origin`` [3] or [R, 3]; ``tables`` are
    the nine SceneTables fields, in order, on the rays' device."""

    @staticmethod
    def forward(ctx, plan: ScenePlan, cfg: RenderConfig, origin, dirs,
                *fields):
        tables = SceneTables(*fields)
        # Under differentiation the black-lane skip must be off: a skipped
        # lane never computes its true shadow state, so the replay could
        # not give a black leaf the colour gradient light * d colour (a
        # black primitive would stay black under fitting).  The
        # saturation-floor skip stays: it is exact for gradients too.
        cfg = cfg.replace(shade_skip_black=False)
        save = cfg.normal_mode == "analytic" and SAVE_WINNER
        out = render_rays(plan, cfg, tables, origin, dirs, save_winner=save)
        out, winner = out if save else (out, ())
        colors = blend(out.cidx, out.light, tables.prim_color)
        t = dot3(out.p - origin, dirs) / dot3(dirs, dirs)
        ctx.plan, ctx.cfg = plan, cfg
        ctx.origin_dim = origin.dim()
        ctx.n_winner = len(winner)
        ctx.save_for_backward(out.p, out.done, out.cidx, out.smask, t, dirs,
                              *winner, *fields)
        return colors

    @staticmethod
    def backward(ctx, g_out):
        plan, cfg = ctx.plan, ctx.cfg
        p, conv, cidx, smask, t, dirs, *rest = ctx.saved_tensors
        winner, fields = rest[:ctx.n_winner], rest[ctx.n_winner:]
        tables = SceneTables(*fields)
        P = tables.prim_color.shape[0]
        fused = cfg.fused_generators
        if fused and cfg.normal_mode == "fd":
            p_bar, gp, grads = _fused_fd_bwd(plan, cfg, tables, p, conv,
                                             cidx, smask, dirs, g_out)
            o_bar = gp if ctx.origin_dim == 2 else gp.sum(dim=0)
            return (None, None, o_bar, t[:, None] * gp, *grads)
        if cfg.normal_mode == "analytic":
            # the forward's residuals, else one K2 launch at the hits
            sd0, widx0, g0 = winner or (fused_winner_eval if fused else
                                        winner_eval)(plan, tables, p)
            g = g0
        else:
            sd7, widx7, g7 = stencil_eval(plan, cfg, tables, p, center=True)
            inv = 1.0 / (2.0 * cfg.fd_h)
            g = torch.stack([(sd7[1 + a] - sd7[4 + a]) * inv
                             for a in range(3)], dim=-1)
            g0 = g7[0]

        # 1. shading replay from the normal's primal
        p_bar, g_bar, pc_bar, light_bar = _replay(plan, cfg, tables, p, g,
                                                  cidx, smask, g_out)

        if cfg.normal_mode == "analytic" and fused:
            # 2. the chain on the fused field, reduced onto base rows
            hess_p_bar, hess_pos, hess_aux = fused_winner_hessian_chain(
                plan, tables, widx0, g0, g_bar, sd0)
            p_bar = p_bar + hess_p_bar
        elif cfg.normal_mode == "analytic":
            # 2. the analytic normal's chain: the winner's Hessian
            hess_p_bar, rows, hidx = winner_hessian_chain(
                plan, tables, widx0, g0, g_bar, sd0)
            p_bar = p_bar + hess_p_bar
        else:
            # 2. FD chain: the stencil rows' cotangents reach p through g
            u_fd = fd_stencil_cotangents(cfg, g_bar)             # [6, R]
            p_bar = p_bar + (u_fd[..., None] * g7[1:]).sum(dim=0)

        # 3. implicit-function route at the hit
        t_bar = torch.where(conv, dot3(p_bar, dirs),
                            torch.zeros((), device=p.device))
        w = ift_ray_weights(t_bar, dot3(g0, dirs), cfg.ift_damping)
        gp = p_bar + w[:, None] * g0

        # 4. the parameter scatters: FD, one over all 7 stencil rows;
        # analytic, one over the winner rows and one of the Hessian rows
        if cfg.normal_mode == "analytic" and fused:
            pos_bar, aux_bar = fused_theta_cotangents(plan, tables, widx0,
                                                      g0, w, sd0, p)
            pos_bar, aux_bar = pos_bar + hess_pos, aux_bar + hess_aux
        elif cfg.normal_mode == "analytic":
            pos_bar, aux_bar = theta_cotangents(plan, tables, widx0, g0, w)
            pos_bar = pos_bar + segment_add(hidx, rows, P)
        else:
            pos_bar, aux_bar = theta_cotangents(
                plan, tables, widx7, g7, torch.cat([w[None], u_fd]))

        o_bar = gp if ctx.origin_dim == 2 else gp.sum(dim=0)
        d_bar = t[:, None] * gp
        grads = SceneTables(
            prim_pos=pos_bar, prim_aux=aux_bar, prim_color=pc_bar,
            light_pos=light_bar, light_color=None, cam_position=None,
            cam_direction=None, cam_up=None, cam_fov=None)
        return (None, None, o_bar, d_bar, *grads)


def _fused_fd_bwd(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                  p: torch.Tensor, conv: torch.Tensor, cidx: torch.Tensor,
                  smask: torch.Tensor, dirs: torch.Tensor,
                  g_out: torch.Tensor) -> tuple:
    """The fused FD backward (pallas_render._fused_bwd with fused
    generators and FD normals): autograd through the Lambert replay of
    normalize(normal_fd(scene_sd_fused)) at the hits with the forward's
    shadow bits, then the implicit-function route through scene_sd_fused
    at the hits.  -> (p_bar [R, 3], p_bar + w grad f [R, 3], SceneTables
    of cotangents)."""
    L = plan.num_lights
    color_p = gather_rows(cidx, tables.prim_color)
    with torch.enable_grad():
        pos = tables.prim_pos.detach().requires_grad_()
        aux = tables.prim_aux.detach().requires_grad_()
        lp = tables.light_pos[:L].detach().requires_grad_()
        p_ = p.detach().requires_grad_()
        col_ = color_p.detach().requires_grad_()
        tb = tables._replace(prim_pos=pos, prim_aux=aux)
        n = normalize(normal_fd(lambda q: scene_sd_fused(plan, tb, q), p_,
                                cfg.fd_h))
        shade = lambert_replay(lp, p_, n, smask, cfg.saturation)[:, None] * col_
        pos_bar, aux_bar, lp_bar, p_bar, color_bar = torch.autograd.grad(
            shade, (pos, aux, lp, p_, col_), g_out, allow_unused=True,
            materialize_grads=True)
    # the implicit-function route: grad_p f and the parameters' f_theta
    t_bar = torch.where(conv, dot3(p_bar, dirs),
                        torch.zeros((), device=p.device))
    grad_p, w, pos2_bar, aux2_bar = fused_ift(plan, cfg, tables, p, dirs,
                                              t_bar)
    light_bar = torch.zeros_like(tables.light_pos)
    light_bar[:L] = lp_bar
    grads = SceneTables(
        prim_pos=pos_bar + pos2_bar, prim_aux=aux_bar + aux2_bar,
        prim_color=segment_add(cidx, color_bar, tables.prim_color.shape[0]),
        light_pos=light_bar, light_color=None, cam_position=None,
        cam_direction=None, cam_up=None, cam_fov=None)
    return p_bar, p_bar + w[:, None] * grad_p, grads


def _replay(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
            p: torch.Tensor, g: torch.Tensor, cidx: torch.Tensor,
            smask: torch.Tensor, g_out: torch.Tensor) -> tuple:
    """Autograd through the Lambert term of ``normalize(g)`` at the hits,
    with the forward's shadow bits, times the winner colour ->
    (p_bar [R, 3], g_bar [R, 3], prim_color cotangent [P, 3], light_pos
    cotangent).  The colour gather stays outside autograd, so its
    cotangent is one row scatter."""
    L = plan.num_lights
    color_p = gather_rows(cidx, tables.prim_color)
    with torch.enable_grad():
        lp = tables.light_pos[:L].detach().requires_grad_()
        p_ = p.detach().requires_grad_()
        g_ = g.detach().requires_grad_()
        col_ = color_p.detach().requires_grad_()
        light = lambert_replay(lp, p_, normalize(g_), smask, cfg.saturation)
        shade = light[:, None] * col_
        # with no lights, nothing but the colour reaches the shade
        lp_bar, p_bar, g_bar, color_bar = torch.autograd.grad(
            shade, (lp, p_, g_, col_), g_out, allow_unused=True,
            materialize_grads=True)
    pc_bar = segment_add(cidx, color_bar, tables.prim_color.shape[0])
    light_bar = torch.zeros_like(tables.light_pos)
    light_bar[:L] = lp_bar
    return p_bar, g_bar, pc_bar, light_bar
