"""The differentiable fused render: K1 forward, exact-FD backward with K2.

Counterpart of ``raymarching_tpu.ops.pallas_render.fused_render_op`` with
its ``_fused_fwd`` and ``_exact_fd_bwd`` rules, for the default training
configuration (exact tables, FD normals, hard shadows, white lights).

Forward: K1 over every ray (``render_rays``) with the black-lane shadow
skip off, then the colour blend.  Backward, one K2 launch in all:

  1. ``stencil_eval`` over the 7-point stencil of every hit: the FD normal
     primal from the stencil SDs, and every d scene / dp and winner row.
  2. Autograd through the Lambert replay of ``normalize(gfd)`` times the
     winner colour, with the saved shadow bits; the colour cotangent goes
     onto the colour rows with ``index_add_``.
  3. The FD chain: p_bar += sum of the stencil rows' u_fd * g.
  4. The implicit-function weight w on the hit row, one
     ``theta_cotangents`` scatter over all 7 rows, and the origin and
     direction cotangents.

Camera gradients flow on from ``origin``/``dirs`` through
``core.camera.generate_rays`` under ordinary autograd.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..scene.compile import ScenePlan, SceneTables

from ..core.march import dot3
from ..core.shading import lambert_replay, normalize
from .render_kernel import blend, render_rays, winner_colors
from .scene_vjp import (fd_stencil_cotangents, ift_ray_weights, segment_add,
                        stencil_eval, theta_cotangents)


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
        out = render_rays(plan, cfg, tables, origin, dirs)
        colors = blend(out.cidx, out.light, tables.prim_color)
        t = dot3(out.p - origin, dirs) / dot3(dirs, dirs)
        ctx.plan, ctx.cfg = plan, cfg
        ctx.origin_dim = origin.dim()
        ctx.save_for_backward(out.p, out.done, out.cidx, out.smask, t, dirs,
                              *fields)
        return colors

    @staticmethod
    def backward(ctx, g_out):
        plan, cfg = ctx.plan, ctx.cfg
        p, conv, cidx, smask, t, dirs, *fields = ctx.saved_tensors
        tables = SceneTables(*fields)
        P = tables.prim_color.shape[0]
        L = plan.num_lights
        sd7, widx7, g7 = stencil_eval(plan, cfg, tables, p, center=True)
        inv = 1.0 / (2.0 * cfg.fd_h)
        gfd = torch.stack([(sd7[1 + a] - sd7[4 + a]) * inv
                           for a in range(3)], dim=-1)

        # 1. shading replay from the FD-gradient primal; the colour gather
        # stays outside autograd so its cotangent is one row scatter
        color_p = winner_colors(cidx, tables.prim_color)
        with torch.enable_grad():
            lp = tables.light_pos[:L].detach().requires_grad_()
            p_ = p.detach().requires_grad_()
            gfd_ = gfd.detach().requires_grad_()
            col_ = color_p.detach().requires_grad_()
            light = lambert_replay(lp, p_, normalize(gfd_), smask,
                                   cfg.saturation)
            shade = light[:, None] * col_
            # with no lights, nothing but the colour reaches the shade
            lp_bar, p_bar, gfd_bar, color_bar = torch.autograd.grad(
                shade, (lp, p_, gfd_, col_), g_out, allow_unused=True,
                materialize_grads=True)
        pc_bar = segment_add(cidx, color_bar, P)
        light_bar = torch.zeros_like(tables.light_pos)
        light_bar[:L] = lp_bar

        # 2. FD chain: the stencil rows' cotangents reach p through g
        u_fd = fd_stencil_cotangents(cfg, gfd_bar)               # [6, R]
        p_bar = p_bar + (u_fd[..., None] * g7[1:]).sum(dim=0)

        # 3. implicit-function route at the hit (row 0 of the stencil)
        g0 = g7[0]
        t_bar = torch.where(conv, dot3(p_bar, dirs),
                            torch.zeros((), device=p.device))
        w = ift_ray_weights(t_bar, dot3(g0, dirs), cfg.ift_damping)
        gp = p_bar + w[:, None] * g0

        # 4. one scatter for all 7 rows' parameter cotangents
        pos_bar, aux_bar = theta_cotangents(
            plan, tables, widx7, g7, torch.cat([w[None], u_fd]))

        o_bar = gp if ctx.origin_dim == 2 else gp.sum(dim=0)
        d_bar = t[:, None] * gp
        grads = SceneTables(
            prim_pos=pos_bar, prim_aux=aux_bar, prim_color=pc_bar,
            light_pos=light_bar, light_color=None, cam_position=None,
            cam_direction=None, cam_up=None, cam_fov=None)
        return (None, None, o_bar, d_bar, *grads)
