"""The differentiable fused render: K1 forward, winner-algebra backward
(with mirror bounces, an anchored replay of the bounce chain).

Counterpart of ``raymarching_tpu.ops.pallas_render.fused_render_op`` with
its ``_fused_fwd``, ``_exact_fd_bwd``, ``_exact_analytic_bwd`` and
``_fused_analytic_bwd`` rules and the fused-generator FD branch of
``_fused_bwd``, for the training configurations on exact tables and with
fused generators (FD or analytic normals), with the shading extensions:
coloured lights, soft shadows and ambient occlusion.  The forward saves
K1's penumbra and occlusion factors (``shade_kernel.Factors``), and every
backward's Lambert replay reapplies them as constants with the shadow
bits, as JAX's ``_lambert_replay`` does; with coloured lights
``light_color`` gets its cotangent from the same replay.

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

Procedural fractal leaves (``plan.proc``) take the FD backward above on
exact tables, the stencil rows' scatter carrying the fractals' size
columns; with analytic normals, or with fused generators, the normal is
replayed under autograd as in the fused FD backward (``_replay_bwd``; the
forward saves no winner residuals: a fractal winner has no closed-form
Hessian), on exact tables with the implicit-function route through K2's
combined mode, one launch a slice of ``REPLAY_RAYS`` rays.

With mirror bounces (``cfg.reflect_strength > 0``) the forward launches
K1's bounce entry, saves each bounce's hit, convergence, colour winner,
shadow bits and factors, and the backward is ``reflect_bwd``
(``_reflect_bwd`` with ``_anchored_hit``): autograd through a plain
PyTorch replay of the whole bounce chain, each march an ``AnchoredHit``
at its saved hit, no kernel launch.

Camera gradients flow on from ``origin``/``dirs`` through
``core.camera.generate_rays`` (or ``generate_rays_dof``) under ordinary
autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import RenderConfig
from ..scene.compile import ScenePlan, SceneTables

from ..core.march import dot3
from ..core.sdf import require_kernel_form, scene_sd, scene_sd_fused
from ..core.shading import (lambert_replay, normal_analytic, normal_fd,
                            normalize)
from ..utils.timing import span
from .march_op import fused_ift
from .render_kernel import blend, render_rays
from .shade_kernel import bounce_count
from .surface_kernel import stencil_points
from .scene_vjp import (REPLAY_RAYS, fd_stencil_cotangents,
                        fused_theta_cotangents, fused_winner_eval,
                        fused_winner_hessian_chain, gather_rows,
                        ift_ray_weights, replay_slice, segment_add,
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
        B = bounce_count(cfg)
        # (pallas_render._save_winner_engaged: a procedural winner's
        # normal has no closed-form Hessian, so its backward replays)
        save = (cfg.normal_mode == "analytic" and SAVE_WINNER and not B
                and not plan.proc)
        res = render_rays(plan, cfg, tables, origin, dirs, save_winner=save,
                          save_factors=True)
        out, *extras = res
        winner = extras[0] if save else ()
        bounces = extras.pop() if B else ()
        factors = extras[-1]
        colors = blend(out.cidx, out.light, tables.prim_color, bounces,
                       cfg.reflect_strength)
        t = dot3(out.p - origin, dirs) / dot3(dirs, dirs)
        ctx.plan, ctx.cfg = plan, cfg
        ctx.origin_dim = origin.dim()
        ctx.n_winner = len(winner)
        ctx.factors = tuple(f is not None for f in factors)
        # each bounce's anchors: hit, convergence, colour winner, shadow
        # bits and factors (pallas_render._reflect_bwd's)
        anchors = [v for b in bounces for v in (b.p, b.done, b.cidx,
                                                b.smask, b.sfac, b.aofac)
                   if v is not None]
        ctx.save_for_backward(out.p, out.done, out.cidx, out.smask, t, dirs,
                              *winner, *(f for f in factors if f is not None),
                              *((origin, *anchors) if B else ()), *fields)
        return colors

    @staticmethod
    def backward(ctx, g_out):
        with span("rt.bwd"):
            plan, cfg = ctx.plan, ctx.cfg
            if cfg.fused_generators:
                require_kernel_form(plan)   # a deep plan's fused backward
            p, conv, cidx, smask, t, dirs, *rest = ctx.saved_tensors
            winner, rest = rest[:ctx.n_winner], rest[ctx.n_winner:]
            soft, ao = ctx.factors
            sfac = rest.pop(0) if soft else None
            aofac = rest.pop(0) if ao else None
            shadow = Shadow(smask, sfac, aofac)
            if bounce_count(cfg):
                origin = rest.pop(0)
                anchors = [Anchor(p, conv, cidx, shadow)]
                for _ in range(bounce_count(cfg)):
                    p_b, conv_b, cidx_b, smask_b = rest[:4]
                    del rest[:4]
                    anchors.append(Anchor(p_b, conv_b, cidx_b, Shadow(
                        smask_b, rest.pop(0) if soft else None,
                        rest.pop(0) if ao else None)))
                o_bar, d_bar, grads = reflect_bwd(
                    plan, cfg, SceneTables(*rest), origin, dirs, anchors,
                    g_out)
                return (None, None, o_bar, d_bar, *grads)
            tables = SceneTables(*rest)
            P = tables.prim_color.shape[0]
            fused = cfg.fused_generators
            analytic = cfg.normal_mode == "analytic"
            if (fused and not analytic) or (analytic and plan.proc):
                with span("rt.bwd.replay"):
                    gp, grads = _replay_bwd(plan, cfg, tables, p, conv, cidx,
                                            shadow, dirs, g_out)
                o_bar = gp if ctx.origin_dim == 2 else gp.sum(dim=0)
                return (None, None, o_bar, t[:, None] * gp, *grads)
            if cfg.normal_mode == "analytic":
                # the forward's residuals, else one K2 launch at the hits
                sd0, widx0, g0 = winner or (fused_winner_eval if fused else
                                            winner_eval)(plan, tables, p)
                g = g0
            else:
                sd7, widx7, g7 = stencil_eval(plan, cfg, tables, p,
                                              center=True)
                inv = 1.0 / (2.0 * cfg.fd_h)
                g = torch.stack([(sd7[1 + a] - sd7[4 + a]) * inv
                                 for a in range(3)], dim=-1)
                g0 = g7[0]

            # 1. shading replay from the normal's primal
            with span("rt.bwd.replay"):
                p_bar, g_bar, pc_bar, light_bar, lc_bar = _replay(
                    plan, cfg, tables, p, g, cidx, shadow, g_out)

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
            with span("rt.bwd.scatter"):
                if cfg.normal_mode == "analytic" and fused:
                    pos_bar, aux_bar = fused_theta_cotangents(
                        plan, tables, widx0, g0, w, sd0, p)
                    pos_bar, aux_bar = pos_bar + hess_pos, aux_bar + hess_aux
                elif cfg.normal_mode == "analytic":
                    pos_bar, aux_bar = theta_cotangents(plan, tables, widx0,
                                                        g0, w)
                    pos_bar = pos_bar + segment_add(hidx, rows, P)
                else:
                    # a fractal leaf's size cotangent needs the stencil SDs
                    # and points (scene_vjp.theta_cotangents)
                    pos_bar, aux_bar = theta_cotangents(
                        plan, tables, widx7, g7, torch.cat([w[None], u_fd]),
                        *((sd7, stencil_points(p, cfg.fd_h, center=True))
                          if plan.proc else ()))

            o_bar = gp if ctx.origin_dim == 2 else gp.sum(dim=0)
            d_bar = t[:, None] * gp
            grads = SceneTables(
                prim_pos=pos_bar, prim_aux=aux_bar, prim_color=pc_bar,
                light_pos=light_bar, light_color=lc_bar, cam_position=None,
                cam_direction=None, cam_up=None, cam_fov=None)
            return (None, None, o_bar, d_bar, *grads)



class Anchor(NamedTuple):
    """One march of the bounce chain as the forward saw it: its hit (the
    AnchoredHit primal) and convergence, its colour winner and its
    shadow decisions."""

    p: torch.Tensor
    done: torch.Tensor
    cidx: torch.Tensor
    shadow: "Shadow"


class AnchoredHit(torch.autograd.Function):
    """p = AnchoredHit.apply(plan, cfg, tables, p_saved, done, o, d, pos,
    aux): "march from (o, d) to the surface", anchored at a kernel-saved
    hit (pallas_render._anchored_hit).  The forward returns the saved hit;
    the backward applies the implicit-function rule there: t* solves
    f(o + t* d) = eps, so dt* / d(theta, o, d) flows through grad f at the
    hit (``ift_ray_weights``, damped by cfg.ift_damping), evaluated by
    autograd through ``core.sdf.scene_sd`` (``scene_sd_fused`` with fused
    generators).  Unconverged rays carry no t-cotangent; their p_bar still
    reaches the origin.  ``pos`` and ``aux`` are the tables' prim_pos and
    prim_aux, the fields the field reads."""

    @staticmethod
    def forward(ctx, plan, cfg, tables, p_saved, done, o, d, pos, aux):
        ctx.plan, ctx.cfg, ctx.tables = plan, cfg, tables
        ctx.save_for_backward(p_saved, done, o, d, pos, aux)
        return p_saved.clone()

    @staticmethod
    def backward(ctx, p_bar):
        p, done, o, d, pos, aux = ctx.saved_tensors
        sdf = scene_sd_fused if ctx.cfg.fused_generators else scene_sd
        with torch.enable_grad():
            pos_ = pos.detach().requires_grad_()
            aux_ = aux.detach().requires_grad_()
            q = p.detach().requires_grad_()
            f = sdf(ctx.plan, ctx.tables._replace(prim_pos=pos_,
                                                  prim_aux=aux_), q)
            (grad_p,) = torch.autograd.grad(f, q, torch.ones_like(f),
                                            retain_graph=True)
            t_bar = torch.where(done, dot3(p_bar, d),
                                torch.zeros((), device=p.device))
            w = ift_ray_weights(t_bar, dot3(grad_p, d), ctx.cfg.ift_damping)
            pos_bar, aux_bar = torch.autograd.grad(f, (pos_, aux_), w,
                                                   materialize_grads=True)
        t = dot3(p - o, d) / dot3(d, d)
        adj = p_bar + w[:, None] * grad_p
        return (None, None, None, None, None, adj, t[:, None] * adj,
                pos_bar, aux_bar)


def reflect_bwd(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                origin: torch.Tensor, dirs: torch.Tensor, anchors: list,
                g_out: torch.Tensor) -> tuple:
    """The backward of a render with mirror bounces
    (pallas_render._reflect_bwd): autograd through a replay of the whole
    bounce chain (core.render.shade_rays' recursion) with every march an
    ``AnchoredHit`` at the forward's hit.  The normals are
    ``normal_fd`` of the field, or ``normal_analytic`` with a graph, so
    the second-order terms through the reflected direction d - 2 (d . n) n
    are in; the light is ``lambert_replay`` with the saved shadow
    decisions; the colours are gathered at the saved winners.  Plain
    PyTorch (JAX's replay is plain jnp): no kernel launch.  The rays are
    replayed ``REPLAY_RAYS`` at a time.  -> (origin cotangent, dirs
    cotangent, SceneTables of cotangents)."""
    sdf = scene_sd_fused if cfg.fused_generators else scene_sd
    s = cfg.reflect_strength
    off = cfg.surface_precision + cfg.offset_precision
    L, R = plan.num_lights, dirs.shape[0]
    per_ray = origin.dim() == 2
    o_bar = torch.zeros_like(origin)
    d_bar = torch.empty_like(dirs)
    sums = None

    def lit(v):
        return v[:, None] if v.dim() == 1 else v

    for lo in range(0, R, REPLAY_RAYS):
        sl = slice(lo, lo + REPLAY_RAYS)
        with torch.enable_grad():
            pos = tables.prim_pos.detach().requires_grad_()
            aux = tables.prim_aux.detach().requires_grad_()
            colr = tables.prim_color.detach().requires_grad_()
            lp, lc = _light_leaves(plan, tables)
            tb = tables._replace(prim_pos=pos, prim_aux=aux)
            o0 = (origin[sl] if per_ray else origin).detach().requires_grad_()
            d0 = dirs[sl].detach().requires_grad_()
            o, d = o0.expand(d0.shape), d0
            cols, lits = [], []
            for b, a in enumerate(anchors):
                ph = AnchoredHit.apply(plan, cfg, tables, a.p[sl], a.done[sl],
                                       o, d, pos, aux)
                sd_one = lambda q: sdf(plan, tb, q)  # noqa: E731
                g = (normal_analytic(sd_one, ph, graph=True)
                     if cfg.normal_mode == "analytic"
                     else normal_fd(sd_one, ph, cfg.fd_h))
                n = normalize(g)
                sh = a.shadow.rows(sl)
                lits.append(lit(lambert_replay(
                    lp, ph, n, sh.smask, cfg.saturation, sh.sfac, sh.aofac,
                    lc)))
                cols.append(gather_rows(a.cidx[sl], colr))
                if b + 1 < len(anchors):
                    d = d - 2.0 * dot3(d, n)[:, None] * n
                    o = ph + off * n
            c = lits[-1] * cols[-1]
            for b in reversed(range(len(anchors) - 1)):
                c = cols[b] * ((1.0 - s) * lits[b] + s * c)
            leaves = (pos, aux, colr, lp, o0, d0) + (
                (lc,) if lc is not None else ())
            got = torch.autograd.grad(c, leaves, g_out[sl],
                                      allow_unused=True,
                                      materialize_grads=True)
        pos_b, aux_b, col_b, lp_b, ob, db, *lc_b = got
        if per_ray:
            o_bar[sl] = ob
        else:
            o_bar += ob
        d_bar[sl] = db
        part = (pos_b, aux_b, col_b, lp_b, *lc_b)
        sums = part if sums is None else tuple(
            a + b for a, b in zip(sums, part))
    if sums is None:                    # no rays
        sums = tuple(torch.zeros_like(v) for v in (
            tables.prim_pos, tables.prim_aux, tables.prim_color,
            tables.light_pos[:L], *((tables.light_color[:L],)
                                    if plan.colored_lights else ())))
    pos_bar, aux_bar, pc_bar, lp_bar, *lc_bar = sums
    light_bar, lcolor_bar = _light_cotangents(tables, L, lp_bar,
                                              lc_bar[0] if lc_bar else None)
    grads = SceneTables(
        prim_pos=pos_bar, prim_aux=aux_bar, prim_color=pc_bar,
        light_pos=light_bar, light_color=lcolor_bar, cam_position=None,
        cam_direction=None, cam_up=None, cam_fov=None)
    return o_bar, d_bar, grads


class Shadow(NamedTuple):
    """The forward's stop-gradient shading decisions that the replay
    reapplies: the shadow bits, and the penumbra and occlusion factors
    when those extensions are on."""

    smask: torch.Tensor
    sfac: Optional[torch.Tensor]   # [L, R] or None
    aofac: Optional[torch.Tensor]  # [R] or None

    def rows(self, sl: slice) -> "Shadow":
        """The decisions of the rays in ``sl``."""
        return Shadow(self.smask[sl],
                      None if self.sfac is None else self.sfac[:, sl],
                      None if self.aofac is None else self.aofac[sl])


def _light_leaves(plan: ScenePlan, tables: SceneTables) -> tuple:
    """Leaf copies of the real lights' positions and, with coloured
    lights, colours (else None), for a replay under autograd."""
    L = plan.num_lights
    lp = tables.light_pos[:L].detach().requires_grad_()
    lc = (tables.light_color[:L].detach().requires_grad_()
          if plan.colored_lights else None)
    return lp, lc


def _shade(cfg: RenderConfig, lp, lc, p_, n, shadow: Shadow,
           col_) -> torch.Tensor:
    """The replayed shade [R, 3]: the Lambert term times the colour."""
    light = lambert_replay(lp, p_, n, shadow.smask, cfg.saturation,
                           shadow.sfac, shadow.aofac, lc)
    return (light if lc is not None else light[:, None]) * col_


def _light_cotangents(tables: SceneTables, L: int, lp_bar, lc_bar) -> tuple:
    """(light_pos, light_color) cotangents on the tables' rows from those
    of the L real lights; light_color's is None without coloured lights."""
    light_bar = torch.zeros_like(tables.light_pos)
    light_bar[:L] = lp_bar
    if lc_bar is None:
        return light_bar, None
    color_bar = torch.zeros_like(tables.light_color)
    color_bar[:L] = lc_bar
    return light_bar, color_bar


def _replay_bwd(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                p: torch.Tensor, conv: torch.Tensor, cidx: torch.Tensor,
                shadow: Shadow, dirs: torch.Tensor,
                g_out: torch.Tensor) -> tuple:
    """The backward that replays the normal under autograd (pallas_render
    ._fused_bwd's fall-through): with fused generators and FD normals, and
    with analytic normals on a plan with procedural leaves (whose winner
    has no closed-form Hessian).  Autograd through the Lambert replay of
    normalize(normal) at the hits, the normal ``normal_fd`` of the field or
    ``normal_analytic`` with a graph, the field ``scene_sd_fused`` with
    fused generators else ``scene_sd``, with the forward's shadow
    decisions; then the implicit-function route at the hits: on the fused
    field by autograd (``march_op.fused_ift``), on exact tables by K2's
    combined mode and the winner scatter with its procedural columns
    (scene_vjp.ift_pieces).  ``scene_vjp.replay_slice`` rays a slice.  ->
    (p_bar + w grad f [R, 3], SceneTables of cotangents)."""
    L, R = plan.num_lights, p.shape[0]
    sdf = scene_sd_fused if cfg.fused_generators else scene_sd
    color_p = gather_rows(cidx, tables.prim_color)
    gp = torch.empty_like(p)
    color_bar = torch.empty_like(color_p)
    sums = None
    n = replay_slice(plan, R)
    for lo in range(0, R, n):
        sl = slice(lo, lo + n)
        with torch.enable_grad():
            pos = tables.prim_pos.detach().requires_grad_()
            aux = tables.prim_aux.detach().requires_grad_()
            lp, lc = _light_leaves(plan, tables)
            p_ = p[sl].detach().requires_grad_()
            col_ = color_p[sl].detach().requires_grad_()
            tb = tables._replace(prim_pos=pos, prim_aux=aux)
            sd_one = lambda q: sdf(plan, tb, q)  # noqa: E731
            g = (normal_analytic(sd_one, p_, graph=True)
                 if cfg.normal_mode == "analytic"
                 else normal_fd(sd_one, p_, cfg.fd_h))
            shade = _shade(cfg, lp, lc, p_, normalize(g), shadow.rows(sl),
                           col_)
            leaves = (pos, aux, lp, p_, col_) + ((lc,) if lc is not None
                                                 else ())
            pos_b, aux_b, lp_b, p_bar, color_bar[sl], *lc_b = (
                torch.autograd.grad(shade, leaves, g_out[sl],
                                    allow_unused=True,
                                    materialize_grads=True))
        t_bar = torch.where(conv[sl], dot3(p_bar, dirs[sl]),
                            torch.zeros((), device=p.device))
        if cfg.fused_generators:
            grad_p, w, pos2_b, aux2_b = fused_ift(plan, cfg, tables, p[sl],
                                                  dirs[sl], t_bar)
        else:
            sd0, widx0, grad_p = winner_eval(plan, tables, p[sl])
            w = ift_ray_weights(t_bar, dot3(grad_p, dirs[sl]),
                                cfg.ift_damping)
            pos2_b, aux2_b = theta_cotangents(plan, tables, widx0, grad_p, w,
                                              sd0, p[sl])
        gp[sl] = p_bar + w[:, None] * grad_p
        part = (pos_b + pos2_b, aux_b + aux2_b, lp_b, *lc_b)
        sums = part if sums is None else tuple(
            a + b for a, b in zip(sums, part))
    if sums is None:                    # no rays
        sums = tuple(torch.zeros_like(v) for v in (
            tables.prim_pos, tables.prim_aux, tables.light_pos[:L],
            *((tables.light_color[:L],) if plan.colored_lights else ())))
    pos_bar, aux_bar, lp_bar, *lc_bar = sums
    light_bar, lcolor_bar = _light_cotangents(tables, L, lp_bar,
                                              lc_bar[0] if lc_bar else None)
    grads = SceneTables(
        prim_pos=pos_bar, prim_aux=aux_bar,
        prim_color=segment_add(cidx, color_bar, tables.prim_color.shape[0]),
        light_pos=light_bar, light_color=lcolor_bar, cam_position=None,
        cam_direction=None, cam_up=None, cam_fov=None)
    return gp, grads


def _replay(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
            p: torch.Tensor, g: torch.Tensor, cidx: torch.Tensor,
            shadow: Shadow, g_out: torch.Tensor) -> tuple:
    """Autograd through the Lambert term of ``normalize(g)`` at the hits,
    with the forward's shadow decisions, times the winner colour ->
    (p_bar [R, 3], g_bar [R, 3], prim_color cotangent [P, 3], light_pos
    cotangent, light_color cotangent or None without coloured lights).
    The colour gather stays outside autograd, so its cotangent is one row
    scatter."""
    L = plan.num_lights
    color_p = gather_rows(cidx, tables.prim_color)
    with torch.enable_grad():
        lp, lc = _light_leaves(plan, tables)
        p_ = p.detach().requires_grad_()
        g_ = g.detach().requires_grad_()
        col_ = color_p.detach().requires_grad_()
        shade = _shade(cfg, lp, lc, p_, normalize(g_), shadow, col_)
        # with no lights, nothing but the colour reaches the shade
        leaves = (lp, p_, g_, col_) + ((lc,) if lc is not None else ())
        lp_bar, p_bar, g_bar, color_bar, *lc_bar = torch.autograd.grad(
            shade, leaves, g_out, allow_unused=True, materialize_grads=True)
    pc_bar = segment_add(cidx, color_bar, tables.prim_color.shape[0])
    light_bar, lcolor_bar = _light_cotangents(tables, L, lp_bar,
                                              lc_bar[0] if lc_bar else None)
    return p_bar, g_bar, pc_bar, light_bar, lcolor_bar
