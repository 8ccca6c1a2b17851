"""The reference's fit step: render, mean squared error, gradients, Adam.

The gradient is the implicit-function one of a sphere-traced image: the hit
point is a root of f(o + t d; theta) = c, so

    dt/dtheta = -f_theta / (grad f . d),  dt/do = -grad f / (grad f . d),
    dt/dd = -t grad f / (grad f . d),

held at zero for a ray that did not converge, with |grad f . d| floored at
1e-6.  The field's value at a point is its winning leaf's distance (with the
sign it enters the fold with), so f, the six stencil values of the normal
and their gradients are those of the winning leaves.  The shadow tests and
the winners are taken from the forward, in the forward's precision, and
held constant; the colour is the colour winner's row.  The replay that
autograd differentiates computes in the forward's precision, so its image
is the forward's bit for bit, but it reads the winners' rows from copies of
the tables in ``sum_dtype`` (float64 by default): their gradients are summed
there, where the stencil's +-1/(2h) terms cancel without a float32 sum's
error, and land on the float32 parameters.

Adam is written out (torch.optim.Adam's update, betas (0.9, 0.999), eps
1e-8); a field that receives no gradient is not stepped.
"""

from __future__ import annotations

import torch

from .field import Field, winner_distance
from .render import (Settings, camera_dirs, dot3, normalize, shade)
from .scene import TABLE_FIELDS, Scene

DENOM_EPS = 1e-6
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _winner_sd(scene_t, ptype, w, s, p):
    return s * winner_distance(ptype[w], scene_t["prim_pos"][w].to(p.dtype),
                               scene_t["prim_aux"][w].to(p.dtype), p)


def loss_and_grad(scene: Scene, params: dict, target, st: Settings, *,
                  dtype=torch.float32, sum_dtype=torch.float64,
                  rows_per_chunk: int = 512):
    """Mean squared error of the render of ``params`` (float32 tensors
    that require grad, by table name) against ``target`` [H, W, 3]; the
    gradients accumulate in each parameter's ``.grad``.  Returns the loss
    as a Python float."""
    dev = target.device
    H, W = st.height, st.width
    fwd = {k: v.detach().to(dtype) for k, v in params.items()}
    field = Field(scene, dev, dtype, tables=fwd)
    ptype = field.ptype
    total = 0.0
    f = dict(dtype=dtype, device=dev)
    for r0 in range(0, H, rows_per_chunk):
        rows = min(rows_per_chunk, H - r0)
        py = (float(r0) + torch.arange(rows, **f))[:, None].expand(
            rows, W).reshape(-1)
        px = torch.arange(W, **f)[None, :].expand(rows, W).reshape(-1)
        with torch.no_grad():
            dirs = camera_dirs(fwd["cam_position"], fwd["cam_direction"],
                               fwd["cam_up"], fwd["cam_fov"], st, py, px)
            S = dirs.shape[1]
            r = shade(field, fwd, st, fwd["cam_position"],
                      dirs.reshape(-1, 3), keep=True)
        P = {k: v.to(dtype) for k, v in params.items()}
        S64 = {k: params[k].to(sum_dtype)
               for k in ("prim_pos", "prim_aux", "prim_color")}
        d = camera_dirs(P["cam_position"], P["cam_direction"], P["cam_up"],
                        P["cam_fov"], st, py, px).reshape(-1, 3)
        o = P["cam_position"]
        dc = d.detach()
        q = r.hit.position
        t0 = dot3(q - o.detach(), dc) / dot3(dc, dc)
        wh, sh = r.hit_winner
        with torch.enable_grad():
            qq = q.clone().requires_grad_()
            fw = _winner_sd({k: v.detach() for k, v in S64.items()}, ptype,
                            wh, sh, qq)
            (g,) = torch.autograd.grad(fw.sum(), qq)
        f_theta = _winner_sd(S64, ptype, wh, sh, q)
        denom = dot3(g, dc)
        denom = torch.where(denom.abs() < DENOM_EPS,
                            torch.where(denom < 0, -DENOM_EPS, DENOM_EPS),
                            denom)
        delta_o = (o - o.detach()).expand(d.shape)
        delta_d = d - dc
        f_lin = (f_theta - f_theta.detach()) + dot3(
            g, delta_o + t0[:, None] * delta_d)
        tau = torch.where(r.hit.converged, -f_lin / denom,
                          torch.zeros((), dtype=dtype, device=dev))
        p = q + delta_o + t0[:, None] * delta_d + dc * tau[:, None]
        eye = torch.eye(3, dtype=dtype, device=dev) * st.fd_h
        cols = []
        for a in range(3):
            (wp, sp), (wm, sm) = r.stencil[2 * a], r.stencil[2 * a + 1]
            cols.append(_winner_sd(S64, ptype, wp, sp, p + eye[a])
                        - _winner_sd(S64, ptype, wm, sm, p - eye[a]))
        n = normalize(torch.stack(cols, dim=-1) / (2.0 * st.fd_h))
        light = torch.zeros(p.shape[0], dtype=dtype, device=dev)
        for li, mask in enumerate(r.shadow):
            lam = dot3(n, normalize(P["light_pos"][li] - p))
            light = light + torch.where(mask, 0.0, lam)
        lo = torch.tensor(st.saturation, dtype=dtype, device=dev)
        hi = torch.tensor(1.0, dtype=dtype, device=dev)
        light = torch.minimum(torch.maximum(light, lo), hi)
        color = light[:, None] * S64["prim_color"][r.cidx].to(dtype)
        pix = color.reshape(rows, W, S, 3).mean(dim=2)
        err = (pix - target[r0:r0 + rows].to(dtype)).to(sum_dtype)
        loss = (err * err).sum() / (H * W * 3)
        loss.backward()
        total += float(loss.detach())
    return total


def adam_step(params: dict, state: dict, lr: float, step: int) -> None:
    """One Adam update (step counts from 1) of every parameter that has a
    gradient."""
    b1, b2 = BETAS
    with torch.no_grad():
        for k, p in params.items():
            if p.grad is None:
                continue
            g = p.grad
            m, v = state.setdefault(k, (torch.zeros_like(p),
                                        torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            denom = (v.sqrt() / bc2 ** 0.5).add_(ADAM_EPS)
            p.addcdiv_(m, denom, value=-lr / bc1)


def fit(scene: Scene, start: dict, target, st: Settings, *, steps: int,
        lr: float, dtype=torch.float32, sum_dtype=torch.float64,
        rows_per_chunk: int = 512) -> dict:
    """``steps`` steps of the fit from tables ``start`` (arrays by name):
    the loss of each step, the first step's gradient of each field
    (None where it had none) and the fields after the last step."""
    dev = target.device
    params = {k: torch.as_tensor(start[k], device=dev).float().clone()
              .requires_grad_() for k in TABLE_FIELDS}
    state, losses, grad0 = {}, [], None
    for i in range(steps):
        for p in params.values():
            p.grad = None
        losses.append(loss_and_grad(scene, params, target, st, dtype=dtype,
                                    sum_dtype=sum_dtype,
                                    rows_per_chunk=rows_per_chunk))
        if i == 0:
            grad0 = {k: (None if p.grad is None else p.grad.detach().clone())
                     for k, p in params.items()}
        adam_step(params, state, lr, i + 1)
    return {"losses": losses, "grad0": grad0,
            "theta": {k: p.detach().clone() for k, p in params.items()}}
