"""Sphere-tracing march in plain PyTorch.

Port of ``raymarching_tpu.core.march`` (scene.cpp:34-42): up to
``iterations`` steps of ``sd = SDF(p); p += min(sd, MAX_STEP) * ray``,
converged once ``sd < eps`` — the position update comes before the check,
so the hit point carries one final sub-epsilon step and ``sd`` is the value
one step back.  A done ray is frozen, so each ray's trajectory is the one
the reference's per-ray loop gives.  Two drivers, the same arithmetic per
ray:

  * the early-exit march (``march``'s default): eager PyTorch gathers the
    rays still marching before every step and stops once none is left;
  * the fixed-iteration march (``march_scan``): every ray every step, the
    done ones frozen by ``torch.where`` masks in the order of JAX's
    ``_march_step``, so autograd can differentiate it (the unrolled CPU
    autodiff oracle); its chunks of ``REMAT_CHUNK`` steps run under
    ``torch.utils.checkpoint``, so the backward keeps one carry a chunk.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

# Step clamp: no bounded scene's SDF comes near it, so trajectories are
# unchanged; an unbounded or empty scene takes finite steps instead of inf.
MAX_STEP = 1e5
# Steps of the fixed-iteration march run under one checkpoint (JAX's
# march_scan remat_chunk): the backward keeps one carry per chunk.
REMAT_CHUNK = 50


class MarchResult(NamedTuple):
    position: torch.Tensor   # [N, 3] endpoint (includes the final step)
    sd: torch.Tensor         # [N] last evaluated SD (at position - sd*ray)
    converged: torch.Tensor  # [N] bool


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot of [N, 3] tensors, summed (x + y) + z as the kernels
    sum it."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def march(sd_fn: Callable, origin: torch.Tensor, ray: torch.Tensor,
          iterations: int, eps: float, *, differentiable: bool = False,
          tmax: Optional[torch.Tensor] = None,
          init_done: Optional[torch.Tensor] = None,
          project_t: bool = False, with_steps: bool = False,
          soft_k: Optional[float] = None):
    """March rays ``ray`` [N, 3] from ``origin`` [3] or [N, 3].

    ``differentiable``: the fixed-iteration ``march_scan``, which autograd
    differentiates; else the early-exit march (core.march.march).  Both
    give every ray the same bits.

    ``tmax`` [N]: also stop once the ray has passed this distance (shadow
    rays stop at the light; exact for the shadow boolean, since the march
    only moves forward).  The distance is the sum of steps, as in the JAX
    oracle, or with ``project_t`` the projection (p - origin) . ray, as in
    the render kernel.  ``init_done`` [N] bool: rays that start done and
    take no step (position = origin, sd = +inf).  ``with_steps``: return
    (MarchResult, steps [N] int32), the scene evaluations each ray took
    (core.march.march_profile).  ``soft_k`` (shadow rays of soft
    shadows, with ``tmax``): return (MarchResult, pen [N]), the penumbra
    tracker min over each ray's steps of clamp(soft_k sd / max(t, eps), 0,
    1) with t the distance before the step (core.shading._soft_step; 1 for
    a ray that takes no step)."""
    if differentiable:
        return march_scan(sd_fn, origin, ray, iterations, eps, tmax=tmax,
                          init_done=init_done, project_t=project_t,
                          with_steps=with_steps, soft_k=soft_k)
    o = origin.expand(ray.shape)
    p = o.clone()
    n = ray.shape[0]
    sd_last = torch.full((n,), float("inf"), dtype=ray.dtype, device=ray.device)
    done = (torch.zeros(n, dtype=torch.bool, device=ray.device)
            if init_done is None else init_done.clone())
    t = torch.zeros(n, dtype=ray.dtype, device=ray.device)
    steps = torch.zeros(n, dtype=torch.int32, device=ray.device)
    pen = (None if soft_k is None else
           torch.ones(n, dtype=ray.dtype, device=ray.device))
    for _ in range(iterations):
        act = (~done).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        pa, ra = p[act], ray[act]
        sd = sd_fn(pa)
        if soft_k is not None:
            t_cur = dot3(pa - o[act], ra) if project_t else t[act]
            ratio = torch.clamp(sd * soft_k / torch.clamp_min(t_cur, eps),
                                0.0, 1.0)
            pen[act] = torch.minimum(pen[act], ratio)
        step = torch.clamp_max(sd, MAX_STEP)
        pa = pa + step[:, None] * ra
        dn = sd < eps
        if tmax is not None:
            if project_t:
                ta = dot3(pa - o[act], ra)
            else:
                ta = t[act] + step
                t[act] = ta
            dn = dn | (ta >= tmax[act])
        p[act] = pa
        sd_last[act] = sd
        done[act] = dn
        if with_steps:
            steps[act] += 1
    return _result(p, sd_last, done, eps, pen, steps if with_steps else None)


def _result(p, sd_last, done, eps, pen, steps):
    res = MarchResult(position=p, sd=sd_last,
                      converged=done & (sd_last < eps))
    if pen is not None:
        return res, pen
    return res if steps is None else (res, steps)


def _masked_step(sd_fn: Callable, o, ray, eps: float, tmax, project_t: bool,
                 soft_k, carry):
    """One step of every ray, the done ones frozen (core.march._march_step,
    with core.shading._soft_step's penumbra tracker): carry (p, sd_last,
    done, t, pen, steps) -> the next."""
    p, sd_last, done, t, pen, steps = carry
    sd = sd_fn(p)
    active = ~done
    if soft_k is not None:
        t_cur = dot3(p - o, ray) if project_t else t
        ratio = torch.clamp(sd * soft_k / torch.clamp_min(t_cur, eps),
                            0.0, 1.0)
        pen = torch.where(active, torch.minimum(pen, ratio), pen)
    step = torch.clamp_max(sd, MAX_STEP)
    p_new = p + step[:, None] * ray
    dn = sd < eps
    if tmax is not None:
        if project_t:
            dn = dn | (dot3(p_new - o, ray) >= tmax)
        else:
            t_new = t + step
            dn = dn | (t_new >= tmax)
            t = torch.where(active, t_new, t)
    p = torch.where(active[:, None], p_new, p)
    sd_last = torch.where(active, sd, sd_last)
    return (p, sd_last, done | dn, t, pen,
            steps + active.to(steps.dtype))


def march_scan(sd_fn: Callable, origin: torch.Tensor, ray: torch.Tensor,
               iterations: int, eps: float, *,
               tmax: Optional[torch.Tensor] = None,
               init_done: Optional[torch.Tensor] = None,
               project_t: bool = False, with_steps: bool = False,
               soft_k: Optional[float] = None):
    """Fixed-iteration march (core.march.march_scan): ``iterations`` steps
    of every ray, a done ray frozen by ``torch.where`` masks, so autograd
    differentiates the whole trajectory (the unrolled CPU autodiff oracle
    the implicit-function backwards are held to).  With grad enabled and
    more than ``REMAT_CHUNK`` iterations, each whole chunk of
    ``REMAT_CHUNK`` steps runs under ``torch.utils.checkpoint``: the
    backward keeps one carry a chunk, not the activations of every step,
    and recomputes a chunk's steps when it reaches them.  Each ray's
    values are bitwise ``march``'s early-exit ones; the options and
    returns are ``march``'s."""
    o = origin.expand(ray.shape)
    n = ray.shape[0]
    f32 = dict(dtype=ray.dtype, device=ray.device)
    carry = (o.clone(), torch.full((n,), float("inf"), **f32),
             (torch.zeros(n, dtype=torch.bool, device=ray.device)
              if init_done is None else init_done.clone()),
             torch.zeros(n, **f32),
             None if soft_k is None else torch.ones(n, **f32),
             torch.zeros(n, dtype=torch.int32, device=ray.device))

    def run(k: int, *c):
        for _ in range(k):
            c = _masked_step(sd_fn, o, ray, eps, tmax, project_t, soft_k, c)
        return c

    done_steps = 0
    if REMAT_CHUNK < iterations and torch.is_grad_enabled():
        for _ in range(iterations // REMAT_CHUNK):
            carry = checkpoint(run, REMAT_CHUNK, *carry, use_reentrant=False,
                               preserve_rng_state=False)
        done_steps = iterations // REMAT_CHUNK * REMAT_CHUNK
    p, sd_last, done, _, pen, steps = run(iterations - done_steps, *carry)
    return _result(p, sd_last, done, eps, pen, steps if with_steps else None)
