"""Sphere-tracing march in plain PyTorch.

Port of ``raymarching_tpu.core.march`` (scene.cpp:34-42): up to
``iterations`` steps of ``sd = SDF(p); p += min(sd, MAX_STEP) * ray``,
converged once ``sd < eps`` — the position update comes before the check,
so the hit point carries one final sub-epsilon step and ``sd`` is the value
one step back.  A done ray is frozen, so each ray's trajectory is the one
the reference's per-ray loop gives.  Eager PyTorch gathers the rays still
marching before every step, which changes no ray's arithmetic.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

# Step clamp: no bounded scene's SDF comes near it, so trajectories are
# unchanged; an unbounded or empty scene takes finite steps instead of inf.
MAX_STEP = 1e5


class MarchResult(NamedTuple):
    position: torch.Tensor   # [N, 3] endpoint (includes the final step)
    sd: torch.Tensor         # [N] last evaluated SD (at position - sd*ray)
    converged: torch.Tensor  # [N] bool


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot of [N, 3] tensors, summed (x + y) + z as the kernels
    sum it."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def march(sd_fn: Callable, origin: torch.Tensor, ray: torch.Tensor,
          iterations: int, eps: float, *, tmax: Optional[torch.Tensor] = None,
          init_done: Optional[torch.Tensor] = None,
          project_t: bool = False, with_steps: bool = False,
          soft_k: Optional[float] = None):
    """March rays ``ray`` [N, 3] from ``origin`` [3] or [N, 3].

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
    res = MarchResult(position=p, sd=sd_last,
                      converged=done & (sd_last < eps))
    if soft_k is not None:
        return res, pen
    return (res, steps) if with_steps else res
