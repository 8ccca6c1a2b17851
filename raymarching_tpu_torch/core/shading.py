"""Surface normals, hard shadows and Lambertian multi-light shading.

Port of ``raymarching_tpu.core.shading`` for the reference's shading model
(scene.cpp:45-89): the normal is the normalised 6-point central difference
of the SDF (or, with ``RenderConfig.normal_mode="analytic"``, its exact
gradient by one reverse-mode sweep); a light counts only if a march from
the hit point, lifted off the surface by ``surface_eps + offset_eps``
along the normal, passes the light; the Lambert sum over lights is clamped
to ``[saturation, 1]``.  Soft shadows and ambient occlusion are not ported
yet.  ``shadow_fn`` routes the shadow marches through a kernel
(``api.make_render_hooks``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .march import dot3, march

TINY = torch.finfo(torch.float32).tiny


def fd_stencil(scene_sd: Callable, p: torch.Tensor, h: float) -> torch.Tensor:
    """Unscaled central differences sd(p + h e_a) - sd(p - h e_a): [N, 3]."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device) * h
    return torch.stack([scene_sd(p + eye[a]) - scene_sd(p - eye[a])
                        for a in range(3)], dim=-1)


def normal_fd(scene_sd: Callable, p: torch.Tensor, h: float) -> torch.Tensor:
    """Central-difference SDF gradient (not normalised), p [N, 3]."""
    return fd_stencil(scene_sd, p, h) / (2.0 * h)


def normal_analytic(scene_sd: Callable, p: torch.Tensor) -> torch.Tensor:
    """Exact SDF gradient (not normalised) by one reverse-mode sweep,
    p [N, 3] -> [N, 3] (core.shading.normal_analytic): autograd through
    the fold's minima and maxima, which give a tie to the first operand
    where JAX splits it.  Forward only (the ref oracle's): p is detached,
    and the result carries no graph."""
    with torch.enable_grad():
        q = p.detach().requires_grad_()
        sd = scene_sd(q)
        (g,) = torch.autograd.grad(sd, q, torch.ones_like(sd))
    return g


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize over the last axis: zero or non-finite vectors map to
    zero instead of NaN."""
    v = torch.where(torch.isfinite(v), v, torch.zeros((), dtype=v.dtype,
                                                      device=v.device))
    sq = (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
          + v[..., 2] * v[..., 2])[..., None]
    norm = torch.sqrt(torch.clamp_min(sq, TINY))
    return v / torch.clamp_min(norm, TINY)


def shadowed(scene_sd: Callable, light_pos: torch.Tensor, p: torch.Tensor,
             n: torch.Tensor, iterations: int, surface_eps: float,
             offset_eps: float, *, march_fn: Optional[Callable] = None
             ) -> torch.Tensor:
    """Boolean shadow test by re-marching toward the light, p, n [N, 3]:
    shadowed iff the march stops before passing the light.  ``march_fn``
    ((origin, dirs, tmax) -> MarchResult) replaces the plain march."""
    ray = normalize(light_pos - p)
    start = p + n * (surface_eps + offset_eps)
    r = light_pos - start
    tmax = torch.sqrt(dot3(r, r))
    if march_fn is None:
        res = march(scene_sd, start, ray, iterations, surface_eps, tmax=tmax)
    else:
        res = march_fn(start, ray, tmax)
    return dot3(light_pos - res.position, ray) > 0


def lighting(scene_sd: Callable, light_positions: torch.Tensor,
             p: torch.Tensor, n: torch.Tensor, *, iterations: int,
             surface_eps: float, offset_eps: float, saturation: float,
             shadows: bool = True, shadow_fn: Optional[Callable] = None
             ) -> torch.Tensor:
    """Total Lambertian lighting in [saturation, 1]: p, n [N, 3] -> [N].
    The shadow booleans are constants under autograd (detached inputs, no
    graph), as the JAX code stops their gradients; ``shadow_fn`` is
    ``shadowed``'s ``march_fn``."""
    total = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    for lp in light_positions:
        lambert = dot3(n, normalize(lp - p))
        if shadows:
            with torch.no_grad():
                mask = shadowed(scene_sd, lp.detach(), p.detach(),
                                n.detach(), iterations, surface_eps,
                                offset_eps, march_fn=shadow_fn)
            lambert = torch.where(mask, 0.0, lambert)
        total = total + lambert
    return torch.clamp(total, saturation, 1.0)


def lambert_replay(light_pos: torch.Tensor, p: torch.Tensor, n: torch.Tensor,
                   smask: torch.Tensor, saturation: float) -> torch.Tensor:
    """Differentiable Lambert term [R] of white lights ``light_pos`` [L, 3]
    at hit points p [R, 3] with normals n [R, 3], the hard-shadow booleans
    replayed from the forward's saved ``smask`` bits (pallas_render
    ._lambert_replay).

    The clamp is max then min against tensors, as jnp.clip is built: at a
    bound both PyTorch and JAX give half the gradient to each side of the
    tie, where ``torch.clamp`` would pass all of it."""
    total = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    for li in range(light_pos.shape[0]):
        lambert = dot3(n, normalize(light_pos[li] - p))
        shadowed = ((smask >> li) & 1) == 1
        total = total + torch.where(shadowed, 0.0, lambert)
    lo = torch.tensor(saturation, dtype=p.dtype, device=p.device)
    hi = torch.tensor(1.0, dtype=p.dtype, device=p.device)
    return torch.minimum(torch.maximum(total, lo), hi)
