"""Surface normals, hard shadows and Lambertian multi-light shading.

Port of ``raymarching_tpu.core.shading`` for the reference's shading model
(scene.cpp:45-89): the normal is the normalised 6-point central difference
of the SDF (or, with ``RenderConfig.normal_mode="analytic"``, its exact
gradient by one reverse-mode sweep); a light counts only if a march from
the hit point, lifted off the surface by ``surface_eps + offset_eps``
along the normal, passes the light; the Lambert sum over lights is clamped
to ``[saturation, 1]``.  ``shadow_fn`` routes the shadow marches through a
kernel (``api.make_render_hooks``).

Extensions of the JAX package, all off by default (the reference has none):
coloured lights (the ``LightColor`` scene line: each light's Lambert term
weighted per channel, the clamp per channel), soft shadows (the shadow
boolean replaced by a penumbra factor, ``soft_shadow_factor``) and ambient
occlusion (the clamped light scaled by ``ambient_occlusion``).  Both
factors are constants under autograd, as the JAX code stops their
gradients.
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


def normal_analytic(scene_sd: Callable, p: torch.Tensor,
                    graph: bool = False) -> torch.Tensor:
    """Exact SDF gradient (not normalised) by one reverse-mode sweep,
    p [N, 3] -> [N, 3] (core.shading.normal_analytic): autograd through
    the fold's minima and maxima, which give a tie to the first operand
    where JAX splits it.  Forward only by default (the ref oracle's
    forward): p is detached, and the result carries no graph.  With
    ``graph`` the gradient is a function of p and of what ``scene_sd``
    reads, for a second sweep (the differentiable ref render, the
    mirror-bounce replay, which differentiates the reflected direction);
    a p that does not require grad is taken as a constant."""
    if graph:
        q = p if p.requires_grad else p.detach().requires_grad_()
        with torch.enable_grad():
            sd = scene_sd(q)
            (g,) = torch.autograd.grad(sd, q, torch.ones_like(sd),
                                       create_graph=True)
        return g
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


def soft_shadow_factor(scene_sd: Callable, light_pos: torch.Tensor,
                       p: torch.Tensor, n: torch.Tensor, iterations: int,
                       surface_eps: float, offset_eps: float,
                       k: float) -> torch.Tensor:
    """Penumbra factor in [0, 1] of each ray, p, n [N, 3] -> [N]: the march
    toward the light of ``shadowed``, 0 where it stops before passing the
    light, else the min over its steps of clamp(k sd / max(t, eps), 0, 1)
    with t the distance marched so far, summed step by step
    (core.shading._soft_step).  As k grows it becomes the hard boolean."""
    ray = normalize(light_pos - p)
    start = p + n * (surface_eps + offset_eps)
    r = light_pos - start
    tmax = torch.sqrt(dot3(r, r))
    res, pen = march(scene_sd, start, ray, iterations, surface_eps,
                     tmax=tmax, soft_k=k)
    lit = dot3(light_pos - res.position, ray) <= 0
    return torch.where(lit, pen, torch.zeros((), dtype=pen.dtype,
                                             device=pen.device))


def ambient_occlusion(scene_sd: Callable, p: torch.Tensor, n: torch.Tensor,
                      strength: float, samples: int,
                      delta: float) -> torch.Tensor:
    """SDF ambient-occlusion factor in [0, 1], p, n [N, 3] -> [N]:

        occ = sum_i 2^-i (i delta - sd(p + i delta n)),  i = 1..samples
        ao  = clamp(1 - strength occ, 0, 1)

    (core.shading.ambient_occlusion; i delta is a double rounded once to
    float32, as JAX rounds it.)"""
    occ = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    for i in range(1, samples + 1):
        d = i * delta
        occ = occ + (2.0 ** -i) * (d - scene_sd(p + d * n))
    return torch.clamp(1.0 - strength * occ, 0.0, 1.0)


def lighting(scene_sd: Callable, light_positions: torch.Tensor,
             p: torch.Tensor, n: torch.Tensor, *, iterations: int,
             surface_eps: float, offset_eps: float, saturation: float,
             shadows: bool = True, shadow_fn: Optional[Callable] = None,
             light_colors: Optional[torch.Tensor] = None,
             soft_shadow_k: float = 0.0, ao_strength: float = 0.0,
             ao_samples: int = 5, ao_delta: float = 0.1) -> torch.Tensor:
    """Total Lambertian lighting in [saturation, 1]: p, n [N, 3] -> [N], or
    with ``light_colors`` [L, 3] -> [N, 3] (each light's term weighted per
    channel, clamped per channel).  ``soft_shadow_k > 0`` (with shadows)
    replaces each shadow boolean by ``soft_shadow_factor``;
    ``ao_strength > 0`` scales the clamped light by ``ambient_occlusion``.
    The shadow booleans and both factors are constants under autograd
    (detached inputs, no graph), as the JAX code stops their gradients;
    ``shadow_fn`` is ``shadowed``'s ``march_fn`` (the soft march is always
    the plain one, as in the JAX code)."""
    colored = light_colors is not None
    shape = tuple(p.shape) if colored else (p.shape[0],)
    total = torch.zeros(shape, dtype=p.dtype, device=p.device)
    for li, lp in enumerate(light_positions):
        lambert = dot3(n, normalize(lp - p))
        if shadows and soft_shadow_k > 0.0:
            with torch.no_grad():
                fac = soft_shadow_factor(
                    scene_sd, lp.detach(), p.detach(), n.detach(),
                    iterations, surface_eps, offset_eps, soft_shadow_k)
            lambert = lambert * fac
        elif shadows:
            with torch.no_grad():
                mask = shadowed(scene_sd, lp.detach(), p.detach(),
                                n.detach(), iterations, surface_eps,
                                offset_eps, march_fn=shadow_fn)
            lambert = torch.where(mask, 0.0, lambert)
        if colored:
            total = total + lambert[:, None] * light_colors[li]
        else:
            total = total + lambert
    out = torch.clamp(total, saturation, 1.0)
    if ao_strength > 0.0:
        with torch.no_grad():
            ao = ambient_occlusion(scene_sd, p.detach(), n.detach(),
                                   ao_strength, ao_samples, ao_delta)
        out = out * (ao[:, None] if colored else ao)
    return out


def lambert_replay(light_pos: torch.Tensor, p: torch.Tensor, n: torch.Tensor,
                   smask: torch.Tensor, saturation: float,
                   sfac: Optional[torch.Tensor] = None,
                   aofac: Optional[torch.Tensor] = None,
                   light_color: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Differentiable Lambert term [R] of the lights at ``light_pos`` [L, 3]
    at hit points p [R, 3] with normals n [R, 3], the forward's saved
    stop-gradient decisions reapplied (pallas_render._lambert_replay): the
    hard-shadow booleans from its ``smask`` bits, or with soft shadows its
    penumbra factors ``sfac`` [L, R]; with ``light_color`` [L, 3] each
    term weighted per channel ([R, 3]); the clamp; then with AO its factors
    ``aofac`` [R].

    The clamp is max then min against tensors, as jnp.clip is built: at a
    bound both PyTorch and JAX give half the gradient to each side of the
    tie, where ``torch.clamp`` would pass all of it."""
    colored = light_color is not None
    shape = tuple(p.shape) if colored else (p.shape[0],)
    total = torch.zeros(shape, dtype=p.dtype, device=p.device)
    for li in range(light_pos.shape[0]):
        lambert = dot3(n, normalize(light_pos[li] - p))
        if sfac is not None:
            lambert = lambert * sfac[li]
        else:
            shadowed = ((smask >> li) & 1) == 1
            lambert = torch.where(shadowed, 0.0, lambert)
        if colored:
            total = total + lambert[:, None] * light_color[li]
        else:
            total = total + lambert
    lo = torch.tensor(saturation, dtype=p.dtype, device=p.device)
    hi = torch.tensor(1.0, dtype=p.dtype, device=p.device)
    light = torch.minimum(torch.maximum(total, lo), hi)
    if aofac is not None:
        light = light * (aofac[:, None] if colored else aofac)
    return light
