"""Surface normals, hard shadows and Lambertian multi-light shading.

Port of ``raymarching_tpu.core.shading`` for the reference's shading model
(scene.cpp:45-89): the normal is the normalised 6-point central difference
of the SDF; a light counts only if a march from the hit point, lifted off
the surface by ``surface_eps + offset_eps`` along the normal, passes the
light; the Lambert sum over lights is clamped to ``[saturation, 1]``.
Soft shadows and ambient occlusion are not ported yet.
"""

from __future__ import annotations

from typing import Callable

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
             offset_eps: float) -> torch.Tensor:
    """Boolean shadow test by re-marching toward the light, p, n [N, 3]:
    shadowed iff the march stops before passing the light."""
    ray = normalize(light_pos - p)
    start = p + n * (surface_eps + offset_eps)
    r = light_pos - start
    tmax = torch.sqrt(dot3(r, r))
    res = march(scene_sd, start, ray, iterations, surface_eps, tmax=tmax)
    return dot3(light_pos - res.position, ray) > 0


def lighting(scene_sd: Callable, light_positions: torch.Tensor,
             p: torch.Tensor, n: torch.Tensor, *, iterations: int,
             surface_eps: float, offset_eps: float, saturation: float,
             shadows: bool = True) -> torch.Tensor:
    """Total Lambertian lighting in [saturation, 1]: p, n [N, 3] -> [N]."""
    total = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    for lp in light_positions:
        lambert = dot3(n, normalize(lp - p))
        if shadows:
            mask = shadowed(scene_sd, lp, p, n, iterations, surface_eps,
                            offset_eps)
            lambert = torch.where(mask, 0.0, lambert)
        total = total + lambert
    return torch.clamp(total, saturation, 1.0)
