"""Winner algebra of the exact-FD backward: stencil, cotangents, scatter.

Counterpart of ``raymarching_tpu.ops.scene_vjp`` (the exact-table,
two-level part) and of ``ops.march_op.ift_ray_weights``.  Through every
min/max fold the scene SDF is a.e. ``sign_eff * sd_w`` for one winning
leaf w with a static path sign, so K2's (sd, winner, gradient) per point
turn every parameter cotangent into a per-point formula and one
scatter-add onto the leaf rows:

    d scene / d centre_w = -g,   d scene / d radius_w = -sign_eff[w],
    d scene / d size_w,a = -sign_eff[w] * |g_a| / 2.

Ties go wholly to the first minimal leaf (strict <), the reference's
binary-fold rule; the JAX ``jnp`` route splits them evenly.  Tied leaves
have identical fields, so sums over a tie class agree.

The JAX package reduces with blocked one-hot matmuls (``_segment_add``,
``_gather_rows``), a workaround for the TPU's slow scatter; here the
reduction is ``index_add_`` (float atomics on the card, so the order of
the sum changes from run to run).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from raymarching_tpu.config import RenderConfig
from raymarching_tpu.scene.compile import ScenePlan, SceneTables
from raymarching_tpu.scene.csg import PrimType

from ..core.sdf import leaf_signs
from .surface_kernel import surface_eval

# |grad f . d| can vanish at grazing incidence: the sign-preserving floor
# of march_op._DENOM_EPS
DENOM_EPS = 1e-6


@functools.lru_cache(maxsize=64)
def leaf_statics(plan: ScenePlan) -> Tuple[np.ndarray, np.ndarray]:
    """Per-leaf (sign_eff [P] float32, is_sphere [P] bool) of a two-level
    plan (scene_vjp._leaf_statics); a leafless plan gets one pad row."""
    if plan.kernel is None:
        raise NotImplementedError(
            "not ported yet: depth > 2 scenes (ROADMAP Queue 2, D8)")
    sign_eff = leaf_signs(plan)
    is_sphere = np.zeros(sign_eff.shape, bool)
    is_sphere[:plan.num_primitives] = (np.asarray(plan.prim_type, np.int32)
                                       == int(PrimType.SPHERE))
    return sign_eff, is_sphere


def stencil_points(p: torch.Tensor, h: float, *, center: bool
                   ) -> torch.Tensor:
    """The FD stencil of every point p [R, 3] -> [K, R, 3]: K = 7 with
    ``center`` (row 0 = p, rows 1+a / 4+a = p +- h e_a), else 6 (rows
    a / 3+a = p +- h e_a).  Rows are grouped by offset, so neighbouring
    points stay neighbours (warp coherence of the fold's culls)."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device) * h
    offs = torch.cat(([torch.zeros((1, 3), dtype=p.dtype, device=p.device)]
                      if center else []) + [eye, -eye])
    return p[None, :, :] + offs[:, None, :]


def stencil_eval(plan: ScenePlan, cfg: RenderConfig, tables: SceneTables,
                 p: torch.Tensor, *, center: bool) -> tuple:
    """Winner evaluation at ``stencil_points`` of every point p [R, 3] in
    ONE K2 launch -> (sd [K, R], widx [K, R], g [K, R, 3])."""
    q = stencil_points(p, cfg.fd_h, center=center)
    K, R = q.shape[:2]
    sd, widx, g = surface_eval(plan, tables, q.reshape(-1, 3))
    return sd.reshape(K, R), widx.reshape(K, R), g.reshape(K, R, 3)


def fd_stencil_cotangents(cfg: RenderConfig, nbar: torch.Tensor
                          ) -> torch.Tensor:
    """Per-stencil-row SD cotangents of g_a = (f(p + h e_a) -
    f(p - h e_a)) / 2h, in stencil_eval's row order (+x +y +z -x -y -z):
    nbar [R, 3] -> u [6, R]."""
    inv = 1.0 / (2.0 * cfg.fd_h)
    return torch.cat([nbar.t() * inv, -nbar.t() * inv])


def ift_ray_weights(t_bar: torch.Tensor, denom: torch.Tensor,
                    damping: float) -> torch.Tensor:
    """The implicit-function cotangent w = -t_bar / (grad f . d) per ray:
    with ``damping`` > 0 the Tikhonov-damped -t_bar * denom / (denom^2 +
    damping^2), else 1/denom with |denom| floored at DENOM_EPS, sign kept."""
    if damping > 0.0:
        return -t_bar * denom / (denom * denom + damping * damping)
    small = denom.abs() < DENOM_EPS
    floor = torch.where(denom < 0, -DENOM_EPS, DENOM_EPS)
    return -t_bar / torch.where(small, floor, denom)


def segment_add(idx: torch.Tensor, vals: torch.Tensor, P: int
                ) -> torch.Tensor:
    """[P, C] sums of the rows of vals [R, C] by idx [R] (negative:
    dropped), scene_vjp._segment_add: misses land on a spare row P that is
    cut off, so no host sync filters them.

    The sums are taken in float64 and rounded once to vals' dtype.  A
    leaf's stencil rows carry cotangents of +-1 / 2 fd_h that cancel to a
    far smaller sum, so a float32 sum keeps an error of the terms' size,
    and the card's atomics reorder it from run to run: in float32 the
    card's and the CPU's gradients of one render differed by more than
    tests/test_mega.py's tolerance."""
    rows = torch.where(idx >= 0, idx, P).long()
    out = torch.zeros((P + 1, vals.shape[1]), dtype=torch.float64,
                      device=vals.device)
    return out.index_add_(0, rows, vals.double())[:P].to(vals.dtype)


def theta_cotangents(plan: ScenePlan, tables: SceneTables, widx: torch.Tensor,
                     g: torch.Tensor, u: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter per-point winner cotangents onto the leaf rows.

    widx [...] winner leaf (negative: none), g [..., 3] d scene / dp,
    u [...] the cotangent on the scene SD -> (prim_pos cotangent [P, 3],
    prim_aux cotangent [P, 3]).  Each point adds the columns
    [-u g, -u, -u |g| / 2] to its winner's row; sign_eff and the
    sphere/box split are applied per leaf after the sum (they are shared
    by every point that lands on a leaf, and +-1 factors commute exactly
    with the sum)."""
    P = tables.prim_pos.shape[0]
    sign_eff, is_sphere = leaf_statics(plan)
    widx = widx.reshape(-1)
    g = g.reshape(-1, 3)
    mu = -u.reshape(-1, 1)
    red = segment_add(widx, torch.cat([mu * g, mu, 0.5 * mu * g.abs()],
                                      dim=1), P)
    se = torch.as_tensor(sign_eff[:P], device=red.device)[:, None]
    sph = torch.as_tensor(is_sphere[:P], device=red.device)[:, None]
    aux_sphere = torch.cat([red[:, 3:4], torch.zeros_like(red[:, :2])], dim=1)
    return red[:, :3], se * torch.where(sph, aux_sphere, red[:, 4:7])
