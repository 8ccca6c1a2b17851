"""The scene's signed distance field, plain PyTorch, every leaf evaluated.

Leaf distances (body.cpp:32-57): a sphere |p - c| - r; a box the largest
of the per-axis excesses |p - c| - s/2; a cross their median.  A list folds
its leaves left to right (body.cpp:66-111): UNION by min, COMPLEMENT by min
of the negated leaves, INTERSECTION by max, DIFFERENCE by max of the first
leaf and the negated rest; the root is a UNION of the bodies.  Ties keep the
earlier operand, and the winning leaf's colour is the surface colour.

No culling and no closed forms: a sponge's every cross is evaluated at every
point, in blocks of points so the [points, leaves] matrix stays bounded.
``dtype`` is the precision of the positions and tables (float32 for the
reference; a lower one for the control).
"""

from __future__ import annotations

import numpy as np
import torch

from .scene import (BOX, COMPLEMENT, CROSS, DIFFERENCE, INTERSECTION, SPHERE,
                    Scene)

# Elements of one [points, leaves] block.
LEAF_BUDGET = 1 << 25


def med3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def leaf_distance(kind: int, p, pos, aux):
    """[N, K] distances of K leaves of one type at points p [N, 3]."""
    d = p[:, None, :] - pos
    if kind == SPHERE:
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        return (torch.sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz,
                                           1e-24)) - aux[:, 0])
    b = d.abs() - aux * 0.5
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    if kind == BOX:
        return torch.maximum(torch.maximum(bx, by), bz)
    return med3(bx, by, bz)


def winner_distance(ptype, pos, aux, p):
    """Distance of one leaf a point: rows ``pos``/``aux`` [N, 3] of types
    ``ptype`` [N] at p [N, 3] -> [N].  Differentiable in all three tensors:
    the fold's value is its winner's, so this carries the field's gradient
    to the winning row."""
    d = p - pos
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    sph = torch.sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-24)) \
        - aux[:, 0]
    b = d.abs() - aux * 0.5
    bx, by, bz = b[:, 0], b[:, 1], b[:, 2]
    box = torch.maximum(torch.maximum(bx, by), bz)
    crs = med3(bx, by, bz)
    return torch.where(ptype == SPHERE, sph,
                       torch.where(ptype == BOX, box, crs))


class Field:
    """The field of ``scene`` on ``device`` in ``dtype``."""

    def __init__(self, scene: Scene, device, dtype=torch.float32,
                 tables=None):
        self.scene = scene
        self.device = torch.device(device)
        self.dtype = dtype
        t = tables or scene.tables()
        self.pos = torch.as_tensor(t["prim_pos"], device=device).to(dtype)
        self.aux = torch.as_tensor(t["prim_aux"], device=device).to(dtype)
        self.ptype = torch.as_tensor(scene.ptype, device=device)
        self.kinds = []
        for kind in (SPHERE, BOX, CROSS):
            rows = np.nonzero(scene.ptype == kind)[0]
            if len(rows):
                self.kinds.append((kind, torch.as_tensor(rows,
                                                         device=device)))
        # per body: (start, count, fold op max?, per-entry sign [count])
        self.folds = []
        for b in scene.bodies:
            if b.mode is None:
                sign = [1.0]
                use_max = False
            elif b.mode == DIFFERENCE:
                sign, use_max = [1.0] + [-1.0] * (b.count - 1), True
            elif b.mode == COMPLEMENT:
                sign, use_max = [-1.0] * b.count, False
            elif b.mode == INTERSECTION:
                sign, use_max = [1.0] * b.count, True
            else:
                sign, use_max = [1.0] * b.count, False
            self.folds.append((b.start, b.count, use_max,
                               torch.tensor(sign, dtype=dtype,
                                            device=device)))

    def _block(self, p, with_winner: bool):
        n, P = p.shape[0], self.pos.shape[0]
        leaf = torch.empty((n, P), dtype=self.dtype, device=self.device)
        for kind, rows in self.kinds:
            leaf[:, rows] = leaf_distance(kind, p, self.pos[rows],
                                          self.aux[rows])
        vals, wins, signs = [], [], []
        for start, count, use_max, sign in self.folds:
            v = leaf[:, start:start + count]
            if count == 1:
                vals.append(v[:, 0] * sign[0])
                wins.append(torch.full((n,), start, device=self.device))
                signs.append(sign[0].expand(n))
                continue
            v = v * sign
            k = v.argmax(1) if use_max else v.argmin(1)
            vals.append(v.gather(1, k[:, None])[:, 0])
            wins.append(start + k)
            signs.append(sign[k])
        vals = torch.stack(vals, 1)
        kb = vals.argmin(1)        # the root UNION, first minimum
        sd = vals.gather(1, kb[:, None])[:, 0]
        if not with_winner:
            return sd, None, None
        w = torch.stack(wins, 1).gather(1, kb[:, None])[:, 0]
        s = torch.stack(signs, 1).gather(1, kb[:, None])[:, 0]
        return sd, w, s

    def __call__(self, p, with_winner: bool = False):
        """sd [N] at p [N, 3]; with ``with_winner`` also the winning leaf
        [N] (int64) and the sign [N] its distance enters the value with."""
        p = p.to(self.dtype)
        rows = max(1, LEAF_BUDGET // max(self.pos.shape[0], 1))
        parts = [self._block(p[i:i + rows], with_winner)
                 for i in range(0, p.shape[0], rows)] or \
            [self._block(p, with_winner)]
        sd = torch.cat([q[0] for q in parts])
        if not with_winner:
            return sd
        return (sd, torch.cat([q[1] for q in parts]),
                torch.cat([q[2] for q in parts]))
