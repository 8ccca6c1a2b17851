"""Procedural fractal leaves: the Mandelbox, Mandelbulb and Julia DEs.

Port of ``raymarching_tpu.core.sdf.mandelbox_sd``, ``mandelbulb_sd`` and
``julia_sd`` and of their kernel forms in ``pallas_march`` (D7:
``_mandelbox_sd``, ``_mandelbulb_sd``, ``_julia_sd`` and the gradient
sweeps ``_mandelbox_sd_grad``, ``_mandelbulb_sd_grad`` on ``_Jet`` dual
numbers, ``_julia_sd_grad``).  The value functions are written component by
component in the kernels' order of operations, so they are at once the
differentiable field (``core.sdf.leaf_sd`` under autograd) and the plain
twin of ``csrc/proc.cuh``'s value functions: each PyTorch op rounds once,
as each operation of the kernels built with ``-fmad=false`` does.  The
gradient functions are the kernels' forward-mode sweeps (the Mandelbox's
hand-written Jacobian, the others on ``Jet``), the plain twin of
``csrc/proc.cuh``'s gradients, and use no autograd.

Every floor sits inside the argument of the op it guards (sqrt, log, the
inverse), never on its result, so a dead branch's cotangent is zeroed by
the floor's subgradient instead of meeting an inf (the JAX package's
discipline).  The Mandelbox keeps the JAX oracle's 1e-24 floor under its
final square root, which the kernels apply too (value-neutral above it).

A leaf's structural parameters (``ScenePlan.proc``: kind "mb", "bulb" or
"julia", the fold scale, the power or the Julia constant, and the
iteration count) are Python numbers here; its centre and size are table
entries and carry gradients.  A Python number meets a float32 tensor as
its float32 rounding, the value the kernels read from the scene's
procedural rows.  Divisions take a tensor divisor or numerator: PyTorch
divides a CUDA tensor by a Python number as a product with its reciprocal.
"""

from __future__ import annotations

import torch

# The escape radii and clips of the masked iterations (JAX's constants).
BULB_BAILOUT, BULB_CLIP, BULB_MQ = 256.0, 16.0, 65536.0
JULIA_BAILOUT, JULIA_CLIP, JULIA_MQ = 16.0, 8.0, 4096.0

# Operations of one evaluation, for a roofline bound (core.sdf.LeafCount):
# (setup, per iteration, final), counted from csrc/proc.cuh one
# arithmetic, min/max, compare or select each (a clip two).  The value
# forms: the Mandelbox 6 + 31 iters + 9, the Mandelbulb 11 + 94 iters + 7,
# the Julia set 13 + 44 iters + 8.  The gradient sweeps (the winner's
# gradient, once a point that a procedural leaf wins): the Mandelbox's
# Jacobian 8 + 127 iters + 43; on jets, where a product is 10 operations
# (the value, and per tangent two products and a sum), a sum 4 and a
# difference 8 (a negation and a sum, the same bits as JAX's _Jet), the
# Mandelbulb 52 + 661 iters + 52 and the Julia set 58 + 247 iters + 58.
PROC_VALUE_OPS = {"mb": (6, 31, 9), "bulb": (11, 94, 7), "julia": (13, 44, 8)}
PROC_GRAD_OPS = {"mb": (8, 127, 43), "bulb": (52, 661, 52),
                 "julia": (58, 247, 58)}


def value_ops(kind: str, iters: int) -> int:
    """Operations of one value evaluation of a procedural leaf."""
    a, b, c = PROC_VALUE_OPS[kind]
    return a + b * iters + c


def grad_ops(kind: str, iters: int) -> int:
    """Operations of one gradient sweep of a procedural leaf."""
    a, b, c = PROC_GRAD_OPS[kind]
    return a + b * iters + c


def _one(like: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=like.dtype, device=like.device)


def _q0(p: torch.Tensor, c: torch.Tensor, size: torch.Tensor) -> tuple:
    """(p - c) / size per axis: p [N, 3], c [3], size a 0-dim tensor."""
    q0 = (p - c) / size
    return q0[:, 0], q0[:, 1], q0[:, 2]


def mandelbox_sd(p: torch.Tensor, c: torch.Tensor, size: torch.Tensor,
                 scale: float, iters: int) -> torch.Tensor:
    """Mandelbox DE of one leaf at p [N, 3] -> [N]: box fold, sphere fold
    (f = r2 < 1 ? 1 / max(r2, 1/4) : 1), q = scale f q + q0, dr = |scale|
    f dr + 1, then size |q| / dr (core.sdf.mandelbox_sd)."""
    one = _one(p)
    q0x, q0y, q0z = _q0(p, c, size)
    qx, qy, qz = q0x, q0y, q0z
    dr = torch.ones_like(q0x)
    for _ in range(iters):
        qx = torch.clamp(qx, -1.0, 1.0) * 2.0 - qx
        qy = torch.clamp(qy, -1.0, 1.0) * 2.0 - qy
        qz = torch.clamp(qz, -1.0, 1.0) * 2.0 - qz
        r2 = qx * qx + qy * qy + qz * qz
        f = torch.where(r2 < 1.0, one / torch.clamp_min(r2, 0.25), one)
        sf = scale * f
        qx, qy, qz = sf * qx + q0x, sf * qy + q0y, sf * qz + q0z
        dr = abs(scale) * f * dr + 1.0
    return size * torch.sqrt(torch.clamp_min(qx * qx + qy * qy + qz * qz,
                                             1e-24)) / dr


def mandelbulb_sd(p: torch.Tensor, c: torch.Tensor, size: torch.Tensor,
                  power: float, iters: int) -> torch.Tensor:
    """Power-8 Mandelbulb DE of one leaf at p [N, 3] -> [N]: the trig-free
    triplex iteration w <- w^8 + q0 with masked escape at m > 256, w
    clipped to +-16 and m to 65536 inside the step (value-exact for live
    lanes, finite for frozen ones), the (x, z) radius floored at 1e-10
    (core.sdf.mandelbulb_sd).  ``power`` is fixed at 8 and unused."""
    del power
    one = _one(p)
    q0x, q0y, q0z = _q0(p, c, size)
    wx, wy, wz = q0x, q0y, q0z
    m = wx * wx + wy * wy + wz * wz
    dz = torch.ones_like(q0x)
    for _ in range(iters):
        esc = m > BULB_BAILOUT
        x = torch.clamp(wx, -BULB_CLIP, BULB_CLIP)
        y = torch.clamp(wy, -BULB_CLIP, BULB_CLIP)
        z = torch.clamp(wz, -BULB_CLIP, BULB_CLIP)
        mq = torch.clamp_max(m, BULB_MQ)
        dz_new = (8.0 * (mq * mq * mq) * torch.sqrt(torch.clamp_min(mq, 1e-12))
                  * dz + 1.0)
        x2, y2, z2 = x * x, y * y, z * z
        x4, y4, z4 = x2 * x2, y2 * y2, z2 * z2
        s2 = x2 + z2
        s = torch.sqrt(torch.clamp_min(s2, 1e-20))
        inv = one / torch.clamp_min(s, 1e-10)
        ux, uz = x * inv, z * inv
        ux2, uz2 = ux * ux, uz * uz
        ux4, uz4 = ux2 * ux2, uz2 * uz2
        k1 = x4 + y4 + z4 - 6.0 * y2 * z2 - 6.0 * x2 * y2 + 2.0 * z2 * x2
        k4 = x2 - y2 + z2
        pa = ux * uz * (ux2 - uz2) * (ux4 - 6.0 * ux2 * uz2 + uz4)
        pb = (ux4 * ux4 - 28.0 * ux4 * ux2 * uz2 + 70.0 * ux4 * uz4
              - 28.0 * ux2 * uz2 * uz4 + uz4 * uz4)
        yk = y * k4 * k1 * s
        nx = 64.0 * yk * pa + q0x
        ny = -16.0 * y2 * s2 * k4 * k4 + k1 * k1 + q0y
        nz = -8.0 * yk * pb + q0z
        m_new = nx * nx + ny * ny + nz * nz
        wx = torch.where(esc, wx, nx)
        wy = torch.where(esc, wy, ny)
        wz = torch.where(esc, wz, nz)
        dz = torch.where(esc, dz, dz_new)
        m = torch.where(esc, m, m_new)
    m = torch.clamp_min(m, 1e-12)
    return size * 0.25 * torch.log(m) * torch.sqrt(m) / dz


def julia_sd(p: torch.Tensor, c: torch.Tensor, size: torch.Tensor,
             const, iters: int) -> torch.Tensor:
    """Quaternion z^2 + c Julia DE of one leaf at p [N, 3] -> [N] (the
    slice w = 0): masked escape at m > 16, the quaternion clipped to +-8 and
    m to 4096 inside the step, the floors under sqrt and log
    (core.sdf.julia_sd).  ``const`` is the 4-tuple Julia constant."""
    ca, cb, cc, cd = (float(v) for v in const)
    a, b, c_ = _q0(p, c, size)
    d = torch.zeros_like(a)
    m = a * a + b * b + c_ * c_ + d * d
    md = torch.ones_like(a)
    for _ in range(iters):
        esc = m > JULIA_BAILOUT
        mq = torch.clamp_max(m, JULIA_MQ)
        md_new = 2.0 * torch.sqrt(torch.clamp_min(mq, 1e-12)) * md
        ax = torch.clamp(a, -JULIA_CLIP, JULIA_CLIP)
        bx = torch.clamp(b, -JULIA_CLIP, JULIA_CLIP)
        cx = torch.clamp(c_, -JULIA_CLIP, JULIA_CLIP)
        dx = torch.clamp(d, -JULIA_CLIP, JULIA_CLIP)
        na = ax * ax - bx * bx - cx * cx - dx * dx + ca
        nb = 2.0 * ax * bx + cb
        nc = 2.0 * ax * cx + cc
        nd = 2.0 * ax * dx + cd
        m_new = na * na + nb * nb + nc * nc + nd * nd
        a = torch.where(esc, a, na)
        b = torch.where(esc, b, nb)
        c_ = torch.where(esc, c_, nc)
        d = torch.where(esc, d, nd)
        md = torch.where(esc, md, md_new)
        m = torch.where(esc, m, m_new)
    m = torch.clamp_min(m, 1e-12)
    md = torch.clamp_min(md, 1e-12)
    return size * 0.25 * torch.sqrt(m) * torch.log(m) / md


PROC_SD = {"mb": mandelbox_sd, "bulb": mandelbulb_sd, "julia": julia_sd}


def proc_sd(spec: tuple, p: torch.Tensor, c: torch.Tensor,
            size: torch.Tensor) -> torch.Tensor:
    """The DE of a leaf whose ``ScenePlan.proc`` entry is (leaf, kind,
    param, iters), at p [N, 3]."""
    _, kind, param, iters = spec
    return PROC_SD[kind](p, c, size, param, iters)


class Jet:
    """A value and its three tangents d/dp (pallas_march._Jet), so the
    Mandelbulb's and the Julia set's gradients are their forward
    iterations run on dual numbers.  The operations and their order are
    csrc/proc.cuh's Jet's: a product's tangent is a.t b.v + a.v b.t, a
    difference the sum with the negation (the same bits)."""

    __slots__ = ("v", "tx", "ty", "tz")

    def __init__(self, v, tx, ty, tz):
        self.v, self.tx, self.ty, self.tz = v, tx, ty, tz

    def __add__(self, o):
        if isinstance(o, Jet):
            return Jet(self.v + o.v, self.tx + o.tx, self.ty + o.ty,
                       self.tz + o.tz)
        return Jet(self.v + o, self.tx, self.ty, self.tz)

    def __neg__(self):
        return Jet(-self.v, -self.tx, -self.ty, -self.tz)

    def __sub__(self, o):
        return self + (-o)

    def __mul__(self, o):
        if isinstance(o, Jet):
            return Jet(self.v * o.v, self.tx * o.v + self.v * o.tx,
                       self.ty * o.v + self.v * o.ty,
                       self.tz * o.v + self.v * o.tz)
        return Jet(self.v * o, self.tx * o, self.ty * o, self.tz * o)

    __rmul__ = __mul__


def _times(a: Jet, g: torch.Tensor) -> tuple:
    """The tangents of a unary op's jet: a's tangents times its
    derivative g."""
    return g * a.tx, g * a.ty, g * a.tz


def _zero_one(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """1 where mask, else 0, in like's type."""
    return torch.where(mask, _one(like), torch.zeros((), dtype=like.dtype,
                                                     device=like.device))


def jet_sqrt_floor(a: Jet, floor: float) -> Jet:
    r = torch.sqrt(torch.clamp_min(a.v, floor))
    half = torch.full((), 0.5, dtype=r.dtype, device=r.device)
    g = torch.where(a.v > floor, half / r,
                    torch.zeros((), dtype=r.dtype, device=r.device))
    return Jet(r, *_times(a, g))


def jet_log_floor(a: Jet, floor: float) -> Jet:
    v = torch.clamp_min(a.v, floor)
    g = torch.where(a.v > floor, _one(v) / v,
                    torch.zeros((), dtype=v.dtype, device=v.device))
    return Jet(torch.log(v), *_times(a, g))


def jet_min_c(a: Jet, c: float) -> Jet:
    z = _zero_one(a.v < c, a.v)
    return Jet(torch.clamp_max(a.v, c), *_times(a, z))


def jet_max_c(a: Jet, c: float) -> Jet:
    z = _zero_one(a.v > c, a.v)
    return Jet(torch.clamp_min(a.v, c), *_times(a, z))


def jet_clip(a: Jet, lo: float, hi: float) -> Jet:
    z = _zero_one((a.v > lo) & (a.v < hi), a.v)
    return Jet(torch.clamp(a.v, lo, hi), *_times(a, z))


def jet_inv_floor(a: Jet, floor: float) -> Jet:
    v = torch.clamp_min(a.v, floor)
    inv = _one(v) / v
    g = torch.where(a.v > floor, -inv * inv,
                    torch.zeros((), dtype=v.dtype, device=v.device))
    return Jet(inv, *_times(a, g))


def jet_where(mask: torch.Tensor, a: Jet, b: Jet) -> Jet:
    return Jet(torch.where(mask, a.v, b.v), torch.where(mask, a.tx, b.tx),
               torch.where(mask, a.ty, b.ty), torch.where(mask, a.tz, b.tz))


def _jet_q0(p: torch.Tensor, c: torch.Tensor, size: torch.Tensor) -> tuple:
    """The seed jets (p - c) * (1 / size) with tangents diag(1 / size)."""
    inv_s = _one(size) / size
    zero = torch.zeros_like(p[:, 0])
    s0 = inv_s + zero
    d = (p - c) * inv_s
    return (Jet(d[:, 0], s0, zero, zero), Jet(d[:, 1], zero, s0, zero),
            Jet(d[:, 2], zero, zero, s0), zero)


def mandelbox_grad(p: torch.Tensor, c: torch.Tensor, size: torch.Tensor,
                   scale: float, iters: int) -> torch.Tensor:
    """d DE / dp [N, 3] of a Mandelbox leaf (pallas_march
    ._mandelbox_sd_grad): the 3x3 Jacobian dq/dp and d dr / dp carried
    through the iteration by hand, the box fold flipping Jacobian rows,
    the sphere fold a rank-one update through df / dr2 = -f^2."""
    one = _one(p)
    zero_s = torch.zeros((), dtype=p.dtype, device=p.device)
    s0 = one / size
    q0x, q0y, q0z = _q0(p, c, size)
    qx, qy, qz = q0x, q0y, q0z
    dr = torch.ones_like(q0x)
    zero = torch.zeros_like(q0x)
    jxx = s0 + zero
    jyy, jzz = jxx, jxx
    jxy = jxz = jyx = jyz = jzx = jzy = zero
    dx_ = dy_ = dz_ = zero
    asf = abs(scale)
    for _ in range(iters):
        bx = torch.where(qx.abs() <= 1.0, one, -one)
        by = torch.where(qy.abs() <= 1.0, one, -one)
        bz = torch.where(qz.abs() <= 1.0, one, -one)
        qx = torch.clamp(qx, -1.0, 1.0) * 2.0 - qx
        qy = torch.clamp(qy, -1.0, 1.0) * 2.0 - qy
        qz = torch.clamp(qz, -1.0, 1.0) * 2.0 - qz
        jxx, jxy, jxz = bx * jxx, bx * jxy, bx * jxz
        jyx, jyy, jyz = by * jyx, by * jyy, by * jyz
        jzx, jzy, jzz = bz * jzx, bz * jzy, bz * jzz
        r2 = qx * qx + qy * qy + qz * qz
        f = torch.where(r2 < 1.0, one / torch.clamp_min(r2, 0.25), one)
        fp = torch.where((r2 > 0.25) & (r2 < 1.0), -f * f, zero_s)
        r2x = 2.0 * (qx * jxx + qy * jyx + qz * jzx)
        r2y = 2.0 * (qx * jxy + qy * jyy + qz * jzy)
        r2z = 2.0 * (qx * jxz + qy * jyz + qz * jzz)
        fx, fy, fz = fp * r2x, fp * r2y, fp * r2z
        sf = scale * f
        jxx = sf * jxx + scale * qx * fx + s0
        jxy = sf * jxy + scale * qx * fy
        jxz = sf * jxz + scale * qx * fz
        jyx = sf * jyx + scale * qy * fx
        jyy = sf * jyy + scale * qy * fy + s0
        jyz = sf * jyz + scale * qy * fz
        jzx = sf * jzx + scale * qz * fx
        jzy = sf * jzy + scale * qz * fy
        jzz = sf * jzz + scale * qz * fz + s0
        qx, qy, qz = sf * qx + q0x, sf * qy + q0y, sf * qz + q0z
        dx_ = asf * (f * dx_ + dr * fx)
        dy_ = asf * (f * dy_ + dr * fy)
        dz_ = asf * (f * dz_ + dr * fz)
        dr = asf * f * dr + 1.0
    r = torch.sqrt(qx * qx + qy * qy + qz * qz)
    rinv = one / torch.clamp_min(r, 1e-30)
    rx = (qx * jxx + qy * jyx + qz * jzx) * rinv
    ry = (qx * jxy + qy * jyy + qz * jzy) * rinv
    rz = (qx * jxz + qy * jyz + qz * jzz) * rinv
    inv_dr2 = one / (dr * dr)
    return torch.stack([size * (rx * dr - r * dx_) * inv_dr2,
                        size * (ry * dr - r * dy_) * inv_dr2,
                        size * (rz * dr - r * dz_) * inv_dr2], dim=-1)


def mandelbulb_grad(p: torch.Tensor, c: torch.Tensor, size: torch.Tensor,
                    power: float, iters: int) -> torch.Tensor:
    """d DE / dp [N, 3] of a Mandelbulb leaf: the forward iteration on
    jets (pallas_march._mandelbulb_sd_grad)."""
    del power
    q0x, q0y, q0z, zero = _jet_q0(p, c, size)
    wx, wy, wz = q0x, q0y, q0z
    m = wx * wx + wy * wy + wz * wz
    dz = Jet(torch.ones_like(zero), zero, zero, zero)
    for _ in range(iters):
        esc = m.v > BULB_BAILOUT
        x = jet_clip(wx, -BULB_CLIP, BULB_CLIP)
        y = jet_clip(wy, -BULB_CLIP, BULB_CLIP)
        z = jet_clip(wz, -BULB_CLIP, BULB_CLIP)
        mq = jet_min_c(m, BULB_MQ)
        dz_new = 8.0 * (mq * mq * mq) * jet_sqrt_floor(mq, 1e-12) * dz + 1.0
        x2, y2, z2 = x * x, y * y, z * z
        x4, y4, z4 = x2 * x2, y2 * y2, z2 * z2
        s2 = x2 + z2
        s = jet_sqrt_floor(s2, 1e-20)
        inv = jet_inv_floor(s, 1e-10)
        ux, uz = x * inv, z * inv
        ux2, uz2 = ux * ux, uz * uz
        ux4, uz4 = ux2 * ux2, uz2 * uz2
        k1 = (x4 + y4 + z4 - 6.0 * (y2 * z2) - 6.0 * (x2 * y2)
              + 2.0 * (z2 * x2))
        k4 = x2 - y2 + z2
        pa = ux * uz * (ux2 - uz2) * (ux4 - 6.0 * (ux2 * uz2) + uz4)
        pb = (ux4 * ux4 - 28.0 * (ux4 * (ux2 * uz2)) + 70.0 * (ux4 * uz4)
              - 28.0 * ((ux2 * uz2) * uz4) + uz4 * uz4)
        yk = y * k4 * k1 * s
        nx = 64.0 * yk * pa + q0x
        ny = -16.0 * (y2 * s2) * (k4 * k4) + k1 * k1 + q0y
        nz = -8.0 * yk * pb + q0z
        m_new = nx * nx + ny * ny + nz * nz
        wx = jet_where(esc, wx, nx)
        wy = jet_where(esc, wy, ny)
        wz = jet_where(esc, wz, nz)
        dz = jet_where(esc, dz, dz_new)
        m = jet_where(esc, m, m_new)
    lg = jet_log_floor(m, 1e-12)
    rt = jet_sqrt_floor(m, 1e-12)
    inv_dz = jet_inv_floor(dz, 0.0)
    de = 0.25 * lg * rt * inv_dz
    return torch.stack([size * de.tx, size * de.ty, size * de.tz], dim=-1)


def julia_grad(p: torch.Tensor, c: torch.Tensor, size: torch.Tensor,
               const, iters: int) -> torch.Tensor:
    """d DE / dp [N, 3] of a Julia leaf: the forward iteration on jets
    (pallas_march._julia_sd_grad)."""
    ca, cb, cc, cd = (float(v) for v in const)
    a, b, c_, zero = _jet_q0(p, c, size)
    d = Jet(zero, zero, zero, zero)
    m = a * a + b * b + c_ * c_ + d * d
    md = Jet(torch.ones_like(zero), zero, zero, zero)
    for _ in range(iters):
        esc = m.v > JULIA_BAILOUT
        mq = jet_min_c(m, JULIA_MQ)
        md_new = 2.0 * jet_sqrt_floor(mq, 1e-12) * md
        ax = jet_clip(a, -JULIA_CLIP, JULIA_CLIP)
        bx = jet_clip(b, -JULIA_CLIP, JULIA_CLIP)
        cx = jet_clip(c_, -JULIA_CLIP, JULIA_CLIP)
        dx = jet_clip(d, -JULIA_CLIP, JULIA_CLIP)
        na = ax * ax - bx * bx - cx * cx - dx * dx + ca
        nb = 2.0 * (ax * bx) + cb
        nc = 2.0 * (ax * cx) + cc
        nd = 2.0 * (ax * dx) + cd
        m_new = na * na + nb * nb + nc * nc + nd * nd
        a = jet_where(esc, a, na)
        b = jet_where(esc, b, nb)
        c_ = jet_where(esc, c_, nc)
        d = jet_where(esc, d, nd)
        md = jet_where(esc, md, md_new)
        m = jet_where(esc, m, m_new)
    rt = jet_sqrt_floor(m, 1e-12)
    lg = jet_log_floor(m, 1e-12)
    inv_md = jet_inv_floor(jet_max_c(md, 1e-12), 0.0)
    de = 0.25 * rt * lg * inv_md
    return torch.stack([size * de.tx, size * de.ty, size * de.tz], dim=-1)


PROC_GRAD = {"mb": mandelbox_grad, "bulb": mandelbulb_grad,
             "julia": julia_grad}


def proc_grad(spec: tuple, p: torch.Tensor, c: torch.Tensor,
              size: torch.Tensor) -> torch.Tensor:
    """d DE / dp [N, 3] of the leaf whose ``ScenePlan.proc`` entry is
    (leaf, kind, param, iters), at p [N, 3]."""
    _, kind, param, iters = spec
    return PROC_GRAD[kind](p, c, size, param, iters)

