"""The reference's renderer, plain PyTorch: camera, march, shading.

The reference project's model (RevelcoS/Raymarching, render.cpp:82-120,
scene.cpp:26-89, object.cpp:23-42): a pinhole camera whose screen sits at
z = -1, focal width 2 tan(FOV / 2), SSAA sample (i, j) of a k x k kernel at
sub-pixel ((i + 1) / k, (j + 1) / k); a sphere-tracing march of at most
``iterations`` steps, p += sd * ray, done once sd < eps; the surface colour
taken one step back; the normal the central difference of the field with
step h; each light counts when a march from the hit, lifted off the surface
by 2 eps along the normal, passes it; the Lambert sum clamped to
[saturation, 1], times the colour; the mean of the SSAA samples.

Every operation is written out elementwise (no matrix products, which may
run in TF32 on the card), in the order the renderer under test documents
for its own plain path, so the two agree to rounding and differ only where
a rounding moves a ray across an edge or a shadow's rim.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .field import Field

DEG_TO_RAD = math.pi / 180.0
MAX_STEP = 1e5


class Settings(NamedTuple):
    width: int
    height: int
    ssaa: int
    iterations: int = 1000
    eps: float = 1e-3            # surface precision (constants.h)
    offset: float = 1e-3         # shadow-ray offset precision
    saturation: float = 0.05
    fd_h: float = 1e-3
    shadows: bool = True

    @classmethod
    def of(cls, d: dict) -> "Settings":
        return cls(**{k: d[k] for k in cls._fields if k in d})


def dot3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _unit(v):
    return v / torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def rotation(direction, up):
    """Columns right, up', -forward (object.cpp:25-31)."""
    right = _unit(_cross(direction, up))
    up2 = _unit(_cross(right, direction))
    return torch.stack([right, up2, -_unit(direction)], dim=1)


def camera_dirs(position, direction, up, fov, st: Settings, py, px):
    """Directions [n, S, 3] of the SSAA samples of pixels (py, px) (float
    tensors [n] of row and column), S = ssaa^2, i-major."""
    f = dict(dtype=position.dtype, device=position.device)
    w = 2.0 * torch.tan(fov * DEG_TO_RAD / 2.0)
    h = w / (float(st.width) / float(st.height))
    k = st.ssaa
    si = (torch.arange(k, **f) + 1.0) / k
    u = (px[:, None, None] + si[None, :, None]) / st.width
    v = (py[:, None, None] + si[None, None, :]) / st.height
    shape = (px.shape[0], k, k)
    x = (w * (u - 0.5)).expand(shape)
    y = (h * (0.5 - v)).expand(shape)
    n = torch.sqrt(x * x + y * y + 1.0)
    xc, yc, zc = x / n, y / n, -1.0 / n
    R = rotation(direction, up)
    d = torch.stack([xc * R[0, 0] + yc * R[0, 1] + zc * R[0, 2],
                     xc * R[1, 0] + yc * R[1, 1] + zc * R[1, 2],
                     xc * R[2, 0] + yc * R[2, 1] + zc * R[2, 2]], dim=-1)
    return d.reshape(px.shape[0], k * k, 3)


class March(NamedTuple):
    position: torch.Tensor
    sd: torch.Tensor
    converged: torch.Tensor
    steps: torch.Tensor


def march(field: Field, origin, ray, iterations: int, eps: float,
          tmax: Optional[torch.Tensor] = None) -> March:
    """Early-exit sphere tracing of rays ``ray`` [N, 3] from ``origin``
    [3] or [N, 3]: the rays still marching are gathered before each step.
    The position moves before the convergence test, so a hit carries one
    sub-eps step and ``sd`` is the value one step back.  With ``tmax`` a
    ray also stops once the sum of its steps reaches it."""
    o = origin.expand(ray.shape)
    p = o.clone()
    n = ray.shape[0]
    f = dict(dtype=ray.dtype, device=ray.device)
    sd_last = torch.full((n,), float("inf"), **f)
    done = torch.zeros(n, dtype=torch.bool, device=ray.device)
    t = torch.zeros(n, **f)
    steps = torch.zeros(n, dtype=torch.int64, device=ray.device)
    for _ in range(iterations):
        act = (~done).nonzero().squeeze(1)
        if act.numel() == 0:
            break
        pa, ra = p[act], ray[act]
        sd = field(pa)
        step = torch.clamp_max(sd, MAX_STEP)
        pa = pa + step[:, None] * ra
        dn = sd < eps
        if tmax is not None:
            ta = t[act] + step
            t[act] = ta
            dn = dn | (ta >= tmax[act])
        p[act] = pa
        sd_last[act] = sd
        done[act] = dn
        steps[act] += 1
    return March(p, sd_last, done & (sd_last < eps), steps)


def normalize(v):
    """Zero or non-finite vectors map to zero, not NaN."""
    tiny = torch.finfo(v.dtype).tiny
    v = torch.where(torch.isfinite(v), v, torch.zeros((), dtype=v.dtype,
                                                      device=v.device))
    sq = (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
          + v[..., 2] * v[..., 2])[..., None]
    norm = torch.sqrt(torch.clamp_min(sq, tiny))
    return v / torch.clamp_min(norm, tiny)


class Shaded(NamedTuple):
    color: torch.Tensor          # [N, 3]
    light: torch.Tensor          # [N]
    cidx: torch.Tensor           # [N] colour winner leaf
    hit: March
    normal: torch.Tensor         # [N, 3]
    stencil: list                # 6 x (winner [N], sign [N]): +x, -x, +y...
    hit_winner: tuple            # (winner [N], sign [N]) at the hit
    shadow: list                 # per light: [N] bool, True = shadowed
    shadow_steps: list           # per light: [N] int64


def shade(field: Field, tables: dict, st: Settings, origin, dirs,
          keep: bool = False) -> Shaded:
    """Colours of rays ``dirs`` [N, 3] from ``origin`` [3].  ``tables``:
    the scene tables as tensors of the field's dtype.  With ``keep`` the
    winners of the hit and of the normal's stencil are kept too (the fit's
    replay)."""
    res = march(field, origin, dirs, st.iterations, st.eps)
    p = res.position
    p_color = p - torch.clamp_max(res.sd, MAX_STEP)[:, None] * dirs
    _, cidx, _ = field(p_color, with_winner=True)
    eye = torch.eye(3, dtype=p.dtype, device=p.device) * st.fd_h
    cols, stencil = [], []
    for a in range(3):
        hi = field(p + eye[a], with_winner=keep)
        lo = field(p - eye[a], with_winner=keep)
        if keep:
            stencil += [hi[1:], lo[1:]]
            hi, lo = hi[0], lo[0]
        cols.append(hi - lo)
    n = normalize(torch.stack(cols, dim=-1) / (2.0 * st.fd_h))
    hit_winner = field(p, with_winner=True)[1:] if keep else None
    L = len(field.scene.lights)
    total = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    masks, ssteps = [], []
    for li in range(L):
        lp = tables["light_pos"][li]
        lam = dot3(n, normalize(lp - p))
        if st.shadows:
            ray = normalize(lp - p)
            start = p + n * (st.eps + st.offset)
            r = lp - start
            sh = march(field, start, ray, st.iterations, st.eps,
                       tmax=torch.sqrt(dot3(r, r)))
            mask = dot3(lp - sh.position, ray) > 0
            lam = torch.where(mask, 0.0, lam)
            masks.append(mask)
            ssteps.append(sh.steps)
        total = total + lam
    light = torch.clamp(total, st.saturation, 1.0)
    color = light[:, None] * tables["prim_color"][cidx]
    return Shaded(color, light, cidx, res, n, stencil, hit_winner, masks,
                  ssteps)


def render_pixels(field: Field, tables: dict, st: Settings, position,
                  direction, py, px, chunk: int = 1 << 16):
    """Colours [n, 3] of pixels (py, px) seen from camera ``position`` /
    ``direction`` (the scene's up and FOV), the mean of their SSAA samples,
    and the steps their rays took: (colours, primary steps [n, S], shadow
    steps [n, S] summed over the lights)."""
    dirs = camera_dirs(position, direction, tables["cam_up"],
                       tables["cam_fov"], st, py, px)
    n, S = dirs.shape[:2]
    flat = dirs.reshape(-1, 3)
    cols, prim, shad = [], [], []
    for i in range(0, flat.shape[0], chunk):
        r = shade(field, tables, st, position, flat[i:i + chunk])
        cols.append(r.color)
        prim.append(r.hit.steps)
        shad.append(sum(r.shadow_steps) if r.shadow_steps else
                    torch.zeros_like(r.hit.steps))
    colors = torch.cat(cols).reshape(n, S, 3).mean(dim=1)
    return (colors, torch.cat(prim).reshape(n, S),
            torch.cat(shad).reshape(n, S))


def tables_on(tables: dict, device, dtype) -> dict:
    """The scene tables as tensors on ``device`` in ``dtype``."""
    return {k: torch.as_tensor(v, device=device).to(dtype)
            for k, v in tables.items()}
