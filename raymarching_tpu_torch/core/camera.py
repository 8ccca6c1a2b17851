"""Camera: look-at rotation, focal length, primary-ray generation.

Port of ``raymarching_tpu.core.camera`` (object.cpp:23-42 and
render.cpp:82-111 of the reference): the screen plane sits at z = -1 in
camera space, focal width 2 tan(FOV/2), and SSAA sample (i, j) of a k x k
kernel sits at sub-pixel ((i + 1)/k, (j + 1)/k).  Same op order as the JAX
code, so directions agree to float32 rounding.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import RenderConfig
from ..scene.compile import SceneTables

DEG_TO_RAD = math.pi / 180.0


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def camera_rotation(direction: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """3x3 rotation, columns [right, up', -forward] (object.cpp:25-31)."""
    right = _unit(_cross(direction, up))
    up2 = _unit(_cross(right, direction))
    forward = _unit(direction)
    return torch.stack([right, up2, -forward], dim=1)


def camera_focal(fov_deg: torch.Tensor) -> torch.Tensor:
    """focal = 2 tan(FOV/2) (object.cpp:35)."""
    return 2.0 * torch.tan(fov_deg * DEG_TO_RAD / 2.0)


def generate_rays(tables: SceneTables, cfg: RenderConfig, row_range=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All primary rays of one frame, on the tables' device.

    Returns (origin [3], directions [H, W, S, 3]), S = ssaa^2 samples in
    (i-major, j-minor) order (render.cpp:104-105).  ``row_range=(r0, n)``
    gives the rays of image rows [r0, r0 + n) only, [n, W, S, 3], by the
    same per-pixel expression (the row index float(r0) + arange(n), exact
    in float32 below 2^24 rows), so a block's rays are bitwise the whole
    frame's rows (``api.render_tiled``)."""
    dev = tables.cam_position.device
    f32 = dict(dtype=torch.float32, device=dev)
    w = camera_focal(tables.cam_fov)
    h = w / cfg.aspect_ratio
    k = cfg.ssaa

    px = torch.arange(cfg.width, **f32)
    if row_range is None:
        py = torch.arange(cfg.height, **f32)
    else:
        r0, n = row_range
        py = float(r0) + torch.arange(n, **f32)
    si = (torch.arange(k, **f32) + 1.0) / k
    u = (px[None, :, None, None] + si[None, None, :, None]) / cfg.width
    v = (py[:, None, None, None] + si[None, None, None, :]) / cfg.height

    rows = py.shape[0]
    shape = (rows, cfg.width, k, k)
    x = (w * (u - 0.5)).expand(shape)
    y = (h * (0.5 - v)).expand(shape)
    n = torch.sqrt(x * x + y * y + 1.0)    # z = -1, so z^2 is exactly 1
    xc, yc, zc = x / n, y / n, -1.0 / n
    R = camera_rotation(tables.cam_direction, tables.cam_up)
    # Elementwise mul-adds, never a [*, 3] @ [3, 3] product: a float32
    # matmul may run in TF32 on the card (about three decimal digits), the
    # Hopper form of the reduced-precision hazard the JAX code records.
    d = torch.stack([xc * R[0, 0] + yc * R[0, 1] + zc * R[0, 2],
                     xc * R[1, 0] + yc * R[1, 1] + zc * R[1, 2],
                     xc * R[2, 0] + yc * R[2, 1] + zc * R[2, 2]], dim=-1)
    return tables.cam_position, d.reshape(rows, cfg.width, k * k, 3)


def serve_cam_rows(tables: SceneTables, cfg: RenderConfig) -> torch.Tensor:
    """[3, 8] camera rows of the in-kernel raygen (pallas_render
    ._serve_cam_rows): row 0 = [position xyz, focal w, focal h, 0, 0, 0],
    rows 1-2 = the camera rotation row-major (R22 wraps to row 2), on the
    tables' device.  The JAX rows carry a chunk's first ray index as a
    float32 in row 0; here it is an integer argument of the kernel."""
    dev = tables.cam_position.device
    f32 = dict(dtype=torch.float32, device=dev)
    w = camera_focal(tables.cam_fov)
    # a divisor tensor: a CUDA tensor divided by a Python number becomes a
    # product with its reciprocal
    h = w / torch.tensor(cfg.aspect_ratio, **f32)
    R = camera_rotation(tables.cam_direction, tables.cam_up).reshape(9)
    row0 = torch.cat([tables.cam_position.reshape(3), w.reshape(1),
                      h.reshape(1), torch.zeros(3, **f32)])
    return torch.cat([row0, R, torch.zeros(7, **f32)]).reshape(3, 8)


def raygen_dirs(rows: torch.Tensor, cfg: RenderConfig, base: int,
                n: int, block: tuple = (0, 0)) -> torch.Tensor:
    """Directions [n, 3] of rays base .. base + n - 1 of the frame in scan
    order (pixel-major, SSAA sample minor: ``generate_rays``' order), or
    with ``block`` = (bh, bw) in block order (``core.order.to_blocked``'s:
    bh x bw pixel blocks, block-row major), by the in-kernel raygen's
    arithmetic (pallas_render._raygen_dirs, both arms): sample offsets
    (i + 1) (1/k), the pixel lerp times 1/W and 1/H (the reciprocals
    doubles rounded once to float32), normalise with z^2 = 1, rotate;
    ``rows`` from ``serve_cam_rows``.  The plain twin of K1's raygen
    entries.  It differs from ``generate_rays`` by roundings."""
    dev = rows.device
    f32 = dict(dtype=torch.float32, device=dev)
    k, W = cfg.ssaa, cfg.width
    r = torch.arange(base, base + n, dtype=torch.int64, device=dev)
    s, t1 = r % (k * k), r // (k * k)
    bh, bw = block
    if bh:
        t2, t3 = t1 // bw, t1 // bw // bh
        pxi = (t3 % (W // bw)) * bw + t1 % bw
        pyi = (t3 // (W // bw)) * bh + t2 % bh
    else:
        pxi, pyi = t1 % W, t1 // W
    px, py = pxi.to(torch.float32), pyi.to(torch.float32)
    si, sj = (s // k).to(torch.float32), (s % k).to(torch.float32)
    rk, rw, rh = (torch.tensor(v, **f32)
                  for v in (1.0 / k, 1.0 / W, 1.0 / cfg.height))
    u = (px + (si + 1.0) * rk) * rw
    v = (py + (sj + 1.0) * rk) * rh
    x = rows[0, 3] * (u - 0.5)
    y = rows[0, 4] * (0.5 - v)
    nrm = torch.sqrt(x * x + y * y + 1.0)
    xc, yc, zc = x / nrm, y / nrm, torch.full_like(nrm, -1.0) / nrm
    R = rows[1:].reshape(-1)[:9]
    return torch.stack([xc * R[0] + yc * R[1] + zc * R[2],
                        xc * R[3] + yc * R[4] + zc * R[5],
                        xc * R[6] + yc * R[7] + zc * R[8]], dim=-1)


# pi (3 - sqrt(5)): successive lens samples land evenly over the disk (a
# sunflower spiral), so the mean of the ssaa^2 samples converges to the
# lens integral with no random numbers (core.camera.GOLDEN_ANGLE).
GOLDEN_ANGLE = 2.3999632297286533


def lens_offsets(cfg: RenderConfig, device) -> torch.Tensor:
    """[S, 2] sunflower lens-disk offsets of radius ``cfg.aperture`` (world
    units) for thin-lens depth of field (core.camera.lens_offsets)."""
    f32 = dict(dtype=torch.float32, device=device)
    S = cfg.samples_per_pixel
    s = torch.arange(S, **f32)
    r = cfg.aperture * torch.sqrt((s + 0.5) / torch.tensor(S, **f32))
    th = s * GOLDEN_ANGLE
    return torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=-1)


def generate_rays_dof(tables: SceneTables, cfg: RenderConfig, row_range=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin-lens rays of one frame (core.camera.generate_rays_dof) ->
    (origins [H, W, S, 3], directions [H, W, S, 3]), or of the rows
    ``row_range`` of it (``generate_rays``): SSAA sample s starts
    at its lens-disk point (``lens_offsets`` in the camera's right / up
    plane) and aims at its pinhole ray's focal point, where that ray
    crosses the focus plane ``cfg.focus_dist`` along the view axis.  The
    SSAA mean is the lens integral.  Differentiable in the pose, as
    ``generate_rays`` is."""
    o, d = generate_rays(tables, cfg, row_range)
    R = camera_rotation(tables.cam_direction, tables.cam_up)
    right, up2, fwd = R[:, 0], R[:, 1], -R[:, 2]
    off = lens_offsets(cfg, o.device)
    off_w = off[:, 0:1] * right + off[:, 1:2] * up2          # [S, 3]
    # elementwise, never a [*, 3] @ [3] product (generate_rays' note); a
    # tensor numerator (a Python number over a tensor is a reciprocal
    # product in PyTorch)
    focus = torch.tensor(cfg.focus_dist, dtype=d.dtype, device=d.device)
    tf = focus / (d[..., 0] * fwd[0] + d[..., 1] * fwd[1] + d[..., 2] * fwd[2])
    pf = o + tf[..., None] * d
    origins = o.expand(d.shape) + off_w
    dirs = pf - origins
    norm = torch.sqrt((dirs * dirs).sum(dim=-1, keepdim=True))
    return origins, dirs / norm
