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


def generate_rays(tables: SceneTables, cfg: RenderConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All primary rays of one frame, on the tables' device.

    Returns (origin [3], directions [H, W, S, 3]), S = ssaa^2 samples in
    (i-major, j-minor) order (render.cpp:104-105)."""
    dev = tables.cam_position.device
    f32 = dict(dtype=torch.float32, device=dev)
    w = camera_focal(tables.cam_fov)
    h = w / cfg.aspect_ratio
    k = cfg.ssaa

    px = torch.arange(cfg.width, **f32)
    py = torch.arange(cfg.height, **f32)
    si = (torch.arange(k, **f32) + 1.0) / k
    u = (px[None, :, None, None] + si[None, None, :, None]) / cfg.width
    v = (py[:, None, None, None] + si[None, None, None, :]) / cfg.height

    shape = (cfg.height, cfg.width, k, k)
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
    return tables.cam_position, d.reshape(cfg.height, cfg.width, k * k, 3)
