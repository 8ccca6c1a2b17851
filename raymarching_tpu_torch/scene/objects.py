"""Non-body scene objects: lights and camera.

Replaces the reference's ``Object`` namespace (source/object.cpp,
source/include/object.h).  Camera math spec (object.cpp:23-42):

  - look-at transform columns: [right, up', -forward, position] with
      right   = normalize(cross(direction, up))
      up'     = normalize(cross(right, direction))
      forward = normalize(direction)
  - focal = 2 * tan(FOV * pi/180 / 2)
  - view(v, offset): transform @ [v, offset ? 1 : 0] — point vs direction.

Defaults (object.h:35-38): position (0,0,0), direction (0,0,-1),
up (0,1,0), FOV 90.  Lights default to white (object.h:24; the scene parser
never sets light color, scene.cpp:154-158).

Numerics here are plain Python/NumPy — camera parameters enter the traced
program as a pytree (see scene.compile.camera_pytree) so camera-pose
gradients flow through a jnp re-implementation in core.camera.

The port's own copy of ``raymarching_tpu.scene.objects`` (same names, same behaviour; a test
holds the two equal), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

Vec3 = Tuple[float, float, float]

DEG_TO_RAD = math.pi / 180.0


@dataclasses.dataclass
class Light:
    position: Vec3
    color: Vec3 = (1.0, 1.0, 1.0)

    def __post_init__(self):
        self.position = tuple(float(v) for v in self.position)
        self.color = tuple(float(v) for v in self.color)


@dataclasses.dataclass
class Camera:
    position: Vec3 = (0.0, 0.0, 0.0)
    direction: Vec3 = (0.0, 0.0, -1.0)
    up: Vec3 = (0.0, 1.0, 0.0)
    fov: float = 90.0

    def __post_init__(self):
        self.position = tuple(float(v) for v in self.position)
        self.direction = tuple(float(v) for v in self.direction)
        self.up = tuple(float(v) for v in self.up)
        self.fov = float(self.fov)

    @property
    def focal(self) -> float:
        return 2.0 * math.tan(self.fov * DEG_TO_RAD / 2.0)

    def rotation(self) -> np.ndarray:
        """3x3 rotation with columns [right, up', -forward] (object.cpp:25-31)."""
        direction = np.asarray(self.direction, np.float64)
        up = np.asarray(self.up, np.float64)
        right = np.cross(direction, up)
        right = right / np.linalg.norm(right)
        up2 = np.cross(right, direction)
        up2 = up2 / np.linalg.norm(up2)
        forward = direction / np.linalg.norm(direction)
        return np.stack([right, up2, -forward], axis=1).astype(np.float32)

    def transform(self) -> np.ndarray:
        """Full 4x4 column-major look-at transform (object.cpp:27-30)."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.rotation()
        m[:3, 3] = np.asarray(self.position, np.float32)
        return m

    def view(self, v: Vec3, offset: bool = True) -> np.ndarray:
        """Apply the transform with w=1 (point) or w=0 (direction)
        (object.cpp:38-42)."""
        v = np.asarray(v, np.float32)
        out = self.rotation() @ v
        if offset:
            out = out + np.asarray(self.position, np.float32)
        return out
