"""The benchmark's own count of a frame's work, for K1's roofline share.

The count reads the same work whatever implements the kernel: the steps the
benchmark's plain march (``reference.render``) takes on each ray, times the
operations of one evaluation of the field from a frozen cost table by
primitive.  It never reads the program's own counters.

Operations of one field evaluation (value only, float32):

  sphere   11  3 sub, 3 mul, 2 add, clamp, sqrt, sub
  box      14  3 sub, 3 abs, 3 mul (s/2), 3 sub, 2 max
  cross    16  the box's 12, then the median: 4 min/max
  fold      1  a body's entry folded into its list or the root (min/max)
  negate    1  an entry that enters its list negated
  sponge   33  a level of the closed-form Menger fold (3 mul, 3 mod at 2
               each, 3 sub, a scale, 3 abs, 3 mul, 3 sub, 3 abs, 3 max,
               3 min/sub, a divide, a max), times its iterations, plus the
               bounding box; a sponge counts as this fold, not as its
               20^k crosses

A ray's work:

  step     8  per march step beyond the field: p += sd d (6), the test,
              the step sum of a shadow march
  ray     (primary steps + shadow steps + 1 colour + 6 normal) field
          evaluations and the steps' overhead, plus
  shade   20  the normal's differences and normalisation, plus
  light   24  per light: direction and normalisation, Lambert dot, the
              shadow ray's start and length, plus
  colour   5  the clamp and the colour product

Bytes: each ray's direction read once (12 B) and its colour written once
(12 B), the scene tables read once.  Peaks: the H100 SXM's published float32
rate outside the tensor cores, 67 TFLOP/s, and its HBM3 bandwidth, 3.35 TB/s
(NVIDIA's data sheet, at the 700 W power limit).

A window's count (``frame_work``) takes ``PIXELS`` seeded pixels, all their
SSAA samples, of each pose the window rendered, marches their rays with the
reference, and weights each pose's mean ray by the frames of that pose.  It
reads only what the runner saw (the scene, the settings, the poses, the
frames of each pose, the seed), so a further roofline share is one more
reader and needs no change to a runner.
"""

from __future__ import annotations

import numpy as np
import torch

from . import traffic
from .reference.field import Field
from .reference.render import camera_dirs, shade, tables_on
from .reference.scene import BOX, CROSS, SPHERE, Scene

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

LEAF = {SPHERE: 11, BOX: 14, CROSS: 16}
FOLD = 1
NEGATE = 1
SPONGE_LEVEL = 33
STEP = 8
SHADE = 20
LIGHT = 24
COLOUR = 5
RAY_BYTES = 24
TABLE_BYTES_PER_LEAF = 36
PIXELS = 16             # sampled pixels a pose, in a window's count


def field_ops(scene: Scene) -> int:
    """Operations of one evaluation of the scene's field."""
    ops = 0
    for b in scene.bodies:
        if b.kind == "menger":
            ops += LEAF[BOX] + SPONGE_LEVEL * b.iterations + FOLD + NEGATE
        elif b.mode is None:
            ops += LEAF[int(scene.ptype[b.start])]
        else:
            ops += sum(LEAF[int(t)] for t in
                       scene.ptype[b.start:b.start + b.count])
            ops += FOLD * (b.count - 1)
            ops += NEGATE * (b.count if b.kind == "bounds" else b.count - 1)
        ops += FOLD
    return ops


def ray_ops(scene: Scene, primary_steps, shadow_steps):
    """Operations of each ray whose primary and (summed) shadow marches
    took these steps (tensors or numbers, elementwise)."""
    L = len(scene.lights)
    evals = primary_steps + shadow_steps + 7
    return (evals * field_ops(scene) + (primary_steps + shadow_steps) * STEP
            + SHADE + LIGHT * L + COLOUR)


def frame_bytes(scene: Scene, rays: int) -> float:
    return float(RAY_BYTES * rays + TABLE_BYTES_PER_LEAF * len(scene.ptype))


def roofline_pct(ops: float, nbytes: float, seconds: float):
    """The share in % of ``seconds`` that the larger of the two bounds
    takes, and which bound it is."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 100.0 * max(t_ops, t_bytes) / seconds, (
        "operations" if t_ops >= t_bytes else "bytes")


def frame_work(seen: dict, pixels: int = PIXELS):
    """(operations, bytes) of a frame window's frames, from what the runner
    saw: ``scene``, ``settings`` (the reference's), ``positions`` and
    ``directions`` [poses, 3] of the orbit, ``counts`` [poses] the frames
    rendered of each, ``seed`` and ``device``."""
    scene, st, dev = seen["scene"], seen["settings"], seen["device"]
    counts = np.asarray(seen["counts"])
    P = torch.as_tensor(seen["positions"], device=dev)
    D = torch.as_tensor(seen["directions"], device=dev)
    field = Field(scene, dev, torch.float32)
    rt = tables_on(scene.tables(), dev, torch.float32)
    g = traffic.rng(seen["seed"], 5)
    rays = st.width * st.height * st.ssaa ** 2
    poses = np.nonzero(counts)[0]
    o, d = [], []
    for i in poses:
        py, px = traffic.pixel_sample(g, st.height, st.width, pixels, dev)
        di = camera_dirs(P[i], D[i], rt["cam_up"], rt["cam_fov"], st, py,
                         px).reshape(-1, 3)
        o.append(P[i].expand_as(di))
        d.append(di)
    r = shade(field, rt, st, torch.cat(o), torch.cat(d))
    per = ray_ops(scene, r.hit.steps, sum(r.shadow_steps)).double()
    per_pose = per.reshape(len(poses), -1).mean(1).cpu()
    ops = float((torch.as_tensor(counts[poses]).double() * per_pose).sum())
    return ops * rays, float(counts.sum()) * frame_bytes(scene, rays)
