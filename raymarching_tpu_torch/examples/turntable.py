"""Turntable animation: render N frames orbiting the demo scene.

Production-shaped throughput demo: every frame is one ``render_tables``
call with only the camera changed.  The port of the JAX repo's
``examples/turntable.py``: fused generators and FD normals, so on the card
a frame is one launch of K1's fused entry.  The first frame also loads the
kernel library (and builds it, on a checkout that has not built it yet);
it is printed apart, and the steady frames after it give s/frame and fps.

    python -m raymarching_tpu_torch.examples.turntable [--frames 24]
        [--out $TMPDIR/turntable] [--width 512] [--height 384]
        [--device cuda] [--backend cuda]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..api import render_tables
from ..config import RenderConfig
from ..io.image import save_image
from ..scene.compile import compile_scene
from ..scene.parser import load_scene
from ..tables import tables_to_torch

SCENE = Path(__file__).resolve().parents[2] / "scenes" / "demo.txt"
# the orbit's centre: the scene's middle, not the mean leaf position that
# api.turntable_poses takes by default
CENTRE = np.array([5.0, 5.0, -35.0], np.float32)


def setup(cfg: RenderConfig | None = None, width: int = 512,
          height: int = 384):
    """(plan, tables, tables0, cfg): the demo compiled, its tables at the
    orbit's first pose, and the script's frame (SSAA 2, 1,000 iterations,
    FD normals, fused generators; or ``cfg``)."""
    plan, tables = compile_scene(load_scene(str(SCENE)))
    cfg = cfg or RenderConfig(width=width, height=height, ssaa=2,
                              iterations=1000, normal_mode="fd",
                              fused_generators=True)
    pos, look = poses(tables, 1)[0]
    return plan, tables, tables._replace(cam_position=pos,
                                         cam_direction=look), cfg


def poses(tables, frames: int) -> list:
    """(position, direction) float32 [3] of each frame: the original camera
    position orbited about CENTRE in the xz plane at its starting radius
    and height, looking at the centre."""
    p0 = np.asarray(tables.cam_position) - CENTRE
    radius = float(np.linalg.norm(p0[[0, 2]]))
    phi0 = math.atan2(float(p0[2]), float(p0[0]))
    out = []
    for i in range(frames):
        phi = phi0 + 2.0 * math.pi * i / frames
        pos = CENTRE + np.array([radius * math.cos(phi), float(p0[1]),
                                 radius * math.sin(phi)], np.float32)
        look = CENTRE - pos
        out.append((pos, look / np.linalg.norm(look)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "turntable"))
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--backend", default="cuda",
                    help="render backend: cuda, multi, ref or torch")
    args = ap.parse_args(argv)

    plan, tables, _, cfg = setup(width=args.width, height=args.height)
    dev = torch.device(args.device)
    tt = tables_to_torch(tables, dev)

    os.makedirs(args.out, exist_ok=True)
    times = []
    for i, (pos, look) in enumerate(poses(tables, args.frames)):
        t = tt._replace(cam_position=torch.as_tensor(pos, device=dev),
                        cam_direction=torch.as_tensor(look, device=dev))
        t0 = time.perf_counter()
        img = render_tables(plan, t, cfg, backend=args.backend,
                            device=dev).cpu().numpy()
        times.append(time.perf_counter() - t0)
        save_image(os.path.join(args.out, f"frame_{i:03d}.png"), img)

    steady = times[1:] or times
    print(f"{args.frames} frames -> {args.out}; first (library load) "
          f"{times[0]:.2f}s, steady {np.mean(steady):.3f}s/frame "
          f"({1.0 / np.mean(steady):.1f} fps at "
          f"{args.width}x{args.height} SSAA2)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
