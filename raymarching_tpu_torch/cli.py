"""Command-line entry point of the port.

    python -m raymarching_tpu_torch --scene scenes/demo.txt --out out.png
    python -m raymarching_tpu_torch --scene scenes/demo.txt \
        --backend ref,multi,cuda --width 128 --height 96 --ssaa 1 --compare
    python -m raymarching_tpu_torch --scene scenes/demo.txt \
        --normal-mode analytic --out analytic.png
    python -m raymarching_tpu_torch --scene scenes/demo.txt \
        --soft-shadow-k 6 --ao 0.8 --out soft.png
    python -m raymarching_tpu_torch --scene scenes/mirror.txt \
        --reflect 0.4 --bounces 2 --aperture 0.2 --focus 8 --out dof.png

Defaults are the reference configuration (1024x768, SSAA 3x3, 1000
iterations) on the CUDA device; ``--device cpu`` runs the plain PyTorch
versions of the kernels instead.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .config import RenderConfig
from .io.image import save_image
from .scene.compile import compile_scene
from .scene.parser import load_scene

from .api import render_tables, resolve_backend, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raymarching_tpu_torch",
        description="sphere-tracing renderer, PyTorch + CUDA port")
    p.add_argument("--scene", required=True,
                   help="scene text file (reference objects.txt grammar)")
    p.add_argument("--out", default="out.png",
                   help="output image (.png/.ppm/.jpg/.pfm)")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--ssaa", type=int, default=3, help="SSAA kernel size")
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--shadows", action=argparse.BooleanOptionalAction,
                   default=True, help="hard shadow rays (default on)")
    p.add_argument("--soft-shadow-k", type=float, default=0.0,
                   help="penumbra sharpness for soft shadows (extension; "
                        "0 = the reference's hard shadows)")
    p.add_argument("--ao", type=float, default=0.0, metavar="STRENGTH",
                   help="SDF ambient-occlusion strength (extension; "
                        "0 = off)")
    p.add_argument("--reflect", type=float, default=0.0, metavar="S",
                   help="mirror reflection strength in [0, 1), 0 = off "
                        "(tinted-mirror extension)")
    p.add_argument("--bounces", type=int, default=1,
                   help="mirror bounce count (with --reflect)")
    p.add_argument("--aperture", type=float, default=0.0, metavar="RADIUS",
                   help="thin-lens aperture radius in world units "
                        "(extension; 0 = pinhole; blur quality scales "
                        "with --ssaa)")
    p.add_argument("--focus", type=float, default=6.0, metavar="DIST",
                   help="focus-plane distance along the view axis "
                        "(with --aperture)")
    p.add_argument("--normal-mode", choices=["fd", "analytic"], default="fd",
                   help="surface normals: fd = 6-eval central differences "
                        "(reference parity), analytic = the SDF's exact "
                        "gradient, one evaluation")
    p.add_argument("--backend", default="cuda",
                   help="comma list of cuda|multi|ref (fused kernel, "
                        "multi-kernel, plain oracle); the last one is saved")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:N, cpu)")
    p.add_argument("--compare", action="store_true",
                   help="print the max abs difference between backends")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.scene):
        print(f"error: scene file not found: {args.scene}", file=sys.stderr)
        return 2
    try:
        backends = [resolve_backend(b.strip())
                    for b in args.backend.split(",") if b.strip()]
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e} (use --device cpu for the plain versions)",
              file=sys.stderr)
        return 2

    plan, tables = compile_scene(load_scene(args.scene))
    cfg = RenderConfig(width=args.width, height=args.height, ssaa=args.ssaa,
                       iterations=args.iterations, gamma=args.gamma,
                       shadows=args.shadows, normal_mode=args.normal_mode,
                       soft_shadow_k=args.soft_shadow_k, ao_strength=args.ao,
                       reflect_strength=args.reflect,
                       reflect_bounces=args.bounces, aperture=args.aperture,
                       focus_dist=args.focus)
    print(f"scene: {plan.num_primitives} primitives, {plan.num_lights} "
          f"lights; device {device}")

    images = {}
    for backend in backends:
        t0 = time.perf_counter()
        img = render_tables(plan, tables, cfg, backend=backend, device=device)
        images[backend] = img.cpu().numpy()   # waits for the device
        dt = time.perf_counter() - t0
        print(f"{backend}: {dt:.3f} s, "
              f"{cfg.rays_per_image / dt / 1e6:.3f} Mrays/s (incl. build)")

    if args.compare and len(images) > 1:
        names = list(images)
        for other in names[1:]:
            diff = float(np.abs(images[other] - images[names[0]]).max())
            print(f"max |{other} - {names[0]}| = {diff:.2e}")

    save_image(args.out, images[backends[-1]], gamma=cfg.gamma)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
