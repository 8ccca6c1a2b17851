"""Command-line entry point of the port.

    python -m raymarching_tpu_torch --scene scenes/demo.txt --out out.png
    python -m raymarching_tpu_torch --scene scenes/demo.txt \
        --backend ref,torch,multi,cuda --width 128 --height 96 --ssaa 1 \
        --compare
    python -m raymarching_tpu_torch --scene scenes/demo.txt \
        --normal-mode analytic --out analytic.png
    python -m raymarching_tpu_torch --scene scenes/demo.txt \
        --soft-shadow-k 6 --ao 0.8 --out soft.png
    python -m raymarching_tpu_torch --scene scenes/mirror.txt \
        --reflect 0.4 --bounces 2 --aperture 0.2 --focus 8 --out dof.png
    python -m raymarching_tpu_torch --scene scenes/demo.txt \
        --row-block 128 --out big.png          # streamed in row blocks
    python -m raymarching_tpu_torch --scene scenes/demo.txt \
        --animate 24 --orbit 360 --out orbit.gif   # or frames orbit_000.png
    python -m raymarching_tpu_torch --scene scenes/demo.txt \
        --mesh demo.obj --mesh-res 128         # mesh only, no render
    python -m raymarching_tpu_torch --scene scenes/demo.txt --selfcheck \
        --stats --log-json - --profile trace/

Defaults are the reference configuration (1024x768, SSAA 3x3, 1000
iterations) on the CUDA device; ``--device cpu`` runs the plain PyTorch
versions of the kernels instead.  The options are the JAX package's CLI's
(``raymarching_tpu/cli.py``), with its rules: ``--animate`` renders one
backend and takes no ``--compare`` or ``--row-block`` (exit 2); a failed
``--selfcheck`` exits 3.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

from .config import RenderConfig
from .io.image import save_image
from .scene.compile import compile_scene
from .scene.parser import load_scene
from .utils import structlog
from .utils.structlog import emit
from .utils.timing import Phase, profile_march, profiler_trace

from .api import (render_tables, render_tiled, resolve_backend,
                  resolve_device, turntable_frames)

IMAGE_FORMATS = (".png", ".ppm", ".jpg", ".jpeg", ".pfm", "")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raymarching_tpu_torch",
        description="sphere-tracing renderer, PyTorch + CUDA port")
    p.add_argument("--scene", required=True,
                   help="scene text file (reference objects.txt grammar)")
    p.add_argument("--out", default=None,
                   help="output image (.png/.ppm/.jpg/.pfm; default "
                        "out.png; with --mesh and no --out the render is "
                        "skipped)")
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
                   help="comma list of cuda|multi|ref|torch (fused "
                        "kernel, multi-kernel, plain oracle, plain with the "
                        "implicit-function march); the last one is saved")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:N, cpu)")
    p.add_argument("--ray-chunk", type=int, default=0,
                   help="rays a kernel launch (0: the whole frame at once)")
    p.add_argument("--row-block", type=int, default=0, metavar="N",
                   help="stream the frame through the device N rows at a "
                        "time (api.render_tiled): frames whose rays do "
                        "not fit in device memory; single-frame mode only")
    p.add_argument("--animate", type=int, default=0, metavar="N",
                   help="render an N-frame turntable orbit instead of one "
                        "image; --out .gif writes an animated GIF, else "
                        "numbered frames <out>_000.png ... (the server's "
                        "/animate)")
    p.add_argument("--orbit", type=float, default=360.0, metavar="DEG",
                   help="turntable sweep in degrees (with --animate)")
    p.add_argument("--delay-cs", type=int, default=4,
                   help="GIF frame delay in centiseconds (with --animate)")
    p.add_argument("--mesh", default=None, metavar="PATH",
                   help="also extract the scene's zero isosurface as a "
                        "triangle mesh (.obj/.ply; marching tetrahedra "
                        "over an SDF grid sampled by K2)")
    p.add_argument("--mesh-res", type=int, default=128,
                   help="mesh grid samples per axis (with --mesh)")
    p.add_argument("--mesh-bounds", type=float, nargs=6, default=None,
                   metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
                   help="mesh grid world bounds (default: the scene's "
                        "solid-geometry bounding box)")
    p.add_argument("--compare", action="store_true",
                   help="print the max abs difference between backends")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="write a torch.profiler Chrome trace of the "
                        "render into LOGDIR")
    p.add_argument("--stats", action="store_true",
                   help="print march convergence / iteration statistics "
                        "(K3's step counts at reduced resolution)")
    p.add_argument("--log-json", default=None, metavar="PATH",
                   help="append structured JSON-lines events to PATH; "
                        "'-' for stderr")
    p.add_argument("--selfcheck", action="store_true",
                   help="bitwise re-render and oracle check before "
                        "rendering; exit 3 on failure")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    render_wanted = args.out is not None or args.mesh is None
    out = args.out if args.out is not None else "out.png"
    ext = os.path.splitext(out)[1].lower()
    if render_wanted and ext not in IMAGE_FORMATS and not (
            args.animate > 0 and ext == ".gif"):
        print(f"error: unsupported output format {ext!r} "
              "(png, ppm, jpg, pfm are supported)", file=sys.stderr)
        return 2
    if args.mesh is not None and not args.mesh.lower().endswith(
            (".obj", ".ply")):
        print(f"error: unsupported mesh format {args.mesh!r} "
              "(obj, ply are supported)", file=sys.stderr)
        return 2
    if not os.path.exists(args.scene):
        print(f"error: scene file not found: {args.scene}", file=sys.stderr)
        return 2
    try:
        backends = [resolve_backend(b.strip())
                    for b in args.backend.split(",") if b.strip()]
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.animate > 0 and (args.compare or len(backends) > 1
                             or args.row_block > 0):
        print("error: --animate renders one backend; --compare, backend "
              "lists and --row-block apply to single-frame mode only",
              file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e} (use --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    if args.log_json:
        structlog.configure(
            path=None if args.log_json == "-" else args.log_json).log(
                "start", scene=args.scene, resolution=[args.width,
                                                       args.height],
                ssaa=args.ssaa, device=str(device))
    try:
        return _run(args, backends, device, render_wanted, out, ext)
    finally:
        if args.log_json:
            structlog.reset()


def _run(args, backends, device, render_wanted: bool, out: str,
         ext: str) -> int:
    with Phase("scene load"):
        plan, tables = compile_scene(load_scene(args.scene))
    print(f"scene: {plan.num_primitives} primitives, {plan.num_lights} "
          f"lights, kernel-form={'yes' if plan.kernel else 'no'}; "
          f"device {device}")
    emit("scene", primitives=int(plan.num_primitives),
         lights=int(plan.num_lights), kernel_form=plan.kernel is not None)
    cfg = RenderConfig(width=args.width, height=args.height, ssaa=args.ssaa,
                       iterations=args.iterations, gamma=args.gamma,
                       shadows=args.shadows, normal_mode=args.normal_mode,
                       ray_chunk=args.ray_chunk,
                       soft_shadow_k=args.soft_shadow_k, ao_strength=args.ao,
                       reflect_strength=args.reflect,
                       reflect_bounces=args.bounces, aperture=args.aperture,
                       focus_dist=args.focus)
    rays = cfg.rays_per_image
    backend = backends[-1]

    if args.selfcheck:
        from .utils.selfcheck import assert_healthy
        try:
            report = assert_healthy(plan, tables, backend=backend,
                                    device=device)
        except RuntimeError as e:
            print(f"selfcheck FAILED: {e}", file=sys.stderr)
            return 3
        print(f"selfcheck ok (rerun x{report['rerun']['repeats']} bitwise, "
              f"oracle bad-frac {report['oracle']['bad_pixel_frac']:.4f})")

    if args.mesh is not None:
        from .io.mesh import extract_mesh, save_mesh
        b = args.mesh_bounds
        with Phase("mesh extract"):
            verts, faces = extract_mesh(
                plan, tables, resolution=max(2, args.mesh_res),
                bounds=None if b is None else (b[:3], b[3:]),
                device=device)
        with Phase("mesh save"):
            save_mesh(args.mesh, verts, faces)
        print(f"wrote {args.mesh} ({len(verts)} vertices, "
              f"{len(faces)} triangles)")
        emit("mesh", out=args.mesh, vertices=int(len(verts)),
             triangles=int(len(faces)))
        if not render_wanted:
            emit("done", out=args.mesh)
            return 0

    if args.stats:
        # K3's step counts at reduced resolution (its twin's on the CPU)
        small = cfg.replace(width=min(cfg.width, 256),
                            height=min(cfg.height, 192), ssaa=1)
        print("march stats (primary rays, reduced res):",
              json.dumps(profile_march(plan, tables, small, device=device)))

    if args.animate > 0:
        with profiler_trace(args.profile):
            with Phase(f"{backend} animate x{args.animate}",
                       rays=args.animate * rays) as ph:
                frames = list(turntable_frames(
                    plan, tables, cfg, args.animate,
                    orbit=math.radians(args.orbit), backend=backend,
                    device=device))
        emit("animate", backend=backend, frames=args.animate,
             seconds=round(ph.seconds, 6),
             mrays_per_s=round(args.animate * rays / ph.seconds / 1e6, 4))
        with Phase("save"):
            if ext == ".gif":
                from .io.gif import encode_gif
                from .io.image import to_uint8
                data = encode_gif(
                    (to_uint8(f, cfg.gamma) for f in frames),
                    delay_cs=max(1, min(args.delay_cs, 1000)))
                with open(out, "wb") as fh:
                    fh.write(data)
                print(f"wrote {out} ({args.animate} frames)")
            else:
                stem, fext = os.path.splitext(out)
                for i, f in enumerate(frames):
                    save_image(f"{stem}_{i:03d}{fext or '.png'}", f,
                               gamma=cfg.gamma)
                print(f"wrote {stem}_000{fext or '.png'} .. "
                      f"{stem}_{len(frames) - 1:03d}{fext or '.png'}")
        emit("done", out=out)
        return 0

    images = {}
    with profiler_trace(args.profile):
        for be in backends:
            if args.row_block > 0:
                with Phase(f"{be} render (tiled, {args.row_block} rows a "
                           "block)", rays=rays) as ph:
                    img = render_tiled(plan, tables, cfg,
                                       row_block=args.row_block, backend=be,
                                       device=device)
            else:
                with Phase(f"{be} render (incl. build)", rays=rays) as ph:
                    img = ph.sync(render_tables(plan, tables, cfg,
                                                backend=be, device=device))
            images[be] = img
            emit("render", backend=be, seconds=round(ph.seconds, 6),
                 mrays_per_s=round(rays / ph.seconds / 1e6, 4))

    if args.compare and len(images) > 1:
        names = list(images)
        for other in names[1:]:
            diff = float(np.abs(images[other] - images[names[0]]).max())
            print(f"max |{other} - {names[0]}| = {diff:.2e}")

    with Phase("save"):
        save_image(out, images[backend], gamma=cfg.gamma)
    print(f"wrote {out}")
    emit("done", out=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
