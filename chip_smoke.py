"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, every failure an uncaught exception:
  1. device  — a CUDA device is required; its name and power limit;
  2. build   — nvcc builds the port's kernel from csrc/;
  3. compare — K1 (ops.render_kernel.render_rays) against its plain
               PyTorch twin on demo, config1-4 and menger4, and the demo
               image against the port's ref oracle;
  4. main    — the demo through ``raymarching_tpu_torch.render`` at 512x512
               SSAA 2 and at the reference's 1024x768 SSAA 3, 1000
               iterations (median of three warm frames), counting kernel
               launches; then K1 (median of five launches) against its
               plain twin at those shapes, timed with CUDA events;
  5. serve   — the port's HTTP server answers /healthz and three /render
               requests with PNGs equal to direct renders.
Then the kernel table as JSON and, last, the device line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DEMO = ROOT / "scenes" / "demo.txt"
# kernel vs plain twin: discrete outputs equal on this share of rays, hit
# points and SDs within P_ATOL where convergence agrees, images within
# IMG_ATOL (tests/test_mega.py's cross-path image tolerance)
AGREE, P_ATOL, IMG_ATOL = 0.999, 1e-4, 5e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def timed(fn, runs: int = 1):
    """(last result, median ms) of ``runs`` calls of fn(), each between two
    CUDA events."""
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return out, sorted(times)[len(times) // 2]


def compare(plan, cfg, tables, origin, dirs):
    """Launch K1 (five times) and its plain twin (once) on the same rays;
    check and return the worst differences and both times."""
    from raymarching_tpu_torch.ops.render_kernel import (blend, render_rays,
                                                         render_rays_plain)
    k, ms = timed(lambda: render_rays(plan, cfg, tables, origin, dirs),
                  runs=5)
    p, plain_ms = timed(lambda: render_rays_plain(plan, cfg, tables, origin,
                                                  dirs))
    worst = {}
    for name in ("done", "cidx", "smask"):
        share = (getattr(k, name) == getattr(p, name)).double().mean().item()
        worst[name] = share
        check(share >= AGREE, f"{name} agrees on {share:.5f} of rays")
    same = k.done == p.done
    worst["p"] = (k.p - p.p)[same].abs().max().item() if same.any() else 0.0
    worst["sd"] = ((k.sd - p.sd)[same & k.done].abs().max().item()
                   if (same & k.done).any() else 0.0)
    check(worst["p"] <= P_ATOL, f"hit points differ by {worst['p']}")
    check(worst["sd"] <= P_ATOL, f"SDs differ by {worst['sd']}")
    H, W, S = cfg.height, cfg.width, cfg.samples_per_pixel
    img = lambda o: blend(o.cidx, o.light, tables.prim_color).reshape(  # noqa: E731
        H, W, S, 3).mean(dim=2)
    worst["image"] = (img(k) - img(p)).abs().max().item()
    check(worst["image"] <= IMG_ATOL, f"images differ by {worst['image']}")
    return worst, ms, plain_ms


def rays_for(plan, tables, cfg):
    from raymarching_tpu_torch.core import camera as cam
    origin, dirs = cam.generate_rays(tables, cfg)
    return origin, dirs.reshape(-1, 3)


def has_demo_objects(img: torch.Tensor) -> bool:
    """Red sphere, blue DeathStar, green sphere and black background."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return bool(((r > 0.2) & (g < 0.05) & (b < 0.05)).any()
                and ((b > 0.2) & (r < 0.05) & (g < 0.05)).any()
                and ((g > 0.2) & (r < 0.05) & (b < 0.05)).any()
                and (img.amax(dim=-1) == 0).any())


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch.ops import build
    from raymarching_tpu_torch.ops.render_kernel import render_rays
    from raymarching_tpu_torch.serve import make_server
    from raymarching_tpu_torch.tables import tables_to_torch

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(card)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build("render_kernel")
    build.load_library("render_kernel")
    regs = [ln.strip() for ln in lib_path.with_suffix(".log").read_text()
            .splitlines() if "registers" in ln]
    print(f"[build] {time.perf_counter() - t0:.2f} s -> {lib_path.name}; "
          f"{'; '.join(regs)}")

    # 3. kernel vs plain twin at small sizes, and the ref oracle
    small = rt.RenderConfig(width=64, height=48, ssaa=2, iterations=1000)
    cases = [(s, small) for s in ("demo", "config1", "config2", "config3",
                                  "config4")]
    cases.append(("menger4", small.replace(width=32, height=24, ssaa=1)))
    image_errs = []
    for scene, cfg in cases:
        plan, tables = rt.compile_scene(
            rt.load_scene(str(ROOT / "scenes" / f"{scene}.txt")))
        tt = tables_to_torch(tables, dev)
        worst, _, _ = compare(plan, cfg, tt, *rays_for(plan, tt, cfg))
        image_errs.append(worst["image"])
        print(f"[compare] {scene} {cfg.width}x{cfg.height} ssaa{cfg.ssaa}: "
              + ", ".join(f"{k} {v:.6g}" for k, v in worst.items()))
    demo = rt.load_scene(str(DEMO))
    ref = rt.render_ref(demo, small, device=dev)
    fused = rt.render(demo, small, device=dev)
    ref_err = (fused - ref).abs().max().item()
    check(ref_err <= IMG_ATOL, f"demo vs ref oracle differs by {ref_err}")
    print(f"[compare] demo vs ref oracle 64x48 ssaa2: image {ref_err:.6g}")

    # 4. the main path: render() at the bench footprint and the reference's
    main_cfgs = [rt.RenderConfig(width=512, height=512, ssaa=2,
                                 iterations=1000), rt.RenderConfig()]
    render_rays.launches = 0
    images, secs = [], []
    for cfg in main_cfgs:
        rt.render(demo, cfg, device=dev)             # warm-up at this shape
        img, ms = timed(lambda: rt.render(demo, cfg, device=dev), runs=3)
        images.append(img)
        secs.append(ms / 1e3)
    launches = render_rays.launches
    # one launch per render(): a warm-up and three timed frames per shape
    check(launches == 4 * len(main_cfgs), f"K1 launched {launches} times")
    for cfg, img, s in zip(main_cfgs, images, secs):
        check(img.shape == (cfg.height, cfg.width, 3), f"shape {img.shape}")
        check(bool(torch.isfinite(img).all()), "image not finite")
        check(img.max().item() > 0.0, "image all black")
        check(has_demo_objects(img), "demo objects missing")
        print(f"[main] demo {cfg.width}x{cfg.height} ssaa{cfg.ssaa} "
              f"{cfg.iterations} it: {s:.4f} s, "
              f"{cfg.rays_per_image / s / 1e6:.3f} Mrays/s; {card}")
    plan, tables = rt.compile_scene(demo)
    tt = tables_to_torch(tables, dev)
    rows = []
    for cfg in main_cfgs:
        worst, ms, plain_ms = compare(plan, cfg, tt, *rays_for(plan, tt, cfg))
        image_errs.append(worst["image"])
        rows.append((ms, plain_ms))
        print(f"[kernel] render_kernel demo {cfg.width}x{cfg.height} "
              f"ssaa{cfg.ssaa}: K1 {ms:.3f} ms, plain {plain_ms:.3f} ms; "
              + ", ".join(f"{k} {v:.6g}" for k, v in worst.items())
              + f"; {card}")

    # 5. the server
    srv = make_server("127.0.0.1", 0, dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health.get("status") == "ok", f"healthz {health}")
        cfg = rt.RenderConfig(width=256, height=192, ssaa=2)
        want = rt.to_uint8(rt.render(demo, cfg, device=dev).cpu().numpy())
        body = DEMO.read_bytes()
        for _ in range(3):
            req = urllib.request.Request(
                url + "/render?width=256&height=192&ssaa=2", data=body,
                method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                png = rt.decode_png(r.read())
            check(png.shape == want.shape and (png == want).all(),
                  "/render PNG differs from a direct render")
        print(f"[serve] /healthz ok; 3 x /render 256x192 ssaa2 equal to "
              "direct renders")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)

    check("jax" not in sys.modules, "JAX was imported")
    ms, plain_ms = rows[-1]
    print(json.dumps({"kernels": [{
        "name": "render_kernel", "route": "cuda",
        "source": "raymarching_tpu_torch/csrc/render_kernel.cu",
        "replaces": "raymarching_tpu/ops/pallas_render.py:211",
        "launches": launches, "max_abs_err": max(image_errs),
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
