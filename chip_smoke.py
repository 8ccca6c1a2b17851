"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, every failure an uncaught exception:
  1. device      — a CUDA device is required; its name and power limit;
  2. build       — nvcc builds both kernels from csrc/, in parallel;
  3. compare     — K1 (ops.render_kernel.render_rays) against its plain
                   PyTorch twin on demo, config1-4 and menger4, and the
                   demo image against the port's ref oracle;
  4. compare-bwd — K2 (ops.surface_kernel.surface_eval) against its plain
                   twin on the 7-point stencils of K1's hits on the same
                   scenes, bitwise; the card's gradients of a 32x24 demo
                   render against the CPU's;
  5. main        — the demo through ``raymarching_tpu_torch.render`` at
                   512x512 SSAA 2 and at the reference's 1024x768 SSAA 3,
                   1000 iterations (median of three warm frames), counting
                   kernel launches; then K1 (median of five launches)
                   against its plain twin at those shapes, timed with CUDA
                   events;
  6. train       — ``raymarching_tpu_torch.fit`` of the perturbed demo at
                   512x512 SSAA 2, 1000 iterations, 5 Adam steps, counting
                   launches (one K1 and one K2 a step); then one step split
                   into forward, K2, the rest of the backward and the
                   optimizer, the parameter scatter alone, and K2 (median
                   of five launches) against its plain twin on that
                   step's 7,340,032 stencil points;
  7. serve       — the port's HTTP server answers /healthz and three
                   /render requests with PNGs equal to direct renders.
Then the kernel table as JSON and, last, the device line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEMO = ROOT / "scenes" / "demo.txt"
# kernel vs plain twin: discrete outputs equal on this share of rays, hit
# points and SDs within P_ATOL where convergence agrees, images within
# IMG_ATOL (tests/test_mega.py's cross-path image tolerance)
AGREE, P_ATOL, IMG_ATOL = 0.999, 1e-4, 5e-4
# card vs CPU gradients: tests/test_mega.py:62's tolerance (the card's
# atomics reorder the float64 parameter sums, and its elementwise maths
# rounds a few values apart from the CPU's)
GRAD_RTOL, GRAD_ATOL_SCALE = 0.02, 0.005
KERNELS = ("render_kernel", "surface_kernel")
TRAINABLE = ("prim_pos", "prim_aux", "prim_color", "light_pos")
# Adam rates: colours enter the image linearly; the geometry and light
# gradients leave out coverage (the implicit-function route moves hit
# depth, not silhouettes or shadow edges), and Adam steps every row of
# the sponge by about the rate, so they take a smaller one
COLOR_LR, GEOMETRY_LR = 2e-2, 1e-3


def adam(params):
    """Adam over fit's trainable tensors (TRAINABLE order)."""
    pos, aux, col, light = params
    return torch.optim.Adam([{"params": [col], "lr": COLOR_LR},
                             {"params": [pos, aux, light],
                              "lr": GEOMETRY_LR}])


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


def compare_bwd(plan, cfg, tables, origin, dirs):
    """K2 and its plain twin on the 7-point stencils of K1's hits; they
    must agree bitwise.  Returns the hit count."""
    from raymarching_tpu_torch.ops import scene_vjp
    from raymarching_tpu_torch.ops.render_kernel import render_rays
    from raymarching_tpu_torch.ops.surface_kernel import surface_eval_plain
    p = render_rays(plan, cfg, tables, origin, dirs).p
    k = scene_vjp.stencil_eval(plan, cfg, tables, p, center=True)
    torch.cuda.synchronize()
    q = scene_vjp.stencil_points(p, cfg.fd_h, center=True)
    plain = surface_eval_plain(plan, tables, q.reshape(-1, 3))
    for name, a, b in zip(("sd", "widx", "g"), k, plain):
        b = b.reshape(a.shape)
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"K2 {name} differs from its twin on "
              f"{int((a != b).reshape(7 * p.shape[0], -1).any(1).sum())} "
              "points")
    return p.shape[0]


def grads_of(plan, tables, cfg, device, origin, dirs):
    """Gradients of the MSE against grey of the differentiable render of
    rays (origin, dirs) made once on the CPU, for every SceneTables field
    and the rays, and the (K1, K2) launches it took."""
    from raymarching_tpu_torch.ops.render_kernel import render_rays
    from raymarching_tpu_torch.ops.render_op import FusedRender
    from raymarching_tpu_torch.ops.surface_kernel import surface_eval
    from raymarching_tpu_torch.tables import tables_to_torch
    tt = tables_to_torch(tables, device, requires_grad=type(tables)._fields)
    o = origin.to(device).requires_grad_()
    d = dirs.to(device).requires_grad_()
    k1, k2 = render_rays.launches, surface_eval.launches
    colors = FusedRender.apply(plan, cfg, o, d, *tt)
    g = torch.autograd.grad(torch.mean((colors - 0.25) ** 2), [*tt, o, d],
                            allow_unused=True, materialize_grads=True)
    return ([v.cpu() for v in g],
            (render_rays.launches - k1, surface_eval.launches - k2))


def perturbed_demo(tables):
    """The demo with the red sphere moved and shrunk, the green sphere's
    colour tinted and light 0 moved; returns (tables, red row, green
    row)."""
    col = tables.prim_color
    red = int(np.nonzero((col == (1, 0, 0)).all(axis=1))[0][0])
    green = int(np.nonzero((col == (0, 1, 0)).all(axis=1))[0][0])
    pos, aux, col, lp = (np.array(v) for v in (
        tables.prim_pos, tables.prim_aux, tables.prim_color,
        tables.light_pos))
    pos[red] += (1.5, -1.0, 1.0)
    aux[red, 0] *= 0.85
    col[green] = (0.4, 1.0, 0.0)
    lp[0] += (6.0, -4.0, 5.0)
    return (tables._replace(prim_pos=pos, prim_aux=aux, prim_color=col,
                            light_pos=lp), red, green)


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
    from raymarching_tpu_torch.ops import build, scene_vjp
    from raymarching_tpu_torch.ops.render_kernel import render_rays
    from raymarching_tpu_torch.ops.surface_kernel import (surface_eval,
                                                          surface_eval_plain)
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

    # 2. build: one nvcc per kernel, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(build.build, KERNELS))
    for kname, lib_path in zip(KERNELS, libs):
        build.load_library(kname)
        regs = [ln.strip() for ln in lib_path.with_suffix(".log").read_text()
                .splitlines() if "registers" in ln]
        print(f"[build] {lib_path.name}; {'; '.join(regs)}")
    print(f"[build] both kernels in {time.perf_counter() - t0:.2f} s")

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

    # 4. K2 vs its plain twin on the stencils of K1's hits, bitwise, and
    # the card's gradients against the CPU's
    for scene, cfg in cases:
        plan, tables = rt.compile_scene(
            rt.load_scene(str(ROOT / "scenes" / f"{scene}.txt")))
        tt = tables_to_torch(tables, dev)
        hits = compare_bwd(plan, cfg, tt, *rays_for(plan, tt, cfg))
        print(f"[compare-bwd] {scene} {cfg.width}x{cfg.height} "
              f"ssaa{cfg.ssaa}: K2 = plain twin bitwise (sd, widx, g) on "
              f"{7 * hits} stencil points")
    # the same rays on both sides: the card's camera rounds a few
    # directions an ulp off the CPU's, which a grazing hit amplifies
    plan, tables = rt.compile_scene(demo)
    gcfg = rt.RenderConfig(width=32, height=24, ssaa=1, iterations=1000)
    rays = rays_for(plan, tables_to_torch(tables, "cpu"), gcfg)
    g_card, launched = grads_of(plan, tables, gcfg, dev, *rays)
    check(launched == (1, 1), f"a differentiable render launched {launched}")
    g_cpu, _ = grads_of(plan, tables, gcfg, torch.device("cpu"), *rays)
    worst_grad = (0.0, "")
    for field, a, b in zip(tables._fields + ("origin", "dirs"), g_card,
                           g_cpu):
        check(bool(torch.isfinite(a).all()), f"{field} gradient not finite")
        scale = max(b.abs().max().item(), 1e-8)
        excess = ((a - b).abs() - GRAD_RTOL * b.abs()
                  - GRAD_ATOL_SCALE * scale).max().item()
        check(excess <= 0, f"{field} gradient: card vs CPU over tolerance "
              f"by {excess}")
        worst_grad = max(worst_grad,
                         ((a - b).abs().max().item() / scale, field))
    print(f"[compare-bwd] demo 32x24 gradients, card vs CPU on the same "
          f"rays, every table field and the rays: max |diff| / field scale "
          f"{worst_grad[0]:.3g} ({worst_grad[1]}; tolerance rtol "
          f"{GRAD_RTOL}, atol {GRAD_ATOL_SCALE} x scale)")

    # 5. the main path: render() at the bench footprint and the reference's
    main_cfgs = [rt.RenderConfig(width=512, height=512, ssaa=2,
                                 iterations=1000), rt.RenderConfig()]
    render_rays.launches = surface_eval.launches = 0
    images, secs = [], []
    for cfg in main_cfgs:
        rt.render(demo, cfg, device=dev)             # warm-up at this shape
        img, ms = timed(lambda: rt.render(demo, cfg, device=dev), runs=3)
        images.append(img)
        secs.append(ms / 1e3)
    launches = render_rays.launches
    # one launch per render(): a warm-up and three timed frames per shape
    check(launches == 4 * len(main_cfgs), f"K1 launched {launches} times")
    check(surface_eval.launches == 0, "a forward render launched K2")
    for cfg, img, s in zip(main_cfgs, images, secs):
        check(img.shape == (cfg.height, cfg.width, 3), f"shape {img.shape}")
        check(bool(torch.isfinite(img).all()), "image not finite")
        check(img.max().item() > 0.0, "image all black")
        check(has_demo_objects(img), "demo objects missing")
        print(f"[main] demo {cfg.width}x{cfg.height} ssaa{cfg.ssaa} "
              f"{cfg.iterations} it: {s:.4f} s, "
              f"{cfg.rays_per_image / s / 1e6:.3f} Mrays/s; {card}")
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

    # 6. training: fit the perturbed demo back to the true one
    tcfg = main_cfgs[0]
    rays = tcfg.rays_per_image
    target = rt.render_tables(plan, tables, tcfg, device=dev)
    start, red, green = perturbed_demo(tables)
    perturbed = {"prim_pos": [red], "prim_aux": [red],
                 "prim_color": [green], "light_pos": [0]}
    stamps, step_grads = [], []

    def on_step(step, loss, tt_):
        stamps.append(time.perf_counter())
        step_grads.append({f: getattr(tt_, f).grad.clone()
                           for f in TRAINABLE})

    render_rays.launches = surface_eval.launches = 0
    t0 = time.perf_counter()
    res = rt.fit(plan, start, target, tcfg, device=dev, steps=5,
                 trainable=TRAINABLE, optimizer=adam, callback=on_step)
    train_launches = (render_rays.launches, surface_eval.launches)
    check(train_launches == (5, 5),
          f"5 fit steps launched (K1, K2) = {train_launches}")
    for grads in step_grads:
        for f, g in grads.items():
            check(bool(torch.isfinite(g).all()), f"{f} gradient not finite")
            rows_ = perturbed[f]
            check(bool((g[rows_].abs().sum(dim=-1) > 0).all()),
                  f"{f} gradient is zero on perturbed rows {rows_}")
    check(res.losses[-1] < res.losses[0], f"loss did not fall: {res.losses}")
    step_s = sorted(np.diff([t0] + stamps))
    med = statistics.median(step_s)
    print(f"[train] demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"{tcfg.iterations} it, Adam (colour lr {COLOR_LR}, geometry "
          f"and light lr {GEOMETRY_LR}) on {', '.join(TRAINABLE)}: "
          f"loss {' '.join(f'{v:.6g}' for v in res.losses)}; launches "
          f"K1 {train_launches[0]}, K2 {train_launches[1]}")
    print(f"[train] step median {med * 1e3:.1f} ms (min "
          f"{step_s[0] * 1e3:.1f}, max {step_s[-1] * 1e3:.1f}), fwd+bwd "
          f"{rays / med / 1e6:.3f} Mrays/s; {card}")

    # one more step, split with CUDA events (median of three)
    tt = tables_to_torch(res.tables, dev, requires_grad=TRAINABLE)
    opt = adam([getattr(tt, f) for f in TRAINABLE])
    splits = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        img = rt.render_tables(plan, tt, tcfg, differentiable=True,
                               device=dev)
        loss = torch.mean((img - target) ** 2)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd_ms, bwd_ms, opt_ms = (statistics.median(c) for c in zip(*splits))

    # K2 against its twin on this step's stencil, and the scatter alone
    p = render_rays(plan, tcfg.replace(shade_skip_black=False), tt,
                    *rays_for(plan, tt, tcfg)).p
    q = scene_vjp.stencil_points(p, tcfg.fd_h, center=True).reshape(-1, 3)
    render_rays.launches = surface_eval.launches = 0
    (sd7, widx7, g7), k2_ms = timed(
        lambda: scene_vjp.stencil_eval(plan, tcfg, tt, p, center=True),
        runs=5)
    k2_plain, k2_plain_ms = timed(lambda: surface_eval_plain(plan, tt, q))
    k2_err = 0.0
    for kn, a, b in zip(("sd", "widx", "g"), (sd7, widx7, g7), k2_plain):
        b = b.reshape(a.shape)
        check(torch.equal(a, b), f"K2 {kn} differs from its twin at 512^2")
        k2_err = max(k2_err, (a - b).abs().max().item())
    u = torch.randn(sd7.shape, device=dev)
    _, scatter_ms = timed(lambda: scene_vjp.theta_cotangents(
        plan, tt, widx7, g7, u), runs=5)
    print(f"[train] step split (median of 3, CUDA events): forward "
          f"{fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (K2 {k2_ms:.2f} ms, "
          f"rest: replay + scatter {bwd_ms - k2_ms:.2f} ms), optimizer "
          f"{opt_ms:.2f} ms; {card}")
    print(f"[train] parameter scatter alone (theta_cotangents, "
          f"{q.shape[0]} rows x 7 columns onto {plan.num_primitives} leaf "
          f"rows): {scatter_ms:.2f} ms; {card}")
    print(f"[kernel] surface_kernel demo stencil {q.shape[0]} points: K2 "
          f"{k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms; sd, widx, g "
          f"bitwise equal; {card}")

    # 7. the server
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
        "launches": launches + train_launches[0],
        "max_abs_err": max(image_errs), "ms": ms, "plain_ms": plain_ms}, {
        "name": "surface_kernel", "route": "cuda",
        "source": "raymarching_tpu_torch/csrc/surface_kernel.cu",
        "replaces": "raymarching_tpu/ops/pallas_march.py:2656",
        "launches": train_launches[1], "max_abs_err": k2_err,
        "ms": k2_ms, "plain_ms": k2_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
