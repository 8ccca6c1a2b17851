"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --times    # the kernels' device times alone

Phases, one line each, every failure an uncaught exception:
  1. device      — a CUDA device is required; its name and power limit;
  2. build       — nvcc builds the four kernels from csrc/, in parallel;
                   each one's ptxas registers and spills;
  3. compare     — on demo, config1-4 and menger4: K1 (ops.render_kernel
                   .render_rays) against its plain PyTorch twin; K3
                   (ops.march_kernel.march_rays) against its twin on the
                   primary rays, with the step counter, and on shadow rays
                   with tmax from K1's hit points; K4 (ops.shade_kernel
                   .shade_rays) against its twin on K1's hit points; K2's
                   five modes and its stencil entry (7 and 6 points a hit)
                   against their twins; K1 and K4 with analytic normals
                   and their winner residuals against their twins and K4
                   against K1: all bitwise, with the lattice
                   collapse on and off (menger4 through the device-memory
                   instantiation); K1, K3, K4 and K2 on counts that are no
                   multiple of a tile, on one ray and with per-ray origins;
                   which scenes the kernels stage in shared memory; each
                   kernel's resident blocks an SM.  Then the demo image
                   against the port's ref oracle;
  4. compare-bwd — K2 (ops.surface_kernel.surface_eval) against its plain
                   twin on the 7-point stencils of K1's hits on the same
                   scenes, bitwise; the card's gradients of a 32x24 demo
                   render against the CPU's;
  5. main        — the demo through ``raymarching_tpu_torch.render`` at
                   512x512 SSAA 2 and at the reference's 1024x768 SSAA 3,
                   1000 iterations (median of three warm frames), counting
                   kernel launches; then K1 (median of five launches)
                   against its plain twin at 512x512 SSAA 2, timed with
                   CUDA events, and K1 at 1024x768 SSAA 3 against its
                   plain twin on every eighth ray, bitwise;
  6. train       — ``raymarching_tpu_torch.fit`` of the perturbed demo at
                   512x512 SSAA 2, 1000 iterations, 5 Adam steps, counting
                   launches (one K1 and one K2 a step); then one step split
                   into forward, K2, the rest of the backward and the
                   optimizer, the parameter scatter alone, and K2's stencil
                   entry (median of five launches) against its plain twin
                   on a step's 7,340,032 stencil points, on the tables the
                   fit starts from (the collapse on) and on the fitted
                   tables (the flag 0, the leaf fold);
  7. multi       — the demo at 512x512 SSAA 2 through
                   ``backend="multi"`` (K3 for primary and shadow rays, K2
                   for colours and normals): image against the fused
                   backend's, frame time, launches a frame, K3's primary
                   and shadow launches alone against their twins, and
                   K2's winner, FD-gradient and combined modes against
                   theirs at the shapes the multi frame and step give
                   them (the hit points and their six-point stencils);
  8. two-phase   — the same frame with ``two_phase_k1=48`` (K3, K3, K4):
                   image equal to the one-kernel frame, the unconverged
                   share after phase 1, both frame times; ``two_phase_k1=1``
                   on a small frame, which overflows the second phase's
                   capacity and marches again in full; K4 alone against
                   its twin; ``[phases]``: K4's device time with and
                   without its shadow marches and K2's winner and
                   FD-gradient modes on the same hit points, in turns;
  9. train-multi — three ``fit`` steps through ``backend="multi"``; its
                   gradients against the fused backend's on the same rays;
  9b. analytic   — ``normal_mode="analytic"`` on the demo: ``render``
                   at 512x512 SSAA 2 and 1024x768 SSAA 3 (launches; the
                   image against the FD image by tests/test_mega.py's
                   agreement rule); K1 with and without its winner
                   residuals, K4, K3 + K4 and K2's analytic mode against
                   their twins and each other, bitwise; K1, K4 and K2's
                   device times FD / analytic in turns; card vs CPU
                   gradients (one K1 launch, no K2); 3 fit steps (no K2
                   launch) split into forward, backward, optimizer and the
                   scatters; the multi-kernel frame and 3 steps;
 10. profile     — ``utils.timing.profile_march``: K3's step counts;
 11. warp        — where a thread-per-ray kernel loses its lanes, from K3's
                   step counter and the fold's cull test on the demo frame:
                   march lane efficiency (primary and shadow rays), cull
                   coherence within a warp, K1's shadow skips; and
                   ``[tail]``: K3 on the slowest ray alone, and K4 on
                   the hit whose shadow marches are the longest alone: the
                   serial chains no launch can be shorter than;
 12. collapse    — K1 (both resolutions) and K3 (primary, both shadow
                   launches) timed with the lattice collapse on and off in
                   turns, outputs bitwise equal; every kernel on a table
                   with one cross row moved (the flag drops on the device)
                   against the leaf fold and the plain twins; K2's combined
                   mode on the step's stencils on / off likewise;
                   ``[placement]``: the scene staged in shared memory
                   against read from device memory, all four kernels;
                   ``[multipoint]``: K2's FD-gradient mode with its seven
                   points in one walk of the scene against seven walks, in
                   turns, outputs bitwise equal;
 13. serve       — the port's HTTP server answers /healthz and three
                   /render requests with PNGs equal to direct renders.
Then each kernel's launches in one call of each path, and the kernel table
as JSON (each kernel's largest difference from its plain twin over every
output of every comparison above, its time beside its plain twin's and its
bound: the larger of its bytes over 3.35 TB/s and its operations on this
run's data, 12 for each leaf evaluation the fold's cull keeps and the
collapsed carve's as core.sdf.LeafCount states them, over 67 TFLOP/s, the
H100's published float32 rate) and, last, the device line.
"""

from __future__ import annotations

import json
import re
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
# multi-kernel against fused image: tests/test_mega.py:38 holds the JAX
# backends to 1e-6 on a small frame; at a million rays an ulp in a normal
# may flip a shadow bit, so the card's frame is held to that tolerance on
# a share AGREE of its pixels and in the mean
MULTI_ATOL = 1e-6
# analytic against FD normals: tests/test_mega.py:176-177's rule, this share
# of pixels under ANALYTIC_ATOL and the median under ANALYTIC_MEDIAN
ANALYTIC_ATOL, ANALYTIC_SHARE, ANALYTIC_MEDIAN = 5e-3, 0.99, 1e-4
# the fused gate: the fused analytic frame against the exact FD one, more
# than GATE_SHARE of its pixels within GATE_ATOL and no offender off a
# silhouette (tests/test_gate_offenders.py, utils.gatecheck)
GATE_ATOL, GATE_SHARE = 5e-3, 0.995
KERNELS = ("render_kernel", "surface_kernel", "march_kernel", "shade_kernel")
# the largest |kernel - plain twin| over every output of every comparison
# of this run, per kernel (``compare`` and ``same`` fill it)
ERRS = dict.fromkeys(KERNELS, 0.0)
# the H100's published peaks (SXM data sheet): device memory bytes/s and
# float32 operations/s outside the tensor cores (core.sdf.LeafCount counts
# the fold's operations)
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12
# the 1024x768 SSAA 3 frame's plain twin runs on one ray in BIG_STRIDE
BIG_STRIDE = 8
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


def device_ms(fn, needle: str, runs: int = 5):
    """Median device time in ms of the kernels whose name contains
    ``needle`` over ``runs`` calls of fn(), from torch.profiler: the kernel
    alone, without its wrapper's host work.  The profiler now and then
    hands back fewer kernel records than launches; such a window is taken
    again, and the third is read as it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        times = []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and needle in e.name:
                t = getattr(e, "device_time", None)
                times.append((e.cuda_time if t is None else t) / 1e3)
        if len(times) >= runs:
            break
    check(len(times) > 0, f"the profiler saw no {needle} launch in {runs} "
          "calls")
    return statistics.median(times)


def max_err(got, want) -> float:
    """The largest absolute difference, element by element, between two
    tuples of tensors (None entries skipped; booleans as 0 and 1; equal
    elements, infinities included, as 0; a NaN on one side as inf)."""
    worst = 0.0
    for a, b in zip(got, want):
        if a is None or b is None or a.shape != b.shape or not a.numel():
            continue
        a, b = a.double(), b.double()
        d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
        worst = max(worst, torch.nan_to_num(d, nan=float("inf")).max().item())
    return worst


def compare(plan, cfg, tables, origin, dirs):
    """Launch K1 (five times) and its plain twin (once) on the same rays;
    check and return the worst differences, both times and the twin's
    count of the fold's work."""
    from raymarching_tpu_torch.ops.render_kernel import (blend, render_rays,
                                                         render_rays_plain)
    k, ms = timed(lambda: render_rays(plan, cfg, tables, origin, dirs),
                  runs=5)
    p, plain_ms, count = timed_counted(lambda: render_rays_plain(
        plan, cfg, tables, origin, dirs))
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
    # every ray output (p, sd, done, cidx, light, smask), all rays
    worst["outputs"] = max_err(k, p)
    ERRS["render_kernel"] = max(ERRS["render_kernel"], worst["image"],
                                worst["outputs"])
    return worst, ms, plain_ms, count


def ptxas_summary(log: str) -> str:
    """The -Xptxas -v report of one library in a line: the most registers
    of its entry kernels, and the largest stack frame and spill traffic
    of any of its functions (the non-inlined fold functions included)."""
    def most(pattern):
        return max((int(v) for v in re.findall(pattern, log)), default=0)
    return (f"{most(r'Used (\d+) registers')} registers, "
            f"{most(r'(\d+) bytes stack frame')} B stack frame, "
            f"{most(r'(\d+) bytes spill stores')} B spill stores, "
            f"{most(r'(\d+) bytes spill loads')} B spill loads "
            f"(ptxas, largest of {len(re.findall('Function properties', log))}"
            " functions)")


def entry_label(name: str) -> str:
    """A kernel entry's mangled name in short: the kernel and its template
    arguments (K1's and K4's normal, K2's mode, the scene view)."""
    m = re.search(r"((?:render|surface|march|shade)_kernel)(_analytic)?I(.*)",
                  name)
    if not m:
        return name
    kern, analytic, rest = m.groups()
    ints = re.findall(r"Li(\d+)E", rest)
    parts = ["fused"] if "Fused" in rest else []
    if kern in ("render_kernel", "shade_kernel"):
        parts.append("analytic" if analytic else "FD")
    elif kern == "surface_kernel" and ints:
        parts.append(f"mode {ints[0]}")
        if "Lb1E" in rest:
            parts.append("stencil")
    parts += [v for v, tag in (("shared", "SharedScene"),
                               ("device", "DeviceScene")) if tag in rest]
    return f"{kern}<{', '.join(parts)}>"


def ptxas_entries(log: str) -> list:
    """(entry, registers, stack frame bytes) of each kernel entry in one
    library's -Xptxas -v report, in its order, the entry as entry_label
    gives it."""
    regs, stack, entry, func = [], {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            func = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and func is not None:
            stack[func] = int(m.group(1))
            func = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            regs.append((entry, int(m.group(1))))
            entry = None
    return [(entry_label(e), r, stack.get(e, 0)) for e, r in regs]


def same(what: str, got, want, kernel: str | None = None) -> None:
    """Bitwise equality of two tuples of tensors (None entries skipped).
    With ``kernel``, ``want`` is that kernel's plain twin and the largest
    difference found goes into the kernel's row of the table."""
    if kernel is not None:
        ERRS[kernel] = max(ERRS[kernel], max_err(got, want))
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None and b is None:
            continue
        check(a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(a, b),
              f"{what}: output {i} differs from its twin on "
              f"{int((a != b).sum()) if a.shape == b.shape else 'shape'}")


def shadow_rays(tables, cfg, p, n, li):
    """The shadow rays of light ``li`` from hit points p with unit normals
    n, as core.shading.shadowed builds them: (start, direction, tmax)."""
    from raymarching_tpu_torch.core.march import dot3
    from raymarching_tpu_torch.core.shading import normalize
    lp = tables.light_pos[li]
    start = p + n * (cfg.surface_precision + cfg.offset_precision)
    r = lp - start
    return start, normalize(lp - p), torch.sqrt(dot3(r, r))


def compare_new(plan, cfg, tables, origin, dirs, collapse=True):
    """K3, K4, K2's five modes and K2's stencil entry against their plain
    twins, all bitwise (every kernel is built with -fmad=false), and K3 and
    K4 against K1's own outputs; K1 and K4 with analytic normals and their
    winner residuals against their twins and K4 against K1; with the
    lattice collapse on or off in kernels and twins alike.  Returns the
    number of comparisons."""
    from raymarching_tpu_torch.core.shading import normalize
    from raymarching_tpu_torch.ops import march_kernel as mk
    from raymarching_tpu_torch.ops import shade_kernel as shk
    from raymarching_tpu_torch.ops import surface_kernel as sk
    from raymarching_tpu_torch.ops.render_kernel import (render_rays,
                                                         render_rays_plain)
    c = {"collapse": collapse}
    k1 = render_rays(plan, cfg, tables, origin, dirs, **c)
    res, steps = mk.march_rays(plan, cfg, tables, origin, dirs,
                               with_steps=True, **c)
    res_p, steps_p = mk.march_rays_plain(plan, cfg, tables, origin, dirs,
                                         with_steps=True, **c)
    same("K3 primary", (*res, steps), (*res_p, steps_p), "march_kernel")
    same("K3 against K1's march", res, (k1.p, k1.sd, k1.done))
    n_cmp = 2
    _, _, g = sk.surface_eval(plan, tables, k1.p, mode=sk.FD_GRAD,
                              fd_h=cfg.fd_h, **c)
    for li in range(plan.num_lights):
        s, d, tmax = shadow_rays(tables, cfg, k1.p, normalize(g), li)
        same(f"K3 shadow rays of light {li}",
             mk.march_rays(plan, cfg, tables, s, d, tmax=tmax, **c),
             mk.march_rays_plain(plan, cfg, tables, s, d, tmax=tmax, **c),
             "march_kernel")
        n_cmp += 1
    k4 = shk.shade_rays(plan, cfg, tables, k1.p, k1.sd, dirs, **c)
    same("K4", k4, shk.shade_rays_plain(plan, cfg, tables, k1.p, k1.sd,
                                        dirs, **c), "shade_kernel")
    same("K4 against K1's shading", k4, (k1.cidx, k1.light, k1.smask))
    n_cmp += 2
    an = cfg.replace(normal_mode="analytic")
    k1a, w1a = render_rays(plan, an, tables, origin, dirs, save_winner=True,
                           **c)
    p1a, pw1a = render_rays_plain(plan, an, tables, origin, dirs,
                                  save_winner=True, **c)
    same("K1 analytic", (*k1a, *w1a), (*p1a, *pw1a), "render_kernel")
    same("K1 analytic without residuals",
         render_rays(plan, an, tables, origin, dirs, **c), p1a,
         "render_kernel")
    k4a, w4a = shk.shade_rays(plan, an, tables, k1a.p, k1a.sd, dirs,
                              save_winner=True, **c)
    s4a, sw4a = shk.shade_rays_plain(plan, an, tables, k1a.p, k1a.sd, dirs,
                                     save_winner=True, **c)
    same("K4 analytic", (*k4a, *w4a), (*s4a, *sw4a), "shade_kernel")
    same("K4 analytic against K1's", (*k4a, *w4a),
         (k1a.cidx, k1a.light, k1a.smask, *w1a))
    n_cmp += 4
    for mode in sk.MODES:
        same(f"K2 mode {mode}",
             sk.surface_eval(plan, tables, k1.p, mode=mode, fd_h=cfg.fd_h,
                             **c),
             sk.surface_eval_plain(plan, tables, k1.p, mode=mode,
                                   fd_h=cfg.fd_h, **c), "surface_kernel")
        n_cmp += 1
    for center in (True, False):
        same(f"K2 stencil entry, centre {center}",
             sk.surface_stencil(plan, tables, k1.p, cfg.fd_h, center=center,
                                **c),
             sk.surface_stencil_plain(plan, tables, k1.p, cfg.fd_h,
                                      center=center, **c), "surface_kernel")
        n_cmp += 1
    torch.cuda.synchronize()
    return n_cmp


def compare_fused(plan, cfg, tables, origin, dirs):
    """The fused-generator instantiations of all four kernels against their
    plain twins on a scene with generators, both normals, bitwise: K1 (with
    analytic normals with and without its residuals), K3 with steps and on
    shadow rays, K4 on K1's hits and against K1, K2's five modes at the
    hits, and the residuals against K2's combined mode; the combined mode
    names some carves by extended ids.  Returns the number of
    comparisons."""
    from raymarching_tpu_torch.core.shading import normalize
    from raymarching_tpu_torch.ops import march_kernel as mk
    from raymarching_tpu_torch.ops import shade_kernel as shk
    from raymarching_tpu_torch.ops import surface_kernel as sk
    from raymarching_tpu_torch.ops.render_kernel import (render_rays,
                                                         render_rays_plain)
    n_cmp = 0
    for normal in ("fd", "analytic"):
        fc = cfg.replace(fused_generators=True, normal_mode=normal)
        kw = {"save_winner": True} if normal == "analytic" else {}
        k1, w1 = (render_rays(plan, fc, tables, origin, dirs, **kw)
                  if kw else (render_rays(plan, fc, tables, origin, dirs), ()))
        p1, pw = (render_rays_plain(plan, fc, tables, origin, dirs, **kw)
                  if kw else (render_rays_plain(plan, fc, tables, origin,
                                                dirs), ()))
        same(f"K1 fused {normal}", (*k1, *w1), (*p1, *pw), "render_kernel")
        if kw:
            same("K1 fused analytic without residuals",
                 render_rays(plan, fc, tables, origin, dirs), p1,
                 "render_kernel")
            same("K2 fused combined = K1's residuals", sk.surface_eval(
                plan, tables, k1.p, fused=True), w1)
        res, steps = mk.march_rays(plan, fc, tables, origin, dirs,
                                   with_steps=True)
        res_p, steps_p = mk.march_rays_plain(plan, fc, tables, origin, dirs,
                                             with_steps=True)
        same("K3 fused primary", (*res, steps), (*res_p, steps_p),
             "march_kernel")
        same("K3 fused against K1's march", res, (k1.p, k1.sd, k1.done))
        _, _, g = sk.surface_eval(plan, tables, k1.p, mode=sk.FD_GRAD,
                                  fd_h=cfg.fd_h, fused=True)
        for li in range(plan.num_lights):
            s_, d_, tmax = shadow_rays(tables, fc, k1.p, normalize(g), li)
            same(f"K3 fused shadow rays of light {li}",
                 mk.march_rays(plan, fc, tables, s_, d_, tmax=tmax),
                 mk.march_rays_plain(plan, fc, tables, s_, d_, tmax=tmax),
                 "march_kernel")
        o4 = shk.shade_rays(plan, fc, tables, k1.p, k1.sd, dirs, **kw)
        s4 = shk.shade_rays_plain(plan, fc, tables, k1.p, k1.sd, dirs, **kw)
        k4, w4 = o4 if kw else (o4, ())
        s4, sw = s4 if kw else (s4, ())
        same(f"K4 fused {normal}", (*k4, *w4), (*s4, *sw), "shade_kernel")
        same(f"K4 fused {normal} against K1's", (*k4, *w4),
             (k1.cidx, k1.light, k1.smask, *w1))
        n_cmp += 6 + plan.num_lights + (2 if kw else 0)
    for mode in sk.MODES:
        k2 = sk.surface_eval(plan, tables, k1.p, mode=mode, fd_h=cfg.fd_h,
                             fused=True)
        same(f"K2 fused mode {mode}", k2, sk.surface_eval_plain(
            plan, tables, k1.p, mode=mode, fd_h=cfg.fd_h, fused=True),
            "surface_kernel")
        n_cmp += 1
    widx = sk.surface_eval(plan, tables, k1.p, fused=True)[1]
    n_gen = sum(g_.fused is not None for g_ in plan.kernel.groups)
    check(int(widx.max()) < plan.num_primitives + n_gen,
          "an extended winner id past the fused groups")
    torch.cuda.synchronize()
    return n_cmp, int((widx >= plan.num_primitives).sum())


def compare_ragged(plan, cfg, tables, origin, dirs):
    """K1, K3, K4 and K2 (its FD-gradient mode and its stencil entry) on
    the first n rays, with per-ray origins, for n that is 1, below a warp
    and no multiple of a warp or a tile: rays are independent, so every
    output must be the full launch's on those rays, bitwise.  Returns the
    ray counts."""
    from raymarching_tpu_torch.ops import march_kernel as mk
    from raymarching_tpu_torch.ops import shade_kernel as shk
    from raymarching_tpu_torch.ops import surface_kernel as sk
    from raymarching_tpu_torch.ops.render_kernel import render_rays
    R = dirs.shape[0]
    full = render_rays(plan, cfg, tables, origin, dirs)
    full3, steps3 = mk.march_rays(plan, cfg, tables, origin, dirs,
                                  with_steps=True)
    full2 = sk.surface_eval(plan, tables, full.p, mode=sk.FD_GRAD,
                            fd_h=cfg.fd_h)
    full2s = sk.surface_stencil(plan, tables, full.p, cfg.fd_h, center=True)
    counts = [n for n in (1, 31, 1000, R - 37) if 0 < n <= R]
    for n in counts:
        same(f"K2 FD gradient on {n} points",
             sk.surface_eval(plan, tables, full.p[:n], mode=sk.FD_GRAD,
                             fd_h=cfg.fd_h), tuple(
                 None if v is None else v[:n] for v in full2))
        same(f"K2 stencil entry on {n} hits",
             sk.surface_stencil(plan, tables, full.p[:n], cfg.fd_h,
                                center=True),
             tuple(v[:, :n] for v in full2s))
        org = origin.expand(R, 3)[:n].contiguous()
        same(f"K1 on {n} rays", render_rays(plan, cfg, tables, org, dirs[:n]),
             tuple(v[:n] for v in full))
        part3, psteps = mk.march_rays(plan, cfg, tables, org, dirs[:n],
                                      with_steps=True)
        same(f"K3 on {n} rays", (*part3, psteps),
             (*(v[:n] for v in full3), steps3[:n]))
        same(f"K4 on {n} rays",
             shk.shade_rays(plan, cfg, tables, full.p[:n], full.sd[:n],
                            dirs[:n]),
             (full.cidx[:n], full.light[:n], full.smask[:n]))
    torch.cuda.synchronize()
    return counts


def timed_counted(plain_fn):
    """(result, ms, count) of one call of a plain twin under
    core.sdf.LeafCount, which counts the work the kernels' fold does on
    the same points (it applies the fold's cull rule per point)."""
    from raymarching_tpu_torch.core.sdf import LeafCount
    with LeafCount() as count:
        out, ms = timed(plain_fn)
    return out, ms, count


def bound_ms(count, n_bytes: int):
    """The least time the card could take for the work of one kernel
    launch: (ms, "bytes" or "operations", leaf evaluations, the
    operations' ms, the bytes' ms, the operations), from a plain twin's
    ``count`` of the operations on this run's data and the bytes the
    kernel must move."""
    t_ops = count.ops / FP32_OPS_S
    t_bytes = n_bytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", count.leaves,
            t_ops * 1e3, t_bytes * 1e3, count.ops)


def launch_counts():
    from raymarching_tpu_torch.ops.march_kernel import march_rays
    from raymarching_tpu_torch.ops.render_kernel import render_rays
    from raymarching_tpu_torch.ops.shade_kernel import shade_rays
    from raymarching_tpu_torch.ops.surface_kernel import surface_eval
    return {"render_kernel": render_rays.launches,
            "surface_kernel": surface_eval.launches,
            "march_kernel": march_rays.launches,
            "shade_kernel": shade_rays.launches}


def zero_counts():
    from raymarching_tpu_torch.ops.march_kernel import march_rays
    from raymarching_tpu_torch.ops.render_kernel import render_rays
    from raymarching_tpu_torch.ops.shade_kernel import shade_rays
    from raymarching_tpu_torch.ops.surface_kernel import surface_eval
    for fn in (render_rays, surface_eval, march_rays, shade_rays):
        fn.launches = 0


def compare_bwd(plan, cfg, tables, origin, dirs):
    """K2 and its plain twin on the 7-point stencils of K1's hits; they
    must agree bitwise.  Returns the hit count."""
    from raymarching_tpu_torch.ops import scene_vjp
    from raymarching_tpu_torch.ops.render_kernel import render_rays
    from raymarching_tpu_torch.ops.surface_kernel import (stencil_points,
                                                          surface_eval_plain)
    p = render_rays(plan, cfg, tables, origin, dirs).p
    k = scene_vjp.stencil_eval(plan, cfg, tables, p, center=True)
    torch.cuda.synchronize()
    q = stencil_points(p, cfg.fd_h, center=True)
    plain = surface_eval_plain(plan, tables, q.reshape(-1, 3))
    for name, a, b in zip(("sd", "widx", "g"), k, plain):
        b = b.reshape(a.shape)
        ERRS["surface_kernel"] = max(ERRS["surface_kernel"],
                                     max_err((a,), (b,)))
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"K2 {name} differs from its twin on "
              f"{int((a != b).reshape(7 * p.shape[0], -1).any(1).sum())} "
              "points")
    return p.shape[0]


def grads_of(plan, tables, cfg, device, origin, dirs):
    """Gradients of the MSE against grey of the fused differentiable
    render of rays (origin, dirs) made once on the CPU, for every
    SceneTables field and the rays, and the (K1, K2) launches it took."""
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


def grad_check(fields, got, want, what: str):
    """Hold gradients ``got`` to ``want`` field by field at tests/test_mega
    .py:62's tolerance; returns (worst |diff| / field scale, its field)."""
    worst = (0.0, "")
    for field, a, b in zip(fields, got, want):
        check(bool(torch.isfinite(a).all()), f"{field} gradient not finite")
        scale = max(b.abs().max().item(), 1e-8)
        excess = ((a - b).abs() - GRAD_RTOL * b.abs()
                  - GRAD_ATOL_SCALE * scale).max().item()
        check(excess <= 0, f"{field} gradient: {what} over tolerance by "
              f"{excess}")
        worst = max(worst, ((a - b).abs().max().item() / scale, field))
    return worst


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


def kernel_times() -> int:
    """``--times``: one line with the device times (torch.profiler, median
    of five launches) of K1 at 512x512 SSAA 2 and 1024x768 SSAA 3, of K3
    on the primary rays and on the slowest of them alone, of K4, of K2 on
    the 7-point stencils of the hits (and that call with its wrapper,
    CUDA events) and in its FD-gradient mode, of K1, K4 and K2 with
    analytic normals, and of K1 with the scene read from device memory, on
    the demo at 1,000 iterations.  For holding two checkouts against each
    other on one card: run it from each in one command, in turns (parent,
    change, change, parent)."""
    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch import tables as scene_tables
    from raymarching_tpu_torch.ops import march_kernel as mk
    from raymarching_tpu_torch.ops import scene_vjp
    from raymarching_tpu_torch.ops import shade_kernel as shk
    from raymarching_tpu_torch.ops import surface_kernel as sk
    from raymarching_tpu_torch.ops.render_kernel import render_rays

    dev = torch.device("cuda")
    plan, tables = rt.compile_scene(rt.load_scene(str(DEMO)))
    tt = scene_tables.tables_to_torch(tables, dev)
    cfg = rt.RenderConfig(width=512, height=512, ssaa=2, iterations=1000)
    origin, dirs = rays_for(plan, tt, cfg)
    hit, steps = mk.march_rays(plan, cfg, tt, origin, dirs, with_steps=True)
    slow = int(steps.argmax())
    out = {
        "K1 512x512 ssaa2": device_ms(lambda: render_rays(
            plan, cfg, tt, origin, dirs), "render_kernel"),
        "K3 primary": device_ms(lambda: mk.march_rays(
            plan, cfg, tt, origin, dirs), "march_kernel"),
        f"K3 slowest ray alone ({int(steps[slow])} steps)": device_ms(
            lambda: mk.march_rays(plan, cfg, tt, origin,
                                  dirs[slow:slow + 1]), "march_kernel"),
        "K4": device_ms(lambda: shk.shade_rays(
            plan, cfg, tt, hit.position, hit.sd, dirs), "shade_kernel"),
        "K2 combined, 7-point stencils": device_ms(
            lambda: scene_vjp.stencil_eval(plan, cfg, tt, hit.position,
                                           center=True), "surface_kernel"),
        "K2 stencil_eval with its wrapper": timed(
            lambda: scene_vjp.stencil_eval(plan, cfg, tt, hit.position,
                                           center=True), runs=5)[1],
        "K2 FD gradient": device_ms(lambda: sk.surface_eval(
            plan, tt, hit.position, mode=sk.FD_GRAD, fd_h=cfg.fd_h),
            "surface_kernel"),
    }
    acfg = cfg.replace(normal_mode="analytic")
    out["K1 512x512 ssaa2 analytic"] = device_ms(lambda: render_rays(
        plan, acfg, tt, origin, dirs), "render_kernel")
    out["K4 analytic"] = device_ms(lambda: shk.shade_rays(
        plan, acfg, tt, hit.position, hit.sd, dirs), "shade_kernel")
    out["K2 analytic"] = device_ms(lambda: sk.surface_eval(
        plan, tt, hit.position, mode=sk.ANALYTIC), "surface_kernel")
    fcfg = acfg.replace(fused_generators=True)
    out["K1 512x512 ssaa2 fused analytic"] = device_ms(lambda: render_rays(
        plan, fcfg, tt, origin, dirs), "render_kernel")
    out["K1 512x512 ssaa2 fused FD"] = device_ms(lambda: render_rays(
        plan, fcfg.replace(normal_mode="fd"), tt, origin, dirs),
        "render_kernel")
    out["K3 primary fused"] = device_ms(lambda: mk.march_rays(
        plan, fcfg, tt, origin, dirs), "march_kernel")
    out["K4 fused analytic"] = device_ms(lambda: shk.shade_rays(
        plan, fcfg, tt, hit.position, hit.sd, dirs), "shade_kernel")
    out["K4 fused FD"] = device_ms(lambda: shk.shade_rays(
        plan, fcfg.replace(normal_mode="fd"), tt, hit.position, hit.sd, dirs),
        "shade_kernel")
    out["K2 fused combined"] = device_ms(lambda: sk.surface_eval(
        plan, tt, hit.position, fused=True), "surface_kernel")
    limit = scene_tables.SHARED_SCENE_BYTES
    scene_tables.SHARED_SCENE_BYTES = 0
    try:
        out["K1 512x512 ssaa2, scene in device memory"] = device_ms(
            lambda: render_rays(plan, cfg, tt, origin, dirs), "render_kernel")
    finally:
        scene_tables.SHARED_SCENE_BYTES = limit
    big = rt.RenderConfig()
    big_org, big_dirs = rays_for(plan, tt, big)
    for b in (big, big.replace(normal_mode="analytic"),
              big.replace(normal_mode="analytic", fused_generators=True)):
        name = ("" if b.normal_mode == "fd" else " analytic") + (
            " fused" if b.fused_generators else "")
        out[f"K1 {b.width}x{b.height} ssaa{b.ssaa}{name}"] = device_ms(
            lambda: render_rays(plan, b, tt, big_org, big_dirs),
            "render_kernel")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[times] {ROOT}: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in out.items())
          + f"; {smi.splitlines()[0]}")
    return 0


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--times"]:
        return kernel_times()
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; expected none "
              "or --times", file=sys.stderr)
        return 2
    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch.api import render_tables
    from raymarching_tpu_torch.core.shading import normalize
    from raymarching_tpu_torch.ops import build, scene_vjp
    from raymarching_tpu_torch.ops import march_kernel as mk
    from raymarching_tpu_torch.ops import shade_kernel as shk
    from raymarching_tpu_torch.ops import surface_kernel as sk
    from raymarching_tpu_torch.ops.render_kernel import (phase2_capacity,
                                                         render_rays,
                                                         render_rays_plain,
                                                         two_phase_march)
    from raymarching_tpu_torch.serve import make_server
    from raymarching_tpu_torch.core.sdf import carve_folded
    from raymarching_tpu_torch.tables import (SHARED_SCENE_BYTES,
                                              lattice_ok, scene_operands,
                                              tables_to_torch)
    from raymarching_tpu_torch.utils.timing import profile_march

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
        log = lib_path.with_suffix(".log").read_text()
        print(f"[build] {lib_path.name}; " + ptxas_summary(log))
        entries = ptxas_entries(log)
        check(bool(entries), f"no kernel entry in {kname}'s ptxas report")
        print(f"[ptxas] {kname} by entry (registers, stack frame): "
              + "; ".join(f"{e} {r} / {st} B" for e, r, st in entries))
    print(f"[build] {len(KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.2f} s")

    # 3. kernels vs plain twins at small sizes, and the ref oracle
    small = rt.RenderConfig(width=64, height=48, ssaa=2, iterations=1000)
    cases = [(s, small) for s in ("demo", "config1", "config2", "config3",
                                  "config4")]
    cases.append(("menger4", small.replace(width=32, height=24, ssaa=1)))
    for scene, cfg in cases:
        plan, tables = rt.compile_scene(
            rt.load_scene(str(ROOT / "scenes" / f"{scene}.txt")))
        tt = tables_to_torch(tables, dev)
        rays = rays_for(plan, tt, cfg)
        worst = compare(plan, cfg, tt, *rays)[0]
        print(f"[compare] {scene} {cfg.width}x{cfg.height} ssaa{cfg.ssaa}: "
              + ", ".join(f"{k} {v:.6g}" for k, v in worst.items()))
        n_cmp = (compare_new(plan, cfg, tt, *rays)
                 + compare_new(plan, cfg, tt, *rays, collapse=False))
        ops = scene_operands(plan, tt, dev)
        nbytes = ops.nbytes(plan.num_lights)
        if any(g_.fused is not None for g_ in plan.kernel.groups):
            f_cmp, n_ext = compare_fused(plan, cfg, tt, *rays)
            f_bytes = scene_operands(plan, tt, dev, True, True).nbytes(
                plan.num_lights)
            print(f"[compare] {scene} fused generators: K1 (FD; analytic "
                  f"with and without residuals), K3 (primary with steps, "
                  f"shadow rays), K4 (both normals), K2's five modes = "
                  f"plain twins bitwise, K3 and K4 = K1's, K2's combined "
                  f"mode = K1's residuals ({f_cmp} comparisons; {n_ext} of "
                  f"{rays[1].shape[0]} hits won by a carve, extended ids); "
                  f"fused packing {f_bytes} bytes, read from "
                  f"{'shared' if f_bytes <= SHARED_SCENE_BYTES else 'device'}"
                  " memory")
        print(f"[compare] {scene}: K3 (primary rays with steps, shadow "
              f"rays with tmax of {plan.num_lights} lights), K4, K2's five "
              f"modes and its stencil entry, K1 and K4 with analytic normals "
              f"and their residuals = plain twins bitwise, and "
              f"K3, K4 = K1's march and shading bitwise, with the lattice "
              f"collapse on and off ({n_cmp} comparisons; collapse flag "
              f"{int(ops.flag.item())}); K1, K3, K4, K2 on "
              f"{compare_ragged(plan, cfg, tt, *rays)} rays with per-ray "
              f"origins = the full launch's; scene {nbytes} bytes, read "
              f"from {'shared' if nbytes <= SHARED_SCENE_BYTES else 'device'}"
              " memory")
        if scene == "demo":
            # 16 bytes cover the staged copy's alignment padding; K1 and K4
            # take a third argument, the normal (0 FD, 1 analytic)
            per_sm = {}
            f_bytes = scene_operands(plan, tt, dev, True, True).nbytes(
                plan.num_lights)
            for k in KERNELS:
                lib = build.load_library(k)
                # K1 and K4: (normal, fused); K3: (fused); K2's stencil
                # entry: exact only
                variants = {
                    "render_kernel": {"FD": (0, 0), "analytic": (1, 0),
                                      "fused FD": (0, 1),
                                      "fused analytic": (1, 1)},
                    "shade_kernel": {"FD": (0, 0), "analytic": (1, 0),
                                     "fused FD": (0, 1),
                                     "fused analytic": (1, 1)},
                    "march_kernel": {"": (0,), "fused": (1,)},
                    "surface_kernel": {"": ()}}[k]
                for label, extra in variants.items():
                    staged = (f_bytes if extra and extra[-1] else nbytes) + 16
                    per_sm[f"{k} {label}".strip()] = (
                        lib.rt_blocks_per_sm(1, staged, *extra),
                        lib.rt_blocks_per_sm(0, 0, *extra))
            check(all(min(v) > 0 for v in per_sm.values()),
                  f"resident blocks an SM: {per_sm}")
            print("[occupancy] resident blocks an SM (128 threads each), "
                  f"the demo's {nbytes} bytes ({f_bytes} fused) staged in "
                  "shared memory / the scene in device memory: "
                  + "; ".join(f"{k} {a} / {b}"
                              for k, (a, b) in per_sm.items()))
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
    worst_grad = grad_check(tables._fields + ("origin", "dirs"), g_card,
                            g_cpu, "card vs CPU")
    print(f"[compare-bwd] demo 32x24 gradients, card vs CPU on the same "
          f"rays, every table field and the rays: max |diff| / field scale "
          f"{worst_grad[0]:.3g} ({worst_grad[1]}; tolerance rtol "
          f"{GRAD_RTOL}, atol {GRAD_ATOL_SCALE} x scale)")

    # 5. the main path: render() at the bench footprint and the reference's
    main_cfgs = [rt.RenderConfig(width=512, height=512, ssaa=2,
                                 iterations=1000), rt.RenderConfig()]
    # per path: (calls of its entry point between zero_counts() and the
    # reading, each kernel's launches in them)
    paths = {}

    def add_counts(path: str, calls: int):
        counts = launch_counts()
        paths[path] = (calls, counts)
        return counts

    zero_counts()
    images, secs = [], []
    for cfg in main_cfgs:
        rt.render(demo, cfg, device=dev)             # warm-up at this shape
        img, ms = timed(lambda: rt.render(demo, cfg, device=dev), runs=3)
        images.append(img)
        secs.append(ms / 1e3)
    counts = add_counts("main", 4 * len(main_cfgs))
    # one launch per render(): a warm-up and three timed frames per shape
    check(counts == {"render_kernel": 4 * len(main_cfgs),
                     "surface_kernel": 0, "march_kernel": 0,
                     "shade_kernel": 0},
          f"forward renders launched {counts}")
    for cfg, img, s in zip(main_cfgs, images, secs):
        check(img.shape == (cfg.height, cfg.width, 3), f"shape {img.shape}")
        check(bool(torch.isfinite(img).all()), "image not finite")
        check(img.max().item() > 0.0, "image all black")
        check(has_demo_objects(img), "demo objects missing")
        print(f"[main] demo {cfg.width}x{cfg.height} ssaa{cfg.ssaa} "
              f"{cfg.iterations} it: {s:.4f} s, "
              f"{cfg.rays_per_image / s / 1e6:.3f} Mrays/s; {card}")
    fused_img, fused_s = images[0], secs[0]
    tcfg = main_cfgs[0]
    R = tcfg.rays_per_image
    tt = tables_to_torch(tables, dev)
    origin, dirs = rays_for(plan, tt, tcfg)
    worst, k1_ms, k1_plain_ms, k1_count = compare(plan, tcfg, tt, origin,
                                                  dirs)
    dev_ms = {"render_kernel": device_ms(
        lambda: render_rays(plan, tcfg, tt, origin, dirs), "render_kernel")}
    print(f"[kernel] render_kernel demo {tcfg.width}x{tcfg.height} "
          f"ssaa{tcfg.ssaa}: K1 {k1_ms:.3f} ms with its wrapper, "
          f"{dev_ms['render_kernel']:.3f} ms on the device alone, plain "
          f"{k1_plain_ms:.3f} ms; "
          + ", ".join(f"{k} {v:.6g}" for k, v in worst.items()) + f"; {card}")
    big = main_cfgs[1]
    big_org, big_dirs = rays_for(plan, tt, big)
    k1_big, k1_big_ms = timed(lambda: render_rays(plan, big, tt, big_org,
                                                  big_dirs), runs=5)
    # rays are independent: the plain twin on every BIG_STRIDE-th ray must
    # give those rays' outputs of the full launch, bitwise
    sub_org = big_org if big_org.dim() == 1 else big_org[::BIG_STRIDE]
    k1_big_p = render_rays_plain(plan, big, tt, sub_org,
                                 big_dirs[::BIG_STRIDE])
    same(f"K1 at {big.width}x{big.height} ssaa{big.ssaa}",
         tuple(v[::BIG_STRIDE] for v in k1_big), k1_big_p, "render_kernel")
    k1_big_dev = device_ms(lambda: render_rays(plan, big, tt, big_org,
                                               big_dirs), "render_kernel", 3)
    print(f"[kernel] render_kernel demo {big.width}x{big.height} "
          f"ssaa{big.ssaa}: K1 {k1_big_ms:.3f} ms with its wrapper, "
          f"{k1_big_dev:.3f} ms on the device alone; every output of every "
          f"{BIG_STRIDE}th ray ({k1_big_p.p.shape[0]} of "
          f"{big_dirs.shape[0]}) bitwise equal to the plain twin's; {card}")
    del k1_big, k1_big_p, big_dirs
    # K1 reads a direction and writes 5 floats and 2 ints a ray
    k1_bound = bound_ms(k1_count, R * (12 + 32))
    # the same with every leaf folded: the bound before the collapse
    leaf_bounds = {"render_kernel": bound_ms(timed_counted(
        lambda: render_rays_plain(plan, tcfg, tt, origin, dirs,
                                  collapse=False))[2], R * (12 + 32))}

    # 6. training: fit the perturbed demo back to the true one
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

    def check_step_grads():
        for grads in step_grads:
            for f, g in grads.items():
                check(bool(torch.isfinite(g).all()),
                      f"{f} gradient not finite")
                rows_ = perturbed[f]
                check(bool((g[rows_].abs().sum(dim=-1) > 0).all()),
                      f"{f} gradient is zero on perturbed rows {rows_}")

    zero_counts()
    t0 = time.perf_counter()
    res = rt.fit(plan, start, target, tcfg, device=dev, steps=5,
                 trainable=TRAINABLE, optimizer=adam, callback=on_step)
    counts = add_counts("train", 5)
    check(counts == {"render_kernel": 5, "surface_kernel": 5,
                     "march_kernel": 0, "shade_kernel": 0},
          f"5 fit steps launched {counts}")
    check_step_grads()
    check(res.losses[-1] < res.losses[0], f"loss did not fall: {res.losses}")
    step_s = sorted(np.diff([t0] + stamps))
    med = statistics.median(step_s)
    print(f"[train] demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"{tcfg.iterations} it, Adam (colour lr {COLOR_LR}, geometry "
          f"and light lr {GEOMETRY_LR}) on {', '.join(TRAINABLE)}: "
          f"loss {' '.join(f'{v:.6g}' for v in res.losses)}; launches "
          f"K1 {counts['render_kernel']}, K2 {counts['surface_kernel']}")
    print(f"[train] step median {med * 1e3:.1f} ms (min "
          f"{step_s[0] * 1e3:.1f}, max {step_s[-1] * 1e3:.1f}), fwd+bwd "
          f"{rays / med / 1e6:.3f} Mrays/s; {card}")
    fused_step_s = med

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

    # K2 against its twin on the stencils of a step, and the scatter alone:
    # on the tables the fit starts from (its first step: the cross rows
    # still share the lattice, so the combined mode takes the collapse) and
    # on the fitted tables (Adam has moved every cross row: the flag is 0
    # and the same kernel folds leaf by leaf)
    def k2_on_step(step_tables, what):
        """K2's stencil entry on a step's 7-point stencils against its
        twin: (ms with wrapper, device ms, plain ms, bound, bound with
        every leaf folded, the kernel's outputs)."""
        tt_ = tables_to_torch(step_tables, dev)
        p_ = render_rays(plan, tcfg.replace(shade_skip_black=False), tt_,
                         *rays_for(plan, tt_, tcfg)).p
        q_ = sk.stencil_points(p_, tcfg.fd_h,
                                      center=True).reshape(-1, 3)
        out, ms = timed(lambda: scene_vjp.stencil_eval(
            plan, tcfg, tt_, p_, center=True), runs=5)
        plain, plain_ms, count = timed_counted(
            lambda: sk.surface_eval_plain(plan, tt_, q_))
        same(f"K2 combined on the 7-point stencils at 512^2, {what}", out,
             tuple(b.reshape(a.shape) for a, b in zip(out, plain)),
             "surface_kernel")
        # the stencil entry reads a hit (12 bytes) and writes 4 floats and
        # an int for each of its 7 stencil points
        n_bytes = p_.shape[0] * (12 + 7 * 20)
        leaf = bound_ms(timed_counted(lambda: sk.surface_eval_plain(
            plan, tt_, q_, collapse=False))[2], n_bytes)
        dev_t = device_ms(lambda: scene_vjp.stencil_eval(
            plan, tcfg, tt_, p_, center=True), "surface_kernel")
        flag = int(lattice_ok(plan.kernel, tt_).item())
        print(f"[kernel] surface_kernel demo stencil entry on {what} "
              f"(collapse flag {flag}), {p_.shape[0]} hits = {q_.shape[0]} "
              f"points: K2 {ms:.3f} ms with its wrapper, {dev_t:.3f} ms on "
              f"the device alone, plain {plain_ms:.3f} ms; sd, widx, g "
              f"bitwise equal; {card}")
        return ms, dev_t, plain_ms, bound_ms(count, n_bytes), leaf, tt_, out

    (k2_ms, dev_ms["surface_kernel"], k2_plain_ms, k2_bound,
     leaf_bounds["surface_kernel"], _, _) = k2_on_step(
         start, "the fit's first tables")
    k2_fit_ms, _, _, _, _, tt, (sd7, widx7, g7) = k2_on_step(
        res.tables, "the fitted tables")
    u = torch.randn(sd7.shape, device=dev)
    _, scatter_ms = timed(lambda: scene_vjp.theta_cotangents(
        plan, tt, widx7, g7, u), runs=5)
    print(f"[train] step split (median of 3, CUDA events): forward "
          f"{fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (K2 {k2_fit_ms:.2f} "
          f"ms, rest: replay + scatter {bwd_ms - k2_fit_ms:.2f} ms), "
          f"optimizer {opt_ms:.2f} ms; {card}")
    print(f"[train] parameter scatter alone (theta_cotangents, "
          f"{sd7.numel()} rows x 7 columns onto {plan.num_primitives} leaf "
          f"rows): {scatter_ms:.2f} ms; {card}")
    del sd7, widx7, g7, u

    # 7. the multi-kernel backend at the same frame
    tt = tables_to_torch(tables, dev)
    origin, dirs = rays_for(plan, tt, tcfg)
    zero_counts()
    rt.render(demo, tcfg, backend="multi", device=dev)
    multi_img, multi_ms = timed(
        lambda: rt.render(demo, tcfg, backend="multi", device=dev), runs=3)
    counts = add_counts("multi", 4)
    L = plan.num_lights
    check(counts == {"render_kernel": 0, "surface_kernel": 4 * 2,
                     "march_kernel": 4 * (1 + L), "shade_kernel": 0},
          f"4 multi-kernel frames launched {counts}")
    check(has_demo_objects(multi_img), "demo objects missing (multi)")
    diff = (multi_img - fused_img).abs()
    multi_err = diff.max().item()
    close = (diff.amax(dim=-1) <= MULTI_ATOL).double().mean().item()
    check(close >= AGREE, f"multi vs fused image: {close:.6f} of pixels "
          f"within {MULTI_ATOL}")
    check(diff.mean().item() <= MULTI_ATOL, "multi vs fused image: mean "
          f"difference {diff.mean().item()}")
    print(f"[multi] demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"{tcfg.iterations} it, backend=multi: {multi_ms / 1e3:.4f} s "
          f"(fused backend {fused_s:.4f} s in this run), "
          f"{R / multi_ms / 1e3:.3f} Mrays/s; launches a frame: K3 {1 + L} "
          f"(1 primary + {L} shadow), K2 2 (winner, FD gradient), K1 0, "
          f"K4 0; {card}")
    print(f"[multi] image vs backend=cuda: max |diff| {multi_err:.3g}, "
          f"{close:.6f} of pixels within {MULTI_ATOL} (the JAX suite's "
          f"tolerance for pallas vs mega), mean |diff| "
          f"{diff.mean().item():.3g}")
    (hit, steps), k3_ms = timed(lambda: mk.march_rays(
        plan, tcfg, tt, origin, dirs, with_steps=True), runs=5)
    (hit_p, steps_p), k3_plain_ms, k3_count = timed_counted(
        lambda: mk.march_rays_plain(plan, tcfg, tt, origin, dirs,
                                    with_steps=True))
    same("K3 primary at 512^2", (*hit, steps), (*hit_p, steps_p),
         "march_kernel")
    # K3 reads a direction and writes 5 floats (and here the step count)
    k3_bound = bound_ms(k3_count, R * (12 + 24))
    leaf_bounds["march_kernel"] = bound_ms(timed_counted(
        lambda: mk.march_rays_plain(plan, tcfg, tt, origin, dirs,
                                    collapse=False))[2], R * (12 + 24))
    check(k3_bound[2] > 0 and int(steps.sum()) > 0, "no march work counted")
    dev_ms["march_kernel"] = device_ms(lambda: mk.march_rays(
        plan, tcfg, tt, origin, dirs, with_steps=True), "march_kernel")
    print(f"[kernel] march_kernel demo primary rays {R}: K3 {k3_ms:.3f} ms "
          f"with its wrapper, {dev_ms['march_kernel']:.3f} ms on the device "
          f"alone, plain {k3_plain_ms:.3f} ms; position, sd, converged, steps "
          f"bitwise equal; {int(steps.sum())} evaluations, "
          f"{leaf_bounds['march_kernel'][2] / int(steps.sum()):.1f} of "
          f"{plan.num_primitives} leaves an evaluation after the cull with "
          f"every leaf folded, {k3_bound[5] / int(steps.sum()):.1f} "
          f"operations an evaluation with the collapse against "
          f"{leaf_bounds['march_kernel'][5] / int(steps.sum()):.1f}; {card}")
    # K2 as the multi frame and step launch it: winner and FD gradient at
    # the hit points (forward), the combined mode at the hit points
    # (MarchOp's backward) and on their six-point stencils (NormalOp's)
    q6 = sk.stencil_points(hit.position, tcfg.fd_h,
                                  center=False).reshape(-1, 3)
    # (label, points, mode, bytes written a point: 4 a float, 4 a winner);
    # every mode reads a point's 12 bytes
    k2_modes = {}
    for label, q, mode, out_bytes in (
            ("winner", hit.position, sk.WINNER, 8),
            ("FD gradient", hit.position, sk.FD_GRAD, 16),
            ("combined", hit.position, sk.COMBINED, 20),
            ("combined, six-point stencils", q6, sk.COMBINED, 20),
            ("analytic", hit.position, sk.ANALYTIC, 16)):
        fn = lambda: sk.surface_eval(  # noqa: E731
            plan, tt, q, mode=mode, fd_h=tcfg.fd_h)
        k2m, k2m_ms = timed(fn, runs=5)
        k2m_p, k2m_plain_ms, k2m_count = timed_counted(
            lambda: sk.surface_eval_plain(plan, tt, q, mode=mode,
                                          fd_h=tcfg.fd_h))
        same(f"K2 {label} at 512^2", k2m, k2m_p, "surface_kernel")
        k2m_bound = bound_ms(k2m_count, q.shape[0] * (12 + out_bytes))
        k2m_dev = device_ms(fn, "surface_kernel", 3)
        k2_modes[label] = (k2m_ms, k2m_dev, k2m_plain_ms, k2m_bound)
        print(f"[kernel] surface_kernel demo {label}, {q.shape[0]} points: "
              f"K2 {k2m_ms:.3f} ms with its wrapper, {k2m_dev:.3f} ms on the "
              f"device alone, plain {k2m_plain_ms:.3f} ms; bound "
              f"{k2m_bound[0]:.4f} ms by {k2m_bound[1]} ({k2m_bound[5]} "
              f"operations, {k2m_bound[2]} leaf evaluations); bitwise "
              f"equal; {card}")
        if mode == sk.FD_GRAD:
            g = k2m[2]
    del q6, k2m, k2m_p
    for li in range(L):
        s, d, tmax = shadow_rays(tt, tcfg, hit.position, normalize(g), li)
        sh, sh_ms = timed(lambda: mk.march_rays(plan, tcfg, tt, s, d,
                                                tmax=tmax), runs=5)
        sh_p, sh_plain_ms = timed(lambda: mk.march_rays_plain(
            plan, tcfg, tt, s, d, tmax=tmax))
        same(f"K3 shadow rays of light {li} at 512^2", sh, sh_p,
             "march_kernel")
        sh_dev = device_ms(lambda: mk.march_rays(plan, tcfg, tt, s, d,
                                                 tmax=tmax), "march_kernel")
        print(f"[kernel] march_kernel demo shadow rays of light {li} with "
              f"tmax {R}: K3 {sh_ms:.3f} ms with its wrapper, {sh_dev:.3f} "
              f"ms on the device alone, plain {sh_plain_ms:.3f} ms; "
              f"bitwise equal; {card}")

    # 8. the two-phase march of the fused backend
    cfg2 = tcfg.replace(two_phase_k1=48)
    zero_counts()
    rt.render(demo, cfg2, device=dev)
    tp_img, tp_ms = timed(lambda: rt.render(demo, cfg2, device=dev), runs=3)
    counts = add_counts("two_phase", 4)
    check(counts == {"render_kernel": 0, "surface_kernel": 0,
                     "march_kernel": 4 * 2, "shade_kernel": 4},
          f"4 two-phase frames launched {counts}")
    check(torch.equal(tp_img, fused_img),
          "the two-phase image differs from the one-kernel image")
    # both frames again in turns: at this size the host's share of a frame
    # varies more than the kernels differ
    turns = [timed(lambda: rt.render(demo, c, device=dev), runs=3)[1]
             for c in (cfg2, tcfg, tcfg, cfg2)]
    tp_ms, one_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    left = (~mk.march_rays(plan, tcfg, tt, origin, dirs,
                           iterations=48).converged).sum().item()
    print(f"[two-phase] demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"two_phase_k1=48: image equal to the one-kernel frame; "
          f"{left} of {R} rays ({left / R:.5f}) unconverged after phase 1 "
          f"(capacity {phase2_capacity(cfg2, R)}); frame "
          f"{tp_ms / 1e3:.4f} s against {one_ms / 1e3:.4f} s one-kernel in "
          f"this run (in turns: two-phase, one, one, two-phase); launches a "
          f"frame: K3 2, K4 1; {card}")
    ocfg = small.replace(two_phase_k1=1)
    o_org, o_dirs = rays_for(plan, tt, ocfg)
    left1 = (~mk.march_rays(plan, ocfg, tt, o_org, o_dirs,
                            iterations=1).converged).sum().item()
    check(left1 > phase2_capacity(ocfg, o_dirs.shape[0]),
          "two_phase_k1=1 did not overflow the second phase")
    zero_counts()
    over = rt.render(demo, ocfg, device=dev)
    counts = add_counts("two_phase_overflow", 1)
    check(counts["march_kernel"] == 2 and counts["shade_kernel"] == 1,
          f"the overflow frame launched {counts}")
    check(torch.equal(over, rt.render(demo, small, device=dev)),
          "the overflow branch's image differs from the one-kernel image")
    print(f"[two-phase] demo {small.width}x{small.height} ssaa{small.ssaa} "
          f"two_phase_k1=1: {left1} of {o_dirs.shape[0]} rays unconverged "
          f"> capacity {phase2_capacity(ocfg, o_dirs.shape[0])}: the full "
          "march ran again, image equal to the one-kernel frame")
    hit2 = two_phase_march(plan, cfg2, tt, origin, dirs)
    same("two-phase march against one march", hit2, hit)
    k4, k4_ms = timed(lambda: shk.shade_rays(plan, tcfg, tt, hit2.position,
                                             hit2.sd, dirs), runs=5)
    k4_p, k4_plain_ms, k4_count = timed_counted(
        lambda: shk.shade_rays_plain(plan, tcfg, tt, hit2.position, hit2.sd,
                                     dirs))
    same("K4 at 512^2", k4, k4_p, "shade_kernel")
    # K4 reads 7 floats and writes a float and 2 ints a ray
    k4_bound = bound_ms(k4_count, R * (28 + 12))
    leaf_bounds["shade_kernel"] = bound_ms(timed_counted(
        lambda: shk.shade_rays_plain(plan, tcfg, tt, hit2.position, hit2.sd,
                                     dirs, collapse=False))[2], R * (28 + 12))
    dev_ms["shade_kernel"] = device_ms(lambda: shk.shade_rays(
        plan, tcfg, tt, hit2.position, hit2.sd, dirs), "shade_kernel")
    print(f"[kernel] shade_kernel demo hit points {R}: K4 {k4_ms:.3f} ms "
          f"with its wrapper, {dev_ms['shade_kernel']:.3f} ms on the device "
          f"alone, plain {k4_plain_ms:.3f} ms; cidx, light, smask bitwise equal; "
          f"{card}")

    # K4's three phases apart, on the same hit points, in turns: without
    # its shadow marches it is the winner fold and the normal; K2's winner
    # and FD-gradient modes are those two alone (at the hit point, where K4
    # takes its winner a step back)
    noshadow = tcfg.replace(shadows=False)
    phase_fns = {
        "K4": (lambda: shk.shade_rays(plan, tcfg, tt, hit2.position, hit2.sd,
                                      dirs), "shade_kernel"),
        "K4 without shadows": (lambda: shk.shade_rays(
            plan, noshadow, tt, hit2.position, hit2.sd, dirs),
            "shade_kernel"),
        "K2 winner": (lambda: sk.surface_eval(
            plan, tt, hit2.position, mode=sk.WINNER), "surface_kernel"),
        "K2 FD gradient": (lambda: sk.surface_eval(
            plan, tt, hit2.position, mode=sk.FD_GRAD, fd_h=tcfg.fd_h),
            "surface_kernel"),
    }
    order = list(phase_fns) + list(phase_fns)[::-1]
    phase_ms = dict.fromkeys(phase_fns, 0.0)
    for k in order:
        phase_ms[k] += device_ms(*phase_fns[k], 3) / 2
    print(f"[phases] demo hit points {R}, device time of the kernel alone, "
          f"in turns (each twice, the median of 3 launches): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in phase_ms.items())
          + f"; so K4's shadow marches "
          f"{phase_ms['K4'] - phase_ms['K4 without shadows']:.3f} ms, its "
          f"winner fold and normal {phase_ms['K4 without shadows']:.3f} ms "
          f"(K2: winner {phase_ms['K2 winner']:.3f}, FD gradient with the "
          f"centre {phase_ms['K2 FD gradient']:.3f}); {card}")

    # 9. training through the multi-kernel backend
    stamps.clear()
    step_grads.clear()
    zero_counts()
    t0 = time.perf_counter()
    mres = rt.fit(plan, start, target, tcfg, device=dev, backend="multi",
                  steps=3, trainable=TRAINABLE, optimizer=adam,
                  callback=on_step)
    counts = add_counts("train_multi", 3)
    # a step: K3 primary + L shadow; K2 winner, FD gradient, and the
    # combined mode for MarchOp's and NormalOp's backward
    check(counts == {"render_kernel": 0, "surface_kernel": 3 * 4,
                     "march_kernel": 3 * (1 + L), "shade_kernel": 0},
          f"3 multi-kernel fit steps launched {counts}")
    check_step_grads()
    check(all(np.isfinite(mres.losses)), f"losses {mres.losses}")
    # both backends start from the same tables: the same first loss, to
    # the image tolerance
    check(abs(mres.losses[0] - res.losses[0]) <= 1e-5,
          f"first loss {mres.losses[0]} against fused {res.losses[0]}")
    mstep_s = sorted(np.diff([t0] + stamps))
    mmed = statistics.median(mstep_s)
    print(f"[train-multi] demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"backend=multi, 3 Adam steps: loss "
          f"{' '.join(f'{v:.6g}' for v in mres.losses)}; step median "
          f"{mmed * 1e3:.1f} ms (min {mstep_s[0] * 1e3:.1f}) against the "
          f"fused backend's {fused_step_s * 1e3:.1f} ms in this run, "
          f"fwd+bwd {rays / mmed / 1e6:.3f} Mrays/s; launches a step: K3 "
          f"{1 + L}, K2 4; {card}")
    fields = tables._fields
    grads = {}
    for backend in ("cuda", "multi"):
        gt = tables_to_torch(start, dev, requires_grad=fields)
        img = render_tables(plan, gt, tcfg.replace(shade_skip_black=False),
                            backend=backend, differentiable=True, device=dev)
        grads[backend] = torch.autograd.grad(
            torch.mean((img - target) ** 2), list(gt), allow_unused=True,
            materialize_grads=True)
    worst_mg = grad_check(fields, grads["multi"], grads["cuda"],
                          "multi vs fused")
    print(f"[train-multi] gradients of the first step's loss, "
          f"backend=multi against backend=cuda on the same rays, every "
          f"table field: max |diff| / field scale {worst_mg[0]:.3g} "
          f"({worst_mg[1]}; tolerance rtol {GRAD_RTOL}, atol "
          f"{GRAD_ATOL_SCALE} x scale)")

    # 9b. the analytic-normal regime on the same footprint
    acfg, abig = (c.replace(normal_mode="analytic") for c in main_cfgs)
    zero_counts()
    a_images, a_secs = [], []
    for cfg in (acfg, abig):
        rt.render(demo, cfg, device=dev)             # warm-up at this shape
        img, ms = timed(lambda: rt.render(demo, cfg, device=dev), runs=3)
        a_images.append(img)
        a_secs.append(ms / 1e3)
    counts = add_counts("analytic", 8)
    check(counts == {"render_kernel": 8, "surface_kernel": 0,
                     "march_kernel": 0, "shade_kernel": 0},
          f"analytic forward renders launched {counts}")
    for cfg, img, s_, fd_img, fd_s in zip((acfg, abig), a_images, a_secs,
                                          images, secs):
        check(img.shape == (cfg.height, cfg.width, 3), f"shape {img.shape}")
        check(bool(torch.isfinite(img).all()), "analytic image not finite")
        check(has_demo_objects(img), "demo objects missing (analytic)")
        # tests/test_mega.py:176-177: analytic against FD normals
        diff = (img - fd_img).abs().amax(dim=-1)
        share = (diff < ANALYTIC_ATOL).double().mean().item()
        med = diff.median().item()
        check(share >= ANALYTIC_SHARE and med < ANALYTIC_MEDIAN,
              f"analytic vs FD image: {share:.6f} of pixels under "
              f"{ANALYTIC_ATOL}, median {med}")
        print(f"[analytic] demo {cfg.width}x{cfg.height} ssaa{cfg.ssaa} "
              f"{cfg.iterations} it, render() with analytic normals: "
              f"{s_:.4f} s against {fd_s:.4f} s with FD normals in this run, "
              f"{cfg.rays_per_image / s_ / 1e6:.3f} Mrays/s; image against "
              f"the FD image: {share:.6f} of pixels under {ANALYTIC_ATOL}, "
              f"median {med:.3g}, max {diff.max().item():.3g}; {card}")
    att = tables_to_torch(tables, dev)
    origin, dirs = rays_for(plan, att, acfg)
    # K1 with and without the residuals against its twin, every output
    (k1a, w1a), k1aw_ms = timed(lambda: render_rays(
        plan, acfg, att, origin, dirs, save_winner=True), runs=5)
    k1a_n, k1a_ms = timed(lambda: render_rays(plan, acfg, att, origin, dirs),
                          runs=5)
    (p1a, pw1a), k1a_plain_ms, k1a_count = timed_counted(
        lambda: render_rays_plain(plan, acfg, att, origin, dirs,
                                  save_winner=True))
    same("K1 analytic at 512^2 with residuals", (*k1a, *w1a), (*p1a, *pw1a),
         "render_kernel")
    same("K1 analytic at 512^2 without residuals", k1a_n, p1a,
         "render_kernel")
    check(not torch.equal(k1a.light, render_rays(plan, tcfg, att, origin,
                                                 dirs).light),
          "the analytic light equals the FD light")
    # K4 on K1's hits, with and without residuals, against its twin and K1
    (k4a, w4a), k4aw_ms = timed(lambda: shk.shade_rays(
        plan, acfg, att, k1a.p, k1a.sd, dirs, save_winner=True), runs=5)
    k4a_n, k4a_ms = timed(lambda: shk.shade_rays(plan, acfg, att, k1a.p,
                                                 k1a.sd, dirs), runs=5)
    (s4a, sw4a), k4a_plain_ms, k4a_count = timed_counted(
        lambda: shk.shade_rays_plain(plan, acfg, att, k1a.p, k1a.sd, dirs,
                                     save_winner=True))
    same("K4 analytic at 512^2 with residuals", (*k4a, *w4a), (*s4a, *sw4a),
         "shade_kernel")
    same("K4 analytic at 512^2 without residuals", k4a_n, s4a,
         "shade_kernel")
    same("K4 analytic against K1's outputs and residuals", (*k4a, *w4a),
         (k1a.cidx, k1a.light, k1a.smask, *w1a))
    # K3 + K4 = K1, and K2's combined and analytic modes = the residuals
    two, w2 = render_rays(plan, acfg.replace(two_phase_k1=48), att, origin,
                          dirs, save_winner=True)
    same("K3, K3, K4 = K1 with analytic normals", (*two, *w2), (*k1a, *w1a))
    k2a = sk.surface_eval(plan, att, k1a.p, mode=sk.ANALYTIC)
    same("K2 analytic at K1's hits", k2a, sk.surface_eval_plain(
        plan, att, k1a.p, mode=sk.ANALYTIC), "surface_kernel")
    same("K2 analytic = K1's residuals", (k2a[0], k2a[2]), (w1a.sd, w1a.g))
    same("K2 combined = K1's residuals", scene_vjp.winner_eval(
        plan, att, k1a.p), w1a)
    del p1a, pw1a, s4a, sw4a, k4a, w4a, two, w2, k2a, k1a_n, k4a_n
    zero_counts()
    a_two = rt.render(demo, acfg.replace(two_phase_k1=48), device=dev)
    counts = add_counts("two_phase_analytic", 1)
    check(counts["march_kernel"] == 2 and counts["shade_kernel"] == 1,
          f"an analytic two-phase frame launched {counts}")
    check(torch.equal(a_two, a_images[0]),
          "the analytic two-phase image differs from the one-kernel image")
    # K1 writes 5 floats and 2 ints a ray and, with the residuals, 4 floats
    # and an int more; K4 reads 7 floats and writes a float and 2 ints
    k1a_bound = bound_ms(k1a_count, R * (12 + 32))
    k4a_bound = bound_ms(k4a_count, R * (28 + 12))

    def in_turns(fa, fb, needle, runs=3):
        """Median device ms of fa and fb, in turns (a, b, b, a)."""
        t = [device_ms(f, needle, runs) for f in (fa, fb, fb, fa)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    big_org, big_dirs = rays_for(plan, att, abig)
    dev_turns = {
        "K1 512x512 ssaa2": in_turns(
            lambda: render_rays(plan, tcfg, att, origin, dirs),
            lambda: render_rays(plan, acfg, att, origin, dirs),
            "render_kernel"),
        f"K1 {big.width}x{big.height} ssaa{big.ssaa}": in_turns(
            lambda: render_rays(plan, big, att, big_org, big_dirs),
            lambda: render_rays(plan, abig, att, big_org, big_dirs),
            "render_kernel"),
        "K4": in_turns(
            lambda: shk.shade_rays(plan, tcfg, att, k1a.p, k1a.sd, dirs),
            lambda: shk.shade_rays(plan, acfg, att, k1a.p, k1a.sd, dirs),
            "shade_kernel"),
        "K2 FD gradient / analytic": in_turns(
            lambda: sk.surface_eval(plan, att, k1a.p, mode=sk.FD_GRAD,
                                    fd_h=tcfg.fd_h),
            lambda: sk.surface_eval(plan, att, k1a.p, mode=sk.ANALYTIC),
            "surface_kernel"),
    }
    del big_dirs
    k1aw_dev = device_ms(lambda: render_rays(plan, acfg, att, origin, dirs,
                                             save_winner=True),
                         "render_kernel", 3)
    print(f"[analytic] device time of the kernel alone, FD / analytic "
          f"normals in turns (fd, analytic, analytic, fd; each the median "
          f"of 3 launches), demo at 1000 iterations: "
          + "; ".join(f"{k} {a:.3f} / {b:.3f} ms"
                      for k, (a, b) in dev_turns.items())
          + f"; K1 512x512 ssaa2 analytic with its residuals "
          f"{k1aw_dev:.3f} ms; {card}")
    print(f"[kernel] render_kernel analytic demo {tcfg.width}x{tcfg.height} "
          f"ssaa{tcfg.ssaa}: K1 {k1a_ms:.3f} ms with its wrapper "
          f"({k1aw_ms:.3f} with residuals), plain {k1a_plain_ms:.3f} ms, "
          f"bound {k1a_bound[0]:.4f} ms by {k1a_bound[1]} ({k1a_bound[5]} "
          f"operations); every output and residual bitwise equal to the "
          f"twin's; K4 {k4a_ms:.3f} ms ({k4aw_ms:.3f} with residuals), "
          f"plain {k4a_plain_ms:.3f} ms, bound {k4a_bound[0]:.4f} ms by "
          f"{k4a_bound[1]}; K4 and K3 + K4 = K1 bitwise; {card}")

    # the card's analytic gradients against the CPU twins' on the same rays
    a_gcfg = gcfg.replace(normal_mode="analytic")
    g_rays = rays_for(plan, tables_to_torch(tables, "cpu"), a_gcfg)
    ga_card, launched = grads_of(plan, tables, a_gcfg, dev, *g_rays)
    check(launched == (1, 0), "a differentiable analytic render launched "
          f"(K1, K2) {launched}: the backward must launch no K2")
    ga_cpu, _ = grads_of(plan, tables, a_gcfg, torch.device("cpu"), *g_rays)
    worst_ag = grad_check(tables._fields + ("origin", "dirs"), ga_card,
                          ga_cpu, "analytic card vs CPU")
    print(f"[analytic] demo 32x24 gradients with analytic normals, card vs "
          f"CPU on the same rays, every table field and the rays: max "
          f"|diff| / field scale {worst_ag[0]:.3g} ({worst_ag[1]}; "
          f"tolerance rtol {GRAD_RTOL}, atol {GRAD_ATOL_SCALE} x scale); "
          f"launches K1 1, K2 0")

    # the fused analytic fit: one K1 launch a step, no K2
    stamps.clear()
    step_grads.clear()
    zero_counts()
    t0 = time.perf_counter()
    ares = rt.fit(plan, start, target, acfg, device=dev, steps=3,
                  trainable=TRAINABLE, optimizer=adam, callback=on_step)
    counts = add_counts("train_analytic", 3)
    check(counts == {"render_kernel": 3, "surface_kernel": 0,
                     "march_kernel": 0, "shade_kernel": 0},
          f"3 analytic fit steps launched {counts}")
    check_step_grads()
    check(ares.losses[-1] < ares.losses[0], f"loss did not fall: "
          f"{ares.losses}")
    astep = statistics.median(np.diff([t0] + stamps))
    att_g = tables_to_torch(ares.tables, dev, requires_grad=TRAINABLE)
    opt = adam([getattr(att_g, f) for f in TRAINABLE])
    splits = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        img = rt.render_tables(plan, att_g, acfg, differentiable=True,
                               device=dev)
        loss = torch.mean((img - target) ** 2)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    a_fwd, a_bwd, a_opt = (statistics.median(c) for c in zip(*splits))
    # the analytic backward's two float64 scatters alone, on a step's
    # residuals: the winner rows (7 columns) and the Hessian rows (3)
    at_ = tables_to_torch(ares.tables, dev)
    (_, wst) = render_rays(plan, acfg.replace(shade_skip_black=False), at_,
                           *rays_for(plan, at_, acfg), save_winner=True)
    u_ = torch.randn(wst.sd.shape, device=dev)
    gbar_ = torch.randn(wst.g.shape, device=dev)
    _, rows_, hidx_ = scene_vjp.winner_hessian_chain(plan, at_, wst.widx,
                                                     wst.g, gbar_, wst.sd)
    _, a_scatter_ms = timed(lambda: (
        scene_vjp.theta_cotangents(plan, at_, wst.widx, wst.g, u_),
        scene_vjp.segment_add(hidx_, rows_, plan.num_primitives)), runs=5)
    n_hess = int((hidx_ >= 0).sum())
    del wst, u_, gbar_, rows_, hidx_
    print(f"[analytic] fit, demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"{tcfg.iterations} it, analytic normals, 3 Adam steps: loss "
          f"{' '.join(f'{v:.6g}' for v in ares.losses)}; step median "
          f"{astep * 1e3:.1f} ms against {fused_step_s * 1e3:.1f} ms with FD "
          f"normals in this run; launches a step K1 1, K2 0; {card}")
    print(f"[analytic] step split (median of 3, CUDA events), analytic / "
          f"FD normals: forward {a_fwd:.2f} / {fwd_ms:.2f} ms, backward "
          f"{a_bwd:.2f} / {bwd_ms:.2f} ms (no K2 launch / K2 "
          f"{k2_fit_ms:.2f} ms), optimizer {a_opt:.2f} / {opt_ms:.2f} ms; "
          f"the parameter scatters alone {a_scatter_ms:.2f} ms ({R} winner "
          f"rows x 7 columns and {n_hess} sphere Hessian rows x 3) / "
          f"{scatter_ms:.2f} ms ({7 * R} rows x 7 columns); {card}")

    # the multi-kernel backend with analytic normals: frame and step
    zero_counts()
    rt.render(demo, acfg, backend="multi", device=dev)
    am_img, am_ms = timed(lambda: rt.render(demo, acfg, backend="multi",
                                            device=dev), runs=3)
    counts = add_counts("multi_analytic", 4)
    check(counts == {"render_kernel": 0, "surface_kernel": 4 * 2,
                     "march_kernel": 4 * (1 + L), "shade_kernel": 0},
          f"4 multi-kernel analytic frames launched {counts}")
    diff = (am_img - a_images[0]).abs()
    close = (diff.amax(dim=-1) <= MULTI_ATOL).double().mean().item()
    check(close >= AGREE and diff.mean().item() <= MULTI_ATOL,
          f"multi vs fused analytic image: {close:.6f} of pixels within "
          f"{MULTI_ATOL}, mean {diff.mean().item()}")
    stamps.clear()
    step_grads.clear()
    zero_counts()
    t0 = time.perf_counter()
    amres = rt.fit(plan, start, target, acfg, device=dev, backend="multi",
                   steps=3, trainable=TRAINABLE, optimizer=adam,
                   callback=on_step)
    counts = add_counts("train_multi_analytic", 3)
    # a step: K3 primary + L shadow; K2 winner, analytic, and the combined
    # mode for MarchOp's and NormalOp's backward
    check(counts == {"render_kernel": 0, "surface_kernel": 3 * 4,
                     "march_kernel": 3 * (1 + L), "shade_kernel": 0},
          f"3 multi-kernel analytic fit steps launched {counts}")
    check_step_grads()
    check(abs(amres.losses[0] - ares.losses[0]) <= 1e-5,
          f"first loss {amres.losses[0]} against fused {ares.losses[0]}")
    amstep = statistics.median(np.diff([t0] + stamps))
    print(f"[analytic] backend=multi, analytic normals: frame "
          f"{am_ms / 1e3:.4f} s (FD {multi_ms / 1e3:.4f} s in this run), "
          f"image against the fused analytic one: {close:.6f} of pixels "
          f"within {MULTI_ATOL}; 3 Adam steps, loss "
          f"{' '.join(f'{v:.6g}' for v in amres.losses)}, step median "
          f"{amstep * 1e3:.1f} ms (FD {mmed * 1e3:.1f} ms); launches a "
          f"frame K3 {1 + L}, K2 2 (winner, analytic), a step K3 {1 + L}, "
          f"K2 4; {card}")

    # 9c. fused generators (the JAX bench's headline regime) on the same
    # footprint: render() fused with analytic normals, the gate against
    # the exact FD image, every kernel against its twin, device times
    # against the exact field in turns, gradients, the fit, multi
    from raymarching_tpu_torch.api import render_aovs
    from raymarching_tpu_torch.utils.gatecheck import classify_offenders
    fcfg, fbig = (c.replace(fused_generators=True, normal_mode="analytic")
                  for c in main_cfgs)
    ffd = fcfg.replace(normal_mode="fd")
    zero_counts()
    f_images, f_secs = [], []
    for cfg in (fcfg, fbig):
        rt.render(demo, cfg, device=dev)             # warm-up at this shape
        img, ms = timed(lambda: rt.render(demo, cfg, device=dev), runs=3)
        f_images.append(img)
        f_secs.append(ms / 1e3)
    counts = add_counts("fused", 8)
    check(counts == {"render_kernel": 8, "surface_kernel": 0,
                     "march_kernel": 0, "shade_kernel": 0},
          f"fused forward renders launched {counts}")
    for cfg, img, s_, a_s, fd_s in zip((fcfg, fbig), f_images, f_secs,
                                       a_secs, secs):
        check(img.shape == (cfg.height, cfg.width, 3), f"shape {img.shape}")
        check(bool(torch.isfinite(img).all()), "fused image not finite")
        check(has_demo_objects(img), "demo objects missing (fused)")
        print(f"[fused] demo {cfg.width}x{cfg.height} ssaa{cfg.ssaa} "
              f"{cfg.iterations} it, render() with fused generators and "
              f"analytic normals: {s_:.4f} s against {a_s:.4f} s exact "
              f"analytic and {fd_s:.4f} s exact FD in this run, "
              f"{cfg.rays_per_image / s_ / 1e6:.3f} Mrays/s; {card}")
    # the gate: the fused analytic frame against the exact FD one, its
    # offenders classified against the exact frame's AOV planes
    gdiff = (f_images[0] - images[0]).abs().amax(dim=-1)
    gshare = (gdiff < GATE_ATOL).double().mean().item()
    # how far the fused field moves the frame: against the exact analytic one
    fa_diff = (f_images[0] - a_images[0]).abs().amax(dim=-1)
    aovs = {k: v.cpu().numpy() for k, v in render_aovs(
        plan, tables, tcfg, device=dev).items()}
    check(np.array_equal(aovs["color"], images[0].cpu().numpy()),
          "the AOV colour plane differs from render()'s image")
    gate = classify_offenders(gdiff.cpu().numpy(), GATE_ATOL, aovs["objid"],
                              aovs["depth"], aovs["hit"],
                              shadow=aovs["shadow"], normal=aovs["normal"])
    check(gshare > GATE_SHARE and gate["offenders_interior"] == 0,
          f"the fused gate: {gshare:.6f} of pixels within {GATE_ATOL} "
          f"(needs > {GATE_SHARE}), {gate}")
    print(f"[fused] gate, demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa}: "
          f"fused analytic against exact FD, {gshare:.6f} of pixels within "
          f"{GATE_ATOL} (needs > {GATE_SHARE}), max {gdiff.max().item():.3g}; "
          f"{gate['offenders']} offenders, {gate['offenders_on_silhouette']} "
          f"on silhouettes, {gate['offenders_interior']} interior "
          f"(utils.gatecheck against api.render_aovs' exact planes); against "
          f"the exact analytic frame {(fa_diff < GATE_ATOL).double().mean().item():.6f}"
          f" within {GATE_ATOL}, {(fa_diff > 0).double().mean().item():.6f} of "
          f"pixels differ, max {fa_diff.max().item():.3g}")
    ftt = tables_to_torch(tables, dev)
    origin, dirs = rays_for(plan, ftt, fcfg)
    (k1f, w1f), k1f_ms = timed(lambda: render_rays(
        plan, fcfg, ftt, origin, dirs, save_winner=True), runs=5)
    (p1f, pw1f), k1f_plain_ms, k1f_count = timed_counted(
        lambda: render_rays_plain(plan, fcfg, ftt, origin, dirs,
                                  save_winner=True))
    same("K1 fused analytic at 512^2 with residuals", (*k1f, *w1f),
         (*p1f, *pw1f), "render_kernel")
    n_ext = int((w1f.widx >= plan.num_primitives).sum())
    del p1f, pw1f
    k1ffd = render_rays(plan, ffd, ftt, origin, dirs)
    same(f"K1 fused FD at 512^2 on every {BIG_STRIDE}th ray",
         tuple(v[::BIG_STRIDE] for v in k1ffd),
         render_rays_plain(plan, ffd, ftt, origin, dirs[::BIG_STRIDE]),
         "render_kernel")
    (k4f, w4f), k4f_ms = timed(lambda: shk.shade_rays(
        plan, fcfg, ftt, k1f.p, k1f.sd, dirs, save_winner=True), runs=5)
    (s4f, sw4f), k4f_plain_ms, k4f_count = timed_counted(
        lambda: shk.shade_rays_plain(plan, fcfg, ftt, k1f.p, k1f.sd, dirs,
                                     save_winner=True))
    same("K4 fused analytic at 512^2", (*k4f, *w4f), (*s4f, *sw4f),
         "shade_kernel")
    same("K4 fused analytic against K1's", (*k4f, *w4f),
         (k1f.cidx, k1f.light, k1f.smask, *w1f))
    del s4f, sw4f, k4f, w4f
    (hf, stf), k3f_ms = timed(lambda: mk.march_rays(
        plan, fcfg, ftt, origin, dirs, with_steps=True), runs=5)
    (hf_p, stf_p), k3f_plain_ms, k3f_count = timed_counted(
        lambda: mk.march_rays_plain(plan, fcfg, ftt, origin, dirs,
                                    with_steps=True))
    same("K3 fused primary at 512^2", (*hf, stf), (*hf_p, stf_p),
         "march_kernel")
    same("K3 fused against K1's march", hf, (k1f.p, k1f.sd, k1f.done))
    del hf_p, stf_p
    f_k2 = {}
    for label, mode, out_bytes in (("winner", sk.WINNER, 8),
                                   ("FD gradient", sk.FD_GRAD, 16),
                                   ("combined", sk.COMBINED, 20),
                                   ("analytic", sk.ANALYTIC, 16)):
        fn = lambda: sk.surface_eval(  # noqa: E731
            plan, ftt, k1f.p, mode=mode, fd_h=tcfg.fd_h, fused=True)
        k2m, k2m_ms = timed(fn, runs=5)
        k2m_p, k2m_plain_ms, k2m_count = timed_counted(
            lambda: sk.surface_eval_plain(plan, ftt, k1f.p, mode=mode,
                                          fd_h=tcfg.fd_h, fused=True))
        same(f"K2 fused {label} at 512^2", k2m, k2m_p, "surface_kernel")
        f_k2[label] = (k2m_ms, k2m_plain_ms,
                       bound_ms(k2m_count, R * (12 + out_bytes)))
    same("K2 fused combined = K1's residuals", sk.surface_eval(
        plan, ftt, k1f.p, fused=True), w1f)
    del k2m, k2m_p
    # K1 with its residuals writes 5 floats, 2 ints, 4 floats and an int a
    # ray; K4 reads 7 floats and writes a float, 2 ints and the residuals
    k1f_bound = bound_ms(k1f_count, R * (12 + 32 + 20))
    k4f_bound = bound_ms(k4f_count, R * (28 + 12 + 20))
    k3f_bound = bound_ms(k3f_count, R * (12 + 24))
    print(f"[fused] kernels against their twins at 512^2, bitwise: K1 fused "
          f"analytic with residuals {k1f_ms:.3f} ms with its wrapper, plain "
          f"{k1f_plain_ms:.3f} ms, bound {k1f_bound[0]:.4f} ms by "
          f"{k1f_bound[1]} ({k1f_bound[5]} operations); {n_ext} of {R} hits "
          f"won by a carve (extended ids in the residuals); K1 fused FD on "
          f"every {BIG_STRIDE}th ray; K4 {k4f_ms:.3f} ms, plain "
          f"{k4f_plain_ms:.3f}, bound {k4f_bound[0]:.4f} by {k4f_bound[1]}; "
          f"K3 {k3f_ms:.3f} ms, plain {k3f_plain_ms:.3f}, bound "
          f"{k3f_bound[0]:.4f} by {k3f_bound[1]}, {int(stf.sum())} "
          f"evaluations; K2 "
          + ", ".join(f"{k} {a:.3f} ms (plain {b:.3f}, bound {c[0]:.4f} by "
                      f"{c[1]})" for k, (a, b, c) in f_k2.items())
          + f"; {card}")
    big_org, big_dirs = rays_for(plan, ftt, fbig)
    f_turns = {
        "K1 512x512 ssaa2 analytic": in_turns(
            lambda: render_rays(plan, acfg, ftt, origin, dirs),
            lambda: render_rays(plan, fcfg, ftt, origin, dirs),
            "render_kernel"),
        "K1 512x512 ssaa2 FD": in_turns(
            lambda: render_rays(plan, tcfg, ftt, origin, dirs),
            lambda: render_rays(plan, ffd, ftt, origin, dirs),
            "render_kernel"),
        f"K1 {fbig.width}x{fbig.height} ssaa{fbig.ssaa} analytic": in_turns(
            lambda: render_rays(plan, abig, ftt, big_org, big_dirs),
            lambda: render_rays(plan, fbig, ftt, big_org, big_dirs),
            "render_kernel"),
        "K3 primary": in_turns(
            lambda: mk.march_rays(plan, tcfg, ftt, origin, dirs),
            lambda: mk.march_rays(plan, fcfg, ftt, origin, dirs),
            "march_kernel"),
        "K4 analytic": in_turns(
            lambda: shk.shade_rays(plan, acfg, ftt, k1f.p, k1f.sd, dirs),
            lambda: shk.shade_rays(plan, fcfg, ftt, k1f.p, k1f.sd, dirs),
            "shade_kernel"),
        "K4 FD": in_turns(
            lambda: shk.shade_rays(plan, tcfg, ftt, k1f.p, k1f.sd, dirs),
            lambda: shk.shade_rays(plan, ffd, ftt, k1f.p, k1f.sd, dirs),
            "shade_kernel"),
    }
    for label, mode in (("winner", sk.WINNER), ("FD gradient", sk.FD_GRAD),
                        ("combined", sk.COMBINED),
                        ("analytic", sk.ANALYTIC)):
        f_turns[f"K2 {label}"] = in_turns(
            lambda: sk.surface_eval(plan, ftt, k1f.p, mode=mode,
                                    fd_h=tcfg.fd_h),
            lambda: sk.surface_eval(plan, ftt, k1f.p, mode=mode,
                                    fd_h=tcfg.fd_h, fused=True),
            "surface_kernel")
    del big_dirs
    print(f"[fused] device time of the kernel alone, exact / fused "
          f"generators in turns (exact, fused, fused, exact; each the median "
          f"of 3 launches), demo at 1000 iterations: "
          + "; ".join(f"{k} {a:.3f} / {b:.3f} ms"
                      for k, (a, b) in f_turns.items()) + f"; {card}")
    # the card's fused gradients against the CPU twins' on the same rays
    for normal in ("fd", "analytic"):
        f_gcfg = gcfg.replace(fused_generators=True, normal_mode=normal)
        g_rays = rays_for(plan, tables_to_torch(tables, "cpu"), f_gcfg)
        gf_card, launched = grads_of(plan, tables, f_gcfg, dev, *g_rays)
        check(launched == (1, 0), f"a differentiable fused {normal} render "
              f"launched (K1, K2) {launched}: the backward launches no K2")
        gf_cpu, _ = grads_of(plan, tables, f_gcfg, torch.device("cpu"),
                             *g_rays)
        worst_fg = grad_check(tables._fields + ("origin", "dirs"), gf_card,
                              gf_cpu, f"fused {normal} card vs CPU")
        print(f"[fused] demo 32x24 gradients with fused generators and "
              f"{normal} normals, card vs CPU on the same rays, every table "
              f"field and the rays: max |diff| / field scale "
              f"{worst_fg[0]:.3g} ({worst_fg[1]}); launches K1 1, K2 0")
    # the fused analytic fit: one K1 launch a step, no K2
    stamps.clear()
    step_grads.clear()
    zero_counts()
    t0 = time.perf_counter()
    fres = rt.fit(plan, start, target, fcfg, device=dev, steps=3,
                  trainable=TRAINABLE, optimizer=adam, callback=on_step)
    counts = add_counts("train_fused", 3)
    check(counts == {"render_kernel": 3, "surface_kernel": 0,
                     "march_kernel": 0, "shade_kernel": 0},
          f"3 fused analytic fit steps launched {counts}")
    check_step_grads()
    check(all(np.isfinite(fres.losses)), f"losses {fres.losses}")
    fstep = statistics.median(np.diff([t0] + stamps))
    ft_g = tables_to_torch(fres.tables, dev, requires_grad=TRAINABLE)
    opt = adam([getattr(ft_g, f) for f in TRAINABLE])
    splits = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        img = rt.render_tables(plan, ft_g, fcfg, differentiable=True,
                               device=dev)
        loss = torch.mean((img - target) ** 2)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    f_fwd, f_bwd, f_opt = (statistics.median(c) for c in zip(*splits))
    ft_ = tables_to_torch(fres.tables, dev)
    (_, wst) = render_rays(plan, fcfg.replace(shade_skip_black=False), ft_,
                           *rays_for(plan, ft_, fcfg), save_winner=True)
    u_ = torch.randn(wst.sd.shape, device=dev)
    gbar_ = torch.randn(wst.g.shape, device=dev)
    pf_ = k1f.p
    _, f_scatter_ms = timed(lambda: (
        scene_vjp.fused_theta_cotangents(plan, ft_, wst.widx, wst.g, u_,
                                         wst.sd, pf_),
        scene_vjp.fused_winner_hessian_chain(plan, ft_, wst.widx, wst.g,
                                             gbar_, wst.sd)), runs=5)
    del wst, u_, gbar_
    print(f"[fused] fit, demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"{tcfg.iterations} it, fused generators and analytic normals, 3 "
          f"Adam steps: loss {' '.join(f'{v:.6g}' for v in fres.losses)}; "
          f"step median {fstep * 1e3:.1f} ms against {astep * 1e3:.1f} ms "
          f"exact analytic and {fused_step_s * 1e3:.1f} ms exact FD in this "
          f"run; launches a step K1 1, K2 0; split (median of 3, CUDA "
          f"events) fused / exact analytic: forward {f_fwd:.2f} / "
          f"{a_fwd:.2f} ms, backward {f_bwd:.2f} / {a_bwd:.2f} ms, optimizer "
          f"{f_opt:.2f} / {a_opt:.2f} ms; the scatters and the chain alone "
          f"{f_scatter_ms:.2f} / {a_scatter_ms:.2f} ms; {card}")
    # the multi-kernel backend on the fused field: frame, steps, two-phase
    zero_counts()
    rt.render(demo, fcfg, backend="multi", device=dev)
    fm_img, fm_ms = timed(lambda: rt.render(demo, fcfg, backend="multi",
                                            device=dev), runs=3)
    counts = add_counts("multi_fused", 4)
    check(counts == {"render_kernel": 0, "surface_kernel": 4 * 2,
                     "march_kernel": 4 * (1 + L), "shade_kernel": 0},
          f"4 multi-kernel fused frames launched {counts}")
    diff = (fm_img - f_images[0]).abs()
    close = (diff.amax(dim=-1) <= MULTI_ATOL).double().mean().item()
    check(close >= AGREE and diff.mean().item() <= MULTI_ATOL,
          f"multi vs fused-backend image with fused generators: {close:.6f} "
          f"of pixels within {MULTI_ATOL}, mean {diff.mean().item()}")
    stamps.clear()
    step_grads.clear()
    zero_counts()
    t0 = time.perf_counter()
    fmres = rt.fit(plan, start, target, fcfg, device=dev, backend="multi",
                   steps=3, trainable=TRAINABLE, optimizer=adam,
                   callback=on_step)
    counts = add_counts("train_multi_fused", 3)
    # a step: K3 primary + L shadow; K2 winner and analytic forward, the
    # fused combined mode for NormalOp's backward (MarchOp's is autograd
    # through scene_sd_fused)
    check(counts == {"render_kernel": 0, "surface_kernel": 3 * 3,
                     "march_kernel": 3 * (1 + L), "shade_kernel": 0},
          f"3 multi-kernel fused fit steps launched {counts}")
    check_step_grads()
    check(abs(fmres.losses[0] - fres.losses[0]) <= 1e-5,
          f"first loss {fmres.losses[0]} against fused {fres.losses[0]}")
    fmstep = statistics.median(np.diff([t0] + stamps))
    zero_counts()
    f_two = rt.render(demo, fcfg.replace(two_phase_k1=48), device=dev)
    counts = add_counts("two_phase_fused", 1)
    check(counts["march_kernel"] == 2 and counts["shade_kernel"] == 1,
          f"a fused two-phase frame launched {counts}")
    check(torch.equal(f_two, f_images[0]),
          "the fused two-phase image differs from the one-kernel image")
    print(f"[fused] backend=multi: frame {fm_ms / 1e3:.4f} s (exact analytic "
          f"{am_ms / 1e3:.4f} s in this run), image against the fused "
          f"backend's: {close:.6f} of pixels within {MULTI_ATOL}; 3 Adam "
          f"steps, loss {' '.join(f'{v:.6g}' for v in fmres.losses)}, step "
          f"median {fmstep * 1e3:.1f} ms (exact analytic {amstep * 1e3:.1f} "
          f"ms); launches a frame K3 {1 + L}, K2 2, a step K3 {1 + L}, K2 3; "
          f"two_phase_k1=48 (K3 2, K4 1) image equal to the one-kernel "
          f"frame; {card}")
    del k1f, w1f, k1ffd, hf, stf

    # 10. K3's step counter through profile_march
    prof = profile_march(plan, tables, tcfg, device=dev)
    st = prof["steps"]
    check(prof["rays"] == R and st["max"] <= tcfg.iterations
          and abs(st["mean"] - steps.double().mean().item()) < 1e-6,
          f"profile_march {prof}")
    print(f"[profile] demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"primary rays: {prof['converged']} of {prof['rays']} converged; "
          f"steps mean {st['mean']:.3f}, p50 {st['p50']}, p90 {st['p90']}, "
          f"p99 {st['p99']}, max {st['max']}")

    # 11. where a thread-per-ray kernel loses its lanes
    def lane_efficiency(st):
        """Sum of steps over 32 x the sum of each warp's slowest ray; warps
        are 32 consecutive rays."""
        st = torch.nn.functional.pad(st.double(), (0, -st.numel() % 32))
        w = st.reshape(-1, 32)
        return (w.sum() / (32 * w.max(dim=1).values.sum())).item()

    k1_out = render_rays(plan, tcfg, tt, origin, dirs)
    n_hat = normalize(g)
    black = shk.black_skip_ids(plan, tcfg, tt)
    skip_black = k1_out.cidx < 0
    for k in black:
        skip_black = skip_black | (k1_out.cidx == k)
    upper = torch.zeros_like(k1_out.sd)
    for li in range(L):
        upper = upper + torch.clamp_min(
            (n_hat * normalize(tt.light_pos[li] - hit.position)).sum(-1), 0.0)
    skip_sat = upper < tcfg.saturation
    skipped = skip_black | skip_sat
    # a warp whose every lane skips runs no shadow march at all
    all_skipped = torch.nn.functional.pad(
        skipped, (0, -R % 32), value=True).reshape(-1, 32).all(
            dim=1).double().mean().item()
    eff = {"primary": lane_efficiency(steps)}
    shadow_steps = torch.zeros_like(steps)
    for li in range(L):
        s, d, tmax = shadow_rays(tt, tcfg, hit.position, n_hat, li)
        _, sh_steps = mk.march_rays(plan, tcfg, tt, s, d, tmax=tmax,
                                    with_steps=True)
        shadow_steps += torch.where(skipped, 0, sh_steps)
        eff[f"shadow {li}"] = lane_efficiency(sh_steps)
        # inside K1 a skipped lane takes no step and waits
        eff[f"shadow {li} with K1's skips"] = lane_efficiency(
            torch.where(skipped, 0, sh_steps))
    # the floor under any march launch: its slowest ray marches alone,
    # one evaluation after the other
    slow = int(steps.argmax())
    slow_ms = device_ms(lambda: mk.march_rays(
        plan, tcfg, tt, origin, dirs[slow:slow + 1]), "march_kernel")
    cap_ms = device_ms(lambda: mk.march_rays(
        plan, tcfg, tt, origin, dirs, iterations=48), "march_kernel")
    print(f"[tail] demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa}: the "
          f"slowest primary ray alone ({int(steps[slow])} steps) takes K3 "
          f"{slow_ms:.3f} ms on the device, "
          f"{slow_ms * 1e3 / int(steps[slow]):.3f} us a step; all {R} rays "
          f"{dev_ms['march_kernel']:.3f} ms, and capped at 48 steps "
          f"({int(torch.clamp_max(steps, 48).sum())} of {int(steps.sum())} "
          f"evaluations) {cap_ms:.3f} ms; {card}")
    # the same floor under K4: the hit whose shadow marches, one light after
    # the other, are the longest
    slow4 = int(shadow_steps.argmax())
    slow4_ms = device_ms(lambda: shk.shade_rays(
        plan, tcfg, tt, hit.position[slow4:slow4 + 1], hit.sd[slow4:slow4 + 1],
        dirs[slow4:slow4 + 1]), "shade_kernel")
    live = shadow_steps[shadow_steps > 0].double()
    print(f"[tail] K4: the hit with the longest shadow marches alone "
          f"({int(shadow_steps[slow4])} steps over {L} lights, one after the "
          f"other) takes K4 {slow4_ms:.3f} ms on the device; all {R} hits "
          f"{dev_ms['shade_kernel']:.3f} ms; the {live.numel()} hits that "
          f"march take {live.mean().item():.1f} shadow steps in the mean, "
          f"p99 {int(live.quantile(0.99))}, p99.9 "
          f"{int(live.quantile(0.999))}; {card}")
    q7 = sk.stencil_points(hit.position, tcfg.fd_h, center=True)
    folded = carve_folded(plan, tt, q7.reshape(-1, 3)).reshape(7, -1)
    folded = torch.nn.functional.pad(folded, (0, -folded.shape[1] % 32))
    by_warp = folded.reshape(7, -1, 32).any(dim=-1)
    print(f"[warp] demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa}, warps of "
          f"32 consecutive rays; march lane efficiency (sum of steps / 32 x "
          f"sum of warp maxima): "
          + ", ".join(f"{k} {v:.4f}" for k, v in eff.items())
          + f"; cull coherence at the hit points and their stencils: the "
          f"carve is folded at {folded.double().mean().item():.4f} of "
          f"points, in {by_warp.double().mean().item():.4f} of warps; K1 "
          f"phases: {k1_out.done.double().mean().item():.4f} of rays "
          f"converge, shadow marches skipped for "
          f"{skip_black.double().mean().item():.4f} (black lane) and "
          f"{(skip_sat & ~skip_black).double().mean().item():.4f} more "
          f"(saturation floor), {skipped.double().mean().item():.4f} in all, "
          f"{all_skipped:.4f} of rays in warps that skip on every lane")
    del q7, folded, by_warp, k1_out

    # 12. the lattice collapse on against off, in turns, in this run
    def on_off(fn, needle, runs=5):
        """(median device ms on, off) of the ``needle`` kernel in
        fn(collapse), in turns (on, off, off, on), and their outputs, which
        must be bitwise equal."""
        same("collapse on against off", fn(True), fn(False))
        t = [device_ms(lambda: fn(c), needle, runs // 2 + 1)
             for c in (True, False, False, True)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    fn = lambda c: render_rays(plan, tcfg, tt, origin, dirs, collapse=c)  # noqa: E731
    k1_on, k1_off = on_off(fn, "render_kernel")
    big_org, big_dirs = rays_for(plan, tt, big)
    fn = lambda c: render_rays(plan, big, tt, big_org, big_dirs, collapse=c)  # noqa: E731
    k1b_on, k1b_off = on_off(fn, "render_kernel")
    del big_dirs
    fn = lambda c: mk.march_rays(plan, tcfg, tt, origin, dirs, collapse=c)  # noqa: E731
    k3_on, k3_off = on_off(fn, "march_kernel")
    sh_times = []
    for li in range(L):
        s, d, tmax = shadow_rays(tt, tcfg, hit.position, n_hat, li)
        fn = lambda c: mk.march_rays(plan, tcfg, tt, s, d, tmax=tmax,  # noqa: E731
                                     collapse=c)
        sh_times.append(on_off(fn, "march_kernel"))
    fn = lambda c: shk.shade_rays(plan, tcfg, tt, hit.position, hit.sd, dirs,  # noqa: E731
                                  collapse=c)
    k4_on, k4_off = on_off(fn, "shade_kernel")
    fn = lambda c: sk.surface_eval(plan, tt, hit.position, mode=sk.FD_GRAD,  # noqa: E731
                                   fd_h=tcfg.fd_h, collapse=c)
    k2_on, k2_off = on_off(lambda c: tuple(
        v for v in fn(c) if v is not None), "surface_kernel")
    # K2's combined mode on the stencils of a step: values and gradients
    # bitwise equal on and off; on a tie between crosses the collapsed fold
    # may name another cross of the tie class
    st_on, st_off = (scene_vjp.stencil_eval(plan, tcfg, tt, hit.position,
                                            center=True, collapse=c)
                     for c in (True, False))
    same("K2 stencil entry, collapse on against off (sd, g)",
         (st_on[0], st_on[2]), (st_off[0], st_off[2]))
    k2_same_winner = (st_on[1] == st_off[1]).double().mean().item()
    del st_on, st_off
    t = [device_ms(lambda: scene_vjp.stencil_eval(
        plan, tcfg, tt, hit.position, center=True, collapse=c),
        "surface_kernel", 3) for c in (True, False, False, True)]
    k2c_on, k2c_off = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"[collapse] demo, lattice collapse on / off in turns (on, off, "
          f"off, on; device time of the kernel alone, each the median of 3 "
          f"launches), outputs bitwise equal: K1 {tcfg.width}x{tcfg.height} "
          f"ssaa{tcfg.ssaa} {k1_on:.3f} / {k1_off:.3f} ms; K1 "
          f"{big.width}x{big.height} ssaa{big.ssaa} {k1b_on:.3f} / "
          f"{k1b_off:.3f} ms; K3 primary {k3_on:.3f} / {k3_off:.3f} ms; "
          + "; ".join(f"K3 shadow {li} {a:.3f} / {b:.3f} ms"
                      for li, (a, b) in enumerate(sh_times))
          + f"; K4 {k4_on:.3f} / {k4_off:.3f} ms; K2 FD gradient "
          f"{k2_on:.3f} / {k2_off:.3f} ms; K2 combined on the "
          f"{7 * R} stencil points of a step {k2c_on:.3f} / {k2c_off:.3f} ms "
          f"(sd and gradient bitwise equal, the same winner on "
          f"{k2_same_winner:.6f} of points: crosses that tie); {card}")
    # the scene in shared against device memory, same kernels, in turns
    def placements(fn, needle):
        """(device ms with the demo staged in shared memory, read from
        device memory) of fn(), in turns; outputs bitwise equal."""
        from raymarching_tpu_torch import tables as scene_tables
        limit = scene_tables.SHARED_SCENE_BYTES
        t, outs = [], []
        for nbytes in (limit, 0, 0, limit):
            scene_tables.SHARED_SCENE_BYTES = nbytes
            try:
                t.append(device_ms(fn, needle, 3))
                outs.append(fn())
            finally:
                scene_tables.SHARED_SCENE_BYTES = limit
        same("shared against device memory", outs[0], outs[1])
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    k1_sh, k1_dv = placements(
        lambda: render_rays(plan, tcfg, tt, origin, dirs), "render_kernel")
    k3_sh, k3_dv = placements(
        lambda: mk.march_rays(plan, tcfg, tt, origin, dirs), "march_kernel")
    k4_sh, k4_dv = placements(
        lambda: shk.shade_rays(plan, tcfg, tt, hit.position, hit.sd, dirs),
        "shade_kernel")
    k2_sh, k2_dv = placements(
        lambda: scene_vjp.stencil_eval(plan, tcfg, tt, hit.position,
                                       center=True), "surface_kernel")
    k2f_sh, k2f_dv = placements(
        lambda: tuple(v for v in sk.surface_eval(
            plan, tt, hit.position, mode=sk.FD_GRAD, fd_h=tcfg.fd_h)
            if v is not None), "surface_kernel")
    print(f"[placement] demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa}, the "
          f"scene staged in shared memory / read from device memory by the "
          f"same persistent kernel, in turns (device time of the kernel "
          f"alone), outputs bitwise equal: K1 {k1_sh:.3f} / {k1_dv:.3f} ms; "
          f"K3 primary {k3_sh:.3f} / {k3_dv:.3f} ms; K4 {k4_sh:.3f} / "
          f"{k4_dv:.3f} ms; K2 combined on the stencils {k2_sh:.3f} / "
          f"{k2_dv:.3f} ms; K2 FD gradient {k2f_sh:.3f} / {k2f_dv:.3f} ms; "
          f"{card}")

    # several points a walk of the scene against one, same kernels, in turns
    def turns(fn, needle, off):
        """(device ms with every keyword on, with the keywords ``off``
        off) of fn(**keywords), in turns (on, off, off, on); outputs
        bitwise equal."""
        same(f"{needle} with {off} off", tuple(
            v for v in fn() if v is not None), tuple(
            v for v in fn(**off) if v is not None))
        t = [device_ms(lambda: fn(**kw), needle, 3)
             for kw in ({}, off, off, {})]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    k2mp_on, k2mp_off = turns(lambda **kw: sk.surface_eval(
        plan, tt, hit.position, mode=sk.FD_GRAD, fd_h=tcfg.fd_h, **kw),
        "surface_kernel", {"multipoint": False})
    print(f"[multipoint] demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa}, K2's "
          f"FD-gradient mode on the {R} hit points, its seven points in one "
          f"walk of the scene / in seven walks, in turns (on, off, off, on; "
          f"device time of the kernel alone, each the median of 3 "
          f"launches), outputs bitwise equal: {k2mp_on:.3f} / "
          f"{k2mp_off:.3f} ms; {card}")

    # one cross row moved: the flag drops on the device and every kernel
    # folds leaf by leaf, as its twin does
    lat_g = next(g_ for g_ in plan.kernel.groups if g_.lattice is not None)
    moved_pos = np.array(tables.prim_pos)
    moved_pos[lat_g.start + 5, 0] += 0.25
    mt = tables_to_torch(tables._replace(prim_pos=moved_pos), dev)
    check(int(lattice_ok(plan.kernel, tt).item()) == 1
          and int(lattice_ok(plan.kernel, mt).item()) == 0,
          "the collapse flag of the demo and of the moved table")
    m_rays = rays_for(plan, mt, small)
    worst = compare(plan, small, mt, *m_rays)[0]
    n_cmp = compare_new(plan, small, mt, *m_rays)
    same("K1 on the moved table, collapse asked for against off",
         render_rays(plan, small, mt, *m_rays),
         render_rays(plan, small, mt, *m_rays, collapse=False))
    m_org, m_dirs = rays_for(plan, mt, tcfg)
    same("K1 on the moved table at 512^2, collapse asked for against off",
         render_rays(plan, tcfg, mt, m_org, m_dirs),
         render_rays(plan, tcfg, mt, m_org, m_dirs, collapse=False))
    print(f"[collapse] demo with cross row {lat_g.start + 5} moved by 0.25: "
          f"flag 0 on the device; K1 = plain twin ({worst['outputs']:.6g}), "
          f"K3, K4, K2 = plain twins ({n_cmp} comparisons), K1 with the "
          f"collapse asked for = K1 with it off at {small.width}x"
          f"{small.height} and {tcfg.width}x{tcfg.height}, all bitwise")
    del m_dirs

    # 13. the server
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

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "raymarching_tpu"))
    check(not loaded, f"JAX or the JAX package was imported: {loaded}")
    totals = {k: sum(c[k] for _, c in paths.values()) for k in KERNELS}
    check(all(v > 0 for v in totals.values()),
          f"a kernel was never launched on a main path: {totals}")
    per_call = {}
    for kname in KERNELS:
        per_call[kname] = {}
        for path, (calls, c) in paths.items():
            check(c[kname] % calls == 0, f"{path}: {c[kname]} {kname} "
                  f"launches in {calls} calls")
            per_call[kname][path] = c[kname] // calls
    print("[launches] a call of each path's entry point (render or a fit "
          "step; the counts zeroed before the path, read after it): "
          + "; ".join(f"{k} {json.dumps(v)}" for k, v in per_call.items()))
    csrc = "raymarching_tpu_torch/csrc/"

    def row(kname, replaces, ms, plain_ms, bound, analytic=None,
            fused=None):
        # ms: CUDA events around the wrapper's call, as in earlier runs;
        # device_ms: the kernel alone, from the profiler;
        # launches: the sum over the paths' runs (warm-up frames included);
        # launches_per_call: one render or fit step of each path;
        # max_abs_err: over every output of every comparison with the
        # plain twin in this run
        return {"name": kname, "route": "cuda",
                "source": f"{csrc}{kname}.cu", "replaces": replaces,
                "launches": totals[kname],
                "launches_per_call": per_call[kname],
                "max_abs_err": ERRS[kname], "ms": ms,
                "device_ms": dev_ms[kname],
                "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1],
                "bound_ms_leaf_fold": leaf_bounds[kname][0],
                "library_ms": None, "analytic": analytic, "fused": fused}

    def fused_row(ms, plain_ms, bound, turns):
        # the kernel on the fused generator field, analytic normals (K2:
        # its combined mode) on the same rays; exact_device_ms: the exact
        # field's device time in turns with device_ms
        return {"ms": ms, "device_ms": turns[1], "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "exact_device_ms": turns[0]}

    def analytic_row(ms, device, plain_ms, bound, fd_device):
        # the kernel with analytic normals (K2: its analytic mode) on the
        # same rays; fd_device_ms: the FD form's device time in turns
        return {"ms": ms, "device_ms": device, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "fd_device_ms": fd_device}

    for kname, bound in (("render_kernel", k1_bound),
                         ("surface_kernel", k2_bound),
                         ("march_kernel", k3_bound),
                         ("shade_kernel", k4_bound)):
        old = leaf_bounds[kname]
        print(f"[bound] {kname}: {bound[5]} operations ({bound[2]} leaf "
              f"evaluations, the rest collapsed levels) at "
              f"{FP32_OPS_S / 1e12:.0f} TFLOP/s = {bound[3]:.4f} ms; its "
              f"bytes at {HBM_BYTES_S / 1e12:.2f} TB/s = {bound[4]:.4f} ms; "
              f"bound {bound[0]:.4f} ms, by {bound[1]}; with every leaf "
              f"folded {old[5]} operations ({old[2]} leaf evaluations), "
              f"bound {old[0]:.4f} ms, by {old[1]}; {card}")
    print(json.dumps({"kernels": [
        row("render_kernel", "raymarching_tpu/ops/pallas_render.py:211",
            k1_ms, k1_plain_ms, k1_bound, analytic_row(
                k1a_ms, dev_turns["K1 512x512 ssaa2"][1], k1a_plain_ms,
                k1a_bound, dev_turns["K1 512x512 ssaa2"][0]), fused_row(
                k1f_ms, k1f_plain_ms, k1f_bound,
                f_turns["K1 512x512 ssaa2 analytic"])),
        row("surface_kernel", "raymarching_tpu/ops/pallas_march.py:2656",
            k2_ms, k2_plain_ms, k2_bound, analytic_row(
                k2_modes["analytic"][0],
                dev_turns["K2 FD gradient / analytic"][1],
                k2_modes["analytic"][2], k2_modes["analytic"][3],
                dev_turns["K2 FD gradient / analytic"][0]), fused_row(
                f_k2["combined"][0], f_k2["combined"][1],
                f_k2["combined"][2], f_turns["K2 combined"])),
        row("march_kernel", "raymarching_tpu/ops/pallas_march.py:1716",
            k3_ms, k3_plain_ms, k3_bound, fused=fused_row(
                k3f_ms, k3f_plain_ms, k3f_bound, f_turns["K3 primary"])),
        row("shade_kernel", "raymarching_tpu/ops/pallas_render.py:558",
            k4_ms, k4_plain_ms, k4_bound, analytic_row(
                k4a_ms, dev_turns["K4"][1], k4a_plain_ms, k4a_bound,
                dev_turns["K4"][0]), fused_row(
                k4f_ms, k4f_plain_ms, k4f_bound, f_turns["K4 analytic"]))]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
