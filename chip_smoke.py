"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --times    # the kernels' device times alone
    python3 chip_smoke.py --fused-fd-step   # the fused FD fit step alone
    python3 chip_smoke.py --ptxas    # every entry's registers and stack

Phases, one line each, every failure an uncaught exception; a
``[seconds]`` line ends each phase, and one before the kernel table gives
them all with the run's total:
  1. device      — a CUDA device is required; its name and power limit;
  2. build       — nvcc builds the nine sources of csrc/ (K1's reference,
                   extended-shading, raygen and mirror-bounce entries, K2,
                   K3, K4's reference and extended-shading entries, the
                   parameter scatter's segment kernel; ops.build.SOURCES),
                   in parallel in the background while [compare] runs, each of its launches waiting for
                   its own kernel's library (the bounce comparisons' plain
                   twins are taken before their kernel's library is
                   waited for); once all are built, each
                   one's ptxas registers and stack by entry, the
                   procedural, deep and cull views' entries and the
                   far-tap entries apart;
  3. compare     — on demo, config1-4 (64x48 SSAA 2) and menger4 (32x24),
                   100 iterations (each case's share of rays that hit by
                   then and by 1000): K1 (ops.render_kernel
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
                   kernel's resident blocks an SM.  K1's bounce entries
                   against their twins, bitwise over every output of every
                   shade set, on demo, config3, config4, menger4 and
                   scenes/mirror.txt (BOUNCE_CASES: 1-3 bounces, both
                   normals, both fields, extensions off and soft + AO), on
                   1, 31, 1000 and R - 37 rays with per-ray origins, the
                   raygen bounce entry, the scene in device memory = staged.
                   Then the demo image against the port's ref oracle;
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
                   optimizer, the parameter scatter alone (and its segment
                   kernel on the rows of a step in the fit's ray order,
                   the stencil and the colour rows, against index_add_,
                   with the rows it merges an add), and K2's stencil
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
 9d. shading     — the shading extensions at the same footprint: render()
                   of the demo with soft shadows (k 6) and AO (0.8) and of
                   scenes/mirror.txt (coloured lights, reflect 0); K1's
                   and K4's extended entries against their twins, bitwise
                   on every output (light, factors, residuals), FD and
                   analytic, exact and fused, on every 16th ray (the demo
                   soft + AO FD exact on every ray), each scene in device
                   memory against shared; K4 and two-phase against K1; device
                   times against the reference entries in turns; 5 steps
                   of the fused analytic fit with soft shadows and AO (one
                   K1, no K2 a step); card vs CPU gradients, light_color
                   included;
 9e. reflect     — mirror bounces (reflect 0.4) at the same footprint:
                   render() of the demo and mirror.txt with 1 and 2
                   bounces (one K1 bounce launch a frame), the images
                   against backend="multi"; K1's bounce entry against its
                   twin on every 8th ray, its device time in turns with
                   the reference entry, the raygen bounce entry; 3 fit steps
                   with one bounce (the anchored replay backward, no K2),
                   their split and peak memory; card vs CPU gradients;
 9f. dof         — thin-lens depth of field (aperture 0.2, focus 8): the
                   frame (K1 with per-ray origins), then with a bounce,
                   against backend="multi"; card vs CPU gradients;
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
 13. serve       — ``[serve-raygen]``: K1's raygen entry against K1 on the
                   raygen twin's directions and against its twin, bitwise,
                   with the extensions and analytic normals too; the image
                   against the standard path's by the agreement share;
                   then the port's HTTP server: /healthz, /render (raygen,
                   its default), serve_raygen=0, the extensions, two
                   bounces (K1's raygen bounce entry) and a lens with PNGs
                   equal to direct renders, and render() and /render
                   at 256x256 and 512x512 SSAA 2 with raygen on and off in
                   turns, with their launches; ``[aovs]``: POST /aovs at
                   256x256 with a bounce, its ZIP of six planes, the
                   colour plane the beauty frame's PNG;
 14. fractal     — the procedural leaves (scenes/mandelbox.txt,
                   mandelbulb.txt, julia.txt; julia.txt with a Menger
                   sponge for the fused packing): every kernel's procedural
                   view (fold.cuh's Proc<S>, csrc/proc.cuh) against its twin
                   at 32x24 SSAA 1, 50 iterations, bitwise (K1's
                   reference, extended, raygen and bounce entries, FD and
                   analytic; K3; K4; K2's five modes and its stencil
                   entry); render() of each at
                   512x512 SSAA 2, 1000 iterations, FD and analytic, with
                   K1's device time in turns with the demo's through the
                   same entry, its bound (core.sdf.LeafCount with the
                   fractals' operations) and share; julia.txt's two-phase
                   frame (K3, K3, K4) equal to the one kernel's; K3, K4 and K2 on
                   julia.txt's frame against their twins with their
                   bounds; card vs CPU gradients at 32x24; 3 fit steps with
                   each normal, split, with the analytic replay's peak
                   memory, K2's combined mode on each of the replay's
                   slices against its twin; mandelbox.txt's multi-kernel
                   frame, its two K2 modes at its hits against their twins;
 15. deep        — trees deeper than two levels (no two-level form; JAX's
                   generic evaluator, D8): every kernel's deep view
                   (fold.cuh's Deep<S>) against its twin at 32x24 SSAA 1,
                   bitwise in every entry and mode, on the demo behind a
                   deep list (all its leaves folded: no collapse, no cull;
                   with and without the fused flag) and on julia.txt's
                   Julia inside an intersection; the deep demo at 512x512
                   SSAA 2, 1000 iterations: render() FD and analytic with
                   K1's device time in turns with the two-level demo's, K1
                   against its twin, its bound and share; the multi and
                   two-phase frames; K3, K4 and K2's stencil entry (the fit
                   step's shape) against their twins with their bounds;
                   one fit step in each normal; a served frame (raygen);
                   the deep Julia's frame;
 16. cli         — what the CLI and the server reach past one frame: the
                   demo turntable (24 frames at 512x512 SSAA 2, 8 poses a
                   render_frames call, one K1 launch each), each frame of a
                   batch bitwise render_tables at its pose and K1 on every
                   8th ray of the batch bitwise its twin; render_tiled at
                   1024x768 SSAA 3 (6 blocks of 128 rows) bitwise the whole
                   frame, block by block, both peaks of device memory, and
                   a 4096x4096 SSAA 3 tiled frame with its peak; the demo's
                   mesh at --mesh-res 128: K2's SD mode on 2,097,152 points
                   bitwise its twin, its times and bound (a JSON row of its
                   own), 8 launches a grid, marching tetrahedra apart;
                   POST /animate as a GIF in process and the encoder alone;
                   --selfcheck through the CLI; chains of 17 and 40 nested
                   lists (the DeepSpill view) and the demo with 300 AO taps
                   (the far-tap entries), every entry bitwise its twin;
 17. oracle      — the port's plain gradient oracles on the demo at 64x48
                   SSAA 1, 200 iterations: render_tables(backend="ref",
                   differentiable=True) (the unrolled march) and
                   backend="torch" (the plain implicit-function march)
                   give the forward ref image bitwise; ref's gradients
                   against the cuda backend's and torch's against ref's at
                   tests/test_grad.py:55's tolerance; the card's ref
                   gradients against the CPU's on the same rays;
 18. shard       — the demo at 512x512 SSAA 2, 1000 iterations, backend
                   cuda, its rows split over a torch.distributed process
                   group (parallel.sharded): world 1 over NCCL in this
                   process, then world 2 over gloo in two processes on the
                   one card (spawned after the build, loading its
                   libraries): the gathered bands bitwise the
                   single-process frame, the steps' gradients against one
                   process's (bitwise at world 1), train_step, three
                   fit(mesh=) Adam steps (the ranks' tables bitwise equal;
                   at world 1 fit()'s), render_tiled_multihost at 1024x768
                   SSAA 3 and render_rays_sharded on an odd bundle of three
                   posed views bitwise their single-process forms; one K1
                   a frame and one K1 and one K2 a step on every rank;
                   per-rank frame and step times and the all-reduce's;
 19. cull        — the culls of the four kernels' folds (pallas_march's
                   D5, the wide-UNION chunk cull, and D4, the deep-sponge
                   walks; fold.cuh's Cull<S>): every kernel's Cull view
                   against both plain twins, the culled fold and the
                   unculled one, bitwise, at SSAA 1, 200 iterations, on
                   scatter1k.txt
                   (32x24; also its extended and bounce forms, and the
                   fused one at 24x18),
                   menger4.txt (16x12; the value-bound winner walk) and an
                   iters-5 sponge (12x9; the margin walk); scatter1k and
                   menger4 at 512x512 SSAA 2, 1000 iterations: render()
                   and a fit step in each normal, the multi and two-phase
                   frames, the device times of K1, K3, K4 and K2's stencil
                   entry, each held to the culled twin on every 8th ray
                   and to the unculled one on every 16th, with
                   the culled twin's bound and skip shares; block ray
                   order: the demo's standard and served frames in block
                   and scan order in turns, bitwise equal, K3's lane
                   efficiency in each order (also at 1024x768 SSAA 3),
                   K1's raygen block arm against its twin;
 20. native      — the native host runtime (raymarching_tpu_torch.native):
                   g++ builds native/raymarch_host.cpp into a temporary
                   directory, loaded for this phase only;
                   its parse of demo, menger4, julia and mirror.txt against
                   the port's compile_scene; a 512x384 demo frame through
                   its PNG writer and io.png, decoded to the same pixels;
 21. examples    — raymarching_tpu_torch.examples' four scripts through
                   their main at their own defaults (fit_scene, both
                   fit_multiview modes, fit_fractal, the 24-frame
                   turntable): loss reductions, parameter errors, both
                   fit_multiview asserts, steady ms a turntable frame, each
                   run's launches against the expected count; K1 on one
                   step's rays of each fit (and a turntable frame) against
                   its twin on every 8th ray, as the step launches it.
The [fractal] and [deep] 512x512 frames' twins run on every TWIN_STRIDE-th
(32nd) ray.  Then each kernel's launches in one call of each path, and the
kernel table as JSON (each kernel's largest difference from its plain twin
over every output of every comparison above, its time beside its plain
twin's and its bound: the larger of its bytes over 3.35 TB/s and its
operations on this run's data, 12 for each leaf evaluation the fold's cull
keeps and the collapsed carve's as core.sdf.LeafCount states them, over 67
TFLOP/s, the H100's published float32 rate) and, last, the device line.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

T_START = time.perf_counter()
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
# mirror bounces and the lens, fused against multi: JAX's pallas-vs-mega
# image tolerance (tests/test_reflections.py:79), on a share AGREE of the
# pixels (an ulp in a normal may turn a grazing bounce)
REFLECT_ATOL = 2e-3
# the scene kernels, one CUDA source and library each: K1's reference,
# extended-shading, raygen and mirror-bounce entries, K2, K3, K4's
# reference and extended-shading entries
KERNELS = ("render_kernel", "render_ext_kernel", "render_raygen_kernel",
           "render_bounce_kernel", "surface_kernel", "march_kernel",
           "shade_kernel", "shade_ext_kernel")
# every source: the scene kernels and the parameter scatter's segmented
# sum (its launches stay out of the scene kernels' counts; [train]
# reports it)
SOURCES = KERNELS + ("segment_kernel",)
# ptxas's registers and stack frame by entry of the sources the mirror-bounce
# entries were added beside (the seven-source tree's build, NVIDIA H100
# 80GB HBM3 machine, nvcc of CUDA 12): [build] says whether they held
_K1 = ("{0}<{1}FD, device> 72 / 64 B; {0}<{1}analytic, device> 48 / {2} B; "
       "{0}<{1}FD, shared> 48 / 160 B; {0}<{1}analytic, shared> 48 / 96 B; "
       "{0}<{1}fused, FD, device> 72 / 64 B; {0}<{1}fused, analytic, device> "
       "48 / {3} B; {0}<{1}fused, FD, shared> 64 / 32 B; {0}<{1}fused, "
       "analytic, shared> 48 / 88 B")
SEVEN_SOURCE_PTXAS = {
    "render_kernel": _K1.format("render_kernel", "", 160, 144),
    "render_ext_kernel": (
        "render_kernel<extended, FD, device> 72 / 64 B; render_kernel<"
        "extended, analytic, device> 48 / 176 B; render_kernel<extended, FD, "
        "shared> 72 / 16 B; render_kernel<extended, analytic, shared> 48 / "
        "120 B; render_kernel<extended, fused, FD, device> 80 / 24 B; "
        "render_kernel<extended, fused, analytic, device> 48 / 168 B; "
        "render_kernel<extended, fused, FD, shared> 64 / 56 B; render_kernel<"
        "extended, fused, analytic, shared> 48 / 120 B"),
    "render_raygen_kernel": (
        "render_kernel<raygen, FD, device> 72 / 64 B; render_kernel<raygen,"
        " analytic, device> 48 / 160 B; render_kernel<raygen, extended, FD,"
        " device> 72 / 56 B; render_kernel<raygen, extended, analytic, "
        "device> 48 / 168 B; render_kernel<raygen, FD, shared> 48 / 160 B; "
        "render_kernel<raygen, analytic, shared> 48 / 96 B; "
        "render_kernel<raygen, extended, FD, shared> 72 / 8 B; "
        "render_kernel<raygen, extended, analytic, shared> 48 / 112 B; "
        "render_kernel<raygen, fused, FD, device> 72 / 64 B; "
        "render_kernel<raygen, fused, analytic, device> 48 / 152 B; "
        "render_kernel<raygen, extended, fused, FD, device> 72 / 56 B; "
        "render_kernel<raygen, extended, fused, analytic, device> 48 / 160 "
        "B; render_kernel<raygen, fused, FD, shared> 64 / 32 B; "
        "render_kernel<raygen, fused, analytic, shared> 48 / 88 B; "
        "render_kernel<raygen, extended, fused, FD, shared> 64 / 64 B; "
        "render_kernel<raygen, extended, fused, analytic, shared> 48 / 112 "
        "B"),
    "surface_kernel": (
        "surface_kernel<mode 4, device> 56 / 16 B; surface_kernel<mode 4, "
        "shared> 56 / 0 B; surface_kernel<fused, mode 4, device> 56 / 16 B;"
        " surface_kernel<fused, mode 4, shared> 56 / 0 B; "
        "surface_kernel<mode 3, device> 64 / 24 B; surface_kernel<mode 3, "
        "shared> 80 / 0 B; surface_kernel<fused, mode 3, device> 64 / 32 B;"
        " surface_kernel<fused, mode 3, shared> 72 / 8 B; "
        "surface_kernel<mode 2, device> 40 / 0 B; surface_kernel<mode 2, "
        "shared> 48 / 0 B; surface_kernel<fused, mode 2, device> 40 / 0 B; "
        "surface_kernel<fused, mode 2, shared> 54 / 0 B; "
        "surface_kernel<mode 1, device> 48 / 0 B; surface_kernel<mode 1, "
        "shared> 56 / 0 B; surface_kernel<fused, mode 1, device> 48 / 8 B; "
        "surface_kernel<fused, mode 1, shared> 48 / 0 B; "
        "surface_kernel<mode 0, device> 56 / 8 B; surface_kernel<mode 0, "
        "shared> 64 / 0 B; surface_kernel<fused, mode 0, device> 56 / 16 B;"
        " surface_kernel<fused, mode 0, shared> 48 / 32 B; "
        "surface_kernel<mode 0, stencil, device> 64 / 24 B; "
        "surface_kernel<mode 0, stencil, shared> 72 / 0 B"),
    "march_kernel": (
        "march_kernel<device> 48 / 40 B; march_kernel<shared> 64 / 0 B; "
        "march_kernel<fused, device> 48 / 48 B; march_kernel<fused, shared> "
        "48 / 32 B"),
    "shade_kernel": (
        "shade_kernel<FD, device> 72 / 80 B; shade_kernel<analytic, device> "
        "48 / 128 B; shade_kernel<FD, shared> 48 / 160 B; shade_kernel<"
        "analytic, shared> 48 / 88 B; shade_kernel<fused, FD, device> 72 / "
        "80 B; shade_kernel<fused, analytic, device> 48 / 128 B; "
        "shade_kernel<fused, FD, shared> 64 / 32 B; shade_kernel<fused, "
        "analytic, shared> 48 / 88 B"),
    "shade_ext_kernel": (
        "shade_kernel<extended, FD, device> 72 / 64 B; shade_kernel<extended, "
        "analytic, device> 48 / 176 B; shade_kernel<extended, FD, shared> "
        "72 / 16 B; shade_kernel<extended, analytic, shared> 48 / 112 B; "
        "shade_kernel<extended, fused, FD, device> 72 / 64 B; shade_kernel<"
        "extended, fused, analytic, device> 48 / 200 B; shade_kernel<"
        "extended, fused, FD, shared> 72 / 8 B; shade_kernel<extended, fused, "
        "analytic, shared> 48 / 112 B"),
}
# the largest |kernel - plain twin| over every output of every comparison
# of this run, per kernel (``compare`` and ``same`` fill it)
ERRS = dict.fromkeys(KERNELS, 0.0)
# the H100's published peaks (SXM data sheet): device memory bytes/s and
# float32 operations/s outside the tensor cores (core.sdf.LeafCount counts
# the fold's operations)
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12
# the 1024x768 SSAA 3 frame's plain twin runs on one ray in BIG_STRIDE
BIG_STRIDE = 8
# the [fractal] and [deep] 512x512 frames' plain twins, whose fractal DEs
# and unculled deep folds take seconds a launch, on one ray in TWIN_STRIDE
TWIN_STRIDE = 32
# [shading]'s eight scene x normal x field forms against their twins on one
# ray in SHADE_STRIDE (the rows' configuration on every ray)
SHADE_STRIDE = 16
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


# each phase's seconds in this run, in the order run (``phase`` fills it)
PHASE_S = {}
_RUNNING = []


def phase(name=None) -> None:
    """End the running phase, printing its seconds, and start ``name``."""
    now = time.perf_counter()
    if _RUNNING:
        done, t0 = _RUNNING.pop()
        PHASE_S[done] = PHASE_S.get(done, 0.0) + now - t0
        print(f"[seconds] {done} {now - t0:.1f} s")
    if name is not None:
        _RUNNING.append((name, now))


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
    hands back fewer kernel records than launches, or none; such a window
    is taken again, and the fifth is read as it is.  With no record in
    five windows the calls are timed by CUDA events instead, the wrapper's
    host work included, and the line says so; the wrappers' launch counts
    must still move."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
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
    if not times:
        family = needle.split("_")[0]     # every source of the kernel

        def launched():
            return sum(v for k, v in launch_counts().items()
                       if k.startswith(family))
        before = launched()
        _, ms = timed(fn, runs)
        check(launched() > before, f"no {needle} launch in {runs} calls")
        print(f"[profiler] no {needle} record in 5 windows: {ms:.3f} ms by "
              f"CUDA events, the wrapper's host work included")
        return ms
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


def build_report(built) -> None:
    """The [build] and [ptxas] lines of the background build, once
    ``built`` (build.build_all's result) is in: each library's seconds and
    ptxas report, the views' entries apart, and the seven-source build's
    registers held to the recorded table."""
    from raymarching_tpu_torch.ops import build

    for kname, (lib_path, secs) in zip(SOURCES, built):
        build.load_library(kname)
        log = lib_path.with_suffix(".log").read_text()
        print(f"[build] {lib_path.name} in {secs:.1f} s; "
              + ptxas_summary(log))
        entries = ptxas_entries(log)
        check(bool(entries), f"no kernel entry in {kname}'s ptxas report")
        # the procedural views' entries (Proc<S>), the deep views' (Deep<S>,
        # DeepSpill<S>) and the extended entries for more than 256 AO taps
        # apart: the others are held to the build before they existed
        report = "; ".join(f"{e} {r} / {st} B" for e, r, st in entries
                           if not any(v in e for v in ("procedural", "deep",
                                                       "far taps", "cull")))
        print(f"[ptxas] {kname} by entry (registers, stack frame): "
              + report)
        for view in ("procedural", "deep", "far taps", "cull"):
            print(f"[ptxas] {kname} {view} entries: " + "; ".join(
                f"{e} {r} / {st} B" for e, r, st in entries if view in e))
        if kname in SEVEN_SOURCE_PTXAS:
            # entry for entry, in any order (new instantiations reorder the
            # report)
            same_ = (sorted(report.split("; "))
                     == sorted(SEVEN_SOURCE_PTXAS[kname].split("; ")))
            print(f"[ptxas] {kname}: the seven-source build's registers "
                  f"and stack, entry for entry: "
                  f"{'the same' if same_ else 'CHANGED'}")
    print(f"[build] {len(SOURCES)} sources in "
          f"{max(secs for _, secs in built):.2f} s (all started together), "
          f"[compare] running meanwhile from its first launch of each "
          f"kernel")


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
    m = re.search(r"((?:render|surface|march|shade)_kernel)(_raygen)?(_ext)?"
                  r"(_bounce)?(_analytic)?I(.*)", name)
    if not m:
        return name
    kern, raygen, ext, bounce, analytic, rest = m.groups()
    ints = re.findall(r"Li(\d+)E", rest)
    parts = ["raygen"] if raygen else []
    parts += ["extended"] if ext else []
    parts += ["bounce"] if bounce else []
    parts += ["fused"] if "Fused" in rest else []
    parts += ["procedural"] if "Proc" in rest else []
    parts += ["deep"] if "Deep" in rest else []
    parts += ["spill"] if "DeepSpill" in rest else []
    parts += ["far taps"] if "Far" in rest else []
    parts += ["cull"] if "Cull" in rest else []
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


def flat(out):
    """A render's outputs and extras (Winner, Factors, a tuple of
    BounceOutputs) as one tuple of tensors and Nones."""
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return tuple(v for part in out for v in flat(part))
    return tuple(out)


def rows_of(vals, idx):
    """Rays ``idx`` (a slice or index tensor) of each of ``flat``'s
    outputs: [L, R] factors by column, everything else by row."""
    n = vals[0].shape[0]
    return tuple(None if v is None else
                 v[:, idx] if v.dim() == 2 and v.shape[1] == n
                 and v.shape[0] != n else v[idx] for v in vals)


# K1's bounce entries in [compare]: (bounces, normal, fused field,
# extensions) on every scene, every pair of the four settings covered
BOUNCE_CASES = ((1, "fd", False, False), (1, "analytic", True, True),
                (2, "fd", True, True), (2, "analytic", False, False),
                (3, "fd", False, True), (3, "analytic", True, False))


def bounce_cases(plan, cfg):
    """(B, config, tag) of each of BOUNCE_CASES on ``plan``: the fused
    field only where the scene has generators."""
    fused_ok = any(g_.fused is not None for g_ in plan.kernel.groups)
    out = []
    for B, normal, fz, ext in BOUNCE_CASES:
        c = cfg.replace(reflect_strength=0.4, reflect_bounces=B,
                        normal_mode=normal, fused_generators=fz and fused_ok,
                        **(dict(soft_shadow_k=6.0, ao_strength=0.8) if ext
                           else {}))
        out.append((B, c, f"B {B} {normal} "
                    f"{'fused' if c.fused_generators else 'exact'}"
                    f"{' soft + AO' if ext else ''}"))
    return out


def bounce_twins(plan, cfg, tables, origin, dirs):
    """The plain twins' outputs that compare_bounce holds K1's bounce
    entries to: one a case of bounce_cases, then the raygen bounce twin's.
    They launch no kernel, so [compare] takes them while the bounce
    entries' source is still building."""
    from raymarching_tpu_torch.ops.render_kernel import (render_raygen_plain,
                                                         render_rays_plain)
    twins = [flat(render_rays_plain(plan, c, tables, origin, dirs,
                                    save_factors=True))
             for _, c, _ in bounce_cases(plan, cfg)]
    rc = cfg.replace(reflect_strength=0.4, reflect_bounces=2,
                     soft_shadow_k=6.0, ao_strength=0.8)
    twins.append(flat(render_raygen_plain(plan, rc, tables, 0,
                                          dirs.shape[0], save_factors=True)))
    return twins


def compare_bounce(plan, cfg, tables, origin, dirs, twins):
    """K1's bounce entries (csrc/render_bounce_kernel.cu) against their
    plain twins (``twins``, bounce_twins' outputs), bitwise
    over every output of every shade set (the primary hit's and each
    bounce's colour winner, light, shadow bits, penumbra and AO factors,
    hit point, SD and convergence): BOUNCE_CASES (the fused field where
    the scene has generators; the extensions soft shadows k 6 and AO 0.8,
    coloured lights where the scene has them); the first n rays with
    per-ray origins for n that is 1, below a warp and no multiple of a
    warp or a tile, against the full launch; the raygen bounce entry
    against its twin and against the bounce entry on the twin's
    directions.  Returns the number of comparisons."""
    from raymarching_tpu_torch.core import camera as cam
    from raymarching_tpu_torch.ops.render_kernel import (render_raygen,
                                                         render_rays)
    n_cmp = 0
    R = dirs.shape[0]
    for (B, c, tag), twin in zip(bounce_cases(plan, cfg), twins):
        k = flat(render_rays(plan, c, tables, origin, dirs,
                             save_factors=True))
        same(f"K1 bounce {tag}", k, twin, "render_bounce_kernel")
        n_cmp += 1
        if B == 2:
            for n in (n_ for n_ in (1, 31, 1000, R - 37) if 0 < n_ <= R):
                org = origin.expand(R, 3)[:n].contiguous()
                same(f"K1 bounce {tag} on {n} rays with per-ray origins",
                     flat(render_rays(plan, c, tables, org, dirs[:n],
                                      save_factors=True)),
                     rows_of(k, slice(0, n)))
                n_cmp += 1
    rc = cfg.replace(reflect_strength=0.4, reflect_bounces=2,
                     soft_shadow_k=6.0, ao_strength=0.8)
    rg = flat(render_raygen(plan, rc, tables, 0, R, save_factors=True))
    same("K1 raygen bounce entry against its twin", rg, twins[-1],
         "render_bounce_kernel")
    rg_dirs = cam.raygen_dirs(cam.serve_cam_rows(tables, rc), rc, 0, R)
    same("K1 raygen bounce entry against the bounce entry on the twin's "
         "directions", rg, flat(render_rays(
             plan, rc, tables, tables.cam_position, rg_dirs,
             save_factors=True)))
    torch.cuda.synchronize()
    return n_cmp + 2


def timed_counted(plain_fn):
    """(result, ms, count) of one call of a plain twin under
    core.sdf.LeafCount, which counts the work the kernels' fold does on
    the same points (it applies the fold's cull rule per point)."""
    from raymarching_tpu_torch.core.sdf import LeafCount
    with LeafCount() as count:
        out, ms = timed(plain_fn)
    return out, ms, count


def bound_ms(count, n_bytes: int, stride: int = 1):
    """The least time the card could take for the work of one kernel
    launch: (ms, "bytes" or "operations", leaf evaluations, the
    operations' ms, the bytes' ms, the operations), from a plain twin's
    ``count`` of the operations on this run's data (on every ``stride``-th
    ray of the launch, times ``stride``) and the bytes the kernel must
    move."""
    ops = count.ops * stride
    t_ops = ops / FP32_OPS_S
    t_bytes = n_bytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            count.leaves * stride, t_ops * 1e3, t_bytes * 1e3, ops)


def launch_counts():
    """Each source's launches since zero_counts (the wrappers' counts)."""
    from raymarching_tpu_torch.ops.march_kernel import march_rays
    from raymarching_tpu_torch.ops.render_kernel import (render_raygen,
                                                         render_rays)
    from raymarching_tpu_torch.ops.shade_kernel import shade_rays
    from raymarching_tpu_torch.ops.surface_kernel import surface_eval
    counts = {**render_rays.entry_launches,
              "render_raygen_kernel":
                  render_raygen.entry_launches["render_raygen_kernel"]}
    counts["render_bounce_kernel"] += render_raygen.entry_launches[
        "render_bounce_kernel"]
    return {**counts, "surface_kernel": surface_eval.launches,
            "march_kernel": march_rays.launches,
            **shade_rays.entry_launches}


def only(**counts) -> dict:
    """A launch_counts dict with these counts and 0 for every other
    source."""
    return {k: counts.get(k, 0) for k in KERNELS}


def zero_counts():
    from raymarching_tpu_torch.ops.march_kernel import march_rays
    from raymarching_tpu_torch.ops.render_kernel import (render_raygen,
                                                         render_rays)
    from raymarching_tpu_torch.ops.shade_kernel import shade_rays
    from raymarching_tpu_torch.ops.surface_kernel import surface_eval
    for fn in (render_rays, render_raygen, surface_eval, march_rays,
               shade_rays):
        fn.launches = 0
    for fn in (render_rays, render_raygen, shade_rays):
        fn.entry_launches = dict.fromkeys(fn.entry_launches, 0)


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


def grad_check(fields, got, want, what: str, rtol: float = GRAD_RTOL,
               atol_scale: float = GRAD_ATOL_SCALE):
    """Hold gradients ``got`` to ``want`` field by field at tests/test_mega
    .py:62's tolerance (or ``rtol`` and ``atol_scale`` x the field's
    largest |want|); returns (worst |diff| / field scale, its field)."""
    worst = (0.0, "")
    for field, a, b in zip(fields, got, want):
        check(bool(torch.isfinite(a).all()), f"{field} gradient not finite")
        scale = max(b.abs().max().item(), 1e-8)
        excess = ((a - b).abs() - rtol * b.abs()
                  - atol_scale * scale).max().item()
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


def hit_shares(plan, cfg, tables, origin, dirs) -> str:
    """The shares of rays that hit a surface within ``cfg``'s iterations
    and within the main path's 1000, by K3's primary march: a ray that
    misses marches to the cap, so the first share says how many rays
    reach the shading, shadow and winner branches at this cap."""
    from raymarching_tpu_torch.ops import march_kernel as mk
    shares = [mk.march_rays(plan, cfg.replace(iterations=its), tables,
                            origin, dirs)[2].double().mean().item()
              for its in (cfg.iterations, 1000)]
    return (f"hit by {cfg.iterations} iterations {shares[0]:.4f} of rays, "
            f"by 1000 {shares[1]:.4f}")


def rays_for(plan, tables, cfg):
    from raymarching_tpu_torch.core import camera as cam
    origin, dirs = cam.generate_rays(tables, cfg)
    return origin, dirs.reshape(-1, 3)


def segment_report(plan, tables, cfg, dev, card: str) -> None:
    """[train]'s segment kernel lines: the parameter scatter alone on the
    rows of a fit step, its rays in the fit's block order
    (api._render_rows): the stencil rows (the theta entry, 7 columns) and
    the colour rows (the generic entry, 3), each against index_add_ (the
    plain twin, CUDA events around it) on the same rows, float64 sums
    within 1e-12 of their terms' magnitudes; the rows a warp merges into
    an add (scene_vjp.merge_factor); the bound, the bytes a row must be
    read (id, g, u: 20; id and a colour cotangent: 16) at HBM_BYTES_S."""
    from raymarching_tpu_torch.core.order import frame_blocks, to_blocked
    from raymarching_tpu_torch.ops import scene_vjp
    from raymarching_tpu_torch.ops import segment_kernel as seg
    from raymarching_tpu_torch.ops.render_kernel import render_rays
    H, W, S = cfg.height, cfg.width, cfg.samples_per_pixel
    origin, dirs = rays_for(plan, tables, cfg)
    dirs = to_blocked(dirs, H, W, S, *frame_blocks(cfg, H, "cuda"))
    hit = render_rays(plan, cfg.replace(shade_skip_black=False), tables,
                      origin, dirs)
    _, widx, g = scene_vjp.stencil_eval(plan, cfg, tables, hit.p,
                                        center=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    u = torch.randn(widx.shape, generator=gen, device=dev)
    cbar = torch.randn((hit.cidx.shape[0], 3), generator=gen, device=dev)
    P = tables.prim_pos.shape[0]
    cases = {
        "stencil": (widx, 20, lambda: seg.theta_sum(widx, g, u, P),
                    lambda: seg.theta_sum_plain(widx, g, u, P),
                    lambda: seg.theta_terms(g.reshape(-1, 3), u.reshape(-1))),
        "colour": (hit.cidx, 16, lambda: seg.segment_sum(hit.cidx, cbar, P),
                   lambda: seg.segment_sum_plain(hit.cidx, cbar, P),
                   lambda: cbar)}
    total = 0.0
    for what, (ids, row_bytes, kernel, plain, terms) in cases.items():
        want, plain_ms = timed(plain, runs=3)
        got, ms = timed(kernel, runs=5)
        scale = seg.segment_sum_plain(ids.reshape(-1), terms().abs(), P)
        err = float(((got - want).abs() / scale.clamp_min(1e-300)).max())
        check(err <= 1e-12, f"segment kernel, {what} rows: a float64 sum "
              f"{err:.3g} of its terms' magnitudes off index_add_'s")
        dev_t = device_ms(kernel, "segment_sum")
        bound = ids.numel() * row_bytes / HBM_BYTES_S * 1e3
        total += bound
        C = got.shape[1]
        print(f"[train] segment kernel on the fit's {what} rows "
              f"({ids.numel()} rows x {C} columns onto {P} leaf rows, "
              f"{scene_vjp.merge_factor(ids):.2f} rows an add): {ms:.3f} ms "
              f"with its wrapper, {dev_t:.4f} ms on the device alone, "
              f"index_add_ {plain_ms:.2f} ms; bound {bound:.4f} ms by bytes "
              f"({row_bytes} B a row), share {100 * bound / dev_t:.1f}%; "
              f"float64 sums within {err:.2g} of their terms' magnitudes of "
              f"index_add_'s; {card}")
    print(f"[train] segment kernel bound a fit step, both scatters: "
          f"{total:.4f} ms; {card}")


def has_demo_objects(img: torch.Tensor) -> bool:
    """Red sphere, blue DeathStar, green sphere and black background."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return bool(((r > 0.2) & (g < 0.05) & (b < 0.05)).any()
                and ((b > 0.2) & (r < 0.05) & (g < 0.05)).any()
                and ((g > 0.2) & (r < 0.05) & (b < 0.05)).any()
                and (img.amax(dim=-1) == 0).any())


# the fractal scenes of the [fractal] phase (procedural leaves), and the
# Julia scene with a Menger sponge beside it (the fused packing with
# procedural runs)
FRACTALS = ("mandelbox", "mandelbulb", "julia")
FRACTAL_SPONGE = "julia + sponge"


def fractal_scene(name: str):
    """A [fractal] scene: scenes/<name>.txt, or FRACTAL_SPONGE."""
    from raymarching_tpu_torch.scene.parser import parse_scene
    text = (ROOT / "scenes" / f"{'julia' if name == FRACTAL_SPONGE else name}"
            ".txt").read_text()
    if name == FRACTAL_SPONGE:
        text += "\nColor 0.8 0.8 0.8\nMengerSponge 2.2 -0.8 -6.5 1.6 2\n"
    return parse_scene(text)


def view_compare(plan, tables, cfg, fused: bool, ext: bool,
                 what: str = "fractal", taps: int | None = None,
                 normals=("fd", "analytic")) -> int:
    """Every kernel's view of ``plan`` (the procedural one, or a deep
    plan's) against its plain twin on the rays
    of ``cfg``, bitwise on every output, FD and analytic normals: K1's
    reference entry (the analytic one with its residuals), K3 with steps,
    K4, K2's five modes at K1's hits and its stencil entry (exact packing),
    K1's raygen entry; with ``ext`` K1's and K4's extended entries (soft
    shadows k 6, AO 0.8), K1's bounce entry (one bounce, with them) and
    its raygen form; ``taps`` AO taps there when given; ``normals`` the
    normals to take.  Returns the number of comparisons."""
    from raymarching_tpu_torch.ops import march_kernel as mk
    from raymarching_tpu_torch.ops import scene_vjp
    from raymarching_tpu_torch.ops import shade_kernel as shk
    from raymarching_tpu_torch.ops import surface_kernel as sk
    from raymarching_tpu_torch.ops.render_kernel import (
        render_raygen, render_raygen_plain, render_rays, render_rays_plain)
    n = 0
    for normal in normals:
        c = cfg.replace(normal_mode=normal, fused_generators=fused)
        origin, dirs = rays_for(plan, tables, c)
        sw = normal == "analytic"
        k1 = render_rays(plan, c, tables, origin, dirs, save_winner=sw)
        same(f"{what} K1 {normal}", flat(k1), flat(render_rays_plain(
            plan, c, tables, origin, dirs, save_winner=sw)), "render_kernel")
        ray = k1[0] if sw else k1
        check(bool(ray.done.any()) and bool((ray.cidx >= 0).any()),
              f"{what}: no hit")
        res, steps = mk.march_rays(plan, c, tables, origin, dirs,
                                   with_steps=True)
        res_p, steps_p = mk.march_rays_plain(plan, c, tables, origin, dirs,
                                             with_steps=True)
        same(f"{what} K3 {normal}", (*res, steps), (*res_p, steps_p),
             "march_kernel")
        k4 = shk.shade_rays(plan, c, tables, ray.p, ray.sd, dirs,
                            save_winner=sw)
        same(f"{what} K4 {normal}", flat(k4), flat(shk.shade_rays_plain(
            plan, c, tables, ray.p, ray.sd, dirs, save_winner=sw)),
            "shade_kernel")
        same(f"{what} K4 {normal} vs K1", flat(k4), flat(k1)[3:])
        R = dirs.shape[0]
        same(f"{what} K1 raygen {normal}", flat(render_raygen(
            plan, c, tables, 0, R, save_winner=sw)), flat(
                render_raygen_plain(plan, c, tables, 0, R, save_winner=sw)),
            "render_raygen_kernel")
        n += 5
        if normal == "fd":
            for mode in sk.MODES:
                same(f"{what} K2 mode {mode}", sk.surface_eval(
                    plan, tables, ray.p, mode=mode, fd_h=c.fd_h,
                    fused=fused), sk.surface_eval_plain(
                        plan, tables, ray.p, mode=mode, fd_h=c.fd_h,
                        fused=fused), "surface_kernel")
                n += 1
            if not fused:
                for center in (True, False):
                    same(f"{what} K2 stencil entry", scene_vjp.stencil_eval(
                        plan, c, tables, ray.p, center=center),
                        sk.surface_stencil_plain(plan, tables, ray.p,
                                                 c.fd_h, center=center),
                        "surface_kernel")
                    n += 1
        if not ext:
            continue
        # the extended entries, and the bounce entries with the extensions
        soft = c.replace(soft_shadow_k=6.0, ao_strength=0.8)
        if taps is not None:
            soft = soft.replace(ao_samples=taps)
        ke = render_rays(plan, soft, tables, origin, dirs, save_winner=sw,
                         save_factors=True)
        same(f"{what} K1 extended {normal}", flat(ke), flat(
            render_rays_plain(plan, soft, tables, origin, dirs,
                              save_winner=sw, save_factors=True)),
            "render_ext_kernel")
        same(f"{what} K4 extended {normal}", flat(shk.shade_rays(
            plan, soft, tables, ke[0].p, ke[0].sd, dirs, save_winner=sw,
            save_factors=True)), flat(shk.shade_rays_plain(
                plan, soft, tables, ke[0].p, ke[0].sd, dirs,
                save_winner=sw, save_factors=True)), "shade_ext_kernel")
        n += 2
        for b in (soft,):
            b = b.replace(reflect_strength=0.4, reflect_bounces=1)
            same(f"{what} K1 bounce {normal}", flat(render_rays(
                plan, b, tables, origin, dirs, save_factors=True)),
                flat(render_rays_plain(plan, b, tables, origin, dirs,
                                       save_factors=True)),
                "render_bounce_kernel")
            same(f"{what} K1 raygen bounce {normal}", flat(render_raygen(
                plan, b, tables, 0, R, save_factors=True)), flat(
                    render_raygen_plain(plan, b, tables, 0, R,
                                        save_factors=True)),
                "render_bounce_kernel")
            n += 2
    torch.cuda.synchronize()
    return n


def fractal_phase(dev, card: str, add_counts, demo_plan, demo_tt) -> dict:
    """[fractal]: the procedural leaves (scenes/mandelbox.txt,
    mandelbulb.txt, julia.txt) on every path.  Every kernel's procedural
    view against its twin at 32x24 SSAA 1; render() at 512x512 SSAA 2,
    1000 iterations, FD and analytic normals, with K1's device time in
    turns with the demo's through the same entry, its bound and share;
    K3, K4 and K2 on julia.txt's frame against their twins with their
    bounds; card vs CPU gradients; 3 fit steps with each normal, their
    split and the analytic replay's peak memory; the multi-kernel frame on
    mandelbox.txt.  Returns each of the four kernels' procedural row of
    the JSON table."""
    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch.ops import march_kernel as mk
    from raymarching_tpu_torch.ops import scene_vjp
    from raymarching_tpu_torch.ops import shade_kernel as shk
    from raymarching_tpu_torch.ops import surface_kernel as sk
    from raymarching_tpu_torch.ops.render_kernel import (render_rays,
                                                         render_rays_plain)
    from raymarching_tpu_torch.tables import scene_operands, tables_to_torch

    t_phase = time.perf_counter()
    launches = dict.fromkeys(KERNELS, 0)

    def counted(path: str, calls: int) -> dict:
        counts = add_counts(path, calls)
        for k in KERNELS:
            launches[k] += counts[k]
        return counts

    # 1. the kernels against their twins, small (the twins' marches take a
    # few hundred launches a step: 50 iterations keep this part short, and
    # still end 185-1213 rays a scene on its fractal)
    small = rt.RenderConfig(width=32, height=24, ssaa=1, iterations=50)
    n_cmp = 0
    for name in FRACTALS + (FRACTAL_SPONGE,):
        plan, tables = rt.compile_scene(fractal_scene(name))
        check(bool(plan.proc), f"{name}: no procedural leaf")
        tt = tables_to_torch(tables, dev)
        fused = name == FRACTAL_SPONGE
        ops_ = scene_operands(plan, tt, dev, True, fused)
        check(ops_.proc == 1, f"{name}: not the procedural view")
        n_cmp += view_compare(plan, tt, small, fused, ext=name == "julia")
    print(f"[fractal] compare {time.perf_counter() - t_phase:.1f} s")
    errs = {k: ERRS[k] for k in KERNELS}
    print(f"[fractal] every kernel's procedural view = its plain twin "
          f"bitwise ({n_cmp} comparisons at {small.width}x{small.height} "
          f"ssaa{small.ssaa} {small.iterations} it on "
          f"{', '.join(FRACTALS + (FRACTAL_SPONGE,))} (exact, the last "
          f"fused): K1's reference and raygen entries, FD and analytic; K3; "
          f"K4 FD and analytic; K2's five modes and its stencil entry; on "
          f"julia.txt K1's and K4's extended and K1's bounce entries with "
          f"soft shadows and AO); largest difference over this run so far "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (logf and torch.log round alike on the card)")

    # 2. frames at full width, K1 in turns with the demo, bounds
    fcfg = rt.RenderConfig(width=512, height=512, ssaa=2, iterations=1000)
    R = fcfg.rays_per_image
    rows = {}
    frame_rows = []
    for name in FRACTALS:
        scene = fractal_scene(name)
        plan, tables = rt.compile_scene(scene)
        tt = tables_to_torch(tables, dev)
        for normal in ("fd", "analytic"):
            c = fcfg.replace(normal_mode=normal)
            zero_counts()
            rt.render(scene, c, device=dev)       # warm-up at this shape
            img, ms = timed(lambda: rt.render(scene, c, device=dev), runs=3)
            counts = counted(f"fractal_{name}_{normal}", 4)
            check(counts == only(render_kernel=4),
                  f"{name} {normal} render() launched {counts}")
            check(img.shape == (c.height, c.width, 3)
                  and bool(torch.isfinite(img).all())
                  and img.max().item() > 0, f"{name} image")
            origin, dirs = rays_for(plan, tt, c)
            d_org, d_dirs = rays_for(demo_plan, demo_tt, c)
            turns = {"demo": [], name: []}
            for who in ("demo", name, name, "demo"):
                p_, t_, o_, d_ = ((demo_plan, demo_tt, d_org, d_dirs)
                                  if who == "demo" else
                                  (plan, tt, origin, dirs))
                turns[who].append(device_ms(lambda: render_rays(
                    p_, c, t_, o_, d_), "render_kernel"))
            k1_dev = statistics.mean(turns[name])
            demo_dev = statistics.mean(turns["demo"])
            _, k1_ms = timed(lambda: render_rays(plan, c, tt, origin, dirs),
                             runs=3)
            # the twin on every TWIN_STRIDE-th ray (the fractals' DEs make
            # it the phase's longest part), the bound from its count
            sub = dirs[::TWIN_STRIDE]
            plain, plain_ms, count = timed_counted(lambda: render_rays_plain(
                plan, c, tt, origin, sub))
            same(f"{name} K1 {normal} at 512^2 (every {TWIN_STRIDE}th ray)",
                 render_rays(plan, c, tt, origin, sub), plain,
                 "render_kernel")
            del plain
            bound = bound_ms(count, R * (12 + 32), TWIN_STRIDE)
            frame_rows.append(
                f"{name} {normal}: render() {ms:.3f} ms, K1 {k1_dev:.3f} ms "
                f"on the device (demo {demo_dev:.3f} in turns: "
                f"{', '.join(f'{v:.3f}' for v in turns['demo'])} / "
                f"{', '.join(f'{v:.3f}' for v in turns[name])}), bound "
                f"{bound[0]:.4f} ms by {bound[1]} ({bound[5]} operations, "
                f"{bound[2]} leaf evaluations), share "
                f"{bound[0] / k1_dev:.1%}")
            if name == "julia":
                rows[("render_kernel", normal)] = {
                    "scene": "scenes/julia.txt", "ms": k1_ms,
                    "device_ms": k1_dev, "demo_device_ms": demo_dev,
                    "plain_ms": plain_ms, "bound_ms": bound[0],
                    "bound_by": bound[1]}
        print(f"[fractal] {name} 512x512 ssaa2 1000 it (3 frames, one K1 "
              f"a frame): " + "; ".join(frame_rows[-2:]) + f"; {card}")

    # the two-phase frame of julia.txt: K3, K3 on the tail (or again in
    # full), K4; the one kernel's image bit for bit
    scene = fractal_scene("julia")
    zero_counts()
    two = rt.render(scene, fcfg.replace(two_phase_k1=48), device=dev)
    counts = counted("two_phase_fractal", 1)
    check(counts["shade_kernel"] == 1 and counts["render_kernel"] == 0
          and counts["march_kernel"] in (1, 2), f"two-phase julia frame "
          f"launched {counts}")
    check(torch.equal(two, rt.render(scene, fcfg, device=dev)),
          "two-phase julia frame differs from the one kernel's")
    print(f"[fractal] julia.txt 512x512 ssaa2 two_phase_k1=48: launches K3 "
          f"{counts['march_kernel']}, K4 1; the one kernel's image bitwise")

    # K3, K4 and K2 on julia.txt's frame (FD), against their twins, bounds
    plan, tables = rt.compile_scene(fractal_scene("julia"))
    tt = tables_to_torch(tables, dev)
    origin, dirs = rays_for(plan, tt, fcfg)
    hit, k3_ms = timed(lambda: mk.march_rays(plan, fcfg, tt, origin, dirs),
                       runs=3)
    k3_dev = device_ms(lambda: mk.march_rays(plan, fcfg, tt, origin, dirs),
                       "march_kernel", 3)
    k3_p, k3_plain, k3_count = timed_counted(lambda: mk.march_rays_plain(
        plan, fcfg, tt, origin, dirs))
    same("julia K3 at 512^2", hit, k3_p, "march_kernel")
    rows["march_kernel"] = {"scene": "scenes/julia.txt", "ms": k3_ms,
                            "device_ms": k3_dev, "plain_ms": k3_plain,
                            "bound": bound_ms(k3_count, R * (12 + 20))}
    k4, k4_ms = timed(lambda: shk.shade_rays(plan, fcfg, tt, hit.position,
                                             hit.sd, dirs), runs=3)
    k4_dev = device_ms(lambda: shk.shade_rays(plan, fcfg, tt, hit.position,
                                              hit.sd, dirs), "shade_kernel", 3)
    k4_p, k4_plain, k4_count = timed_counted(lambda: shk.shade_rays_plain(
        plan, fcfg, tt, hit.position, hit.sd, dirs))
    same("julia K4 at 512^2", k4, k4_p, "shade_kernel")
    rows["shade_kernel"] = {"scene": "scenes/julia.txt", "ms": k4_ms,
                            "device_ms": k4_dev, "plain_ms": k4_plain,
                            "bound": bound_ms(k4_count, R * (28 + 12))}
    p = hit.position
    k2, k2_ms = timed(lambda: scene_vjp.stencil_eval(plan, fcfg, tt, p,
                                                     center=True), runs=3)
    k2_dev = device_ms(lambda: scene_vjp.stencil_eval(
        plan, fcfg, tt, p, center=True), "surface_kernel", 3)
    k2_p, k2_plain, k2_count = timed_counted(lambda: sk.surface_stencil_plain(
        plan, tt, p, fcfg.fd_h, center=True))
    same("julia K2 stencil entry at 512^2", k2, k2_p, "surface_kernel")
    rows["surface_kernel"] = {"scene": "scenes/julia.txt, the 7-point "
                              "stencils of K3's hits", "ms": k2_ms,
                              "device_ms": k2_dev, "plain_ms": k2_plain,
                              "bound": bound_ms(k2_count, R * (12 + 7 * 20))}
    for kname in ("march_kernel", "shade_kernel", "surface_kernel"):
        b = rows[kname].pop("bound")
        rows[kname].update(bound_ms=b[0], bound_by=b[1])
        print(f"[fractal] {kname} julia.txt 512x512 ssaa2: "
              f"{rows[kname]['ms']:.3f} ms with its wrapper, "
              f"{rows[kname]['device_ms']:.3f} ms on the device, plain "
              f"{rows[kname]['plain_ms']:.1f} ms; bound {b[0]:.4f} ms by "
              f"{b[1]} ({b[5]} operations), share "
              f"{b[0] / rows[kname]['device_ms']:.1%}; bitwise its twin; "
              f"{card}")
    del hit, k4, k4_p, k2, k2_p

    print(f"[fractal] frames and kernels {time.perf_counter() - t_phase:.1f} s")

    # 3. gradients, card vs CPU on the same rays (julia.txt, 32x24; the CPU
    # side's marches at 100 iterations)
    gcfg = rt.RenderConfig(width=32, height=24, ssaa=1, iterations=100)
    g_rows = []
    for normal in ("fd", "analytic"):
        c = gcfg.replace(normal_mode=normal)
        o, d = rays_for(plan, tables_to_torch(tables, "cpu"), c)
        got, launched = grads_of(plan, tables, c, dev, o, d)
        want, _ = grads_of(plan, tables, c, torch.device("cpu"), o, d)
        check(launched == (1, 1), f"julia {normal} gradients launched "
              f"{launched}")
        worst = grad_check(type(tables)._fields + ("origin", "dirs"), got,
                           want, f"julia {normal}")
        g_rows.append(f"{normal} {worst[0]:.3g} ({worst[1]})")
    print(f"[fractal] julia.txt 32x24 gradients card vs CPU on the same rays "
          f"(K1 1 and K2 1 a render: the FD stencil, or the analytic "
          f"replay's combined mode), max |diff| / field scale: "
          + ", ".join(g_rows) + f" (tolerance {GRAD_RTOL} relative, "
          f"{GRAD_ATOL_SCALE} of the scale)")

    print(f"[fractal] gradients {time.perf_counter() - t_phase:.1f} s")

    # 4. fit: 3 steps on julia.txt at 512^2 with each normal
    target = rt.render_tables(plan, tables, fcfg, device=dev)
    (leaf, *_), = plan.proc
    pos, aux = np.array(tables.prim_pos), np.array(tables.prim_aux)
    pos[leaf] += (0.08, -0.05, 0.04)
    aux[leaf, 0] *= 1.04
    start = tables._replace(prim_pos=pos, prim_aux=aux)
    train = ("prim_pos", "prim_aux")
    for normal in ("fd", "analytic"):
        c = fcfg.replace(normal_mode=normal)
        stamps = []
        zero_counts()
        t0 = time.perf_counter()
        res = rt.fit(plan, start, target, c, device=dev, steps=3, lr=1e-3,
                     trainable=train, callback=lambda *a: stamps.append(
                         time.perf_counter()))
        counts = counted(f"train_fractal_{normal}", 3)
        slices = -(-R // scene_vjp.REPLAY_RAYS)
        check(counts == only(render_kernel=3, surface_kernel=3 * (
            1 if normal == "fd" else slices)), f"julia {normal} fit "
            f"launched {counts}")
        check(all(np.isfinite(res.losses)), f"losses {res.losses}")
        step = statistics.median(np.diff([t0] + stamps))
        tg = tables_to_torch(res.tables, dev, requires_grad=train)
        opt = torch.optim.Adam([tg.prim_pos, tg.prim_aux], lr=1e-3)
        splits = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            opt.zero_grad(set_to_none=True)
            ev[0].record()
            img = rt.render_tables(plan, tg, c, differentiable=True,
                                   device=dev)
            loss = torch.mean((img - target) ** 2)
            ev[1].record()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss.backward()
            ev[2].record()
            opt.step()
            ev[3].record()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        fwd, bwd, opt_ms = (statistics.median(v) for v in zip(*splits))
        # the backward's parts: K2 (the stencil entry, or the combined mode
        # on a slice) and the parameter scatter, alone on the fit's tables
        t_ = tables_to_torch(res.tables, dev)
        out = render_rays(plan, c.replace(shade_skip_black=False), t_,
                          origin, dirs)
        if normal == "fd":
            st, k2_fit = timed(lambda: scene_vjp.stencil_eval(
                plan, c, t_, out.p, center=True), runs=3)
            q7 = sk.stencil_points(out.p, c.fd_h, center=True)
            u = torch.randn(st[0].shape, device=dev)
            _, scatter = timed(lambda: scene_vjp.theta_cotangents(
                plan, t_, st[1], st[2], u, st[0], q7), runs=3)
            del st, q7
        else:
            # K2's combined mode as the replay launches it, one slice of
            # the hits at a time, against its twin on every slice
            for lo in range(0, R, scene_vjp.REPLAY_RAYS):
                q = out.p[lo:lo + scene_vjp.REPLAY_RAYS]
                same("julia K2 combined mode on a replay slice",
                     scene_vjp.winner_eval(plan, t_, q),
                     sk.surface_eval_plain(plan, t_, q, mode=sk.COMBINED),
                     "surface_kernel")
            sl = slice(0, scene_vjp.REPLAY_RAYS)
            w, k2_fit = timed(lambda: scene_vjp.winner_eval(
                plan, t_, out.p[sl]), runs=3)
            k2_fit *= slices
            u = torch.randn(w[0].shape, device=dev)
            _, scatter = timed(lambda: scene_vjp.theta_cotangents(
                plan, t_, w[1], w[2], u, w[0], out.p[sl]), runs=3)
            scatter *= slices
        del out
        parts = (f"K2's stencil entry {k2_fit:.2f} ms, the scatter "
                 f"{scatter:.2f} ms, the rest {bwd - k2_fit - scatter:.2f} ms"
                 if normal == "fd" else
                 f"the replay under autograd {bwd - k2_fit - scatter:.2f} "
                 f"ms, K2's combined mode {k2_fit:.2f} ms and the scatter "
                 f"{scatter:.2f} ms over {slices} slices of "
                 f"{scene_vjp.REPLAY_RAYS} rays, each slice's K2 bitwise "
                 f"its twin")
        print(f"[fractal] fit julia.txt 512x512 ssaa2 1000 it, {normal} "
              f"normals, 3 Adam steps on prim_pos, prim_aux: loss "
              f"{' '.join(f'{v:.6g}' for v in res.losses)}; step median "
              f"{step * 1e3:.1f} ms; launches a step K1 1, K2 "
              f"{counts['surface_kernel'] // 3}; split (median of 3, CUDA "
              f"events) forward {fwd:.2f} ms, backward {bwd:.2f} ms ("
              f"{parts}), optimizer {opt_ms:.2f} ms; backward peak memory "
              f"{peak:.2f} GiB above the forward's; {card}")

    # 5. the multi-kernel backend: one frame on mandelbox.txt
    scene = fractal_scene("mandelbox")
    mplan, mtables = rt.compile_scene(scene)
    rt.render(scene, fcfg, backend="multi", device=dev)
    zero_counts()
    mimg, mms = timed(lambda: rt.render(scene, fcfg, backend="multi",
                                        device=dev))
    counts = counted("multi_fractal", 1)
    check(counts == only(march_kernel=1 + mplan.num_lights,
                         surface_kernel=2), f"multi frame launched {counts}")
    # its two K2 modes at its 1,048,576 primary hits (K3's), against their
    # twins
    mtt = tables_to_torch(mtables, dev)
    mhit = mk.march_rays(mplan, fcfg, mtt, *rays_for(mplan, mtt, fcfg))
    for mode in (sk.WINNER, sk.FD_GRAD):
        same(f"mandelbox K2 mode {mode} at the multi frame's hits",
             sk.surface_eval(mplan, mtt, mhit.position, mode=mode,
                             fd_h=fcfg.fd_h),
             sk.surface_eval_plain(mplan, mtt, mhit.position, mode=mode,
                                   fd_h=fcfg.fd_h), "surface_kernel")
    del mhit
    fimg = rt.render(scene, fcfg, device=dev)
    diff = (mimg - fimg).abs().amax(dim=-1)
    share = (diff <= REFLECT_ATOL).double().mean().item()
    check(share >= AGREE, f"multi vs fused: {share} of pixels agree")
    print(f"[fractal] mandelbox.txt 512x512 ssaa2 backend=multi: "
          f"{mms:.3f} ms, launches K3 {counts['march_kernel']}, K2 "
          f"{counts['surface_kernel']} (K2's winner and FD-gradient modes "
          f"at its {R} hits bitwise their twins); against backend=cuda "
          f"{share:.5f} of pixels within {REFLECT_ATOL}, max "
          f"{diff.max().item():.3g}; "
          f"{card}")
    print("[fractal] launches on its paths: " + ", ".join(
              f"{k} {v}" for k, v in launches.items()))
    rows["launches"] = launches
    return rows


# the [deep] phase (pallas_march's D8: plans with no two-level form)
D8 = ("raymarching_tpu/ops/pallas_march.py:1533 (_scene_generic_tile, via "
      ":1628, :2284, :2456, :2577)")


def deep_demo(scene):
    """``scene`` with a depth-3 list in front of its root's children (a
    union holding an intersection of a union and a sphere): its plan has no
    two-level form, so every kernel takes its deep view (fold.cuh's
    Deep<S>) and folds every leaf, with no collapse and no cull."""
    from raymarching_tpu_torch.scene.csg import Box, ListNode, Mode, Sphere
    inner = ListNode(Mode.UNION, [Sphere((0, 0, -4), 1.0),
                                  Box((1, 0, -4), (1, 1, 1))])
    mid = ListNode(Mode.INTERSECTION, [inner, Sphere((0.5, 0, -4), 1.2)])
    return dataclasses.replace(scene, tree=ListNode(
        scene.tree.mode, [ListNode(Mode.UNION, [mid])]
        + list(scene.tree.children)))


def deep_julia():
    """scenes/julia.txt with its Julia leaf inside an intersection, three
    lists down: union(Julia, sphere) intersected with a box, in a union."""
    from raymarching_tpu_torch.scene.csg import (Box, Julia, ListNode, Mode,
                                                 Sphere)
    from raymarching_tpu_torch.scene.parser import load_scene
    scene = load_scene(str(ROOT / "scenes" / "julia.txt"))
    leaf = next(c for c in scene.tree.children if isinstance(c, Julia))
    inter = ListNode(Mode.INTERSECTION, [
        ListNode(Mode.UNION, [leaf, Sphere((0.9, 0.0, -5.0), 0.6)]),
        Box((0.0, 0.2, -5.0), (2.4, 2.0, 2.4))])
    rest = [c for c in scene.tree.children if c is not leaf]
    return dataclasses.replace(scene, tree=ListNode(
        scene.tree.mode, rest + [ListNode(Mode.UNION, [inter])]))


def deep_phase(dev, card: str, add_counts, demo_plan, demo_tt) -> dict:
    """[deep]: plans deeper than two levels on every path.  Every kernel's
    deep view against its twin at 32x24 SSAA 1 (the demo behind a deep
    list, with and without the fused flag; julia.txt's Julia inside an
    intersection); the deep demo (every leaf folded: no collapse, no cull)
    at 512x512 SSAA 2, 1000 iterations: render() with FD and analytic
    normals, K1's device time in turns with the two-level demo's through
    the same entry, K1 against its twin (also as the fit step launches it,
    with the winner residuals in analytic), its bound and share; the multi
    frame and the two-phase frame; K3, K4 and K2's stencil entry on the
    frame's hits against their twins with their bounds, and K2's winner
    and FD-gradient modes (the multi frame's) there; one fit step in each
    normal; a served frame, whose raygen launch is held to its twin; the
    deep Julia's frame.  Returns each of the four kernels' deep row of the JSON
    table."""
    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch.ops import march_kernel as mk
    from raymarching_tpu_torch.ops import scene_vjp
    from raymarching_tpu_torch.ops import shade_kernel as shk
    from raymarching_tpu_torch.ops import surface_kernel as sk
    from raymarching_tpu_torch.ops.render_kernel import (
        render_raygen, render_raygen_plain, render_rays, render_rays_plain)
    from raymarching_tpu_torch.tables import scene_operands, tables_to_torch

    t_phase = time.perf_counter()
    launches = dict.fromkeys(KERNELS, 0)

    def counted(path: str, calls: int) -> dict:
        counts = add_counts(path, calls)
        for k in KERNELS:
            launches[k] += counts[k]
        return counts

    demo = rt.load_scene(str(DEMO))
    ddemo, djulia = deep_demo(demo), deep_julia()
    plan, tables = rt.compile_scene(ddemo)
    jplan, jtables = rt.compile_scene(djulia)
    tt, jtt = tables_to_torch(tables, dev), tables_to_torch(jtables, dev)
    for what, p_, t_ in (("deep demo", plan, tt), ("deep julia", jplan, jtt)):
        ops_ = scene_operands(p_, t_, dev, True, True)
        check(p_.kernel is None and ops_.deep == 1 and ops_.fused == 0,
              f"{what}: not the deep view")

    # 1. every deep entry against its twin, small
    small = rt.RenderConfig(width=32, height=24, ssaa=1, iterations=50)
    n_cmp = (view_compare(plan, tt, small, False, True, "deep demo")
             + view_compare(plan, tt, small, True, False,
                            "deep demo, fused flag")
             + view_compare(jplan, jtt, small, False, True, "deep julia"))
    print(f"[deep] every kernel's deep view = its plain twin bitwise "
          f"({n_cmp} comparisons at {small.width}x{small.height} ssaa"
          f"{small.ssaa} {small.iterations} it on the demo behind a deep "
          f"list ({plan.num_primitives} leaves; again with the fused flag, "
          f"which a deep plan's field ignores) and julia.txt's Julia in an "
          f"intersection: K1's reference and raygen entries, FD and "
          f"analytic; K3; K4 FD and analytic; K2's five modes and its "
          f"stencil entry; K1's and K4's extended and K1's bounce entries "
          f"with soft shadows and AO); largest difference over this run so "
          f"far " + ", ".join(f"{k} {v:.3g}" for k, v in ERRS.items())
          + f"; {time.perf_counter() - t_phase:.1f} s")

    # 2. the deep demo's frames at full width, K1 in turns with the demo
    fcfg = rt.RenderConfig(width=512, height=512, ssaa=2, iterations=1000)
    R = fcfg.rays_per_image
    rows = {}
    origin, dirs = rays_for(plan, tt, fcfg)
    d_org, d_dirs = rays_for(demo_plan, demo_tt, fcfg)
    frame_rows = []
    for normal in ("fd", "analytic"):
        c = fcfg.replace(normal_mode=normal)
        zero_counts()
        rt.render(ddemo, c, device=dev)          # warm-up at this shape
        img, ms = timed(lambda: rt.render(ddemo, c, device=dev), runs=3)
        counts = counted(f"deep_{normal}", 4)
        check(counts == only(render_kernel=4),
              f"deep {normal} render() launched {counts}")
        check(img.shape == (c.height, c.width, 3)
              and bool(torch.isfinite(img).all()) and has_demo_objects(img),
              f"deep {normal} image")
        turns = {"demo": [], "deep": []}
        for who in ("demo", "deep", "deep", "demo"):
            p_, t_, o_, d_ = ((demo_plan, demo_tt, d_org, d_dirs)
                              if who == "demo" else (plan, tt, origin, dirs))
            turns[who].append(device_ms(lambda: render_rays(
                p_, c, t_, o_, d_), "render_kernel"))
        k1_dev = statistics.mean(turns["deep"])
        demo_dev = statistics.mean(turns["demo"])
        _, k1_ms = timed(lambda: render_rays(plan, c, tt, origin, dirs),
                         runs=3)
        # the twins on every TWIN_STRIDE-th ray, the bound from the count
        sub = dirs[::TWIN_STRIDE]
        plain, plain_ms, count = timed_counted(lambda: render_rays_plain(
            plan, c, tt, origin, sub))
        same(f"deep demo K1 {normal} at 512^2 (every {TWIN_STRIDE}th ray)",
             render_rays(plan, c, tt, origin, sub), plain, "render_kernel")
        del plain
        # K1 as the fit step launches it (render_op.FusedRender: no
        # black-lane skip, the shading factors and, with analytic normals,
        # the winner residuals), against its twin
        fc = c.replace(shade_skip_black=False)
        sw = normal == "analytic"
        same(f"deep demo K1 {normal} at 512^2 as the fit step launches it "
             f"(every {TWIN_STRIDE}th ray)",
             flat(render_rays(plan, fc, tt, origin, sub, save_winner=sw,
                              save_factors=True)),
             flat(render_rays_plain(plan, fc, tt, origin, sub,
                                    save_winner=sw, save_factors=True)),
             "render_kernel")
        bound = bound_ms(count, R * (12 + 32), TWIN_STRIDE)
        frame_rows.append(
            f"{normal}: render() {ms:.3f} ms, K1 {k1_dev:.3f} ms on the "
            f"device (the two-level demo {demo_dev:.3f} in turns: "
            f"{', '.join(f'{v:.3f}' for v in turns['demo'])} / "
            f"{', '.join(f'{v:.3f}' for v in turns['deep'])}), with its "
            f"wrapper {k1_ms:.3f} ms, plain {plain_ms:.1f} ms (bitwise; "
            f"so is the fit step's launch, with its factors"
            f"{' and winner residuals' if normal == 'analytic' else ''}), "
            f"bound {bound[0]:.4f} ms by {bound[1]} ({bound[5]} operations, "
            f"{bound[2]} leaf evaluations), share {bound[0] / k1_dev:.1%}")
        rows[("render_kernel", normal)] = {
            "scene": "scenes/demo.txt behind a deep list", "ms": k1_ms,
            "device_ms": k1_dev, "demo_device_ms": demo_dev,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "share": bound[0] / k1_dev}
    print(f"[deep] demo behind a deep list, {plan.num_primitives} leaves, "
          f"512x512 ssaa2 1000 it (3 frames, one K1 a frame): "
          + "; ".join(frame_rows) + f"; {card}")

    # the multi frame and the two-phase frame (FD)
    rt.render(ddemo, fcfg, backend="multi", device=dev)
    zero_counts()
    mimg, mms = timed(lambda: rt.render(ddemo, fcfg, backend="multi",
                                        device=dev))
    counts = counted("multi_deep", 1)
    check(counts == only(march_kernel=1 + plan.num_lights, surface_kernel=2),
          f"deep multi frame launched {counts}")
    fimg = rt.render(ddemo, fcfg, device=dev)
    diff = (mimg - fimg).abs().amax(dim=-1)
    share = (diff <= REFLECT_ATOL).double().mean().item()
    check(share >= AGREE, f"deep multi vs fused: {share} of pixels agree")
    zero_counts()
    two, tms = timed(lambda: rt.render(ddemo, fcfg.replace(two_phase_k1=48),
                                       device=dev))
    counts2 = counted("two_phase_deep", 1)
    check(counts2["shade_kernel"] == 1 and counts2["render_kernel"] == 0
          and counts2["march_kernel"] in (1, 2),
          f"deep two-phase frame launched {counts2}")
    check(torch.equal(two, fimg), "deep two-phase frame differs from the "
          "one kernel's")
    print(f"[deep] demo behind a deep list 512x512 ssaa2: backend=multi "
          f"{mms:.3f} ms, launches K3 {counts['march_kernel']}, K2 "
          f"{counts['surface_kernel']}, against backend=cuda {share:.5f} of "
          f"pixels within {REFLECT_ATOL}, max {diff.max().item():.3g}; "
          f"two_phase_k1=48 {tms:.3f} ms, launches K3 "
          f"{counts2['march_kernel']}, K4 1, the one kernel's image bitwise; "
          f"{card}")
    del mimg, two

    # K3, K4 and K2's stencil entry on the deep demo's frame (FD), bounds
    hit, k3_ms = timed(lambda: mk.march_rays(plan, fcfg, tt, origin, dirs),
                       runs=3)
    k3_dev = device_ms(lambda: mk.march_rays(plan, fcfg, tt, origin, dirs),
                       "march_kernel", 3)
    k3_p, k3_plain, k3_count = timed_counted(lambda: mk.march_rays_plain(
        plan, fcfg, tt, origin, dirs))
    same("deep demo K3 at 512^2", hit, k3_p, "march_kernel")
    # the multi frame's two K2 modes at its 1,048,576 primary hits (K3's),
    # against their twins
    for mode in (sk.WINNER, sk.FD_GRAD):
        same(f"deep demo K2 mode {mode} at the multi frame's hits",
             sk.surface_eval(plan, tt, hit.position, mode=mode,
                             fd_h=fcfg.fd_h),
             sk.surface_eval_plain(plan, tt, hit.position, mode=mode,
                                   fd_h=fcfg.fd_h), "surface_kernel")
    rows["march_kernel"] = {"ms": k3_ms, "device_ms": k3_dev,
                            "plain_ms": k3_plain,
                            "bound": bound_ms(k3_count, R * (12 + 20))}
    k4, k4_ms = timed(lambda: shk.shade_rays(plan, fcfg, tt, hit.position,
                                             hit.sd, dirs), runs=3)
    k4_dev = device_ms(lambda: shk.shade_rays(plan, fcfg, tt, hit.position,
                                              hit.sd, dirs), "shade_kernel", 3)
    k4_p, k4_plain, k4_count = timed_counted(lambda: shk.shade_rays_plain(
        plan, fcfg, tt, hit.position, hit.sd, dirs))
    same("deep demo K4 at 512^2", k4, k4_p, "shade_kernel")
    rows["shade_kernel"] = {"ms": k4_ms, "device_ms": k4_dev,
                            "plain_ms": k4_plain,
                            "bound": bound_ms(k4_count, R * (28 + 12))}
    p = hit.position
    k2, k2_ms = timed(lambda: scene_vjp.stencil_eval(plan, fcfg, tt, p,
                                                     center=True), runs=3)
    k2_dev = device_ms(lambda: scene_vjp.stencil_eval(
        plan, fcfg, tt, p, center=True), "surface_kernel", 3)
    k2_p, k2_plain, k2_count = timed_counted(lambda: sk.surface_stencil_plain(
        plan, tt, p, fcfg.fd_h, center=True))
    same("deep demo K2 stencil entry at 512^2 (the fit step's shape)", k2,
         k2_p, "surface_kernel")
    rows["surface_kernel"] = {"scene": "the 7-point stencils of K3's hits",
                              "ms": k2_ms, "device_ms": k2_dev,
                              "plain_ms": k2_plain,
                              "bound": bound_ms(k2_count, R * (12 + 7 * 20))}
    for kname in ("march_kernel", "shade_kernel", "surface_kernel"):
        b = rows[kname].pop("bound")
        rows[kname].update(bound_ms=b[0], bound_by=b[1],
                           share=b[0] / rows[kname]["device_ms"])
        print(f"[deep] {kname} demo behind a deep list 512x512 ssaa2: "
              f"{rows[kname]['ms']:.3f} ms with its wrapper, "
              f"{rows[kname]['device_ms']:.3f} ms on the device, plain "
              f"{rows[kname]['plain_ms']:.1f} ms; bound {b[0]:.4f} ms by "
              f"{b[1]} ({b[5]} operations, {b[2]} leaf evaluations), share "
              f"{rows[kname]['share']:.1%}; bitwise its twin; {card}")
    print(f"[deep] K2's winner and FD-gradient modes (the multi frame's) "
          f"at the deep demo's {R} primary hits: bitwise their twins")
    del hit, k3_p, k4, k4_p, k2, k2_p

    # one fit step in each normal (FD: K1 and K2's stencil entry; analytic:
    # K1 with its winner residuals, no K2)
    target = rt.render_tables(plan, tables, fcfg, device=dev)
    start, _, _ = perturbed_demo(tables)
    for normal in ("fd", "analytic"):
        c = fcfg.replace(normal_mode=normal)
        rt.fit(plan, start, target, c, device=dev, steps=1,
               trainable=TRAINABLE, optimizer=adam)     # warm-up
        zero_counts()
        t0 = time.perf_counter()
        res = rt.fit(plan, start, target, c, device=dev, steps=1,
                     trainable=TRAINABLE, optimizer=adam)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        counts = counted(f"train_deep_{normal}", 1)
        check(counts == only(render_kernel=1,
                             surface_kernel=1 if normal == "fd" else 0),
              f"deep {normal} fit step launched {counts}")
        check(all(np.isfinite(res.losses)), f"losses {res.losses}")
        print(f"[deep] fit step, demo behind a deep list 512x512 ssaa2 1000 "
              f"it, {normal} normals, Adam on {', '.join(TRAINABLE)}: "
              f"{step_ms:.1f} ms (host clock, loss {res.losses[0]:.6g}); "
              f"launches K1 1, K2 {counts['surface_kernel']}; {card}")

    # a served frame: K1's raygen entry, no camera pass
    scfg = fcfg.replace(serve_raygen=True)
    rt.render(ddemo, scfg, device=dev)
    zero_counts()
    simg, sms = timed(lambda: rt.render(ddemo, scfg, device=dev))
    counts = counted("serve_deep", 1)
    check(counts == only(render_raygen_kernel=1),
          f"deep served frame launched {counts}")
    # the raygen entry's launch of that frame, every ray, against its twin
    same("deep demo K1 raygen entry at 512^2 (the served frame's launch)",
         render_raygen(plan, scfg, tt, 0, R),
         render_raygen_plain(plan, scfg, tt, 0, R), "render_raygen_kernel")
    sdiff = (simg - fimg).abs().amax(dim=-1)
    s_share = (sdiff <= ANALYTIC_ATOL).double().mean().item()
    check(s_share >= 0.995, f"deep served frame: {s_share} of pixels agree")
    print(f"[deep] served frame (serve_raygen, K1's raygen entry 1, its "
          f"{R} rays bitwise the twin's): "
          f"{sms:.3f} ms; {s_share:.5f} of pixels within {ANALYTIC_ATOL} of "
          f"the standard frame's (the raygen directions round apart at "
          f"silhouettes); {card}")
    del simg, fimg

    # the deep Julia's frame, forward
    zero_counts()
    rt.render(djulia, fcfg, device=dev)
    jimg, jms = timed(lambda: rt.render(djulia, fcfg, device=dev), runs=3)
    counts = counted("deep_julia", 4)
    check(counts == only(render_kernel=4), f"deep julia launched {counts}")
    check(bool(torch.isfinite(jimg).all()) and jimg.max().item() > 0,
          "deep julia image")
    jo, jd = rays_for(jplan, jtt, fcfg)
    jk1 = device_ms(lambda: render_rays(jplan, fcfg, jtt, jo, jd),
                    "render_kernel")
    jsub = slice(0, R, TWIN_STRIDE)
    jk = render_rays(jplan, fcfg, jtt, jo, jd[jsub])
    jp_, _, jcount = timed_counted(lambda: render_rays_plain(
        jplan, fcfg, jtt, jo, jd[jsub]))
    same(f"deep julia K1 at 512^2 (every {TWIN_STRIDE}th ray)", jk, jp_,
         "render_kernel")
    print(f"[deep] julia.txt's Julia in an intersection, 512x512 ssaa2 1000 "
          f"it, FD: render() {jms:.3f} ms, K1 {jk1:.3f} ms on the device; "
          f"K1 = its twin on every {TWIN_STRIDE}th ray bitwise ("
          f"{jcount.ops} operations there); {card}")
    print("[deep] launches on its paths: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    rows["launches"] = launches
    return rows


# the culls of the four kernels' folds (pallas_march's D5 and D4) and the
# block ray order, [cull]
CULL_SCENES = ("scatter1k", "menger4")
D5_D4 = ("raymarching_tpu/ops/pallas_march.py:598 (D5: _bvh_group_fold), "
         ":844-1190 (D4: _menger_subtree_fold :844, _menger_level2_walk "
         ":913, _menger_carve_subtree_culled :946, _subtree_collapse_eval "
         ":1006, _menger_subtree_collapsed :1075, "
         "_menger_subtree_vbound_fold :1102, _subtree_carve_fold :1174)")


def sponge5():
    """The iters-5 sponge of tests/test_pallas.py's _menger_plan (168,422
    leaves: no lattice, so every fold of it takes D4's margin walk)."""
    from raymarching_tpu_torch.scene.compile import compile_tree
    from raymarching_tpu_torch.scene.csg import ListNode, Mode, bounds
    from raymarching_tpu_torch.scene.generators import menger_sponge
    from raymarching_tpu_torch.scene.objects import Camera
    return compile_tree(ListNode(Mode.UNION, [
        bounds(60.0), menger_sponge((0, 0, -8), 9.0, 5)]), [], Camera())


class unculled:
    """Within it the plain twins fold every leaf (core.sdf.CULL off)."""

    def __enter__(self):
        from raymarching_tpu_torch.core import sdf
        self.was, sdf.CULL = sdf.CULL, False

    def __exit__(self, *exc):
        from raymarching_tpu_torch.core import sdf
        sdf.CULL = self.was
        return False


def lane_efficiency(st) -> float:
    """Sum of steps over 32 x the sum of each warp's slowest ray; warps
    are 32 consecutive rays."""
    st = torch.nn.functional.pad(st.double(), (0, -st.numel() % 32))
    w = st.reshape(-1, 32)
    return (w.sum() / (32 * w.max(dim=1).values.sum())).item()


def skip_shares(count) -> str:
    """The culls' skip shares in a twin's LeafCount."""
    out = []
    for what, tested, skipped in (
            ("chunks", count.chunks_tested, count.chunks_skipped),
            ("cells", count.cells_tested, count.cells_skipped)):
        if tested:
            out.append(f"{what} {skipped}/{tested} skipped "
                       f"({skipped / tested:.4f})")
    return ", ".join(out) or "no test"


def cull_phase(dev, card: str, add_counts) -> dict:
    """[cull]: the culls of pallas_march's D5 (the wide-UNION chunk cull,
    scenes/scatter1k.txt) and D4 (the deep-sponge walks: menger4.txt's
    value-bound winner walk, an iters-5 sponge's margin walk) and the block
    ray order.  Every kernel's Cull view against both plain twins (the
    culled and the unculled fold) bitwise, small (the unculled twin with FD
    normals) and at the paths' shapes (the culled twin on every 8th ray,
    the unculled on every 16th); scatter1k and menger4 at 512x512 SSAA 2,
    1000 iterations: render() in FD and analytic, one fit step in each, the
    multi frame and the two-phase frame, the device times of K1, K2's
    stencil entry, K3 and K4 with the culled twins' bounds and skip
    shares; the demo's standard and served frames in block and scan order
    in turns, bitwise equal, with the warps' lane efficiency under each
    (also at 1024x768 SSAA 3); K1's raygen block arm against its twin.
    Returns each of the four kernels' cull row of the JSON table."""
    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch.core.order import block_dims, to_blocked
    from raymarching_tpu_torch.ops import march_kernel as mk
    from raymarching_tpu_torch.ops import scene_vjp
    from raymarching_tpu_torch.ops import shade_kernel as shk
    from raymarching_tpu_torch.ops import surface_kernel as sk
    from raymarching_tpu_torch.ops.render_kernel import (
        render_raygen, render_raygen_plain, render_rays, render_rays_plain)
    from raymarching_tpu_torch.tables import scene_operands, tables_to_torch

    t_phase = time.perf_counter()
    launches = dict.fromkeys(KERNELS, 0)

    def counted(path: str, calls: int) -> dict:
        counts = add_counts(path, calls)
        for k in KERNELS:
            launches[k] += counts[k]
        return counts

    # 1. every kernel's Cull view against both twins, small
    small = rt.RenderConfig(width=32, height=24, ssaa=1, iterations=200)
    worlds = {name: rt.compile_scene(rt.load_scene(
        str(ROOT / "scenes" / f"{name}.txt"))) for name in CULL_SCENES}
    worlds["iters 5"] = sponge5()
    # the twins fold [rays, leaves] at every step, and take a few launches
    # a step until their slowest ray ends: each world takes the frame its
    # twin can fold in seconds, scatter1k's 1,002 leaves at 32x24, menger4's
    # 8,424 at 16x12, the iters-5 sponge's 168,422 at 12x9, at most 200
    # steps (150 on the sponge)
    sizes = {"scatter1k": small, "menger4": small.replace(width=16,
                                                          height=12),
             "iters 5": small.replace(width=12, height=9, iterations=150)}
    n_cmp, took = 0, []
    for name, (plan, tables) in worlds.items():
        t_w = time.perf_counter()
        tt = tables_to_torch(tables, dev)
        ops_ = scene_operands(plan, tt, dev)
        check(ops_.cull == 1, f"{name}: not the Cull view")
        c = sizes[name]
        ext = name == "scatter1k"
        n_cmp += view_compare(plan, tt, c, False, ext, f"cull {name}")
        with unculled():
            n_cmp += view_compare(plan, tt, c, False, False,
                                  f"cull {name} (unculled twin)",
                                  normals=("fd",))
        took.append(f"{name} {c.width}x{c.height} {c.iterations} it "
                    f"{time.perf_counter() - t_w:.1f} s")
    # scatter1k's chunks in the fused packing (test_bvh_cull.py:218)
    plan, tables = worlds["scatter1k"]
    n_cmp += view_compare(plan, tables_to_torch(tables, dev),
                          small.replace(width=24, height=18), True, False,
                          "cull scatter1k fused")
    print(f"[cull] every kernel's Cull view = both plain twins (the culled "
          f"and the unculled fold) bitwise ({n_cmp} comparisons, ssaa1: "
          + "; ".join(took) + " (scatter1k also with the extended and "
          f"bounce entries against the culled twin, and in the fused "
          f"packing at 24x18): K1's reference and raygen entries FD and "
          f"analytic (the unculled twin FD), K3, K4, K2's five modes and "
          f"its stencil entry) in "
          f"{time.perf_counter() - t_phase:.1f} s; largest difference so "
          f"far " + ", ".join(f"{k} {v:.3g}" for k, v in ERRS.items()))

    # 2. scatter1k and menger4 at the bench footprint
    fcfg = rt.RenderConfig(width=512, height=512, ssaa=2, iterations=1000)
    R = fcfg.rays_per_image
    rows = {k: {} for k in ("render_kernel", "surface_kernel",
                            "march_kernel", "shade_kernel")}
    for name in CULL_SCENES:
        scene = rt.load_scene(str(ROOT / "scenes" / f"{name}.txt"))
        plan, tables = worlds[name]
        tt = tables_to_torch(tables, dev)
        out = []
        for normal in ("fd", "analytic"):
            c = fcfg.replace(normal_mode=normal)
            zero_counts()
            rt.render(scene, c, device=dev)       # warm-up at this shape
            img, ms = timed(lambda: rt.render(scene, c, device=dev), runs=3)
            check(counted(f"cull_{name}_{normal}", 4)
                  == only(render_kernel=4), f"{name} {normal} render()")
            check(img.shape == (512, 512, 3) and bool(
                torch.isfinite(img).all()) and img.max().item() > 0,
                f"{name} image")
            target = img
            start = tables._replace(prim_color=np.asarray(
                tables.prim_color) * np.float32(0.9))
            zero_counts()
            rt.fit(plan, start, target, c, device=dev, steps=1,
                   trainable=TRAINABLE, optimizer=adam)
            _, step_ms = timed(lambda: rt.fit(
                plan, start, target, c, device=dev, steps=1,
                trainable=TRAINABLE, optimizer=adam), runs=3)
            counted(f"cull_{name}_fit_{normal}", 4)
            out.append(f"{normal}: render() {ms:.3f} ms, a fit step "
                       f"{step_ms:.1f} ms")
        zero_counts()
        multi, multi_ms = timed(lambda: rt.render(scene, fcfg, backend="multi",
                                                  device=dev), runs=2)
        counted(f"cull_{name}_multi", 2)
        zero_counts()
        two, two_ms = timed(lambda: rt.render(
            scene, fcfg.replace(two_phase_k1=48), device=dev), runs=2)
        counted(f"cull_{name}_two_phase", 2)
        one = rt.render(scene, fcfg, device=dev)
        check(torch.equal(two, one), f"{name}: two-phase frame differs")
        agree = ((multi - one).abs() <= MULTI_ATOL).double().mean().item()
        check(agree >= AGREE, f"{name}: multi frame agrees on {agree}")
        print(f"[cull] {name} 512x512 ssaa2 1000 it: " + "; ".join(out)
              + f"; the multi frame {multi_ms:.3f} ms ({agree:.5f} of "
              f"pixels within {MULTI_ATOL} of the fused one), the two-phase "
              f"frame {two_ms:.3f} ms (the fused one bitwise); {card}")
        # the kernels on the frame's rays (scan order), device times, and
        # the twins: the culled one on every 8th ray (its count), the
        # unculled one on every 16th, both bitwise
        origin, dirs = rays_for(plan, tt, fcfg)
        sub, sub16 = dirs[::8], dirs[::16]
        k1_dev = {n: device_ms(lambda: render_rays(
            plan, fcfg.replace(normal_mode=n), tt, origin, dirs),
            "render_kernel", 3) for n in ("fd", "analytic")}
        k1, k1_ms = timed(lambda: render_rays(plan, fcfg, tt, origin, sub))
        p1, p1_ms, c1 = timed_counted(lambda: render_rays_plain(
            plan, fcfg, tt, origin, sub))
        same(f"cull {name} K1 on every 8th ray", k1, p1, "render_kernel")
        with unculled():
            same(f"cull {name} K1 on every 16th ray (unculled twin)",
                 render_rays(plan, fcfg, tt, origin, sub16),
                 render_rays_plain(plan, fcfg, tt, origin, sub16),
                 "render_kernel")
        hit = mk.march_rays(plan, fcfg, tt, origin, dirs)
        k3_dev = device_ms(lambda: mk.march_rays(plan, fcfg, tt, origin,
                                                 dirs), "march_kernel", 3)
        k3 = mk.march_rays(plan, fcfg, tt, origin, sub)
        p3, p3_ms, c3 = timed_counted(lambda: mk.march_rays_plain(
            plan, fcfg, tt, origin, sub))
        same(f"cull {name} K3 on every 8th ray", k3, p3, "march_kernel")
        with unculled():
            same(f"cull {name} K3 on every 16th ray (unculled twin)",
                 mk.march_rays(plan, fcfg, tt, origin, sub16),
                 mk.march_rays_plain(plan, fcfg, tt, origin, sub16),
                 "march_kernel")
        hp, hs = hit.position, hit.sd
        k4_dev = device_ms(lambda: shk.shade_rays(plan, fcfg, tt, hp, hs,
                                                  dirs), "shade_kernel", 3)
        k4 = shk.shade_rays(plan, fcfg, tt, hp[::8], hs[::8], sub)
        p4, p4_ms, c4 = timed_counted(lambda: shk.shade_rays_plain(
            plan, fcfg, tt, hp[::8], hs[::8], sub))
        same(f"cull {name} K4 on every 8th hit", k4, p4, "shade_kernel")
        with unculled():
            same(f"cull {name} K4 on every 16th hit (unculled twin)",
                 shk.shade_rays(plan, fcfg, tt, hp[::16], hs[::16], sub16),
                 shk.shade_rays_plain(plan, fcfg, tt, hp[::16], hs[::16],
                                      sub16), "shade_kernel")
        k2_dev = device_ms(lambda: scene_vjp.stencil_eval(
            plan, fcfg, tt, hp, center=True), "surface_kernel", 3)
        k2 = scene_vjp.stencil_eval(plan, fcfg, tt, hp[::8], center=True)
        p2, p2_ms, c2 = timed_counted(lambda: sk.surface_stencil_plain(
            plan, tt, hp[::8], fcfg.fd_h, center=True))
        same(f"cull {name} K2 stencil on every 8th hit", k2, p2,
             "surface_kernel")
        with unculled():
            same(f"cull {name} K2 stencil on every 16th hit (unculled "
                 f"twin)", scene_vjp.stencil_eval(plan, fcfg, tt, hp[::16],
                                                  center=True),
                 sk.surface_stencil_plain(plan, tt, hp[::16], fcfg.fd_h,
                                          center=True), "surface_kernel")
        # the bound of the whole frame's launch: the culled twin's count on
        # every 8th ray, times 8
        for kname, dev_ms_, plain_ms, count, nbytes in (
                ("render_kernel", k1_dev["fd"], p1_ms, c1, 12 + 32),
                ("march_kernel", k3_dev, p3_ms, c3, 12 + 20),
                ("shade_kernel", k4_dev, p4_ms, c4, 28 + 12),
                ("surface_kernel", k2_dev, p2_ms, c2, 12 + 7 * 20)):
            b = bound_ms(count, R * nbytes // 8)
            b = (b[0] * 8, b[1], b[2] * 8, b[3] * 8, b[4] * 8, b[5] * 8)
            rows[kname][name] = {"device_ms": dev_ms_,
                                 "plain_ms_every_8th_ray": plain_ms,
                                 "bound_ms": b[0], "bound_by": b[1],
                                 "operations": b[5],
                                 "leaves_folded": b[2],
                                 "chunks_tested": count.chunks_tested * 8,
                                 "chunks_skipped": count.chunks_skipped * 8,
                                 "cells_tested": count.cells_tested * 8,
                                 "cells_skipped": count.cells_skipped * 8}
            if kname == "render_kernel":
                rows[kname][name]["device_ms_analytic"] = k1_dev["analytic"]
                rows[kname][name]["ms"] = k1_ms
            print(f"[cull] {name} {kname} 512x512 ssaa2: {dev_ms_:.3f} ms "
                  f"on the device; bound {b[0]:.4f} ms by {b[1]} ({b[5]} "
                  f"operations, {b[2]} leaves folded: the culled twin's "
                  f"count on every 8th ray, x 8), share "
                  f"{b[0] / dev_ms_:.1%}; twin {skip_shares(count)}; "
                  f"bitwise the culled twin on every 8th ray and the "
                  f"unculled on every 16th; {card}")
        print(f"[cull] {name}: K1 analytic {k1_dev['analytic']:.3f} ms on "
              f"the device; {card}")
        del k1, p1, k3, p3, k4, p4, k2, p2, hit

    # 3. block ray order: the demo's frames in turns, bitwise
    demo = rt.load_scene(str(DEMO))
    dplan, dtables = rt.compile_scene(demo)
    dtt = tables_to_torch(dtables, dev)
    block_rows = []
    for serve in (False, True):
        c = fcfg.replace(serve_raygen=serve)
        imgs, turns = {}, {"scan": [], "block": []}
        for order in ("scan", "block", "block", "scan"):
            co = c.replace(ray_order=order)
            rt.render(demo, co, device=dev)
            imgs[order], ms = timed(lambda: rt.render(demo, co, device=dev),
                                    runs=2)
            turns[order].append(ms)
        check(torch.equal(imgs["scan"], imgs["block"]),
              f"block and scan frames differ (serve_raygen {serve})")
        zero_counts()
        rt.render(demo, c.replace(ray_order="block"), device=dev)
        counted(f"block_order_serve={int(serve)}", 1)
        block_rows.append(
            f"{'served' if serve else 'standard'} frame scan "
            f"{' / '.join(f'{v:.3f}' for v in turns['scan'])} ms, block "
            f"{' / '.join(f'{v:.3f}' for v in turns['block'])} ms, bitwise")
    # [warp]'s lane efficiency of K3's primary march in each order; at
    # SSAA 3 (9 samples a pixel) a warp's 32 rays straddle pixels, and the
    # two orders give it other pixels
    bd = block_dims(fcfg.height, fcfg.width, fcfg.samples_per_pixel,
                    fcfg.tile_sublanes * 128)
    big = fcfg.replace(width=1024, height=768, ssaa=3)
    eff = []
    for name, (plan, tables), c in [
            ("demo", (dplan, dtables), fcfg),
            *((n, worlds[n], fcfg) for n in CULL_SCENES),
            ("demo 1024x768 ssaa3", (dplan, dtables), big)]:
        tt = tables_to_torch(tables, dev)
        origin, dirs = rays_for(plan, tt, c)
        shape = (c.height, c.width, c.samples_per_pixel)
        bdc = block_dims(*shape, c.tile_sublanes * 128)
        _, st_scan = mk.march_rays(plan, c, tt, origin, dirs,
                                   with_steps=True)
        blocked = to_blocked(dirs, *shape, *bdc)
        _, st_block = mk.march_rays(plan, c, tt, origin, blocked,
                                    with_steps=True)
        check(torch.equal(to_blocked(st_scan, *shape, *bdc), st_block),
              f"{name}: steps differ between orders")
        t_scan = device_ms(lambda: mk.march_rays(plan, c, tt, origin,
                                                 dirs), "march_kernel", 3)
        t_block = device_ms(lambda: mk.march_rays(plan, c, tt, origin,
                                                  blocked), "march_kernel", 3)
        eff.append(f"{name} ({bdc[0]}x{bdc[1]} blocks) "
                   f"{lane_efficiency(st_scan):.4f} scan / "
                   f"{lane_efficiency(st_block):.4f} block (K3 "
                   f"{t_scan:.3f} / {t_block:.3f} ms)")
        del st_scan, st_block, blocked, dirs
    # K1's raygen block arm against its twin, both entries
    small_b = small.replace(tile_sublanes=1)
    bds = block_dims(small_b.height, small_b.width, 1, 128)
    Rs = small_b.rays_per_image
    for c in (small_b, small_b.replace(normal_mode="analytic"),
              small_b.replace(reflect_strength=0.4, reflect_bounces=1)):
        same("K1 raygen block arm", flat(render_raygen(
            dplan, c, dtt, 0, Rs, block=bds)), flat(render_raygen_plain(
                dplan, c, dtt, 0, Rs, block=bds)),
            "render_bounce_kernel" if c.reflect_bounces
            else "render_raygen_kernel")
    print(f"[cull] block order (pixel blocks {bd[0]}x{bd[1]} at 512x512 "
          f"ssaa2): " + "; ".join(block_rows) + "; [warp] lane efficiency "
          f"of K3's primary march: " + "; ".join(eff) + f"; K1's raygen "
          f"block arm ({bds[0]}x{bds[1]} blocks at 64x48) = its twin "
          f"bitwise, reference FD and analytic and bounce; {card}")
    rows["launches"] = launches
    return rows


def chain_world(levels: int):
    """A scene whose lists nest ``levels`` deep (tests/torch_util.py's
    chain_tree in a lit room): past the kernels' per-thread stack of
    tables.DEEP_LEVELS (16) it takes the DeepSpill view."""
    import math
    from raymarching_tpu_torch.scene import csg
    from raymarching_tpu_torch.scene.compile import compile_tree
    from raymarching_tpu_torch.scene.objects import Camera, Light
    node = csg.Sphere((0.0, -1.0, -6.0), 0.6, (0.9, 0.3, 0.2))
    for i in range(1, levels):
        if i % 2:
            a = 0.55 * i
            node = csg.ListNode(csg.Mode.UNION, [node, csg.Sphere(
                (1.8 * math.cos(a), 0.12 * i - 1.0, -6.0 + 1.8 * math.sin(a)),
                0.45, (0.2, 0.4 + 0.02 * i, 0.9))])
        else:
            node = csg.ListNode(csg.Mode.INTERSECTION, [node, csg.Box(
                (0.0, 0.0, -6.0), (8.0, 8.0, 8.0), (0.8, 0.8, 0.8))])
    tree = csg.ListNode(csg.Mode.UNION, [
        csg.bounds(40.0), csg.Box((0.0, -2.5, -6.0), (12.0, 0.5, 12.0),
                                  (0.9, 0.9, 0.9)), node])
    return compile_tree(tree, [Light((5.0, 8.0, 4.0)),
                               Light((-6.0, 5.0, 0.0))],
                        Camera(position=(0.0, 1.5, 3.0),
                               direction=(0.0, -0.3, -1.0)))


def cli_phase(dev, card: str, add_counts) -> dict:
    """[cli]: what the CLI and the server reach past one render, at full
    width, each path with the counts zeroed before it and read after it:
    the demo turntable (24 frames at 512x512 SSAA 2, 1000 iterations, 8
    poses a render_frames call), each frame of one batch bitwise
    render_tables at its pose and K1 on every 8th ray of the batch bitwise
    its twin; the demo through render_tiled at 1024x768 SSAA 3 (six
    blocks of 128 rows) bitwise the whole frame, block by block, with both
    peaks of device memory, and a 4096x4096 SSAA 3 tiled frame with its
    peak; the demo's mesh at --mesh-res 128 (2,097,152 points: K2's SD
    mode bitwise its twin, its times and bound, the marching tetrahedra
    apart); POST /animate as a GIF in process and the GIF encoder alone;
    --selfcheck through the CLI; the deep fold past its stack (chains of
    17 and 40 lists) and 300 AO taps, every entry bitwise its twin.
    Returns K2's SD row of the JSON table."""
    import tempfile

    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch import cli
    from raymarching_tpu_torch.api import (render_frames, render_tiled,
                                           turntable_frames, turntable_poses)
    from raymarching_tpu_torch.core import camera as cam
    from raymarching_tpu_torch.io import mesh as M
    from raymarching_tpu_torch.io.gif import encode_gif
    from raymarching_tpu_torch.ops import surface_kernel as sk
    from raymarching_tpu_torch.ops.render_kernel import (render_rays,
                                                         render_rays_plain)
    from raymarching_tpu_torch.serve import make_server
    from raymarching_tpu_torch.tables import (scene_operands, spill_levels,
                                              tables_to_torch)

    demo = rt.load_scene(str(DEMO))
    plan, tables = rt.compile_scene(demo)
    tt = tables_to_torch(tables, dev)

    # 1. the turntable: 3 render_frames calls of 8 poses, one K1 each
    cfg = rt.RenderConfig(width=512, height=512, ssaa=2, iterations=1000)
    list(turntable_frames(plan, tt, cfg, 8, device=dev))    # warm-up
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = list(turntable_frames(plan, tt, cfg, 24, device=dev))
    turn_s = time.perf_counter() - t0
    counts = add_counts("turntable", 3)
    check(counts == only(render_kernel=3), f"the turntable launched {counts}")
    check(len(frames) == 24 and all(np.isfinite(f).all() for f in frames),
          "turntable frames")
    ps, ds = (np.stack(x) for x in zip(*turntable_poses(tt, 24)[:8]))
    batch, batch_ms = timed(lambda: render_frames(plan, tt, cfg, ps, ds,
                                                  device=dev), runs=3)
    f32 = dict(dtype=torch.float32, device=dev)
    origins, dirs = [], []
    for i in range(8):
        pose = tt._replace(cam_position=torch.as_tensor(ps[i], **f32),
                           cam_direction=torch.as_tensor(ds[i], **f32))
        check(torch.equal(batch[i], rt.render_tables(plan, pose, cfg,
                                                     device=dev)),
              f"render_frames frame {i} differs from render_tables")
        check(np.array_equal(frames[i], batch[i].cpu().numpy()),
              f"turntable frame {i} differs from its batch")
        o, d = cam.generate_rays(pose, cfg)
        origins.append(o.expand(cfg.rays_per_image, 3)[::BIG_STRIDE])
        dirs.append(d.reshape(-1, 3)[::BIG_STRIDE])
    o8, d8 = torch.cat(origins).contiguous(), torch.cat(dirs).contiguous()
    same("K1 on every 8th ray of a render_frames batch",
         tuple(render_rays(plan, cfg, tt, o8, d8)),
         tuple(render_rays_plain(plan, cfg, tt, o8, d8)), "render_kernel")
    del batch, o8, d8, origins, dirs
    print(f"[cli] turntable: demo 24 frames 512x512 ssaa2 1000 it, 8 poses "
          f"({8 * cfg.rays_per_image} rays) a render_frames call: "
          f"{turn_s:.3f} s with the frames' copies to the host "
          f"({24 * cfg.rays_per_image / turn_s / 1e6:.1f} Mrays/s); one "
          f"8-pose render_frames call {batch_ms:.3f} ms; launches K1 3 "
          f"(one a call); each frame of a batch = render_tables at its pose "
          f"bitwise, K1 on every {BIG_STRIDE}th ray of the batch "
          f"({8 * cfg.rays_per_image // BIG_STRIDE} rays, an origin a ray) "
          f"= its twin bitwise; {card}")

    # 2. tiled: the reference frame in six blocks of 128 rows, then 4096^2
    big = rt.RenderConfig()
    peaks = {}

    def peak_of(what, fn, path, launches):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        out, ms = timed(fn)
        counts = add_counts(path, 1)
        check(counts == only(render_kernel=launches),
              f"{what} launched {counts}")
        peaks[what] = (torch.cuda.max_memory_allocated() - base, ms)
        return out

    tiled = peak_of("tiled 1024x768 ssaa3", lambda: render_tiled(
        plan, tt, big, row_block=128, device=dev), "tiled", 6)
    whole = peak_of("whole 1024x768 ssaa3", lambda: rt.render_tables(
        plan, tt, big, device=dev).cpu().numpy(), "whole", 1)
    for r in range(0, big.height, 128):
        check(np.array_equal(tiled[r:r + 128], whole[r:r + 128]),
              f"tiled block of rows {r}..{r + 127} differs from the frame")
    huge = big.replace(width=4096, height=4096)
    img = peak_of("tiled 4096x4096 ssaa3", lambda: render_tiled(
        plan, tt, huge, row_block=128, device=dev), "tiled_4096", 32)
    check(img.shape == (4096, 4096, 3) and bool(np.isfinite(img).all())
          and has_demo_objects(torch.from_numpy(img)), "4096^2 tiled frame")
    del img, tiled, whole
    print("[cli] tiled: demo 1024x768 ssaa3 in 6 blocks of 128 rows = the "
          "whole frame bitwise, block by block (max_abs_err 0.0); "
          + "; ".join(f"{k} {ms:.1f} ms, peak {b / 2**20:.1f} MiB"
                      for k, (b, ms) in peaks.items())
          + f" ({huge.rays_per_image} rays, K1 32 launches); {card}")

    # 3. the mesh at --mesh-res 128: K2's SD mode on 2,097,152 points
    lo, hi = M.default_bounds(plan, tables)
    res = 128
    pts = torch.from_numpy(M.grid_points(lo, hi, res)).to(dev)
    N = pts.shape[0]
    k2 = sk.surface_eval(plan, tt, pts, mode=sk.SD)
    plain, plain_ms, count = timed_counted(
        lambda: sk.surface_eval_plain(plan, tt, pts, mode=sk.SD))
    same("K2 SD mode on the mesh grid", k2, plain, "surface_kernel")
    del plain
    sd_ms = timed(lambda: sk.surface_eval(plan, tt, pts, mode=sk.SD),
                  runs=5)[1]
    sd_dev = device_ms(lambda: sk.surface_eval(plan, tt, pts, mode=sk.SD),
                       "surface_kernel")
    sd_bound = bound_ms(count, 16 * N)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = M.sample_sdf_grid(plan, tt, lo, hi, res, device=dev)
    grid_s = time.perf_counter() - t0
    counts = add_counts("mesh", 1)
    check(counts == only(surface_kernel=8), f"the mesh grid launched "
          f"{counts}")
    check(np.array_equal(grid.reshape(-1), k2[0].cpu().numpy()),
          "the chunked grid differs from one launch")
    t0 = time.perf_counter()
    verts, faces = M.marching_tetrahedra(grid, lo, (hi - lo) / (res - 1))
    mt_s = time.perf_counter() - t0
    check(len(faces) > 10000 and bool(np.isfinite(verts).all()),
          "the demo's mesh")
    print(f"[cli] mesh: demo --mesh-res {res} ({N} points): K2's SD mode = "
          f"its twin bitwise, {sd_ms:.3f} ms with its wrapper, device "
          f"{sd_dev:.4f} ms, twin {plain_ms:.1f} ms, bound {sd_bound[0]:.4f}"
          f" ms by {sd_bound[1]} ({sd_bound[5]} operations, {16 * N} bytes);"
          f" sample_sdf_grid {grid_s * 1e3:.1f} ms in 8 launches of 2^18 "
          f"points (host copies included); marching tetrahedra "
          f"{mt_s * 1e3:.1f} ms on the host ({len(verts)} vertices, "
          f"{len(faces)} triangles); {card}")
    del pts, k2

    # 4. POST /animate as a GIF in process, and the encoder alone
    srv = make_server("127.0.0.1", 0, dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = (f"http://127.0.0.1:{srv.server_address[1]}/animate?width=256"
               "&height=256&ssaa=2&frames=24&format=gif")
        body = DEMO.read_bytes()
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            r.read()                                     # warm-up
        zero_counts()
        t0 = time.perf_counter()
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            gif = r.read()
        animate_s = time.perf_counter() - t0
        counts = add_counts("animate", 1)
        check(counts == only(render_kernel=3), f"/animate launched {counts}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    acfg = rt.RenderConfig(width=256, height=256, ssaa=2,
                           serve_raygen=True)
    u8 = [rt.to_uint8(f) for f in turntable_frames(plan, tt, acfg, 24,
                                                   device=dev)]
    t0 = time.perf_counter()
    data = encode_gif(u8, delay_cs=4)
    gif_s = time.perf_counter() - t0
    check(gif == data and gif[:6] == b"GIF89a", "/animate's GIF differs "
          "from the encoder's on the turntable's frames")
    print(f"[cli] /animate: demo 24 frames 256x256 ssaa2 as a GIF "
          f"({len(gif)} bytes) in {animate_s:.3f} s in process, K1 3 "
          f"launches; the GIF encoder alone {gif_s:.3f} s on the host "
          f"({24 * 256 * 256 / gif_s / 1e6:.2f} Mpx/s, pure Python); "
          f"{card}")

    # 5. --selfcheck through the CLI on the card
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        rc = cli.main(["--scene", str(DEMO), "--selfcheck", "--out",
                       str(Path(tmp) / "selfcheck.png"), "--width", "256",
                       "--height", "192", "--ssaa", "1", "--device", "cuda"])
    check(rc == 0, f"--selfcheck exited {rc}")
    counts = add_counts("selfcheck", 1)
    check(counts == only(render_kernel=4), f"--selfcheck launched {counts}")

    # 6. the deep fold past its stack, and 300 AO taps ([deep]'s shape)
    small = rt.RenderConfig(width=32, height=24, ssaa=1, iterations=50)
    n_cmp = 0
    for levels in (17, 40):
        cplan, ctables = chain_world(levels)
        ctt = tables_to_torch(ctables, dev)
        ops = scene_operands(cplan, ctt, dev)
        check(ops.spill == 1 and spill_levels(cplan) == levels - 16,
              f"the {levels}-list chain is not the spill view")
        n_cmp += view_compare(cplan, ctt, small, False, True,
                              f"chain of {levels} lists")
    n_cmp += view_compare(plan, tt, small, False, True, "demo 300 AO taps",
                          taps=300)
    print(f"[cli] --selfcheck on the card: exit 0, K1 4 launches (rerun x2, "
          f"oracle, the frame); chains of 17 and 40 nested lists (the "
          f"DeepSpill view, 1 and 24 levels past the stack) and the demo "
          f"with 300 AO taps: every entry = its twin bitwise ({n_cmp} "
          f"comparisons at {small.width}x{small.height}); {card}")
    return {"ms": sd_ms, "device_ms": sd_dev, "plain_ms": plain_ms,
            "bound": sd_bound, "points": N}


# [oracle]: the demo at this footprint through the differentiable ref oracle
ORACLE_CFG = dict(width=64, height=48, ssaa=1, iterations=200)
# implicit-function against unrolled gradients: tests/test_grad.py:55
IFT_RTOL, IFT_ATOL_SCALE = 0.08, 0.02
# [shard] world 2 against one process: the same per-ray terms, their
# float32 partial sums added in the all-reduce
SHARD_RTOL, SHARD_ATOL_SCALE = 1e-4, 1e-5
# [shard]: the bundle of three posed views for render_rays_sharded (an odd
# number of rays, 3 x 211 x 97), and the world-2 spawn's time limit, all
# its ranks together
SHARD_RAYS_CFG = dict(width=211, height=97, ssaa=1, iterations=1000)
SHARD_WORLD_TIMEOUT_S = 300


def oracle_grads(plan, tables, cfg, backend: str, device):
    """(image, gradients of the MSE against grey for every field) of
    ``render_tables(backend=..., differentiable=True)`` on ``device``."""
    from raymarching_tpu_torch.api import render_tables
    from raymarching_tpu_torch.tables import tables_to_torch
    tt = tables_to_torch(tables, device, requires_grad=type(tables)._fields)
    img = render_tables(plan, tt, cfg, backend=backend, differentiable=True,
                        device=device)
    g = torch.autograd.grad(torch.mean((img - 0.25) ** 2), list(tt),
                            allow_unused=True, materialize_grads=True)
    return img.detach(), [v.cpu() for v in g]


def ref_ray_grads(plan, tables, cfg, device, origin, dirs):
    """Gradients of the MSE against grey of the unrolled ref oracle's
    colours of rays (origin, dirs) made once on the CPU, for every field
    and the rays (``core.render.shade_rays(differentiable=True)``)."""
    from raymarching_tpu_torch.core.render import shade_rays
    from raymarching_tpu_torch.tables import tables_to_torch
    tt = tables_to_torch(tables, device, requires_grad=type(tables)._fields)
    o = origin.to(device).requires_grad_()
    d = dirs.to(device).requires_grad_()
    colors = shade_rays(plan, tt, cfg, o, d, differentiable=True)
    g = torch.autograd.grad(torch.mean((colors - 0.25) ** 2), [*tt, o, d],
                            allow_unused=True, materialize_grads=True)
    return [v.cpu() for v in g]


def oracle_phase(dev, card: str) -> None:
    """[oracle]: the port's two plain gradient oracles on the card (the
    unrolled ``ref`` with ``differentiable=True`` and the ``torch``
    backend's implicit-function march) against each other, the fused
    backend and the CPU."""
    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch.api import render_tables
    from raymarching_tpu_torch.tables import tables_to_torch
    plan, tables = rt.compile_scene(rt.load_scene(str(DEMO)))
    fields = type(tables)._fields
    cfg = rt.RenderConfig(**ORACLE_CFG)
    fwd = render_tables(plan, tables, cfg, backend="ref", device=dev)
    ms = {}
    g = {}
    for backend in ("ref", "cuda", "torch"):
        (img, g[backend]), ms[backend] = timed(lambda: oracle_grads(
            plan, tables, cfg, backend, dev))
        if backend != "cuda":
            check(torch.equal(img, fwd), f"the differentiable {backend} "
                  "image differs from the forward ref image")
    w_cuda = grad_check(fields, g["ref"], g["cuda"], "ref vs cuda",
                        IFT_RTOL, IFT_ATOL_SCALE)
    w_torch = grad_check(fields, g["torch"], g["ref"], "torch vs ref",
                         IFT_RTOL, IFT_ATOL_SCALE)
    # the same rays on both sides (compare-bwd's note)
    rays = rays_for(plan, tables_to_torch(tables, "cpu"), cfg)
    g_card = ref_ray_grads(plan, tables, cfg, dev, *rays)
    c0 = time.perf_counter()
    g_cpu = ref_ray_grads(plan, tables, cfg, torch.device("cpu"), *rays)
    cpu_s = time.perf_counter() - c0
    w_cpu = grad_check(fields + ("origin", "dirs"), g_card, g_cpu,
                       "ref card vs CPU")
    print(f"[oracle] demo {cfg.width}x{cfg.height} ssaa{cfg.ssaa} "
          f"{cfg.iterations} it: render_tables(backend='ref', "
          f"differentiable=True) image = the forward ref image bitwise, "
          f"and so is backend='torch''s; gradients of the MSE against grey, "
          f"every field: ref vs cuda max |diff| / field scale "
          f"{w_cuda[0]:.3g} ({w_cuda[1]}), torch vs ref {w_torch[0]:.3g} "
          f"({w_torch[1]}) (tolerance rtol {IFT_RTOL}, atol "
          f"{IFT_ATOL_SCALE} x scale); ref card vs CPU on the same rays, "
          f"every field and the rays, {w_cpu[0]:.3g} ({w_cpu[1]}; rtol "
          f"{GRAD_RTOL}, atol {GRAD_ATOL_SCALE} x scale); forward + "
          f"backward ms on the card: ref {ms['ref']:.1f}, torch "
          f"{ms['torch']:.1f}, cuda {ms['cuda']:.1f}; ref on the CPU "
          f"{cpu_s:.1f} s; {card}")


def shard_world(world: int, dev) -> dict:
    """Every [shard] check one rank of a process group of ``world`` ranks
    makes at the bench footprint (the demo at 512x512 SSAA 2, 1000
    iterations, backend cuda, FD normals), each path's launches counted
    from 0 just before it and read just after it; one process's results
    are computed on the same rank outside those windows.  Returns what the
    rank saw, for the cross-rank checks and the report."""
    import torch.distributed as dist

    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch.api import (render_rays, render_tables,
                                           render_tiled,
                                           render_tiled_multihost,
                                           turntable_poses)
    from raymarching_tpu_torch.core import camera as cam
    from raymarching_tpu_torch.parallel import distributed as D
    from raymarching_tpu_torch.parallel import sharded as S
    from raymarching_tpu_torch.tables import tables_to_torch
    plan, tables = rt.compile_scene(rt.load_scene(str(DEMO)))
    fields = type(tables)._fields
    cfg = rt.RenderConfig(width=512, height=512, ssaa=2, iterations=1000)
    big = rt.RenderConfig()
    target = render_tables(plan, tables, cfg, device=dev)
    start = perturbed_demo(tables)[0]
    mesh = S.make_mesh()
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "paths": {}}

    def counted(path: str, calls: int):
        out["paths"][path] = (calls, launch_counts())

    # frames: one K1 launch a band
    zero_counts()
    band = S.render_sharded(plan, tables, cfg, mesh, backend="cuda")
    band, out["frame_ms"] = timed(lambda: S.render_sharded(
        plan, tables, cfg, mesh, backend="cuda"), runs=3)
    counted("frame", 4)
    check(out["paths"]["frame"][1] == only(render_kernel=4),
          f"4 sharded frames launched {out['paths']['frame'][1]}")
    frame = D.gather_image(band, mesh)
    whole = render_tables(plan, tables, cfg, device=dev).cpu().numpy()
    check(np.array_equal(frame, whole), "the gathered bands differ from "
          "the single-process frame")
    # steps: one K1 and one K2 launch a step, one all-reduce a backward
    zero_counts()
    calls0 = S.all_reduce_grads.calls
    S.loss_and_grads(plan, start, target, cfg, mesh, "cuda")
    (loss, grads), out["step_ms"] = timed(lambda: S.loss_and_grads(
        plan, start, target, cfg, mesh, "cuda"), runs=3)
    counted("step", 4)
    check(out["paths"]["step"][1] == only(render_kernel=4, surface_kernel=4),
          f"4 sharded steps launched {out['paths']['step'][1]}")
    check(S.all_reduce_grads.calls - calls0 == 4,
          f"{S.all_reduce_grads.calls - calls0} all-reduces in 4 steps")
    out["bytes"] = S.all_reduce_grads.bytes
    check(out["bytes"] == 4 * sum(np.asarray(v).size for v in tables),
          f"the all-reduce carried {out['bytes']} bytes")
    tt = tables_to_torch(start, dev, requires_grad=fields)
    img = render_tables(plan, tt, cfg, differentiable=True, device=dev)
    want = torch.autograd.grad(torch.mean((img - target) ** 2), list(tt),
                               allow_unused=True, materialize_grads=True)
    got = [v.cpu() for v in grads]
    want = [v.cpu() for v in want]
    if world == 1:
        for f, a, b in zip(fields, got, want):
            check(torch.equal(a, b), f"world 1: the {f} gradient differs "
                  "from the single-process step's")
        out["grad_err"] = (0.0, "")
    else:
        out["grad_err"] = grad_check(fields, got, want,
                                     f"world {world} vs one process",
                                     SHARD_RTOL, SHARD_ATOL_SCALE)
    lr = 1e-2
    zero_counts()
    _, stepped = S.train_step(plan, start, target, cfg, mesh, lr=lr,
                              backend="cuda")
    counted("train_step", 1)
    st = tables_to_torch(start, dev)
    for f, a, b, gg in zip(fields, stepped, st, grads):
        check(torch.equal(a, b - lr * gg), f"train_step's {f} is not "
              "tables - lr x its gradient")
    buf = torch.zeros(out["bytes"] // 4, device=dev)
    _, out["allreduce_ms"] = timed(lambda: dist.all_reduce(buf), runs=21)
    # three Adam steps of fit(mesh=)
    zero_counts()
    res = rt.fit(plan, start, target, cfg, device=dev, steps=3,
                 trainable=TRAINABLE, optimizer=adam, mesh=mesh)
    counted("fit", 3)
    check(out["paths"]["fit"][1] == only(render_kernel=3, surface_kernel=3),
          f"3 fit(mesh=) steps launched {out['paths']['fit'][1]}")
    out["fit"] = [np.asarray(getattr(res.tables, f).cpu()) for f in fields]
    out["fit_losses"] = res.losses
    if world == 1:
        one = rt.fit(plan, start, target, cfg, device=dev, steps=3,
                     trainable=TRAINABLE, optimizer=adam)
        for f, a in zip(fields, out["fit"]):
            check(np.array_equal(a, np.asarray(getattr(one.tables, f).cpu())),
                  f"world 1: fit(mesh=)'s {f} differs from fit()'s")
    # the tiled frame, each rank its band of rows (6 blocks of 128 in all)
    zero_counts()
    tiled, out["tiled_ms"] = timed(lambda: render_tiled_multihost(
        plan, tables, big, device=dev))
    counted("tiled", 1)
    check(out["paths"]["tiled"][1] == only(render_kernel=6 // world),
          f"render_tiled_multihost launched {out['paths']['tiled'][1]}")
    check(np.array_equal(tiled, render_tiled(plan, tables, big, device=dev)),
          "render_tiled_multihost differs from render_tiled")
    # an odd-sized bundle of three posed views
    rcfg = rt.RenderConfig(**SHARD_RAYS_CFG)
    tt0 = tables_to_torch(tables, dev)
    origins, dirs = [], []
    for pos, d in turntable_poses(tables, 3):
        o, dd = cam.generate_rays(tt0._replace(
            cam_position=torch.as_tensor(pos, device=dev),
            cam_direction=torch.as_tensor(d, device=dev)), rcfg)
        dirs.append(dd.reshape(-1, 3))
        origins.append(o.expand(dirs[-1].shape))
    origins, dirs = torch.cat(origins), torch.cat(dirs)
    check(dirs.shape[0] % 2 == 1, "the bundle is not odd-sized")
    zero_counts()
    colors = S.render_rays_sharded(plan, tables, origins, dirs, rcfg, mesh)
    counted("rays", 1)
    check(out["paths"]["rays"][1] == only(render_kernel=1),
          f"render_rays_sharded launched {out['paths']['rays'][1]}")
    check(torch.equal(colors, render_rays(plan, tables, origins, dirs, rcfg,
                                          device=dev)),
          "render_rays_sharded differs from render_rays")
    out["rays"] = dirs.shape[0]
    out["frame"] = frame
    return out


def shard_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    """One spawned rank of the [shard] phase's gloo world: joins the group
    on the one card and writes ``shard_world``'s results; any failure is
    an uncaught exception and a non-zero exit."""
    import torch.distributed as dist

    from raymarching_tpu_torch.parallel import distributed as D
    # a share of the host's cores each: the ranks' plain references would
    # otherwise spin against each other
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    D.initialize(init, world, rank, backend="gloo", device="cuda")
    try:
        res = shard_world(world, torch.device("cuda",
                                              torch.cuda.current_device()))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(res, str(Path(out_dir) / f"rank{rank}.pt"))


def shard_phase(dev, card: str, add_counts) -> dict:
    """[shard]: the demo rendered and fitted with its rows split over a
    torch.distributed process group, world 1 over NCCL in this process,
    then world 2 over gloo in two spawned processes on the one card.
    Returns K1's and K2's launches on its paths, by world and rank."""
    import multiprocessing
    import tempfile

    import torch.distributed as dist

    from raymarching_tpu_torch.parallel import distributed as D
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        D.initialize(f"file://{tmp}/rendezvous-1", 1, 0, backend="nccl",
                     device="cuda")
        try:
            check(dist.get_backend() == "nccl", "world 1 is not on NCCL")
            w1 = shard_world(1, dev)
        finally:
            dist.destroy_process_group()
        for path, (calls, counts) in w1["paths"].items():
            add_counts(f"shard_w1_{path}", calls, counts)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=shard_rank, args=(
            r, 2, f"file://{tmp}/rendezvous-2", tmp)) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARD_WORLD_TIMEOUT_S
        try:
            for r, p in enumerate(procs):
                p.join(max(deadline - time.monotonic(), 0.0))
                check(p.exitcode == 0, f"[shard] world 2 rank {r} ended with "
                      f"exit code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        w2 = [torch.load(str(Path(tmp) / f"rank{r}.pt"), weights_only=False)
              for r in range(2)]
    for r, res in enumerate(w2):
        check(res["backend"] == "gloo" and res["rank"] == r,
              f"world 2 rank {r}: {res['backend']}, rank {res['rank']}")
        check(np.array_equal(res["frame"], w1["frame"]),
              f"world 2 rank {r}'s gathered frame differs from world 1's")
        for a, b in zip(res["fit"], w2[0]["fit"]):
            check(np.array_equal(a, b), "world 2: the ranks' tables differ "
                  "after fit(mesh=)")
        check(res["fit_losses"] == w2[0]["fit_losses"],
              "world 2: the ranks' fit losses differ")
    for world, ranks in ((1, [w1]), (2, w2)):
        for res in ranks:
            per = "; ".join(
                f"{k} {res['paths'][k][1]['render_kernel']} K1, "
                f"{res['paths'][k][1]['surface_kernel']} K2 in "
                f"{res['paths'][k][0]}" for k in res["paths"])
            print(f"[shard] world {world} ({res['backend']}) rank "
                  f"{res['rank']}: demo 512x512 ssaa2 1000 it, backend cuda, "
                  f"FD: band of {512 // world} rows {res['frame_ms']:.3f} ms, "
                  f"step (fwd + bwd + all-reduce) {res['step_ms']:.3f} ms, "
                  f"the all-reduce {res['allreduce_ms']:.3f} ms for "
                  f"{res['bytes']} bytes (CUDA events); gradients against "
                  f"one process's: "
                  + ("bitwise" if world == 1 else
                     f"max |diff| / field scale {res['grad_err'][0]:.3g} "
                     f"({res['grad_err'][1]}; rtol {SHARD_RTOL}, atol "
                     f"{SHARD_ATOL_SCALE} x scale)")
                  + f"; tiled 1024x768 ssaa3 {res['tiled_ms']:.1f} ms; "
                  f"launches: {per}; {card}")
    print(f"[shard] gathered bands = the single-process frame bitwise in "
          f"both worlds; 3 fit(mesh=) Adam steps: ranks' tables bitwise "
          f"equal (world 1: = fit()'s); render_tiled_multihost 1024x768 "
          f"ssaa3 = render_tiled; render_rays_sharded on {w1['rays']} rays "
          f"of three posed views = render_rays, bitwise")
    for k in ("render_kernel", "surface_kernel"):
        report[k] = {f"world_{world}_{res['backend']}_rank_{res['rank']}": {
            path: c[k] for path, (_, c) in res["paths"].items()}
            for world, ranks in ((1, [w1]), (2, w2)) for res in ranks}
    return report


# [examples]: each example of raymarching_tpu_torch.examples, its main at
# its own defaults: (label, module name, arguments)
EXAMPLE_RUNS = (("fit_scene", "fit_scene", ()),
                ("fit_multiview", "fit_multiview", ()),
                ("fit_multiview --fit-poses", "fit_multiview",
                 ("--fit-poses",)),
                ("fit_fractal", "fit_fractal", ()),
                ("turntable", "turntable", ()))
# the scenes [native] parses: the demo, the deep sponge, a fractal leaf and
# coloured lights
NATIVE_SCENES = ("demo", "menger4", "julia", "mirror")


def native_phase(card: str) -> None:
    """[native]: the native host runtime (raymarching_tpu_torch.native):
    g++ builds native/raymarch_host.cpp into a temporary directory, which
    is loaded for this phase only, so the checkout's build/native/ and
    save_image's writer stay as they were; its parser and flattener on
    NATIVE_SCENES against the port's compile_scene (the tables, procedural
    entries and groups), with both parse times; one demo frame written
    through its PNG writer and through io.png, both decoded to the same
    pixels, with both writers' times."""
    import tempfile

    from raymarching_tpu_torch import native

    saved = native._LIB
    try:
        with tempfile.TemporaryDirectory() as tmp:
            native_checks(card, native, Path(tmp))
    finally:
        native._LIB = saved


def native_checks(card: str, native, out: Path) -> None:
    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch.io import png
    from raymarching_tpu_torch.io.image import to_uint8
    from raymarching_tpu_torch.scene.parser import parse_scene

    t0 = time.perf_counter()
    path = native.build(out)
    build_s = time.perf_counter() - t0
    check(native.load_library(path) is not None, f"{path} did not load")
    rows = []
    for name in NATIVE_SCENES:
        text = (ROOT / "scenes" / f"{name}.txt").read_text()
        c0 = time.perf_counter()
        res = native.native_parse_scene(text)
        c1 = time.perf_counter()
        scene = parse_scene(text)
        plan, tables = rt.compile_scene(scene)
        c2 = time.perf_counter()
        n_l = len(scene.lights)
        check(np.array_equal(res["prim_type"], np.asarray(plan.prim_type))
              and np.allclose(res["prim_pos"], tables.prim_pos, rtol=2e-6,
                              atol=1e-5)
              and np.allclose(res["prim_aux"], tables.prim_aux, rtol=2e-6,
                              atol=0)
              and np.array_equal(res["prim_color"], tables.prim_color)
              and np.array_equal(res["lights"], tables.light_pos[:n_l])
              and np.array_equal(res["light_colors"],
                                 tables.light_color[:n_l])
              and np.array_equal(res["camera"], np.concatenate([
                  tables.cam_position, tables.cam_direction, tables.cam_up,
                  [tables.cam_fov]]).astype(np.float32))
              and res["proc"] == plan.proc,
              f"{name}: the native tables differ from compile_scene's")
        kp = plan.kernel
        check(kp is not None and [tuple(m) for m in res["group_meta"]] == [
            (g.gsign, g.count) for g in kp.groups] and np.array_equal(
            res["prim_scale"], np.concatenate(
                [np.asarray(g.scales, np.float32) for g in kp.groups])),
            f"{name}: the native groups differ from the kernel plan's")
        rows.append(f"{name} {res['prim_type'].shape[0]} leaves "
                    f"{(c1 - c0) * 1e3:.2f} ms (Python {(c2 - c1) * 1e3:.1f} "
                    f"ms)")
    dev = torch.device("cuda")
    img = to_uint8(rt.render(rt.load_scene(str(DEMO)), rt.RenderConfig(
        width=512, height=384, ssaa=2, iterations=1000),
        device=dev).cpu().numpy())
    w0 = time.perf_counter()
    check(native.native_write_png(str(out / "frame_native.png"), img),
          "the native PNG writer failed")
    w1 = time.perf_counter()
    png.write_png(str(out / "frame_python.png"), img)
    w2 = time.perf_counter()
    a, b = (png.read_png(str(out / f"frame_{w}.png"))
            for w in ("native", "python"))
    check(np.array_equal(a, b) and np.array_equal(a[..., :3], img),
          "the two PNG writers' pixels differ")
    print(f"[native] {path.name} built into a temporary directory by "
          f"{shutil.which(native.CXX)} in {build_s:.1f} s (CXX in the "
          f"environment: {os.environ.get('CXX')!r}); parse + flatten = "
          f"compile_scene's tables, procedural entries and groups: "
          + "; ".join(rows) + f"; a 512x384 demo frame "
          f"through the native PNG writer {(w1 - w0) * 1e3:.1f} ms "
          f"({(out / 'frame_native.png').stat().st_size} bytes) and "
          f"io.png {(w2 - w1) * 1e3:.1f} ms "
          f"({(out / 'frame_python.png').stat().st_size} bytes), both "
          f"decoded to the same pixels; {card}")


def examples_phase(dev, card: str, add_counts) -> dict:
    """[examples]: each example of raymarching_tpu_torch.examples through
    its main at its own defaults (full width, full step counts) on the
    card, into a temporary directory, its printed lines echoed: the fits'
    loss reductions and parameter errors (fit_scene's from its checkpoint),
    both fit_multiview modes passing their own asserts, the turntable's 24
    frames and steady time a frame; each run's launches (a step: K1 1, K2
    0, or in fit_fractal's analytic fractal backward 1 a slice of rays; a
    turntable frame: K1 1); then K1 on one step's rays of each fit
    example (and one turntable frame) against its plain twin on every
    BIG_STRIDE-th ray, as the step launches it, bitwise.  Returns each
    example's launches by kernel."""
    import contextlib
    import importlib
    import tempfile

    from raymarching_tpu_torch.io.checkpoint import load_checkpoint
    from raymarching_tpu_torch.ops import scene_vjp
    from raymarching_tpu_torch.ops.render_kernel import (render_rays,
                                                         render_rays_plain)
    from raymarching_tpu_torch.tables import tables_to_torch

    mods = {name: importlib.import_module(
        f"raymarching_tpu_torch.examples.{name}")
        for _, name, _ in EXAMPLE_RUNS}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, name, argv in EXAMPLE_RUNS:
            mod = mods[name]
            plan, tables_true, tables0, cfg = mod.setup()
            out_dir = f"{tmp}/{name}"
            args = [*argv] + (["--out", out_dir] if name != "fit_multiview"
                              else [])
            buf = io.StringIO()
            zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(args)
            secs = time.perf_counter() - t0
            counts = add_counts(f"example {label}", 1)
            launches[label] = counts
            check(rc == 0, f"{label} exited {rc}")
            text = buf.getvalue()
            lines = text.strip().splitlines()
            if name == "turntable":
                frames = len(list(Path(out_dir).glob("frame_*.png")))
                check(frames == 24, f"the turntable wrote {frames} frames")
                want = only(render_kernel=24)
                steady = float(re.search(r"steady ([0-9.]+)s/frame",
                                         text).group(1))
                what = (f"24 frames, steady {steady * 1e3:.1f} ms a frame; "
                        f"launches a frame K1 {counts['render_kernel'] // 24}")
            else:
                steps = 120 if name == "fit_multiview" else 150
                renders = 1 if name == "fit_multiview" else 3
                R = cfg.rays_per_image * (4 if name == "fit_multiview"
                                          else 1)
                slices = -(-R // scene_vjp.REPLAY_RAYS)
                want = only(render_kernel=steps + renders,
                            surface_kernel=(steps * slices
                                            if plan.proc else 0))
                what = (f"{steps} steps, launches a step K1 1, K2 "
                        f"{counts['surface_kernel'] // steps} (and K1 "
                        f"{renders} a frame outside the steps)")
            check(counts == want, f"{label} launched {counts}, not {want}")
            if name in ("fit_scene", "fit_fractal"):
                m = re.search(r"^loss ([0-9.e+-]+) -> ([0-9.e+-]+)", text,
                              re.M)
                first, last = float(m.group(1)), float(m.group(2))
                check(last < first, f"{label}: loss {first} -> {last}")
            if name == "fit_multiview":
                # its own assert, and the same bound read from its line
                m = re.search(r"error ([0-9.]+) -> ([0-9.]+)", text)
                check(lines[-1] == "ok" and float(m.group(2))
                      < 0.5 * float(m.group(1)),
                      f"{label} did not pass its assert")
            if name == "fit_scene":
                # its parameters' errors, from the checkpoint it wrote
                fitted, step, _ = load_checkpoint(f"{out_dir}/ckpt.npz")
                check(step == steps, f"{label}: checkpoint step {step}")
                errs = []
                for f, rows_ in (("prim_pos", [2, 3]), ("prim_aux", [2, 3]),
                                 ("prim_color", [4]), ("light_pos", [0])):
                    truth = np.asarray(getattr(tables_true, f))[rows_]
                    e0 = np.abs(np.asarray(getattr(tables0, f))[rows_]
                                - truth).max()
                    e1 = np.abs(np.asarray(getattr(fitted, f))[rows_]
                                - truth).max()
                    errs.append(f"{f}{rows_} {e0:.4f} -> {e1:.4f}")
                lines.append("largest parameter errors (checkpoint): "
                             + ", ".join(errs))
            shown = [ln for ln in lines if not ln.startswith("step ")]
            print(f"[examples] {label}: {secs:.1f} s; {what}; "
                  + " | ".join(shown) + f"; {card}")
            # K1 as a step launches it on every BIG_STRIDE-th ray of the
            # step's rays (the turntable: its first frame's), bitwise
            sw = (cfg.normal_mode == "analytic" and not plan.proc
                  and name != "turntable")
            fc = (cfg if name == "turntable"
                  else cfg.replace(shade_skip_black=False))
            tt = tables_to_torch(tables0, dev)
            if name == "fit_multiview":
                views = mod.view_positions(4)
                if argv:
                    tt = tables_to_torch(tables_true, dev)
                    views = mod.perturbed_poses(views)
                    o, d = mod.bundle(tt, cfg, torch.as_tensor(
                        mod.CENTER, device=dev), torch.as_tensor(
                        views, device=dev))
                else:
                    rays = [mod.camera_rays(tt, cfg, p, mod.CENTER)
                            for p in views]
                    o = torch.cat([r[0] for r in rays])
                    d = torch.cat([r[1] for r in rays])
                o, d = o[::BIG_STRIDE], d[::BIG_STRIDE]
            else:
                o, d = rays_for(plan, tt, cfg)
                d = d[::BIG_STRIDE]
            extra = {} if name == "turntable" else dict(save_winner=sw,
                                                        save_factors=True)
            same(f"{label}: K1 on a step's rays (every {BIG_STRIDE}th)",
                 flat(render_rays(plan, fc, tt, o, d, **extra)),
                 flat(render_rays_plain(plan, fc, tt, o, d, **extra)),
                 "render_kernel")
    print(f"[examples] K1 on one step's rays of each fit example and on a "
          f"turntable frame (every {BIG_STRIDE}th ray, as the step launches "
          f"it: the factors and, without fractals, the winner residuals) = "
          f"its plain twin bitwise; {card}")
    return launches


def kernel_times() -> int:
    """``--times``: one line with the device times (torch.profiler, median
    of five launches) of K1 at 512x512 SSAA 2 and 1024x768 SSAA 3, of K3
    on the primary rays and on the slowest of them alone, of K4, of K2 on
    the 7-point stencils of the hits (and that call with its wrapper,
    CUDA events) and in its FD-gradient mode, of K1, K4 and K2 with
    analytic normals, of K1 and K4 with soft shadows and AO, K1's raygen
    entry, K1 on scenes/mirror.txt (coloured lights), and of K1 with the
    scene read from device memory, on the demo at 1,000 iterations; then
    K1 and K4 in both normals, K3 and K2's stencil entry on scatter1k.txt
    and menger4.txt (scan-order rays); then K1 and K2's stencil entry on a
    [shard] rank's band of 256 rows, K1 in render_frames (8 turntable
    poses) and K1's raygen entry in block order, a ``[times-bounds]`` line
    with their bounds and shares.  For holding two checkouts against
    each other on one card: run it from each in one command, in turns
    (parent, change, change, parent), copying this script into a checkout
    whose own lacks a row."""
    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch import tables as scene_tables
    from raymarching_tpu_torch.ops import march_kernel as mk
    from raymarching_tpu_torch.ops import scene_vjp
    from raymarching_tpu_torch.ops import shade_kernel as shk
    from raymarching_tpu_torch.ops import surface_kernel as sk
    from raymarching_tpu_torch.ops.render_kernel import (render_raygen,
                                                         render_rays)

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
    scfg = cfg.replace(soft_shadow_k=6.0, ao_strength=0.8)
    out["K1 512x512 ssaa2 soft + AO"] = device_ms(lambda: render_rays(
        plan, scfg, tt, origin, dirs), "render_kernel")
    out["K4 soft + AO"] = device_ms(lambda: shk.shade_rays(
        plan, scfg, tt, hit.position, hit.sd, dirs), "shade_kernel")
    out["K1 512x512 ssaa2 raygen"] = device_ms(lambda: render_raygen(
        plan, cfg, tt, 0, dirs.shape[0]), "render_kernel")
    # every extended entry with AO, the scene in shared and in device
    # memory: K1's extended (exact and fused), raygen and bounce entries,
    # K4's extended entry in both normals
    limit = scene_tables.SHARED_SCENE_BYTES
    bcfg = scfg.replace(reflect_strength=0.4, reflect_bounces=1)
    for where, nbytes in (("", limit), (", device memory", 0)):
        scene_tables.SHARED_SCENE_BYTES = nbytes
        try:
            out[f"K1 512x512 ssaa2 soft + AO fused{where}"] = device_ms(
                lambda: render_rays(plan, scfg.replace(
                    fused_generators=True), tt, origin, dirs),
                "render_kernel")
            out[f"K1 512x512 ssaa2 raygen soft + AO{where}"] = device_ms(
                lambda: render_raygen(plan, scfg, tt, 0, dirs.shape[0]),
                "render_kernel")
            out[f"K1 512x512 ssaa2 bounce soft + AO{where}"] = device_ms(
                lambda: render_rays(plan, bcfg, tt, origin, dirs),
                "render_kernel")
            out[f"K4 analytic soft + AO{where}"] = device_ms(
                lambda: shk.shade_rays(plan, scfg.replace(
                    normal_mode="analytic"), tt, hit.position, hit.sd,
                    dirs), "shade_kernel")
            if nbytes == 0:
                out[f"K1 512x512 ssaa2 soft + AO{where}"] = device_ms(
                    lambda: render_rays(plan, scfg, tt, origin, dirs),
                    "render_kernel")
                out[f"K4 soft + AO{where}"] = device_ms(
                    lambda: shk.shade_rays(plan, scfg, tt, hit.position,
                                           hit.sd, dirs), "shade_kernel")
        finally:
            scene_tables.SHARED_SCENE_BYTES = limit
    # a deep plan of the Deep view (three lists, the per-thread stack)
    dplan, dtables = rt.compile_scene(deep_demo(rt.load_scene(str(DEMO))))
    dtt = scene_tables.tables_to_torch(dtables, dev)
    d_org, d_dirs = rays_for(dplan, dtt, cfg)
    out["K1 512x512 ssaa2 deep demo"] = device_ms(lambda: render_rays(
        dplan, cfg, dtt, d_org, d_dirs), "render_kernel")
    del d_dirs
    mplan, mtables = rt.compile_scene(rt.load_scene(str(
        ROOT / "scenes" / "mirror.txt")))
    mtt = scene_tables.tables_to_torch(mtables, dev)
    m_org, m_dirs = rays_for(mplan, mtt, cfg)
    out["K1 512x512 ssaa2 mirror.txt coloured"] = device_ms(
        lambda: render_rays(mplan, cfg, mtt, m_org, m_dirs), "render_kernel")
    del m_dirs
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
    # the scenes of [cull] (scatter1k's chunks, menger4's sponge) on the
    # frame's rays in scan order
    for name in CULL_SCENES:
        cplan, ctables = rt.compile_scene(rt.load_scene(str(
            ROOT / "scenes" / f"{name}.txt")))
        ctt = scene_tables.tables_to_torch(ctables, dev)
        c_org, c_dirs = rays_for(cplan, ctt, cfg)
        chit = mk.march_rays(cplan, cfg, ctt, c_org, c_dirs)
        for label, c in (("", cfg), (" analytic", acfg)):
            out[f"K1 {name}{label}"] = device_ms(lambda: render_rays(
                cplan, c, ctt, c_org, c_dirs), "render_kernel")
            out[f"K4 {name}{label}"] = device_ms(lambda: shk.shade_rays(
                cplan, c, ctt, chit.position, chit.sd, c_dirs),
                "shade_kernel")
        out[f"K3 {name}"] = device_ms(lambda: mk.march_rays(
            cplan, cfg, ctt, c_org, c_dirs), "march_kernel")
        out[f"K2 {name} 7-point stencils"] = device_ms(
            lambda: scene_vjp.stencil_eval(cplan, cfg, ctt, chit.position,
                                           center=True), "surface_kernel")
        del c_dirs, chit
    # the paths whose kernels had no device time alone: K1 and K2's stencil
    # entry on a [shard] rank's band (world 2: the first 256 of 512 rows),
    # K1 in render_frames (8 turntable poses, an origin a ray) and K1's
    # raygen entry in block order (the served frame); each with its bound,
    # from the plain twin's count on every stride-th ray or hit
    from raymarching_tpu_torch.api import render_frames, turntable_poses
    from raymarching_tpu_torch.core import camera as cam
    from raymarching_tpu_torch.core.order import frame_blocks
    from raymarching_tpu_torch.ops.render_kernel import render_rays_plain
    bounds = {}
    band = cfg.height // 2
    b_org, b_dirs = cam.generate_rays(tt, cfg, (0, band))
    b_dirs = b_dirs.reshape(-1, 3)
    label = f"K1 [shard] world 2 band ({band} rows)"
    out[label] = device_ms(lambda: render_rays(plan, cfg, tt, b_org, b_dirs),
                           "render_kernel")
    bounds[label] = bound_ms(timed_counted(lambda: render_rays_plain(
        plan, cfg, tt, b_org, b_dirs[::8]))[2], b_dirs.shape[0] * (12 + 32),
        8)
    b_hit = render_rays(plan, cfg.replace(shade_skip_black=False), tt, b_org,
                        b_dirs).p
    label = f"K2 stencil entry [shard] band's {b_hit.shape[0]} hits"
    out[label] = device_ms(lambda: scene_vjp.stencil_eval(
        plan, cfg, tt, b_hit, center=True), "surface_kernel")
    bounds[label] = bound_ms(timed_counted(lambda: sk.surface_eval_plain(
        plan, tt, sk.stencil_points(b_hit, cfg.fd_h, center=True).reshape(
            -1, 3)))[2], b_hit.shape[0] * (12 + 7 * 20))
    del b_dirs, b_hit
    ps, ds = (np.stack(v) for v in zip(*turntable_poses(tables, 24)[:8]))
    label = "K1 in render_frames (8 poses)"
    out[label] = device_ms(lambda: render_frames(plan, tt, cfg, ps, ds,
                                                 device=dev), "render_kernel")
    f_org, f_dirs = [], []
    for p_, d_ in zip(ps, ds):
        o_, dd = cam.generate_rays(tt._replace(
            cam_position=torch.as_tensor(p_, device=dev),
            cam_direction=torch.as_tensor(d_, device=dev)), cfg)
        f_org.append(o_.expand(dd.numel() // 3, 3)[::64])
        f_dirs.append(dd.reshape(-1, 3)[::64])
    bounds[label] = bound_ms(timed_counted(lambda: render_rays_plain(
        plan, cfg, tt, torch.cat(f_org), torch.cat(f_dirs)))[2],
        8 * dirs.shape[0] * (24 + 32), 64)
    del f_org, f_dirs
    bds = frame_blocks(cfg, cfg.height, "cuda")
    label = f"K1 512x512 ssaa2 raygen, block order {bds}"
    out[label] = device_ms(lambda: render_raygen(
        plan, cfg, tt, 0, dirs.shape[0], block=bds), "render_kernel")
    bounds[label] = bound_ms(timed_counted(lambda: render_rays_plain(
        plan, cfg, tt, origin, dirs[::8]))[2], dirs.shape[0] * 32, 8)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[times-bounds] " + "; ".join(
        f"{k}: bound {b[0]:.4f} ms by {b[1]} ({b[5]} operations), share "
        f"{b[0] / out[k]:.1%}" for k, b in bounds.items())
        + f"; {smi.splitlines()[0]}")
    print(f"[times] {ROOT}: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in out.items())
          + f"; {smi.splitlines()[0]}")
    return 0


def ptxas_table() -> int:
    """``--ptxas``: build every source and print one tab-separated line an
    entry (source, entry as entry_label gives it, registers, stack frame
    bytes), for holding two checkouts' builds against each other entry for
    entry."""
    from raymarching_tpu_torch.ops import build
    for kname, (lib_path, _) in zip(SOURCES, build.build_all(SOURCES)):
        log = lib_path.with_suffix(".log").read_text()
        for e, r, st in ptxas_entries(log):
            print(f"{kname}\t{e}\t{r}\t{st}")
    return 0


def fused_fd_step() -> int:
    """``--fused-fd-step``: the fit step with fused generators and FD
    normals, whose backward replays the normal under autograd (no kernel
    launch), on the perturbed demo at 512x512 SSAA 2, 1000 iterations:
    the step median of 3 ``fit`` steps after one more (host clock), its
    split into forward, backward and optimizer (CUDA events, median of 3)
    and the backward's peak memory above the forward's (the largest of
    the 3).  For holding two checkouts against each other on one card:
    copy this script into each and run it from each in one command, in
    turns (parent, change, change, parent)."""
    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch.tables import tables_to_torch

    dev = torch.device("cuda")
    plan, tables = rt.compile_scene(rt.load_scene(str(DEMO)))
    cfg = rt.RenderConfig(width=512, height=512, ssaa=2, iterations=1000,
                          fused_generators=True)
    target = rt.render_tables(plan, tables, cfg, device=dev)
    start, _, _ = perturbed_demo(tables)
    stamps = []
    res = rt.fit(plan, start, target, cfg, device=dev, steps=1,
                 trainable=TRAINABLE, optimizer=adam)
    t0 = time.perf_counter()
    res = rt.fit(plan, res.tables, target, cfg, device=dev, steps=3,
                 trainable=TRAINABLE, optimizer=adam,
                 callback=lambda *a: stamps.append(time.perf_counter()))
    check(all(np.isfinite(res.losses)), f"losses {res.losses}")
    step = statistics.median(np.diff([t0] + stamps))
    tg = tables_to_torch(res.tables, dev, requires_grad=TRAINABLE)
    opt = adam([getattr(tg, f) for f in TRAINABLE])
    splits, peak = [], 0.0
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        img = rt.render_tables(plan, tg, cfg, differentiable=True,
                               device=dev)
        loss = torch.mean((img - target) ** 2)
        ev[1].record()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        peak = max(peak, (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd, bwd, opt_ms = (statistics.median(v) for v in zip(*splits))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[fused-fd-step] {ROOT}: demo {cfg.width}x{cfg.height} ssaa"
          f"{cfg.ssaa} {cfg.iterations} it, fused generators, FD normals, "
          f"3 Adam steps: loss {' '.join(f'{v:.6g}' for v in res.losses)}; "
          f"step median {step * 1e3:.1f} ms; split (median of 3, CUDA "
          f"events) forward {fwd:.2f} ms, backward {bwd:.2f} ms, optimizer "
          f"{opt_ms:.2f} ms; backward peak memory {peak:.2f} GiB above the "
          f"forward's; {smi.splitlines()[0]}")
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
    if sys.argv[1:] == ["--fused-fd-step"]:
        return fused_fd_step()
    if sys.argv[1:] == ["--ptxas"]:
        return ptxas_table()
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; expected none, "
              "--times, --fused-fd-step or --ptxas", file=sys.stderr)
        return 2
    phase("device")
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
    from raymarching_tpu_torch import tables as scene_tables
    from raymarching_tpu_torch.core import camera as cam
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

    phase("build")
    # 2. build: one nvcc per source, all started together in the
    # background; [compare] runs meanwhile, its first launch of a kernel
    # waiting for that kernel's own library (ops.build.build)
    check(set(SOURCES) == set(build.SOURCES),
          f"the package's sources {build.SOURCES}, this script's {SOURCES}")
    nvcc_pool = ThreadPoolExecutor(1)
    building = nvcc_pool.submit(build.build_all, SOURCES)
    t_build = time.perf_counter()

    phase("compare")
    # 3. kernels vs plain twins at small sizes, and the ref oracle (100
    # iterations: a twin marches a missing ray to the cap, a few launches
    # a step, so the cap bounds this part's time; each case prints the
    # share of rays that hit by it and by the main path's 1000)
    small = rt.RenderConfig(width=64, height=48, ssaa=2, iterations=100)
    cases = [(s, small) for s in ("demo", "config1", "config2", "config3",
                                  "config4")]
    cases.append(("menger4", small.replace(width=32, height=24, ssaa=1)))
    later = []   # K1's bounce entries, whose library builds last
    for scene, cfg in cases:
        plan, tables = rt.compile_scene(
            rt.load_scene(str(ROOT / "scenes" / f"{scene}.txt")))
        tt = tables_to_torch(tables, dev)
        rays = rays_for(plan, tt, cfg)
        worst = compare(plan, cfg, tt, *rays)[0]
        print(f"[compare] {scene} {cfg.width}x{cfg.height} ssaa{cfg.ssaa}: "
              + ", ".join(f"{k} {v:.6g}" for k, v in worst.items())
              + "; " + hit_shares(plan, cfg, tt, *rays))
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
              f"{int(ops.flag[0].item())}); K1, K3, K4, K2 on "
              f"{compare_ragged(plan, cfg, tt, *rays)} rays with per-ray "
              f"origins = the full launch's; scene {nbytes} bytes, read "
              f"from {'shared' if nbytes <= SHARED_SCENE_BYTES else 'device'}"
              " memory")
        if scene != "config1" and scene != "config2":
            later.append((scene, plan, cfg, tt, rays,
                          bounce_twins(plan, cfg, tt, *rays)))
        if scene == "demo":
            demo_ops = (plan, tt, nbytes)
    # the plain twins of the bounce comparisons on scenes/mirror.txt
    # (coloured lights) and the ref oracle's demo frame, while the bounce
    # entries' source builds
    mplan, mtables = rt.compile_scene(rt.load_scene(str(ROOT / "scenes" /
                                                        "mirror.txt")))
    mtt = tables_to_torch(mtables, dev)
    mrays = rays_for(mplan, mtt, small)
    mtwins = bounce_twins(mplan, small, mtt, *mrays)
    demo = rt.load_scene(str(DEMO))
    ref = rt.render_ref(demo, small, device=dev)
    t_wait = time.perf_counter()
    built = building.result()
    nvcc_pool.shutdown()
    print(f"[compare] before the build ended: {t_wait - t_build:.1f} s of "
          f"comparisons and twins; then {time.perf_counter() - t_wait:.1f} "
          f"s waiting for the last library")
    build_report(built)
    for scene, plan, cfg, tt, rays, twins in later:
        b_cmp = compare_bounce(plan, cfg, tt, *rays, twins)
        print(f"[compare] {scene}: K1's bounce entries = plain twins "
              f"bitwise on every output of every shade set ({b_cmp} "
              f"comparisons: B 1-3, FD and analytic, "
              f"{'exact and fused' if any(g_.fused is not None for g_ in plan.kernel.groups) else 'exact'}, "
              f"extensions off and soft + AO; 1, 31, 1000 and "
              f"{rays[1].shape[0] - 37} rays with per-ray origins = "
              f"the full launch's; the raygen bounce entry = its twin "
              f"and the bounce entry on its directions)")
    plan, tt, nbytes = demo_ops
    # 16 bytes cover the staged copy's alignment padding; K1 and K4
    # take a third argument, the normal (0 FD, 1 analytic)
    per_sm = {}
    f_bytes = scene_operands(plan, tt, dev, True, True).nbytes(
        plan.num_lights)
    for k in KERNELS:
        lib = build.load_library(k)
        # K1 and K4 (each source): (normal, fused); K1's raygen
        # entries (normal, fused, extended); K3: (fused); K2's
        # stencil entry: exact only
        nf = {"FD": (0, 0), "analytic": (1, 0), "fused FD": (0, 1),
              "fused analytic": (1, 1)}
        variants = {
            "render_kernel": nf, "render_ext_kernel": nf,
            "shade_kernel": nf, "shade_ext_kernel": nf,
            "render_raygen_kernel": {
                "FD": (0, 0, 0), "analytic": (1, 0, 0),
                "extended FD": (0, 0, 1),
                "extended analytic": (1, 0, 1)},
            "render_bounce_kernel": {
                "FD": (0, 0, 0), "analytic": (1, 0, 0),
                "fused analytic": (1, 1, 0), "raygen FD": (0, 0, 1),
                "raygen analytic": (1, 0, 1)},
            "march_kernel": {"": (0,), "fused": (1,)},
            "surface_kernel": {"": ()}}[k]
        for label, extra in variants.items():
            fz = extra[1] if len(extra) > 1 else sum(extra)
            staged = (f_bytes if fz else nbytes) + 16
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
    # K1's bounce entries on scenes/mirror.txt (coloured lights), and the
    # demo's scene read from device memory against staged
    b_cmp = compare_bounce(mplan, small, mtt, *mrays, mtwins)
    plan, tables = rt.compile_scene(rt.load_scene(str(DEMO)))
    tt = tables_to_torch(tables, dev)
    rays = rays_for(plan, tt, small)
    bc = small.replace(reflect_strength=0.4, reflect_bounces=2,
                       normal_mode="analytic", soft_shadow_k=6.0,
                       ao_strength=0.8)
    staged = flat(render_rays(plan, bc, tt, *rays, save_factors=True))
    limit = scene_tables.SHARED_SCENE_BYTES
    scene_tables.SHARED_SCENE_BYTES = 0
    try:
        same("K1 bounce, demo in device memory / staged", flat(render_rays(
            plan, bc, tt, *rays, save_factors=True)), staged)
    finally:
        scene_tables.SHARED_SCENE_BYTES = limit
    print(f"[compare] mirror.txt (coloured lights): K1's bounce entries = "
          f"plain twins bitwise ({b_cmp} comparisons, as above); demo B 2 "
          f"analytic soft + AO, scene in device memory = staged")
    fused = rt.render(demo, small, device=dev)
    ref_err = (fused - ref).abs().max().item()
    check(ref_err <= IMG_ATOL, f"demo vs ref oracle differs by {ref_err}")
    print(f"[compare] demo vs ref oracle {small.width}x{small.height} "
          f"ssaa{small.ssaa} {small.iterations} it: "
          f"image {ref_err:.6g}")

    phase("compare-bwd")
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

    phase("main")
    # 5. the main path: render() at the bench footprint and the reference's
    main_cfgs = [rt.RenderConfig(width=512, height=512, ssaa=2,
                                 iterations=1000), rt.RenderConfig()]
    # per path: (calls of its entry point between zero_counts() and the
    # reading, each kernel's launches in them)
    paths = {}

    def add_counts(path: str, calls: int, counts=None):
        # the launches since zero_counts(), or ``counts`` read by a path
        # that zeroed and read them itself
        counts = launch_counts() if counts is None else counts
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
    check(counts == only(render_kernel=4 * len(main_cfgs)),
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

    phase("train")
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
    check(counts == only(render_kernel=5, surface_kernel=5,
                         march_kernel=0, shade_kernel=0),
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
    segment_report(plan, tt, tcfg, dev, card)

    phase("multi")
    # 7. the multi-kernel backend at the same frame
    tt = tables_to_torch(tables, dev)
    origin, dirs = rays_for(plan, tt, tcfg)
    zero_counts()
    rt.render(demo, tcfg, backend="multi", device=dev)
    multi_img, multi_ms = timed(
        lambda: rt.render(demo, tcfg, backend="multi", device=dev), runs=3)
    counts = add_counts("multi", 4)
    L = plan.num_lights
    check(counts == only(render_kernel=0, surface_kernel=4 * 2,
                         march_kernel=4 * (1 + L), shade_kernel=0),
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

    phase("two-phase")
    # 8. the two-phase march of the fused backend
    cfg2 = tcfg.replace(two_phase_k1=48)
    zero_counts()
    rt.render(demo, cfg2, device=dev)
    tp_img, tp_ms = timed(lambda: rt.render(demo, cfg2, device=dev), runs=3)
    counts = add_counts("two_phase", 4)
    check(counts == only(render_kernel=0, surface_kernel=0,
                         march_kernel=4 * 2, shade_kernel=4),
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

    phase("train-multi")
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
    check(counts == only(render_kernel=0, surface_kernel=3 * 4,
                         march_kernel=3 * (1 + L), shade_kernel=0),
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

    phase("analytic")
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
    check(counts == only(render_kernel=8, surface_kernel=0,
                         march_kernel=0, shade_kernel=0),
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
    check(counts == only(render_kernel=3, surface_kernel=0,
                         march_kernel=0, shade_kernel=0),
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
    check(counts == only(render_kernel=0, surface_kernel=4 * 2,
                         march_kernel=4 * (1 + L), shade_kernel=0),
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
    check(counts == only(render_kernel=0, surface_kernel=3 * 4,
                         march_kernel=3 * (1 + L), shade_kernel=0),
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

    phase("fused")
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
    check(counts == only(render_kernel=8, surface_kernel=0,
                         march_kernel=0, shade_kernel=0),
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
    check(counts == only(render_kernel=3, surface_kernel=0,
                         march_kernel=0, shade_kernel=0),
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
    check(counts == only(render_kernel=0, surface_kernel=4 * 2,
                         march_kernel=4 * (1 + L), shade_kernel=0),
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
    check(counts == only(render_kernel=0, surface_kernel=3 * 3,
                         march_kernel=3 * (1 + L), shade_kernel=0),
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

    phase("shading")
    # 9d. the shading extensions at the same footprint: soft shadows (k 6)
    # with AO (0.8) on the demo, coloured lights on scenes/mirror.txt
    # (reflect 0: its mirror bounces are not ported); K1's and K4's
    # extended entries against their twins in both normals, both fields
    # and both placements, two-phase, device times against the reference
    # entries in turns, the fused analytic fit, card vs CPU gradients
    from raymarching_tpu_torch import tables as scene_tables
    from raymarching_tpu_torch.ops.render_kernel import render_rays_plain as k1_plain
    mirror = rt.load_scene(str(ROOT / "scenes" / "mirror.txt"))
    mplan, mtables = rt.compile_scene(mirror)
    check(mplan.colored_lights, "scenes/mirror.txt has no coloured lights")
    softao = dict(soft_shadow_k=6.0, ao_strength=0.8)
    scfg = tcfg.replace(**softao)
    mcfg = tcfg
    zero_counts()
    s_imgs, s_secs = {}, {}
    for label, scene_, cfg in (("demo soft + AO", demo, scfg),
                               ("mirror.txt coloured", mirror, mcfg)):
        rt.render(scene_, cfg, device=dev)           # warm-up at this shape
        s_imgs[label], ms = timed(lambda: rt.render(scene_, cfg, device=dev),
                                  runs=3)
        s_secs[label] = ms / 1e3
    counts = add_counts("shading", 8)
    check(counts == only(render_ext_kernel=8),
          f"extended-shading renders launched {counts}")
    for label, img in s_imgs.items():
        check(img.shape == (tcfg.height, tcfg.width, 3)
              and bool(torch.isfinite(img).all()) and img.max().item() > 0,
              f"{label}: image")
    s_diff = (s_imgs["demo soft + AO"] - fused_img).abs()
    check(s_diff.max().item() > 1e-2, "soft shadows and AO moved nothing")
    mw = rt.render(mirror, mcfg.replace(shadows=False), device=dev)
    chan = (mw[..., 0] - mw[..., 2]).abs().max().item()
    check(chan > 1e-2, "the coloured lights gave a grey frame")
    print(f"[shading] render() at {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"{tcfg.iterations} it: demo with soft shadows (k 6) and AO (0.8) "
          f"{s_secs['demo soft + AO']:.4f} s (reference shading "
          f"{fused_s:.4f} s in this run), max |diff| to the reference image "
          f"{s_diff.max().item():.3g}; mirror.txt with coloured lights "
          f"(reflect 0) {s_secs['mirror.txt coloured']:.4f} s; launches a "
          f"frame: K1's extended entry 1; {card}")

    def every(vals, stride=BIG_STRIDE):
        """Every stride-th ray of each output ([L, R] factors by column)."""
        return rows_of(vals, slice(None, None, stride))

    limit = scene_tables.SHARED_SCENE_BYTES
    n_cmp = 0
    for sname, pl, tb, ch in (("demo", plan, tables, softao),
                              ("mirror.txt", mplan, mtables, {})):
        stt = tables_to_torch(tb, dev)
        for normal in ("fd", "analytic"):
            for fz in (False, True):
                c = tcfg.replace(normal_mode=normal, fused_generators=fz,
                                 **ch)
                kw = dict(save_winner=normal == "analytic",
                          save_factors=True)
                tag = f"{sname} {normal} {'fused' if fz else 'exact'}"
                o_, d_ = rays_for(pl, stt, c)
                k1 = render_rays(pl, c, stt, o_, d_, **kw)
                k4 = shk.shade_rays(pl, c, stt, k1[0].p, k1[0].sd, d_, **kw)
                scene_tables.SHARED_SCENE_BYTES = 0
                try:
                    same(f"K1 extended {tag}, scene in device memory / "
                         "shared", flat(render_rays(pl, c, stt, o_, d_, **kw)),
                         flat(k1))
                    same(f"K4 extended {tag}, scene in device memory / "
                         "shared", flat(shk.shade_rays(pl, c, stt, k1[0].p,
                                                       k1[0].sd, d_, **kw)),
                         flat(k4))
                finally:
                    scene_tables.SHARED_SCENE_BYTES = limit
                same(f"K4 extended = K1 extended, {tag}", flat(k4),
                     (k1[0].cidx, k1[0].light, k1[0].smask,
                      *flat(tuple(k1[1:]))))
                sub = slice(None, None, SHADE_STRIDE)
                same(f"K1 extended {tag} on every {SHADE_STRIDE}th ray",
                     every(flat(k1), SHADE_STRIDE), flat(k1_plain(
                         pl, c, stt, o_, d_[sub], **kw)),
                     "render_ext_kernel")
                same(f"K4 extended {tag} on every {SHADE_STRIDE}th ray",
                     every(flat(k4), SHADE_STRIDE),
                     flat(shk.shade_rays_plain(
                         pl, c, stt, k1[0].p[sub], k1[0].sd[sub], d_[sub],
                         **kw)), "shade_ext_kernel")
                n_cmp += 6
                del k1, k4
    # the rows' configuration in full: demo, soft shadows and AO, FD, exact
    tt = tables_to_torch(tables, dev)
    origin, dirs = rays_for(plan, tt, scfg)
    (k1s, fs), k1s_ms = timed(lambda: render_rays(
        plan, scfg, tt, origin, dirs, save_factors=True), runs=5)
    (p1s, pfs), k1s_plain_ms, k1s_count = timed_counted(
        lambda: k1_plain(plan, scfg, tt, origin, dirs, save_factors=True))
    same("K1 extended, demo soft + AO at 512^2, every ray", (*k1s, *fs),
         (*p1s, *pfs), "render_ext_kernel")
    del p1s, pfs
    (k4s, f4s), k4s_ms = timed(lambda: shk.shade_rays(
        plan, scfg, tt, k1s.p, k1s.sd, dirs, save_factors=True), runs=5)
    (p4s, pf4s), k4s_plain_ms, k4s_count = timed_counted(
        lambda: shk.shade_rays_plain(plan, scfg, tt, k1s.p, k1s.sd, dirs,
                                     save_factors=True))
    same("K4 extended, demo soft + AO at 512^2, every ray", (*k4s, *f4s),
         (*p4s, *pf4s), "shade_ext_kernel")
    same("K4 extended = K1 extended at 512^2", (*k4s, *f4s),
         (k1s.cidx, k1s.light, k1s.smask, *fs))
    del p4s, pf4s
    # K1 writes 5 floats, 2 ints, the light, 2 penumbra factors and the AO
    # factor a ray; K4 reads 7 floats and writes the same less the march's
    L = plan.num_lights
    k1s_bound = bound_ms(k1s_count, R * (12 + 28 + 4 + 4 * L + 4))
    k4s_bound = bound_ms(k4s_count, R * (28 + 12 + 4 * L + 4))
    zero_counts()
    s_two = rt.render(demo, scfg.replace(two_phase_k1=48), device=dev)
    counts = add_counts("two_phase_shading", 1)
    check(counts == only(march_kernel=2, shade_ext_kernel=1),
          f"a two-phase soft + AO frame launched {counts}")
    check(torch.equal(s_two, s_imgs["demo soft + AO"]),
          "the two-phase soft + AO image differs from the one-kernel image")
    # device time against the reference entries, in turns
    white = dataclasses.replace(mplan, colored_lights=False)
    mtt = tables_to_torch(mtables, dev)
    m_org, m_dirs = rays_for(mplan, mtt, mcfg)
    f_soft = fcfg.replace(**softao)
    s_turns = {
        "K1 demo reference / soft + AO": in_turns(
            lambda: render_rays(plan, tcfg, tt, origin, dirs),
            lambda: render_rays(plan, scfg, tt, origin, dirs),
            "render_kernel"),
        "K1 demo reference / soft": in_turns(
            lambda: render_rays(plan, tcfg, tt, origin, dirs),
            lambda: render_rays(plan, tcfg.replace(soft_shadow_k=6.0), tt,
                                origin, dirs), "render_kernel"),
        "K1 demo reference / AO": in_turns(
            lambda: render_rays(plan, tcfg, tt, origin, dirs),
            lambda: render_rays(plan, tcfg.replace(ao_strength=0.8), tt,
                                origin, dirs), "render_kernel"),
        "K1 demo fused analytic reference / soft + AO": in_turns(
            lambda: render_rays(plan, fcfg, tt, origin, dirs),
            lambda: render_rays(plan, f_soft, tt, origin, dirs),
            "render_kernel"),
        "K1 mirror.txt white lights / coloured": in_turns(
            lambda: render_rays(white, mcfg, mtt, m_org, m_dirs),
            lambda: render_rays(mplan, mcfg, mtt, m_org, m_dirs),
            "render_kernel"),
        "K4 demo reference / soft + AO": in_turns(
            lambda: shk.shade_rays(plan, tcfg, tt, k1s.p, k1s.sd, dirs),
            lambda: shk.shade_rays(plan, scfg, tt, k1s.p, k1s.sd, dirs),
            "shade_kernel"),
    }
    dev_ms["render_ext_kernel"] = s_turns["K1 demo reference / soft + AO"][1]
    dev_ms["shade_ext_kernel"] = s_turns["K4 demo reference / soft + AO"][1]
    print(f"[shading] K1 and K4 extended against their twins, bitwise on "
          f"every output (light, colour winner, shadow bits, penumbra and "
          f"AO factors, winner residuals): demo soft + AO and mirror.txt "
          f"coloured, FD and analytic, exact and fused, on every "
          f"{SHADE_STRIDE}th ray; each scene in device memory = shared, K4 = "
          f"K1 on every ray ({n_cmp} comparisons); demo soft + AO FD exact "
          f"on every ray: K1 {k1s_ms:.3f} ms with its wrapper, plain "
          f"{k1s_plain_ms:.3f} ms, bound {k1s_bound[0]:.4f} ms by "
          f"{k1s_bound[1]} ({k1s_bound[5]} operations); K4 {k4s_ms:.3f} ms, "
          f"plain {k4s_plain_ms:.3f} ms, bound {k4s_bound[0]:.4f} ms by "
          f"{k4s_bound[1]}; two_phase_k1=48 (K3 2, K4 extended 1) image "
          f"equal to the one-kernel frame; {card}")
    print(f"[shading] device time of the kernel alone, reference / extended "
          f"entry in turns (reference, extended, extended, reference; each "
          f"the median of 3 launches), 512x512 ssaa2 1000 it: "
          + "; ".join(f"{k} {a:.3f} / {b:.3f} ms"
                      for k, (a, b) in s_turns.items()) + f"; {card}")
    del k1s, fs, k4s, f4s, m_dirs
    # the fused analytic fit with soft shadows and AO: one K1 a step, no K2
    s_target = rt.render_tables(plan, tables, f_soft, device=dev)
    stamps.clear()
    step_grads.clear()
    zero_counts()
    t0 = time.perf_counter()
    sres = rt.fit(plan, start, s_target, f_soft, device=dev, steps=5,
                  trainable=TRAINABLE, optimizer=adam, callback=on_step)
    counts = add_counts("train_shading", 5)
    check(counts == only(render_ext_kernel=5),
          f"5 soft + AO fused analytic fit steps launched {counts}")
    check_step_grads()
    check(sres.losses[-1] < sres.losses[0], f"loss did not fall: "
          f"{sres.losses}")
    sstep = statistics.median(np.diff([t0] + stamps))
    print(f"[shading] fit, demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"{tcfg.iterations} it, fused generators, analytic normals, soft "
          f"shadows and AO, 5 Adam steps: loss "
          f"{' '.join(f'{v:.6g}' for v in sres.losses)}; step median "
          f"{sstep * 1e3:.1f} ms against {fstep * 1e3:.1f} ms with the "
          f"reference shading in this run; launches a step K1 1 (extended), "
          f"K2 0; {card}")
    # card vs CPU gradients at 32x24, light_color included on mirror.txt
    for sname, pl, tb, ch in (
            ("demo soft + AO, fused analytic", plan, tables,
             dict(fused_generators=True, normal_mode="analytic", **softao)),
            ("mirror.txt coloured, FD", mplan, mtables, {}),
            ("mirror.txt coloured, soft + AO, analytic", mplan, mtables,
             dict(normal_mode="analytic", **softao))):
        c = gcfg.replace(**ch)
        g_rays = rays_for(pl, tables_to_torch(tb, "cpu"), c)
        gs_card, launched = grads_of(pl, tb, c, dev, *g_rays)
        want = (1, 1 if c.normal_mode == "fd" else 0)
        check(launched == want, f"{sname}: a differentiable render "
              f"launched (K1, K2) {launched}")
        gs_cpu, _ = grads_of(pl, tb, c, torch.device("cpu"), *g_rays)
        worst_sg = grad_check(tb._fields + ("origin", "dirs"), gs_card,
                              gs_cpu, f"{sname} card vs CPU")
        lc = tb._fields.index("light_color")
        print(f"[shading] {sname}: 32x24 gradients, card vs CPU on the same "
              f"rays, every table field and the rays: max |diff| / field "
              f"scale {worst_sg[0]:.3g} ({worst_sg[1]}); light_color "
              f"gradient max {gs_card[lc].abs().max().item():.3g}; launches "
              f"K1 1, K2 {launched[1]}")

    phase("reflect")
    # 9e. mirror bounces at the same footprint: render() of the demo and
    # scenes/mirror.txt with reflect 0.4 and 1 or 2 bounces (one K1 bounce
    # launch a frame); K1's bounce entry against its twin on every ray and
    # its device time in turns with the reference entry; the raygen bounce
    # entry likewise; the images against backend="multi"; 5 fit steps
    # with one bounce and their split; card vs CPU gradients
    from raymarching_tpu_torch.ops.render_kernel import render_raygen
    reflect = dict(reflect_strength=0.4)
    zero_counts()
    r_imgs, r_secs = {}, {}
    for sname, scene_ in (("demo", demo), ("mirror.txt", mirror)):
        for B in (1, 2):
            c = tcfg.replace(reflect_bounces=B, **reflect)
            rt.render(scene_, c, device=dev)         # warm-up at this shape
            r_imgs[sname, B], ms = timed(
                lambda: rt.render(scene_, c, device=dev), runs=3)
            r_secs[sname, B] = ms / 1e3
    counts = add_counts("reflect", 16)
    check(counts == only(render_bounce_kernel=16),
          f"renders with mirror bounces launched {counts}")
    for (sname, B), img in r_imgs.items():
        check(img.shape == (tcfg.height, tcfg.width, 3)
              and bool(torch.isfinite(img).all()) and img.max().item() > 0,
              f"{sname} B {B}: image")
    r_moved = (r_imgs["demo", 1] - fused_img).abs().max().item()
    r_deeper = (r_imgs["demo", 2] - r_imgs["demo", 1]).abs().max().item()
    check(r_moved > 1e-2 and r_deeper > 1e-4,
          f"bounces moved the demo by {r_moved}, the second by {r_deeper}")
    # against the multi backend (K3 with per-ray origins, K2): JAX's
    # pallas-vs-mega tolerance, tests/test_reflections.py:79, on a share
    r_multi = []
    for sname, scene_, B in (("demo", demo, 1), ("demo", demo, 2),
                             ("mirror.txt", mirror, 1)):
        mimg = rt.render(scene_, tcfg.replace(reflect_bounces=B, **reflect),
                         backend="multi", device=dev)
        md = (mimg - r_imgs[sname, B]).abs().amax(dim=-1)
        share = (md <= REFLECT_ATOL).double().mean().item()
        check(share >= AGREE, f"{sname} B {B}: multi against fused, "
              f"{share:.6f} of pixels within {REFLECT_ATOL}")
        r_multi.append(f"{sname} B {B}: {share:.6f} of pixels within "
                       f"{REFLECT_ATOL}, max {md.max().item():.3g}")
        del mimg
    print(f"[reflect] render() at {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"{tcfg.iterations} it, reflect 0.4 (median of 3, CUDA events): "
          + "; ".join(f"{n} B {b} {t * 1e3:.3f} ms"
                      for (n, b), t in r_secs.items())
          + f" (no bounce {fused_s * 1e3:.3f} ms in this run); launches a "
          f"frame: K1's bounce entry 1; demo moved by {r_moved:.3g}, the "
          f"second bounce by {r_deeper:.3g}; against backend=multi: "
          + "; ".join(r_multi) + f"; {card}")
    tt = tables_to_torch(tables, dev)
    origin, dirs = rays_for(plan, tt, tcfg)
    rc1 = tcfg.replace(reflect_bounces=1, **reflect)
    (kb, kbf, kbb), kb_ms = timed(lambda: render_rays(
        plan, rc1, tt, origin, dirs, save_factors=True), runs=5)
    pb, kb_plain_ms, kb_count = timed_counted(lambda: k1_plain(
        plan, rc1, tt, origin, dirs[::BIG_STRIDE], save_factors=True))
    same(f"K1 bounce, demo B 1 at 512^2, every {BIG_STRIDE}th ray",
         rows_of(flat((kb, kbf, kbb)), slice(None, None, BIG_STRIDE)),
         flat(pb), "render_bounce_kernel")
    del pb, kb, kbf, kbb
    # reads the directions, writes 5 floats, 2 ints and the light a set
    kb_bound = bound_ms(kb_count, R * (12 + 2 * 32), BIG_STRIDE)
    b_turns = {
        f"K1 demo reference / B {B}": in_turns(
            lambda: render_rays(plan, tcfg, tt, origin, dirs),
            lambda: render_rays(plan, tcfg.replace(reflect_bounces=B,
                                                   **reflect),
                                tt, origin, dirs), "render_kernel")
        for B in (1, 2)}
    rg_dirs = cam.raygen_dirs(cam.serve_cam_rows(tt, rc1), rc1, 0, R)
    (rgb, rgbb), rgb_ms = timed(lambda: render_raygen(plan, rc1, tt, 0, R),
                                runs=5)
    same("K1 raygen bounce against the bounce entry on its directions, "
         "every ray", flat((rgb, rgbb)), flat(render_rays(
             plan, rc1, tt, tt.cam_position, rg_dirs)))
    del rgb, rgbb
    b_turns["K1 demo bounce B 1 on the raygen directions / raygen bounce"] = (
        in_turns(lambda: render_rays(plan, rc1, tt, tt.cam_position,
                                     rg_dirs),
                 lambda: render_raygen(plan, rc1, tt, 0, R),
                 "render_kernel"))
    del rg_dirs
    dev_ms["render_bounce_kernel"] = b_turns["K1 demo reference / B 1"][1]
    print(f"[reflect] K1's bounce entry, demo B 1 at {tcfg.width}x"
          f"{tcfg.height} ssaa{tcfg.ssaa}: = its twin on every "
          f"{BIG_STRIDE}th ray (every output of both shade sets); "
          f"{kb_ms:.3f} ms with its wrapper, "
          f"plain {kb_plain_ms:.3f} ms, bound {kb_bound[0]:.4f} ms by "
          f"{kb_bound[1]} ({kb_bound[5]} operations); the raygen bounce "
          f"entry = the bounce entry on its directions, {rgb_ms:.3f} ms with "
          f"its wrapper; device time of the kernel alone in turns (a, b, b, "
          f"a; each the median of 3 launches): "
          + "; ".join(f"{k} {a:.3f} / {b:.3f} ms"
                      for k, (a, b) in b_turns.items()) + f"; {card}")
    # 3 fit steps with one bounce: one K1 bounce launch a step, no K2 (the
    # backward replays the chain in plain PyTorch, REPLAY_RAYS at a time)
    r_target = rt.render_tables(plan, tables, rc1, device=dev)
    stamps.clear()
    step_grads.clear()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rres = rt.fit(plan, start, r_target, rc1, device=dev, steps=3,
                  trainable=TRAINABLE, optimizer=adam, callback=on_step)
    counts = add_counts("train_reflect", 3)
    check(counts == only(render_bounce_kernel=3),
          f"3 fit steps with a bounce launched {counts}")
    check_step_grads()
    check(rres.losses[-1] < rres.losses[0], f"loss did not fall: "
          f"{rres.losses}")
    r_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rstep = statistics.median(np.diff([t0] + stamps))
    rtt = tables_to_torch(rres.tables, dev, requires_grad=TRAINABLE)
    opt = adam([getattr(rtt, f) for f in TRAINABLE])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    img = rt.render_tables(plan, rtt, rc1, differentiable=True, device=dev)
    loss = torch.mean((img - r_target) ** 2)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    torch.cuda.synchronize()
    r_split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    del rtt, opt, img, loss
    print(f"[reflect] fit, demo {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"{tcfg.iterations} it, reflect 0.4, 1 bounce, FD normals, 3 Adam "
          f"steps: loss {' '.join(f'{v:.6g}' for v in rres.losses)}; step "
          f"median {rstep * 1e3:.1f} ms; split (one more step, CUDA "
          f"events): forward {r_split[0]:.1f} ms, backward (the replay, "
          f"{scene_vjp.REPLAY_RAYS} rays a slice) {r_split[1]:.1f} ms, "
          f"optimizer {r_split[2]:.2f} ms; peak device memory "
          f"{r_peak:.2f} GiB (torch.cuda.max_memory_allocated over the 3 "
          f"steps); launches a step K1's bounce entry 1, K2 0; {card}")
    # card vs CPU gradients at 32x24 on the same rays
    for sname, pl, tb, ch in (
            ("demo B 1 FD", plan, tables, dict(reflect_bounces=1)),
            ("demo B 2 analytic", plan, tables,
             dict(reflect_bounces=2, normal_mode="analytic")),
            ("mirror.txt B 1 FD soft + AO", mplan, mtables,
             dict(reflect_bounces=1, **softao))):
        c = gcfg.replace(**reflect, **ch)
        g_rays = rays_for(pl, tables_to_torch(tb, "cpu"), c)
        gr_card, launched = grads_of(pl, tb, c, dev, *g_rays)
        check(launched == (1, 0), f"{sname}: a differentiable render "
              f"launched (K1, K2) {launched}")
        gr_cpu, _ = grads_of(pl, tb, c, torch.device("cpu"), *g_rays)
        worst_rg = grad_check(tb._fields + ("origin", "dirs"), gr_card,
                              gr_cpu, f"{sname} card vs CPU")
        print(f"[reflect] {sname}: 32x24 gradients, card vs CPU on the same "
              f"rays, every table field and the rays: max |diff| / field "
              f"scale {worst_rg[0]:.3g} ({worst_rg[1]}); launches K1 1 "
              f"(bounce), K2 0")

    phase("dof")
    # 9f. thin-lens depth of field at the same footprint: aperture 0.2,
    # focus 8 (K1 with per-ray origins, one launch a frame), then with a
    # mirror bounce (K1's bounce entry); the images against multi; card vs
    # CPU gradients of the lens pose
    d_imgs, d_secs = {}, {}
    dof = dict(aperture=0.2, focus_dist=8.0)
    for label, c, want in (("dof", tcfg.replace(**dof), "render_kernel"),
                           ("dof + reflect", tcfg.replace(**dof, **reflect),
                            "render_bounce_kernel")):
        zero_counts()
        rt.render(demo, c, device=dev)               # warm-up at this shape
        d_imgs[label], ms = timed(lambda: rt.render(demo, c, device=dev),
                                  runs=3)
        d_secs[label] = ms / 1e3
        counts = add_counts(label.replace(" + ", "_"), 4)
        check(counts == only(**{want: 4}),
              f"{label} frames launched {counts}")
        img = d_imgs[label]
        check(bool(torch.isfinite(img).all()) and img.max().item() > 0,
              f"{label}: image")
        mimg = rt.render(demo, c, backend="multi", device=dev)
        md = (mimg - img).abs().amax(dim=-1)
        d_secs[label] = (d_secs[label], (md <= REFLECT_ATOL).double().mean()
                         .item(), md.max().item())
        check(d_secs[label][1] >= AGREE, f"{label}: multi against fused, "
              f"{d_secs[label][1]:.6f} of pixels within {REFLECT_ATOL}")
        del mimg
    d_blur = (d_imgs["dof"] - fused_img).abs().max().item()
    check(d_blur > 1e-2, f"the lens moved the frame by {d_blur}")
    c = gcfg.replace(**dof)
    o_, d_ = cam.generate_rays_dof(tables_to_torch(tables, "cpu"), c)
    g_rays = (o_.reshape(-1, 3), d_.reshape(-1, 3))
    gd_card, launched = grads_of(plan, tables, c, dev, *g_rays)
    check(launched == (1, 1), f"a differentiable DOF render launched "
          f"(K1, K2) {launched}")
    gd_cpu, _ = grads_of(plan, tables, c, torch.device("cpu"), *g_rays)
    worst_dg = grad_check(tables._fields + ("origin", "dirs"), gd_card,
                          gd_cpu, "DOF card vs CPU")
    print(f"[dof] render() at {tcfg.width}x{tcfg.height} ssaa{tcfg.ssaa} "
          f"{tcfg.iterations} it, aperture 0.2, focus 8 (median of 3, CUDA "
          f"events): " + "; ".join(
              f"{k} {t * 1e3:.3f} ms, against backend=multi {sh:.6f} of "
              f"pixels within {REFLECT_ATOL}, max {mx:.3g}"
              for k, (t, sh, mx) in d_secs.items())
          + f"; pinhole {fused_s * 1e3:.3f} ms in this run; launches a frame "
          f"K1 1 (per-ray origins; the bounce entry with reflect 0.4); the "
          f"lens moved the frame by {d_blur:.3g}; 32x24 gradients card vs "
          f"CPU on the same lens rays, every field and the rays: max |diff| "
          f"/ field scale {worst_dg[0]:.3g} ({worst_dg[1]}); {card}")

    phase("profile")
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

    phase("warp")
    # 11. where a thread-per-ray kernel loses its lanes
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

    phase("collapse")
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

    phase("serve")
    # 13. the serving path: K1's raygen entry against K1 on its twin's
    # directions and against its twin, the image against the standard
    # path's, render() and /render with raygen on and off in turns
    from raymarching_tpu_torch.ops.render_kernel import render_raygen_plain
    tt = tables_to_torch(tables, dev)
    rg_dirs = cam.raygen_dirs(cam.serve_cam_rows(tt, tcfg), tcfg, 0, R)
    rg, rg_ms = timed(lambda: render_raygen(plan, tcfg, tt, 0, R), runs=5)
    same("K1 raygen entry against K1 on the raygen twin's directions",
         tuple(rg), tuple(render_rays(plan, tcfg, tt, tt.cam_position,
                                      rg_dirs)))
    rg_p, rg_plain_ms, rg_count = timed_counted(
        lambda: render_raygen_plain(plan, tcfg, tt, 0, R))
    same("K1 raygen entry against its plain twin", tuple(rg), tuple(rg_p),
         "render_raygen_kernel")
    del rg_p
    same("K1 raygen entry on a chunk of the frame",
         tuple(render_raygen(plan, tcfg, tt, 99_999, 300_001)),
         tuple(v[99_999:400_000] for v in rg))
    # the raygen entries with the extensions and analytic normals (fused)
    rcfg = fcfg.replace(**softao)
    kw = dict(save_winner=True, save_factors=True)
    rg_x = render_raygen(plan, rcfg, tt, 0, R, **kw)
    same("K1 raygen extended fused analytic against K1 extended on the "
         "twin's directions", flat(rg_x), flat(render_rays(
             plan, rcfg, tt, tt.cam_position, rg_dirs, **kw)))
    same(f"K1 raygen extended fused analytic against its twin on every "
         f"{BIG_STRIDE}th ray", every(flat(rg_x)), flat(k1_plain(
             plan, rcfg, tt, tt.cam_position, rg_dirs[::BIG_STRIDE], **kw)),
         "render_raygen_kernel")
    del rg_x
    # K1 raygen writes 6 floats and 2 ints a ray and reads nothing of it
    rg_bound = bound_ms(rg_count, R * 32)
    rg_turns = in_turns(lambda: render_rays(plan, tcfg, tt, tt.cam_position,
                                            rg_dirs),
                        lambda: render_raygen(plan, tcfg, tt, 0, R),
                        "render_kernel")
    dev_ms["render_raygen_kernel"] = rg_turns[1]
    del rg, rg_dirs
    # the image against the standard path's: tests/test_serve_raygen.py's
    # agreement rule
    zero_counts()
    rg_img = rt.render(demo, tcfg.replace(serve_raygen=True), device=dev)
    counts = add_counts("serve_raygen", 1)
    check(counts == only(render_raygen_kernel=1),
          f"a serve_raygen frame launched {counts}")
    rdiff = (rg_img - fused_img).abs().amax(dim=-1)
    rshare = (rdiff < 5e-3).double().mean().item()
    check(rshare > 0.995 and rdiff.median().item() < 1e-4,
          f"raygen image against the standard one: {rshare:.6f} of pixels "
          f"under 5e-3, median {rdiff.median().item()}")
    print(f"[serve-raygen] K1's raygen entry at {tcfg.width}x{tcfg.height} "
          f"ssaa{tcfg.ssaa}: = K1 on the raygen twin's directions, = its "
          f"plain twin (every output, every ray), a chunk = the frame's "
          f"rays; extended fused analytic = K1 extended on the same "
          f"directions and its twin on every {BIG_STRIDE}th ray; "
          f"{rg_ms:.3f} ms with its wrapper, device {rg_turns[1]:.3f} ms "
          f"against K1 on the same directions {rg_turns[0]:.3f} ms in "
          f"turns, plain {rg_plain_ms:.3f} ms, bound {rg_bound[0]:.4f} ms by "
          f"{rg_bound[1]}; image against the standard path's: {rshare:.6f} "
          f"of pixels under 5e-3, median {rdiff.median().item():.3g}, max "
          f"{rdiff.max().item():.3g}; {card}")

    srv = make_server("127.0.0.1", 0, dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health.get("status") == "ok", f"healthz {health}")
        body = DEMO.read_bytes()

        def post(query):
            req = urllib.request.Request(url + "/render?" + query, data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return rt.decode_png(r.read())

        # the server's default is the raygen path; serve_raygen=0 the
        # standard one: each PNG is the direct render's
        cfg = rt.RenderConfig(width=256, height=192, ssaa=2)
        for q, c in (("", cfg.replace(serve_raygen=True)),
                     ("&serve_raygen=0", cfg),
                     ("&soft_shadow_k=6&ao=0.8", cfg.replace(
                         serve_raygen=True, **softao)),
                     ("&reflect=0.4&bounces=2", cfg.replace(
                         serve_raygen=True, reflect_bounces=2, **reflect)),
                     ("&aperture=0.2&focus=8", cfg.replace(
                         serve_raygen=True, **dof))):
            want = rt.to_uint8(rt.render(demo, c, device=dev).cpu().numpy())
            zero_counts()
            png = post("width=256&height=192&ssaa=2" + q)
            counts = add_counts(f"serve{q.replace('&', '_') or '_default'}",
                                1)
            check(png.shape == want.shape and (png == want).all(),
                  f"/render{q} PNG differs from a direct render")
        check(paths["serve_reflect=0.4_bounces=2"][1] == only(
            render_bounce_kernel=1), "/render with bounces launched "
            f"{paths['serve_reflect=0.4_bounces=2'][1]}")
        # POST /aovs at 256x256 with a bounce: the ZIP of the six planes,
        # its colour plane the beauty frame's PNG (render_aovs blends the
        # bounces; one K1 bounce launch and one K2 launch for the normal)
        aq = "width=256&height=256&reflect=0.4&bounces=1"
        areq = urllib.request.Request(url + "/aovs?" + aq, data=body,
                                      method="POST")
        zero_counts()
        t0 = time.perf_counter()
        with urllib.request.urlopen(areq, timeout=300) as r:
            zbody = r.read()
        aovs_ms = (time.perf_counter() - t0) * 1e3
        counts = add_counts("aovs", 1)
        check(counts == only(render_bounce_kernel=1, surface_kernel=1),
              f"/aovs launched {counts}")
        with zipfile.ZipFile(io.BytesIO(zbody)) as zf:
            members = sorted(zf.namelist())
            check(members == sorted(("color.png", "normal.png", "hit.png",
                                     "depth.npy", "objid.npy",
                                     "shadow.npy")), f"/aovs ZIP {members}")
            acolor = rt.decode_png(zf.read("color.png"))
            adepth = np.load(io.BytesIO(zf.read("depth.npy")))
        beauty = rt.to_uint8(rt.render(demo, rt.RenderConfig(
            width=256, height=256, ssaa=1, reflect_bounces=1, **reflect),
            device=dev).cpu().numpy())
        check(acolor.shape == beauty.shape and (acolor == beauty).all(),
              "/aovs color.png differs from the beauty frame")
        check(adepth.shape == (256, 256) and bool(np.isfinite(
            adepth).any()), "/aovs depth plane")
        print(f"[aovs] POST /aovs 256x256 reflect 0.4, 1 bounce: ZIP of "
              f"{', '.join(members)} ({len(zbody)} bytes) in "
              f"{aovs_ms:.1f} ms; color.png = the beauty frame's PNG; "
              f"launches K1's bounce entry 1, K2 1 (the normal plane); "
              f"{card}")
        # render() and /render at 256^2 and 512^2, raygen on and off in
        # turns (off, on, on, off; render() the median of 3 frames, /render
        # the median of 3 requests, host clock), launches of each
        serve_rows = []
        for size in (256, 512):
            c = rt.RenderConfig(width=size, height=size, ssaa=2)
            q = f"width={size}&height={size}&ssaa=2"
            t_r, t_s = {False: [], True: []}, {False: [], True: []}
            for on in (False, True):
                rt.render(demo, c.replace(serve_raygen=on), device=dev)
                post(q + ("" if on else "&serve_raygen=0"))
            for on in (False, True, True, False):
                zero_counts()
                t_r[on].append(timed(lambda: rt.render(
                    demo, c.replace(serve_raygen=on), device=dev),
                    runs=3)[1])
                counts = add_counts(f"render_{size}_raygen_{int(on)}", 3)
                check(counts == (only(render_raygen_kernel=3) if on
                                 else only(render_kernel=3)),
                      f"render() {size}^2 raygen {on} launched {counts}")
                zero_counts()
                lat = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    post(q + ("" if on else "&serve_raygen=0"))
                    lat.append((time.perf_counter() - t0) * 1e3)
                counts = add_counts(f"serve_{size}_raygen_{int(on)}", 3)
                check(counts == (only(render_raygen_kernel=3) if on
                                 else only(render_kernel=3)),
                      f"/render {size}^2 raygen {on} launched {counts}")
                t_s[on].append(statistics.median(lat))
            serve_rows.append(
                f"{size}x{size} ssaa2: render() "
                f"{statistics.mean(t_r[False]):.3f} / "
                f"{statistics.mean(t_r[True]):.3f} ms (turns "
                f"{', '.join(f'{v:.3f}' for v in t_r[False])} / "
                f"{', '.join(f'{v:.3f}' for v in t_r[True])}), /render "
                f"{statistics.mean(t_s[False]):.1f} / "
                f"{statistics.mean(t_s[True]):.1f} ms")
        print(f"[serve] /healthz ok; /render (raygen, the default), "
              f"serve_raygen=0, soft_shadow_k=6&ao=0.8, reflect=0.4&bounces=2 "
              f"(K1's raygen bounce entry) and aperture=0.2&focus=8 at "
              f"256x192 ssaa2 equal to direct renders; standard / raygen, "
              f"launches a "
              f"frame K1 1 / K1's raygen entry 1: " + "; ".join(serve_rows)
              + f"; {card}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)

    phase("fractal")
    # 14. the procedural leaves on every path
    dplan, dtables = rt.compile_scene(demo)
    proc_rows = fractal_phase(dev, card, add_counts, dplan,
                              tables_to_torch(dtables, dev))

    phase("deep")
    # 15. deep trees (no two-level form) on every path
    deep_rows = deep_phase(dev, card, add_counts, dplan,
                           tables_to_torch(dtables, dev))

    phase("cli")
    # 16. the CLI's and the server's paths past one render
    sd_row = cli_phase(dev, card, add_counts)

    phase("oracle")
    # 17. the port's plain gradient oracles on the card
    oracle_phase(dev, card)

    phase("shard")
    # 18. the demo's rows sharded over a torch.distributed process group
    shard_rows = shard_phase(dev, card, add_counts)

    phase("cull")
    # 19. the culls of D5 and D4 on scatter1k, menger4 and an iters-5
    # sponge, and the block ray order
    cull_rows = cull_phase(dev, card, add_counts)

    # 20. the native host runtime: build, parse, the PNG writers
    phase("native")
    native_phase(card)

    # 21. the examples at their own defaults
    phase("examples")
    example_rows = examples_phase(dev, card, add_counts)
    phase(None)
    print("[seconds] every phase: " + "; ".join(
        f"{k} {v:.1f}" for k, v in PHASE_S.items())
        + f"; total {time.perf_counter() - T_START:.1f} s from the "
        f"interpreter's start; {card}")

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
                "bound_ms_leaf_fold": leaf_bounds.get(kname, (None,))[0],
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
    table = {"kernels": [
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
                k4f_ms, k4f_plain_ms, k4f_bound, f_turns["K4 analytic"])),
        # the extended entries on the demo with soft shadows and AO (FD,
        # exact), device time in turns with the reference entry
        # (reference_device_ms); the raygen entries on the demo's frame in
        # scan order, in turns with K1 on the same directions
        {**row("render_ext_kernel", "raymarching_tpu/ops/pallas_render.py"
               ":211 (_shade_body :327: soft :517, coloured :526, AO :541)",
               k1s_ms, k1s_plain_ms, k1s_bound),
         "reference_device_ms": s_turns["K1 demo reference / soft + AO"][0]},
        {**row("render_raygen_kernel", "raymarching_tpu/ops/pallas_render.py"
               ":211 (_raygen_dirs :162)", rg_ms, rg_plain_ms, rg_bound),
         "reference_device_ms": rg_turns[0]},
        {**row("shade_ext_kernel", "raymarching_tpu/ops/pallas_render.py:558"
               " (_shade_body :327)", k4s_ms, k4s_plain_ms, k4s_bound),
         "reference_device_ms": s_turns["K4 demo reference / soft + AO"][0]},
        # the bounce entries on the demo with reflect 0.4 and one bounce
        # (FD, exact), device time in turns with the reference entry on the
        # same rays; two bounces and the raygen bounce entry beside it
        {**row("render_bounce_kernel", "raymarching_tpu/ops/pallas_render.py"
               ":211 (bounce branch :284-309)", kb_ms, kb_plain_ms, kb_bound),
         "reference_device_ms": b_turns["K1 demo reference / B 1"][0],
         "device_ms_2_bounces": b_turns["K1 demo reference / B 2"][1],
         "raygen": {"ms": rgb_ms, "device_ms": b_turns[
             "K1 demo bounce B 1 on the raygen directions / raygen bounce"][1],
             "bound_ms": kb_bound[0], "bound_by": kb_bound[1]}},
    ]}
    # each kernel's procedural view ([fractal]: scenes/julia.txt at 512x512
    # ssaa2; K1 also FD and analytic, with the demo's device time in turns),
    # and its launches on the [fractal] paths
    d7 = ("raymarching_tpu/ops/pallas_march.py:71, :93, :160, :288, :343, "
          ":386 (D7, through _prim_sd :433 and _prim_sd_grad :2004)")
    for r in table["kernels"]:
        k = r["name"]
        if k == "render_kernel":
            r["procedural"] = {"replaces": d7, "scene": "scenes/julia.txt",
                               "fd": proc_rows[("render_kernel", "fd")],
                               "analytic": proc_rows[("render_kernel",
                                                      "analytic")]}
        elif k in ("march_kernel", "shade_kernel", "surface_kernel"):
            r["procedural"] = {"replaces": d7, **proc_rows[k]}
        if "procedural" in r:
            r["procedural"]["launches"] = proc_rows["launches"][k]
    # each kernel's deep view ([deep]: the demo behind a deep list at
    # 512x512 ssaa2; K1 FD and analytic, with the two-level demo's device
    # time in turns; K2 its stencil entry at the fit step's shape), and its
    # launches on the [deep] paths
    for r in table["kernels"]:
        k = r["name"]
        if k == "render_kernel":
            r["deep"] = {"replaces": D8,
                         "scene": "scenes/demo.txt behind a deep list",
                         "fd": deep_rows[("render_kernel", "fd")],
                         "analytic": deep_rows[("render_kernel",
                                                "analytic")]}
        elif k in ("march_kernel", "shade_kernel", "surface_kernel"):
            r["deep"] = {"replaces": D8, **deep_rows[k]}
        if "deep" in r:
            r["deep"]["launches"] = deep_rows["launches"][k]
    # K1's and K2's launches on the [shard] paths, by world and rank (a
    # band's frame, a step, train_step, fit(mesh=), the tiled frame, the
    # bundle of rays)
    for r in table["kernels"]:
        if r["name"] in shard_rows:
            r["shard"] = {"launches": shard_rows[r["name"]]}
    # each kernel's Cull view ([cull]: scatter1k.txt's chunk cull and
    # menger4.txt's value-bound winner walk at 512x512 ssaa2, the device
    # times with the culled twins' bounds and counts), and its launches on
    # the [cull] paths
    for r in table["kernels"]:
        k = r["name"]
        if k in cull_rows:
            r["cull"] = {"replaces": D5_D4, **cull_rows[k],
                         "launches": cull_rows["launches"][k]}
    # each kernel's launches in each example's run ([examples]: its main
    # at its own defaults, the counts zeroed before it and read after it)
    for r in table["kernels"]:
        r["examples"] = {"launches": {
            label: c[r["name"]] for label, c in example_rows.items()}}
    # K2's SD mode on the demo's mesh grid ([cli]), a row of its own
    table["kernels"].append({
        "name": "surface_kernel (SD mode, mesh grid)", "route": "cuda",
        "source": f"{csrc}surface_kernel.cu",
        "replaces": "raymarching_tpu/ops/pallas_march.py:2656 (SD mode: "
                    "with_color=False, with_normal=False; io/mesh.py:262)",
        "launches": paths["mesh"][1]["surface_kernel"],
        "max_abs_err": ERRS["surface_kernel"], "ms": sd_row["ms"],
        "device_ms": sd_row["device_ms"], "plain_ms": sd_row["plain_ms"],
        "bound_ms": sd_row["bound"][0], "bound_by": sd_row["bound"][1],
        "library_ms": None, "points": sd_row["points"]})
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
