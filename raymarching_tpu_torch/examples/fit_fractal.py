"""Differentiable FRACTAL fitting: recover a quaternion Julia set's
position, size, and color from pixels alone.

A demo the reference renderer could not express, let alone differentiate:
the target image is a procedural Julia-set fractal; the initial guess is
shifted, shrunk, and re-tinted; plain Adam on the photometric MSE recovers
the parameters.  Gradients flow through the sphere-trace fixed point (IFT
backward) and through the unrolled quaternion iteration into the leaf's
table entries — the size cotangent rides the DE's homogeneity
(ops.scene_vjp.theta_cotangents).

Two knobs matter for fitting fractals and are demonstrated here:

  * ``ift_damping``: rolls off the IFT 1/(grad f . d) weight on grazing
    rays (abundant on curved fractal surfaces) instead of clamping it at
    1e6 — see ops.march_op.ift_ray_weights.
  * Geometry smoothness: the Julia set at moderate iteration counts has
    SMOOTH swirled surfaces, so photometric gradients are informative.  A
    deep Mandelbulb's surface is rough at pixel scale — its pointwise
    gradient is exact but the loss landscape is jagged, and plain local
    descent stalls (that regime needs stochastic smoothing or silhouette
    terms; a documented limitation, not a gradient bug).

The port of the JAX repo's ``examples/fit_fractal.py``: on the card a step
is one K1 launch (its procedural analytic entry) and K2's combined mode in
the fractal analytic backward, once a slice of rays.

    python -m raymarching_tpu_torch.examples.fit_fractal [--steps 150]
        [--out $TMPDIR/fit_fractal] [--device cuda] [--backend cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from ..api import render_tables
from ..config import RenderConfig
from ..io.image import save_image
from ..optimize import fit
from ..scene.compile import compile_tree
from ..scene.csg import Julia, ListNode, Mode, bounds
from ..scene.objects import Camera, Light

TRAINABLE = ("prim_pos", "prim_aux", "prim_color")
LR = 1e-2


def setup(cfg: RenderConfig | None = None):
    """(plan, tables_true, tables0, cfg): a Julia leaf inside a Bounds box,
    the same tables with the fractal shifted, shrunk and re-tinted, and the
    script's 96x72 frame (shadows off, analytic normals, damped IFT
    weights; or ``cfg``)."""
    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        Julia((0.0, 0.0, -5.0), 1.3, c=(-0.2, 0.6, 0.2, 0.2), iterations=6,
              color=(0.9, 0.55, 0.25)),
    ])
    plan, tables_true = compile_tree(
        tree, [Light((5.0, 6.0, 0.5))],
        Camera(position=(2.4, 1.9, -1.4), direction=(-2.4, -2.0, -3.6),
               fov=50.0))
    # Shadows off (a boolean is a step function — zero gradient a.e., pure
    # noise for fitting) + analytic normals + damped IFT weights.
    cfg = cfg or RenderConfig(width=96, height=72, ssaa=1, iterations=300,
                              shadows=False, normal_mode="analytic",
                              ift_damping=3e-3)
    # Perturb the fractal: shift, shrink, re-tint.
    pos = np.array(tables_true.prim_pos)
    aux = np.array(tables_true.prim_aux)
    col = np.array(tables_true.prim_color)
    pos[1] += np.array([0.2, -0.15, 0.18])
    aux[1, 0] *= 0.8
    col[1] = np.clip(col[1] + np.array([-0.3, 0.2, 0.3]), 0, 1)
    tables0 = tables_true._replace(prim_pos=pos, prim_aux=aux,
                                   prim_color=col)
    return plan, tables_true, tables0, cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "fit_fractal"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--backend", default="cuda",
                    help="render backend: cuda, multi, ref or torch")
    args = ap.parse_args(argv)

    plan, tables_true, tables0, cfg = setup()
    kw = dict(backend=args.backend, device=args.device)
    target = render_tables(plan, tables_true, cfg, **kw)

    os.makedirs(args.out, exist_ok=True)
    save_image(os.path.join(args.out, "target.png"), target.cpu().numpy())
    save_image(os.path.join(args.out, "initial.png"),
               render_tables(plan, tables0, cfg, **kw).cpu().numpy())

    def cb(step, loss, _):
        if step % 25 == 0:
            print(f"step {step:4d}  loss {loss:.6f}")

    res = fit(plan, tables0, target, cfg, steps=args.steps, lr=LR,
              trainable=TRAINABLE, callback=cb, **kw)

    fitted = render_tables(plan, res.tables, cfg, **kw)
    save_image(os.path.join(args.out, "fitted.png"), fitted.cpu().numpy())
    got = {f: getattr(res.tables, f).cpu().numpy() for f in TRAINABLE}
    true_pos = np.asarray(tables_true.prim_pos[1])
    fit_pos = got["prim_pos"][1]
    ce = np.abs(got["prim_color"][1]
                - np.asarray(tables_true.prim_color[1])).max()
    print(f"loss {res.losses[0]:.6f} -> {res.losses[-1]:.6f} "
          f"({res.losses[0] / max(res.losses[-1], 1e-12):.1f}x reduction)")
    was = np.abs(np.asarray(tables0.prim_pos[1]) - true_pos).max()
    print(f"julia position error: {np.abs(fit_pos - true_pos).max():.4f} "
          f"(was {was:.4f})")
    print(f"julia size: {float(got['prim_aux'][1, 0]):.4f} "
          f"(true {float(tables_true.prim_aux[1, 0]):.4f}, "
          f"start {float(tables0.prim_aux[1, 0]):.4f}); "
          f"color err {ce:.4f}")
    print(f"images in {args.out}/: target.png initial.png fitted.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
