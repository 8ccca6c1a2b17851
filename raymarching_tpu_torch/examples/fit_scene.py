"""Differentiable rendering demo: recover perturbed scene parameters.

The capability the reference renderer could never have: render a target
image, perturb the scene (sphere positions, radii, colors, a light), and
gradient-descend the parameters back by comparing rendered pixels — the
gradients flow through the iterative sphere-trace via the implicit-function
backward.  The port of the JAX repo's ``examples/fit_scene.py``: on the
card each step is one K1 launch (analytic normals: the kernel saves the
winner residuals, and the backward launches nothing).

    python -m raymarching_tpu_torch.examples.fit_scene [--steps 150]
        [--out $TMPDIR/fit] [--device cuda] [--backend cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

from ..api import render_tables
from ..config import RenderConfig
from ..io.image import save_image
from ..optimize import fit
from ..scene.compile import compile_scene
from ..scene.parser import load_scene

SCENE = Path(__file__).resolve().parents[2] / "scenes" / "config3.txt"
TRAINABLE = ("prim_pos", "prim_aux", "prim_color", "light_pos")
LR = 2e-2


def setup(cfg: RenderConfig | None = None):
    """(plan, tables_true, tables0, cfg): config3 compiled, the same tables
    with the DeathStar pair shifted and shrunk, the sphere tinted and
    light 0 moved (seed 0), and the script's 128x96 analytic frame (or
    ``cfg``)."""
    plan, tables_true = compile_scene(load_scene(str(SCENE)))
    cfg = cfg or RenderConfig(width=128, height=96, ssaa=1, iterations=300,
                              shadows=True, normal_mode="analytic")
    # Perturb: shift + shrink the DeathStar, move a light, tint the sphere.
    rng = np.random.default_rng(0)
    pos = np.array(tables_true.prim_pos)
    aux = np.array(tables_true.prim_aux)
    col = np.array(tables_true.prim_color)
    lp = np.array(tables_true.light_pos)
    pos[2:4] += rng.normal(0, 0.4, (2, 3))
    aux[2:4, 0] *= 0.8
    col[4] = np.clip(col[4] + 0.3, 0, 1)
    lp[0] += np.array([2.0, -1.0, 1.0])
    tables0 = tables_true._replace(prim_pos=pos, prim_aux=aux,
                                   prim_color=col, light_pos=lp)
    return plan, tables_true, tables0, cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "fit"))
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
              trainable=TRAINABLE,
              checkpoint_path=os.path.join(args.out, "ckpt.npz"),
              callback=cb, **kw)

    fitted = render_tables(plan, res.tables, cfg, **kw)
    save_image(os.path.join(args.out, "fitted.png"), fitted.cpu().numpy())
    print(f"loss {res.losses[0]:.6f} -> {res.losses[-1]:.6f} "
          f"({res.losses[0] / max(res.losses[-1], 1e-12):.1f}x reduction)")
    print(f"images in {args.out}/: target.png initial.png fitted.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
