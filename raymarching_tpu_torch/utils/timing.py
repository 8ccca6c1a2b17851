"""March observability: convergence and step statistics.

Counterpart of ``raymarching_tpu.utils.timing.march_iteration_stats`` and
``profile_march``.  The step counts come from K3's per-ray counter on a
CUDA device (``backend="kernel"``) or from the plain march over the plain
scene fold (``backend="plain"``, the JAX package's ``"jnp"``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def march_iteration_stats(converged: np.ndarray,
                          steps: Optional[np.ndarray] = None) -> dict:
    """Convergence summary: rays, converged, miss share and, with
    ``steps``, the mean, p50, p90, p99 and max of the per-ray counts."""
    converged = np.asarray(converged)
    out = {
        "rays": int(converged.size),
        "converged": int(converged.sum()),
        "miss_fraction": float(1.0 - converged.mean()) if converged.size
        else 0.0,
    }
    if steps is not None:
        steps = np.asarray(steps)
        out["steps"] = {
            "mean": float(steps.mean()),
            "p50": int(np.percentile(steps, 50)),
            "p90": int(np.percentile(steps, 90)),
            "p99": int(np.percentile(steps, 99)),
            "max": int(steps.max()),
        }
    return out


def profile_march(plan, tables, cfg, backend: str = "kernel", *,
                  device) -> dict:
    """Render-shaped march profile: convergence and the step histogram of
    the primary rays of ``cfg``'s camera, on ``device``.

    ``backend``: ``"kernel"`` — ``ops.march_kernel.march_rays`` (K3's own
    counter on a CUDA device, its plain twin on the CPU); ``"plain"`` —
    ``core.march.march`` over the generic scene fold ``core.sdf.scene_sd``,
    independent of the kernel form."""
    from ..api import resolve_device
    from ..core import camera as cam
    from ..tables import tables_to_torch

    if backend not in ("kernel", "plain"):
        raise ValueError(f"unknown backend {backend!r}; expected kernel or "
                         "plain")
    with torch.no_grad():
        tables = tables_to_torch(tables, resolve_device(device))
        origin, dirs = cam.generate_rays(tables, cfg)
        dirs = dirs.reshape(-1, 3)
        if backend == "kernel":
            from ..ops.march_kernel import march_rays

            res, steps = march_rays(plan, cfg, tables, origin, dirs,
                                    with_steps=True)
        else:
            from ..core.march import march
            from ..core.sdf import scene_sd

            res, steps = march(lambda p: scene_sd(plan, tables, p), origin,
                               dirs, cfg.iterations, cfg.surface_precision,
                               with_steps=True)
    return march_iteration_stats(res.converged.cpu().numpy(),
                                 steps.cpu().numpy())
