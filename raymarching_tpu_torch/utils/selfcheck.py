"""Failure detection: deterministic re-render and an oracle check (the
port's counterpart of ``raymarching_tpu.utils.selfcheck``).

A render is a pure function of (plan, tables, cfg), and every kernel of
the port gives the same bits for the same work, so two renders of the
same frame on one device must be equal bit for bit: a difference is a
fault of the card or the runtime that no exception reports, and the
tiles that differ say where.  That cannot see a kernel that is wrong the
same way every time; the oracle check can, by holding the frame to the
port's plain ``ref`` backend at a reduced resolution.

  * ``rerun_check``   — render ``repeats`` times, compare bitwise, report
                        the tiles that differ;
  * ``oracle_check``  — the backend against ``ref`` at 1/8 resolution
                        (at least 32 x 32), by the share of pixels beyond
                        a tolerance;
  * ``assert_healthy`` — both, raising RuntimeError on a failure (the
                        CLI's ``--selfcheck``).

Each returns a report and emits it through ``utils.structlog``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import api
from ..config import RenderConfig
from ..scene.compile import ScenePlan, SceneTables
from .structlog import emit


def _tile_mismatches(a: np.ndarray, b: np.ndarray,
                     tile: Tuple[int, int]) -> list:
    """[(row0, col0, count), ...] for tiles where a != b (bitwise)."""
    th, tw = tile
    h, w = a.shape[:2]
    out = []
    neq = np.any(a != b, axis=-1)
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            n = int(neq[r0:r0 + th, c0:c0 + tw].sum())
            if n:
                out.append((r0, c0, n))
    return out


def _render(plan, tables, cfg, backend, device) -> np.ndarray:
    return api.render_tables(plan, tables, cfg, backend=backend,
                             device=device).cpu().numpy()


def rerun_check(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                *, backend: str = "cuda", repeats: int = 2,
                tile: Tuple[int, int] = (64, 64), device) -> dict:
    """Render ``repeats`` times on ``device``; any bitwise difference is a
    fault.  The report lists the first 16 differing tiles of each repeat
    that differs from the first render."""
    imgs = [_render(plan, tables, cfg, backend, device)
            for _ in range(repeats)]
    bad = []
    worst = 0.0
    for i, img in enumerate(imgs[1:], start=1):
        tiles = _tile_mismatches(imgs[0], img, tile)
        if tiles:
            bad.append({"repeat": i, "tiles": tiles[:16],
                        "tiles_total": len(tiles)})
            worst = max(worst, float(np.abs(imgs[0] - img).max()))
    report = {
        "check": "rerun", "ok": not bad, "repeats": repeats,
        "backend": backend, "rays": cfg.rays_per_image,
        "max_abs_diff": worst, "mismatches": bad,
    }
    emit("selfcheck", **{k: v for k, v in report.items() if k != "mismatches"},
         mismatch_repeats=len(bad))
    return report


def oracle_check(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                 *, backend: str = "cuda", tol: float = 5e-3,
                 max_bad_frac: float = 0.005, device) -> dict:
    """``backend`` against the ``ref`` oracle on ``device`` at 1/8 of the
    resolution (at least 32 x 32): ok while at most ``max_bad_frac`` of
    the pixels differ by more than ``tol`` (FD normals near edges differ
    by about 1e-3 between operation orders)."""
    small = cfg.replace(width=max(cfg.width // 8, 32),
                        height=max(cfg.height // 8, 32), ray_chunk=0)
    fast = _render(plan, tables, small, backend, device)
    ref = _render(plan, tables, small, "ref", device)
    diff = np.abs(fast - ref).max(axis=-1)
    bad_frac = float((diff > tol).mean())
    report = {
        "check": "oracle", "ok": bad_frac <= max_bad_frac,
        "backend": backend, "tol": tol, "bad_pixel_frac": bad_frac,
        "max_abs_diff": float(diff.max()),
        "resolution": [small.width, small.height],
    }
    emit("selfcheck", **report)
    return report


def assert_healthy(plan: ScenePlan, tables: SceneTables,
                   cfg: Optional[RenderConfig] = None, *,
                   backend: str = "cuda", repeats: int = 2, device) -> dict:
    """Both checks (default frame 256 x 192, SSAA 1, 500 iterations);
    raise RuntimeError with the report on a failure."""
    cfg = cfg or RenderConfig(width=256, height=192, ssaa=1, iterations=500)
    r1 = rerun_check(plan, tables, cfg, backend=backend, repeats=repeats,
                     device=device)
    r2 = oracle_check(plan, tables, cfg, backend=backend, device=device)
    report = {"ok": r1["ok"] and r2["ok"], "rerun": r1, "oracle": r2}
    if not report["ok"]:
        raise RuntimeError(f"selfcheck failed: {report}")
    return report
