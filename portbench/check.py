"""The comparisons that decide ``correct``: the program's outputs against
the plain reference (``reference/``), each number against its limit
(``limits/<cell>.json``).

Frames: a seeded sample of pixels of frames the window rendered, each the
mean of its SSAA samples by the reference at that frame's pose; a pixel is
off when a channel differs by more than ``PIXEL_TOL`` (a quarter of an
8-bit level).  ``px_off_share`` is the share of sampled pixels off.

Fit: the window's own fit against the reference's, over its first step.
``loss_gap`` is |loss - loss_ref| / loss_ref; ``grad_gap`` and
``change_gap`` go by the worst field ("leaf"): the gap between the
program's norm and the reference's, of the first step's gradient (as
Adam's state holds it) and of the fields' change by that step, over the
larger of the reference's norm of that leaf and of the median leaf.  The
change leaves out the leaves whose reference gradient is under a thousandth
of the median leaf's: Adam moves them by round-off alone.  Later steps are
not compared: the implicit-function gradient is carried by a few grazing
rays, and the first step's round-off (parameters 1e-5 apart) moves which
rays graze, so from the second step the two sides' gradients differ by
whole factors on every seed (PERF.md, Findings).

Inputs: ``tables_off`` counts the elements of the program's compiled scene
tables that differ from the reference's reading of the same file (limit 0),
so both sides start from one scene.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

PIXEL_TOL = 1e-3


def tables_off(program: dict, reference: dict) -> int:
    off = 0
    for k, want in reference.items():
        got = np.asarray(program[k], np.float32)
        want = np.asarray(want, np.float32)
        off += (want.size if got.shape != want.shape
                else int(np.count_nonzero(got != want)))
    return off


def pixels_off(got, want) -> int:
    """Pixels [n, 3] of ``got`` that differ from ``want`` by more than
    PIXEL_TOL in a channel (a NaN is off)."""
    d = (got.double() - want.double()).abs()
    d = torch.nan_to_num(d, nan=float("inf"))
    return int((d.max(dim=1).values > PIXEL_TOL).sum())


def _norms(fields: dict) -> dict:
    return {k: (0.0 if v is None else float(torch.as_tensor(v).double()
                                            .norm()))
            for k, v in fields.items()}


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    rn = _norms(ref)
    pn = _norms(prog)
    med = float(np.median([rn[k] for k in keep])) if keep else 0.0
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep]
    return max(gaps) if gaps else 0.0


def fit_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: losses [steps], grad0 {field: tensor or
    None}, theta0 and theta (after the steps) {field: tensor}."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    fields = list(ref["grad0"])
    rg = _norms(ref["grad0"])
    med = float(np.median(list(rg.values())))
    moved = [k for k in fields if rg[k] >= 1e-3 * med]

    def change(side):
        return {k: torch.as_tensor(side["theta"][k]).double().cpu()
                - torch.as_tensor(side["theta0"][k]).double().cpu()
                for k in fields}
    return {
        "loss_gap": max(losses),
        "grad_gap": _leaf_gap(prog["grad0"], ref["grad0"], fields),
        "change_gap": _leaf_gap(change(prog), change(ref), moved),
    }


def load_limits(path) -> dict:
    return {k: v for k, v in json.loads(Path(path).read_text()).items()
            if isinstance(v, dict) and "limit" in v}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number with no limit, or a NaN, fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        good = (limit is not None and value == value and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
