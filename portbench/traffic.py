"""The one generator of the benchmark's traffic: a mix file's parameters and
the seed in, the inputs a run hands the program out.

A mix is ``traffic/<name>.json``.  Its ``kind`` names the runner that runs
it (``runners/<kind>.py``); the rest are parameters, so a new mix of an
existing kind is a data file and nothing else.

``frames``: one closed-loop client renders frame after frame.  Each frame's
camera is a pose of the scene's turntable orbit: the circle in the xz plane
about the mean leaf position, at the scene camera's radius and height,
looking at the centre.  Every seed gets the same ``poses`` angles, evenly
spaced over the full turn, in an order drawn from the seed, so seeds change
the order of the work and not the work.

``fit``: the scene's tables perturbed by the mix's ``perturb`` edits and
fitted back toward the unperturbed scene's image.  An edit names a table, a
row and, where it touches one element, a column; it adds (``add``),
multiplies (``mul``) or sets (``set``) a ``value`` that is fixed or, given
as ``{"uniform": [low, high]}``, drawn from the seed, the edits' draws in
their order.  The demo's mix is ``chip_smoke.py``'s ``perturbed_demo``: the
red sphere moved by a fixed offset and shrunk, the green sphere's colour
tinted, light 0 moved by a fixed offset, with the scale and the tint drawn
from the seed in narrow ranges.  The offsets are fixed so that every seed
fits the same geometry: the step's work does not move with the seed.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np


def load(path) -> dict:
    return json.loads(Path(path).read_text())


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one named use of the seed (any int up to 2**64)."""
    return np.random.Generator(np.random.PCG64([int(seed) % (1 << 64),
                                                *stream]))


def orbit_poses(tables: dict, count: int):
    """(positions [count, 3], directions [count, 3]) float32: ``count``
    poses evenly spaced over the turntable orbit of ``tables``' camera,
    the first at the scene's own angle."""
    pos = np.asarray(tables["prim_pos"], np.float32)
    center = pos.mean(0) if len(pos) else np.zeros(3, np.float32)
    p0 = np.asarray(tables["cam_position"], np.float32) - center
    radius = float(np.hypot(p0[0], p0[2]))
    phi0 = math.atan2(float(p0[2]), float(p0[0]))
    ps, ds = [], []
    for i in range(count):
        phi = phi0 + 2.0 * math.pi * i / count
        p = center + np.array([radius * math.cos(phi), float(p0[1]),
                               radius * math.sin(phi)], np.float32)
        look = center - p
        ps.append(p.astype(np.float32))
        ds.append((look / float(np.linalg.norm(look))).astype(np.float32))
    return np.stack(ps), np.stack(ds)


def frame_schedule(tables: dict, mix: dict, seed: int):
    """The frame client's poses and the order it visits them in:
    (positions, directions, order [poses] int64); frame k of a window
    renders pose order[k % poses]."""
    pos, dirs = orbit_poses(tables, int(mix["poses"]))
    order = rng(seed, 1).permutation(len(pos))
    return pos, dirs, order


def pixel_sample(g: np.random.Generator, height: int, width: int, m: int,
                 device):
    """(rows, columns) of ``m`` pixels drawn by ``g``, float tensors on
    ``device``: the pixels a frame's check compares."""
    import torch
    return (torch.as_tensor(g.integers(height, size=m), device=device).float(),
            torch.as_tensor(g.integers(width, size=m), device=device).float())


def perturb(tables: dict, mix: dict, seed: int) -> dict:
    """The fit's start: ``tables`` (arrays by name, not modified) with the
    edits of ``mix["perturb"]``, their draws from the seed."""
    g = rng(seed, 2)
    out = {k: np.array(v, copy=True) for k, v in tables.items()}
    for e in mix["perturb"]:
        v = e["value"]
        if isinstance(v, dict):
            v = g.uniform(*v["uniform"])
        v = np.asarray(v, out[e["table"]].dtype)
        row = out[e["table"]][int(e["row"])]
        at = slice(None) if e.get("col") is None else int(e["col"])
        if e["op"] == "add":
            row[at] += v
        elif e["op"] == "mul":
            row[at] *= v
        elif e["op"] == "set":
            row[at] = v
        else:
            raise ValueError(f"no perturbation op {e['op']!r}")
    return out
