"""The benchmark's own reading of a scene file: parse and flatten.

The grammar is the reference project's (RevelcoS/Raymarching, README.md:62-79,
scene.cpp:92-190): ``Bounds``, ``Sphere``, ``Box``, ``Cross``, ``DeathStar``,
``MengerSponge``, ``Light``, ``Camera Position|Direction|Up|FOV`` and
``Color``; other keywords are skipped, as the reference's loader skips them.
Bodies form one root UNION in file order; ``Bounds`` is a COMPLEMENT list
around a black box at the origin; ``DeathStar`` is a DIFFERENCE of a sphere
and the same sphere moved 1.5 r in x; ``MengerSponge`` is a DIFFERENCE of a
box and its crosses, appended depth first in the reference's subcell order
(body.cpp:113-170).

Leaves are numbered depth first, and ``tables`` lays them out as rows of
``prim_pos``, ``prim_aux`` and ``prim_color``: the nine named arrays that
the renderer under test takes as its scene tables.  The benchmark checks
that the program's compiled tables equal these, so both sides start from
one scene.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

SPHERE, BOX, CROSS = 0, 1, 2
UNION, COMPLEMENT, INTERSECTION, DIFFERENCE = 0, 1, 2, 3

# The 20 subcell offsets (units of d), front 8, back 8, middle 4
# (body.cpp:119-144).
MENGER_OFFSETS = (
    (1, -1, -1), (0, -1, -1), (-1, -1, -1),
    (1, 1, -1), (0, 1, -1), (-1, 1, -1),
    (-1, 0, -1), (1, 0, -1),
    (1, -1, 1), (0, -1, 1), (-1, -1, 1),
    (1, 1, 1), (0, 1, 1), (-1, 1, 1),
    (-1, 0, 1), (1, 0, 1),
    (-1, -1, 0), (1, -1, 0),
    (-1, 1, 0), (1, 1, 0),
)

TABLE_FIELDS = ("prim_pos", "prim_aux", "prim_color", "light_pos",
                "light_color", "cam_position", "cam_direction", "cam_up",
                "cam_fov")


@dataclasses.dataclass
class Body:
    """One child of the root UNION: a leaf (``mode`` None) or a list of
    leaves ``start .. start + count - 1`` folded by ``mode``.  ``kind``
    names what the scene line made ("sphere", "box", "cross", "bounds",
    "deathstar", "menger"); ``iterations`` is a sponge's."""

    kind: str
    mode: Optional[int]
    start: int
    count: int
    iterations: int = 0


@dataclasses.dataclass
class Scene:
    ptype: np.ndarray            # [P] int
    pos: np.ndarray              # [P, 3] float32
    aux: np.ndarray              # [P, 3] float32
    color: np.ndarray            # [P, 3] float32
    bodies: List[Body]
    lights: np.ndarray           # [L, 3] float32
    camera: dict                 # position, direction, up (float32 [3]), fov

    def tables(self) -> dict:
        """The nine scene tables as float32 arrays, by field name."""
        L = max(len(self.lights), 1)
        lp = np.zeros((L, 3), np.float32)
        lp[:len(self.lights)] = self.lights
        return {
            "prim_pos": self.pos.copy(), "prim_aux": self.aux.copy(),
            "prim_color": self.color.copy(), "light_pos": lp,
            "light_color": np.ones((L, 3), np.float32),
            "cam_position": np.asarray(self.camera["position"], np.float32),
            "cam_direction": np.asarray(self.camera["direction"],
                                        np.float32),
            "cam_up": np.asarray(self.camera["up"], np.float32),
            "cam_fov": np.asarray(self.camera["fov"], np.float32),
        }


def _menger(out: list, position, size: float, iterations: int, color):
    d = size / 3.0
    out.append((CROSS, position, (d, d, d), color))
    if iterations >= 2:
        for ox, oy, oz in MENGER_OFFSETS:
            sub = (position[0] + ox * d, position[1] + oy * d,
                   position[2] + oz * d)
            _menger(out, sub, d, iterations - 1, color)


def parse(text: str) -> Scene:
    leaves: List[Tuple] = []      # (type, pos, aux, color)
    bodies: List[Body] = []
    lights: List[Tuple[float, float, float]] = []
    camera = {"position": (0.0, 0.0, 0.0), "direction": (0.0, 0.0, -1.0),
              "up": (0.0, 1.0, 0.0), "fov": 90.0}
    color = (1.0, 1.0, 1.0)

    def body(kind, mode, items, iterations=0):
        bodies.append(Body(kind, mode, len(leaves), len(items), iterations))
        leaves.extend(items)

    for line in text.splitlines():
        tok = line.split()
        if not tok:
            continue
        cmd, a = tok[0], tok[1:]
        try:
            if cmd == "Sphere":
                x, y, z, r = map(float, a[:4])
                body("sphere", None, [(SPHERE, (x, y, z), (r, 0.0, 0.0),
                                       color)])
            elif cmd in ("Box", "Cross"):
                x, y, z, sx, sy, sz = map(float, a[:6])
                t = BOX if cmd == "Box" else CROSS
                body(cmd.lower(), None, [(t, (x, y, z), (sx, sy, sz), color)])
            elif cmd == "Bounds":
                s = float(a[0])
                body("bounds", COMPLEMENT, [(BOX, (0.0, 0.0, 0.0), (s, s, s),
                                             (0.0, 0.0, 0.0))])
            elif cmd == "DeathStar":
                x, y, z, r = map(float, a[:4])
                body("deathstar", DIFFERENCE,
                     [(SPHERE, (x, y, z), (r, 0.0, 0.0), color),
                      (SPHERE, (x + 1.5 * r, y, z), (r, 0.0, 0.0), color)])
            elif cmd == "MengerSponge":
                x, y, z, size = map(float, a[:4])
                iters = int(a[4])
                items = [(BOX, (x, y, z), (size, size, size), color)]
                _menger(items, (x, y, z), size, iters, color)
                body("menger", DIFFERENCE, items, iters)
            elif cmd == "Light":
                lights.append(tuple(map(float, a[:3])))
            elif cmd == "Camera":
                sub, rest = a[0], a[1:]
                if sub in ("Position", "Direction", "Up"):
                    camera[sub.lower()] = tuple(map(float, rest[:3]))
                elif sub == "FOV":
                    camera["fov"] = float(rest[0])
            elif cmd == "Color":
                color = tuple(map(float, a[:3]))
        except (ValueError, IndexError) as e:
            raise ValueError(f"malformed scene line: {line!r}") from e

    n = len(leaves)
    ptype = np.array([t for t, *_ in leaves], np.int64)
    pos = np.array([p for _, p, _, _ in leaves], np.float32).reshape(n, 3)
    aux = np.array([s for _, _, s, _ in leaves], np.float32).reshape(n, 3)
    col = np.array([c for *_, c in leaves], np.float32).reshape(n, 3)
    return Scene(ptype=ptype, pos=pos, aux=aux, color=col, bodies=bodies,
                 lights=np.array(lights, np.float32).reshape(-1, 3),
                 camera=camera)


def load(path) -> Scene:
    with open(path) as f:
        return parse(f.read())
