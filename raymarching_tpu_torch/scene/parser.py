"""Scene text-file parser.

Implements the exact line-oriented grammar of the reference loader
(scene.cpp:92-190, grammar documented at reference README.md:62-79) so
existing ``scene/objects.txt`` files run unchanged:

    Bounds <size>
    Sphere <x> <y> <z> <radius>
    Box    <x> <y> <z> <sx> <sy> <sz>
    Cross  <x> <y> <z> <sx> <sy> <sz>
    DeathStar    <x> <y> <z> <radius>
    MengerSponge <x> <y> <z> <size> <iterations>
    Light  <x> <y> <z>
    Camera Position|Direction|Up <x> <y> <z>
    Camera FOV <deg>
    Color  <r> <g> <b>
    LightColor <r> <g> <b>      (extension, see below)
    Material <name> <r> <g> <b>                             (extension)
    Color <name> / LightColor <name>                        (extension)
    Mandelbox <x> <y> <z> <size> [scale=2] [iterations=8]   (extension)
    Mandelbulb <x> <y> <z> <size> [iterations=6]            (extension)
    Julia <x> <y> <z> <size> <cx> <cy> <cz> <cw> [iterations=11]  (ext.)

Statefulness matches the reference: a running "current color" (default white)
set by ``Color`` lines is applied to subsequently created bodies
(scene.cpp:99, 183-185); unknown leading keywords are silently ignored (the
C++ falls through every branch), which doubles as comment support; bodies are
appended to a root UNION list in file order; ``Bounds`` becomes a
COMPLEMENT-list-wrapped black box (scene.cpp:120-127).

``LightColor`` is this framework's scene-format extension: the reference
declares a per-light color field but never parses a value for it
(object.h:24, scene.cpp:154-158), so every reference light is white.  A
``LightColor`` line sets a running current light color (default white)
applied to subsequent ``Light`` lines; in the reference binary the unknown
keyword falls through silently, so extended scenes still load there (with
white lights).  Non-white lights switch shading to per-channel accumulation
(core.shading.lighting) and make ``tables.light_color`` differentiable.

``Material`` names a reusable color: ``Material steel 0.6 0.6 0.65``
defines it, and a subsequent ``Color steel`` (or ``LightColor steel``)
selects it exactly as the numeric form would — the named form is pure
sugar over the reference's running-color state, so materials never reach
the compiled tables.  Names may be redefined (later definition wins for
subsequent uses); an undefined name is a parse error.  In the reference
binary ``Material`` lines fall through silently, but ``Color <name>``
does not parse there — scenes meant to stay reference-loadable should
keep numeric ``Color`` lines.

``Mandelbox``, ``Mandelbulb``, and ``Julia`` are likewise extensions
(silently skipped by the reference binary): procedural fractal distance
estimates the CSG table cannot express at any size — see scene.csg for
each iteration's semantics.  Their trailing parameters (fold scale,
iteration counts, the Julia quaternion constant) are structural (compiled
into the plan); position/size/color behave like any other primitive.

The port's own copy of ``raymarching_tpu.scene.parser`` (same names, same behaviour; a test
holds the two equal), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List

from . import generators
from .csg import (Box, Cross, Julia, ListNode, Mandelbox, Mandelbulb, Mode,
                  Sphere, bounds)
from .objects import Camera, Light


@dataclasses.dataclass
class Scene:
    """A parsed scene: root CSG tree + lights + camera."""

    tree: ListNode
    lights: List[Light]
    camera: Camera

    @property
    def num_primitives(self) -> int:
        from .csg import count_primitives

        return count_primitives(self.tree)


def parse_scene(text: str) -> Scene:
    tree = ListNode(Mode.UNION)
    lights: List[Light] = []
    camera = Camera()
    color = (1.0, 1.0, 1.0)
    light_color = (1.0, 1.0, 1.0)
    materials: dict = {}

    def resolve_color(args):
        """Numeric ``r g b`` or a defined material name."""
        try:
            return tuple(map(float, args[:3]))
        except ValueError:
            if args and args[0] in materials:
                return materials[args[0]]
            raise ValueError(f"unknown material {args[0]!r}") from None

    for line in text.splitlines():
        tokens = line.split()
        if not tokens:
            continue
        cmd, args = tokens[0], tokens[1:]

        try:
            if cmd == "Sphere":
                x, y, z, r = map(float, args[:4])
                tree.append(Sphere((x, y, z), r, color))
            elif cmd == "Box":
                x, y, z, sx, sy, sz = map(float, args[:6])
                tree.append(Box((x, y, z), (sx, sy, sz), color))
            elif cmd == "Cross":
                x, y, z, sx, sy, sz = map(float, args[:6])
                tree.append(Cross((x, y, z), (sx, sy, sz), color))
            elif cmd == "Mandelbox":
                x, y, z, size = map(float, args[:4])
                mscale = float(args[4]) if len(args) > 4 else 2.0
                miters = int(args[5]) if len(args) > 5 else 8
                tree.append(Mandelbox((x, y, z), size, mscale, miters,
                                      color))
            elif cmd == "Mandelbulb":
                x, y, z, size = map(float, args[:4])
                biters = int(args[4]) if len(args) > 4 else 6
                tree.append(Mandelbulb((x, y, z), size, biters, color))
            elif cmd == "Julia":
                x, y, z, size, ca, cb, cc, cd = map(float, args[:8])
                jiters = int(args[8]) if len(args) > 8 else 11
                tree.append(Julia((x, y, z), size, (ca, cb, cc, cd),
                                  jiters, color))
            elif cmd == "Bounds":
                size = float(args[0])
                tree.append(bounds(size))
            elif cmd == "DeathStar":
                x, y, z, r = map(float, args[:4])
                tree.append(generators.death_star((x, y, z), r, color))
            elif cmd == "MengerSponge":
                x, y, z, size = map(float, args[:4])
                iters = int(args[4])
                tree.append(generators.menger_sponge((x, y, z), size, iters, color))
            elif cmd == "Light":
                x, y, z = map(float, args[:3])
                lights.append(Light((x, y, z), color=light_color))
            elif cmd == "Camera":
                sub, rest = args[0], args[1:]
                if sub == "Position":
                    camera.position = tuple(map(float, rest[:3]))
                elif sub == "Direction":
                    camera.direction = tuple(map(float, rest[:3]))
                elif sub == "Up":
                    camera.up = tuple(map(float, rest[:3]))
                elif sub == "FOV":
                    camera.fov = float(rest[0])
            elif cmd == "Color":
                color = resolve_color(args)
            elif cmd == "LightColor":
                light_color = resolve_color(args)
            elif cmd == "Material":
                if len(args) < 4:
                    raise ValueError("Material needs <name> <r> <g> <b>")
                materials[args[0]] = tuple(map(float, args[1:4]))
            # Unknown keywords fall through silently, like the reference.
        except (ValueError, IndexError) as e:
            raise ValueError(f"malformed scene line: {line!r}") from e

    return Scene(tree=tree, lights=lights, camera=camera)


def load_scene(path: str) -> Scene:
    with open(path, "r") as f:
        return parse_scene(f.read())
