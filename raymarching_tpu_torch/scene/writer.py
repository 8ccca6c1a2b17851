"""Scene writer: CSG tree / fitted tables -> objects.txt text.

Round-trip completion for the reference grammar (README.md:62-79): scenes
parsed with :mod:`parser`, optimized with :mod:`raymarching_tpu.optimize`,
can be written back out as scene files loadable by this framework AND by the
reference binary.

Two entry points:
  * :func:`scene_to_text` — serialize a CSG tree (exact round trip; Menger/
    DeathStar provenance nodes re-emit their generator command).
  * :func:`tables_to_text` — serialize fitted ``SceneTables`` against the
    original tree structure (per-primitive updates; generator groups are
    re-emitted from their base primitive's fitted position/size).

The port's own copy of ``raymarching_tpu.scene.writer`` (same names, same behaviour; a test
holds the two equal), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import io

import numpy as np

from .compile import SceneTables
from .csg import (Box, Cross, Julia, ListNode, Mandelbox, Mandelbulb, Mode,
                  Sphere)
from .generators import DeathStarNode, MengerNode
from .objects import Camera
from .parser import Scene


def _fmt(*values) -> str:
    return " ".join(f"{float(v):.9g}" for v in values)


def _emit_color(out, color, state):
    color = tuple(float(c) for c in color)
    if state.get("color") != color:
        out.write(f"Color {_fmt(*color)}\n")
        state["color"] = color


def scene_to_text(scene: Scene) -> str:
    """Serialize a parsed/constructed Scene back to the text grammar."""
    out = io.StringIO()
    cam = scene.camera
    out.write(f"Camera Position {_fmt(*cam.position)}\n")
    out.write(f"Camera Direction {_fmt(*cam.direction)}\n")
    out.write(f"Camera Up {_fmt(*cam.up)}\n")
    out.write(f"Camera FOV {_fmt(cam.fov)}\n\n")
    lc_state = (1.0, 1.0, 1.0)
    for light in scene.lights:
        color = tuple(float(c) for c in light.color)
        if color != lc_state:
            out.write(f"LightColor {_fmt(*color)}\n")
            lc_state = color
        out.write(f"Light {_fmt(*light.position)}\n")
    out.write("\n")

    state = {}
    for child in scene.tree.children:
        _emit_node(out, child, state)
    return out.getvalue()


def _is_bounds(node) -> bool:
    return (isinstance(node, ListNode) and node.mode == Mode.COMPLEMENT
            and len(node.children) == 1
            and isinstance(node.children[0], Box)
            and node.children[0].position == (0.0, 0.0, 0.0)
            and len(set(node.children[0].size)) == 1)


def _is_death_star(node) -> bool:
    # Provenance nodes serialize from their base sphere even after fitting
    # (the grammar derives the carve sphere from the base; independent
    # fitted carve parameters are not representable and are dropped).
    if isinstance(node, DeathStarNode):
        return True
    if not (isinstance(node, ListNode) and node.mode == Mode.DIFFERENCE
            and len(node.children) == 2
            and all(isinstance(c, Sphere) for c in node.children)):
        return False
    a, b = node.children
    return (a.radius == b.radius
            and b.position == (a.position[0] + 1.5 * a.radius,
                               a.position[1], a.position[2]))


def _emit_node(out, node, state) -> None:
    if _is_bounds(node):
        out.write(f"Bounds {_fmt(node.children[0].size[0])}\n")
        return
    if isinstance(node, MengerNode):
        box = node.children[0]
        _emit_color(out, box.color, state)
        out.write(f"MengerSponge {_fmt(*box.position)} "
                  f"{_fmt(box.size[0])} {node.iterations}\n")
        return
    if _is_death_star(node):
        a = node.children[0]
        _emit_color(out, a.color, state)
        out.write(f"DeathStar {_fmt(*a.position)} {_fmt(a.radius)}\n")
        return
    if isinstance(node, Sphere):
        _emit_color(out, node.color, state)
        out.write(f"Sphere {_fmt(*node.position)} {_fmt(node.radius)}\n")
        return
    if isinstance(node, Box):
        _emit_color(out, node.color, state)
        out.write(f"Box {_fmt(*node.position)} {_fmt(*node.size)}\n")
        return
    if isinstance(node, Cross):
        _emit_color(out, node.color, state)
        out.write(f"Cross {_fmt(*node.position)} {_fmt(*node.size)}\n")
        return
    if isinstance(node, Mandelbox):
        _emit_color(out, node.color, state)
        out.write(f"Mandelbox {_fmt(*node.position)} {_fmt(node.size)} "
                  f"{_fmt(node.scale)} {node.iterations}\n")
        return
    if isinstance(node, Mandelbulb):
        _emit_color(out, node.color, state)
        out.write(f"Mandelbulb {_fmt(*node.position)} {_fmt(node.size)} "
                  f"{node.iterations}\n")
        return
    if isinstance(node, Julia):
        _emit_color(out, node.color, state)
        out.write(f"Julia {_fmt(*node.position)} {_fmt(node.size)} "
                  f"{_fmt(*node.c)} {node.iterations}\n")
        return
    raise ValueError(
        f"cannot serialize {type(node).__name__}: no objects.txt syntax "
        "for general nested lists (the grammar only has generators)")


def tables_to_scene(scene: Scene, tables: SceneTables) -> Scene:
    """Write fitted table values back into a copy of the scene's tree
    (leaf order matches compile's DFS numbering)."""
    import copy

    from .csg import iter_primitives

    scene = copy.deepcopy(scene)
    pos = np.asarray(tables.prim_pos)
    aux = np.asarray(tables.prim_aux)
    col = np.asarray(tables.prim_color)
    for i, prim in enumerate(iter_primitives(scene.tree)):
        prim.position = tuple(float(v) for v in pos[i])
        prim.color = tuple(float(v) for v in col[i])
        if isinstance(prim, Sphere):
            prim.radius = float(aux[i, 0])
        elif isinstance(prim, (Mandelbox, Mandelbulb, Julia)):
            prim.size = float(aux[i, 0])
        else:
            prim.size = tuple(float(v) for v in aux[i])
    lp = np.asarray(tables.light_pos)
    lc = np.asarray(tables.light_color)
    for i, light in enumerate(scene.lights):
        light.position = tuple(float(v) for v in lp[i])
        light.color = tuple(float(v) for v in lc[i])
    scene.camera = Camera(
        position=tuple(np.asarray(tables.cam_position).tolist()),
        direction=tuple(np.asarray(tables.cam_direction).tolist()),
        up=tuple(np.asarray(tables.cam_up).tolist()),
        fov=float(tables.cam_fov))
    return scene


def tables_to_text(scene: Scene, tables: SceneTables) -> str:
    """Serialize fitted tables using the original scene's structure."""
    return scene_to_text(tables_to_scene(scene, tables))
