"""Procedural CSG generators: Menger sponge and Death Star.

Behavioral spec from the reference (body.cpp:113-170):

  - ``MengerSponge(pos, size, iters, color)`` builds ONE flat DIFFERENCE list:
    first child a ``size``^3 Box, followed by crosses appended depth-first —
    at each recursion level a Cross of size d = size/3 at the cell centre,
    then (if iterations >= 2) recursion into 20 subcells of size d at offsets
    in {-d, 0, +d}^3 excluding the 6 face centres and the body centre, in the
    reference's exact order (front 8, back 8, middle 4).  iters=3 yields
    1 + 1 + 20 + 400 = 422 bodies.
  - ``DeathStar(pos, r, color)`` = DIFFERENCE list of a sphere minus an equal
    sphere offset +1.5 r in x.

Child order is preserved exactly because the fold's first-wins tie-break makes
order observable through colors (SURVEY §2 fine print).

The port's own copy of ``raymarching_tpu.scene.generators`` (same names, same behaviour; a test
holds the two equal), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

from .csg import Box, Cross, ListNode, Mode, Sphere, Vec3, WHITE

# The 20 subcell offsets (units of d) in reference order (body.cpp:119-144):
# front 8 (z=-1), back 8 (z=+1), middle 4 (z=0).
_MENGER_OFFSETS = (
    (1, -1, -1), (0, -1, -1), (-1, -1, -1),
    (1, 1, -1), (0, 1, -1), (-1, 1, -1),
    (-1, 0, -1), (1, 0, -1),
    (1, -1, 1), (0, -1, 1), (-1, -1, 1),
    (1, 1, 1), (0, 1, 1), (-1, 1, 1),
    (-1, 0, 1), (1, 0, 1),
    (-1, -1, 0), (1, -1, 0),
    (-1, 1, 0), (1, 1, 0),
)


def _generate_menger(result: ListNode, position: Vec3, size: float,
                     iterations: int, color: Vec3) -> None:
    d = size / 3.0
    result.append(Cross(position=position, size=(d, d, d), color=color))
    if iterations >= 2:
        for ox, oy, oz in _MENGER_OFFSETS:
            sub = (position[0] + ox * d, position[1] + oy * d, position[2] + oz * d)
            _generate_menger(result, sub, d, iterations - 1, color)


import dataclasses


@dataclasses.dataclass
class MengerNode(ListNode):
    """A Menger sponge DIFFERENCE list with provenance.

    Behaves exactly like the explicit 422-body list; the ``iterations``
    field lets the scene compiler additionally emit a fused space-folding
    evaluation (O(iterations) per query instead of O(20^k)) for the Pallas
    fast path — see ops.pallas_march and RenderConfig.fused_generators."""

    iterations: int = 3


def menger_sponge(position: Vec3, size: float, iterations: int = 3,
                  color: Vec3 = WHITE) -> ListNode:
    """Box minus a depth-first union of crosses (body.cpp:149-156)."""
    result = MengerNode(Mode.DIFFERENCE, iterations=int(iterations))
    result.append(Box(position=position, size=(size, size, size), color=color))
    _generate_menger(result, tuple(position), float(size), int(iterations), color)
    return result


@dataclasses.dataclass
class DeathStarNode(ListNode):
    """DeathStar DIFFERENCE list with provenance (for scene serialization —
    the objects.txt grammar can only express this CSG via its generator
    command)."""


def death_star(position: Vec3, radius: float, color: Vec3 = WHITE) -> ListNode:
    """Sphere minus sphere offset +1.5r in x (body.cpp:159-169)."""
    result = DeathStarNode(Mode.DIFFERENCE)
    result.append(Sphere(position=position, radius=radius, color=color))
    diff_pos = (position[0] + 1.5 * radius, position[1], position[2])
    result.append(Sphere(position=diff_pos, radius=radius, color=color))
    return result


def menger_body_count(iterations: int) -> int:
    """1 box + sum_{k=0}^{iters-1} 20^k crosses.  The generator always emits
    at least one cross (the recursion guard is ``iterations >= 2``,
    body.cpp:121), so iterations <= 1 still yields 2 bodies."""
    return 1 + sum(20 ** k for k in range(max(iterations, 1)))
