"""CSG body model: primitives and combinator lists.

Re-design of the reference's pointer-based polymorphic body tree
(``source/body.cpp`` + ``source/include/body.h``) as plain Python dataclasses
used only at scene-construction time.  Nothing here is traced by JAX: the
tree is compiled to flat device tables by :mod:`raymarching_tpu.scene.compile`
before any rendering happens (the TPU analogue of the reference's SSBO
flattening, render.cpp:246-366 — except we do it once, ahead of time, instead
of interpreting the tree with a per-thread stack on the device).

Semantics (body.cpp):
  - ``Surface{SD, color}``; min/max compare by SD with *first*-operand wins on
    ties (std::min/std::max via operator<, body.cpp:12-14).
  - Unary ``-`` negates SD, keeps color (body.cpp:16-18).
  - Sphere SDF:  |c - p| - r                          (body.cpp:32-35)
  - Box SDF:     max(|p - c| - s/2)   (Chebyshev)     (body.cpp:41-45)
  - Cross SDF:   median(b), b=|p-c|-s/2 (the reference's sum-min-max form,
                 body.cpp:51-57, computes this median; see core.sdf._med3)
  - List fold, left to right, first element special-cased (body.cpp:66-111):
      UNION:        s0,  then min(acc, s_i)
      COMPLEMENT:  -s0,  then min(acc, -s_i)
      INTERSECTION: s0,  then max(acc, s_i)
      DIFFERENCE:   s0,  then max(acc, -s_i)
  - Empty list: SD = +inf, color = black (body.cpp:67-70).  (The reference's
    GLSL path returns white here, shader.comp:185-187; we standardise on the
    C++ semantic.)

The port's own copy of ``raymarching_tpu.scene.csg`` (same names, same behaviour; a test
holds the two equal), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import struct
from typing import List as PyList, Tuple, Union


def _f32(v: float) -> float:
    """Round-trip through float32 — structural fractal params are baked
    into compiled plans AND cross the C ABI as f32; canonicalizing here
    keeps the Python- and native-parsed plans equal (same jit cache key)."""
    return struct.unpack("f", struct.pack("f", float(v)))[0]

Vec3 = Tuple[float, float, float]

WHITE: Vec3 = (1.0, 1.0, 1.0)
BLACK: Vec3 = (0.0, 0.0, 0.0)


class Mode(enum.IntEnum):
    """List combination modes (body.h:17-22)."""

    UNION = 0
    COMPLEMENT = 1
    INTERSECTION = 2
    DIFFERENCE = 3


class PrimType(enum.IntEnum):
    """Leaf primitive type codes used in the flat tables."""

    SPHERE = 0
    BOX = 1
    CROSS = 2
    MANDELBOX = 3     # extension — iterated box/sphere-fold fractal DE
    MANDELBULB = 4    # extension — power-8 triplex fractal DE
    JULIA = 5         # extension — quaternion z^2 + c Julia-set DE


def _v3(x) -> Vec3:
    t = tuple(float(v) for v in x)
    if len(t) != 3:
        raise ValueError(f"expected 3 components, got {x!r}")
    return t  # type: ignore[return-value]


@dataclasses.dataclass
class Sphere:
    position: Vec3
    radius: float
    color: Vec3 = WHITE

    def __post_init__(self):
        self.position = _v3(self.position)
        self.color = _v3(self.color)
        self.radius = float(self.radius)

    def sdf(self, p: Vec3) -> float:
        """Scalar reference SDF (used by tests / the pure-Python oracle)."""
        d = math.dist(self.position, p)
        return d - self.radius


@dataclasses.dataclass
class Box:
    position: Vec3
    size: Vec3
    color: Vec3 = WHITE

    def __post_init__(self):
        self.position = _v3(self.position)
        self.size = _v3(self.size)
        self.color = _v3(self.color)

    def sdf(self, p: Vec3) -> float:
        b = [abs(p[i] - self.position[i]) - self.size[i] / 2.0 for i in range(3)]
        return max(b)


@dataclasses.dataclass
class Cross:
    position: Vec3
    size: Vec3
    color: Vec3 = WHITE

    def __post_init__(self):
        self.position = _v3(self.position)
        self.size = _v3(self.size)
        self.color = _v3(self.color)

    def sdf(self, p: Vec3) -> float:
        b = [abs(p[i] - self.position[i]) - self.size[i] / 2.0 for i in range(3)]
        # median of the three excesses — the exact value of the reference's
        # sum-min-max form (body.cpp:51-57); see core.sdf._med3 for why the
        # framework computes the median directly
        return sorted(b)[1]


@dataclasses.dataclass
class Mandelbox:
    """Mandelbox fractal distance estimate (scene-format EXTENSION; the
    reference has no procedural SDF primitives, body.h:25-33 — this adds a
    model family the CSG table cannot express at any size).

    The classic Rrrola iteration in unit space, scaled by ``size``:

        q0 = (p - position) / size;  q = q0;  dr = 1
        repeat ``iterations`` times:
            q  = clamp(q, -1, 1) * 2 - q              (box fold)
            f  = 4        if |q|^2 < 1/4              (sphere fold)
                 1/|q|^2  if 1/4 <= |q|^2 < 1
                 1        otherwise
            q  = scale * f * q + q0
            dr = |scale| * f * dr + 1
        DE = size * |q| / dr

    A (non-negative) distance UNDERESTIMATE — sphere tracing converges to
    the fractal surface exactly like any SDF; CSG folds treat it as a leaf
    distance.  Differentiable parameters: ``position`` and ``size`` (the DE
    is homogeneous: DE(p; c, s) = s * DE((p-c)/s; 0, 1), which the exact
    winner backward exploits — ops.scene_vjp.theta_cotangents).  ``scale``
    and ``iterations`` are structural (baked into the compiled plan).
    """

    position: Vec3
    size: float
    scale: float = 2.0
    iterations: int = 8
    color: Vec3 = WHITE

    def __post_init__(self):
        self.position = _v3(self.position)
        self.color = _v3(self.color)
        self.size = float(self.size)
        self.scale = _f32(self.scale)
        self.iterations = int(self.iterations)
        if self.iterations < 1:
            raise ValueError("Mandelbox iterations must be >= 1")

    def sdf(self, p: Vec3) -> float:
        q0 = tuple((p[i] - self.position[i]) / self.size for i in range(3))
        q = q0
        dr = 1.0
        for _ in range(self.iterations):
            q = tuple(max(-1.0, min(1.0, v)) * 2.0 - v for v in q)
            r2 = sum(v * v for v in q)
            f = 4.0 if r2 < 0.25 else (1.0 / r2 if r2 < 1.0 else 1.0)
            q = tuple(self.scale * f * v + q0[i] for i, v in enumerate(q))
            dr = abs(self.scale) * f * dr + 1.0
        return self.size * math.sqrt(sum(v * v for v in q)) / dr


@dataclasses.dataclass
class Mandelbulb:
    """Power-8 Mandelbulb distance estimate (scene-format EXTENSION, like
    [[Mandelbox]] — a second procedural model family with no reference
    counterpart, body.h:25-33).

    The White–Nylander triplex iteration w <- w^8 + q0 in unit space,
    scaled by ``size``, with the classic escape-time distance estimate

        DE = size * 0.25 * log(m) * sqrt(m) / dz,   m = |w|^2,
        dz accumulating 8*m^3.5*dz + 1 per live step.

    w^8 is evaluated TRIG-FREE: the spherical power collapses to a
    polynomial in (x, y, z) (the standard power-8 algebraic identity),
    restructured here so the (x, z)-plane radius is factored out as a unit
    vector — the raw polynomial divides by (x^2+z^2)^3.5, which is 0/0 on
    the y-axis; the factored form is exact off-axis and finite (with a
    zero y-axis limit) on it.  Escaped lanes (m > 256) are frozen by
    masking, so the fixed-trip-count unrolled loop is value-identical to
    the scalar early-break form.

    Signed: negative inside (log m < 0 for m < 1).  Homogeneous in size
    like every leaf — DE(p; c, s) = s * DE((p-c)/s; 0, 1) — so the winner
    backward's homogeneity-based size cotangent applies unchanged
    (ops.scene_vjp.theta_cotangents).  ``iterations`` is structural; the
    power is fixed at 8 (the polynomial collapse is power-specific).
    """

    position: Vec3
    size: float
    iterations: int = 6
    color: Vec3 = WHITE

    power: int = dataclasses.field(default=8, init=False)   # structural

    def __post_init__(self):
        self.position = _v3(self.position)
        self.color = _v3(self.color)
        self.size = float(self.size)
        self.iterations = int(self.iterations)
        if self.iterations < 1:
            raise ValueError("Mandelbulb iterations must be >= 1")

    def sdf(self, p: Vec3) -> float:
        q0 = tuple((p[i] - self.position[i]) / self.size for i in range(3))
        x, y, z = q0
        m = x * x + y * y + z * z
        dz = 1.0
        for _ in range(self.iterations):
            if m > 256.0:
                break
            dz = 8.0 * math.sqrt(m ** 7) * dz + 1.0
            x2, y2, z2 = x * x, y * y, z * z
            x4, y4, z4 = x2 * x2, y2 * y2, z2 * z2
            s2 = x2 + z2
            s = math.sqrt(max(s2, 1e-20))
            inv = 1.0 / max(s, 1e-10)
            ux, uz = x * inv, z * inv
            ux2, uz2 = ux * ux, uz * uz
            ux4, uz4 = ux2 * ux2, uz2 * uz2
            k1 = x4 + y4 + z4 - 6.0 * y2 * z2 - 6.0 * x2 * y2 + 2.0 * z2 * x2
            k4 = x2 - y2 + z2
            pa = ux * uz * (ux2 - uz2) * (ux4 - 6.0 * ux2 * uz2 + uz4)
            pb = (ux4 * ux4 - 28.0 * ux4 * ux2 * uz2 + 70.0 * ux4 * uz4
                  - 28.0 * ux2 * uz2 * uz4 + uz4 * uz4)
            x = 64.0 * y * k4 * k1 * s * pa + q0[0]
            ynew = -16.0 * y2 * s2 * k4 * k4 + k1 * k1 + q0[1]
            z = -8.0 * y * k4 * k1 * s * pb + q0[2]
            y = ynew
            m = x * x + y * y + z * z
        m = max(m, 1e-12)
        return self.size * 0.25 * math.log(m) * math.sqrt(m) / dz


@dataclasses.dataclass
class Julia:
    """Quaternion Julia-set distance estimate (scene-format EXTENSION —
    third procedural model family after [[Mandelbox]] / [[Mandelbulb]]).

    The classic z <- z^2 + c quaternion iteration seeded from the 3D query
    point's unit-space slice z0 = ((p - position)/size, 0), with the
    escape-time estimate

        DE = size * 0.25 * sqrt(m) * log(m) / md,   m = |z|^2,

    where md accumulates |d z_n / d z_0| = 2 |z| md per live step (the
    quaternion square's Jacobian has operator norm 2|z|).  Bailout 16.
    Quaternion square is pure polynomial: (a,b,c,d)^2 =
    (a^2-b^2-c^2-d^2, 2ab, 2ac, 2ad) — no transcendentals beyond the
    final sqrt/log.

    Signed (negative inside, m < 1) and homogeneous in ``size`` like every
    leaf, so the winner backward's homogeneity-based size cotangent
    applies unchanged.  ``c`` (4 floats) and ``iterations`` are structural
    (baked into the compiled plan); position/size/color differentiate.
    """

    position: Vec3
    size: float
    c: Tuple[float, float, float, float] = (-0.2, 0.6, 0.2, 0.2)
    iterations: int = 11
    color: Vec3 = WHITE

    def __post_init__(self):
        self.position = _v3(self.position)
        self.color = _v3(self.color)
        self.size = float(self.size)
        self.c = tuple(_f32(v) for v in self.c)
        if len(self.c) != 4:
            raise ValueError("Julia c must have 4 components")
        self.iterations = int(self.iterations)
        if self.iterations < 1:
            raise ValueError("Julia iterations must be >= 1")

    def sdf(self, p: Vec3) -> float:
        a = (p[0] - self.position[0]) / self.size
        b = (p[1] - self.position[1]) / self.size
        c_ = (p[2] - self.position[2]) / self.size
        d = 0.0
        ca, cb, cc, cd = self.c
        m = a * a + b * b + c_ * c_ + d * d
        md = 1.0
        for _ in range(self.iterations):
            if m > 16.0:
                break
            md = 2.0 * math.sqrt(m) * md
            a, b, c_, d = (a * a - b * b - c_ * c_ - d * d + ca,
                           2.0 * a * b + cb, 2.0 * a * c_ + cc,
                           2.0 * a * d + cd)
            m = a * a + b * b + c_ * c_ + d * d
        m = max(m, 1e-12)
        md = max(md, 1e-12)
        return self.size * 0.25 * math.sqrt(m) * math.log(m) / md


Primitive = Union[Sphere, Box, Cross, Mandelbox, Mandelbulb, Julia]

PRIM_TYPE = {Sphere: PrimType.SPHERE, Box: PrimType.BOX, Cross: PrimType.CROSS,
             Mandelbox: PrimType.MANDELBOX, Mandelbulb: PrimType.MANDELBULB,
             Julia: PrimType.JULIA}


@dataclasses.dataclass
class ListNode:
    """CSG combinator list (body.h:35-41)."""

    mode: Mode = Mode.UNION
    children: PyList["Node"] = dataclasses.field(default_factory=list)

    def append(self, node: "Node") -> "ListNode":
        self.children.append(node)
        return self

    def sdf(self, p: Vec3) -> Tuple[float, Vec3]:
        """Scalar reference evaluation, mirroring the left-to-right fold with
        first-operand-wins ties (body.cpp:66-111). Returns (SD, color)."""
        if not self.children:
            return math.inf, BLACK

        def eval_child(c: "Node") -> Tuple[float, Vec3]:
            if isinstance(c, ListNode):
                return c.sdf(p)
            return c.sdf(p), c.color

        sd, color = eval_child(self.children[0])
        if self.mode == Mode.COMPLEMENT:
            sd = -sd

        for c in self.children[1:]:
            csd, ccol = eval_child(c)
            if self.mode == Mode.UNION:
                if csd < sd:
                    sd, color = csd, ccol
            elif self.mode == Mode.COMPLEMENT:
                if -csd < sd:
                    sd, color = -csd, ccol
            elif self.mode == Mode.INTERSECTION:
                if csd > sd:
                    sd, color = csd, ccol
            elif self.mode == Mode.DIFFERENCE:
                if -csd > sd:
                    sd, color = -csd, ccol
        return sd, color


Node = Union[Primitive, ListNode]


def count_primitives(node: Node) -> int:
    if isinstance(node, ListNode):
        return sum(count_primitives(c) for c in node.children)
    return 1


def tree_depth(node: Node) -> int:
    """Depth in list nestings (a bare primitive is depth 0)."""
    if isinstance(node, ListNode):
        return 1 + max((tree_depth(c) for c in node.children), default=0)
    return 0


def iter_primitives(node: Node):
    """Yield leaf primitives in depth-first (reference fold) order."""
    if isinstance(node, ListNode):
        for c in node.children:
            yield from iter_primitives(c)
    else:
        yield node


def bounds(size: float) -> ListNode:
    """The ``Bounds`` construct: a COMPLEMENT list wrapping a black ``size``^3
    box at the origin (scene.cpp:120-127) — an inverted room enclosing the
    world so every ray terminates."""
    box = Box(position=(0.0, 0.0, 0.0), size=(size, size, size), color=BLACK)
    return ListNode(Mode.COMPLEMENT, [box])
