"""Shared set-up of the port's test files (tests/test_torch_*.py).

The suite runs in several worker processes at once; PyTorch's CPU ops
would each take every core, so the port's tests run on one thread.
``deep_scene`` puts a depth-3 tree into a scene, and ``random_scene``
builds ``tests/test_fuzz.py``'s random trees from the same draws, in
either package's classes.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deep_scene(scene):
    """The port's ``scene`` with a depth-3 list in front of its root's
    children: a union holding an intersection of a union and a sphere,
    which the two-level kernel form cannot hold, so its plan has no
    ``kernel`` and the kernels take their deep view (D8)."""
    from raymarching_tpu_torch.scene.csg import Box, ListNode, Mode, Sphere
    inner = ListNode(Mode.UNION, [Sphere((0, 0, -4), 1.0),
                                  Box((1, 0, -4), (1, 1, 1))])
    mid = ListNode(Mode.INTERSECTION, [inner, Sphere((0.5, 0, -4), 1.2)])
    tree = ListNode(scene.tree.mode, [ListNode(Mode.UNION, [mid])]
                    + list(scene.tree.children))
    return dataclasses.replace(scene, tree=tree)


def random_scene(rng, depth: int = 1, csg=None):
    """``tests/test_fuzz.py``'s ``_random_scene(rng, depth)``: the same
    draws of ``rng`` in the same order, so one seed gives one tree, built
    from ``csg``, a module with the scene classes (the port's
    ``scene.csg`` by default; the JAX package's gives that package's
    tree)."""
    if csg is None:
        from raymarching_tpu_torch.scene import csg

    def prim():
        pos = tuple(rng.uniform(-6, 6, 3))
        color = tuple(rng.uniform(0, 1, 3))
        kind = rng.integers(0, 6)
        if kind == 0:
            return csg.Sphere(pos, float(rng.uniform(0.3, 3.0)), color)
        if kind == 3:
            return csg.Mandelbox(pos, float(rng.uniform(0.5, 2.0)),
                                 scale=float(rng.uniform(1.5, 3.0)),
                                 iterations=int(rng.integers(2, 5)),
                                 color=color)
        if kind == 4:
            return csg.Mandelbulb(pos, float(rng.uniform(0.5, 2.0)),
                                  iterations=int(rng.integers(2, 5)),
                                  color=color)
        if kind == 5:
            return csg.Julia(pos, float(rng.uniform(0.5, 2.0)),
                             c=tuple(rng.uniform(-0.8, 0.8, 4)),
                             iterations=int(rng.integers(2, 6)), color=color)
        size = tuple(rng.uniform(0.5, 4.0, 3))
        return (csg.Box if kind == 1 else csg.Cross)(pos, size, color)

    def lst(d: int):
        sub = csg.ListNode(csg.Mode(int(rng.integers(0, 4))))
        for _ in range(rng.integers(1, 6)):
            if d > 0 and rng.random() < 0.35:
                sub.append(lst(d - 1))
            else:
                sub.append(prim())
        return sub

    root = csg.ListNode(csg.Mode.UNION)
    for _ in range(rng.integers(1, 7)):
        if rng.random() < 0.5:
            root.append(prim())
        else:
            root.append(lst(depth - 1))
    return root


def chain_tree(levels: int, csg=None):
    """A root union of a Bounds box, a floor and a chain of ``levels`` - 1
    nested lists, so that ``levels`` lists are open at once when the deep
    fold walks it: list i holds list i - 1 and one leaf, a union adding a
    small sphere on a helix and an intersection a box that holds every
    sphere.  Built from ``csg``, a module with the scene classes (the
    port's ``scene.csg`` by default)."""
    import math
    if csg is None:
        from raymarching_tpu_torch.scene import csg
    node = csg.Sphere((0.0, -1.0, -6.0), 0.6, (0.9, 0.3, 0.2))
    for i in range(1, levels):
        if i % 2:
            a = 0.55 * i
            node = csg.ListNode(csg.Mode.UNION, [node, csg.Sphere(
                (1.8 * math.cos(a), 0.12 * i - 1.0, -6.0 + 1.8 * math.sin(a)),
                0.45, (0.2, 0.4 + 0.02 * i, 0.9))])
        else:
            node = csg.ListNode(csg.Mode.INTERSECTION, [node, csg.Box(
                (0.0, 0.0, -6.0), (8.0, 8.0, 8.0), (0.8, 0.8, 0.8))])
    return csg.ListNode(csg.Mode.UNION, [
        csg.bounds(40.0), csg.Box((0.0, -2.5, -6.0), (12.0, 0.5, 12.0),
                                  (0.9, 0.9, 0.9)), node])
