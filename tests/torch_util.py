"""Shared set-up of the port's test files (tests/test_torch_*.py).

The suite runs in several worker processes at once; PyTorch's CPU ops
would each take every core, so the port's tests run on one thread.
``deep_scene`` builds the depth-3 tree the port still refuses.
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
    which the two-level kernel form cannot hold (ROADMAP Queue 2, D8)."""
    from raymarching_tpu_torch.scene.csg import Box, ListNode, Mode, Sphere
    inner = ListNode(Mode.UNION, [Sphere((0, 0, -4), 1.0),
                                  Box((1, 0, -4), (1, 1, 1))])
    mid = ListNode(Mode.INTERSECTION, [inner, Sphere((0.5, 0, -4), 1.2)])
    tree = ListNode(scene.tree.mode, [ListNode(Mode.UNION, [mid])]
                    + list(scene.tree.children))
    return dataclasses.replace(scene, tree=tree)
