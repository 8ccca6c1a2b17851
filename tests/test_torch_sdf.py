"""Port scene field: the post-order oracle and the kernel-form fold agree
with the JAX oracle and the JAX surface kernel (interpret mode) at the
suite's field tolerance, and the colour winners agree off near-ties."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu.core import sdf as jsdf  # noqa: E402
from raymarching_tpu.ops.pallas_march import (kernel_key,  # noqa: E402
                                              pallas_surface_eval)
from raymarching_tpu.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
from raymarching_tpu_torch.core import sdf as tsdf  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

SCENES = ["demo", "config4", "scatter1k"]
N = 1024
# tests/test_fuzz.py's kernel-vs-oracle field tolerance
RTOL, ATOL = 5e-6, 1e-5


def _points_near_surfaces(tables, seed):
    """Seeded points around random leaves, within a few leaf sizes."""
    rng = np.random.default_rng(seed)
    pos, aux = tables.prim_pos, tables.prim_aux
    leaf = rng.integers(0, pos.shape[0], N)
    size = np.maximum(aux[leaf].max(axis=1), 0.5)[:, None]
    size = np.minimum(size, 10.0)
    pts = pos[leaf] + rng.normal(size=(N, 3)) * size
    return pts.astype(np.float32)


@pytest.fixture(scope="module", params=SCENES)
def world(request, scenes_dir):
    plan, tables = compile_scene(load_scene(str(scenes_dir /
                                                f"{request.param}.txt")))
    pts = _points_near_surfaces(tables, seed=SCENES.index(request.param))
    sd_k, idx_k, _ = pallas_surface_eval(
        kernel_key(plan), 1e-3, 8, jnp.asarray(pts), tables,
        with_color=True, with_normal=False, interpret=True)
    return plan, tables, pts, np.asarray(sd_k), np.asarray(idx_k)


def test_scene_sd_matches_jax_oracle(world):
    plan, tables, pts, _, _ = world
    sd_j = np.asarray(jsdf.scene_sd(plan, tables, jnp.asarray(pts)))
    sd_t = tsdf.scene_sd(plan, tables_to_torch(tables, "cpu"),
                         torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(sd_t, sd_j, rtol=RTOL, atol=ATOL)


def test_scene_surface_colour_matches_jax_oracle(world):
    plan, tables, pts, _, _ = world
    _, col_j = jsdf.scene_surface(plan, tables, jnp.asarray(pts))
    _, col_t = tsdf.scene_surface(plan, tables_to_torch(tables, "cpu"),
                                  torch.as_tensor(pts))
    match = np.all(np.abs(col_t.numpy() - np.asarray(col_j)) < 1e-6, axis=-1)
    assert match.mean() > 0.995, f"{(~match).sum()} colour mismatches"


def test_kernel_fold_matches_surface_kernel(world):
    plan, tables, pts, sd_k, idx_k = world
    tt = tables_to_torch(tables, "cpu")
    sd_t, idx_t = tsdf.kernel_fold(plan, tt, torch.as_tensor(pts),
                                   with_idx=True)
    np.testing.assert_allclose(sd_t.numpy(), sd_k, rtol=RTOL, atol=ATOL)
    value_only, none = tsdf.kernel_fold(plan, tt, torch.as_tensor(pts))
    assert none is None
    np.testing.assert_array_equal(value_only.numpy(), sd_t.numpy())

    # winners equal except where the two winners' values tie within 1e-6
    idx_t = idx_t.numpy()
    bad = np.nonzero(idx_t != idx_k)[0]
    if bad.size:
        leaf = tsdf.leaf_sd(plan, tt, torch.as_tensor(pts[bad])).numpy()
        scale = np.ones(leaf.shape[1], np.float32)
        for g in plan.kernel.groups:
            scale[g.start:g.start + g.count] = np.asarray(g.scales) * g.gsign
        val = leaf * scale
        rows = np.arange(bad.size)
        gap = np.abs(val[rows, idx_t[bad]] - val[rows, idx_k[bad]])
        assert (gap <= 1e-6).all(), f"winner mismatches off ties: {gap}"
    assert (idx_t >= 0).all()


def test_leaf_blocks_bound_the_working_set(world, monkeypatch):
    """Blocked evaluation gives the same field as one block."""
    plan, tables, pts, _, _ = world
    tt = tables_to_torch(tables, "cpu")
    whole = tsdf.kernel_fold(plan, tt, torch.as_tensor(pts), True)
    monkeypatch.setattr(tsdf, "_LEAF_BUDGET", 37 * plan.num_primitives)
    blocked = tsdf.kernel_fold(plan, tt, torch.as_tensor(pts), True)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)
