"""The exact Menger lattice collapse in the port's winner-and-gradient
fold (K2's combined mode): the packed stream's winner rows against
``GroupPlan.lattice``; the collapsed plain carve with its winner against
the leaf fold and the JAX package's ``_menger_carve_lattice_idx_grad``; the
collapsed combined twin against the leaf-fold twin (values bitwise, winner
and gradient off the tie sets, cotangent sums with the ties in) and against
the JAX package's ``_scene_sd_idx_grad_tile``; the flag and a moved cross
row; ``LeafCount``.  The CUDA fold that walks the same stream is checked on
the card by tests/test_torch_kernel_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu.ops import pallas_march as pm  # noqa: E402
from raymarching_tpu.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
from raymarching_tpu_torch.core import sdf  # noqa: E402
from raymarching_tpu_torch.ops import scene_vjp as tvjp  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.tables import (lattice_ok, pack_plan,  # noqa: E402
                                          tables_to_torch)
from test_scene_vjp import _tie_free, _world  # noqa: E402
from test_torch_lattice import (_lattice_group, _menger, _moved,  # noqa: E402
                                _points)
from test_torch_surface import _demo_points  # noqa: E402

# tests/test_fuzz.py's kernel-vs-oracle field tolerance
SD_RTOL, SD_ATOL = 5e-6, 1e-5


def _winner_rows(stream, off):
    """The winner rows of the collapse block at ``off``, per level: the
    row of a one-cross level, else {(y row, z row): the rows of the
    column's crosses, in its x-set's member order}, and the x-set members'
    representative rows beside them."""
    n_levels, roff = stream[off], stream[off + 1]
    off += 2
    levels = []
    for _ in range(n_levels):
        n_xsets, size_row = stream[off], stream[off + 1]
        off += 2
        if n_xsets == 0:
            levels.append(stream[roff])
            roff += 1
            continue
        columns = {}
        for _ in range(n_xsets):
            n_mem, n_col = stream[off], stream[off + 1]
            off += 2
            members = tuple(stream[off:off + n_mem])
            off += n_mem
            for c in range(n_col):
                key = (stream[off + 2 * c], stream[off + 2 * c + 1])
                columns[key] = (members, tuple(stream[roff:roff + n_mem]))
                roff += n_mem
            off += 2 * n_col
        levels.append(columns)
    return levels, off, roff


@pytest.mark.parametrize("iters", [2, 3, 4])
def test_packed_winner_rows_reproduce_group_lattice(iters):
    plan, tables = _menger(iters)
    gi, g = _lattice_group(plan)
    stream = pack_plan(plan.kernel).lattice.tolist()
    levels, end, rows_end = _winner_rows(stream, stream[gi])
    # the rows follow the levels, and nothing follows the rows
    assert stream[stream[gi] + 1] == end and rows_end == len(stream)
    pos = np.asarray(tables.prim_pos)
    n_rows = 0
    for got, want in zip(levels, g.lattice):
        if len(want) == 1:
            assert got == want[0]
            n_rows += 1
            continue
        xs, ys, zs, _size, columns, members = want
        assert len(got) == len(columns)
        for (iy, iz, ixs, rows) in columns:
            reps, crosses = got[(ys[iy], zs[iz])]
            by_ix = sorted(zip(ixs, rows))
            assert reps == tuple(xs[ix] for ix, _ in by_ix)
            assert crosses == tuple(row for _, row in by_ix)
            # each is the cross at its member's x and the column's y, z
            for rep, row in zip(reps, crosses):
                assert pos[row, 0] == pos[rep, 0]
                assert pos[row, 1] == pos[ys[iy], 1]
                assert pos[row, 2] == pos[zs[iz], 2]
            n_rows += len(rows)
        assert sorted(r for _, rows in got.values() for r in rows) == sorted(
            m[0] for m in members)
    # every cross of the carve has exactly one winner row
    assert n_rows == g.count - 1


@pytest.mark.parametrize("iters", [2, 3])
def test_collapsed_carve_winner_matches_leaf_fold_and_jax(iters):
    """(min, row) of the collapsed carve: the value bitwise the leaf
    fold's and the JAX collapse's; the row a cross that attains the
    minimum (the crosses of one column tie along their common arm, so
    most points have several); and where the row is the JAX collapse's,
    the winning row's leaf gradient equal to the one-hot axis signs the
    JAX fold carries (``_med3_grad_axes``)."""
    plan, tables = _menger(iters)
    gi, g = _lattice_group(plan)
    t = tables_to_torch(tables, "cpu")
    pts = torch.as_tensor(_points())
    levels = sdf._fold_layout(plan.kernel, True).blocks[gi].levels
    cm, row = sdf._lattice_carve_idx(levels, t, pts)
    assert torch.equal(cm, sdf._lattice_carve(levels, t, pts))
    carve = np.arange(g.start + 1, g.start + g.count)
    leaf = sdf.leaf_sd(plan, t, pts, carve)
    full, k = leaf.min(dim=1)
    assert torch.equal(cm, full)
    # the reported cross attains the minimum everywhere
    assert torch.equal(leaf.gather(1, (row - g.start - 1)[:, None])[:, 0], cm)
    # where one cross alone attains it, that is the leaf fold's argmin
    alone = (leaf == full[:, None]).sum(dim=1) == 1
    assert bool(alone.any())
    assert torch.equal(row[alone], k[alone] + g.start + 1)

    px, py, pz = (jnp.asarray(pts[:, a].numpy()) for a in range(3))
    jm, jrow, jgx, jgy, jgz = pm._menger_carve_lattice_idx_grad(
        pm._build_table(tables, plan.kernel), g, px, py, pz)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jm))
    jrow = torch.as_tensor(np.array(jrow)).long()
    assert torch.equal(row[alone], jrow[alone])
    ptype = torch.as_tensor(np.asarray(plan.prim_type, np.int64))[row]
    grad = sdf.prim_sd_grad(ptype, t.prim_pos[row], t.prim_aux[row], pts)
    jg = torch.as_tensor(np.stack([np.asarray(v) for v in (jgx, jgy, jgz)],
                                  axis=-1))
    same_row = row == jrow
    assert float(same_row.double().mean()) > 0.3
    assert torch.equal(grad[same_row], jg[same_row])
    # the crosses of a tie class share the winning axis and its sign
    assert float((grad == jg).all(dim=1).double().mean()) > 0.99


def _case(name, scenes_dir):
    """(plan, tables, points) of a world with a collapsing group."""
    if name == "world":
        from test_scene_vjp import _points as world_points
        plan, tables = _world()
        return plan, tables, np.array(world_points())
    if name == "demo":
        plan, tables = compile_scene(load_scene(str(scenes_dir / "demo.txt")))
        return plan, tables, _demo_points(seed=7)
    plan, tables = _menger(int(name[-1]))
    return plan, tables, _points(n=512, seed=11)


@pytest.mark.parametrize("name", ["menger2", "menger3", "demo", "world"])
def test_collapsed_combined_twin_matches_leaf_fold_twin(name, scenes_dir):
    plan, tables, p = _case(name, scenes_dir)
    t = tables_to_torch(tables, "cpu")
    assert int(lattice_ok(plan.kernel, t)) == 1
    q = torch.as_tensor(p)
    sd, w, g = sk.surface_eval_plain(plan, t, q)
    sd_l, w_l, g_l = sk.surface_eval_plain(plan, t, q, collapse=False)
    assert torch.equal(sd, sd_l)
    clean = torch.as_tensor(np.array(_tie_free(plan, tables,
                                               jnp.asarray(p))))
    assert float(clean.double().mean()) > 0.5
    assert torch.equal(w[clean], w_l[clean])
    assert torch.equal(g[clean], g_l[clean])
    # with the ties in: a tie class's cotangents move between its leaves,
    # their sum stays (tests/test_scene_vjp.py's conservation test)
    u = torch.as_tensor(np.random.default_rng(2).normal(
        size=p.shape[0]).astype(np.float32))
    on = tvjp.theta_cotangents(plan, t, w, g, u)
    off = tvjp.theta_cotangents(plan, t, w_l, g_l, u)
    for a, b in zip(on, off):
        a, b = a.double().sum(0), b.double().sum(0)
        assert torch.allclose(a, b, rtol=1e-4,
                              atol=1e-5 * max(float(b.abs().max()), 1.0))


@pytest.mark.parametrize("name", ["demo", "config1", "world"])
def test_collapsed_combined_twin_matches_jax_idx_grad_tile(name, scenes_dir):
    """The port's combined twin against the JAX kernel's own fold,
    ``_scene_sd_idx_grad_tile``, which takes the winner collapse for these
    lattices (config1's table does not satisfy the lattice: both fall to
    the leaf fold)."""
    if name == "config1":
        plan, tables = compile_scene(
            load_scene(str(scenes_dir / "config1.txt")))
        p = _demo_points(seed=9)
    else:
        plan, tables, p = _case(name, scenes_dir)
    px, py, pz = (jnp.asarray(p[:, a]) for a in range(3))
    sd_j, w_j, *g_j = pm._scene_sd_idx_grad_tile(
        plan.kernel, pm._build_table(tables, plan.kernel), px, py, pz,
        jnp.float32)
    sd, w, g = sk.surface_eval_plain(plan, tables_to_torch(tables, "cpu"),
                                     torch.as_tensor(p))
    np.testing.assert_allclose(sd.numpy(), np.asarray(sd_j), rtol=SD_RTOL,
                               atol=SD_ATOL)
    clean = np.asarray(_tie_free(plan, tables, jnp.asarray(p)))
    assert clean.mean() > 0.5
    np.testing.assert_array_equal(w.numpy()[clean], np.asarray(w_j)[clean])
    np.testing.assert_allclose(
        g.numpy()[clean],
        np.stack([np.asarray(v) for v in g_j], axis=-1)[clean], rtol=0,
        atol=1e-6)


def test_flag_off_and_moved_row_fall_to_the_leaf_fold():
    plan, tables = _menger(3)
    q = torch.as_tensor(_points(n=512, seed=5))
    t = tables_to_torch(tables, "cpu")
    leafwise = sdf.kernel_fold(plan, t, q, with_grad=True, collapse=False)
    # collapse off: the colour winner's own fold, winner for winner
    sd_c, w_c = sdf.kernel_fold(plan, t, q, True)
    assert torch.equal(leafwise[0], sd_c) and torch.equal(leafwise[1], w_c)
    for a, b in zip(sk.surface_eval_plain(plan, t, q, collapse=False),
                    leafwise):
        assert torch.equal(a, b)
    # a moved cross row drops the flag: asking for the collapse changes
    # nothing, winners included
    mt = tables_to_torch(_moved(plan, tables), "cpu")
    assert int(lattice_ok(plan.kernel, mt)) == 0
    asked = sk.surface_eval_plain(plan, mt, q)
    plain = sk.surface_eval_plain(plan, mt, q, collapse=False)
    for a, b in zip(asked, plain):
        assert torch.equal(a, b)


def test_leaf_count_counts_the_collapsed_winner_levels():
    plan, tables = _menger(3)
    gi, g = _lattice_group(plan)
    t = tables_to_torch(tables, "cpu")
    q = torch.as_tensor(_points())
    block = sdf._fold_layout(plan.kernel, True).blocks[gi]
    members = sum(len(m) for lv in block.levels if lv.members is not None
                  for m in lv.members)
    columns = sum(len(lv.col_y) for lv in block.levels
                  if lv.members is not None)
    assert block.ops_idx == block.ops + sdf.OPS_PER_WINNER_SELECT * (
        members + columns)
    with sdf.LeafCount() as value:
        sdf.kernel_fold(plan, t, q)
    with sdf.LeafCount() as winner:
        sdf.kernel_fold(plan, t, q, with_grad=True)
    with sdf.LeafCount() as leafwise:
        sdf.kernel_fold(plan, t, q, with_grad=True, collapse=False)
    kept = int(sdf.carve_folded(plan, t, q).sum())
    assert 0 < kept < q.shape[0]
    assert winner.leaves == value.leaves < leafwise.leaves
    assert winner.ops - value.ops == kept * (block.ops_idx - block.ops)
    assert leafwise.ops == sdf.OPS_PER_LEAF * leafwise.leaves
