"""The exact Menger lattice collapse in the port's value fold: the packed
descriptor stream against ``GroupPlan.lattice``, the collapsed plain carve
against the port's leaf fold (bitwise) and the JAX package's
``_menger_carve_lattice``, the device-side flag ``lattice_ok`` against the
JAX package's, and the plain twins with the collapse on against off.  The
CUDA fold that walks the same stream is checked on the card by
tests/test_torch_kernel_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu.ops import pallas_march as pm  # noqa: E402
from raymarching_tpu.scene.compile import (compile_scene,  # noqa: E402
                                           compile_tree)
from raymarching_tpu.scene.csg import ListNode, Mode, bounds  # noqa: E402
from raymarching_tpu.scene.generators import menger_sponge  # noqa: E402
from raymarching_tpu.scene.objects import Camera, Light  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch import tables as tt_mod  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.core import sdf  # noqa: E402
from raymarching_tpu_torch.ops import march_kernel as mk  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
from raymarching_tpu_torch.ops import shade_kernel as shk  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.scene.compile import SceneTables  # noqa: E402
from raymarching_tpu_torch.tables import (lattice_ok, pack_plan,  # noqa: E402
                                          scene_operands, tables_to_torch)

CFG = rt.RenderConfig(width=24, height=16, ssaa=1, iterations=120)
# tests/test_fuzz.py:98's tolerance for one fold against another; the
# collapse is expected to be bitwise equal and is first held to that
JAX_RTOL = 5e-6


def _menger(iters):
    """tests/test_pallas.py's lattice world: a sponge inside a Bounds box."""
    tree = ListNode(Mode.UNION, [bounds(60.0),
                                 menger_sponge((0, 0, -8), 9.0, iters)])
    return compile_tree(tree, [Light((6.0, 8.0, 4.0))],
                        Camera(position=(0, 2, 14), fov=55.0))


def _demo(scenes_dir):
    return rt.compile_scene(rt.load_scene(str(scenes_dir / "demo.txt")))


def _lattice_group(plan):
    gi, g = next((i, g) for i, g in enumerate(plan.kernel.groups)
                 if g.fused is not None and g.fused[0] == "menger")
    return gi, g


def _points(n=1024, seed=3):
    """tests/test_pallas.py:373's points."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-30, 30, (n, 3)).astype(np.float32)


def _moved(plan, tables):
    """One cross row moved (tests/test_pallas.py:410-416)."""
    g = next(g for g in plan.kernel.groups if g.lattice is not None)
    pos = np.array(tables.prim_pos)
    pos[g.start + 5, 0] += 0.25
    return tables._replace(prim_pos=pos)


def _decode(stream, off):
    """A collapse block of the packed stream as a list of levels: a leaf
    row for a one-cross level, else (size row, {(y row, z row): sorted x
    rows})."""
    levels = []
    n_levels = stream[off]
    off += 2        # the second entry is the offset of the winner rows
    for _ in range(n_levels):
        n_xsets, size_row = stream[off], stream[off + 1]
        off += 2
        if n_xsets == 0:
            levels.append(size_row)
            continue
        columns = {}
        for _ in range(n_xsets):
            n_mem, n_col = stream[off], stream[off + 1]
            off += 2
            xrows = tuple(sorted(stream[off:off + n_mem]))
            off += n_mem
            for c in range(n_col):
                key = (stream[off + 2 * c], stream[off + 2 * c + 1])
                assert key not in columns
                columns[key] = xrows
            off += 2 * n_col
        levels.append((size_row, columns))
    return levels


@pytest.mark.parametrize("iters", [1, 2, 3, 4])
def test_packed_stream_reproduces_group_lattice(iters):
    plan, _ = _menger(iters)
    gi, g = _lattice_group(plan)
    packed = pack_plan(plan.kernel)
    stream = packed.lattice.tolist()
    assert packed.lattice.dtype == torch.int32
    assert len(stream) >= len(plan.kernel.groups)
    others = [stream[i] for i in range(len(plan.kernel.groups)) if i != gi]
    assert others == [0] * len(others)
    if g.lattice is None:           # iters 1: a base box and one cross
        assert iters == 1 and stream[gi] == 0
        assert packed.members.shape == (2, 0)
        return
    levels = _decode(stream, stream[gi])
    assert len(levels) == len(g.lattice) == iters
    n_members = 0
    for got, want in zip(levels, g.lattice):
        if len(want) == 1:
            assert got == want[0]
            continue
        xs, ys, zs, size_rep, columns, members = want
        assert got[0] == size_rep
        assert got[1] == {(ys[iy], zs[iz]): tuple(sorted(xs[ix] for ix in ixs))
                          for (iy, iz, ixs, _rows) in columns}
        n_members += len(members)
    # six (own, representative) element pairs a cross: x, y, z, 3 sizes
    assert packed.members.shape == (2, 6 * n_members)
    own, rep = packed.members.reshape(2, n_members, 6).tolist()
    want = [m for lv in g.lattice if len(lv) > 1 for m in lv[5]]
    assert [o[0] // 8 for o in own] == [m[0] for m in want]
    for o, r in zip(own, rep):
        assert [v % 8 for v in o] == [v % 8 for v in r] == list(range(6))
        assert len({v // 8 for v in o}) == 1
    # iters 4's level 3: 512 columns over at most 8 distinct x-sets
    if iters == 4:
        assert len(levels[3][1]) == 512
        assert len(set(levels[3][1].values())) <= 8


def test_pack_plan_is_cached_on_the_plan_alone():
    plan, _ = _menger(2)
    plan_again, _ = _menger(2)
    assert pack_plan(plan.kernel) is pack_plan(plan_again.kernel)


@pytest.mark.parametrize("iters", [2, 3, 4])
def test_collapsed_carve_equals_leaf_fold_and_jax(iters):
    plan, tables = _menger(iters)
    gi, g = _lattice_group(plan)
    t = tables_to_torch(tables, "cpu")
    pts = _points()
    levels = sdf._fold_layout(plan.kernel, True).blocks[gi].levels
    fast = sdf._lattice_carve(levels, t, torch.as_tensor(pts))
    # the port's leaf fold over the carve crosses (scale +1)
    carve = np.arange(g.start + 1, g.start + g.count)
    full = sdf.leaf_sd(plan, t, torch.as_tensor(pts), carve).min(dim=1).values
    assert torch.equal(fast, full)
    px, py, pz = (jnp.asarray(pts[:, a]) for a in range(3))
    jfast = np.asarray(pm._menger_carve_lattice(
        pm._build_table(tables, plan.kernel), g, px, py, pz))
    np.testing.assert_allclose(fast.numpy(), jfast, rtol=JAX_RTOL, atol=0)
    np.testing.assert_array_equal(fast.numpy(), jfast)


@pytest.mark.parametrize("scene", ["menger2", "menger3", "menger4", "demo",
                                   "config1", "moved"])
def test_lattice_ok_equals_jax(scene, scenes_dir):
    if scene in ("demo", "config1"):
        # the JAX package's own plan: its lattice_ok takes no other
        plan, tables = compile_scene(
            load_scene(str(scenes_dir / f"{scene}.txt")))
    elif scene == "moved":
        plan, tables = _menger(3)
        tables = _moved(plan, tables)
    else:
        plan, tables = _menger(int(scene[-1]))
    flag = lattice_ok(plan.kernel, tables_to_torch(tables, "cpu"))
    assert flag.shape == (1,) and flag.dtype == torch.int32
    want = float(pm.lattice_ok(plan.kernel, tables))
    assert float(flag) == want
    assert want == (0.0 if scene in ("config1", "moved") else 1.0)


def test_lattice_ok_of_a_generic_plan_is_zero(scenes_dir):
    plan, tables = compile_scene(load_scene(str(scenes_dir / "demo.txt")))
    flag = lattice_ok(plan, tables_to_torch(tables, "cpu"))
    assert int(flag) == 0 == int(pm.lattice_ok(plan, tables))


def test_scene_operands_carry_stream_and_flag(scenes_dir):
    plan, tables = _demo(scenes_dir)
    t = tables_to_torch(tables, "cpu")
    on = scene_operands(plan, t, "cpu")
    off = scene_operands(plan, t, "cpu", collapse=False)
    moved = scene_operands(plan, tables_to_torch(_moved(plan, tables), "cpu"),
                           "cpu")
    assert (int(on.flag), int(off.flag), int(moved.flag)) == (1, 0, 0)
    for ops in (on, off, moved):
        for name in ("groups", "runs", "lattice", "flag"):
            v = getattr(ops, name)
            assert v.dtype == torch.int32 and v.is_contiguous(), name
        assert len(ops.args()) == 11
        assert torch.equal(ops.lattice, pack_plan(plan.kernel).lattice)
    # the demo fits a block's shared memory, menger4 does not
    assert on.nbytes(plan.num_lights) <= tt_mod.SHARED_SCENE_BYTES
    plan4, tables4 = rt.compile_scene(
        rt.load_scene(str(scenes_dir / "menger4.txt")))
    big = scene_operands(plan4, tables_to_torch(tables4, "cpu"), "cpu")
    assert big.nbytes(plan4.num_lights) > tt_mod.SHARED_SCENE_BYTES


def _cases(scenes_dir):
    plan, tables = _menger(3)
    dplan, dtables = _demo(scenes_dir)
    return {"menger3": (plan, tables), "demo": (dplan, dtables),
            "menger3 moved": (plan, _moved(plan, tables)),
            "demo moved": (dplan, _moved(dplan, dtables))}


@pytest.mark.parametrize("case", ["menger3", "demo", "menger3 moved",
                                  "demo moved"])
def test_plain_twins_collapse_on_equals_off(case, scenes_dir):
    plan, tables = _cases(scenes_dir)[case]
    t = tables_to_torch(tables, "cpu")
    origin, dirs = cam.generate_rays(t, CFG)
    dirs = dirs.reshape(-1, 3)
    on3, s_on = mk.march_rays_plain(plan, CFG, t, origin, dirs,
                                    with_steps=True)
    off3, s_off = mk.march_rays_plain(plan, CFG, t, origin, dirs,
                                      with_steps=True, collapse=False)
    for a, b in zip((*on3, s_on), (*off3, s_off)):
        assert torch.equal(a, b)
    on1 = rk.render_rays_plain(plan, CFG, t, origin, dirs)
    off1 = rk.render_rays_plain(plan, CFG, t, origin, dirs, collapse=False)
    for name, a, b in zip(rk.RayOutputs._fields, on1, off1):
        assert torch.equal(a, b), name
    assert bool(on1.done.any()) and bool((on1.cidx >= 0).any())
    # the wrappers hand a CPU tensor to the same twins
    via = rk.render_rays(plan, CFG, t, origin, dirs, collapse=False)
    for a, b in zip(via, off1):
        assert torch.equal(a, b)
    on4 = shk.shade_rays(plan, CFG, t, on1.p, on1.sd, dirs)
    off4 = shk.shade_rays(plan, CFG, t, on1.p, on1.sd, dirs, collapse=False)
    for a, b in zip(on4, off4):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", [sk.SD, sk.FD_GRAD, sk.WINNER, sk.COMBINED])
def test_surface_modes_collapse_on_equals_off(mode, scenes_dir):
    plan, tables = _demo(scenes_dir)
    t = tables_to_torch(tables, "cpu")
    q = torch.as_tensor(_points(512, seed=5) * 0.4)
    on = sk.surface_eval(plan, t, q, mode=mode, fd_h=CFG.fd_h)
    off = sk.surface_eval(plan, t, q, mode=mode, fd_h=CFG.fd_h,
                          collapse=False)
    for a, b in zip(on, off):
        assert (a is None and b is None) or torch.equal(a, b)


def test_leaf_count_counts_the_collapsed_levels(scenes_dir):
    """Per surviving point the collapsed demo carve is one leaf (level 0)
    and, per level, 3 operations an axis excess, 1 an x-set member and 5 a
    column; culled points count the base leaves alone."""
    plan, tables = _demo(scenes_dir)
    t = tables_to_torch(tables, "cpu")
    gi, g = _lattice_group(plan)
    pts = torch.as_tensor(_points())
    kept = int(sdf.carve_folded(plan, t, pts).sum())
    assert 0 < kept < pts.shape[0]
    with sdf.LeafCount() as on:
        sdf.kernel_fold(plan, t, pts)
    with sdf.LeafCount() as off:
        sdf.kernel_fold(plan, t, pts, collapse=False)
    base = plan.num_primitives - (g.count - 1)
    assert off.leaves == pts.shape[0] * base + kept * (g.count - 1)
    assert off.ops == sdf.OPS_PER_LEAF * off.leaves
    assert on.leaves == pts.shape[0] * base + kept
    per_point = 0
    for level in g.lattice[1:]:
        xs, ys, zs, _size, columns, _members = level
        xsets = {tuple(sorted(c[2])) for c in columns}
        per_point += (3 * (len(xs) + len(ys) + len(zs))
                      + sum(len(k) for k in xsets) + 5 * len(columns))
    assert per_point == 3 * (9 + 27) + (5 + 25) + 5 * (8 + 64)
    assert on.ops == sdf.OPS_PER_LEAF * on.leaves + kept * per_point
    assert on.points == off.points == pts.shape[0]


def test_image_and_fit_step_gradients_unchanged_by_collapse(scenes_dir,
                                                            monkeypatch):
    """The demo frame and every gradient field of one differentiable
    render, with the flag as the tables give it and with it forced to 0."""
    plan, tables = _demo(scenes_dir)
    cfg = CFG.replace(iterations=200)

    def frame_and_grads():
        t = tables_to_torch(tables, "cpu", requires_grad=SceneTables._fields)
        img = rt.render_tables(plan, t, cfg, differentiable=True,
                               device="cpu")
        grads = torch.autograd.grad(torch.mean((img - 0.25) ** 2), list(t),
                                    allow_unused=True, materialize_grads=True)
        return img.detach(), grads

    img_on, g_on = frame_and_grads()
    assert torch.equal(img_on, rt.render_tables(plan, tables, cfg,
                                                device="cpu"))
    calls = []

    def no_collapse(kp, t):
        calls.append(1)
        return torch.zeros(1, dtype=torch.int32, device=t.prim_pos.device)

    monkeypatch.setattr(tt_mod, "lattice_ok", no_collapse)
    img_off, g_off = frame_and_grads()
    assert calls
    assert torch.equal(img_on, img_off)
    assert float(img_on.max()) > 0.0
    # The backward's winner fold collapses too.  Where crosses tie
    # (coincident arms: the same value, the same d scene / dp) it may name
    # another cross of the tie class than the leaf fold, so a geometry
    # cotangent may land on another cross row; every other row and field,
    # and the sum over the sponge's cross rows, are unchanged.
    g = next(g for g in plan.kernel.groups if g.lattice is not None)
    nb = sum(count for (_, _, count, scale) in g.runs if scale == -1)
    cross = slice(g.start + nb, g.start + g.count)
    for name, a, b in zip(SceneTables._fields, g_on, g_off):
        if name not in ("prim_pos", "prim_aux"):
            assert torch.equal(a, b), name
            continue
        keep = torch.ones(a.shape[0], dtype=torch.bool)
        keep[cross] = False
        assert torch.equal(a[keep], b[keep]), name
        scale = float(b.abs().max())
        assert torch.allclose(a[cross].double().sum(0),
                              b[cross].double().sum(0), rtol=1e-5,
                              atol=1e-6 * scale), name
    assert any(float(g.abs().max()) > 0 for g in g_on)
