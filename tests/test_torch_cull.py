"""The culls of the kernels' folds in the port: pallas_march's D5 (the
wide-UNION chunk cull, ``_bvh_group_fold``) and D4 (the deep-sponge
subtree walks, ``_menger_subtree_fold`` and its kin).

The cull rows and flags against the JAX package's ``_build_table``, the
routing predicates against its own, the port's culled twin
(``core.sdf.kernel_fold(cull=True)``) against JAX's tile folds and,
bitwise, against the port's unculled twin, with the skip counters of
``core.sdf.LeafCount``; on a CUDA device every kernel's Cull view against
both twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu.ops import pallas_march as pm  # noqa: E402
import raymarching_tpu.scene.compile as j_compile  # noqa: E402
import raymarching_tpu.scene.csg as j_csg  # noqa: E402
import raymarching_tpu.scene.generators as j_gen  # noqa: E402
import raymarching_tpu.scene.objects as j_obj  # noqa: E402
import raymarching_tpu_torch.scene.compile as t_compile  # noqa: E402
import raymarching_tpu_torch.scene.csg as t_csg  # noqa: E402
import raymarching_tpu_torch.scene.generators as t_gen  # noqa: E402
import raymarching_tpu_torch.scene.objects as t_obj  # noqa: E402
from raymarching_tpu_torch import tables as tt_mod  # noqa: E402
from raymarching_tpu_torch.core import sdf  # noqa: E402
from raymarching_tpu_torch.tables import (cull_rows, lattice_ok,  # noqa: E402
                                          scene_operands,
                                          subtree_collapse_ok,
                                          tables_to_torch)

JAX = (j_compile, j_csg, j_gen, j_obj)
PORT = (t_compile, t_csg, t_gen, t_obj)
# tests/test_fuzz.py:98's tolerance for one fold against another
RTOL, ATOL = 5e-6, 1e-5


def scatter_world(m, n_spheres=80, n_boxes=70, seed=0, generators=False):
    """tests/test_bvh_cull.py's _scatter_world (150 leaves: an 80-sphere
    and a 70-box run, each chunked) built with package ``m``'s classes;
    with ``generators`` a Menger sponge and a DeathStar join it."""
    compile_, csg, gen, obj = m
    rng = np.random.RandomState(seed)
    prims = [csg.bounds(80.0)]
    for _ in range(n_spheres):
        p = rng.uniform(-8, 8, 3)
        p[2] -= 14.0
        prims.append(csg.Sphere(tuple(p), float(rng.uniform(0.3, 0.7)),
                                color=tuple(rng.uniform(0.2, 1.0, 3))))
    for _ in range(n_boxes):
        p = rng.uniform(-8, 8, 3)
        p[2] -= 14.0
        prims.append(csg.Box(tuple(p), tuple(rng.uniform(0.4, 1.2, 3)),
                             color=tuple(rng.uniform(0.2, 1.0, 3))))
    if generators:
        prims.append(gen.menger_sponge((0.0, 6.0, -20.0), 6.0, 2))
        prims.append(gen.death_star((3.0, 2.0, -12.0), 1.0))
    return compile_.compile_tree(csg.ListNode(csg.Mode.UNION, prims),
                                 [obj.Light((6.0, 8.0, 4.0))],
                                 obj.Camera(position=(0.0, 0.0, 6.0),
                                            fov=55.0))


def tie_world(m):
    """tests/test_bvh_cull.py:184's world: sphere #5 of a chunked run and
    the first box of a later un-chunked run both at distance 1 from
    (2, 0, 0); the sphere, the earlier leaf (6), wins."""
    compile_, csg, _gen, obj = m
    rng = np.random.RandomState(11)
    prims = [csg.bounds(80.0)]
    for i in range(80):
        prims.append(csg.Sphere((0.0, 0.0, 0.0), 1.0) if i == 5 else
                     csg.Sphere(tuple(rng.uniform(4, 9, 3)), 0.5))
    prims.append(csg.Box((0.0, 0.0, 0.0), (2.0, 2.0, 2.0)))
    for _ in range(7):
        prims.append(csg.Box(tuple(rng.uniform(4, 9, 3)), (0.6, 0.6, 0.6)))
    return compile_.compile_tree(csg.ListNode(csg.Mode.UNION, prims),
                                 [obj.Light((6.0, 8.0, 4.0))], obj.Camera())


def menger_world(m, iters):
    """tests/test_pallas.py's _menger_plan: a sponge inside a Bounds box."""
    compile_, csg, gen, obj = m
    return compile_.compile_tree(csg.ListNode(csg.Mode.UNION, [
        csg.bounds(60.0), gen.menger_sponge((0, 0, -8), 9.0, iters)]), [],
        obj.Camera())


_WORLDS = {}


def world(name):
    """(JAX plan, JAX tables, port plan, port tables on the CPU) of a named
    world, built once a module."""
    if name not in _WORLDS:
        if name.startswith("menger"):
            iters = int(name[6])
            jp, jt = menger_world(JAX, iters)
            tp, _ = menger_world(PORT, iters)
        elif name == "scatter":
            jp, jt = scatter_world(JAX)
            tp, _ = scatter_world(PORT)
        elif name == "scatter200":
            jp, jt = scatter_world(JAX, n_spheres=200, n_boxes=0)
            tp, _ = scatter_world(PORT, n_spheres=200, n_boxes=0)
        elif name == "generators":
            jp, jt = scatter_world(JAX, n_spheres=70, n_boxes=0,
                                   seed=9, generators=True)
            tp, _ = scatter_world(PORT, n_spheres=70, n_boxes=0, seed=9,
                                  generators=True)
        else:
            jp, jt = tie_world(JAX)
            tp, _ = tie_world(PORT)
        _WORLDS[name] = (jp, jt, tp, tables_to_torch(jt, "cpu"))
    return _WORLDS[name]


def perturbed(jt, g, how):
    """The JAX tables with one level-3 cross of sponge group ``g`` moved
    ("moved": the subtree flag drops, the walks fall to the leaf fold) or
    with subtree 3 translated by s / 36 along x as a whole ("translated":
    its rows still share their coordinates, but sit outside the drift
    envelope the flag's s / 72 check guards, pallas_march.py:1229)."""
    pos = np.array(jt.prim_pos)
    T = 421
    b0 = g.start + 2 + 3 * T
    if how == "moved":
        pos[b0 + 2 + 2, 0] += 0.05
    else:
        pos[b0:b0 + T, 0] += np.float32(jt.prim_aux[g.start, 0] / 36.0)
    return jt._replace(prim_pos=pos)


def points(n=256, seed=1, near=None):
    """tests/test_bvh_cull.py's _points (far outside, inside the cloud,
    near surfaces), or with ``near`` = (centre, half) points in that box
    and a quarter far from it."""
    rng = np.random.RandomState(seed)
    if near is None:
        p = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
        p[:, 2] -= 10.0
        p[: n // 4] *= 4.0
        return p
    c, h = near
    p = rng.uniform(-h, h, (n, 3)).astype(np.float32) + np.float32(c)
    p[: n // 4] = rng.uniform(-4 * h, 4 * h, (n // 4, 3)) + np.float32(c)
    return p


def sponge_points(n=256, seed=2):
    return points(n, seed, near=((0.0, 0.0, -8.0), 6.0))


def menger_group(plan):
    return next(g for g in plan.kernel.groups
                if g.fused is not None and g.fused[0] == "menger")


def _folds(plan, tt, q, cull):
    """The port's value, colour-winner and winner-and-gradient folds."""
    sd, _ = sdf.kernel_fold(plan, tt, q, cull=cull)
    sdi, idx = sdf.kernel_fold(plan, tt, q, with_idx=True, cull=cull)
    sdg, widx, g = sdf.kernel_fold(plan, tt, q, with_grad=True, cull=cull)
    return sd, sdi, idx, sdg, widx, g


@pytest.mark.parametrize("case", ["scatter", "menger4", "menger4 moved",
                                  "menger4 translated", "menger5"])
def test_cull_rows_and_flags_equal_jax(case):
    """The chunk bound rows and the Menger offset rows bitwise the JAX
    table's, and flag columns 0 (lattice_ok) and 1 (subtree_collapse_ok)
    its flag row's, on the live tables."""
    name = case.split()[0]
    jp, jt, tp, _ = world(name)
    if " " in case:
        jt = perturbed(jt, menger_group(jp), case.split()[1])
    tt = tables_to_torch(jt, "cpu")
    tbl = np.asarray(pm._build_table(jt, jp.kernel))
    base = pm._bvh_row_base(jp.kernel)
    n = pm._order_row_base(jp.kernel) - base
    rows = cull_rows(tp.kernel, tt).numpy()
    assert n > 0 and rows.shape[0] == tbl.shape[0] - base
    np.testing.assert_array_equal(rows[:n], tbl[base:base + n])
    flag = tbl[pm._flag_row(jp.kernel)]
    assert float(lattice_ok(tp.kernel, tt)) == flag[0]
    assert float(subtree_collapse_ok(tp.kernel, tt)) == flag[1]
    want = {"menger4": (1.0, 1.0), "menger4 moved": (0.0, 0.0),
            "menger4 translated": (0.0, 0.0), "menger5": (0.0, 0.0),
            "scatter": (0.0, 0.0)}[case]
    assert tuple(flag[:2]) == want


@pytest.mark.parametrize("name", ["scatter200", "scatter1k"])
def test_order_rows_equal_jax_off_ties(name, scenes_dir):
    """The nearest-camera chunk order rows: JAX's ordinals, up to the
    order among chunks at the same distance."""
    if name == "scatter1k":
        import raymarching_tpu_torch as rt
        from raymarching_tpu.scene.parser import load_scene
        path = str(scenes_dir / "scatter1k.txt")
        jp, jt = j_compile.compile_scene(load_scene(path))
        tp = rt.compile_scene(rt.load_scene(path))[0]
    else:
        jp, jt, tp, _ = world(name)
    tt = tables_to_torch(jt, "cpu")
    tbl = np.asarray(pm._build_table(jt, jp.kernel))
    rows = cull_rows(tp.kernel, tt).numpy()
    base, first = pm._order_row_base(jp.kernel), pm._bvh_row_base(jp.kernel)
    spans = tt_mod.bvh_order_spans(tp.kernel)
    assert spans == pm.iter_bvh_order_spans(jp.kernel) and spans
    bounds_ = rows[:len(t_compile.iter_bvh_chunks(tp.kernel))]
    cam = np.asarray(jt.cam_position)
    off, chunk0 = 0, 0
    for gi, ri, uni in spans:
        got = rows[base - first + off:base - first + off + uni, 0]
        want = tbl[base + off:base + off + uni, 0]
        assert sorted(got.astype(int).tolist()) == list(range(uni))
        d = ((bounds_[chunk0:chunk0 + uni, :3] - cam) ** 2).sum(axis=1)
        # ordinals may differ only within a set of equal distances
        np.testing.assert_array_equal(d[got.astype(int)],
                                      d[want.astype(int)])
        off += uni
        chunk0 += len(dict(tp.kernel.groups[gi].bvh)[ri])


def _jax_tiles(kp, tbl, p):
    """JAX's four tile folds at p [n, 3] (n a multiple of 128), jitted."""
    px, py, pz = (jnp.asarray(p[:, a].reshape(-1, 128)) for a in range(3))
    f32 = jnp.float32
    out = {}
    for key, fn in (("value", pm._scene_sd_tile),
                    ("idx", pm._scene_sd_idx_tile),
                    ("grad", pm._scene_sd_grad_tile),
                    ("idx_grad", pm._scene_sd_idx_grad_tile)):
        res = jax.jit(lambda t, x, y, z, _f=fn: _f(kp, t, x, y, z, f32))(
            tbl, px, py, pz)
        res = res if isinstance(res, tuple) else (res,)
        out[key] = [np.asarray(v).reshape(-1) for v in res]
    return out


def _unique_winner(plan, tt, q):
    """bool [n]: points whose scene value one leaf alone attains (off the
    tie sets)."""
    leaf = sdf.leaf_sd(plan, tt, q)
    sign = torch.as_tensor(sdf.leaf_signs(plan))
    v = (leaf * sign).abs()
    sd = sdf.kernel_fold(plan, tt, q, cull=False)[0].abs()
    return ((v == sd[:, None]).sum(dim=1) == 1).numpy()


@pytest.mark.parametrize("name", ["scatter", "generators", "menger4"])
def test_culled_folds_agree_with_jax(name):
    """The culled twin's value, colour-winner, gradient and
    winner-and-gradient folds against JAX's tile folds (which take the same
    culls, per tile): values at test_fuzz's tolerance, winner ids off tie
    sets, gradients where the winners agree."""
    jp, jt, tp, tt = world(name)
    p = sponge_points() if name.startswith("menger") else points()
    q = torch.as_tensor(p)
    j = _jax_tiles(jp.kernel, pm._build_table(jt, jp.kernel), p)
    sd, sdi, idx, sdg, widx, g = _folds(tp, tt, q, cull=True)
    for got, want in ((sd, j["value"][0]), (sdi, j["idx"][0]),
                      (sdg, j["grad"][0]), (sdg, j["idx_grad"][0])):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    one = _unique_winner(tp, tt, q)
    assert one.mean() > 0.5
    np.testing.assert_array_equal(idx.numpy()[one], j["idx"][1][one])
    np.testing.assert_array_equal(widx.numpy()[one], j["idx_grad"][1][one])
    # gradients where the winners agree (a sphere's unit vector rounds an
    # ulp apart across the packages' square roots)
    same = one & (widx.numpy() == j["idx_grad"][1])
    for jg in (j["idx_grad"][2:], j["grad"][1:]):
        np.testing.assert_allclose(g.numpy()[same],
                                   np.stack(jg, axis=1)[same],
                                   rtol=RTOL, atol=ATOL)


def test_iters5_margin_walk_agrees_with_jax():
    """The iters-5 sponge (no lattice: D4's margin walk in every fold) at
    256 points: the culled twin's value and winner-and-gradient folds
    against JAX's tile folds."""
    jp, jt, tp, tt = world("menger5")
    p = sponge_points()
    q = torch.as_tensor(p)
    tbl = pm._build_table(jt, jp.kernel)
    px, py, pz = (jnp.asarray(p[:, a].reshape(-1, 128)) for a in range(3))
    jsd = np.asarray(jax.jit(lambda t, x, y, z: pm._scene_sd_tile(
        jp.kernel, t, x, y, z, jnp.float32))(tbl, px, py, pz)).reshape(-1)
    jig = [np.asarray(v).reshape(-1) for v in jax.jit(
        lambda t, x, y, z: pm._scene_sd_idx_grad_tile(
            jp.kernel, t, x, y, z, jnp.float32))(tbl, px, py, pz)]
    sd, _ = sdf.kernel_fold(tp, tt, q)
    sdg, widx, g = sdf.kernel_fold(tp, tt, q, with_grad=True)
    np.testing.assert_allclose(sd.numpy(), jsd, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sdg.numpy(), jig[0], rtol=RTOL, atol=ATOL)
    same = widx.numpy() == jig[1]
    assert same.mean() > 0.5
    np.testing.assert_allclose(g.numpy()[same],
                               np.stack(jig[2:], axis=1)[same],
                               rtol=RTOL, atol=ATOL)


CULL_CASES = ["tie", "scatter", "generators exact", "generators fused",
              "menger4 vbound", "menger4 flag 0", "menger5 margin"]


@pytest.mark.parametrize("case", CULL_CASES)
def test_culled_twin_is_bitwise_the_unculled_twin(case):
    """Every fold of the culled twin equals the unculled twin's bitwise:
    the first-wins tie across a chunked and a plain run, chunks beside
    fused generators in both packings, menger4's value-bound winner walk
    and its fall to the leaf fold when the subtree flag drops, iters 5's
    margin walk.  The skip counters show the culls fire."""
    name = case.split()[0]
    jp, jt, tp, tt = world({"tie": "tie", "generators": "generators",
                            "scatter": "scatter"}.get(name, name))
    fused = case == "generators fused"
    if case == "menger4 flag 0":
        tt = tables_to_torch(perturbed(jt, menger_group(jp), "moved"), "cpu")
        assert int(subtree_collapse_ok(tp.kernel, tt)) == 0
    if name == "tie":
        p = np.tile(np.float32([[2.0, 0.0, 0.0]]), (128, 1))
    elif name.startswith("menger"):
        p = sponge_points()
    else:
        p = points()
    q = torch.as_tensor(p)
    with sdf.LeafCount() as on:
        culled = [sdf.kernel_fold(tp, tt, q, fused=fused),
                  sdf.kernel_fold(tp, tt, q, True, fused=fused),
                  sdf.kernel_fold(tp, tt, q, with_grad=True, fused=fused)]
    with sdf.LeafCount() as off:
        plain = [sdf.kernel_fold(tp, tt, q, fused=fused, cull=False),
                 sdf.kernel_fold(tp, tt, q, True, fused=fused, cull=False),
                 sdf.kernel_fold(tp, tt, q, with_grad=True, fused=fused,
                                 cull=False)]
    for a, b in zip(culled, plain):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)
    assert on.points == off.points == 3 * q.shape[0]
    assert off.chunks_tested == off.cells_tested == 0
    if name == "tie":
        assert bool((culled[1][1] == 6).all()) and bool(
            (culled[2][1] == 6).all())
        assert float(culled[0][0][0]) == 1.0
    if case == "menger4 flag 0":
        # value folds take the lattice or the leaf fold, winner folds the
        # leaf fold: no walk, no test
        assert on.cells_tested == 0 and on.leaves == off.leaves
        return
    if name in ("tie", "scatter", "generators"):
        assert 0 < on.chunks_skipped < on.chunks_tested
    else:
        assert 0 < on.cells_skipped < on.cells_tested
    assert on.leaves < off.leaves


@pytest.mark.parametrize("iters", [3, 4, 5])
def test_routing_predicates_equal_jax(iters):
    """pallas_march's D4 routing and layout predicates on each sponge."""
    jp, _jt, tp, tt = world(f"menger{iters}")
    jg, tg = menger_group(jp), menger_group(tp)
    assert tt_mod.menger_subtrees(tg) == pm._menger_subtrees(jg)
    for port, jax_ in ((tt_mod.use_subtree, pm._use_subtree),
                       (tt_mod.lattice_idx_ok, pm._lattice_idx_ok),
                       (tt_mod.subtree_collapses, pm._subtree_collapses),
                       (tt_mod.subtree_recurses, pm._subtree_recurses)):
        assert port(tg) == jax_(jg), port.__name__
    assert (tt_mod.needs_menger_offsets(tp.kernel)
            == pm._needs_menger_offsets(jp.kernel))
    assert tt_mod.use_subtree(tg) == (iters >= 4)
    ops = scene_operands(tp, tt, "cpu")
    assert ops.cull == int(iters >= 4)
    assert ops.flag.shape[0] == (2 if iters >= 4 else 1)


def test_uniform_prefix_and_spans_equal_jax():
    jp, _jt, tp, _tt = world("scatter200")
    for jg, tg in zip(jp.kernel.groups, tp.kernel.groups):
        for (_ri, jch), (_ri2, tch) in zip(jg.bvh or (), tg.bvh or ()):
            assert tt_mod.uniform_prefix(tch) == pm._uniform_prefix(jch)
    assert tt_mod.bvh_order_spans(tp.kernel) == pm.iter_bvh_order_spans(
        jp.kernel)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scatter", "generators", "menger4",
                                  "menger5"])
def test_cull_view_equals_both_twins_on_card(cuda_device, name):
    """Every kernel's Cull view against the culled and the unculled twin,
    bitwise: K1, K3, K4 and K2's five modes and its stencil entry."""
    import raymarching_tpu_torch as rt
    from raymarching_tpu_torch.core import camera as cam
    from raymarching_tpu_torch.ops import march_kernel as mk
    from raymarching_tpu_torch.ops import render_kernel as rk
    from raymarching_tpu_torch.ops import shade_kernel as shk
    from raymarching_tpu_torch.ops import surface_kernel as sk
    _jp, jt, tp, _tt = world(name)
    tt = tables_to_torch(jt, cuda_device)
    assert scene_operands(tp, tt, cuda_device).cull == 1
    cfg = rt.RenderConfig(width=32, height=24, ssaa=1, iterations=300)
    origin, dirs = cam.generate_rays(tt, cfg)
    dirs = dirs.reshape(-1, 3)
    k1 = rk.render_rays(tp, cfg, tt, origin, dirs)
    k3 = mk.march_rays(tp, cfg, tt, origin, dirs)
    k4 = shk.shade_rays(tp, cfg, tt, k1.p, k1.sd, dirs)
    k2 = [sk.surface_eval(tp, tt, k1.p, mode=m, fd_h=cfg.fd_h)
          for m in sk.MODES]
    for cull in (True, False):
        sdf.CULL, was = cull, sdf.CULL
        try:
            for a, b in zip(k1, rk.render_rays_plain(tp, cfg, tt, origin,
                                                     dirs)):
                assert torch.equal(a, b)
            for a, b in zip(k3, mk.march_rays_plain(tp, cfg, tt, origin,
                                                    dirs)):
                assert torch.equal(a, b)
            for a, b in zip(k4, shk.shade_rays_plain(tp, cfg, tt, k1.p,
                                                     k1.sd, dirs)):
                assert torch.equal(a, b)
            for m, got in zip(sk.MODES, k2):
                want = sk.surface_eval_plain(tp, tt, k1.p, mode=m,
                                             fd_h=cfg.fd_h)
                for a, b in zip(got, want):
                    assert (a is None and b is None) or torch.equal(a, b)
        finally:
            sdf.CULL = was
