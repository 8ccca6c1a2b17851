"""Deep CSG trees in the port (plans with no two-level form: the JAX
package's generic post-order evaluator, ``pallas_march._scene_generic_tile``)
against the JAX package, on the CPU: the kernels' plain twin
``core.sdf.kernel_fold`` in its value, winner and gradient forms on
``tests/test_fuzz.py``'s depth-3 trees against JAX's surface kernel
(Pallas interpret mode) and against the port's own post-order fold; the
depth-3 world of ``tests/test_mega.py`` rendered by every backend against
JAX's mega and ref, with the gradients of the differentiable render in
both normals against JAX's mega backward; the demo with a deep list in
front (every leaf unculled) rendered, fitted two steps; and the regimes
in which the JAX package refuses such a plan.  The kernels themselves are
held to these twins on the card by tests/test_torch_kernel_cuda.py.

The JAX side is the expensive half (interpret-mode compiles): each JAX
image and gradient is computed once, in a module fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import (chain_tree, deep_scene,  # noqa: E402,F401
                        one_torch_thread, random_scene)

from raymarching_tpu import RenderConfig as JaxConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render  # noqa: E402
from raymarching_tpu.core.sdf import scene_sd_fused as jax_sd_fused  # noqa: E402
from raymarching_tpu.ops.pallas_march import (kernel_key,  # noqa: E402
                                              pallas_surface_eval)
from raymarching_tpu.scene import csg as jcsg  # noqa: E402
from raymarching_tpu.scene.compile import compile_tree as jax_compile  # noqa: E402
from raymarching_tpu.scene.objects import Camera as JaxCamera  # noqa: E402
from raymarching_tpu.scene.objects import Light as JaxLight  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.core.sdf import (LeafCount, kernel_fold,  # noqa: E402
                                            leaf_signs, scene_sd,
                                            scene_surface)
from raymarching_tpu_torch.ops import scene_vjp as tvjp  # noqa: E402
from raymarching_tpu_torch.scene import csg as tcsg  # noqa: E402
from raymarching_tpu_torch.scene.compile import SceneTables, compile_tree  # noqa: E402
from raymarching_tpu_torch.scene.objects import Camera, Light  # noqa: E402
from raymarching_tpu_torch.tables import (DEEP_LEVELS, pack_deep,  # noqa: E402
                                          scene_operands, spill_levels,
                                          tables_to_torch)

FIELDS = SceneTables._fields
# tests/test_fuzz.py:96-98: the kernel fold against the post-order fold
SD_RTOL, SD_ATOL = 5e-6, 1e-5
# winners agree off ties (tests/test_fuzz.py:105-107)
WINNER_SHARE = 0.98
# a box, cross or sphere winner's gradient (tests/test_torch_surface.py);
# a fractal winner's forward-mode sweep (tests/test_torch_procedural.py)
G_ATOL, PROC_G_RTOL = 1e-6, 2e-3
# tests/test_mega.py:87 (images) and :62 (gradients)
IMG_ATOL = 5e-4
GRAD_RTOL, GRAD_ATOL_SCALE = 0.02, 0.005
CFG = JaxConfig(width=24, height=16, ssaa=1, iterations=80, shadows=True,
                normal_mode="fd")


def _port_cfg(cfg) -> rt.RenderConfig:
    return rt.RenderConfig(**{f: getattr(cfg, f)
                              for f in cfg.__dataclass_fields__})


def _fuzz_pair(seed):
    """tests/test_fuzz.py's depth-3 tree of ``seed`` in both packages, and
    its 64 points."""
    jtree = random_scene(np.random.default_rng(1000 + seed), 3, jcsg)
    rng = np.random.default_rng(1000 + seed)
    tree = random_scene(rng, 3)
    pts = rng.uniform(-8, 8, size=(64, 3)).astype(np.float32)
    return (jax_compile(jtree, [], JaxCamera()),
            compile_tree(tree, [], Camera()), pts)


# The seed whose gradients are also held to JAX's combined mode, the deep
# tree with the fewest fractal leaves (2): JAX's interpret-mode compile of
# a fractal leaf's jet costs seconds a leaf, and the other deep seeds hold
# 5 to 13 of them (10-30 s a seed; 13 and 19 are two-level trees).  Every
# seed's gradients are held to the autograd gradient of the port's
# post-order fold, and its values and winners to JAX's winner mode.
GRAD_SEEDS = (16,)


@pytest.mark.parametrize("seed", range(12, 20))
def test_deep_fold_matches_jax_generic_evaluator(seed):
    """The twin of ``test_fuzz_all_layers_agree`` at depth 3: kernel_fold's
    value, winner, gradient and winner-and-gradient forms against JAX's
    surface kernel (interpret) in its combined mode (GRAD_SEEDS) or its
    winner mode, and against the port's post-order fold (scene_sd, its
    autograd gradient where the winners agree, scene_surface)."""
    (jplan, jtables), (plan, tables), pts = _fuzz_pair(seed)
    assert (plan.kernel is None) == (jplan.kernel is None)
    np.testing.assert_array_equal(tables.prim_pos, jtables.prim_pos)
    grads = seed in GRAD_SEEDS
    sd_j, w_j, g_j = (None if v is None else np.asarray(v) for v in
                      pallas_surface_eval(
                          kernel_key(jplan), 1e-3, 8, jnp.asarray(pts),
                          jtables, with_color=True, with_normal=grads,
                          analytic=grads, interpret=True))
    tt = tables_to_torch(tables, "cpu")
    q = torch.as_tensor(pts)
    sd, _ = kernel_fold(plan, tt, q)
    sd_w, w = kernel_fold(plan, tt, q, True)
    sd_g, w_g, g = kernel_fold(plan, tt, q, with_grad=True)
    for v in (sd, sd_w, sd_g):
        np.testing.assert_allclose(v.numpy(), sd_j, rtol=SD_RTOL,
                                   atol=SD_ATOL)
    # every form's value is the value fold's, bitwise; the winner too
    assert torch.equal(sd_w, sd) and torch.equal(sd_g, sd)
    assert torch.equal(w_g, w) and w.dtype == torch.int32
    same = w.numpy() == w_j
    assert same.mean() >= WINNER_SHARE, f"{(~same).sum()} winners differ"
    # the gradient where the winners agree: against the autograd gradient
    # of the port's post-order fold on every seed (path signs through
    # negated lists, fractal winners' sweeps), and against JAX's combined
    # mode on GRAD_SEEDS
    qg = q.clone().requires_grad_(True)
    g_post, = torch.autograd.grad(scene_sd(plan, tt, qg).sum(), qg)
    proc = np.isin(w.numpy(), [leaf for leaf, *_ in plan.proc])
    for want in (g_post.numpy(),) + ((g_j,) if grads else ()):
        np.testing.assert_allclose(g.numpy()[same & ~proc],
                                   want[same & ~proc], rtol=0, atol=G_ATOL)
        np.testing.assert_allclose(g.numpy()[same & proc], want[same & proc],
                                   rtol=PROC_G_RTOL, atol=PROC_G_RTOL)
    # the post-order fold: the same field, and the same colour winner
    np.testing.assert_allclose(scene_sd(plan, tt, q).numpy(), sd.numpy(),
                               rtol=SD_RTOL, atol=SD_ATOL)
    _, color = scene_surface(plan, tt, q)
    mine = torch.where((w >= 0)[:, None], tt.prim_color[w.clamp(min=0).long()],
                       torch.zeros(()))
    assert (torch.abs(color - mine).max(dim=1).values < 1e-6).float().mean() \
        >= WINNER_SHARE


def _edge_tree(csg, case):
    """Deep trees of the JAX package's own tests in ``csg``'s classes:
    tests/test_compile_eval.py's nested DIFFERENCE in an INTERSECTION
    (:75-88) and its empty sub-list (:120-128), tests/test_pallas.py's
    sub-list that appears twice (:112-117)."""
    if case == "nested":
        inner = csg.ListNode(csg.Mode.DIFFERENCE, [
            csg.Sphere((0, 0, 0), 3.0, color=(1, 0, 0)),
            csg.Sphere((2, 0, 0), 2.0, color=(0, 1, 0))])
        mid = csg.ListNode(csg.Mode.INTERSECTION, [
            inner, csg.Box((0, 0, 0), (5, 5, 5), color=(0, 0, 1))])
        return csg.ListNode(csg.Mode.UNION, [
            mid, csg.Sphere((6, 6, 6), 1.0, color=(1, 1, 0))])
    if case == "empty":
        return csg.ListNode(csg.Mode.UNION, [
            csg.Sphere((0, 0, 0), 1.0, color=(1, 0, 0)),
            csg.ListNode(csg.Mode.UNION, [])])
    inner = csg.ListNode(csg.Mode.UNION, [csg.Sphere((0, 0, -6), 1.0)])
    mid = csg.ListNode(csg.Mode.DIFFERENCE, [csg.Box((0, 0, -6), (4, 4, 4)),
                                             inner])
    return csg.ListNode(csg.Mode.UNION, [csg.bounds(40.0), mid,
                                         csg.ListNode(csg.Mode.UNION,
                                                      [inner])])


@pytest.mark.parametrize("case", ["nested", "empty", "twice"])
def test_deep_fold_matches_jax_on_its_edge_trees(case):
    """The deep fold in all its forms against JAX's combined mode on the
    deep trees of the JAX package's own tests (an empty list folds to
    (inf, no winner), as JAX's generic evaluator's ``empty()``)."""
    jplan, jtables = jax_compile(_edge_tree(jcsg, case), [], JaxCamera())
    plan, tables = compile_tree(_edge_tree(tcsg, case), [], Camera())
    assert plan.kernel is None and jplan.kernel is None
    pts = np.random.default_rng(6).uniform(-8, 8, (128, 3)).astype(
        np.float32)
    sd_j, w_j, g_j = (np.asarray(v) for v in pallas_surface_eval(
        kernel_key(jplan), 1e-3, 8, jnp.asarray(pts), jtables,
        with_color=True, with_normal=True, analytic=True, interpret=True))
    sd, w, g = kernel_fold(plan, tables_to_torch(tables, "cpu"),
                           torch.as_tensor(pts), with_grad=True)
    np.testing.assert_allclose(sd.numpy(), sd_j, rtol=SD_RTOL, atol=SD_ATOL)
    np.testing.assert_array_equal(w.numpy(), w_j)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=0, atol=G_ATOL)


def test_deep_packing_signs_and_leaf_count():
    """pack_deep's program on a known tree, the path signs of the
    backward (products of the negations root to leaf, as JAX's
    scene_vjp._leaf_statics walks them) and LeafCount's every-leaf count;
    chains that nest more lists than the kernels' stack holds render and
    give gradients as JAX's do."""
    from raymarching_tpu.ops.scene_vjp import _leaf_statics

    (jplan, _), (plan, tables), _ = _fuzz_pair(12)
    assert plan.kernel is None
    np.testing.assert_array_equal(leaf_signs(plan), _leaf_statics(jplan)[0])
    np.testing.assert_array_equal(tvjp.leaf_statics(plan)[0],
                                  _leaf_statics(jplan)[0])
    tt = tables_to_torch(tables, "cpu")
    ops = scene_operands(plan, tt, "cpu", fused=True)
    assert (ops.deep, ops.fused, ops.proc) == (1, 0, 1)
    assert ops.args()[-1] == 4 + 2
    assert int(ops.flag) == 0 and ops.lattice.shape[0] == ops.groups.shape[0]
    # every leaf sits in exactly one run, in leaf order
    leaves = [i for r in ops.runs.tolist() for i in range(r[1], r[1] + r[2])]
    assert leaves == list(range(plan.num_primitives))
    with LeafCount() as count:
        kernel_fold(plan, tt, torch.zeros((5, 3)))
    assert count.leaves == 5 * plan.num_primitives and count.points == 5
    # chains of DEEP_LEVELS + 1 and 40 nested lists, past the kernels'
    # per-thread stack (they raised ValueError before the DeepSpill view):
    # the cuda twin's image and gradients of mean(img^2) against JAX's jnp
    # backend (tests/test_mega.py:62's tolerance; the shadow skip off, its
    # parity configuration)
    cam = dict(position=(0.0, 1.5, 3.0), direction=(0.0, -0.3, -1.0))
    cfg = CFG.replace(width=12, height=8, iterations=60,
                      shade_skip_black=False)
    for levels in (DEEP_LEVELS + 1, 40):
        jplan, jtables = jax_compile(chain_tree(levels, jcsg),
                                     [JaxLight((5.0, 8.0, 4.0))],
                                     JaxCamera(**cam))
        deep, dtables = compile_tree(chain_tree(levels),
                                     [Light((5.0, 8.0, 4.0))], Camera(**cam))
        assert deep.kernel is None and pack_deep(deep).groups.shape[0] > 0
        assert spill_levels(deep) == levels - DEEP_LEVELS
        assert scene_operands(deep, tables_to_torch(dtables, "cpu"),
                              "cpu").spill == 0    # the twins keep no stack
        img, vjp = jax.vjp(lambda t: jax_render(
            jplan, t, cfg, backend="jnp", differentiable=True), jtables)
        (want,) = vjp(2.0 * img / img.size)
        tt = tables_to_torch(dtables, "cpu", requires_grad=FIELDS)
        got = rt.render_tables(deep, tt, _port_cfg(cfg), differentiable=True,
                               device="cpu")
        assert (got.sum(-1) > 0).float().mean() > 0.3
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(img),
                                   rtol=0, atol=IMG_ATOL)
        grads = torch.autograd.grad(torch.mean(got * got), list(tt),
                                    allow_unused=True, materialize_grads=True)
        for field, a in zip(FIELDS, grads):
            if field not in ("prim_pos", "prim_aux", "prim_color",
                             "light_pos"):
                continue
            b = np.asarray(getattr(want, field), np.float64)
            scale = max(np.abs(b).max(), 1e-8)
            np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_SCALE * scale,
                                       err_msg=f"{levels} lists: {field}")


def _depth3_world(package):
    """tests/test_mega.py's depth-3 world (test_mega_depth3_fused) in the
    port's classes or the JAX package's."""
    csg, cam, light, compile_ = (
        (jcsg, JaxCamera, JaxLight, jax_compile) if package == "jax" else
        (tcsg, Camera, Light, compile_tree))
    inner = csg.ListNode(csg.Mode.DIFFERENCE, [csg.Sphere((0, 0, -5), 2.0),
                                               csg.Sphere((1, 0, -5), 1.0)])
    mid = csg.ListNode(csg.Mode.INTERSECTION,
                       [inner, csg.Box((0, 0, -5), (3, 3, 3))])
    root = csg.ListNode(csg.Mode.UNION, [csg.bounds(40.0), mid])
    return compile_(root, [light((5, 5, 5))], cam())


@pytest.fixture(scope="module")
def depth3():
    """JAX's images of the depth-3 world (mega in interpret mode with FD
    and with analytic normals, ref) and its mega gradients of
    mean(img^2), with the shadow skip off (tests/test_mega.py's
    parity configuration)."""
    plan, tables = _depth3_world("jax")
    assert plan.kernel is None
    cfg = CFG.replace(shade_skip_black=False)
    images, grads = {}, {}
    for nm in ("fd", "analytic"):
        c = cfg.replace(normal_mode=nm)
        img, vjp = jax.vjp(lambda t, c=c: jax_render(
            plan, t, c, backend="mega", interpret=True,
            differentiable=True), tables)
        (g,) = vjp(2.0 * img / img.size)
        images[nm] = np.asarray(img)
        grads[nm] = {f: np.asarray(getattr(g, f), np.float64)
                     for f in FIELDS}
    images["ref"] = np.asarray(jax_render(plan, tables, cfg, backend="ref"))
    return cfg, images, grads


BACKENDS = {"cuda": dict(backend="cuda"), "multi": dict(backend="multi"),
            "two-phase": dict(backend="cuda", two_phase_k1=24),
            "ref": dict(backend="ref")}


@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_depth3_images_match_jax(depth3, backend, normal):
    """K1's twin (the deep fold), multi (K3's and K2's twins), two-phase
    (K3, K3, K4's twins) and ref against JAX's mega and ref images."""
    cfg, images, _ = depth3
    plan, tables = _depth3_world("port")
    kw = dict(BACKENDS[backend])
    be = kw.pop("backend")
    c = _port_cfg(cfg).replace(normal_mode=normal, **kw)
    img = rt.render_tables(plan, tables, c, backend=be, device="cpu").numpy()
    assert np.isfinite(img).all() and (img.sum(-1) > 0).mean() > 0.15
    for want in (images[normal], images["ref"]):
        np.testing.assert_allclose(img, want, rtol=0, atol=IMG_ATOL)


@pytest.fixture(scope="module")
def port_grads(depth3):
    """The port's gradients of mean(img^2) on the depth-3 world through
    the cuda twin (FusedRender: the stencil backward with FD normals, the
    saved residuals with analytic ones) and multi (MarchOp, NormalOp)."""
    cfg, _, _ = depth3
    plan, tables = _depth3_world("port")
    out = {}
    for be in ("cuda", "multi"):
        for nm in ("fd", "analytic"):
            tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
            img = rt.render_tables(plan, tt, _port_cfg(cfg).replace(
                normal_mode=nm), backend=be, differentiable=True,
                device="cpu")
            got = torch.autograd.grad(torch.mean(img * img), list(tt),
                                      allow_unused=True,
                                      materialize_grads=True)
            out[be, nm] = {f: v.numpy().astype(np.float64)
                           for f, v in zip(FIELDS, got)}
    return out


@pytest.mark.parametrize("field", ["prim_pos", "prim_aux", "prim_color",
                                   "light_pos"])
@pytest.mark.parametrize("normal", ["fd", "analytic"])
@pytest.mark.parametrize("backend", ["cuda", "multi"])
def test_depth3_gradients_match_jax_mega(depth3, port_grads, backend, normal,
                                         field):
    """tests/test_mega.py::test_mega_depth3_fused's gradient check, the
    port's backward against JAX's mega backward."""
    _, _, grads = depth3
    a, b = port_grads[backend, normal][field], grads[normal][field]
    assert np.isfinite(a).all() and np.abs(a).max() > 0
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SCALE * scale, err_msg=field)


def test_deep_demo_renders_and_fits(scenes_dir):
    """The demo behind a deep list (its 428 leaves and the list's 3, no
    collapse and no cull):
    the cuda twin's image against ref's, then two Adam steps of fit on the
    red sphere, whose loss falls."""
    demo = rt.load_scene(str(scenes_dir / "demo.txt"))
    plan, tables = rt.compile_scene(deep_scene(demo))
    assert plan.kernel is None and plan.num_primitives == 3 + 428
    cfg = rt.RenderConfig(width=32, height=24, ssaa=1, iterations=200)
    img = rt.render_tables(plan, tables, cfg, device="cpu")
    ref = rt.render_tables(plan, tables, cfg, backend="ref", device="cpu")
    assert (img.sum(-1) > 0).float().mean() > 0.2
    torch.testing.assert_close(img, ref, rtol=0, atol=IMG_ATOL)
    target = img
    sphere = next(i for i, c in enumerate(tables.prim_color)
                  if tuple(np.round(c, 2)) == (1.0, 0.0, 0.0))
    pos = tables.prim_pos.copy()
    pos[sphere] += (0.5, 0.0, 0.0)
    res = rt.fit(plan, tables._replace(prim_pos=pos), target, cfg,
                 device="cpu", steps=2, lr=5e-2, trainable=("prim_pos",))
    assert res.losses[-1] < res.losses[0]


# JAX's regimes on a deep plan (each run in the JAX package on the depth-3
# world): every backend renders in both normals, with fused generators
# too (the generic evaluator has no fused branch: the exact field); the
# fused backwards of mega and pallas assert ("fused evaluation requires
# kernel normal form"); ref renders and differentiates with the flag on
# (it ignores it).
REGIMES = [(be, nm) for be in ("cuda", "multi") for nm in ("fd", "analytic")]


@pytest.mark.parametrize("backend,normal", REGIMES)
def test_fused_regimes_follow_jax(backend, normal):
    """With fused generators a deep plan renders the exact field on the
    kernel backends and its backward raises ValueError, where JAX's
    asserts; ref ignores the flag."""
    plan, tables = _depth3_world("port")
    cfg = rt.RenderConfig(width=12, height=8, ssaa=1, iterations=60,
                          normal_mode=normal)
    fz = cfg.replace(fused_generators=True)
    exact = rt.render_tables(plan, tables, cfg, backend=backend,
                             device="cpu")
    torch.testing.assert_close(rt.render_tables(plan, tables, fz,
                                                backend=backend,
                                                device="cpu"),
                               exact, rtol=0, atol=0)
    torch.testing.assert_close(rt.render_tables(plan, tables, fz,
                                                backend="ref", device="cpu"),
                               exact, rtol=0, atol=IMG_ATOL)
    tt = tables_to_torch(tables, "cpu", requires_grad=("prim_pos",))
    img = rt.render_tables(plan, tt, fz, backend=backend, differentiable=True,
                           device="cpu")
    with pytest.raises(ValueError, match="kernel normal form"):
        torch.mean(img * img).backward()
    jplan, jtables = _depth3_world("jax")
    with pytest.raises(AssertionError, match="kernel normal form"):
        jax_sd_fused(jplan, jtables, jnp.zeros((1, 3)))
