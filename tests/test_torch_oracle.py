"""The port's own gradient oracles against the JAX package's, on the CPU:
``render_tables(backend="ref", differentiable=True)`` (the unrolled
autodiff march ``core.march.march_scan``, every chunk checkpointed)
against JAX's ``ref`` with ``differentiable=True``, and the ``torch``
backend (``ops.march_op.PlainMarchOp``: early-exit forward,
implicit-function backward through ``core.sdf.scene_sd``) against JAX's
``jnp``, for every SceneTables field.  Then, within the port, the
twins of tests/test_grad.py: the implicit-function gradients against the
unrolled ones, and both against central differences of the radius; the
differentiable image bitwise the forward one; chunked gradients equal to
whole ones.

The world is tests/test_grad.py's (24x16, SSAA 1, 200 iterations) with
hard shadows on and off and FD and analytic normals; at 16x12 and 100
iterations the extensions: coloured lights (scenes/mirror.txt), soft
shadows + AO, one mirror bounce, a thin lens, a deep plan
(``torch_util.chain_tree``) and scenes/julia.txt.  Each case's gradients
are computed once, in a module fixture."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import chain_tree, one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig as JaxConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render  # noqa: E402
from raymarching_tpu.scene import csg as jcsg  # noqa: E402
from raymarching_tpu.scene.compile import (  # noqa: E402
    compile_scene as jax_compile_scene, compile_tree as jax_compile)
from raymarching_tpu.scene.objects import Camera as JaxCamera  # noqa: E402
from raymarching_tpu.scene.objects import Light as JaxLight  # noqa: E402
from raymarching_tpu.scene.parser import load_scene as jax_load  # noqa: E402
from raymarching_tpu.scene.parser import parse_scene as jax_parse  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.scene.compile import (SceneTables,  # noqa: E402
                                                 compile_tree)
from raymarching_tpu_torch.scene.csg import (Box, ListNode, Mode,  # noqa: E402
                                             PrimType, Sphere, bounds)
from raymarching_tpu_torch.scene.objects import Camera, Light  # noqa: E402
from raymarching_tpu_torch.scene.parser import parse_scene  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402
from test_grad import CFG as GRAD_CFG  # noqa: E402
from test_grad import _world as jax_world  # noqa: E402

FIELDS = SceneTables._fields
# the port against the JAX package: tests/test_mega.py:62
RTOL, ATOL_SCALE = 0.02, 0.005
# implicit-function against unrolled gradients: tests/test_grad.py:55
IFT_RTOL, IFT_ATOL_SCALE = 0.08, 0.02
SCENES = pathlib.Path(__file__).resolve().parent.parent / "scenes"
SMALL = dict(width=16, height=12, iterations=100)
# tests/test_reflections.py's world (tests/test_torch_reflect.py): the
# mirror bounce's case
REFLECT_SCENE = """
Bounds 60
Light 0 8 2
Color 0.9 0.1 0.1
Sphere -1.2 0 -6 1.5
Color 0.2 0.9 0.3
Sphere 1.8 -0.5 -7 1.0
Color 0.9 0.9 0.9
Box 0 -2.5 -6 8 0.5 8
Camera Position 0 1.5 2
"""
DEEP_CAM = dict(position=(0.0, 1.5, 3.0), direction=(0.0, -0.3, -1.0))


def _port_cfg(cfg) -> rt.RenderConfig:
    return rt.RenderConfig(**{f: getattr(cfg, f)
                              for f in cfg.__dataclass_fields__})


def _scene(name):
    """(JAX plan and tables, the port's) of a case's scene."""
    if name == "world":
        jplan, jtables = jax_world()
        tree = ListNode(Mode.UNION, [
            bounds(60.0),
            Sphere((0.0, 0.0, -6.0), 2.5, color=(0.9, 0.4, 0.2)),
            Box((0.0, -3.0, -6.0), (10.0, 1.0, 10.0),
                color=(0.6, 0.6, 0.9)),
        ])
        return (jplan, jtables), compile_tree(
            tree, [Light((6.0, 8.0, 4.0))],
            Camera(position=(0, 0, 6), fov=55.0))
    if name == "deep":
        return (jax_compile(chain_tree(4, jcsg), [JaxLight((5.0, 8.0, 4.0))],
                            JaxCamera(**DEEP_CAM)),
                compile_tree(chain_tree(4), [Light((5.0, 8.0, 4.0))],
                             Camera(**DEEP_CAM)))
    if name == "reflect":
        return (jax_compile_scene(jax_parse(REFLECT_SCENE)),
                rt.compile_scene(parse_scene(REFLECT_SCENE)))
    path = str(SCENES / f"{name}.txt")
    return (jax_compile_scene(jax_load(path)),
            rt.compile_scene(rt.load_scene(path)))


# name -> (scene, configuration)
CASES = {
    "shadowless-analytic": ("world", GRAD_CFG),
    "shadows-analytic": ("world", GRAD_CFG.replace(shadows=True)),
    "shadowless-fd": ("world", GRAD_CFG.replace(normal_mode="fd")),
    "shadows-fd": ("world", GRAD_CFG.replace(shadows=True,
                                             normal_mode="fd")),
    "mirror-coloured": ("mirror", JaxConfig(ssaa=1, shadows=True, **SMALL)),
    "soft-ao": ("world", JaxConfig(ssaa=1, shadows=True, soft_shadow_k=6.0,
                                   ao_strength=0.8, **SMALL)),
    "bounce": ("reflect", JaxConfig(ssaa=1, shadows=True,
                                  reflect_strength=0.4, reflect_bounces=1,
                                  **SMALL)),
    "aperture": ("world", JaxConfig(ssaa=2, shadows=True, aperture=0.2,
                                    focus_dist=6.0, **SMALL)),
    "deep": ("deep", JaxConfig(ssaa=1, shadows=True, **SMALL)),
    "julia": ("julia", JaxConfig(ssaa=1, shadows=True, normal_mode="analytic",
                                 **SMALL)),
}

# tests/test_grad.py's world, where the two routes converge to one
# derivative
WORLD_CASES = ["shadowless-analytic", "shadows-analytic", "shadowless-fd",
               "shadows-fd"]


def _weights(shape):
    """tests/test_grad.py's smooth loss weights."""
    return np.random.default_rng(7).uniform(0.5, 1.0, shape).astype(
        np.float32)


def _port_grads(plan, tables, cfg, backend, weights):
    """(image, gradients of sum(img * weights) / size for every field)."""
    tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
    img = rt.render_tables(plan, tt, cfg, backend=backend,
                           differentiable=True, device="cpu")
    w = torch.from_numpy(weights)
    g = torch.autograd.grad((img * w).sum() / img.numel(), list(tt),
                            allow_unused=True, materialize_grads=True)
    return img.detach(), [v.numpy().astype(np.float64) for v in g]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    scene, jcfg = CASES[request.param]
    (jplan, jtables), (plan, tables) = _scene(scene)
    cfg = _port_cfg(jcfg)
    w = _weights((cfg.height, cfg.width, 3))
    want = {}
    for jb in ("ref", "jnp"):
        g = jax.jit(jax.grad(lambda t: jnp.sum(jax_render(
            jplan, t, jcfg, backend=jb, differentiable=True) * w) / w.size))(
            jtables)
        want[jb] = [np.asarray(getattr(g, f), np.float64) for f in FIELDS]
    got = {b: _port_grads(plan, tables, cfg, b, w) for b in ("ref", "torch")}
    fwd = rt.render_tables(plan, tables, cfg, backend="ref", device="cpu")
    return dict(name=request.param, plan=plan, tables=tables, cfg=cfg,
                weights=w, want=want, got=got, fwd=fwd)


def _tie_rows(plan):
    """Leaf rows of the crosses (Menger carves): their arms tie over open
    regions, where the port gives the tie to the first operand and JAX
    splits it, so they are compared as one sum (sum conservation,
    tests/test_torch_grad.py)."""
    return np.nonzero(np.asarray(plan.prim_type) == int(PrimType.CROSS))[0]


def _assert_fields(got, want, plan, rtol, atol_scale, what):
    ties = _tie_rows(plan)
    for field, a, b in zip(FIELDS, got, want):
        assert np.isfinite(a).all(), f"{what}: {field} not finite"
        scale = max(np.abs(b).max(), 1e-8)
        if field in ("prim_pos", "prim_aux") and len(ties):
            np.testing.assert_allclose(
                a[ties].sum(axis=0), b[ties].sum(axis=0), rtol=rtol,
                atol=atol_scale * scale, err_msg=f"{what}: {field} cross sum")
            a, b = np.delete(a, ties, axis=0), np.delete(b, ties, axis=0)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol_scale * scale,
                                   err_msg=f"{what}: {field}")


@pytest.mark.parametrize("backend", ["ref", "torch"])
def test_gradients_match_jax(case, backend):
    """ref (differentiable) against JAX's ref, torch against JAX's jnp."""
    jb = {"ref": "ref", "torch": "jnp"}[backend]
    _assert_fields(case["got"][backend][1], case["want"][jb], case["plan"],
                   RTOL, ATOL_SCALE, f"{case['name']} {backend} vs {jb}")


def test_differentiable_image_is_the_forward_image(case):
    """The unrolled march and the early-exit one give every ray the same
    bits, and so do the torch backend's hits."""
    assert torch.equal(case["got"]["ref"][0], case["fwd"])
    assert torch.equal(case["got"]["torch"][0], case["fwd"])
    assert case["fwd"].abs().sum() > 0


@pytest.mark.parametrize("case", WORLD_CASES, indirect=True)
def test_ift_matches_unrolled_autodiff(case):
    """tests/test_grad.py::test_ift_matches_unrolled_autodiff in the port:
    the torch backend's implicit-function gradients against the ref
    oracle's unrolled ones, at its tolerance, in its world (off it the
    two routes part, in JAX as in the port: at silhouettes, mirror
    bounces and fractal surfaces the unrolled march's derivative is not
    the converged root's)."""
    _assert_fields(case["got"]["torch"][1], case["got"]["ref"][1],
                   case["plan"], IFT_RTOL, IFT_ATOL_SCALE,
                   f"{case['name']} torch vs ref")


@pytest.mark.parametrize("backend", ["ref", "torch"])
def test_finite_difference_radius(backend):
    """tests/test_grad.py::test_finite_difference_radius on the port's
    backends: d(loss)/d(radius) against central differences."""
    _, (plan, tables) = _scene("world")
    cfg = _port_cfg(GRAD_CFG)
    w = _weights((cfg.height, cfg.width, 3))
    _, g = _port_grads(plan, tables, cfg, backend, w)
    h = 5e-3

    def loss_at(r):
        aux = np.array(tables.prim_aux)
        aux[1, 0] = r
        img = rt.render_tables(plan, tables._replace(prim_aux=aux), cfg,
                               backend=backend, device="cpu")
        return float((img * torch.from_numpy(w)).sum() / img.numel())

    r0 = float(tables.prim_aux[1, 0])
    fd = (loss_at(r0 + h) - loss_at(r0 - h)) / (2 * h)
    assert g[FIELDS.index("prim_aux")][1, 0] == pytest.approx(
        fd, rel=0.1, abs=2e-4)


@pytest.mark.parametrize("normal_mode", ["fd", "analytic"])
def test_chunked_gradients_match_whole(normal_mode):
    """``ray_chunk`` checkpoints each chunk of the unrolled oracle: the
    same image bits, and gradients within 1e-6 of the whole frame's."""
    _, (plan, tables) = _scene("world")
    cfg = rt.RenderConfig(ssaa=1, shadows=True, normal_mode=normal_mode,
                          **SMALL)
    w = _weights((cfg.height, cfg.width, 3))
    img0, g0 = _port_grads(plan, tables, cfg, "ref", w)
    img1, g1 = _port_grads(plan, tables, cfg.replace(ray_chunk=50), "ref", w)
    assert torch.equal(img0, img1)
    for field, a, b in zip(FIELDS, g1, g0):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=field)


def test_march_scan_is_the_early_exit_march():
    """Both drivers of ``core.march.march`` give every ray the same bits,
    with each option (tmax by sum and by projection, step counts, the
    penumbra tracker, rays that start done): the fixed-iteration march
    with its checkpointed chunks (grad enabled, ``differentiable=True``)
    and without them (under no_grad)."""
    from raymarching_tpu_torch.core import camera as cam
    from raymarching_tpu_torch.core.march import march, march_scan
    from raymarching_tpu_torch.core.sdf import scene_sd
    plan, tables = rt.compile_scene(rt.load_scene(str(SCENES / "demo.txt")))
    cfg = rt.RenderConfig(width=12, height=8, ssaa=1, iterations=120)
    tt = tables_to_torch(tables, "cpu", requires_grad=("prim_pos",))
    o, d = cam.generate_rays(tt, cfg)
    d = d.reshape(-1, 3)
    R = d.shape[0]
    tmax = torch.linspace(2.0, 12.0, R)
    start = torch.arange(R) % 7 == 0

    def sd(q):
        return scene_sd(plan, tt, q)

    def flat(out):
        if isinstance(out[0], tuple):
            return [*out[0], out[1]]
        return list(out)

    for kw in (dict(), dict(tmax=tmax), dict(tmax=tmax, project_t=True),
               dict(with_steps=True), dict(tmax=tmax, soft_k=4.0),
               dict(tmax=tmax, soft_k=4.0, project_t=True),
               dict(init_done=start, with_steps=True)):
        want = flat(march(sd, o, d, cfg.iterations, 1e-3, **kw))
        with torch.no_grad():
            plain = march_scan(sd, o, d, cfg.iterations, 1e-3, **kw)
        for got in (march(sd, o, d, cfg.iterations, 1e-3,
                          differentiable=True, **kw), plain):
            got = flat(got)
            assert all(torch.equal(a.detach(), b.detach())
                       for a, b in zip(got, want)), kw
