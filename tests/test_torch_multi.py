"""The port's multi-kernel backend (``backend="multi"``: K3 for primary and
shadow rays, K2 for colours and normals; their plain twins on the CPU)
against the JAX package's (``backend="pallas"``, Pallas interpret mode),
against the port's own fused backend, its gradients against JAX ``jnp``,
and ``MarchOp`` / ``NormalOp`` against autograd through the plain
``scene_sd``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import deep_scene, one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402
from raymarching_tpu.scene.compile import SceneTables, compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.api import make_render_hooks  # noqa: E402
from raymarching_tpu_torch.core import shading  # noqa: E402
from raymarching_tpu_torch.core.march import dot3  # noqa: E402
from raymarching_tpu_torch.core.sdf import scene_sd  # noqa: E402
from raymarching_tpu_torch.ops import march_kernel as mk  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
from raymarching_tpu_torch.ops import scene_vjp as tvjp  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.ops.march_op import march_op  # noqa: E402
from raymarching_tpu_torch.ops.normal_op import normal_op  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402
from test_scene_vjp import _points, _tie_free, _world  # noqa: E402
from test_torch_grad import _assert_close, _carve_rows  # noqa: E402
from test_torch_render_kernel import CFG as MEGA_CFG  # noqa: E402
from test_torch_render_kernel import _mega_world  # noqa: E402

FIELDS = SceneTables._fields
# tests/test_mega.py:87, the cross-path image tolerance, and :38, the
# tolerance of the JAX package's pallas against its mega backend
ATOL, FUSED_ATOL = 5e-4, 1e-6
GREY = 0.25
IMAGE_CASES = {
    "mega_world": MEGA_CFG,
    "demo": RenderConfig(width=32, height=24, ssaa=1, iterations=120),
}
GRAD_CASES = {
    "world": RenderConfig(width=16, height=16, ssaa=1, iterations=60,
                          shadows=True),
    "demo": RenderConfig(width=24, height=16, ssaa=1, iterations=80),
}


def _scene(name, scenes_dir):
    if name == "mega_world":
        return _mega_world()
    if name == "world":
        return _world()
    return compile_scene(load_scene(str(scenes_dir / f"{name}.txt")))


@pytest.fixture(scope="module", params=sorted(IMAGE_CASES))
def images(request, scenes_dir):
    cfg = IMAGE_CASES[request.param]
    plan, tables = _scene(request.param, scenes_dir)
    counts = (rk.render_rays.launches, sk.surface_eval.launches,
              mk.march_rays.launches)
    multi = rt.render_tables(plan, tables, cfg, backend="multi",
                             device="cpu").numpy()
    # CPU tensors take the plain twins: no kernel launches
    assert counts == (rk.render_rays.launches, sk.surface_eval.launches,
                      mk.march_rays.launches)
    return {
        "multi": multi,
        "fused": rt.render_tables(plan, tables, cfg, backend="cuda",
                                  device="cpu").numpy(),
        "ref": rt.render_tables(plan, tables, cfg, backend="ref",
                                device="cpu").numpy(),
        "jax_pallas": np.asarray(jax_render_tables(
            plan, tables, cfg, backend="pallas", interpret=True)),
    }


def test_multi_image_matches_jax_pallas_backend(images):
    assert images["multi"].max() > 0.2
    np.testing.assert_allclose(images["multi"], images["jax_pallas"], rtol=0,
                               atol=ATOL)


def test_multi_image_matches_fused_backend(images):
    np.testing.assert_allclose(images["multi"], images["fused"], rtol=0,
                               atol=FUSED_ATOL)


def test_multi_image_matches_port_oracle(images):
    np.testing.assert_allclose(images["multi"], images["ref"], rtol=0,
                               atol=ATOL)


def test_multi_without_shadows_and_lights(scenes_dir):
    plan, tables = _scene("mega_world", scenes_dir)
    cfg = MEGA_CFG.replace(shadows=False, ssaa=1)
    np.testing.assert_allclose(
        rt.render_tables(plan, tables, cfg, backend="multi", device="cpu"),
        rt.render_tables(plan, tables, cfg, backend="cuda", device="cpu"),
        rtol=0, atol=FUSED_ATOL)
    # a light-less, leaf-less scene: black, finite
    empty = rt.compile_scene(rt.scene.parser.parse_scene(""))
    img = rt.render_tables(*empty, cfg, backend="multi", device="cpu")
    assert bool(torch.isfinite(img).all()) and float(img.abs().max()) == 0.0


def test_soft_shadows_and_ao_route_to_the_fused_backend(scenes_dir,
                                                       monkeypatch):
    """As raymarching_tpu.api.render_tables: the hooks carry no penumbra
    or occlusion factor, so these go to the fused backend (K1's extended
    entry; its twin here): the image of backend="cuda", bit for bit, and
    no hook is built."""
    from raymarching_tpu_torch import api
    plan, tables = _scene("mega_world", scenes_dir)
    for change in (dict(soft_shadow_k=8.0), dict(ao_strength=0.5)):
        cfg = MEGA_CFG.replace(**change)
        want = rt.render_tables(plan, tables, cfg, backend="cuda",
                                device="cpu")
        with monkeypatch.context() as m:
            m.setattr(api, "make_render_hooks", None)
            img = rt.render_tables(plan, tables, cfg, backend="multi",
                                   device="cpu")
        assert torch.equal(img, want)


def test_hooks_of_each_backend(scenes_dir):
    plan, tables = _scene("mega_world", scenes_dir)
    tt = tables_to_torch(tables, "cpu")
    assert make_render_hooks(plan, tt, MEGA_CFG, "ref") == {}
    assert sorted(make_render_hooks(plan, tt, MEGA_CFG, "multi")) == [
        "march_fn", "normal_fn", "shadow_fn", "surface_fn"]
    with pytest.raises(ValueError):
        make_render_hooks(plan, tt, MEGA_CFG, "cuda")
    with pytest.raises(ValueError, match="backend"):
        make_render_hooks(plan, tt, MEGA_CFG, "pallas")


@pytest.fixture(scope="module", params=sorted(GRAD_CASES))
def grads(request, scenes_dir):
    cfg = GRAD_CASES[request.param]
    plan, tables = _scene(request.param, scenes_dir)

    @jax.jit
    def jax_grads(t):
        img, vjp = jax.vjp(lambda t_: jax_render_tables(
            plan, t_, cfg, backend="jnp", differentiable=True), t)
        return vjp(2.0 * (img - GREY) / img.size)[0]

    want = [np.asarray(v, np.float64) for v in jax_grads(tables)]
    got = {}
    for backend in ("multi", "cuda"):
        tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
        img = rt.render_tables(plan, tt, cfg.replace(shade_skip_black=False),
                               backend=backend, differentiable=True,
                               device="cpu")
        g = torch.autograd.grad(torch.mean((img - GREY) ** 2), tt,
                                allow_unused=True, materialize_grads=True)
        got[backend] = [v.numpy().astype(np.float64) for v in g]
    return request.param, plan, got, want


@pytest.mark.parametrize("field", FIELDS)
def test_multi_gradients_match_jax_jnp(grads, field):
    name, plan, got, want = grads
    a, b = got["multi"][FIELDS.index(field)], want[FIELDS.index(field)]
    assert np.isfinite(a).all()
    scale = max(np.abs(b).max(), 1e-8)
    if name == "demo" and field in ("prim_pos", "prim_aux"):
        # ties over the sponge's open regions: the carve rows as one sum
        # (tests/test_torch_grad.py)
        carve = _carve_rows(plan)
        _assert_close(a[carve].sum(axis=0), b[carve].sum(axis=0), scale,
                      f"{field} carve sum")
        a = np.delete(a, np.arange(a.shape[0])[carve], axis=0)
        b = np.delete(b, np.arange(b.shape[0])[carve], axis=0)
    _assert_close(a, b, scale, field)


@pytest.mark.parametrize("field", FIELDS)
def test_multi_gradients_match_fused_backend(grads, field):
    """Two routes to one derivative: the IFT weight on the hit row plus the
    FD chain on six stencil rows (MarchOp, NormalOp), against the fused
    backward's one 7-row scatter."""
    _, _, got, _ = grads
    a, b = got["multi"][FIELDS.index(field)], got["cuda"][FIELDS.index(field)]
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4 * scale,
                               err_msg=field)
    if field != "light_color":
        assert np.abs(a).max() > 0


# --- the two autograd functions alone --------------------------------------

OP_CFG = RenderConfig(width=16, height=16, ssaa=1, iterations=60)
GEOMETRY = ("prim_pos", "prim_aux")


def _op_case():
    plan, tables = _world()
    p = np.array(_points())
    clean = np.array(_tie_free(plan, tables, jnp.asarray(p)))
    rng = np.random.default_rng(3)
    return plan, tables, p, clean, rng.normal(size=p.shape).astype(np.float32)


def test_normal_op_matches_autograd_through_plain_scene_sd():
    plan, tables, p, clean, c = _op_case()
    # off ties at the point and at every stencil point
    for q in sk.stencil_points(torch.as_tensor(p), OP_CFG.fd_h,
                               center=False):
        clean &= np.asarray(_tie_free(plan, tables, jnp.asarray(q.numpy())))
    assert clean.mean() > 0.8
    p, c = torch.as_tensor(p[clean]), torch.as_tensor(c[clean])
    out = {}
    for route in ("op", "plain"):
        tt = tables_to_torch(tables, "cpu", requires_grad=GEOMETRY)
        pt = p.clone().requires_grad_()
        if route == "op":
            g = normal_op(plan, OP_CFG, tt, pt)
        else:
            g = shading.normal_fd(lambda q: scene_sd(plan, tt, q), pt,
                                  OP_CFG.fd_h)
        out[route] = (g.detach(), torch.autograd.grad(
            (g * c).sum(), [pt, tt.prim_pos, tt.prim_aux]))
    # the values: two folds of one field, scaled by 1 / 2h = 500
    torch.testing.assert_close(out["op"][0], out["plain"][0], rtol=0,
                               atol=2e-3)
    for name, a, b in zip(("p",) + GEOMETRY, out["op"][1], out["plain"][1]):
        scale = max(b.abs().max().item(), 1e-8)
        # float64 sums against autograd's float32 ones, over terms of
        # +-500 that nearly cancel
        torch.testing.assert_close(a, b, rtol=1e-3, atol=2e-3 * scale,
                                   msg=name)
        # (a size's cotangents of +u and -u cancel exactly wherever both
        # stencil points of an axis share their winner)
        assert a.abs().max() > 0 or name == "prim_aux", name


def test_normal_op_refuses_unported_branches(scenes_dir):
    # both normals on exact tables and on the fused generator field, with
    # procedural leaves too, are ported, and so is a depth-3 plan (D8) in
    # every one of them: K2's twin on the deep fold, the field's exact
    # normal whatever fused_generators says (as the JAX kernels' generic
    # evaluator has no fused branch)
    plan, tables = rt.compile_scene(deep_scene(rt.load_scene(str(
        scenes_dir / "config1.txt"))))
    assert plan.kernel is None
    tt = tables_to_torch(tables, "cpu")
    p = torch.as_tensor(np.array(_points(8)))
    want = {"fd": shading.normal_fd(lambda q: scene_sd(plan, tt, q), p,
                                    OP_CFG.fd_h),
            "analytic": shading.normal_analytic(
                lambda q: scene_sd(plan, tt, q), p)}
    for change in (dict(), dict(normal_mode="analytic"),
                   dict(fused_generators=True),
                   dict(normal_mode="analytic", fused_generators=True)):
        cfg = OP_CFG.replace(**change)
        g = normal_op(plan, cfg, tt, p)
        assert g.shape == p.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, want[cfg.normal_mode], rtol=0,
                                   atol=2e-3)
        torch.testing.assert_close(g, normal_op(plan, cfg.replace(
            fused_generators=False), tt, p), rtol=0, atol=0)


def test_march_op_matches_ift_through_plain_scene_sd():
    """MarchOp's backward against the implicit-function formulas evaluated
    with autograd through the plain ``scene_sd`` (the JAX package's
    ``march_op._march_bwd``)."""
    plan, tables = _world()
    cfg = OP_CFG
    t0 = tables_to_torch(tables, "cpu")
    from raymarching_tpu_torch.core import camera as cam
    origin, dirs = cam.generate_rays(t0, cfg)
    dirs = dirs.reshape(-1, 3)
    origin = origin.expand(dirs.shape).contiguous()
    hit = mk.march_rays(plan, cfg, t0, origin, dirs)
    clean = torch.as_tensor(np.array(_tie_free(
        plan, tables, jnp.asarray(hit.position.numpy()))))
    assert clean.float().mean() > 0.8 and hit.converged.float().mean() > 0.5
    origin, dirs = origin[clean], dirs[clean]
    c = torch.as_tensor(np.random.default_rng(4).normal(
        size=tuple(dirs.shape)).astype(np.float32))

    tt = tables_to_torch(tables, "cpu", requires_grad=GEOMETRY)
    o, d = origin.clone().requires_grad_(), dirs.clone().requires_grad_()
    res = march_op(plan, cfg, tt, o, d)
    assert not res.sd.requires_grad and res.converged.dtype == torch.bool
    got = torch.autograd.grad((res.position * c).sum(),
                              [o, d, tt.prim_pos, tt.prim_aux])

    tt = tables_to_torch(tables, "cpu", requires_grad=GEOMETRY)
    p_hit = res.position.detach().requires_grad_()
    f = scene_sd(plan, tt, p_hit)
    (grad_p,) = torch.autograd.grad(f.sum(), p_hit, retain_graph=True)
    t_bar = torch.where(res.converged, dot3(c, dirs), torch.zeros(()))
    w = tvjp.ift_ray_weights(t_bar, dot3(grad_p, dirs), cfg.ift_damping)
    pos_bar, aux_bar = torch.autograd.grad((w * f).sum(),
                                           [tt.prim_pos, tt.prim_aux])
    o_bar = c + w[:, None] * grad_p
    t = dot3(p_hit.detach() - origin, dirs) / dot3(dirs, dirs)
    want = (o_bar, t[:, None] * o_bar, pos_bar, aux_bar)
    for name, a, b in zip(("origin", "dirs") + GEOMETRY, got, want):
        scale = max(b.abs().max().item(), 1e-8)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale,
                                   msg=name)
        assert a.abs().max() > 0, name
    # unconverged rays get no implicit gradient: o_bar is p_bar itself
    miss = ~res.converged
    if miss.any():
        assert torch.equal(got[0][miss], c[miss])


@pytest.mark.parametrize("op", ["march", "normal"])
def test_ops_skip_the_scatter_when_no_geometry_field_asks(op, monkeypatch):
    """With no ``prim_pos`` / ``prim_aux`` gradient wanted the backward
    leaves out the parameter scatter and still gives the same ray or point
    cotangents; with nothing wanted at all it evaluates nothing."""
    plan, tables = _world()
    cfg = OP_CFG
    p = torch.as_tensor(np.array(_points(64)))
    d = torch.nn.functional.normalize(torch.as_tensor(
        np.random.default_rng(5).normal(size=(64, 3)).astype(np.float32)),
        dim=1)
    c = torch.as_tensor(np.random.default_rng(6).normal(
        size=(64, 3)).astype(np.float32))

    def run(fields):
        tt = tables_to_torch(tables, "cpu", requires_grad=fields)
        x = p.clone().requires_grad_()
        if op == "march":
            out = march_op(plan, cfg, tt, x, d).position
        else:
            out = normal_op(plan, cfg, tt, x)
        return torch.autograd.grad((out * c).sum(), x)[0]

    full = run(GEOMETRY)
    scatters = []
    real = tvjp.segment_add
    monkeypatch.setattr(tvjp, "segment_add",
                        lambda *a: scatters.append(1) or real(*a))
    assert torch.equal(run(("prim_color",)), full) and not scatters
    assert torch.equal(run(GEOMETRY), full) and scatters

    # nothing wanted of the op itself: no K2 evaluation in the backward
    from raymarching_tpu_torch.ops import march_op as mop, normal_op as nop

    def refuse(*a, **k):
        raise AssertionError("the backward evaluated the scene")

    monkeypatch.setattr(mop, "surface_eval", refuse)
    monkeypatch.setattr(nop, "stencil_eval", refuse)
    tt = tables_to_torch(tables, "cpu", requires_grad=("prim_color",))
    if op == "march":
        out = march_op(plan, cfg, tt, p, d).position
    else:
        out = normal_op(plan, cfg, tt, p)
    (g,) = torch.autograd.grad((out * c).sum(), tt.prim_color,
                               allow_unused=True)
    assert g is None
