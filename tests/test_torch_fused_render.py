"""Fused generators end to end in the port against the JAX package, on the
CPU (the kernels' plain twins): images of the ``cuda``, two-phase and
``multi`` paths against JAX's fused ``mega`` render (interpret mode) in
both normal modes; the gradients of every SceneTables field through the
fused FD and fused analytic backwards, ``cuda`` and ``multi``, against
JAX's; the analytic backward that evaluates nothing with the forward's
residuals; ``render_aovs`` against JAX's; and the fused gate of the demo
(fused analytic against exact FD) classified by the port's
``utils.gatecheck``, held equal to JAX's."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_aovs as jax_render_aovs  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402
from raymarching_tpu.scene.compile import SceneTables, compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
from raymarching_tpu.utils import gatecheck as jgate  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.api import render_aovs  # noqa: E402
from raymarching_tpu_torch.ops import render_op  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402
from raymarching_tpu_torch.utils import gatecheck as tgate  # noqa: E402

FIELDS = SceneTables._fields
# tests/test_mega.py:87's image tolerance on a share of the pixels
# (tests/test_fused_menger.py's 0.995), and :62's gradient rule
IMG_ATOL, IMG_SHARE = 5e-4, 0.995
RTOL, ATOL_SCALE = 0.02, 0.005
GREY = 0.25
BASE = RenderConfig(width=32, height=24, ssaa=1, iterations=300,
                    tile_sublanes=8, fused_generators=True)


def _compiled(name, scenes_dir):
    return compile_scene(load_scene(str(scenes_dir / f"{name}.txt")))


@pytest.fixture(scope="module", params=[("demo", "fd"), ("demo", "analytic"),
                                        ("config4", "fd"),
                                        ("config3", "analytic")],
                ids=lambda v: "-".join(v))
def image_case(request, scenes_dir):
    name, normal = request.param
    plan, tables = _compiled(name, scenes_dir)
    cfg = BASE.replace(normal_mode=normal)
    want = np.asarray(jax_render_tables(plan, tables, cfg, backend="mega",
                                        interpret=True))
    return plan, tables, cfg, want


@pytest.mark.parametrize("path", ["cuda", "two-phase", "multi"])
def test_fused_images_match_jax_mega(image_case, path):
    """The fused image of each path against JAX's fused mega kernel at
    tests/test_mega.py's image tolerance on 99.5% of the pixels; the
    two-phase image equals the one-kernel image."""
    plan, tables, cfg, want = image_case
    c = cfg.replace(two_phase_k1=16) if path == "two-phase" else cfg
    backend = "multi" if path == "multi" else "cuda"
    img = rt.render_tables(plan, tables, c, backend=backend, device="cpu")
    diff = np.abs(img.numpy() - want).max(axis=-1)
    assert (diff < IMG_ATOL).mean() > IMG_SHARE, (diff >= IMG_ATOL).sum()
    assert img.max() > 0
    if path == "two-phase":
        assert torch.equal(img, rt.render_tables(plan, tables, cfg,
                                                 device="cpu"))


@pytest.fixture(scope="module", params=["fd", "analytic"])
def grads(request, scenes_dir):
    plan, tables = _compiled("demo", scenes_dir)
    cfg = BASE.replace(width=24, height=16, iterations=200,
                       normal_mode=request.param)

    @jax.jit
    def jax_grads(t):
        img, vjp = jax.vjp(lambda t_: jax_render_tables(
            plan, t_, cfg, backend="mega", interpret=True,
            differentiable=True), t)
        return [vjp(2.0 * (img - y) / img.size)[0] for y in (0.0, GREY)]

    want = [[np.asarray(v, np.float64) for v in g]
            for g in jax_grads(tables)]
    got = {}
    for backend in ("cuda", "multi"):
        tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
        img = rt.render_tables(plan, tt, cfg, backend=backend,
                               differentiable=True, device="cpu")
        got[backend] = []
        for y in (0.0, GREY):
            g = torch.autograd.grad(torch.mean((img - y) ** 2), tt,
                                    retain_graph=True, allow_unused=True,
                                    materialize_grads=True)
            got[backend].append([v.numpy().astype(np.float64) for v in g])
    return got, want


@pytest.mark.parametrize("backend", ["cuda", "multi"])
@pytest.mark.parametrize("loss", ["img^2", "grey"])
@pytest.mark.parametrize("field", FIELDS)
def test_fused_gradients_match_jax(grads, field, loss, backend):
    """Every field's gradient through the fused FD backward (autograd
    through scene_sd_fused) and the fused analytic one (the winner
    residuals, the fused Hessian chain, extended rows onto base rows), on
    the fused and the multi-kernel backends, against JAX's fused mega
    gradients at tests/test_mega.py:62's tolerance."""
    got, want = grads
    k = ("img^2", "grey").index(loss)
    a, b = got[backend][k][FIELDS.index(field)], want[k][FIELDS.index(field)]
    assert np.isfinite(a).all()
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=field)


@pytest.mark.parametrize("scene", ["demo", "config3"])
def test_fused_residual_backward_evaluates_nothing(scene, scenes_dir,
                                                   monkeypatch):
    """With the forward's winner residuals the fused analytic backward
    calls no scene evaluation (on the card: launches no kernel); without
    them it calls the fused winner_eval once; the gradients are the same
    bits, and the residuals name carves by extended ids."""
    plan, tables = _compiled(scene, scenes_dir)
    cfg = BASE.replace(width=24, height=16, normal_mode="analytic")
    calls = []

    def counted(fn):
        def wrapper(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapper

    for name in ("winner_eval", "fused_winner_eval", "stencil_eval"):
        monkeypatch.setattr(render_op, name, counted(getattr(render_op,
                                                             name)))
    out = {}
    for save in (True, False):
        monkeypatch.setattr(render_op, "SAVE_WINNER", save)
        calls.clear()
        tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
        img = rt.render_tables(plan, tt, cfg, differentiable=True,
                               device="cpu")
        out[save] = torch.autograd.grad(
            torch.mean((img - GREY) ** 2), list(tt), allow_unused=True,
            materialize_grads=True)
        assert calls == ([] if save else ["fused_winner_eval"])
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    assert out[True][FIELDS.index("prim_aux")].abs().max() > 0


def test_render_aovs_match_jax(scenes_dir):
    """The port's AOV planes of a fused analytic frame against JAX's: one
    K1 launch with both skips off and one K2 normal launch there, the
    twins here."""
    plan, tables = _compiled("demo", scenes_dir)
    cfg = BASE.replace(ssaa=2, normal_mode="analytic")
    want = {k: np.asarray(v) for k, v in jax_render_aovs(
        plan, tables, cfg, interpret=True).items()}
    got = {k: v.numpy() for k, v in render_aovs(plan, tables, cfg,
                                                 device="cpu").items()}
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["hit"], want["hit"])
    np.testing.assert_array_equal(got["objid"], want["objid"])
    np.testing.assert_array_equal(got["shadow"], want["shadow"])
    fin = np.isfinite(want["depth"])
    np.testing.assert_array_equal(np.isfinite(got["depth"]), fin)
    np.testing.assert_allclose(got["depth"][fin], want["depth"][fin],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["normal"], want["normal"], atol=1e-4)
    diff = np.abs(got["color"] - want["color"]).max(axis=-1)
    assert (diff < IMG_ATOL).mean() > IMG_SHARE
    # the colour plane is render_tables' image
    assert np.array_equal(got["color"], rt.render_tables(
        plan, tables, cfg, device="cpu").numpy())


def test_demo_fused_gate_with_the_ports_gatecheck(scenes_dir):
    """tests/test_gate_offenders.py:112-136 on the port: the fused analytic
    image against the exact FD image of the demo (64x36 SSAA 2),
    classified against the exact AOVs by the port's gatecheck: every
    offender on a silhouette, a mask that does not blanket the frame, and
    the same classification as JAX's gatecheck on the same planes."""
    plan, tables = _compiled("demo", scenes_dir)
    cfg = RenderConfig(width=64, height=36, ssaa=2, iterations=300,
                       normal_mode="fd")
    exact = rt.render_tables(plan, tables, cfg, device="cpu").numpy()
    fused = rt.render_tables(plan, tables, cfg.replace(
        fused_generators=True, normal_mode="analytic"), device="cpu").numpy()
    diff = np.abs(exact - fused).max(axis=-1)
    aovs = {k: v.numpy() for k, v in render_aovs(plan, tables, cfg,
                                                 device="cpu").items()}
    planes = dict(shadow=aovs["shadow"], normal=aovs["normal"])
    cls = tgate.classify_offenders(diff, 5e-3, aovs["objid"], aovs["depth"],
                                   aovs["hit"], **planes)
    assert cls == jgate.classify_offenders(diff, 5e-3, aovs["objid"],
                                           aovs["depth"], aovs["hit"],
                                           **planes)
    assert cls["all_on_silhouette"], cls["interior_yx"]
    frac = tgate.silhouette_mask(aovs["objid"], aovs["depth"], aovs["hit"],
                                 **planes).mean()
    assert frac < 0.7, frac
