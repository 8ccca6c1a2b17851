"""End-to-end gradients of the port's differentiable render against the JAX
package: ``render_tables(differentiable=True)`` (FusedRender: K1's and
K2's plain twins on the CPU) against JAX ``render_tables(backend="jnp",
differentiable=True)``, for every SceneTables field, at
tests/test_mega.py's gradient tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402
from raymarching_tpu.scene.compile import SceneTables, compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402
from test_scene_vjp import _world  # noqa: E402

FIELDS = SceneTables._fields
# tests/test_mega.py:62: the mega-vs-jnp gradient tolerance
RTOL, ATOL_SCALE = 0.02, 0.005
# a grey target: the MSE against it gives black leaves a colour gradient
# (d pixel / d colour = light), which the MSE against black (img^2) cannot
GREY = 0.25
CASES = {
    "world": RenderConfig(width=16, height=16, ssaa=1, iterations=60,
                          shadows=True),
    "demo": RenderConfig(width=24, height=16, ssaa=1, iterations=80),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def grads(request, scenes_dir):
    cfg = CASES[request.param]
    if request.param == "world":
        plan, tables = _world()
    else:
        plan, tables = compile_scene(load_scene(str(scenes_dir / "demo.txt")))

    @jax.jit
    def jax_grads(t):
        img, vjp = jax.vjp(lambda t_: jax_render_tables(
            plan, t_, cfg, backend="jnp", differentiable=True), t)
        return [vjp(2.0 * (img - y) / img.size)[0] for y in (0.0, GREY)]

    want = [[np.asarray(v, np.float64) for v in g]
            for g in jax_grads(tables)]
    tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
    k1, k2 = rk.render_rays.launches, sk.surface_eval.launches
    img = rt.render_tables(plan, tt, cfg, differentiable=True, device="cpu")
    got = []
    for y in (0.0, GREY):
        g = torch.autograd.grad(torch.mean((img - y) ** 2), tt,
                                retain_graph=True, allow_unused=True,
                                materialize_grads=True)
        got.append([v.numpy().astype(np.float64) for v in g])
    # CPU tensors take the plain twins: no kernel launches
    assert (rk.render_rays.launches, sk.surface_eval.launches) == (k1, k2)
    return request.param, plan, got, want


def _carve_rows(plan):
    """Leaf rows of the demo's Menger carve (its DIFFERENCE group's leaves
    after the base box)."""
    g = max(plan.kernel.groups, key=lambda g: g.count)
    return slice(g.start + 1, g.start + g.count)


def _assert_close(a, b, scale, what):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=what)


@pytest.mark.parametrize("loss", ["img^2", "grey"])
@pytest.mark.parametrize("field", FIELDS)
def test_gradients_match_jax_jnp(grads, field, loss):
    name, plan, got, want = grads
    k = ("img^2", "grey").index(loss)
    a, b = got[k][FIELDS.index(field)], want[k][FIELDS.index(field)]
    assert np.isfinite(a).all()
    scale = max(np.abs(b).max(), 1e-8)
    if name == "demo" and field in ("prim_pos", "prim_aux"):
        # The sponge's cross arms tie over open regions: the port gives a
        # tie to the first leaf, the jnp route splits it evenly, so the
        # carve rows are compared as one group sum (sum conservation,
        # tests/test_scene_vjp.py) and every other row one by one.
        carve = _carve_rows(plan)
        _assert_close(a[carve].sum(axis=0), b[carve].sum(axis=0), scale,
                      f"{field} carve sum")
        a = np.delete(a, np.arange(a.shape[0])[carve], axis=0)
        b = np.delete(b, np.arange(b.shape[0])[carve], axis=0)
    _assert_close(a, b, scale, field)


def test_black_bounds_colour_gradient_is_nonzero(grads):
    """With the black-lane skip off under differentiation, the black
    Bounds leaf gets its colour gradient; against black (img^2) that
    gradient is 0 by the loss itself."""
    name, plan, got, want = grads
    black = list(plan.kernel.black_prims)
    assert black
    c = FIELDS.index("prim_color")
    assert np.abs(got[1][c][black]).min() > 1e-4
    np.testing.assert_array_equal(got[0][c][black], 0.0)
