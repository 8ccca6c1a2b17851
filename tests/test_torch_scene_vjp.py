"""The port's winner algebra (ops.scene_vjp) against the JAX package's:
the parameter scatter ``theta_cotangents``, the FD stencil cotangents, the
implicit-function ray weights and the per-leaf statics.

Ties: the port's fold gives a tie wholly to the first minimal leaf, and the
JAX surface kernel's lattice fold may report another member of the tie
class, so cotangents from each side's own winners are compared per leaf
off ties, and as full-table sums with ties included (tied leaves have
identical fields, tests/test_scene_vjp.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.ops import march_op as jmo  # noqa: E402
from raymarching_tpu.ops import scene_vjp as jvjp  # noqa: E402
from raymarching_tpu_torch.ops import scene_vjp as tvjp  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402
from test_scene_vjp import _points, _tie_free, _world  # noqa: E402

CFG = RenderConfig(width=16, height=16, ssaa=1, iterations=60)


@pytest.fixture(scope="module")
def world():
    plan, tables = _world()
    p = np.array(_points(seed=1))
    u = np.random.default_rng(2).normal(size=p.shape[0]).astype(np.float32)
    jax_w = [np.array(v) for v in jvjp.winner_eval(plan, CFG,
                                                   jnp.asarray(p), tables,
                                                   True)]
    tt = tables_to_torch(tables, "cpu")
    port_w = sk.surface_eval(plan, tt, torch.as_tensor(p))
    clean = np.asarray(_tie_free(plan, tables, jnp.asarray(p)))
    return plan, tables, tt, u, jax_w, port_w, clean


def _jax_theta(plan, tables, widx, g, u):
    ct = jvjp.theta_cotangents(plan, tables, jnp.asarray(widx),
                               jnp.asarray(g), jnp.asarray(u))
    return np.asarray(ct.prim_pos), np.asarray(ct.prim_aux)


def _port_theta(plan, tt, widx, g, u):
    return [v.numpy() for v in tvjp.theta_cotangents(
        plan, tt, torch.as_tensor(widx), torch.as_tensor(g),
        torch.as_tensor(u))]


def test_theta_cotangents_match_jax_on_the_same_winners(world):
    """Same (widx, g, u) in: the same scatter out (summation order only),
    misses (widx -1) included."""
    plan, tables, tt, u, (_, widx, g), _, _ = world
    widx = widx.copy()
    widx[::17] = -1
    want = _jax_theta(plan, tables, widx, g, u)
    got = _port_theta(plan, tt, widx, g, u)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


def test_theta_cotangents_match_jax_off_ties(world):
    plan, tables, tt, u, (_, widx_j, g_j), port_w, clean = world
    assert 0.5 < clean.mean() < 1.0   # ties exist and most lanes are clean
    u = np.where(clean, u, 0.0).astype(np.float32)
    want = _jax_theta(plan, tables, widx_j, g_j, u)
    got = [v.numpy() for v in tvjp.theta_cotangents(
        plan, tt, port_w[1], port_w[2], torch.as_tensor(u))]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=2e-4,
                                   atol=1e-5 * max(np.abs(b).max(), 1.0))


def test_theta_cotangent_sums_match_jax_with_ties(world):
    plan, tables, tt, u, (_, widx_j, g_j), port_w, _ = world
    want = _jax_theta(plan, tables, widx_j, g_j, u)
    got = [v.numpy() for v in tvjp.theta_cotangents(
        plan, tt, port_w[1], port_w[2], torch.as_tensor(u))]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.sum(axis=0, dtype=np.float64),
                                   b.sum(axis=0, dtype=np.float64),
                                   rtol=1e-4, atol=1e-4)


def test_leaf_statics_match_jax(world):
    plan = world[0]
    sign_j, sph_j, proc_j = jvjp._leaf_statics(plan)
    sign_t, sph_t, proc_t = tvjp.leaf_statics(plan)
    np.testing.assert_array_equal(sign_t, sign_j)
    np.testing.assert_array_equal(sph_t, sph_j)
    np.testing.assert_array_equal(proc_t, proc_j)


def test_fd_stencil_cotangents_match_jax():
    nbar = np.random.default_rng(3).normal(size=(33, 3)).astype(np.float32)
    want = np.asarray(jvjp.fd_stencil_cotangents(CFG, jnp.asarray(nbar)))
    got = tvjp.fd_stencil_cotangents(CFG, torch.as_tensor(nbar)).numpy()
    assert got.shape == (6, 33)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("damping", [0.0, 3e-3])
def test_ift_ray_weights_match_jax(damping):
    rng = np.random.default_rng(4)
    t_bar = rng.normal(size=64).astype(np.float32)
    # well-conditioned, grazing (|denom| below the 1e-6 floor) and zero
    denom = np.concatenate([rng.normal(size=56),
                            [5e-7, -5e-7, 0.0, -0.0, 1e-6, -1e-6, 2e-3,
                             -2e-3]]).astype(np.float32)
    want = np.asarray(jmo.ift_ray_weights(jnp.asarray(t_bar),
                                          jnp.asarray(denom), damping))
    got = tvjp.ift_ray_weights(torch.as_tensor(t_bar), torch.as_tensor(denom),
                               damping).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_segment_add_drops_misses():
    idx = torch.tensor([0, 2, -1, 2, -3], dtype=torch.int32)
    vals = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    out = tvjp.segment_add(idx, vals, 3)
    np.testing.assert_array_equal(out.numpy(),
                                  [[0, 1], [0, 0], [8, 10]])


def test_segment_add_keeps_what_cancelling_terms_leave():
    """The stencil's +-1/2h cotangents cancel within a leaf's sum: the sum
    is taken in float64, so a float32 sum's rounding of the large terms
    does not swamp what they leave."""
    idx = torch.zeros(3, dtype=torch.int32)
    vals = torch.tensor([[1e8], [1.0], [-1e8]], dtype=torch.float32)
    out = tvjp.segment_add(idx, vals, 1)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), [[1.0]])
