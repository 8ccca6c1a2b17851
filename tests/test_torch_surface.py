"""K2 in the port: the plain twin ``surface_eval_plain`` (what a CPU tensor
gets from ``surface_eval``) against the JAX surface kernel (Pallas
interpret mode): its combined mode through ``winner_eval`` and
``stencil_eval``, its sd, winner and FD-gradient modes through
``pallas_surface_eval``; the leaf gradients against
``pallas_march._prim_sd_grad``.  The kernel itself
is checked on the card by tests/test_torch_kernel_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.ops import scene_vjp as jvjp  # noqa: E402
from raymarching_tpu.ops.pallas_march import (_prim_sd_grad,  # noqa: E402
                                              pallas_surface_eval)
from raymarching_tpu.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu.scene.csg import PrimType  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
from raymarching_tpu_torch.core import sdf as tsdf  # noqa: E402
from raymarching_tpu_torch.ops import scene_vjp as tvjp  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402
from test_scene_vjp import _points, _tie_free, _world  # noqa: E402

CFG = RenderConfig(width=16, height=16, ssaa=1, iterations=60)
N = 257
# tests/test_fuzz.py's kernel-vs-oracle field tolerance
SD_RTOL, SD_ATOL = 5e-6, 1e-5
# Box and cross gradients are +-1 or 0 and agree exactly; a sphere's
# (p - c) / |p - c| comes out of XLA's CPU code up to an ulp or two off
# PyTorch's (another rounding of the same formula).
G_ATOL = 1e-6


def _demo_points(seed=0):
    """Seeded points over the box that holds the demo's objects (points
    packed round the sponge would mostly sit on the open-region ties of
    its cross arms, where winners may differ)."""
    rng = np.random.default_rng(seed)
    return rng.uniform([-25, -2, -65], [35, 32, -15],
                       (N, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=["world", "demo"])
def case(request, scenes_dir):
    if request.param == "world":
        plan, tables = _world()
        p = np.array(_points())
    else:
        plan, tables = compile_scene(load_scene(str(scenes_dir / "demo.txt")))
        p = _demo_points()
    jax_one = jvjp.winner_eval(plan, CFG, jnp.asarray(p), tables, True)
    jax_st = jvjp.stencil_eval(plan, CFG, jnp.asarray(p), tables, True,
                               center=True)
    tt = tables_to_torch(tables, "cpu")
    port_one = sk.surface_eval(plan, tt, torch.as_tensor(p))
    port_st = tvjp.stencil_eval(plan, CFG, tt, torch.as_tensor(p),
                                center=True)
    return plan, tables, p, jax_one, jax_st[:3], port_one, port_st


def _check(plan, tables, q, jax_out, port_out):
    sd_j, w_j, g_j = (np.asarray(v) for v in jax_out)
    sd_t, w_t, g_t = (v.numpy() for v in port_out)
    np.testing.assert_allclose(sd_t, sd_j, rtol=SD_RTOL, atol=SD_ATOL)
    assert w_t.dtype == np.int32 and g_t.shape == g_j.shape
    clean = np.asarray(_tie_free(plan, tables, jnp.asarray(q)))
    assert clean.mean() > 0.9      # the comparison is not vacuous
    np.testing.assert_array_equal(w_t[clean], w_j[clean])
    np.testing.assert_allclose(g_t[clean], g_j[clean], rtol=0, atol=G_ATOL)


def test_surface_eval_matches_jax_winner_eval(case):
    plan, tables, p, jax_one, _, port_one, _ = case
    _check(plan, tables, p, jax_one, port_one)


def test_stencil_eval_matches_jax_stencil_eval(case):
    plan, tables, p, _, jax_st, _, port_st = case
    sd, w, g = port_st
    assert sd.shape == (7, N) and w.shape == (7, N) and g.shape == (7, N, 3)
    q = sk.stencil_points(torch.as_tensor(p), CFG.fd_h,
                            center=True).reshape(-1, 3).numpy()
    _check(plan, tables, q, [np.asarray(v).reshape((7 * N,) + v.shape[2:])
                             for v in jax_st],
           [v.reshape((7 * N,) + v.shape[2:]) for v in port_st])
    # row 0 is the point itself: the same values as a plain evaluation
    for a, b in zip(port_st, case[5]):
        assert torch.equal(a[0], b)


def test_cpu_tensors_take_the_plain_twin(case):
    plan, tables, p, _, _, port_one, _ = case
    before = sk.surface_eval.launches
    tt = tables_to_torch(tables, "cpu")
    plain = sk.surface_eval_plain(plan, tt, torch.as_tensor(p))
    assert sk.surface_eval.launches == before
    for a, b in zip(port_one, plain):
        assert torch.equal(a, b)
    # the value is the forward fold's own, bitwise, and so is the winner
    # when both fold leaf by leaf; the collapsed combined fold may name
    # another cross of a tie class
    sd, w = tsdf.kernel_fold(plan, tt, torch.as_tensor(p), True)
    leafwise = sk.surface_eval_plain(plan, tt, torch.as_tensor(p),
                                     collapse=False)
    assert torch.equal(sd, plain[0]) and torch.equal(w, leafwise[1])
    clean = torch.as_tensor(np.array(_tie_free(plan, tables,
                                               jnp.asarray(p))))
    assert torch.equal(w[clean], plain[1][clean])


def test_prim_sd_grad_matches_jax_leaf_gradients():
    """Every prim type, with exact ties between the box/cross axes (ties
    go to x, then y) and points on a centre plane (sign 0)."""
    rng = np.random.default_rng(5)
    c = np.array([0.5, -1.0, 2.0], np.float32)
    size = np.array([2.0, 3.0, 4.0], np.float32)
    half = size / 2
    pts = [c + rng.normal(size=(64, 3)).astype(np.float32) * 3,
           c + np.array([[half[0] + 1, half[1] + 1, 0.0],
                         [half[0] + 1, half[1] + 1, half[2] + 1],
                         [0.0, half[1] + 2, half[2] + 2],
                         [-(half[0] + 2), 0.0, half[2] + 2]], np.float32)]
    p = np.concatenate(pts).astype(np.float32)
    tbl = np.zeros((1, 8), np.float32)
    tbl[0, :3], tbl[0, 3:6] = c, size
    for ptype in (PrimType.SPHERE, PrimType.BOX, PrimType.CROSS):
        aux = size if ptype != PrimType.SPHERE else np.array(
            [1.5, 0.0, 0.0], np.float32)
        tbl[0, 3:6] = aux
        _, *gj = _prim_sd_grad(int(ptype), jnp.asarray(tbl), 0,
                               *(jnp.asarray(p[:, a]) for a in range(3)))
        gj = np.stack([np.asarray(v) for v in gj], axis=-1)
        n = p.shape[0]
        gt = tsdf.prim_sd_grad(torch.full((n,), int(ptype)),
                               torch.as_tensor(c).expand(n, 3),
                               torch.as_tensor(aux).expand(n, 3),
                               torch.as_tensor(p)).numpy()
        np.testing.assert_allclose(gt, gj, rtol=0, atol=G_ATOL,
                                   err_msg=str(ptype))


# JAX flags of pallas_surface_eval for each of the port's modes
JAX_MODE = {sk.SD: dict(with_color=False, with_normal=False),
            sk.WINNER: dict(with_color=True, with_normal=False),
            sk.FD_GRAD: dict(with_color=False, with_normal=True)}
# the FD gradient divides differences of SDs by 2 fd_h = 2e-3: an ulp of
# an SD of a few units (2.4e-7) becomes ~2.4e-4 of gradient
FD_G_ATOL = 1e-3


@pytest.mark.parametrize("mode", sorted(JAX_MODE))
def test_surface_modes_match_jax_surface_kernel(case, mode):
    plan, tables, p, *_ = case
    sd_j, w_j, g_j = pallas_surface_eval(
        plan.kernel, CFG.fd_h, CFG.tile_sublanes, jnp.asarray(p), tables,
        interpret=True, **JAX_MODE[mode])
    tt = tables_to_torch(tables, "cpu")
    before = sk.surface_eval.launches
    sd, w, g = sk.surface_eval(plan, tt, torch.as_tensor(p), mode=mode,
                               fd_h=CFG.fd_h)
    assert sk.surface_eval.launches == before      # the plain twin
    np.testing.assert_allclose(sd.numpy(), np.asarray(sd_j), rtol=SD_RTOL,
                               atol=SD_ATOL)
    assert (w is None) == (w_j is None) and (g is None) == (g_j is None)
    clean = np.asarray(_tie_free(plan, tables, jnp.asarray(p)))
    if w is not None:
        assert w.dtype == torch.int32
        np.testing.assert_array_equal(w.numpy()[clean],
                                      np.asarray(w_j)[clean])
    if g is not None:
        # off the points whose stencil straddles a crease of the field
        smooth = np.abs(np.linalg.norm(np.asarray(g_j), axis=-1) - 1) < 1e-2
        assert smooth.mean() > 0.8
        np.testing.assert_allclose(g.numpy()[smooth],
                                   np.asarray(g_j)[smooth], rtol=0,
                                   atol=FD_G_ATOL)
    # every mode's SD is the combined mode's, bitwise, and so is the winner
    # (off the tie sets where the combined mode's collapsed fold may name
    # another cross of the class; everywhere when it folds leaf by leaf)
    sd_c, w_c, _ = case[5]
    assert torch.equal(sd, sd_c)
    if w is not None:
        off_ties = torch.as_tensor(np.array(clean))
        assert torch.equal(w[off_ties], w_c[off_ties])
        assert torch.equal(w, sk.surface_eval(plan, tt, torch.as_tensor(p),
                                              collapse=False)[1])


def test_fd_gradient_is_the_stencil_of_the_sd_mode(case):
    """(f(p + h e_a) - f(p - h e_a)) * (1 / 2h), in that order."""
    plan, tables, p, *_ = case
    tt = tables_to_torch(tables, "cpu")
    pt = torch.as_tensor(p)
    _, _, g = sk.surface_eval(plan, tt, pt, mode=sk.FD_GRAD, fd_h=CFG.fd_h)
    h, inv = CFG.fd_h, 1.0 / (2.0 * CFG.fd_h)
    eye = torch.eye(3) * h
    for a in range(3):
        hi, _, _ = sk.surface_eval(plan, tt, pt + eye[a], mode=sk.SD)
        lo, _, _ = sk.surface_eval(plan, tt, pt - eye[a], mode=sk.SD)
        assert torch.equal(g[:, a], (hi - lo) * inv)


def test_surface_mode_arguments_are_checked(case):
    plan, tables, p, *_ = case
    tt = tables_to_torch(tables, "cpu")
    with pytest.raises(ValueError, match="mode"):
        sk.surface_eval(plan, tt, torch.as_tensor(p), mode=7)
    with pytest.raises(ValueError, match="fd_h"):
        sk.surface_eval(plan, tt, torch.as_tensor(p), mode=sk.FD_GRAD)
