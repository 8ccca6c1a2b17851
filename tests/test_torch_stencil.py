"""K2's stencil entry in the port: ``surface_stencil`` (what the backward
passes call through ``scene_vjp.stencil_eval``) against the route it
replaces, ``stencil_points`` + ``surface_eval_plain``, in layout and bits;
against the JAX package's ``stencil_eval`` with and without the centre row;
the backward passes that reach it; and K2's ``multipoint`` keyword.  On the
CPU the entry takes its plain twin; the kernel that makes the stencil
points itself is checked on the card by tests/test_torch_kernel_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.ops import scene_vjp as jvjp  # noqa: E402
from raymarching_tpu.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.ops import normal_op  # noqa: E402
from raymarching_tpu_torch.ops import scene_vjp as tvjp  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402
from raymarching_tpu_torch.ops.render_op import FusedRender  # noqa: E402
from raymarching_tpu_torch.scene.compile import SceneTables  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402
from test_scene_vjp import _points, _tie_free, _world  # noqa: E402
from test_torch_surface import (G_ATOL, SD_ATOL, SD_RTOL,  # noqa: E402
                                _demo_points)

CFG = RenderConfig(width=16, height=16, ssaa=1, iterations=60)


def _case(name, scenes_dir):
    if name == "world":
        plan, tables = _world()
        return plan, tables, np.array(_points())
    plan, tables = compile_scene(load_scene(str(scenes_dir / "demo.txt")))
    return plan, tables, _demo_points(seed=3)


@pytest.mark.parametrize("center", [True, False])
def test_stencil_points_rows_and_offsets(center):
    p = torch.as_tensor(_demo_points(seed=1))
    h = CFG.fd_h
    q = sk.stencil_points(p, h, center=center)
    K = 7 if center else 6
    assert q.shape == (K, p.shape[0], 3) and q.dtype == torch.float32
    first = 1 if center else 0
    if center:
        assert torch.equal(q[0], p)
    hf = torch.tensor(h, dtype=torch.float32)
    for a in range(3):
        for row, d in ((first + a, hf), (first + 3 + a, -hf)):
            want = p.clone()
            # one float32 addition on the offset's axis, none on the others
            want[:, a] = p[:, a] + d
            assert torch.equal(q[row], want), (row, a)


@pytest.mark.parametrize("collapse", [True, False])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("name", ["world", "demo"])
def test_stencil_entry_equals_points_then_surface_eval(name, center, collapse,
                                                       scenes_dir):
    plan, tables, p = _case(name, scenes_dir)
    tt = tables_to_torch(tables, "cpu")
    pt = torch.as_tensor(p)
    before = sk.surface_eval.launches
    sd, w, g = sk.surface_stencil(plan, tt, pt, CFG.fd_h, center=center,
                                  collapse=collapse)
    assert sk.surface_eval.launches == before      # the plain twin
    K, R = (7 if center else 6), p.shape[0]
    assert sd.shape == (K, R) and w.shape == (K, R) and g.shape == (K, R, 3)
    assert sd.dtype == torch.float32 and w.dtype == torch.int32
    q = sk.stencil_points(pt, CFG.fd_h, center=center)
    for k in range(K):
        sd_k, w_k, g_k = sk.surface_eval_plain(plan, tt, q[k],
                                               collapse=collapse)
        assert torch.equal(sd[k], sd_k), k
        assert torch.equal(w[k], w_k), k
        assert torch.equal(g[k], g_k), k
    # scene_vjp.stencil_eval is this entry
    for a, b in zip(tvjp.stencil_eval(plan, CFG, tt, pt, center=center,
                                      collapse=collapse), (sd, w, g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["world", "demo"])
def test_six_point_stencil_matches_jax_stencil_eval(name, scenes_dir):
    plan, tables, p = _case(name, scenes_dir)
    sd_j, w_j, g_j = (np.asarray(v) for v in jvjp.stencil_eval(
        plan, CFG, jnp.asarray(p), tables, True, center=False)[:3])
    sd, w, g = (v.numpy() for v in tvjp.stencil_eval(
        plan, CFG, tables_to_torch(tables, "cpu"), torch.as_tensor(p),
        center=False))
    assert sd.shape == sd_j.shape == (6, p.shape[0])
    np.testing.assert_allclose(sd, sd_j, rtol=SD_RTOL, atol=SD_ATOL)
    q = sk.stencil_points(torch.as_tensor(p), CFG.fd_h,
                          center=False).numpy()
    clean = np.asarray(_tie_free(plan, tables,
                                 jnp.asarray(q.reshape(-1, 3)))).reshape(6, -1)
    assert clean.mean() > 0.9
    np.testing.assert_array_equal(w[clean], w_j[clean])
    np.testing.assert_allclose(g[clean], g_j[clean], rtol=0, atol=G_ATOL)


def _count_calls(monkeypatch):
    calls = []
    real = sk.surface_stencil

    def counted(plan, tables, p, h, *, center, collapse=True):
        calls.append((tuple(p.shape), center))
        return real(plan, tables, p, h, center=center, collapse=collapse)

    monkeypatch.setattr(tvjp, "surface_stencil", counted)
    return calls


def test_fused_backward_reaches_the_stencil_entry_once(monkeypatch,
                                                       scenes_dir):
    plan, tables = rt.compile_scene(
        rt.load_scene(str(scenes_dir / "demo.txt")))
    cfg = rt.RenderConfig(width=12, height=8, ssaa=1, iterations=80)
    tt = tables_to_torch(tables, "cpu", requires_grad=("prim_pos",))
    origin, dirs = cam.generate_rays(tt, cfg)
    calls = _count_calls(monkeypatch)
    colors = FusedRender.apply(plan, cfg, origin, dirs.reshape(-1, 3), *tt)
    assert calls == []
    colors.mean().backward()
    assert calls == [((cfg.rays_per_image, 3), True)]
    assert float(tt.prim_pos.grad.abs().max()) > 0


def test_normal_op_backward_reaches_the_stencil_entry_once(monkeypatch,
                                                           scenes_dir):
    plan, tables = rt.compile_scene(
        rt.load_scene(str(scenes_dir / "demo.txt")))
    cfg = rt.RenderConfig(width=12, height=8, ssaa=1, iterations=80)
    tt = tables_to_torch(tables, "cpu", requires_grad=("prim_pos",))
    p = torch.as_tensor(_demo_points(seed=2)[:64]).requires_grad_()
    calls = _count_calls(monkeypatch)
    g = normal_op.normal_op(plan, cfg, tt, p)
    assert calls == []
    g.square().sum().backward()
    assert calls == [((64, 3), False)]
    assert bool(torch.isfinite(p.grad).all())
    assert float(p.grad.abs().max()) > 0


def test_stencil_entry_checks_its_arguments(scenes_dir):
    plan, tables = rt.compile_scene(
        rt.load_scene(str(scenes_dir / "demo.txt")))
    tt = tables_to_torch(tables, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        sk.surface_stencil(plan, tt, torch.zeros((4, 3), device="meta"),
                           1e-3, center=True)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.surface_eval(plan, tt, torch.zeros((4, 3), device="meta"))


@pytest.mark.parametrize("multipoint", [True, False])
def test_multipoint_keyword_keeps_the_fd_gradient_bits(multipoint,
                                                       scenes_dir):
    """``multipoint`` chooses how the kernel walks the scene; the twin's
    arithmetic per point is the same under either."""
    plan, tables = rt.compile_scene(
        rt.load_scene(str(scenes_dir / "demo.txt")))
    tt = tables_to_torch(tables, "cpu")
    p = torch.as_tensor(_demo_points(seed=4))
    got = sk.surface_eval(plan, tt, p, mode=sk.FD_GRAD, fd_h=CFG.fd_h,
                          multipoint=multipoint)
    want = sk.surface_eval_plain(plan, tt, p, mode=sk.FD_GRAD, fd_h=CFG.fd_h)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert got[1] is None


def test_tables_fields_untouched_by_the_stencil_entry(scenes_dir):
    """The entry reads its tables; a fit's leaf tensors keep their values
    and record no graph."""
    plan, tables = rt.compile_scene(
        rt.load_scene(str(scenes_dir / "demo.txt")))
    tt = tables_to_torch(tables, "cpu", requires_grad=SceneTables._fields)
    before = [v.detach().clone() for v in tt]
    sd, w, g = sk.surface_stencil(plan, tt, torch.as_tensor(_demo_points()),
                                  CFG.fd_h, center=True)
    assert not (sd.requires_grad or g.requires_grad)
    for a, b in zip(tt, before):
        assert torch.equal(a.detach(), b)
