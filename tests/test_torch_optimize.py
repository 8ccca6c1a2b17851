"""The port's ``fit``: it recovers a shifted sphere (tests/test_optimize.py's
case, FD normals), a resumed run equals an uninterrupted one, untrained
fields stay put, and the checkpoint is the JAX package's npz format."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.io.checkpoint import load_checkpoint  # noqa: E402
from raymarching_tpu.scene.compile import compile_tree  # noqa: E402
from raymarching_tpu.scene.csg import ListNode, Mode, Sphere, bounds  # noqa: E402
from raymarching_tpu.scene.objects import Camera, Light  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
from raymarching_tpu_torch.ops import surface_kernel as sk  # noqa: E402

CFG = RenderConfig(width=24, height=16, ssaa=1, iterations=80,
                   shadows=False)


def _world(dx=0.0):
    """tests/test_optimize.py's world."""
    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        Sphere((dx, 0.0, -6.0), 2.0, color=(0.9, 0.4, 0.2)),
    ])
    return compile_tree(tree, [Light((6.0, 8.0, 4.0))],
                        Camera(position=(0, 0, 6), fov=55.0))


@pytest.fixture(scope="module")
def problem():
    plan, tables0 = _world(0.0)
    _, tables_target = _world(0.3)
    target = rt.render_tables(plan, tables_target, CFG, device="cpu")
    return plan, tables0, target


def test_fit_recovers_sphere_shift():
    plan, tables0 = _world(0.0)
    _, tables_target = _world(0.35)
    target = rt.render_tables(plan, tables_target, CFG, device="cpu")
    res = rt.fit(plan, tables0, target, CFG, device="cpu", steps=40, lr=3e-2,
                 trainable=("prim_pos",))
    assert res.steps == 40 and len(res.losses) == 40
    assert res.losses[-1] < res.losses[0] * 0.5
    fitted_dx = float(res.tables.prim_pos[1, 0])
    assert abs(fitted_dx - 0.35) < 0.1


def test_fit_resume_matches_uninterrupted_run(problem, tmp_path):
    """A 6 + 6-step run resumed from its checkpoint (tables, step and Adam
    state) lands on the parameters of an uninterrupted 12-step run."""
    plan, tables0, target = problem
    path = str(tmp_path / "fit.npz")
    kw = dict(device="cpu", lr=2e-2, trainable=("prim_pos",))
    full = rt.fit(plan, tables0, target, CFG, steps=12, **kw)
    rt.fit(plan, tables0, target, CFG, steps=6, checkpoint_path=path,
           checkpoint_every=100, **kw)
    _, step, extra = load_checkpoint(path)
    assert step == 6 and any(k.startswith("torch_opt.") for k in extra)
    resumed = rt.fit(plan, tables0, target, CFG, steps=12,
                     checkpoint_path=path, resume=True, **kw)
    assert resumed.steps == 6
    np.testing.assert_allclose(resumed.tables.prim_pos.numpy(),
                               full.tables.prim_pos.numpy(), rtol=0,
                               atol=1e-6)
    # a fresh optimizer when the saved state is for other fields: one step
    # from the checkpoint equals one step of a new fit from its tables
    saved, step, _ = load_checkpoint(path)
    kw["trainable"] = ("prim_pos", "light_pos")
    other = rt.fit(plan, tables0, target, CFG, steps=step + 1,
                   checkpoint_path=path, resume=True, **kw)
    fresh = rt.fit(plan, saved, target, CFG, steps=1, **kw)
    assert other.steps == 1
    for a, b in zip(other.tables, fresh.tables):
        assert torch.equal(a, b)


def test_fit_updates_only_trainable_fields(problem, tmp_path):
    plan, tables0, target = problem
    seen = []

    def callback(step, loss, tables):
        seen.append((step, loss, tables.prim_color.grad.clone()))

    path = str(tmp_path / "fit.npz")
    k1, k2 = rk.render_rays.launches, sk.surface_eval.launches
    res = rt.fit(plan, tables0, target, CFG, device="cpu", steps=3, lr=1e-2,
                 trainable=("prim_color", "light_pos"), callback=callback,
                 checkpoint_path=path)
    assert (rk.render_rays.launches, sk.surface_eval.launches) == (k1, k2)
    assert [s for s, _, _ in seen] == [0, 1, 2]
    assert [loss for _, loss, _ in seen] == res.losses
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0
               for _, _, g in seen)
    for name, before, after in zip(tables0._fields, tables0, res.tables):
        if name in ("prim_color", "light_pos"):
            assert not np.array_equal(after.numpy(), before), name
        else:
            np.testing.assert_array_equal(after.numpy(), before,
                                          err_msg=name)
    # the checkpoint loads through the JAX package's numpy-only reader
    saved, step, _ = load_checkpoint(path)
    assert step == 3
    for name, a, b in zip(saved._fields, saved, res.tables):
        assert a.dtype == np.float32, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_fit_over_a_mesh_raises(problem, tmp_path):
    """``fit(mesh=)`` (it raised before the sharded path was ported): with
    no process group a mesh cannot be made (RuntimeError, never a hidden
    group of one); over the one-process group ``initialize`` forms with an
    ``init_method`` it gives ``fit()``'s tables and losses bitwise (one
    rank's band is the frame, its all-reduce the identity); a mesh of more
    devices than processes raises ValueError."""
    from raymarching_tpu_torch.parallel import distributed, sharded
    plan, tables0, target = problem
    cfg = rt.RenderConfig(**{f: getattr(CFG, f)
                             for f in CFG.__dataclass_fields__})
    kw = dict(device="cpu", steps=2, trainable=("prim_pos", "prim_color"))
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        sharded.make_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="initialize"):
        sharded.make_mesh_2d(1, 1, device_type="cpu")
    assert not torch.distributed.is_initialized()
    distributed.initialize(f"file://{tmp_path}/rendezvous", 1, 0,
                           device="cpu")
    try:
        mesh = sharded.make_mesh(device_type="cpu")
        got = rt.fit(plan, tables0, target, cfg, mesh=mesh, **kw)
        with pytest.raises(ValueError, match="need 2 devices"):
            sharded.make_mesh(2, device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()
    want = rt.fit(plan, tables0, target, cfg, **kw)
    assert got.losses == want.losses
    for a, b in zip(got.tables, want.tables):
        assert torch.equal(a, b)
