"""The port's examples (``raymarching_tpu_torch.examples``) against the JAX
repo's scripts (``examples/*.py``), on the CPU: each script's own set-up
(run with its renders and its optimizer stubbed, so its perturbed tables,
configuration, rays and poses are read from it) equals the port's
``setup``; at about 32x24 and 150 iterations each fit's first-step
gradients match the JAX package's at tests/test_mega.py:62's tolerance,
the ``--fit-poses`` pose gradient through ``core.camera.generate_rays``
and ``render_rays`` matches ``jax.grad`` through the JAX package's, and a
turntable frame matches JAX's ``render_tables`` within
tests/test_mega.py:87's 5e-4."""

import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

optax = pytest.importorskip("optax")   # the JAX script's optimizer

from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu.api as japi  # noqa: E402
import raymarching_tpu.optimize  # noqa: E402,F401  (stubbed by the tests)
from raymarching_tpu import RenderConfig as JaxConfig  # noqa: E402
from raymarching_tpu.core import camera as jcam  # noqa: E402
from raymarching_tpu.scene.compile import (  # noqa: E402
    SceneTables as JaxTables)
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.api import render_rays  # noqa: E402
from raymarching_tpu_torch.examples import (fit_fractal,  # noqa: E402
                                            fit_multiview, fit_scene,
                                            turntable)
from raymarching_tpu_torch.scene.compile import SceneTables  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
FIELDS = SceneTables._fields
# tests/test_mega.py:62's gradient tolerance, :87's image tolerance
RTOL, ATOL_SCALE = 0.02, 0.005
IMG_ATOL = 5e-4
SMALL = dict(width=32, height=24, iterations=150)


class _Stop(Exception):
    """Raised by a stub to end a JAX script once its set-up is read."""


def _jax_script(name: str, argv, monkeypatch, **stubs):
    """Run ``examples/<name>.py``'s main with ``argv`` and the given
    attributes stubbed (``{"module.attr": value}`` as keywords with dots
    written ``__``) until a stub raises _Stop."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for target, value in stubs.items():
        owner, attr = target.rsplit("__", 1)
        monkeypatch.setattr(sys.modules[owner.replace("__", ".")], attr,
                            value)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    with pytest.raises(_Stop):
        mod.main()


def _zeros_image(plan, tables, cfg, **kw):
    return np.zeros((cfg.height, cfg.width, 3), np.float32)


def _assert_tables_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def _assert_cfg_equal(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def _jax_cfg(cfg) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


def _jax_tables(tables) -> JaxTables:
    return JaxTables(**{f: jnp.asarray(np.asarray(getattr(tables, f)))
                        for f in FIELDS})


@pytest.mark.parametrize("name,mod,lr,trainable,ckpt", [
    ("fit_scene", fit_scene, 2e-2,
     ("prim_pos", "prim_aux", "prim_color", "light_pos"), True),
    ("fit_fractal", fit_fractal, 1e-2,
     ("prim_pos", "prim_aux", "prim_color"), False)],
    ids=["fit_scene", "fit_fractal"])
def test_fit_setup_equals_jax_script(name, mod, lr, trainable, ckpt,
                                     monkeypatch, tmp_path):
    """The script's perturbed tables, configuration, steps, rate, trainable
    fields and checkpoint, read from its call of ``optimize.fit``."""
    seen = {}

    def fit(plan, tables0, target, cfg, **kw):
        seen.update(plan=plan, tables0=tables0, cfg=cfg, **kw)
        raise _Stop

    _jax_script(name, ["--out", str(tmp_path)], monkeypatch,
                raymarching_tpu__optimize__fit=fit,
                raymarching_tpu__api__render_tables=_zeros_image)
    plan, tables_true, tables0, cfg = mod.setup()
    _assert_tables_equal(tables0, seen["tables0"])
    _assert_cfg_equal(cfg, seen["cfg"])
    assert plan.prim_type == seen["plan"].prim_type
    assert plan.proc == seen["plan"].proc
    assert (seen["steps"], seen["lr"], seen["trainable"]) == (
        150, lr, trainable) == (150, mod.LR, mod.TRAINABLE)
    assert ("checkpoint_path" in seen) == ckpt
    # setup's cfg argument replaces the script's frame only
    small = cfg.replace(**SMALL)
    assert mod.setup(small)[3] is small
    _assert_tables_equal(mod.setup(small)[2], tables0)
    assert not np.array_equal(tables0.prim_pos, tables_true.prim_pos)


def _multiview_capture(monkeypatch, argv):
    """The JAX script's rays, targets' tables and cfg (its first
    render_rays call) and the optimizer's rate and first parameters."""
    seen = {}

    def render(plan, tables, origins, dirs, cfg, **kw):
        seen.update(plan=plan, tables=tables, origins=np.asarray(origins),
                    dirs=np.asarray(dirs), cfg=cfg)
        return jnp.zeros((dirs.shape[0], 3), jnp.float32)

    class Adam:
        def __init__(self, lr):
            seen["lr"] = lr

        def init(self, params):
            seen["params"] = params
            raise _Stop

    def adam(lr):
        return Adam(lr)

    _jax_script("fit_multiview", argv, monkeypatch,
                raymarching_tpu__api__render_rays=render,
                optax__adam=adam)
    return seen


@pytest.mark.parametrize("views", [4, 3])
def test_multiview_setup_equals_jax_script(views, monkeypatch):
    """The views' rays, the target tables and cfg, and the scene fit's
    perturbed tables and rate."""
    seen = _multiview_capture(monkeypatch, ["--views", str(views)])
    plan, tables_true, tables0, cfg = fit_multiview.setup()
    _assert_cfg_equal(cfg, seen["cfg"])
    _assert_tables_equal(tables_true, seen["tables"])
    _assert_tables_equal(tables0, seen["params"])
    assert seen["lr"] == 0.05
    tt = tables_to_torch(tables_true, "cpu")
    rays = [fit_multiview.camera_rays(tt, cfg, p, fit_multiview.CENTER)
            for p in fit_multiview.view_positions(views)]
    o = torch.cat([r[0] for r in rays]).numpy()
    d = torch.cat([r[1] for r in rays]).numpy()
    assert d.shape == (views * cfg.rays_per_image, 3)
    np.testing.assert_array_equal(o, seen["origins"])
    # the cameras' rotations: XLA's and PyTorch's CPU maths an ulp apart
    np.testing.assert_allclose(d, seen["dirs"], rtol=0, atol=1e-6)


def test_multiview_pose_setup_equals_jax_script(monkeypatch):
    """--fit-poses: the perturbed camera positions the fit starts from."""
    seen = _multiview_capture(monkeypatch, ["--fit-poses"])
    want = np.asarray(seen["params"])
    got = fit_multiview.perturbed_poses(fit_multiview.view_positions(4))
    assert got.dtype == np.float32 and got.shape == (4, 3)
    np.testing.assert_array_equal(got, want)


def test_turntable_poses_equal_jax_script(monkeypatch, tmp_path):
    """The first five of 24 frames' camera positions and directions, and
    the frame's cfg, read from the script's render calls (jit stubbed
    away)."""
    seen = []

    def render(plan, t, cfg, **kw):
        seen.append((np.asarray(t.cam_position), np.asarray(t.cam_direction),
                     cfg))
        if len(seen) == 5:
            raise _Stop
        return np.zeros((cfg.height, cfg.width, 3), np.float32)

    _jax_script("turntable", ["--frames", "24", "--width", "8", "--height",
                              "6", "--out", str(tmp_path)], monkeypatch,
                jax__jit=lambda f: f,
                raymarching_tpu__api__render_tables=render)
    plan, tables, tables0, cfg = turntable.setup(width=8, height=6)
    _assert_cfg_equal(cfg, seen[0][2])
    poses = turntable.poses(tables, 24)
    assert len(poses) == 24
    for (pos, look), (jpos, jlook, _) in zip(poses, seen):
        assert pos.dtype == np.float32
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(look, jlook)
    np.testing.assert_array_equal(tables0.cam_position, poses[0][0])
    np.testing.assert_array_equal(tables0.cam_direction, poses[0][1])


@functools.lru_cache(maxsize=None)
def _fit_grads(name: str):
    """The first fit step's gradients and loss of the port's example
    (``fit`` on the cuda backend's plain twins, the trainable fields'
    .grad in its callback) and jax.value_and_grad of the JAX script's
    loss on the CPU (its ``auto`` backend there, jnp), on the port's
    target frame, at 32x24, 150 iterations."""
    mod = {"fit_scene": fit_scene, "fit_fractal": fit_fractal}[name]
    plan, tables_true, tables0, cfg = mod.setup()
    cfg = cfg.replace(**SMALL)
    jcfg = _jax_cfg(cfg)
    target = rt.render_tables(plan, tables_true, cfg, device="cpu").numpy()

    def loss(t):
        img = japi.render_tables(plan, t, jcfg, backend="jnp",
                                 differentiable=True)
        return jnp.mean((img - target) ** 2)

    jloss, want = jax.value_and_grad(loss)(_jax_tables(tables0))
    got = {}
    res = rt.fit(plan, tables0, target, cfg, device="cpu", steps=1,
                 lr=mod.LR, trainable=mod.TRAINABLE,
                 callback=lambda s, l_, t: got.update(
                     {f: getattr(t, f).grad.numpy().astype(np.float64)
                      for f in mod.TRAINABLE}))
    return (got, {f: np.asarray(getattr(want, f), np.float64)
                  for f in mod.TRAINABLE}, res.losses[0], float(jloss))


def _hold(got, want, field):
    assert np.isfinite(got).all(), field
    scale = max(np.abs(want).max(), 1e-8)
    assert np.abs(want).max() > 0, f"{field}: no gradient"
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=field)


@pytest.mark.parametrize("name,field", [
    ("fit_scene", f) for f in fit_scene.TRAINABLE] + [
    ("fit_fractal", f) for f in fit_fractal.TRAINABLE])
def test_fit_first_step_gradients_match_jax(name, field):
    got, want, *_ = _fit_grads(name)
    _hold(got[field], want[field], field)


@pytest.mark.parametrize("name", ["fit_scene", "fit_fractal"])
def test_fit_first_loss_matches_jax(name):
    """The first step's loss, the port's against JAX's on the same
    target."""
    _, _, loss, jloss = _fit_grads(name)
    assert jloss > 0
    np.testing.assert_allclose(loss, jloss, rtol=1e-3)


def _mv_small():
    plan, tables_true, tables0, cfg = fit_multiview.setup()
    return plan, tables_true, tables0, cfg.replace(**SMALL)


def _jax_bundle(tables, jcfg, poses):
    """The JAX script's bundle(): each view's rays from its position,
    looking at the centre, through the JAX package's camera."""
    R = jcfg.height * jcfg.width * jcfg.samples_per_pixel
    center = jnp.asarray(fit_multiview.CENTER)
    os_, ds = [], []
    for i in range(poses.shape[0]):
        look = center - poses[i]
        look = look / jnp.linalg.norm(look)
        o, d = jcam.generate_rays(
            tables._replace(cam_position=poses[i], cam_direction=look), jcfg)
        os_.append(jnp.broadcast_to(o, (R, 3)))
        ds.append(d.reshape(R, 3))
    return jnp.concatenate(os_), jnp.concatenate(ds)


@functools.lru_cache(maxsize=None)
def _mv_grads():
    """Two views at 32x24: the scene fit's first-step gradients of every
    field and the pose fit's pose gradient, the port's (autograd through
    render_rays and core.camera) and JAX's (jax.grad through its
    render_rays, mega in interpret mode on the CPU, and its camera)."""
    plan, tables_true, tables0, cfg = _mv_small()
    jcfg = _jax_cfg(cfg)
    poses_true = fit_multiview.view_positions(2)
    poses0 = fit_multiview.perturbed_poses(poses_true)
    jtrue = _jax_tables(tables_true)
    o, d = _jax_bundle(jtrue, jcfg, jnp.asarray(poses_true))
    t_true = tables_to_torch(tables_true, "cpu")
    to, td = torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d))
    # the port's targets on both sides
    targets = render_rays(plan, t_true, to, td, cfg, device="cpu").numpy()

    def scene_loss(t):
        return jnp.mean((japi.render_rays(plan, t, o, d, jcfg) - targets)
                        ** 2)

    def pose_loss(p):
        po, pd = _jax_bundle(jtrue, jcfg, p)
        return jnp.mean((japi.render_rays(plan, jtrue, po, pd, jcfg)
                         - targets) ** 2)

    want_t = jax.grad(scene_loss)(_jax_tables(tables0))
    want_p = jax.grad(pose_loss)(jnp.asarray(poses0))

    tgt = torch.as_tensor(targets)
    tt = tables_to_torch(tables0, "cpu", requires_grad=FIELDS)
    loss = torch.mean((render_rays(plan, tt, to, td, cfg, device="cpu")
                       - tgt) ** 2)
    got_t = torch.autograd.grad(loss, list(tt), allow_unused=True,
                                materialize_grads=True)
    poses = torch.as_tensor(poses0).requires_grad_()
    po, pd = fit_multiview.bundle(
        t_true, cfg, torch.as_tensor(fit_multiview.CENTER), poses)
    ploss = torch.mean((render_rays(plan, t_true, po, pd, cfg, device="cpu")
                        - tgt) ** 2)
    got_p, = torch.autograd.grad(ploss, [poses])
    return ({f: (g.numpy().astype(np.float64),
                 np.asarray(getattr(want_t, f), np.float64))
             for f, g in zip(FIELDS, got_t)},
            (got_p.numpy().astype(np.float64),
             np.asarray(want_p, np.float64)),
            np.abs(pd.detach().numpy() - np.asarray(
                _jax_bundle(jtrue, jcfg, jnp.asarray(poses0))[1])).max())


@pytest.mark.parametrize("field", ["prim_pos", "prim_aux", "prim_color",
                                   "light_pos"])
def test_multiview_first_step_gradients_match_jax(field):
    got, want = _mv_grads()[0][field]
    _hold(got, want, field)


def test_multiview_fields_without_gradient():
    """render_rays takes the rays, not the camera, and a white light takes
    the reference shading, which reads no light colour: these fields'
    gradients are zero in both packages, so Adam leaves them as optax
    leaves them."""
    grads = _mv_grads()[0]
    for f in ("light_color", "cam_position", "cam_direction", "cam_up",
              "cam_fov"):
        got, want = grads[f]
        assert not got.any() and not want.any(), f


def test_multiview_pose_gradient_matches_jax():
    """--fit-poses: d loss / d poses through the look-at, the camera grid
    and render_rays' origin and direction cotangents, two views."""
    (got, want), dir_err = _mv_grads()[1:]
    assert dir_err <= 1e-6
    assert got.shape == (2, 3)
    _hold(got, want, "poses")


def test_turntable_frame_matches_jax():
    """Frame 5 of 24 at 16x12 SSAA 2 (fused generators, FD normals, 1,000
    iterations): the port's cuda twin against the JAX script's
    render_tables on the CPU (its auto backend, jnp)."""
    plan, tables, _, cfg = turntable.setup(width=16, height=12)
    pos, look = turntable.poses(tables, 24)[5]
    t = tables._replace(cam_position=pos, cam_direction=look)
    got = rt.render_tables(plan, t, cfg, device="cpu").numpy()
    want = np.asarray(japi.render_tables(plan, _jax_tables(t), _jax_cfg(cfg),
                                         backend="jnp"))
    assert got.shape == (12, 16, 3) and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)


def test_turntable_main_writes_frames(tmp_path, capsys):
    """``main`` on the CPU: a PNG a frame and the timing line."""
    assert turntable.main(["--frames", "2", "--width", "16", "--height",
                           "12", "--device", "cpu", "--out",
                           str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "frame_000.png", "frame_001.png"]
    img = rt.decode_png((tmp_path / "frame_001.png").read_bytes())
    assert img.shape[:2] == (12, 16) and img.max() > 0
    out = capsys.readouterr().out
    assert "2 frames ->" in out and "fps at 16x12 SSAA2" in out


def test_examples_are_in_the_standalone_scans():
    """tests/test_torch_standalone.py's import and source scans reach
    every example module."""
    from test_torch_standalone import PKG, _submodules
    names, files = _submodules(), sorted(PKG.rglob("*.py"))
    for mod in ("__init__", "fit_scene", "fit_multiview", "fit_fractal",
                "turntable"):
        assert PKG / "examples" / f"{mod}.py" in files
        if mod != "__init__":
            assert f"raymarching_tpu_torch.examples.{mod}" in names

