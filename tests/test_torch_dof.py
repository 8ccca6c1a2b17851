"""Thin-lens depth of field in the port against the JAX package, on the
CPU (the kernels' plain twins), in the world of tests/test_dof.py with a
floor (a red sphere before the camera, 48x36 SSAA 3, 200 iterations,
aperture 0.25, focus 10): the lens samples and the lens rays against JAX's, the frame
of each backend against JAX's ``mega`` (interpret mode), chunked equal to
unchunked, ``api.render_rays`` with shared and per-ray origins, and the
pose and table gradients against JAX's ``mega`` gradients.  Each JAX
result is computed once and shared by the port's cases."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402
from raymarching_tpu.core import camera as jax_cam  # noqa: E402
from raymarching_tpu.scene.compile import SceneTables  # noqa: E402
from raymarching_tpu.scene.compile import compile_scene as jax_compile  # noqa: E402
from raymarching_tpu.scene.parser import parse_scene as jax_parse  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.api import render_rays  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

FIELDS = SceneTables._fields
CFG = RenderConfig(width=48, height=36, ssaa=3, iterations=200,
                   aperture=0.25, focus_dist=10.0, shadows=False)
# the gradients' footprint: shadows on, so light_pos has a cotangent
GCFG = CFG.replace(width=16, height=12, ssaa=2, iterations=120, shadows=True)
# tests/test_dof.py's mega-vs-oracle tolerance; gradients
# tests/test_mega.py:62's
IMG_ATOL = 2e-3
RTOL, ATOL_SCALE = 0.02, 0.005
GRAD_FIELDS = ("prim_pos", "prim_aux", "prim_color", "light_pos",
               "cam_position", "cam_direction", "cam_fov")


def _port(cfg: RenderConfig) -> rt.RenderConfig:
    return rt.RenderConfig(**{f: getattr(cfg, f)
                              for f in cfg.__dataclass_fields__})


@functools.lru_cache(maxsize=None)
def _world(z: float = -13.0):
    """tests/test_dof.py's scene with the sphere at depth z."""
    return jax_compile(jax_parse(f"""
Bounds 80
Light 4 10 4
Color 0.9 0.2 0.1
Sphere 0 0 {z} 1.0
Color 0.7 0.7 0.8
Box 0 -1.5 -10 12 0.5 30
Camera Position 0 0 6
"""))


@functools.lru_cache(maxsize=None)
def _jax_mega(reflect: float = 0.0):
    plan, tables = _world()
    return np.asarray(jax_render_tables(
        plan, tables, CFG.replace(reflect_strength=reflect), backend="mega",
        interpret=True))


def _img(cfg, backend="cuda"):
    plan, tables = _world()
    return rt.render_tables(plan, tables, _port(cfg), backend=backend,
                            device="cpu").numpy()


def test_lens_samples_and_rays_match_jax():
    """lens_offsets (the sunflower disk) and generate_rays_dof (origins on
    the lens, directions re-aimed at the pinhole rays' focal points)
    against JAX's to 1e-6; the origins lie on the lens disk and the
    directions are unit."""
    _, tables = _world()
    np.testing.assert_allclose(
        cam.lens_offsets(_port(CFG), "cpu").numpy(),
        np.asarray(jax_cam.lens_offsets(CFG)), atol=1e-6)
    o, d = cam.generate_rays_dof(tables_to_torch(tables, "cpu"), _port(CFG))
    jo, jd = jax_cam.generate_rays_dof(tables, CFG)
    assert o.shape == d.shape == (36, 48, 9, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    r = np.linalg.norm(o.numpy() - np.asarray(tables.cam_position), axis=-1)
    assert 0.0 < r.min() and r.max() <= CFG.aperture + 1e-6
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=-1), 1.0,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["cuda", "multi", "ref"])
def test_dof_frame_matches_jax_mega(backend):
    """The DOF frame of each backend (``cuda``: K1's twin with per-ray
    origins through render_rays; ``multi`` and ``ref``: the hooks with
    per-ray origins) against JAX's mega frame, and it is blurred: it moves
    off the pinhole frame."""
    img = _img(CFG, backend)
    np.testing.assert_allclose(img, _jax_mega(), atol=IMG_ATOL)
    assert np.abs(img - _img(CFG.replace(aperture=0.0), backend)).max() > 0.05


def test_dof_with_bounces_matches_jax_mega():
    """Depth of field with a mirror bounce: one bundle through K1's bounce
    twin with per-ray origins, against JAX's mega."""
    np.testing.assert_allclose(_img(CFG.replace(reflect_strength=0.4)),
                               _jax_mega(0.4), atol=IMG_ATOL)


@pytest.mark.parametrize("backend", ["cuda", "multi"])
def test_chunked_equals_unchunked(backend):
    """``ray_chunk`` renders the bundle a chunk at a time: the same bits."""
    cfg = CFG.replace(width=16, height=12, iterations=100)
    assert np.array_equal(_img(cfg.replace(ray_chunk=500), backend),
                          _img(cfg, backend))


def test_render_rays_shared_and_per_ray_origins():
    """api.render_rays (tests/test_render_rays.py:39-58): the camera's rays
    give the pinhole frame bit for bit, with the origin shared or given
    per ray; a bundle of two cameras' rays gives each camera's frame."""
    plan, tables = _world()
    cfg = _port(CFG.replace(width=16, height=12, ssaa=1, aperture=0.0,
                            iterations=100))
    tt = tables_to_torch(tables, "cpu")
    o, d = cam.generate_rays(tt, cfg)
    d = d.reshape(-1, 3)
    shared = render_rays(plan, tables, o, d, cfg, device="cpu")
    img = rt.render_tables(plan, tables, cfg, device="cpu")
    assert torch.equal(shared.reshape(img.shape), img)
    per_ray = render_rays(plan, tables, o.expand(d.shape).numpy(),
                          d.numpy(), cfg, device="cpu")
    assert torch.equal(per_ray, shared)
    o2 = o + torch.tensor([0.5, 0.2, 1.0])
    t2 = tt._replace(cam_position=o2)
    _, d2 = cam.generate_rays(t2, cfg)
    both = render_rays(plan, tables, torch.cat([o.expand(d.shape),
                                                o2.expand(d.shape)]),
                       torch.cat([d, d2.reshape(-1, 3)]), cfg, device="cpu")
    assert torch.equal(both[:d.shape[0]], shared)
    assert torch.equal(both[d.shape[0]:].reshape(img.shape),
                       rt.render_tables(plan, t2, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _grads(normal: str):
    """JAX's mega gradients of mean(img^2) of the DOF frame (interpret
    mode) and the port's through FusedRender and the lens camera."""
    plan, tables = _world()
    cfg = GCFG.replace(normal_mode=normal)
    want = jax.grad(lambda t: jnp.mean(jax_render_tables(
        plan, t, cfg, backend="mega", interpret=True) ** 2))(tables)
    tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
    img = rt.render_tables(plan, tt, _port(cfg), differentiable=True,
                           device="cpu")
    got = torch.autograd.grad(torch.mean(img * img), list(tt),
                              allow_unused=True, materialize_grads=True)
    return ({f: v.numpy().astype(np.float64) for f, v in zip(FIELDS, got)},
            {f: np.asarray(getattr(want, f), np.float64) for f in FIELDS})


@pytest.mark.parametrize("field", GRAD_FIELDS)
@pytest.mark.parametrize("normal", ["fd", "analytic"])
def test_dof_gradients_match_jax_mega(normal, field):
    """Gradients through per-ray origins: FusedRender's origin cotangent
    per ray, then autograd through generate_rays_dof's lens basis and
    focal reprojection to the pose; against JAX's mega gradients at
    tests/test_mega.py:62's tolerance."""
    got, want = (g[field] for g in _grads(normal))
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-8)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=field)
