"""Mirror bounces in the port against the JAX package, on the CPU (the
kernels' plain twins), in the world of tests/test_reflections.py (two
spheres over a white floor, one light, 48x32, 200 iterations, reflect
0.4): the port's ``cuda``, ``multi`` and ``ref`` images against JAX's
``mega`` (interpret mode), ``pallas`` and ``ref``; K1's bounce twin's
per-bounce outputs against ``pallas_render_rays``' ninth element; the
gradients of the reflect backward (the anchored replay of the bounce
chain) against JAX's ``_reflect_bwd`` and against JAX's differentiable
``ref``; scenes/mirror.txt with coloured lights, soft shadows and AO; and
reflect_strength 0 the reflection-free render bit for bit.

The JAX side is the expensive half (interpret-mode renders and gradients
take seconds each): every JAX result is computed once, cached, and
shared by the port's cases."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402
from raymarching_tpu.core import camera as jax_cam  # noqa: E402
from raymarching_tpu.ops.pallas_render import (_blend_bounces,  # noqa: E402
                                               pallas_render_rays)
from raymarching_tpu.scene.compile import SceneTables  # noqa: E402
from raymarching_tpu.scene.compile import compile_scene as jax_compile  # noqa: E402
from raymarching_tpu.scene.parser import load_scene as jax_load  # noqa: E402
from raymarching_tpu.scene.parser import parse_scene as jax_parse  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.ops.render_kernel import render_rays  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

FIELDS = SceneTables._fields
MIRROR = Path(__file__).resolve().parent.parent / "scenes" / "mirror.txt"
SCENE = """
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
CFG = RenderConfig(width=48, height=32, ssaa=1, iterations=200,
                   reflect_strength=0.4)
# tests/test_reflections.py's gradient footprint
GCFG = CFG.replace(width=16, height=12, iterations=150)
# scenes/mirror.txt with every extension on (tests/test_reflections.py's
# full-stack case), its generators fused: the gradients land on the
# generators' base rows (the exact sponge's crosses tie, where the port's
# fold gives a tied cotangent to the first leaf and JAX's splits it)
MCFG = RenderConfig(width=16, height=12, ssaa=1, iterations=120,
                    reflect_strength=0.4, soft_shadow_k=8.0, ao_strength=0.5,
                    fused_generators=True)
# images: tests/test_reflections.py:79's 2e-3, and this share of the
# pixels within 5e-4; gradients against JAX's replay: tests/test_mega.py:62;
# against JAX's unrolled ref: tests/test_reflections.py:166-168
IMG_ATOL, SHARE_ATOL, SHARE = 2e-3, 5e-4, 0.995
RTOL, ATOL_SCALE = 0.02, 0.005
REF_TOL, REF_COS = 0.08, 0.995
# bounce hit points, relative to max(1, |p|): all within P_REL, a share
# P_SHARE within 1e-4
P_REL, P_SHARE = 2e-3, 0.97
JAX_BACKEND = {"cuda": "mega", "multi": "pallas", "ref": "ref"}


def _port(cfg: RenderConfig) -> rt.RenderConfig:
    return rt.RenderConfig(**{f: getattr(cfg, f)
                              for f in cfg.__dataclass_fields__})


@functools.lru_cache(maxsize=None)
def _world(mirror: bool = False):
    if mirror:
        return jax_compile(jax_load(str(MIRROR)))
    return jax_compile(jax_parse(SCENE))


@functools.lru_cache(maxsize=None)
def _jax_rays(B: int):
    """JAX's mega frame of CFG with B bounces from pallas_render_rays
    (interpret mode): (image [H, W, 3], the kernel's outputs)."""
    plan, tables = _world()
    cfg = CFG.replace(reflect_bounces=B)
    o, d = jax_cam.generate_rays(tables, cfg)
    outs = pallas_render_rays(plan, cfg, o, d.reshape(-1, 3), tables,
                              interpret=True)
    img = _blend_bounces(plan, cfg, tables, outs[3], outs[4], outs[8])
    return np.asarray(img).reshape(cfg.height, cfg.width, 3), outs


@functools.lru_cache(maxsize=None)
def _jax_image(backend: str, B: int):
    if backend == "mega":
        return _jax_rays(B)[0]
    plan, tables = _world()
    return np.asarray(jax_render_tables(
        plan, tables, CFG.replace(reflect_bounces=B), backend=backend,
        interpret=True))


def _grads_np(g) -> dict:
    return {f: np.asarray(getattr(g, f), np.float64) for f in FIELDS}


@functools.lru_cache(maxsize=None)
def _jax_grads(backend: str, normal: str, B: int, mirror: bool = False):
    """(image, gradients of its mean) by jax.vjp: ``mega`` (the anchored
    replay, _reflect_bwd) or the unrolled differentiable ``ref``."""
    plan, tables = _world(mirror)
    cfg = (MCFG if mirror else GCFG).replace(reflect_bounces=B,
                                             normal_mode=normal)
    img, vjp = jax.vjp(lambda t: jax_render_tables(
        plan, t, cfg, backend=backend, interpret=True,
        differentiable=backend == "ref"), tables)
    (g,) = vjp(jnp.full(img.shape, 1.0 / img.size, img.dtype))
    return np.asarray(img), _grads_np(g)


@functools.lru_cache(maxsize=None)
def _port_grads(backend: str, normal: str, B: int, mirror: bool = False):
    """The port's gradients of the mean image: ``cuda`` (FusedRender's
    reflect backward) or ``multi`` (MarchOp and NormalOp through the
    recursion)."""
    plan, tables = _world(mirror)
    cfg = (MCFG if mirror else GCFG).replace(reflect_bounces=B,
                                             normal_mode=normal)
    tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
    img = rt.render_tables(plan, tt, _port(cfg), backend=backend,
                           differentiable=True, device="cpu")
    got = torch.autograd.grad(img.mean(), list(tt), allow_unused=True,
                              materialize_grads=True)
    return {f: v.numpy().astype(np.float64) for f, v in zip(FIELDS, got)}


def _img(cfg, backend="cuda", mirror=False):
    plan, tables = _world(mirror)
    return rt.render_tables(plan, tables, _port(cfg), backend=backend,
                            device="cpu").numpy()


def _close(img, want):
    np.testing.assert_allclose(img, want, atol=IMG_ATOL)
    share = (np.abs(img - want).max(axis=-1) <= SHARE_ATOL).mean()
    assert share >= SHARE, share


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("backend", ["cuda", "multi", "ref"])
def test_images_match_jax(backend, B):
    """K1's bounce twin against JAX's in-kernel bounce loop (mega,
    interpret mode), the multi backend's hook recursion (K3 with per-ray
    origins, K2) against JAX's pallas backend, the oracle against JAX's
    ref; the bounces show (the image moves off the reflection-free one)."""
    img = _img(CFG.replace(reflect_bounces=B), backend)
    _close(img, _jax_image(JAX_BACKEND[backend], B))
    base = _img(CFG.replace(reflect_strength=0.0), backend)
    assert np.abs(img - base).max() > 0.05


@pytest.mark.parametrize("backend", ["cuda", "multi", "ref"])
def test_zero_strength_is_the_reflection_free_render(backend):
    """reflect_strength 0 is the reflection-free render bit for bit,
    whatever the bounce count (and the fused path takes no bounce
    entry)."""
    base = CFG.replace(reflect_strength=0.0)
    want = _img(base.replace(reflect_bounces=1), backend)
    assert np.array_equal(_img(base.replace(reflect_bounces=3), backend),
                          want)
    plan, tables = _world()
    tt = tables_to_torch(tables, "cpu")
    o, d = cam.generate_rays(tt, _port(base))
    out = render_rays(plan, _port(base.replace(reflect_bounces=3)), tt, o,
                      d.reshape(-1, 3))
    assert isinstance(out, tuple) and len(out) == 6


@pytest.mark.parametrize("B", [1, 2])
def test_bounce_outputs_match_pallas_render_rays(B):
    """K1's bounce twin's outputs, bounce by bounce (colour winner, light,
    shadow bits, hit point, SD, convergence), against the ninth element of
    JAX's pallas_render_rays, compared off the tie sets: the rays whose
    earlier levels agree in every discrete output."""
    plan, tables = _world()
    cfg = CFG.replace(reflect_bounces=B)
    outs = _jax_rays(B)[1]
    tt = tables_to_torch(tables, "cpu")
    o, d = cam.generate_rays(tt, _port(cfg))
    d = d.reshape(-1, 3)
    ray, bounces = render_rays(plan, _port(cfg), tt, o, d)
    assert len(bounces) == B
    want = [(outs[3], outs[4], outs[5], outs[0], outs[1], outs[2])] + [
        (b[0], b[1], b[2], b[5], b[6], b[7]) for b in outs[8]]
    got = [(ray.cidx, ray.light, ray.smask, ray.p, ray.sd, ray.done)] + [
        (b.cidx, b.light, b.smask, b.p, b.sd, b.done) for b in bounces]
    agree = np.ones(d.shape[0], bool)
    for level, (g, w) in enumerate(zip(got, want)):
        g = [v.numpy() for v in g]
        w = [np.asarray(v) for v in w]
        disc = (g[0] == w[0]) & (g[2] == w[2]) & (g[5] == w[5])
        assert disc[agree].mean() >= 0.99, (level, disc[agree].mean())
        on = agree & disc
        np.testing.assert_allclose(g[1][on], w[1][on], atol=IMG_ATOL)
        hit = on & g[5]
        # a bounce's hit moves by the angle between the two normals times
        # the distance travelled, which grazing rays stretch: held
        # relative to the point's size, and tightly on a share of the hits
        rel = (np.abs(g[3] - w[3]).max(axis=-1)
               / np.maximum(1.0, np.abs(w[3]).max(axis=-1)))[hit]
        assert rel.max() <= P_REL and (rel <= 1e-4).mean() >= P_SHARE, (
            level, rel.max(), (rel <= 1e-4).mean())
        np.testing.assert_allclose(g[4][hit], w[4][hit], atol=1e-4)
        agree = on


@pytest.mark.parametrize("field", ["prim_pos", "prim_color", "light_pos"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("normal", ["fd", "analytic"])
def test_reflect_gradients_match_jax_mega(normal, B, field):
    """FusedRender's reflect backward (AnchoredHit at every saved hit, the
    FD or analytic normal differentiated a second time through the
    reflected direction, the saved shadow decisions) against JAX's
    _reflect_bwd at tests/test_mega.py:62's tolerance."""
    got = _port_grads("cuda", normal, B)[field]
    want = _jax_grads("mega", normal, B)[1][field]
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=field)


@pytest.mark.parametrize("field", ["prim_pos", "prim_color", "light_pos"])
@pytest.mark.parametrize("B", [1, 2])
def test_reflect_gradients_match_jax_ref(B, field):
    """The reflect backward against unrolled autodiff through JAX's ref
    oracle (tests/test_reflections.py:166-168: magnitude 0.08 of the
    scale, direction cosine 0.995), and the multi backend's gradients (the
    implicit-function route through the recursion) against it too."""
    want = _jax_grads("ref", "fd", B)[1][field].ravel()
    scale = np.abs(want).max() + 1e-12
    for backend in ("cuda", "multi"):
        got = _port_grads(backend, "fd", B)[field].ravel()
        assert np.abs(got - want).max() / scale < REF_TOL, backend
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want)
                            + 1e-30)
        assert cos > REF_COS, (backend, cos)


def test_mirror_image_matches_jax_mega():
    """scenes/mirror.txt (coloured lights, a Menger sponge, a DeathStar,
    named materials) with soft shadows, AO and one bounce: K1's bounce
    twin against JAX's mega kernel (its differentiable forward, the same
    image), and the oracle against JAX's ref."""
    plan, tables = _world(True)
    _close(_img(MCFG, mirror=True), _jax_grads("mega", "fd", 1, True)[0])
    _close(_img(MCFG, "ref", mirror=True), np.asarray(jax_render_tables(
        plan, tables, MCFG, backend="ref")))


@pytest.mark.parametrize("field", ["prim_pos", "prim_color", "light_pos",
                                   "light_color"])
def test_mirror_gradients_match_jax_mega(field):
    """The reflect backward on scenes/mirror.txt with every extension on:
    the replay reapplies each bounce's penumbra and AO factors and weights
    by the light colours, so ``light_color`` trains through every
    bounce.  With fused generators the sponge's and the DeathStar's
    cotangents land on their base rows."""
    got = _port_grads("cuda", "fd", 1, True)[field]
    want = _jax_grads("mega", "fd", 1, True)[1][field]
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=field)
