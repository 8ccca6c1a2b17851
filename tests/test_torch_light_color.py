"""Coloured lights (the ``LightColor`` scene line) in the port against the
JAX package, on the CPU (the kernels' plain twins), in the scene of
tests/test_light_color.py (a red and a blue light, 32x24, 80
iterations): the ``ref`` oracle against JAX's ``ref``, the ``cuda`` and
``multi`` backends against JAX's ``mega`` kernel in interpret mode, the
two-phase path equal to one kernel, white lights with the coloured
machinery forced giving the scalar image bit for bit, and the gradients
of every field, ``light_color`` included, through the FD, analytic and
fused analytic backwards against JAX's ``mega`` gradients.  One JAX image
and gradient of each kind, computed once in a module fixture."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.api import render_tables as jax_render_tables  # noqa: E402
from raymarching_tpu.scene.compile import SceneTables  # noqa: E402
from raymarching_tpu.scene.compile import compile_scene as jax_compile  # noqa: E402
from raymarching_tpu.scene.parser import parse_scene as jax_parse  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.ops import shade_kernel as shk  # noqa: E402
from raymarching_tpu_torch.ops.render_kernel import render_rays  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.scene.parser import parse_scene  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

FIELDS = SceneTables._fields
CFG = RenderConfig(width=32, height=24, ssaa=1, iterations=80,
                   shadows=True, normal_mode="fd")
# tests/test_light_color.py's tolerances: ref against ref 5e-4; mega
# against ref on a share of the pixels (an ulp in a normal may flip a
# shadow); gradients tests/test_mega.py:62's
REF_ATOL, AGREE_ATOL, AGREE_SHARE, MEDIAN = 5e-4, 5e-3, 0.99, 1e-4
RTOL, ATOL_SCALE = 0.02, 0.005

SCENE = """
Bounds 60.0
Camera Position 0 0 8
LightColor 1 0.2 0.2
Light 6 8 5
LightColor 0.2 0.2 1
Light -6 8 5
Color 0.9 0.9 0.9
Sphere 0 0 -4 2
Box 0 -3 -4 12 1 12
"""


def _port(cfg: RenderConfig) -> rt.RenderConfig:
    return rt.RenderConfig(**{f: getattr(cfg, f)
                              for f in cfg.__dataclass_fields__})


@pytest.fixture(scope="module")
def world():
    plan, tables = rt.compile_scene(parse_scene(SCENE))
    assert plan.colored_lights
    return plan, tables


@pytest.fixture(scope="module")
def jax_images():
    plan, tables = jax_compile(jax_parse(SCENE))
    return (np.asarray(jax_render_tables(plan, tables, CFG, backend="ref")),
            np.asarray(jax_render_tables(plan, tables, CFG, backend="mega",
                                         interpret=True)))


def _img(plan, tables, cfg, backend="cuda"):
    return rt.render_tables(plan, tables, _port(cfg), backend=backend,
                            device="cpu").numpy()


def test_ref_matches_jax_ref_and_is_coloured(world, jax_images):
    plan, tables = world
    img = _img(plan, tables, CFG, "ref")
    np.testing.assert_allclose(img, jax_images[0], atol=REF_ATOL)
    lit = img[img.max(axis=-1) > 0.2]
    # red light from +x, blue from -x: the channels differ somewhere
    assert np.abs(lit[:, 0] - lit[:, 2]).max() > 0.1


@pytest.mark.parametrize("path", ["cuda", "two-phase", "multi"])
def test_backends_match_jax_mega(world, jax_images, path):
    """K1's twin with three sums and the saturation-floor skip off, K3 + K4
    (equal to one kernel bit for bit) and the multi-kernel backend against
    JAX's mega kernel in interpret mode by tests/test_light_color.py's
    agreement rule, and against JAX's ref the same way."""
    plan, tables = world
    c = CFG.replace(two_phase_k1=16) if path == "two-phase" else CFG
    img = _img(plan, tables, c, "multi" if path == "multi" else "cuda")
    for want in jax_images[::-1]:
        diff = np.abs(img - want).max(axis=-1)
        assert (diff < AGREE_ATOL).mean() > AGREE_SHARE
        assert np.median(diff) < MEDIAN
    if path == "two-phase":
        assert np.array_equal(img, _img(plan, tables, CFG))


@pytest.mark.parametrize("change", [dict(), dict(soft_shadow_k=6.0),
                                    dict(ao_strength=0.8)])
def test_white_lights_forced_coloured_give_the_scalar_image(change):
    """White lights through the coloured machinery give the scalar path's
    image bit for bit, on the oracle and on K1's twin (whose extended
    entry then sums three equal channels with the saturation skip off:
    the skip is exact, so the bits agree), whose [R, 3] lights are
    equal to the scalar ones per channel."""
    scene = parse_scene(SCENE.replace("LightColor 1 0.2 0.2", "")
                           .replace("LightColor 0.2 0.2 1", ""))
    plan, tables = rt.compile_scene(scene)
    assert not plan.colored_lights
    forced = dataclasses.replace(plan, colored_lights=True)
    cfg = CFG.replace(**change)
    for backend in ("ref", "cuda"):
        assert np.array_equal(_img(plan, tables, cfg, backend),
                              _img(forced, tables, cfg, backend)), backend
    pc = _port(cfg)
    tt = tables_to_torch(tables, "cpu")
    origin, dirs = cam.generate_rays(tt, pc)
    dirs = dirs.reshape(-1, 3)
    a = render_rays(plan, pc, tt, origin, dirs)
    b = render_rays(forced, pc, tt, origin, dirs)
    assert b.light.shape == (dirs.shape[0], 3)
    for c in range(3):
        assert torch.equal(a.light, b.light[:, c])


def test_saturation_skip_is_off_with_coloured_lights(world):
    """With coloured lights the saturation floor bounds no channel, so the
    kernels take no such skip (JAX's ``not colored``): the shadow bits are
    those of a render with the skip turned off."""
    plan, tables = world
    pc = _port(CFG)
    tt = tables_to_torch(tables, "cpu")
    origin, dirs = cam.generate_rays(tt, pc)
    dirs = dirs.reshape(-1, 3)
    on = render_rays(plan, pc, tt, origin, dirs)
    off = render_rays(plan, pc.replace(shadow_sat_skip=False), tt, origin,
                      dirs)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    assert shk.shade_operands(plan, pc, tt, "cpu")[2][3] == 0


GRAD_CASES = {"fd": dict(normal_mode="fd"),
              "analytic": dict(normal_mode="analytic"),
              "fused-analytic-soft-ao": dict(
                  normal_mode="analytic", fused_generators=True,
                  soft_shadow_k=6.0, ao_strength=0.8)}


@pytest.fixture(scope="module", params=sorted(GRAD_CASES))
def grads(request):
    """JAX's mega gradients (interpret mode) of mean(img^2) and the port's
    through FusedRender, on the coloured scene."""
    cfg = CFG.replace(**GRAD_CASES[request.param])
    plan, tables = jax_compile(jax_parse(SCENE))
    want = jax.grad(lambda t: jnp.mean(jax_render_tables(
        plan, t, cfg, backend="mega", interpret=True,
        differentiable=True) ** 2))(tables)
    tt = tables_to_torch(tables, "cpu", requires_grad=FIELDS)
    img = rt.render_tables(plan, tt, _port(cfg), differentiable=True,
                           device="cpu")
    got = torch.autograd.grad(torch.mean(img * img), list(tt),
                              allow_unused=True, materialize_grads=True)
    return ({f: v.numpy().astype(np.float64) for f, v in zip(FIELDS, got)},
            {f: np.asarray(getattr(want, f), np.float64) for f in FIELDS})


@pytest.mark.parametrize("field", ["light_color", "light_pos", "prim_pos",
                                   "prim_aux", "prim_color", "cam_position",
                                   "cam_direction"])
def test_gradients_match_jax_mega(grads, field):
    """Every field's gradient, the lights' colours included (the Lambert
    replay weights each term by its light's colour row), against JAX's
    mega backward at tests/test_mega.py:62's tolerance."""
    got, want = grads
    a, b = got[field], want[field]
    assert np.isfinite(a).all()
    if field == "light_color":
        assert np.abs(b).max() > 1e-6
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL_SCALE * scale,
                               err_msg=field)


def test_multi_light_color_gradient_matches_cuda(world):
    """The multi-kernel backend's light_color gradient (autograd through
    core.shading.lighting on K3's shadow bits) against the fused
    backend's replay."""
    plan, tables = world
    got = {}
    for backend in ("cuda", "multi"):
        tt = tables_to_torch(tables, "cpu", requires_grad=("light_color",))
        img = rt.render_tables(plan, tt, _port(CFG), backend=backend,
                               differentiable=True, device="cpu")
        got[backend] = torch.autograd.grad(torch.mean(img * img),
                                           tt.light_color)[0]
    b = got["cuda"]
    scale = b.abs().max().item()
    assert scale > 1e-6
    assert ((got["multi"] - b).abs() <= RTOL * b.abs()
            + ATOL_SCALE * scale).all()
