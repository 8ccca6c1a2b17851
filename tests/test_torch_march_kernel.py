"""K3 in the port: the plain twin ``march_rays_plain`` (what a CPU tensor
gets from ``march_rays``) against the JAX march kernel ``pallas_march``
(Pallas interpret mode) on the same rays: primary rays, shadow rays with a
per-ray tmax, and the step counter.  The kernel itself is checked on the
card by tests/test_torch_kernel_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.core import camera as jcam  # noqa: E402
from raymarching_tpu.ops.pallas_march import pallas_march  # noqa: E402
from raymarching_tpu.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
from raymarching_tpu.utils.timing import march_iteration_stats  # noqa: E402
from raymarching_tpu_torch.core import march as tmarch  # noqa: E402
from raymarching_tpu_torch.core.sdf import LeafCount, scene_sd  # noqa: E402
from raymarching_tpu_torch.ops import march_kernel as mk  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402
from raymarching_tpu_torch.utils import timing as ttiming  # noqa: E402
from test_torch_render_kernel import _mega_world  # noqa: E402

CFG = RenderConfig(width=32, height=24, ssaa=1, iterations=120)
# XLA and PyTorch round some march steps differently: hit points agree to
# a few ulps except on rays still marching at the cap, which stop wherever
# their trajectory got to; discrete outputs agree on this share of rays
P_RTOL, P_ATOL, AGREE = 5e-6, 2e-5, 0.995


def _jax_rays(tables, cfg):
    o, d = jcam.generate_rays(type(tables)(*map(jnp.asarray, tables)), cfg)
    d = np.array(d).reshape(-1, 3)
    return np.broadcast_to(np.array(o), d.shape).copy(), d


@pytest.fixture(scope="module", params=["mega_world", "demo"])
def case(request, scenes_dir):
    if request.param == "mega_world":
        plan, tables = _mega_world()
    else:
        plan, tables = compile_scene(load_scene(str(scenes_dir / "demo.txt")))
    origin, dirs = _jax_rays(tables, CFG)
    tt = tables_to_torch(tables, "cpu")
    return plan, tables, tt, origin, dirs


def _jax_march(plan, tables, origin, dirs, **kw):
    return pallas_march(plan.kernel, CFG.iterations, CFG.surface_precision,
                        CFG.tile_sublanes, jnp.asarray(origin),
                        jnp.asarray(dirs), tables, interpret=True, **kw)


def _hold(port, jax_res):
    conv_j = np.asarray(jax_res.converged)
    conv_t = port.converged.numpy()
    assert conv_t.dtype == bool and (conv_t == conv_j).mean() >= AGREE
    both = conv_t & conv_j
    assert both.mean() > 0.5            # most rays hit something
    np.testing.assert_allclose(port.position.numpy()[both],
                               np.asarray(jax_res.position)[both],
                               rtol=P_RTOL, atol=P_ATOL)
    np.testing.assert_allclose(port.sd.numpy()[both],
                               np.asarray(jax_res.sd)[both], atol=1e-4)
    return both


def test_primary_march_with_steps_matches_jax_kernel(case):
    plan, tables, tt, origin, dirs = case
    jres, jsteps = _jax_march(plan, tables, origin, dirs, with_steps=True)
    res, steps = mk.march_rays(plan, CFG, tt, torch.as_tensor(origin),
                               torch.as_tensor(dirs), with_steps=True)
    _hold(res, jres)
    assert steps.dtype == torch.int32 and int(steps.max()) <= CFG.iterations
    assert (steps.numpy() == np.asarray(jsteps)).mean() >= AGREE
    # the same summary as the JAX package's, from the port's own copy
    want = march_iteration_stats(np.asarray(jres.converged),
                                 np.asarray(jsteps))
    got = ttiming.march_iteration_stats(res.converged.numpy(), steps.numpy())
    assert got["rays"] == want["rays"] == dirs.shape[0]
    assert abs(got["steps"]["mean"] - want["steps"]["mean"]) < 0.05
    assert got["steps"]["p50"] == want["steps"]["p50"]


def test_shadow_march_with_tmax_matches_jax_kernel(case):
    """Rays from the primary hits toward the first light, stopped at it:
    the distance is the projection (p - o) . d."""
    plan, tables, tt, origin, dirs = case
    hit = mk.march_rays(plan, CFG, tt, torch.as_tensor(origin),
                        torch.as_tensor(dirs))
    lp = tt.light_pos[0]
    # start a little off the surface, back along the primary ray
    start = hit.position - 4e-3 * torch.as_tensor(dirs)
    r = lp - start
    tmax = torch.sqrt(tmarch.dot3(r, r))
    ray = r / tmax[:, None]
    jres = _jax_march(plan, tables, start.numpy(), ray.numpy(),
                      tmax=jnp.asarray(tmax.numpy()))
    res = mk.march_rays(plan, CFG, tt, start, ray, tmax=tmax)
    # lit rays stop at the light unconverged: compare every ray's endpoint
    # by its side of the light, and the converged ones' hit points
    lit_t = tmarch.dot3(lp - res.position, ray).numpy() <= 0
    lit_j = np.sum((lp.numpy() - np.asarray(jres.position)) * ray.numpy(),
                   axis=-1) <= 0
    assert (lit_t == lit_j).mean() >= AGREE
    assert 0.05 < lit_t.mean() < 0.95       # both outcomes occur
    conv_t, conv_j = res.converged.numpy(), np.asarray(jres.converged)
    assert (conv_t == conv_j).mean() >= AGREE
    both = conv_t & conv_j
    np.testing.assert_allclose(res.position.numpy()[both],
                               np.asarray(jres.position)[both],
                               rtol=P_RTOL, atol=P_ATOL)
    # a lit ray went no further than one step past the light
    t_end = tmarch.dot3(res.position - start, ray).numpy()
    assert (t_end[lit_t] >= tmax.numpy()[lit_t]).all()


def test_iterations_argument_caps_the_march(case):
    plan, _, tt, origin, dirs = case
    o, d = torch.as_tensor(origin), torch.as_tensor(dirs)
    res, steps = mk.march_rays(plan, CFG, tt, o, d, iterations=7,
                               with_steps=True)
    assert int(steps.max()) == 7
    full, fsteps = mk.march_rays(plan, CFG, tt, o, d, with_steps=True)
    early = fsteps <= 7
    assert early.any() and not early.all()
    for a, b in zip(res, full):
        assert torch.equal(a[early], b[early])
    assert not res.converged[~early].any()
    # a shared [3] origin is the per-ray origin broadcast
    for a, b in zip(mk.march_rays(plan, CFG, tt, o[0], d), full):
        assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_twin(case):
    plan, _, tt, origin, dirs = case
    o, d = torch.as_tensor(origin), torch.as_tensor(dirs)
    before = mk.march_rays.launches
    out = mk.march_rays(plan, CFG, tt, o, d, with_steps=True)
    plain = mk.march_rays_plain(plan, CFG, tt, o, d, with_steps=True)
    assert mk.march_rays.launches == before
    for a, b in zip((*out[0], out[1]), (*plain[0], plain[1])):
        assert torch.equal(a, b)


def test_step_counter_counts_scene_evaluations(case):
    plan, _, tt, origin, dirs = case
    o, d = torch.as_tensor(origin), torch.as_tensor(dirs)
    with LeafCount() as count:
        _, steps = mk.march_rays_plain(plan, CFG, tt, o, d, with_steps=True)
    assert count.points == int(steps.sum())
    assert 0 < count.leaves <= count.points * plan.num_primitives


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_profile_march(case, backend):
    plan, tables, tt, origin, dirs = case
    prof = ttiming.profile_march(plan, tables, CFG, backend, device="cpu")
    assert prof["rays"] == CFG.rays_per_image
    st = prof["steps"]
    assert 1 <= st["p50"] <= st["p90"] <= st["p99"] <= st["max"] \
        <= CFG.iterations
    # the kernel-form fold and the generic fold give one field: the same
    # counts from either backend
    _, steps = tmarch.march(lambda p: scene_sd(plan, tt, p),
                            torch.as_tensor(origin), torch.as_tensor(dirs),
                            CFG.iterations, CFG.surface_precision,
                            with_steps=True)
    assert abs(st["mean"] - steps.double().mean().item()) < 0.05
    with pytest.raises(ValueError, match="backend"):
        ttiming.profile_march(plan, tables, CFG, "pallas", device="cpu")
