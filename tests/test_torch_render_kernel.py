"""K1 in the port: the plain twin against the JAX mega kernel (Pallas
interpret mode) on the same rays, the colour blend, the exact shadow
skips.  The kernel itself is checked on the card by
tests/test_torch_kernel_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.core import camera as jcam  # noqa: E402
from raymarching_tpu.ops.pallas_render import (_blend_bounces,  # noqa: E402
                                               pallas_render_rays)
from raymarching_tpu.scene.compile import compile_scene, compile_tree  # noqa: E402
from raymarching_tpu.scene.csg import Box, ListNode, Mode, Sphere, bounds  # noqa: E402
from raymarching_tpu.scene.generators import death_star  # noqa: E402
from raymarching_tpu.scene.objects import Camera, Light  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

# tests/test_mega.py's configuration
CFG = RenderConfig(width=24, height=16, ssaa=2, iterations=80,
                   shadows=True, normal_mode="fd")


def _mega_world():
    """tests/test_mega.py's world."""
    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        Sphere((0.0, 0.0, -6.0), 2.5, color=(0.9, 0.4, 0.2)),
        death_star((4.0, 1.0, -8.0), 2.0, color=(0.2, 0.4, 0.9)),
        Box((0.0, -3.0, -6.0), (10.0, 1.0, 10.0), color=(0.6, 0.6, 0.9)),
    ])
    return compile_tree(tree, [Light((6.0, 8.0, 4.0)),
                               Light((-5.0, 6.0, 0.0))],
                        Camera(position=(0, 0, 6), fov=55.0))


def _rays(tables, cfg):
    o, d = jcam.generate_rays(type(tables)(*map(jnp.asarray, tables)), cfg)
    return np.array(o), np.array(d).reshape(-1, 3)


@pytest.fixture(scope="module", params=["mega_world", "config4"])
def case(request, scenes_dir):
    if request.param == "mega_world":
        plan, tables = _mega_world()
    else:
        plan, tables = compile_scene(load_scene(str(scenes_dir /
                                                    "config4.txt")))
    origin, dirs = _rays(tables, CFG)
    jax_out = pallas_render_rays(plan, CFG, jnp.asarray(origin),
                                 jnp.asarray(dirs), tables, interpret=True)
    port = rk.render_rays_plain(plan, CFG, tables_to_torch(tables, "cpu"),
                                torch.as_tensor(origin),
                                torch.as_tensor(dirs))
    return plan, tables, origin, dirs, jax_out, port


def test_plain_twin_matches_jax_mega_kernel(case):
    _, _, _, dirs, jax_out, port = case
    R = dirs.shape[0]
    p, sd, done, cidx, light, smask = (np.asarray(v) for v in jax_out[:6])
    agree = ((port.done.numpy() == done) & (port.cidx.numpy() == cidx)
             & (port.smask.numpy() == smask))
    # XLA and PyTorch round some march steps differently, so hit points
    # differ in their last bits.  Two kinds of ray amplify that: one still
    # marching at the iteration cap stops wherever its trajectory got to,
    # and one whose FD stencil straddles an edge turns a 2e-6 shift of the
    # hit point into ~1e-3 of light.  Such a ray counts as disagreeing.
    dlight = np.abs(port.light.numpy() - light)
    agree &= (dlight <= 5e-4) | ~done
    assert agree.mean() >= 0.995, f"{(~agree).sum()}/{R} rays disagree"
    both = agree & done
    np.testing.assert_allclose(port.p.numpy()[both], p[both], atol=1e-3)
    np.testing.assert_allclose(port.sd.numpy()[both], sd[both], atol=1e-4)
    assert port.cidx.dtype == torch.int32 and port.smask.dtype == torch.int32
    assert done.mean() > 0.5     # non-vacuous: most rays hit something


def test_blend_matches_jax_no_bounce_blend(case):
    plan, tables, _, _, jax_out, _ = case
    cidx, light = jax_out[3], jax_out[4]
    want = np.asarray(_blend_bounces(plan, CFG, tables, cidx, light, ()))
    got = rk.blend(torch.as_tensor(np.array(cidx)),
                   torch.as_tensor(np.array(light)),
                   torch.as_tensor(tables.prim_color)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[np.asarray(cidx) < 0] == 0).all()


@pytest.mark.parametrize("off", ["shade_skip_black", "shadow_sat_skip"])
def test_shadow_skips_leave_colours_unchanged(case, off):
    plan, tables, origin, dirs, _, port = case
    cfg = CFG.replace(**{off: False})
    tt = tables_to_torch(tables, "cpu")
    ref = rk.render_rays_plain(plan, cfg, tt, torch.as_tensor(origin),
                               torch.as_tensor(dirs))
    np.testing.assert_array_equal(
        rk.blend(port.cidx, port.light, tt.prim_color).numpy(),
        rk.blend(ref.cidx, ref.light, tt.prim_color).numpy())


def test_per_ray_origins_match_shared_origin(case):
    plan, tables, origin, dirs, _, port = case
    per_ray = np.broadcast_to(origin, dirs.shape).copy()
    out = rk.render_rays_plain(plan, CFG, tables_to_torch(tables, "cpu"),
                               torch.as_tensor(per_ray),
                               torch.as_tensor(dirs))
    for a, b in zip(out, port):
        assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_twin(case):
    plan, tables, origin, dirs, _, port = case
    before = rk.render_rays.launches
    out = rk.render_rays(plan, CFG, tables_to_torch(tables, "cpu"),
                         torch.as_tensor(origin), torch.as_tensor(dirs))
    assert rk.render_rays.launches == before
    for a, b in zip(out, port):
        assert torch.equal(a, b)
