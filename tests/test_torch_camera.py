"""Port camera: primary rays equal the JAX camera's within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu import RenderConfig  # noqa: E402
from raymarching_tpu.core import camera as jcam  # noqa: E402
from raymarching_tpu.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu.scene.parser import load_scene  # noqa: E402
from raymarching_tpu_torch.core import camera as tcam  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402


def _random_camera(tables, seed):
    rng = np.random.default_rng(seed)
    direction = rng.normal(size=3).astype(np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32) + 0.2 * rng.normal(size=3)
    return tables._replace(
        cam_position=rng.uniform(-50, 50, 3).astype(np.float32),
        cam_direction=direction, cam_up=up.astype(np.float32),
        cam_fov=np.float32(rng.uniform(30.0, 100.0)))


@pytest.fixture(scope="module")
def demo_tables(scenes_dir):
    return compile_scene(load_scene(str(scenes_dir / "demo.txt")))[1]


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
@pytest.mark.parametrize("ssaa,width,height", [(1, 17, 9), (2, 12, 10),
                                               (3, 8, 6)])
def test_generate_rays_match_jax(demo_tables, seed, ssaa, width, height):
    tables = (demo_tables if seed is None
              else _random_camera(demo_tables, seed))
    cfg = RenderConfig(width=width, height=height, ssaa=ssaa)
    o_j, d_j = jcam.generate_rays(
        type(tables)(*map(jnp.asarray, tables)), cfg)
    o_t, d_t = tcam.generate_rays(tables_to_torch(tables, "cpu"), cfg)
    assert d_t.shape == (height, width, ssaa * ssaa, 3)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_rotation_and_focal_match_jax(demo_tables, seed):
    tables = _random_camera(demo_tables, seed)
    r_j = jcam.camera_rotation(jnp.asarray(tables.cam_direction),
                               jnp.asarray(tables.cam_up))
    r_t = tcam.camera_rotation(torch.as_tensor(tables.cam_direction),
                               torch.as_tensor(tables.cam_up))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-6)
    f_j = jcam.camera_focal(jnp.asarray(tables.cam_fov))
    f_t = tcam.camera_focal(torch.as_tensor(tables.cam_fov))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6)
