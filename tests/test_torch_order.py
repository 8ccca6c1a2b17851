"""Block ray order in the port (core.order) against the JAX package's
``raymarching_tpu.core.order``: the block shape, both reorders and the
mode rule; frames in block order bitwise the scan-order ones on every
camera-grid path; the raygen twin's block arm against JAX's camera under
``to_blocked``; on a CUDA device K1's raygen block arm against its twin."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu as jrt  # noqa: E402
from raymarching_tpu.core import camera as jcam  # noqa: E402
from raymarching_tpu.core import order as jorder  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.api import render_tiled  # noqa: E402
from raymarching_tpu_torch.core import camera as cam  # noqa: E402
from raymarching_tpu_torch.core import order  # noqa: E402
from raymarching_tpu_torch.ops import render_kernel as rk  # noqa: E402
from raymarching_tpu_torch.tables import tables_to_torch  # noqa: E402

# tests/test_ray_order.py's shapes: the bench frame, the reference frame,
# a small one and awkward divisors
SHAPES = [(512, 512, 4, 2048), (768, 1024, 9, 2048), (36, 64, 1, 1024),
          (50, 60, 9, 2048)]
# a frame small enough for the CPU twins, with pixel blocks: one JAX tile
# of 128 rays
CFG = rt.RenderConfig(width=32, height=24, ssaa=2, iterations=100,
                      tile_sublanes=1)


@pytest.mark.parametrize("H,W,S,tile", SHAPES)
def test_block_dims_and_reorders_equal_jax(H, W, S, tile):
    dims = order.block_dims(H, W, S, tile)
    assert dims == jorder.block_dims(H, W, S, tile) and dims is not None
    R = H * W * S
    x = np.arange(R * 2, dtype=np.float32).reshape(R, 2)
    got = order.to_blocked(torch.as_tensor(x), H, W, S, *dims)
    want = np.asarray(jorder.to_blocked(jnp.asarray(x), H, W, S, *dims))
    np.testing.assert_array_equal(got.numpy(), want)
    back = order.from_blocked(got, H, W, S, *dims)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jorder.from_blocked(jnp.asarray(want), H, W, S, *dims)))
    # the round trip is the identity, and the forward map is no identity
    np.testing.assert_array_equal(back.numpy(), x)
    assert not np.array_equal(got.numpy(), x)
    # one dimension of rows too, as the colours' SSAA samples come back
    flat = torch.arange(R, dtype=torch.int64)
    assert torch.equal(order.from_blocked(order.to_blocked(
        flat, H, W, S, *dims), H, W, S, *dims), flat)


def test_reorder_backward_is_the_inverse_permute():
    H, W, S = 36, 64, 1
    dims = order.block_dims(H, W, S, 1024)
    x = torch.randn(H * W * S, 3, dtype=torch.float64, requires_grad=True)
    g = torch.randn(H * W * S, 3, dtype=torch.float64)
    order.to_blocked(x, H, W, S, *dims).backward(g)
    assert torch.equal(x.grad, order.from_blocked(g, H, W, S, *dims))


def test_tiny_frame_declines():
    assert order.block_dims(8, 8, 1, 2048) is None
    assert jorder.block_dims(8, 8, 1, 2048) is None


# the port's backends beside the JAX package's
BACKENDS = {"cuda": "mega", "multi": "pallas", "ref": "ref", "torch": "jnp"}


@pytest.mark.parametrize("mode", ["auto", "block", "scan"])
def test_resolve_ray_order_equals_jax(mode):
    cfg = rt.RenderConfig(ray_order=mode)
    jcfg = jrt.RenderConfig(ray_order=mode)
    for port, jax_ in BACKENDS.items():
        assert (order.resolve_ray_order(cfg, port)
                == jorder.resolve_ray_order(jcfg, jax_)), port
    with pytest.raises(ValueError):
        order.resolve_ray_order(rt.RenderConfig(ray_order="zigzag"), "cuda")


def test_frame_blocks_use_the_jax_tile():
    c = rt.RenderConfig(width=512, height=512, ssaa=2)
    assert order.frame_blocks(c, 512, "cuda") == jorder.block_dims(
        512, 512, 4, 32 * 128)
    assert order.frame_blocks(c, 512, "multi") is None
    assert order.frame_blocks(c.replace(ray_order="block"), 64,
                              "multi") == jorder.block_dims(64, 512, 4, 4096)


@pytest.fixture(scope="module")
def demo(scenes_dir):
    return rt.load_scene(str(scenes_dir / "demo.txt"))


@pytest.mark.parametrize("path", ["cuda", "served", "lens", "tiled",
                                  "multi"])
def test_block_frame_is_bitwise_the_scan_frame(demo, path):
    """render() (K1's twin), the served frame (the raygen twin's block
    arm), depth of field (per-ray lens origins reordered too),
    render_tiled's row blocks and the multi backend's hooks: the same
    bits in block order as in scan order."""
    plan, tables = rt.compile_scene(demo)
    cfg = {"cuda": CFG, "served": CFG.replace(serve_raygen=True),
           "lens": CFG.replace(aperture=0.2, focus_dist=8.0),
           "tiled": CFG, "multi": CFG}[path]
    backend = "multi" if path == "multi" else "cuda"
    assert order.frame_blocks(cfg.replace(ray_order="block"), 24,
                              backend) is not None

    def frame(mode):
        c = cfg.replace(ray_order=mode)
        if path == "tiled":
            return torch.as_tensor(render_tiled(plan, tables, c,
                                                row_block=12, device="cpu"))
        return rt.render_tables(plan, tables, c, backend=backend,
                                device="cpu")

    scan, block = frame("scan"), frame("block")
    assert torch.equal(scan, block)
    assert float(scan.max()) > 0.0


def test_block_order_reaches_the_served_raygen(demo, monkeypatch):
    """The served frame hands K1's raygen the block shape, and the twin's
    colours come back in scan order."""
    plan, tables = rt.compile_scene(demo)
    seen = []
    raygen = rk.render_raygen

    def spy(*a, **k):
        seen.append(k.get("block"))
        return raygen(*a, **k)

    import raymarching_tpu_torch.api as api
    monkeypatch.setattr(api, "render_raygen", spy)
    cfg = CFG.replace(serve_raygen=True)
    rt.render_tables(plan, tables, cfg, device="cpu")
    assert seen == [order.frame_blocks(cfg, 24, "cuda")]
    seen.clear()
    rt.render_tables(plan, tables, cfg.replace(ray_order="scan"),
                     device="cpu")
    assert seen == [None]


@pytest.mark.parametrize("ssaa", [1, 2])
def test_raygen_block_arm_equals_jax_camera(scenes_dir, ssaa):
    """The raygen twin's directions in block order against JAX's
    generate_rays under to_blocked, at 1e-6."""
    cfg = CFG.replace(ssaa=ssaa)
    _, jtables = jrt.compile_scene(jrt.load_scene(
        str(scenes_dir / "demo.txt")))
    jcfg = jrt.RenderConfig(width=cfg.width, height=cfg.height, ssaa=ssaa)
    H, W, S = cfg.height, cfg.width, cfg.samples_per_pixel
    bd = order.block_dims(H, W, S, 128)
    _, jd = jcam.generate_rays(jtables, jcfg)
    want = np.asarray(jorder.to_blocked(jnp.asarray(jd).reshape(-1, 3),
                                        H, W, S, *bd))
    tt = tables_to_torch(jtables, "cpu")
    got = cam.raygen_dirs(cam.serve_cam_rows(tt, cfg), cfg, 0, H * W * S,
                          bd)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # in scan order, the same directions in the camera's order
    scan = cam.raygen_dirs(cam.serve_cam_rows(tt, cfg), cfg, 0, H * W * S)
    assert torch.equal(order.to_blocked(scan, H, W, S, *bd), got)


def test_raygen_rejects_a_block_that_does_not_tile(demo):
    plan, tables = rt.compile_scene(demo)
    tt = tables_to_torch(tables, "cpu")
    with pytest.raises(ValueError, match="does not tile"):
        rk.render_raygen(plan, CFG, tt, 0, 16, block=(5, 7))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("normal", ["fd", "analytic", "bounce"])
def test_raygen_block_arm_on_card(cuda_device, demo, normal):
    """K1's raygen entries (the bounce entry's raygen form too) in block
    order against their twin, bitwise."""
    plan, tables = rt.compile_scene(demo)
    tt = tables_to_torch(tables, cuda_device)
    cfg = CFG.replace(ssaa=1)
    if normal == "analytic":
        cfg = cfg.replace(normal_mode="analytic")
    if normal == "bounce":
        cfg = cfg.replace(reflect_strength=0.4, reflect_bounces=1)
    bd = order.block_dims(cfg.height, cfg.width, 1, 128)
    R = cfg.rays_per_image
    got = rk.render_raygen(plan, cfg, tt, 0, R, block=bd)
    want = rk.render_raygen_plain(plan, cfg, tt, 0, R, block=bd)

    def flat(x):
        if isinstance(x, tuple) and not hasattr(x, "_fields"):
            return tuple(v for part in x for v in flat(part))
        return tuple(x)

    for a, b in zip(flat(got), flat(want)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("serve", [False, True])
def test_block_frame_on_card(cuda_device, demo, serve):
    cfg = CFG.replace(serve_raygen=serve)
    scan = rt.render(demo, cfg.replace(ray_order="scan"), device=cuda_device)
    block = rt.render(demo, cfg.replace(ray_order="block"),
                      device=cuda_device)
    assert torch.equal(scan, block)
