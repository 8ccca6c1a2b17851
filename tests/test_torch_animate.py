"""Animation in the port against the JAX package, on the CPU:
``api.render_frames`` (a batch of poses in one stream of rays) against
``render_tables`` pose by pose, ``api.turntable_frames``' poses against the
JAX package's and its frames against JAX's jnp turntable, the GIF encoder
(the port's copy of ``io/gif.py``) byte for byte against JAX's with the
twins of tests/test_gif.py, and the server's ``POST /animate`` (twins of
tests/test_serve.py's animate cases)."""

import io
import math
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_gif import _lzw_decode  # noqa: E402
from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu as jrt  # noqa: E402
import raymarching_tpu.api as japi  # noqa: E402
from raymarching_tpu.io import gif as jgif  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.api import (render_frames,  # noqa: E402
                                       turntable_frames, turntable_poses)
from raymarching_tpu_torch.io import gif as tgif  # noqa: E402
from raymarching_tpu_torch.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu_torch.scene.parser import parse_scene  # noqa: E402
from raymarching_tpu_torch.serve import make_server  # noqa: E402

CFG = rt.RenderConfig(width=16, height=12, ssaa=1, iterations=80)
# tests/test_mega.py:87, the cross-path image tolerance
IMG_ATOL = 5e-4
SCENE = """
Bounds 60.0
Camera Position 0 0 8
Light 5 8 5
Color 0.9 0.3 0.2
Sphere 0 0 -4 2
Color 0.2 0.8 0.3
Box 3 0 -4 1 1 1
"""


@pytest.fixture(scope="module")
def demo():
    return rt.compile_scene(rt.load_scene("scenes/demo.txt"))


def _jax_poses(frames, orbit, center=None):
    """The poses JAX's turntable_frames hands render_frames, captured."""
    plan, tables = jrt.compile_scene(jrt.load_scene("scenes/demo.txt"))
    got = []

    def capture(plan_, tables_, cfg, ps, ds, **kw):
        got.extend(zip(ps, ds))
        return np.zeros((len(ps), cfg.height, cfg.width, 3), np.float32)

    orig = japi.render_frames
    japi.render_frames = capture
    try:
        list(japi.turntable_frames(plan, tables, jrt.RenderConfig(
            width=2, height=2, ssaa=1), frames, orbit=orbit, center=center,
            backend="mega", batch=3))
    finally:
        japi.render_frames = orig
    return got


@pytest.mark.parametrize("frames,orbit,center", [
    (5, None, None), (4, math.pi / 2, None), (1, math.pi, None),
    (3, -math.pi / 3, (1.0, 0.5, -6.0))])
def test_turntable_poses_equal_jax(demo, frames, orbit, center):
    """The pose math is JAX's line for line: equal float32 poses."""
    _, tables = demo
    got = turntable_poses(tables, frames, orbit=orbit, center=center)
    want = _jax_poses(frames, orbit, center)
    assert len(got) == len(want) == frames
    for (p, d), (jp, jd) in zip(got, want):
        assert p.dtype == np.float32
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(d, jd)


def test_turntable_endpoints(demo):
    """A full loop leaves out its endpoint (N frames a 2 pi / N apart); a
    partial sweep ends exactly at the swept angle."""
    _, tables = demo
    center = np.asarray(tables.prim_pos, np.float32).mean(0)

    def angle(p):
        q = p - center
        return math.atan2(float(q[2]), float(q[0]))

    full = turntable_poses(tables, 4)
    steps = [(angle(b[0]) - angle(a[0])) % (2 * math.pi)
             for a, b in zip(full, full[1:] + full[:1])]
    np.testing.assert_allclose(steps, [math.pi / 2] * 4, atol=1e-5)
    part = turntable_poses(tables, 3, orbit=math.pi / 2)
    sweep = (angle(part[-1][0]) - angle(part[0][0])) % (2 * math.pi)
    assert abs(sweep - math.pi / 2) < 1e-5
    for p, d in full + part:     # every pose looks at the centre
        look = (center - p) / np.linalg.norm(center - p)
        np.testing.assert_allclose(d, look, atol=1e-6)


def test_render_frames_equal_render_tables_per_pose(demo):
    """Frame i of one batch is render_tables at pose i, bitwise."""
    plan, tables = demo
    poses = turntable_poses(tables, 3, orbit=math.pi / 3)
    ps, ds = (np.stack(x) for x in zip(*poses))
    frames = render_frames(plan, tables, CFG, ps, ds, device="cpu")
    assert frames.shape == (3, CFG.height, CFG.width, 3)
    for i in range(3):
        want = rt.render_tables(plan, tables._replace(
            cam_position=ps[i], cam_direction=ds[i]), CFG, device="cpu")
        assert torch.equal(frames[i], want)
    assert not torch.equal(frames[0], frames[1])
    with pytest.raises(ValueError, match="render_frames"):
        render_frames(plan, tables, CFG, ps, ds[:2], device="cpu")


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_turntable_frames_match_jax_jnp(demo, backend):
    """The port's turntable (cuda: batches through render_frames; ref: a
    render_tables a frame) against JAX's jnp turntable."""
    plan, tables = demo
    got = list(turntable_frames(plan, tables, CFG, 3, orbit=math.pi / 2,
                                backend=backend, batch=2, device="cpu"))
    jplan, jtables = jrt.compile_scene(jrt.load_scene("scenes/demo.txt"))
    want = list(japi.turntable_frames(
        jplan, jtables, jrt.RenderConfig(width=16, height=12, ssaa=1,
                                         iterations=80), 3,
        orbit=math.pi / 2, backend="jnp"))
    assert len(got) == 3
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray) and a.shape == (12, 16, 3)
        np.testing.assert_allclose(a, b, rtol=0, atol=IMG_ATOL)


def _frames(seed=3, n=3, h=16, w=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("n,delay,loop", [(1, 4, True), (3, 5, True),
                                          (4, 10, False)])
def test_encode_gif_bytes_equal_jax(n, delay, loop):
    frames = _frames(n=n)
    assert tgif.encode_gif(frames, delay_cs=delay, loop=loop) == \
        jgif.encode_gif(frames, delay_cs=delay, loop=loop)


@pytest.mark.parametrize("n", [1, 7, 300, 5000])
def test_lzw_roundtrip_random(n):
    data = np.random.default_rng(n).integers(0, 252, n).astype(np.uint8)
    assert np.array_equal(_lzw_decode(tgif._lzw(data, 8), 8), data)


def test_lzw_roundtrip_long_runs():
    data = np.repeat(np.arange(16, dtype=np.uint8), 2048)
    assert np.array_equal(_lzw_decode(tgif._lzw(data, 8), 8), data)


def test_quantize_and_palette_equal_jax():
    img = _frames(seed=0, n=1, h=9, w=13)[0]
    np.testing.assert_array_equal(tgif._quantize(img), jgif._quantize(img))
    np.testing.assert_array_equal(tgif._palette(), jgif._palette())
    err = np.abs(tgif._palette()[tgif._quantize(img)].astype(int)
                 - img.astype(int)).max()
    assert err <= 26


def test_gif_structure_and_refusals():
    frames = [np.full((8, 10, 3), v, np.uint8) for v in (0, 128, 255)]
    data = tgif.encode_gif(frames, delay_cs=10)
    assert data[:6] == b"GIF89a" and data[-1:] == b"\x3B"
    assert b"NETSCAPE2.0" in data
    assert (int.from_bytes(data[6:8], "little"),
            int.from_bytes(data[8:10], "little")) == (10, 8)
    assert b"NETSCAPE2.0" not in tgif.encode_gif([frames[0]])
    with pytest.raises(ValueError):
        tgif.encode_gif([np.zeros((4, 4, 3), np.uint8),
                         np.zeros((5, 4, 3), np.uint8)])
    with pytest.raises(ValueError):
        tgif.encode_gif([])


def test_gif_decodes_with_pillow():
    pil = pytest.importorskip("PIL.Image")
    frames = _frames()
    im = pil.open(io.BytesIO(tgif.encode_gif(frames, delay_cs=5)))
    assert im.size == (12, 16) and getattr(im, "n_frames", 1) == 3
    pal = tgif._palette()
    for k, f in enumerate(frames):
        im.seek(k)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                      pal[tgif._quantize(f)])


@pytest.fixture(scope="module")
def server():
    srv = make_server("127.0.0.1", 0, "cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(url):
    req = urllib.request.Request(url, data=SCENE.encode(), method="POST")
    return urllib.request.urlopen(req)


def _direct(frames, orbit_deg):
    plan, tables = compile_scene(parse_scene(SCENE))
    cfg = rt.RenderConfig(width=16, height=12, ssaa=1, iterations=40,
                          serve_raygen=True)
    return [rt.to_uint8(f) for f in turntable_frames(
        plan, tables, cfg, frames, orbit=math.radians(orbit_deg),
        device="cpu")]


def test_animate_zip(server):
    """format=zip (the default): frame_NNN.png, each the PNG of the direct
    turntable's frame; the camera moves."""
    with _post(server + "/animate?width=16&height=12&iterations=40"
               "&frames=3&orbit=90") as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "application/zip"
        body = r.read()
    with zipfile.ZipFile(io.BytesIO(body)) as zf:
        names = zf.namelist()
        assert names == ["frame_000.png", "frame_001.png", "frame_002.png"]
        pngs = [rt.decode_png(zf.read(n))[..., :3] for n in names]
    for got, want in zip(pngs, _direct(3, 90.0)):
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(pngs[0], pngs[1])


def test_animate_gif(server):
    """format=gif: the port's encoder on the direct turntable's frames."""
    with _post(server + "/animate?width=16&height=12&iterations=40"
               "&frames=3&format=gif&delay_cs=8") as r:
        assert r.status == 200 and r.headers["Content-Type"] == "image/gif"
        body = r.read()
    assert body == tgif.encode_gif(_direct(3, 360.0), delay_cs=8)


@pytest.mark.parametrize("query", [
    "width=8&height=8&frames=100000",            # MAX_FRAMES
    "width=4096&height=4096&ssaa=4&frames=600",  # MAX_ANIMATE_SAMPLES
    "width=2048&height=1024&ssaa=1&frames=24&format=gif",  # MAX_GIF_PIXELS
    "width=8&height=8&frames=2&center=1,2"])
def test_animate_caps_422(server, query):
    """Each cap answers 422 before any render (a malformed centre 400)."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/animate?" + query)
    assert e.value.code == (400 if "center" in query else 422)
