"""The port's own copies of the numpy-only modules (config, scene, io,
utils) against the JAX package's originals: the same plans and tables bit
for bit on every scene file, the same configuration, the same encoded
bytes, checkpoints that cross between the packages, the same gate
classification."""

import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu as jrt  # noqa: E402
from raymarching_tpu.io import checkpoint as jckpt  # noqa: E402
from raymarching_tpu.io import gif as jgif  # noqa: E402
from raymarching_tpu.io import mesh as jmesh  # noqa: E402
from raymarching_tpu.io import jpeg as jjpeg  # noqa: E402
from raymarching_tpu.io import png as jpng  # noqa: E402
from raymarching_tpu.scene import compile as jcompile  # noqa: E402
from raymarching_tpu.scene import parser as jparser  # noqa: E402
from raymarching_tpu.scene import writer as jwriter  # noqa: E402
from raymarching_tpu.utils import gatecheck as jgate  # noqa: E402
from raymarching_tpu.utils import structlog as jlog  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from raymarching_tpu_torch.io import gif as tgif  # noqa: E402
from raymarching_tpu_torch.io import mesh as tmesh  # noqa: E402
from raymarching_tpu_torch.io import image as timage  # noqa: E402
from raymarching_tpu_torch.io import jpeg as tjpeg  # noqa: E402
from raymarching_tpu_torch.io import png as tpng  # noqa: E402
from raymarching_tpu_torch.scene import compile as tcompile  # noqa: E402
from raymarching_tpu_torch.scene import parser as tparser  # noqa: E402
from raymarching_tpu_torch.scene import writer as twriter  # noqa: E402
from raymarching_tpu_torch.tables import (tables_to_numpy,  # noqa: E402
                                          tables_to_torch)
from raymarching_tpu_torch.utils import gatecheck as tgate  # noqa: E402
from raymarching_tpu_torch.utils import structlog as tlog  # noqa: E402

SCENES_DIR = Path(__file__).resolve().parent.parent / "scenes"
SCENE_FILES = sorted(p.name for p in SCENES_DIR.glob("*.txt"))


def _plain(x):
    """A plan (nested dataclasses, named tuples, enums, numpy arrays) as
    plain Python data, so two packages' classes compare by content."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _plain(v) for k, v in zip(x._fields, x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return [str(x.dtype), list(x.shape), x.tobytes().hex()]
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    if hasattr(x, "value") and hasattr(x, "name"):     # an enum member
        return [type(x).__name__, x.name, _plain(x.value)]
    return x


def test_there_are_scene_files():
    assert len(SCENE_FILES) >= 8 and "demo.txt" in SCENE_FILES


@pytest.mark.parametrize("name", SCENE_FILES)
def test_compile_scene_equals_jax_package(name):
    path = str(SCENES_DIR / name)
    jplan, jtables = jcompile.compile_scene(jparser.load_scene(path))
    tplan, ttables = tcompile.compile_scene(tparser.load_scene(path))
    assert type(tplan) is not type(jplan)       # the port's own classes
    assert type(ttables) is tcompile.SceneTables
    assert ttables._fields == jtables._fields
    for field, a, b in zip(jtables._fields, ttables, jtables):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    assert json.dumps(_plain(tplan), sort_keys=True) == json.dumps(
        _plain(jplan), sort_keys=True)
    assert hash(tplan) is not None and tplan == tcompile.compile_scene(
        tparser.load_scene(path))[0]


@pytest.mark.parametrize("name", ["demo.txt", "config4.txt"])
def test_scene_writer_equals_jax_package(name):
    path = str(SCENES_DIR / name)
    jscene, tscene = jparser.load_scene(path), tparser.load_scene(path)
    jtext, ttext = jwriter.scene_to_text(jscene), twriter.scene_to_text(tscene)
    assert ttext == jtext and "Camera" in ttext


def test_render_config_equals_jax_package():
    j, t = jrt.RenderConfig(), rt.RenderConfig()
    assert type(t) is not type(j)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)]
    kw = dict(width=20, height=10, ssaa=2)
    assert (t.replace(**kw).rays_per_image == j.replace(**kw).rays_per_image
            == 800)
    assert t.replace(**kw).aspect_ratio == j.replace(**kw).aspect_ratio
    assert hash(t) == hash(rt.RenderConfig())


def _image(seed=0, h=13, w=17):
    return np.random.default_rng(seed).uniform(-0.2, 1.2, (h, w, 3)).astype(
        np.float32)


@pytest.mark.parametrize("gamma", [1.0, 2.2])
def test_png_and_jpeg_bytes_equal_jax_package(gamma, tmp_path, monkeypatch):
    from raymarching_tpu.io import image as jimage
    from raymarching_tpu_torch import native as tnative
    img = _image()
    data = timage.to_uint8(img, gamma)
    np.testing.assert_array_equal(data, jimage.to_uint8(img, gamma))
    png = tpng.encode_png(data)
    assert png == jpng.encode_png(data)
    np.testing.assert_array_equal(tpng.decode_png(png)[..., :3], data)
    assert tjpeg.encode_jpeg(data, 100) == jjpeg.encode_jpeg(data, 100)
    assert tjpeg.encode_jpeg(data, 60) == jjpeg.encode_jpeg(data, 60)
    # save_image without the native library (its loader stubbed to None):
    # the pure-Python PNG encoder (tests/test_torch_native.py holds the
    # native writer's pixels)
    monkeypatch.setattr(tnative, "load_library", lambda *a, **k: None)
    for ext in ("png", "ppm", "jpg", "pfm"):
        timage.save_image(str(tmp_path / f"t.{ext}"), img, gamma)
    assert (tmp_path / "t.png").read_bytes() == png
    jimage.save_image(str(tmp_path / "j.jpg"), img, gamma)
    jimage.save_image(str(tmp_path / "j.pfm"), img, gamma)
    for ext in ("jpg", "pfm"):
        assert ((tmp_path / f"t.{ext}").read_bytes()
                == (tmp_path / f"j.{ext}").read_bytes())
    np.testing.assert_array_equal(jpng.read_png(str(tmp_path / "t.png")),
                                  tpng.read_png(str(tmp_path / "t.png")))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_between_packages(writer, tmp_path):
    path = str(SCENES_DIR / "config4.txt")
    _, jtables = jcompile.compile_scene(jparser.load_scene(path))
    _, ttables = tcompile.compile_scene(tparser.load_scene(path))
    ck = str(tmp_path / "c.npz")
    extra = {"note": np.arange(3)}
    if writer == "port":
        tckpt.save_checkpoint(ck, ttables, step=7, extra=extra)
        got, step, ex = jckpt.load_checkpoint(ck)
        assert type(got) is jcompile.SceneTables
    else:
        jckpt.save_checkpoint(ck, jtables, step=7, extra=extra)
        got, step, ex = tckpt.load_checkpoint(ck)
        assert type(got) is tcompile.SceneTables
    assert step == 7 and list(ex["note"]) == [0, 1, 2]
    for field, a, b in zip(jtables._fields, got, jtables):
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert not hasattr(tckpt, "save_checkpoint_orbax")


def test_tables_cross_by_field_name():
    """``tables_to_torch`` takes the JAX package's SceneTables (numpy) by
    its field names and gives the port's; ``tables_to_numpy`` gives arrays
    the JAX package's class takes field by field."""
    path = str(SCENES_DIR / "demo.txt")
    _, jtables = jcompile.compile_scene(jparser.load_scene(path))
    tt = tables_to_torch(jtables, "cpu", requires_grad=("prim_pos",))
    assert type(tt) is tcompile.SceneTables and tt.prim_pos.requires_grad
    for field, a, b in zip(jtables._fields, tt, jtables):
        np.testing.assert_array_equal(a.detach().numpy(), b, err_msg=field)

    class Shuffled:            # any object with the field names will do
        pass
    s = Shuffled()
    for field in reversed(jtables._fields):
        setattr(s, field, getattr(jtables, field))
    for a, b in zip(tables_to_torch(s, "cpu"), tt):
        assert torch.equal(a, b.detach())
    back = tables_to_numpy(tt)
    jback = jcompile.SceneTables(**back._asdict())
    for field, a, b in zip(jtables._fields, jback, jtables):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_structlog_records_equal_jax_package():
    """The same records, with the rank given instead of looked up."""
    jbuf, tbuf = io.StringIO(), io.StringIO()
    j = jlog.StructuredLogger(stream=jbuf)
    t = tlog.StructuredLogger(stream=tbuf, rank=0)
    j.log("render", backend="mega", seconds=1.5)
    t.log("render", backend="mega", seconds=1.5)
    with t.span("phase", rays=1000, tag="x"):
        pass
    jrec = json.loads(jbuf.getvalue())
    trec, tspan = (json.loads(ln) for ln in tbuf.getvalue().splitlines())
    drop = lambda r: {k: v for k, v in r.items() if k != "ts"}  # noqa: E731
    assert drop(trec) == drop(jrec) and list(trec) == list(jrec)
    assert tspan["event"] == "phase" and tspan["tag"] == "x"
    assert tspan["mrays_per_s"] > 0 and tspan["process"] == 0
    assert tlog.StructuredLogger(stream=tbuf, rank=5).log("e")["process"] == 5
    assert tlog.get_logger() is None
    tlog.emit("dropped")             # a no-op with no default logger


@pytest.mark.parametrize("planes", ["geometry", "shadow", "normal", "all"])
def test_gatecheck_equals_jax_package(planes):
    """The port's utils.gatecheck classifies seeded AOV planes (object ids
    in patches, depth jumps, partial coverage, shadow fractions, normals
    with creases) as JAX's does: the same mask and the same record."""
    rng = np.random.default_rng(11)
    H, W, L = 24, 32, 2
    objid = np.repeat(np.repeat(rng.integers(-1, 4, (6, 8)), 4, 0), 4, 1)
    hit = np.where(objid < 0, 0.0, 1.0)
    hit[rng.random((H, W)) < 0.05] = 0.5
    depth = np.where(hit > 0, 5.0 + objid + 0.01 * rng.random((H, W)),
                     np.inf)
    shadow = (rng.random((H, W, L)) < 0.3) * rng.choice([0.5, 1.0],
                                                        (H, W, L))
    normal = rng.normal(size=(H, W, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    diff = rng.random((H, W)) * 1e-2
    kw = {"geometry": {}, "shadow": dict(shadow=shadow),
          "normal": dict(normal=normal, crease_deg=30.0),
          "all": dict(shadow=shadow, normal=normal, dilate=2)}[planes]
    np.testing.assert_array_equal(
        tgate.silhouette_mask(objid, depth, hit, **kw),
        jgate.silhouette_mask(objid, depth, hit, **kw))
    got = tgate.classify_offenders(diff, 5e-3, objid, depth, hit, **kw)
    assert got == jgate.classify_offenders(diff, 5e-3, objid, depth, hit,
                                           **kw)
    assert got["offenders"] > 0


@pytest.mark.parametrize("name", SCENE_FILES)
def test_mesh_bounds_and_gif_copies_equal_jax_package(name):
    """io/mesh.py's default_bounds on every scene file and io/gif.py's
    bytes on a frame of its grid's signs: the copies give the originals'
    results."""
    path = str(SCENES_DIR / name)
    jplan, jtables = jcompile.compile_scene(jparser.load_scene(path))
    tplan, ttables = tcompile.compile_scene(tparser.load_scene(path))
    lo, hi = tmesh.default_bounds(tplan, ttables)
    jlo, jhi = jmesh.default_bounds(jplan, jtables)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    pts = tmesh.grid_points(lo, hi, 5)
    frame = (np.abs(pts.reshape(25, 5, 3)) * 40 % 256).astype(np.uint8)
    assert tgif.encode_gif([frame, frame[::-1]]) == jgif.encode_gif(
        [frame, frame[::-1]])
