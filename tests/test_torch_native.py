"""The port's native host runtime (``raymarching_tpu_torch.native``):
``native/raymarch_host.cpp`` built with g++ into a temporary directory,
its parser and flattener held to the JAX package's Python compiler (and to
the port's), its PNG and JPEG writers round-tripped, and ``save_image``
through it.  The twins of ``tests/test_native.py``, which skips unless
``make native`` was run; these build the library themselves, and skip
only without ``g++`` or the zlib headers."""

import shutil
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu.scene import compile as jcompile  # noqa: E402
from raymarching_tpu.scene import parser as jparser  # noqa: E402
from raymarching_tpu_torch import native  # noqa: E402
from raymarching_tpu_torch.io import image as timage  # noqa: E402
from raymarching_tpu_torch.io import png as tpng  # noqa: E402
from raymarching_tpu_torch.scene import compile as tcompile  # noqa: E402
from raymarching_tpu_torch.scene import parser as tparser  # noqa: E402


@pytest.fixture(scope="module")
def lib_path(tmp_path_factory):
    """The library built into a temporary directory and loaded as the
    module's library for this file's tests; the loader's state is put
    back afterwards."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native host runtime cannot be built")
    try:
        path = native.build(tmp_path_factory.mktemp("native"))
    except RuntimeError as e:
        if "zlib.h" in str(e):
            pytest.skip("no zlib headers: the native host runtime cannot "
                        "be built")
        raise
    saved = native._LIB
    native.load_library(path)
    yield path
    native._LIB = saved


def _decode_png(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            assert depth == 8
            channels = {2: 3, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * channels
    rows = []
    for y in range(h):
        line = raw[y * (stride + 1): (y + 1) * (stride + 1)]
        assert line[0] == 0  # filter 0
        rows.append(np.frombuffer(line[1:], np.uint8))
    return np.stack(rows).reshape(h, w, channels)


# the scene files of the parity cases, and tests/test_julia.py's,
# test_mandelbulb.py's and test_light_color.py's native parity texts
FILES = ("demo", "menger4", "julia", "mandelbulb", "mirror")
TEXTS = {
    "julia_mixed": ("Color 0.9 0.6 0.3\n"
                    "Julia 0.1 -0.2 -4 1.2 -0.2 0.6 0.2 0.2 9\n"
                    "Julia 1 0 -6 0.5 0.3 0.5 0.4 0.1\n"
                    "Mandelbulb 0 2 -8 0.75\n"
                    "Sphere 4 0 -6 1.2\n"
                    "Light 6 8 4\n"),
    "bulb_mixed": ("Color 0.4 0.7 0.9\n"
                   "Mandelbulb 0.25 -0.1 -5 1.5 5\n"
                   "Mandelbulb 1 2 -8 0.75\n"
                   "Mandelbox 0 0 -12 1 2 7\n"
                   "Sphere 4 0 -6 1.2\n"
                   "Light 6 8 4\n"),
    "light_colors": ("Light 1 2 3\n"
                     "LightColor 1 0 0\n"
                     "Light 6 8 5\n"
                     "LightColor 0.2 0.4 1\n"
                     "Light -4 2 0\n"
                     "Sphere 0 0 -5 1\n"),
    # tests/test_materials.py's SCENE: named materials
    "materials": ("Material steel 0.6 0.6 0.65\n"
                  "Material lava 0.9 0.2 0.05\n"
                  "Bounds 60\n"
                  "Color steel\n"
                  "Sphere 0 0 -5 1\n"
                  "Color lava\n"
                  "Box 2 0 -5 1 1 1\n"
                  "Color 0.1 0.8 0.1\n"
                  "Sphere -2 0 -5 1\n"),
}


def _text(case, scenes_dir):
    return (TEXTS[case] if case in TEXTS
            else (scenes_dir / f"{case}.txt").read_text())


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("case", FILES + tuple(TEXTS))
def test_native_parser_matches_python(case, package, scenes_dir, lib_path):
    """The C++ parser and flattener give the Python compiler's tables, its
    procedural entries and its group structure, on each scene file and
    extension text, against the JAX package's compile_scene and the
    port's."""
    text = _text(case, scenes_dir)
    res = native.native_parse_scene(text)
    parser, compiler = ((jparser, jcompile) if package == "jax"
                        else (tparser, tcompile))
    scene = parser.parse_scene(text)
    plan, tables = compiler.compile_scene(scene)
    n_lights = len(scene.lights)   # the compiler pads no lights to one

    np.testing.assert_array_equal(res["prim_type"],
                                  np.asarray(plan.prim_type, np.int32))
    # Generated (Menger) positions differ by ~1 ulp: the native parser
    # accumulates in f32 like the reference's LiteMath float3, the Python
    # generator in f64 before the final cast.
    np.testing.assert_allclose(res["prim_pos"], tables.prim_pos, rtol=2e-6,
                               atol=1e-5)
    np.testing.assert_allclose(res["prim_aux"], tables.prim_aux, rtol=2e-6)
    np.testing.assert_array_equal(res["prim_color"], tables.prim_color)
    assert res["lights"].shape[0] == n_lights
    np.testing.assert_array_equal(res["lights"], tables.light_pos[:n_lights])
    np.testing.assert_array_equal(res["light_colors"],
                                  tables.light_color[:n_lights])
    assert res["proc"] == plan.proc
    np.testing.assert_allclose(res["camera"][:3], tables.cam_position)
    np.testing.assert_allclose(res["camera"][3:6], tables.cam_direction)
    np.testing.assert_allclose(res["camera"][6:9], tables.cam_up)
    assert res["camera"][9] == float(tables.cam_fov)
    kp = plan.kernel
    # group structure must match the Python kernel normal form
    assert kp is not None
    assert len(res["group_meta"]) == len(kp.groups)
    for g_native, g_py in zip(res["group_meta"], kp.groups):
        assert g_native[0] == g_py.gsign
        assert g_native[1] == g_py.count
    scales = np.concatenate([np.asarray(g.scales, np.float32)
                             for g in kp.groups])
    np.testing.assert_array_equal(res["prim_scale"], scales)
    counts = np.bincount(res["group_id"], minlength=len(kp.groups))
    np.testing.assert_array_equal(counts, [g.count for g in kp.groups])


def test_native_png_roundtrip(tmp_path, lib_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(23, 31, 3), dtype=np.uint8)
    path = str(tmp_path / "native.png")
    assert native.native_write_png(path, img)
    decoded = _decode_png(open(path, "rb").read())
    np.testing.assert_array_equal(decoded, img)


@pytest.mark.parametrize("img", [np.zeros((4, 5, 3), np.float32),
                                 np.zeros((4, 5), np.uint8),
                                 np.zeros((4, 5, 2), np.uint8)])
def test_native_writers_reject_other_arrays(img, tmp_path, lib_path):
    """Not uint8 [H, W, 3|4]: ValueError, before any pointer is passed."""
    for write in (native.native_write_png, native.native_write_jpeg):
        with pytest.raises(ValueError, match="uint8"):
            write(str(tmp_path / "x"), img)
    assert not list(tmp_path.iterdir())


def test_python_png_roundtrip():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, size=(17, 13, 4), dtype=np.uint8)
    decoded = _decode_png(tpng.encode_png(img))
    np.testing.assert_array_equal(decoded, img)


@pytest.mark.parametrize("text", ["Sphere 1 2", "Color chrome\n"
                                  "Sphere 0 0 -5 1\n"])
def test_native_parser_rejects_malformed(text, lib_path):
    """A short line, and an unknown material name
    (tests/test_materials.py's ``Color chrome``), raise ValueError."""
    with pytest.raises(ValueError):
        native.native_parse_scene(text)


def test_native_jpeg_decodes_close(tmp_path, lib_path):
    """The C++ baseline-JPEG twin (rm_write_jpeg) must decode back (via
    Pillow, an independent decoder) close to the source at quality 100,
    and within the same error envelope as the Python encoder
    (io/jpeg.py) on the same image."""
    PIL = pytest.importorskip("PIL.Image")
    from raymarching_tpu_torch.io.jpeg import write_jpeg

    rng = np.random.default_rng(5)
    # smooth image (JPEG is lossy on noise): gradient + low-freq bumps
    yy, xx = np.mgrid[0:40, 0:56]
    img = np.stack([
        (xx * 255 / 55), (yy * 255 / 39),
        127 + 120 * np.sin(xx / 9.0) * np.cos(yy / 7.0)], -1)
    img = np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)

    npath, ppath = str(tmp_path / "n.jpg"), str(tmp_path / "p.jpg")
    assert native.native_write_jpeg(npath, img, quality=100)
    write_jpeg(ppath, img, quality=100)
    dn = np.asarray(PIL.open(npath).convert("RGB"), np.int32)
    dp = np.asarray(PIL.open(ppath).convert("RGB"), np.int32)
    assert dn.shape == img.shape
    err_n = np.abs(dn - img.astype(np.int32)).mean()
    err_p = np.abs(dp - img.astype(np.int32)).mean()
    assert err_n < 3.0, err_n                  # quality-100 is near-lossless
    assert err_n < err_p + 0.5, (err_n, err_p)  # no worse than the twin


@pytest.mark.parametrize("gamma", [1.0, 2.2])
def test_save_image_takes_the_native_writer(gamma, tmp_path, lib_path):
    """With the library loaded, ``save_image`` writes a PNG through it (the
    bytes of ``native_write_png``) with the pixels of the pure-Python
    encoder."""
    img = np.random.default_rng(6).uniform(-0.2, 1.2, (13, 17, 3)).astype(
        np.float32)
    data = timage.to_uint8(img, gamma)
    timage.save_image(str(tmp_path / "s.png"), img, gamma)
    assert native.native_write_png(str(tmp_path / "n.png"), data)
    assert ((tmp_path / "s.png").read_bytes()
            == (tmp_path / "n.png").read_bytes())
    np.testing.assert_array_equal(tpng.read_png(str(tmp_path / "s.png")),
                                  tpng.decode_png(tpng.encode_png(data)))


def test_build_reuses_and_main_prints_the_library(lib_path, capsys):
    """An unchanged source and flags name the same file, which ``build``
    and ``python -m raymarching_tpu_torch.native DIR`` reuse."""
    assert native.build(lib_path.parent) == lib_path
    assert native.main([str(lib_path.parent)]) == 0
    assert capsys.readouterr().out.strip() == str(lib_path)
    assert lib_path.name.startswith("libraymarch_host_")


def test_build_raises_without_a_compiler(tmp_path, monkeypatch):
    """Without g++ on PATH: RuntimeError, and nothing written; the CXX
    variable names no other compiler."""
    monkeypatch.setenv("CXX", "clang++")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no g\\+\\+ on PATH"):
        native.build(tmp_path)
    assert not list(tmp_path.iterdir())


def test_unbuilt_library_falls_back(tmp_path, monkeypatch, lib_path):
    """With nothing built in the build directory, ``load_library`` gives
    None, the writers return False, the parser None, and ``save_image``
    takes the pure-Python encoder."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native, "_LIB", None)
    assert native.load_library() is None and not native.available()
    img = np.zeros((4, 5, 3), np.uint8)
    assert not native.native_write_png(str(tmp_path / "a.png"), img)
    assert not native.native_write_jpeg(str(tmp_path / "a.jpg"), img)
    assert native.native_parse_scene("Sphere 0 0 -5 1\n") is None
    timage.save_image(str(tmp_path / "p.png"), img.astype(np.float32))
    assert (tmp_path / "p.png").read_bytes() == tpng.encode_png(img)
    # built later in the same process (the fixture's build, copied to
    # where build() would write it): the next call loads it
    want = native.library_path()
    assert want.parent == tmp_path / "empty" and want.name == lib_path.name
    want.parent.mkdir()
    shutil.copy(lib_path, want)
    assert native.build() == want
    assert native.load_library() is not None and native.available()
    assert native.native_write_png(str(tmp_path / "b.png"), img)


def test_without_the_source_save_image_takes_io_png(tmp_path, monkeypatch):
    """Where the package stands without ``native/raymarch_host.cpp`` (an
    installed package): ``load_library`` gives None, ``build`` raises,
    and ``save_image`` writes through the pure-Python encoder."""
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(native, "_LIB", None)
    assert native.load_library() is None and not native.available()
    with pytest.raises(RuntimeError, match="missing.cpp"):
        native.build(tmp_path / "lib")
    assert not (tmp_path / "lib").exists()
    img = np.random.default_rng(7).uniform(0, 1, (5, 6, 3)).astype(
        np.float32)
    timage.save_image(str(tmp_path / "p.png"), img)
    assert ((tmp_path / "p.png").read_bytes()
            == tpng.encode_png(timage.to_uint8(img, 1.0)))


def test_native_is_in_the_standalone_scans():
    """tests/test_torch_standalone.py's import and source scans reach the
    native module."""
    from test_torch_standalone import PKG, _submodules
    assert "raymarching_tpu_torch.native" in _submodules()
    assert PKG / "native.py" in sorted(PKG.rglob("*.py"))
