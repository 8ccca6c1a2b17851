"""Port entry points: the CLI, the HTTP server (``/render``, ``/aovs``),
mirror bounces, depth of field and fractal scenes through both, and the
refusals (a depth-3 scene raises, a missing CUDA device is an error)."""

import io
import json
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import deep_scene, one_torch_thread  # noqa: E402,F401

import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu.io.png import read_png  # noqa: E402
from raymarching_tpu_torch.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu_torch.scene.parser import parse_scene  # noqa: E402
from raymarching_tpu_torch import cli  # noqa: E402
from raymarching_tpu_torch.api import render_aovs  # noqa: E402
from raymarching_tpu_torch.io.image import read_pfm  # noqa: E402
from raymarching_tpu_torch.serve import make_server  # noqa: E402

SCENE = """
Bounds 60.0
Camera Position 0 0 8
Light 5 8 5
Color 0.9 0.3 0.2
Sphere 0 0 -4 2
"""
SMALL = ["--width", "16", "--height", "12", "--ssaa", "1",
         "--iterations", "100"]
AOV_MEMBERS = ("color.png", "normal.png", "hit.png", "depth.npy",
               "objid.npy", "shadow.npy")


def test_cli_writes_png_on_cpu(tmp_path, scenes_dir, capsys):
    out = tmp_path / "out.png"
    rc = cli.main(["--scene", str(scenes_dir / "config1.txt"), "--out",
                   str(out), "--device", "cpu", "--backend", "ref,cuda",
                   "--compare", *SMALL])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape[:2] == (12, 16) and img.max() > 0
    assert "max |cuda - ref|" in capsys.readouterr().out


def test_cli_backend_torch_compares(tmp_path, scenes_dir, capsys):
    """``--backend torch`` (JAX's jnp: the plain pipeline with the
    implicit-function march) renders, and ``--compare`` reports it beside
    the others: its image is the ref oracle's, bitwise."""
    out = tmp_path / "torch.png"
    rc = cli.main(["--scene", str(scenes_dir / "config1.txt"), "--out",
                   str(out), "--device", "cpu", "--backend",
                   "ref,torch,cuda", "--compare", *SMALL])
    assert rc == 0
    text = capsys.readouterr().out
    assert "max |torch - ref| = 0.00e+00" in text
    assert "max |cuda - ref|" in text
    assert read_png(str(out)).max() > 0


def test_server_backend_torch(scenes_dir):
    """``--backend torch`` serves: /healthz names it and /render answers
    the image of ``render_tables(backend="torch")``."""
    srv = make_server("127.0.0.1", 0, "cpu", "torch")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz") as r:
            assert json.loads(r.read())["backend"] == "torch"
        with _post(url + "/render?width=16&height=12&ssaa=1&iterations=80"
                   "&serve_raygen=0") as r:
            png = rt.decode_png(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    plan, tables = compile_scene(parse_scene(SCENE))
    want = rt.to_uint8(rt.render_tables(plan, tables, rt.RenderConfig(
        width=16, height=12, ssaa=1, iterations=80), backend="torch",
        device="cpu").numpy())
    np.testing.assert_array_equal(png[..., :3], want)


def test_cli_without_gpu_refuses_cuda(tmp_path, scenes_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = cli.main(["--scene", str(scenes_dir / "config1.txt"), "--out",
                   str(tmp_path / "x.png"), "--device", "cuda", *SMALL])
    assert rc != 0
    assert not (tmp_path / "x.png").exists()


def test_render_on_missing_cuda_device_raises(scenes_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        rt.render(rt.load_scene(str(scenes_dir / "config1.txt")),
                  rt.RenderConfig(width=4, height=4, ssaa=1), device="cuda")


@pytest.mark.parametrize("change", [
    dict(normal_mode="analytic", reflect_strength=0.3),
    dict(fused_generators=True, reflect_strength=0.3),
    dict(soft_shadow_k=8.0, reflect_strength=0.3),
    dict(ao_strength=0.5, aperture=0.2),
    dict(reflect_strength=0.3), dict(aperture=0.2),
    dict(serve_raygen=True, aperture=0.2)])
def test_unsupported_config_raises(change, scenes_dir):
    """Mirror bounces and depth of field, alone or beside the other
    extensions, render (they raised before they were ported): a finite
    image that is not black, and not the image without them."""
    scene = rt.load_scene(str(scenes_dir / "config1.txt"))
    base = rt.RenderConfig(width=8, height=6, ssaa=2, iterations=100)
    img = rt.render(scene, base.replace(**change), device="cpu")
    assert img.shape == (6, 8, 3) and torch.isfinite(img).all()
    assert img.max() > 0
    plain = {k: v for k, v in change.items()
             if k not in ("reflect_strength", "aperture")}
    assert not torch.equal(img, rt.render(scene, base.replace(**plain),
                                          device="cpu"))


@pytest.mark.parametrize("change", [
    dict(soft_shadow_k=8.0), dict(ao_strength=0.5),
    dict(normal_mode="analytic", soft_shadow_k=8.0, ao_strength=0.5),
    dict(serve_raygen=True)])
def test_shading_extensions_render(change, scenes_dir):
    """The ported extensions render, and move the image off the
    reference shading's."""
    scene = rt.load_scene(str(scenes_dir / "demo.txt"))
    base = rt.RenderConfig(width=16, height=12, ssaa=1, iterations=100)
    img = rt.render(scene, base.replace(**change), device="cpu")
    assert torch.isfinite(img).all() and img.max() > 0
    if "serve_raygen" not in change:
        assert not torch.equal(img, rt.render(scene, base, device="cpu"))


@pytest.mark.parametrize("change", [
    dict(two_phase_k1=16), dict(two_phase_k1=16, shadows=False),
    dict(shade_skip_black=False)])
def test_supported_config_renders(change, scenes_dir):
    """Settings the port accepts: the two-phase march renders the
    one-kernel image exactly."""
    scene = rt.load_scene(str(scenes_dir / "config1.txt"))
    base = rt.RenderConfig(width=8, height=6, ssaa=1, iterations=60)
    img = rt.render(scene, base.replace(**change), device="cpu")
    want = rt.render(scene, base.replace(**{k: v for k, v in change.items()
                                            if k != "two_phase_k1"}),
                     device="cpu")
    assert torch.equal(img, want) and img.max() > 0


def test_unsupported_scenes_and_grad_tables_raise(scenes_dir):
    """The fractal scenes render (they raised before the procedural leaves
    were ported), and so does a depth-3 tree (it raised before the deep
    fold was ported): finite images equal to the ref oracle's.  The
    differentiable ref oracle (it raised before it was ported) renders
    the forward image bitwise and gives finite gradients."""
    cfg = rt.RenderConfig(width=8, height=6, ssaa=1, iterations=100)
    for name in ("mandelbox", "julia"):
        scene = rt.load_scene(str(scenes_dir / f"{name}.txt"))
        img = rt.render(scene, cfg, device="cpu")
        assert img.shape == (6, 8, 3) and torch.isfinite(img).all()
        assert img.max() > 0
        torch.testing.assert_close(img, rt.render_ref(scene, cfg,
                                                      device="cpu"),
                                   rtol=0, atol=1e-3)
    deep = deep_scene(rt.load_scene(str(scenes_dir / "config1.txt")))
    assert compile_scene(deep)[0].kernel is None
    img = rt.render(deep, cfg, device="cpu")
    assert img.shape == (6, 8, 3) and torch.isfinite(img).all()
    assert img.max() > 0
    torch.testing.assert_close(img, rt.render_ref(deep, cfg, device="cpu"),
                               rtol=0, atol=1e-3)
    plan, tables = compile_scene(rt.load_scene(str(scenes_dir /
                                                   "config1.txt")))
    grad_tables = type(tables)(*(torch.tensor(v, requires_grad=True)
                                 for v in tables))
    img = rt.render_tables(plan, grad_tables, cfg, backend="ref",
                           differentiable=True, device="cpu")
    assert torch.equal(img.detach(), rt.render_tables(
        plan, tables, cfg, backend="ref", device="cpu"))
    grads = torch.autograd.grad(img.mean(), list(grad_tables),
                                allow_unused=True, materialize_grads=True)
    assert all(torch.isfinite(g).all() for g in grads)
    assert grad_tables._fields[0] == "prim_pos" and grads[0].abs().max() > 0


def test_cli_renders_a_fractal_scene(tmp_path, scenes_dir):
    """The CLI renders scenes/julia.txt (a procedural leaf) on the CPU: the
    PNG of ``render`` at the same size."""
    out = tmp_path / "julia.png"
    rc = cli.main(["--scene", str(scenes_dir / "julia.txt"), "--out",
                   str(out), "--device", "cpu", *SMALL])
    assert rc == 0
    want = rt.to_uint8(rt.render(
        rt.load_scene(str(scenes_dir / "julia.txt")), rt.RenderConfig(
            width=16, height=12, ssaa=1, iterations=100),
        device="cpu").numpy())
    np.testing.assert_array_equal(read_png(str(out))[..., :3], want)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        rt.render_tables(None, None, backend="mega", device="cpu")


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


def _post(url, body=SCENE):
    req = urllib.request.Request(url, data=body.encode(), method="POST")
    return urllib.request.urlopen(req)


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz") as r:
        payload = json.loads(r.read())
    assert payload == {"status": "ok", "device": "cpu", "backend": "cuda"}


def test_render_png_equals_direct_render(server):
    """``serve_raygen=1`` (the default) renders through the raygen serving
    path: the PNG of ``render`` with ``serve_raygen=True``."""
    q = "/render?width=20&height=14&ssaa=2&iterations=80&serve_raygen=1"
    with _post(server + q) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "image/png"
        assert "X-Serve-Raygen" not in r.headers
        png = rt.decode_png(r.read())
    cfg = rt.RenderConfig(width=20, height=14, ssaa=2, iterations=80,
                          serve_raygen=True)
    want = rt.to_uint8(rt.render(parse_scene(SCENE), cfg,
                                 device="cpu").numpy())
    np.testing.assert_array_equal(png[..., :3], want)


@pytest.mark.parametrize("query,change", [
    ("", dict(serve_raygen=True)),
    ("&serve_raygen=0", dict()),
    ("&soft_shadow_k=6", dict(serve_raygen=True, soft_shadow_k=6.0)),
    ("&ao=0.8&serve_raygen=0", dict(ao_strength=0.8)),
    ("&soft_shadow_k=6&ao=0.8",
     dict(serve_raygen=True, soft_shadow_k=6.0, ao_strength=0.8)),
    ("&soft_shadow_k=-3&ao=-1", dict(serve_raygen=True))])
def test_render_shading_parameters(server, query, change):
    """``soft_shadow_k``, ``ao`` (clamped non-negative) and
    ``serve_raygen`` answer 200 with the image of ``render_tables`` under
    the same configuration (FD normals, the server's default raygen)."""
    with _post(server + "/render?width=16&height=12&ssaa=1&iterations=80"
               + query) as r:
        assert r.status == 200
        png = rt.decode_png(r.read())
    plan, tables = compile_scene(parse_scene(SCENE))
    cfg = rt.RenderConfig(width=16, height=12, ssaa=1, iterations=80,
                          **change)
    want = rt.to_uint8(rt.render_tables(plan, tables, cfg,
                                        device="cpu").numpy())
    np.testing.assert_array_equal(png[..., :3], want)


def test_render_fractal_scene(server, scenes_dir):
    """A scene with a procedural leaf (scenes/mandelbox.txt) answers 200
    with the PNG of ``render`` (the server's default raygen path)."""
    body = (scenes_dir / "mandelbox.txt").read_text()
    with _post(server + "/render?width=16&height=12&ssaa=1&iterations=80",
               body) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "image/png"
        png = rt.decode_png(r.read())
    cfg = rt.RenderConfig(width=16, height=12, ssaa=1, iterations=80,
                          serve_raygen=True)
    want = rt.to_uint8(rt.render(parse_scene(body), cfg,
                                 device="cpu").numpy())
    np.testing.assert_array_equal(png[..., :3], want)
    assert png.max() > 0


def test_render_ppm(server):
    with _post(server + "/render?width=8&height=6&iterations=40&format=ppm"
               ) as r:
        body = r.read()
    assert body.startswith(b"P6\n8 6\n255\n")
    assert len(body.split(b"255\n", 1)[1]) == 8 * 6 * 3


@pytest.mark.parametrize("query,code", [("aperture=0.2", 200),
                                        ("width=0", 422), ("ssaa=9", 422)])
def test_render_refusals(server, query, code):
    """Out-of-range sizes answer 422; an aperture (refused before depth
    of field was ported) renders."""
    url = server + f"/render?width=8&height=6&iterations=40&{query}"
    if code == 200:
        with _post(url) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/png"
        return
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url)
    assert e.value.code == code


def test_unknown_paths_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/nowhere")
    assert e.value.code == 404


@pytest.mark.parametrize("path,item", [("/aovs", None),
                                       ("/animate", "item 12")])
def test_unported_routes_501(server, path, item):
    """No route answers 501 any more: ``/aovs`` (501 before it was ported)
    answers the JAX server's ZIP of the six planes of api.render_aovs, and
    ``/animate`` (501 before ROADMAP Queue 1 ``item`` 12 ported it) a ZIP
    of turntable PNGs."""
    url = server + f"{path}?width=8&height=6&iterations=40&reflect=0.3"
    if path == "/animate":
        with _post(url + "&frames=2") as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "application/zip"
            body = r.read()
        with zipfile.ZipFile(io.BytesIO(body)) as zf:
            assert zf.namelist() == ["frame_000.png", "frame_001.png"]
            assert rt.decode_png(zf.read("frame_001.png")).shape[:2] == (6, 8)
        return
    if item is None:
        with _post(url) as r:
            assert r.headers["Content-Type"] == "application/zip"
            body = r.read()
        with zipfile.ZipFile(io.BytesIO(body)) as zf:
            assert sorted(zf.namelist()) == sorted(AOV_MEMBERS)
            planes = {n: zf.read(n) for n in AOV_MEMBERS}
        plan, tables = compile_scene(parse_scene(SCENE))
        cfg = rt.RenderConfig(width=8, height=6, ssaa=1, iterations=40,
                              reflect_strength=0.3, serve_raygen=True)
        want = render_aovs(plan, tables, cfg, device="cpu")
        np.testing.assert_array_equal(
            rt.decode_png(planes["color.png"])[..., :3],
            rt.to_uint8(want["color"].numpy()))
        for name in ("depth", "objid", "shadow"):
            got = np.load(io.BytesIO(planes[f"{name}.npy"]))
            np.testing.assert_array_equal(got, want[name].numpy())
        assert rt.decode_png(planes["normal.png"]).shape[:2] == (6, 8)
        assert rt.decode_png(planes["hit.png"]).shape[:2] == (6, 8)


# The server's mirror and lens parameters and the configuration each gives,
# clamped as the JAX server clamps them.
MIRROR_LENS_QUERIES = {
    "bounces=2": dict(reflect_bounces=2),
    "bounces=99": dict(reflect_bounces=3),
    "focus=3.5": dict(focus_dist=3.5),
    "focus=-1": dict(focus_dist=1e-3),
    "reflect=0.3&bounces=2": dict(reflect_strength=0.3, reflect_bounces=2),
    "reflect=0.3": dict(reflect_strength=0.3),
    "aperture=0.5": dict(aperture=0.5),
    "soft_shadow_k=6&reflect=0.3": dict(soft_shadow_k=6.0,
                                        reflect_strength=0.3)}


@pytest.mark.parametrize("query", list(MIRROR_LENS_QUERIES))
def test_unported_parameters_501(server, query):
    """``reflect``, ``bounces``, ``aperture`` and ``focus`` (501 before
    mirror bounces and depth of field were ported) reach the
    configuration, clamped as the JAX server clamps them, and answer 200
    with the PNG of ``render_tables`` under it (K1's raygen bounce twin;
    an aperture takes the lens camera): never dropped."""
    with _post(server + f"/render?width=8&height=6&iterations=40&{query}"
               ) as r:
        assert r.status == 200
        png = rt.decode_png(r.read())
    plan, tables = compile_scene(parse_scene(SCENE))
    cfg = rt.RenderConfig(width=8, height=6, ssaa=1, iterations=40,
                          serve_raygen=True, **MIRROR_LENS_QUERIES[query])
    want = rt.to_uint8(rt.render_tables(plan, tables, cfg,
                                        device="cpu").numpy())
    np.testing.assert_array_equal(png[..., :3], want)


def test_server_pins_fd_normals(server):
    """The server renders with FD normals, as the JAX server does, and
    takes no normal_mode parameter."""
    q = "/render?width=12&height=8&iterations=60&normal_mode=analytic"
    with _post(server + q) as r:
        png = rt.decode_png(r.read())
    cfg = rt.RenderConfig(width=12, height=8, ssaa=1, iterations=60)
    want = rt.to_uint8(rt.render(parse_scene(SCENE), cfg,
                                 device="cpu").numpy())
    np.testing.assert_array_equal(png[..., :3], want)


def test_cli_shading_flags(tmp_path, scenes_dir):
    """``--soft-shadow-k`` and ``--ao`` render the extensions: the image of
    ``render`` with those settings."""
    out = tmp_path / "soft.pfm"
    assert cli.main(["--scene", str(scenes_dir / "config1.txt"), "--out",
                     str(out), "--device", "cpu", "--soft-shadow-k", "6",
                     "--ao", "0.8", *SMALL]) == 0
    cfg = rt.RenderConfig(width=16, height=12, ssaa=1, iterations=100,
                          soft_shadow_k=6.0, ao_strength=0.8)
    want = rt.render(rt.load_scene(str(scenes_dir / "config1.txt")), cfg,
                     device="cpu").numpy()
    np.testing.assert_array_equal(read_pfm(str(out)), want)


def test_cli_mirror_and_lens_flags(tmp_path, scenes_dir):
    """``--reflect``, ``--bounces``, ``--aperture`` and ``--focus`` render
    mirror bounces through a thin lens: the image of ``render`` with those
    settings."""
    out = tmp_path / "dof.pfm"
    assert cli.main(["--scene", str(scenes_dir / "config1.txt"), "--out",
                     str(out), "--device", "cpu", "--reflect", "0.3",
                     "--bounces", "2", "--aperture", "0.2", "--focus", "8",
                     *SMALL[:4], "--ssaa", "2", "--iterations", "100"]) == 0
    cfg = rt.RenderConfig(width=16, height=12, ssaa=2, iterations=100,
                          reflect_strength=0.3, reflect_bounces=2,
                          aperture=0.2, focus_dist=8.0)
    want = rt.render(rt.load_scene(str(scenes_dir / "config1.txt")), cfg,
                     device="cpu").numpy()
    np.testing.assert_array_equal(read_pfm(str(out)), want)


def test_cli_normal_mode_flag(tmp_path, scenes_dir, capsys):
    """``--normal-mode analytic`` renders the analytic regime: the image of
    ``render(normal_mode="analytic")``, close to the FD one."""
    outs = {}
    for mode in ("fd", "analytic"):
        out = tmp_path / f"{mode}.pfm"
        assert cli.main(["--scene", str(scenes_dir / "config1.txt"), "--out",
                         str(out), "--device", "cpu", "--normal-mode", mode,
                         *SMALL]) == 0
        outs[mode] = out
    cfg = rt.RenderConfig(width=16, height=12, ssaa=1, iterations=100,
                          normal_mode="analytic")
    want = rt.render(rt.load_scene(str(scenes_dir / "config1.txt")), cfg,
                     device="cpu").numpy()
    got = read_pfm(str(outs["analytic"]))
    np.testing.assert_array_equal(got, want)
    diff = np.abs(got - read_pfm(str(outs["fd"]))).max(axis=-1)
    assert (diff < 5e-3).mean() > 0.99
    with pytest.raises(SystemExit):
        cli.main(["--scene", "x", "--normal-mode", "sobel"])


# dests of the JAX package's CLI the port names otherwise, and why
PARSER_EXCEPTIONS = {
    # --no-shadows: the port's --shadows / --no-shadows pair (dest shadows)
    "no_shadows": "shadows",
}
# dests only the port's CLI has: the torch device (the JAX package picks
# its platform outside the CLI)
PORT_ONLY = {"device", "shadows"}


def test_cli_parser_has_every_jax_option():
    """Every option of raymarching_tpu/cli.py's parser has its counterpart
    in the port's, but those PARSER_EXCEPTIONS names; --backend is there
    with the port's value names (cuda, multi, ref, torch for mega,
    pallas, ref, jnp; the JAX package's auto has none)."""
    from raymarching_tpu import cli as jcli
    jax_dests = {a.dest for a in jcli.build_parser()._actions
                 if a.dest != "help"}
    port_dests = {a.dest for a in cli.build_parser()._actions
                  if a.dest != "help"}
    want = {PARSER_EXCEPTIONS.get(d, d) for d in jax_dests}
    assert want <= port_dests, sorted(want - port_dests)
    assert port_dests - want <= PORT_ONLY
    assert len(jax_dests) == 29
    with pytest.raises(ValueError, match="backend"):
        rt.render_tables(None, None, backend="jnp", device="cpu")
