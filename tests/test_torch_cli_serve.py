"""Port entry points: the CLI, the HTTP server, and the refusals (an
unsupported configuration raises, a missing CUDA device is an error)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu.io.png import read_png  # noqa: E402
from raymarching_tpu_torch.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu_torch.scene.parser import parse_scene  # noqa: E402
from raymarching_tpu_torch import cli  # noqa: E402
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


def test_cli_writes_png_on_cpu(tmp_path, scenes_dir, capsys):
    out = tmp_path / "out.png"
    rc = cli.main(["--scene", str(scenes_dir / "config1.txt"), "--out",
                   str(out), "--device", "cpu", "--backend", "ref,cuda",
                   "--compare", *SMALL])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape[:2] == (12, 16) and img.max() > 0
    assert "max |cuda - ref|" in capsys.readouterr().out


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
    dict(normal_mode="analytic", soft_shadow_k=8.0),
    dict(fused_generators=True, reflect_strength=0.3),
    dict(soft_shadow_k=8.0), dict(ao_strength=0.5),
    dict(reflect_strength=0.3), dict(aperture=0.2),
    dict(serve_raygen=True)])
def test_unsupported_config_raises(change, scenes_dir):
    scene = rt.load_scene(str(scenes_dir / "config1.txt"))
    cfg = rt.RenderConfig(width=4, height=4, ssaa=1, **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rt.render(scene, cfg, device="cpu")


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
    cfg = rt.RenderConfig(width=4, height=4, ssaa=1)
    for name in ("mandelbox", "julia"):
        with pytest.raises(NotImplementedError):
            rt.render(rt.load_scene(str(scenes_dir / f"{name}.txt")), cfg,
                      device="cpu")
    plan, tables = compile_scene(rt.load_scene(str(scenes_dir /
                                                   "config1.txt")))
    grad_tables = type(tables)(*(torch.tensor(v, requires_grad=True)
                                 for v in tables))
    # gradients run on the cuda backend; the differentiable ref oracle is
    # not ported
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 3"):
        rt.render_tables(plan, grad_tables, cfg, backend="ref",
                         differentiable=True, device="cpu")


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
    q = "/render?width=20&height=14&ssaa=2&iterations=80&serve_raygen=1"
    with _post(server + q) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "image/png"
        assert r.headers["X-Serve-Raygen"] == "ignored"
        png = rt.decode_png(r.read())
    cfg = rt.RenderConfig(width=20, height=14, ssaa=2, iterations=80)
    want = rt.to_uint8(rt.render(parse_scene(SCENE), cfg,
                                 device="cpu").numpy())
    np.testing.assert_array_equal(png[..., :3], want)


def test_render_ppm(server):
    with _post(server + "/render?width=8&height=6&iterations=40&format=ppm"
               ) as r:
        body = r.read()
    assert body.startswith(b"P6\n8 6\n255\n")
    assert len(body.split(b"255\n", 1)[1]) == 8 * 6 * 3


@pytest.mark.parametrize("query,code", [("ao=0.5", 501), ("width=0", 422),
                                        ("ssaa=9", 422)])
def test_render_refusals(server, query, code):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + f"/render?width=8&height=6&iterations=40&{query}")
    assert e.value.code == code


def test_unknown_paths_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/nowhere")
    assert e.value.code == 404


@pytest.mark.parametrize("path,item", [("/aovs", "item 9"),
                                       ("/animate", "item 12")])
def test_unported_routes_501(server, path, item):
    """The JAX server's other routes answer 501 and name the ROADMAP item
    they wait for, not 404."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + f"{path}?width=8&height=6&iterations=40")
    assert e.value.code == 501
    assert item in json.loads(e.value.read())["error"]


@pytest.mark.parametrize("query", ["bounces=2", "bounces=99", "focus=3.5",
                                   "focus=-1", "reflect=0.3&bounces=2"])
def test_unported_parameters_501(server, query):
    """``bounces`` and ``focus`` reach the configuration (clamped as the
    JAX server clamps them) and are refused with 501, their features
    (mirror bounces, depth of field) not being ported: never dropped."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + f"/render?width=8&height=6&iterations=40&{query}")
    assert e.value.code == 501
    assert "ROADMAP Queue 1 item 9" in json.loads(e.value.read())["error"]


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
