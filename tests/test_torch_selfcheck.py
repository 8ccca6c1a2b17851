"""The port's ops utilities against the JAX package's, on the CPU: the
failure checks of ``utils/selfcheck.py`` (a bitwise re-render that finds
and places an injected fault, an oracle check against the ``ref``
backend that catches a consistently wrong render), ``utils/debug.py``,
``utils/timing.Phase`` and ``profiler_trace``, and the CLI's
``--log-json``, ``--selfcheck``, ``--stats``, ``--row-block``,
``--animate``, ``--ray-chunk`` and ``--profile``: twins of
tests/test_observability.py and tests/test_cli_io.py's TestUtils."""

import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_util import one_torch_thread  # noqa: E402,F401

from raymarching_tpu.utils import debug as jdebug  # noqa: E402
from raymarching_tpu.utils import selfcheck as jsc  # noqa: E402
import raymarching_tpu_torch as rt  # noqa: E402
import raymarching_tpu_torch.api as api  # noqa: E402
from raymarching_tpu_torch import cli  # noqa: E402
from raymarching_tpu_torch.api import render_tiled  # noqa: E402
from raymarching_tpu_torch.io import gif as tgif  # noqa: E402
from raymarching_tpu_torch.io.image import read_pfm, to_uint8  # noqa: E402
from raymarching_tpu_torch.utils import debug, structlog, timing  # noqa: E402
from raymarching_tpu_torch.utils import selfcheck as sc  # noqa: E402

CFG = rt.RenderConfig(width=24, height=16, ssaa=1, iterations=80)
SMALL = ["--width", "16", "--height", "12", "--ssaa", "1",
         "--iterations", "60", "--device", "cpu"]


@pytest.fixture(scope="module")
def scene():
    return rt.compile_scene(rt.load_scene("scenes/config3.txt"))


@pytest.fixture()
def log_stream():
    stream = io.StringIO()
    structlog.configure(stream=stream)
    yield stream
    structlog.reset()


def test_rerun_check_passes_and_reports(scene, log_stream):
    plan, tables = scene
    report = sc.rerun_check(plan, tables, CFG, repeats=3, device="cpu")
    assert report["ok"] and report["mismatches"] == []
    assert report["rays"] == CFG.rays_per_image
    rec = json.loads(log_stream.getvalue())
    assert rec["event"] == "selfcheck" and rec["check"] == "rerun"


def test_rerun_check_localizes_injected_corruption(scene, monkeypatch):
    """One flipped value is one mismatching tile, as JAX's check places
    it; end to end through a render that corrupts its second frame."""
    plan, tables = scene
    base = np.zeros((72, 96, 3), np.float32)
    flipped = base.copy()
    flipped[40, 70, 1] += 1e-3
    assert sc._tile_mismatches(base, flipped, (64, 64)) == \
        jsc._tile_mismatches(base, flipped, (64, 64)) == [(0, 64, 1)]
    imgs = iter([torch.from_numpy(base), torch.from_numpy(flipped)])
    monkeypatch.setattr(api, "render_tables", lambda *a, **k: next(imgs))
    report = sc.rerun_check(plan, tables, CFG, device="cpu")
    assert not report["ok"]
    assert report["mismatches"][0]["tiles"] == [(0, 64, 1)]


def test_oracle_check_passes_and_detects_wrong_function(scene, monkeypatch):
    plan, tables = scene
    report = sc.oracle_check(plan, tables, CFG, device="cpu")
    assert report["ok"] and report["resolution"] == [32, 32]
    assert report["bad_pixel_frac"] == 0.0
    real = api.render_tables

    def corrupted(plan_, tables_, cfg_, *, backend="cuda", **kw):
        img = real(plan_, tables_, cfg_, backend=backend, **kw)
        return img if backend == "ref" else img + 0.1

    monkeypatch.setattr(api, "render_tables", corrupted)
    assert not sc.oracle_check(plan, tables, CFG, device="cpu")["ok"]
    with pytest.raises(RuntimeError, match="selfcheck failed"):
        sc.assert_healthy(plan, tables, CFG, device="cpu")


def test_assert_healthy_roundtrip(scene):
    plan, tables = scene
    report = sc.assert_healthy(plan, tables, CFG, backend="multi",
                               device="cpu")
    assert report["ok"] and report["rerun"]["repeats"] == 2


def test_check_finite_and_debug_nans():
    """check_finite raises as JAX's does, on tensors, arrays and nested
    containers; debug_nans makes a NaN backward raise, and restores."""
    for mod in (debug, jdebug):
        with pytest.raises(FloatingPointError, match="non-finite"):
            mod.check_finite({"a": np.array([1.0, np.nan])}, "t")
        mod.check_finite({"a": np.array([1.0, 2.0])})
    with pytest.raises(FloatingPointError, match="leaf 2 has 1"):
        debug.check_finite([torch.ones(2), (np.zeros(3),
                            torch.tensor([0.0, float("inf")]))], "t")
    assert not torch.is_anomaly_enabled()
    x = torch.tensor([0.0], requires_grad=True)
    with debug.debug_nans():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"), pytest.warns(
                UserWarning, match="anomaly"):
            (torch.sqrt(x) * 0.0).sum().backward()
    assert not torch.is_anomaly_enabled()


def test_print_v3(capsys):
    debug.print_v3("p", torch.tensor([1.0, 2.0, 3.0]))
    assert capsys.readouterr().out.strip() == "p: 1.0 2.0 3.0"


def test_phase_timing_and_sync(capsys):
    with timing.Phase("x", rays=1000) as ph:
        out = ph.sync({"a": torch.zeros(3), "b": [torch.ones(2), 5]})
    assert "[x]" in capsys.readouterr().out
    assert ph.seconds >= 0
    assert isinstance(out["a"], np.ndarray) and out["b"][1] == 5
    with timing.Phase("quiet", verbose=False):
        pass
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError):
        with timing.Phase("render", rays=10, verbose=False):
            raise ValueError("original error")


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "prof"
    with timing.profiler_trace(str(logdir)):
        torch.ones(8).sum()
    (trace,) = logdir.glob("trace_*.json")
    assert "traceEvents" in json.loads(trace.read_text())
    with timing.profiler_trace(None):     # no logdir: nothing recorded
        pass


def test_cli_log_json_selfcheck_stats(tmp_path, capsys):
    out, logp = tmp_path / "out.png", tmp_path / "log.jsonl"
    assert cli.main(["--scene", "scenes/config3.txt", "--out", str(out),
                     "--log-json", str(logp), "--selfcheck", "--stats",
                     *SMALL]) == 0
    assert out.exists()
    events = [json.loads(ln) for ln in logp.read_text().splitlines()]
    names = [e["event"] for e in events]
    assert names[0] == "start" and names[-1] == "done"
    assert "scene" in names and "render" in names
    assert names.count("selfcheck") == 2
    assert next(e for e in events if e["event"] == "render")[
        "mrays_per_s"] > 0
    text = capsys.readouterr().out
    assert "selfcheck ok" in text
    stats = json.loads(text.split("march stats (primary rays, reduced "
                                  "res): ")[1].splitlines()[0])
    assert stats["rays"] == 16 * 12 and "steps" in stats
    assert structlog.get_logger() is None     # closed when main returns


def test_cli_selfcheck_failure_exits_3(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("selfcheck failed: injected")

    monkeypatch.setattr(sc, "assert_healthy", broken)
    out = tmp_path / "x.png"
    assert cli.main(["--scene", "scenes/config1.txt", "--out", str(out),
                     "--selfcheck", *SMALL]) == 3
    assert not out.exists()


def test_cli_row_block_and_ray_chunk(tmp_path):
    """--row-block writes render_tiled's frame, --ray-chunk renders the
    same bits as one launch."""
    out, chunked = tmp_path / "t.pfm", tmp_path / "c.pfm"
    assert cli.main(["--scene", "scenes/config3.txt", "--out", str(out),
                     "--row-block", "5", *SMALL]) == 0
    assert cli.main(["--scene", "scenes/config3.txt", "--out", str(chunked),
                     "--ray-chunk", "50", *SMALL]) == 0
    plan, tables = rt.compile_scene(rt.load_scene("scenes/config3.txt"))
    cfg = rt.RenderConfig(width=16, height=12, ssaa=1, iterations=60)
    np.testing.assert_array_equal(read_pfm(str(out)), render_tiled(
        plan, tables, cfg, row_block=5, device="cpu"))
    np.testing.assert_array_equal(read_pfm(str(chunked)), rt.render_tables(
        plan, tables, cfg, device="cpu").numpy())


def test_cli_animate_gif_frames_and_refusals(tmp_path):
    """--animate N writes a GIF of turntable_frames' frames, or numbered
    frames; it refuses --compare, a backend list and --row-block."""
    gif = tmp_path / "a.gif"
    assert cli.main(["--scene", "scenes/config1.txt", "--out", str(gif),
                     "--animate", "3", "--orbit", "90", "--delay-cs", "7",
                     *SMALL]) == 0
    plan, tables = rt.compile_scene(rt.load_scene("scenes/config1.txt"))
    cfg = rt.RenderConfig(width=16, height=12, ssaa=1, iterations=60)
    frames = list(api.turntable_frames(plan, tables, cfg, 3,
                                       orbit=np.pi / 2, device="cpu"))
    assert gif.read_bytes() == tgif.encode_gif(
        [to_uint8(f) for f in frames], delay_cs=7)
    assert cli.main(["--scene", "scenes/config1.txt", "--out",
                     str(tmp_path / "f.pfm"), "--animate", "2", *SMALL]) == 0
    np.testing.assert_array_equal(read_pfm(str(tmp_path / "f_001.pfm")),
                                  list(api.turntable_frames(
                                      plan, tables, cfg, 2,
                                      device="cpu"))[1])
    for extra in (["--compare"], ["--backend", "ref,cuda"],
                  ["--row-block", "4"]):
        assert cli.main(["--scene", "scenes/config1.txt", "--out",
                         str(tmp_path / "n.gif"), "--animate", "2", *SMALL,
                         *extra]) == 2
    assert not (tmp_path / "n.gif").exists()


def test_cli_profile_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    assert cli.main(["--scene", "scenes/config1.txt", "--out",
                     str(tmp_path / "p.png"), "--profile", str(logdir),
                     *SMALL]) == 0
    assert len(os.listdir(logdir)) == 1
