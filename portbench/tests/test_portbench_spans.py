"""The span readers: ``_spans.idle_by_span`` splits each idle gap by the
innermost open ``rt.`` span, on any thread, and its parts add up to the
idle time; the program's spans change no reading of the readers that were
there before them; a shrunk traced run of each cell on the CPU holds every
span its readers read, and its readers read every span its idle time
falls under."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.manifest import Manifest  # noqa: E402
from portbench.metrics import _spans  # noqa: E402
from portbench.trace import WINDOW_SPAN, Trace, Window  # noqa: E402

SMALL_FRAME = dict(
    config_patch={"render": {"width": 24, "height": 16, "ssaa": 1,
                             "iterations": 300}},
    mix_patch={"check": {"frames": 2, "every": 2, "pixels": 64},
               "roofline_pixels": 4})
SMALL_FIT = dict(config_patch={"render": {"iterations": 300}},
                 mix_patch={"render": {"width": 24, "height": 16,
                                       "ssaa": 1}})
# the span each reader reads; None: idle time under no span
READS = {"operands_idle_ms.frame": "rt.scene_operands",
         "camera_idle_ms.frame": "rt.camera",
         "k1_host_idle_ms.frame": "rt.k1",
         "render_idle_ms.frame": "rt.render",
         "unspanned_idle_ms.frame": None,
         "replay_idle_ms.fit": "rt.bwd.replay",
         "scatter_idle_ms.fit": "rt.bwd.scatter",
         "autograd_idle_ms.fit": "rt.fit.backward",
         "optimizer_idle_ms.fit": "rt.fit.optimizer",
         "camera_idle_ms.fit": "rt.camera",
         "operands_idle_ms.fit": "rt.scene_operands",
         "k1_host_idle_ms.fit": "rt.k1",
         "render_idle_ms.fit": "rt.render",
         "step_idle_ms.fit": "rt.fit.step",
         "bwd_idle_ms.fit": "rt.bwd",
         "unspanned_idle_ms.fit": None}
EARLIER = ("k1_device_ms.frame", "k1_roofline_pct.frame",
           "camera_device_ms.frame", "device_idle_pct.frame",
           "k1_device_ms.fit", "k2_device_ms.fit", "scatter_device_ms.fit",
           "device_idle_pct.fit")


def _x(name, cat, ts, end, tid=1, ext=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
          "tid": tid}
    if ext is not None:
        ev["args"] = {"External id": ext}
    return ev


# A window of 1,000 us: K1 and K2's stencil, the parameter scatter, one
# elementwise kernel; the fused backward's spans on autograd's device
# thread (tid 2) inside rt.fit.backward on the main one; a span outside
# the window and one that starts before it.
KERNELS = [_x("render_kernel<SharedScene>", "kernel", 100, 400, 7, 91),
           _x("surface_kernel<0, true>", "kernel", 380, 400, 7, 14),
           _x("indexFuncLargeIndex<double>", "kernel", 500, 600, 7, 12),
           _x("elementwise_kernel<MulFunctor>", "kernel", 700, 750, 7, 13)]
OPS = [_x(WINDOW_SPAN, "user_annotation", 0, 1000, ext=1),
       _x("aten::mul", "cpu_op", 20, 55, ext=21),
       _x("aten::index_add_", "cpu_op", 490, 520, 2, 12),
       _x("aten::mul", "cpu_op", 685, 695, 2, 13)]
SPANS = [_x("rt.fit.step", "cpu_op", -50, 950, ext=30),
         _x("rt.render", "cpu_op", 10, 300, ext=31),
         _x("rt.camera", "cpu_op", 10, 60, ext=32),
         _x("rt.k1", "cpu_op", 60, 290, ext=91),
         _x("rt.scene_operands", "cpu_op", 70, 95, ext=33),
         _x("rt.fit.backward", "cpu_op", 400, 900, ext=34),
         _x("rt.bwd", "cpu_op", 420, 680, 2, 35),
         _x("rt.bwd.replay", "cpu_op", 430, 470, 2, 36),
         _x("rt.bwd.scatter", "cpu_op", 480, 650, 2, 37),
         _x("rt.fit.optimizer", "cpu_op", 900, 940, ext=38),
         _x("rt.render", "cpu_op", 1100, 1200, ext=39)]
# us by innermost span over the gaps [0, 100), [400, 500), [600, 700),
# [750, 1000): 550 us idle in all
SPLIT = {"rt.fit.step": 20, "rt.camera": 50, "rt.k1": 15,
         "rt.scene_operands": 25, "rt.fit.backward": 190, "rt.bwd": 50,
         "rt.bwd.replay": 40, "rt.bwd.scatter": 70, "rt.fit.optimizer": 40,
         None: 50}


def _trace(spans=True) -> Trace:
    tr = Trace.of(KERNELS + OPS + (SPANS if spans else []))
    tr.units = 2
    return tr


def test_idle_splits_by_the_innermost_span_on_any_thread():
    tr = _trace()
    got = _spans.idle_by_span(tr)
    assert set(got) == set(SPLIT)
    for name, us in SPLIT.items():
        assert got[name] == pytest.approx(us / 1e6), name
    assert sum(got.values()) == pytest.approx(tr.window_s - tr.busy_s)
    man = Manifest(ROOT)
    for metric, name in READS.items():
        assert man.reader(metric)(tr) == pytest.approx(
            1e3 * SPLIT.get(name, 0) / 1e6 / tr.units), metric


def test_readers_read_nothing_without_spans():
    tr = _trace(spans=False)
    assert _spans.idle_by_span(tr) == {None: pytest.approx(550e-6)}
    man = Manifest(ROOT)
    for metric in READS:
        assert man.reader(metric)(tr) is None, metric


def test_spans_leave_the_earlier_readings_as_they_were():
    """The spans are host ops of the trace: the earlier readers read the
    same, and the breakdown names a gap that no aten op runs across by
    its innermost span instead of "host: no op"."""
    man = Manifest(ROOT)
    with_, without = _trace(), _trace(spans=False)
    for metric in EARLIER:
        reader = man.reader(metric)
        assert reader(with_) == reader(without), metric
    a, b = with_.breakdown(), without.breakdown()
    assert a["device_ops"] == b["device_ops"]
    named, bare = dict(a["idle_gaps"]), dict(b["idle_gaps"])
    spanned = {n: s for n, s in named.items() if n.startswith("rt.")}
    assert spanned and "host: no op" in bare
    assert bare.pop("host: no op") == pytest.approx(
        named.pop("host: no op", 0.0) + sum(spanned.values()))
    assert bare == {n: s for n, s in named.items() if n not in spanned}


@pytest.mark.parametrize("cell", ["demo.frame", "demo.fit"])
def test_a_traced_cpu_run_holds_the_spans_its_readers_read(
        cell, tmp_path, monkeypatch):
    """Every reader of the cell finds its span in a shrunk traced run on
    the CPU, but ``rt.scene_operands``: the CPU path takes the kernels'
    plain twins, which read no operands (the card's test holds it).  The
    cell's readers read every span the idle time falls under, so their
    readings add up to the cell's idle time."""
    got = {}
    read = Window.read

    def keep(self):
        got["tr"] = read(self)
        return got["tr"]

    monkeypatch.setattr(Window, "read", keep)
    out, checks = run.run(cell, 2147483647 + 5, 0.5, True, device="cpu",
                          cache_dir=tmp_path, **(SMALL_FIT if cell.endswith(
                              ".fit") else SMALL_FRAME))
    assert out["correct"], checks
    tr = got["tr"]
    names = {n for _, _, n in _spans.spans(tr)}
    metrics = [m["name"] for m in Manifest(ROOT).per_layer(cell)
               if m["name"] in READS]
    assert len(metrics) == (5 if cell == "demo.frame" else 11)
    spans_read = {READS[m] for m in metrics}
    assert spans_read - {None, "rt.scene_operands"} <= names
    split = _spans.idle_by_span(tr)
    assert set(split) <= spans_read and set(split) <= names | {None}
    assert sum(split.values()) == pytest.approx(tr.window_s - tr.busy_s)
