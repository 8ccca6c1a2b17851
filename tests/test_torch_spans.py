"""The port's profiler spans (``utils.timing.span``): free and built from
nothing when no profiler records; under ``torch.profiler`` on the CPU a
render and a fit emit their ``rt.`` spans, nested as the layers are; and
``Phase`` prints as it did and opens its own span under a profiler."""

import json
import re
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch_util import one_torch_thread  # noqa: E402,F401

import raymarching_tpu_torch as rt  # noqa: E402
from raymarching_tpu_torch.config import RenderConfig  # noqa: E402
from raymarching_tpu_torch.scene.compile import compile_scene  # noqa: E402
from raymarching_tpu_torch.scene.parser import load_scene  # noqa: E402
from raymarching_tpu_torch.tables import (scene_operands,  # noqa: E402
                                          tables_to_torch)
from raymarching_tpu_torch.utils import timing  # noqa: E402

SCENES = Path(__file__).resolve().parent.parent / "scenes"
CFG = RenderConfig(width=24, height=16, ssaa=1, iterations=100)


def _spans(prof, tmp_path, prefix="rt.") -> dict:
    """The profile's events named ``prefix...`` by name, from its Chrome
    trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    by = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith(prefix):
            by.setdefault(e["name"], []).append(e)
    return by


def _inside(a, b) -> bool:
    return (a["tid"] == b["tid"] and b["ts"] <= a["ts"]
            and a["ts"] + a["dur"] <= b["ts"] + b["dur"])


def _each_inside(by, name, outer) -> bool:
    return all(any(_inside(a, b) for b in by[outer]) for a in by[name])


def test_span_without_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record function was built")

    monkeypatch.setattr(timing, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    a, b = timing.span("rt.render"), timing.span("rt.k1")
    assert a is b is timing._OFF
    with a, b:
        pass


@pytest.fixture(scope="module")
def demo():
    return compile_scene(load_scene(str(SCENES / "demo.txt")))


def test_render_and_fit_spans_nest_by_layer(demo, tmp_path):
    plan, tables = demo
    target = rt.render_tables(plan, tables, CFG, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rt.render_tables(plan, tables, CFG, device="cpu")
        rt.fit(plan, tables, target * 0.9, CFG, device="cpu", steps=2)
    by = _spans(prof, tmp_path)
    assert {"rt.render", "rt.camera", "rt.k1", "rt.fit.step",
            "rt.fit.backward", "rt.fit.optimizer", "rt.bwd",
            "rt.bwd.replay", "rt.bwd.scatter"} <= set(by)
    # one frame and two steps' renders; each render's two camera pieces
    assert len(by["rt.render"]) == 3 and len(by["rt.k1"]) == 3
    assert len(by["rt.camera"]) == 6
    assert len(by["rt.fit.step"]) == 2
    for name, outer in [("rt.camera", "rt.render"), ("rt.k1", "rt.render"),
                        ("rt.fit.backward", "rt.fit.step"),
                        ("rt.fit.optimizer", "rt.fit.step"),
                        ("rt.bwd", "rt.fit.backward"),
                        ("rt.bwd.replay", "rt.bwd"),
                        ("rt.bwd.scatter", "rt.bwd")]:
        assert _each_inside(by, name, outer), (name, outer)
    # the fit's two renders are its steps' forwards
    assert sum(any(_inside(r, s) for s in by["rt.fit.step"])
               for r in by["rt.render"]) == 2


def test_scene_operands_opens_its_span(demo, tmp_path):
    """The operands are built only for a CUDA launch (the CPU path takes
    the plain twins), so they are called here directly."""
    plan, tables = demo
    tt = tables_to_torch(tables, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scene_operands(plan, tt, "cpu")
    assert len(_spans(prof, tmp_path)["rt.scene_operands"]) == 1


def test_phase_prints_as_before_and_opens_its_span(capsys, tmp_path):
    with timing.Phase("load", rays=2_000_000):
        time.sleep(0.01)
    assert re.fullmatch(r"\[load\] \d+\.\d{3} s  \(\d+\.\d{3} Mrays/s\)\n",
                        capsys.readouterr().out)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.Phase("save", verbose=False) as ph:
            torch.ones(4).mul_(2)
    assert ph.seconds > 0 and capsys.readouterr().out == ""
    assert len(_spans(prof, tmp_path, "save")["save"]) == 1
