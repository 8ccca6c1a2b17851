"""The harness: names resolve to files, added files are found with no edit,
nothing forbidden is imported or read, and planted faults turn ``correct``
false.  CPU runs use the cells' own files with the frame shrunk."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import faults, run  # noqa: E402
from portbench.manifest import Manifest  # noqa: E402

SMALL_FRAME = dict(
    config_patch={"render": {"width": 24, "height": 16, "ssaa": 1,
                             "iterations": 300}},
    mix_patch={"check": {"frames": 2, "every": 2, "pixels": 64},
               "roofline_pixels": 4})
SMALL_FIT = dict(config_patch={"render": {"iterations": 300}},
                 mix_patch={"render": {"width": 24, "height": 16,
                                       "ssaa": 1}})
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def small(cell):
    return SMALL_FIT if cell.endswith(".fit") else SMALL_FRAME


def test_every_name_resolves_to_its_file():
    man = Manifest(ROOT)
    doc = man.doc
    for c in doc["configs"]:
        cfg = man.config(c["name"])
        assert man.config_file(c["name"]).is_file()
        assert (ROOT / cfg["scene"]).is_file()
        assert cfg["reduced"] == c["reduced"]
    for w in doc["workloads"]:
        man.config_file(w["config"])
        assert man.traffic_file(w["traffic"]).is_file()
        assert man.limits_file(w["name"]).is_file()
        kind = man.traffic(w["traffic"])["kind"]
        assert man.runner_file(kind).is_file() and callable(man.runner(kind))
        assert man.end_to_end(w["name"]) and man.per_layer(w["name"])
    for m in doc["per_layer"]:
        assert callable(man.reader(m["name"]))


def test_manifest_keeps_the_contracts_shape():
    doc = Manifest(ROOT).doc
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in doc[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in doc["end_to_end"]}
    assert "setup_s" in e2e
    for m in doc["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in doc["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_added_files_are_found_with_no_edit(tmp_path):
    """A configuration, a mix, a metric and a cell added as files and
    manifest entries run, and no file that was there changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    bench = tmp_path / "portbench"
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in bench.rglob("*") if p.is_file()}
    (bench / "scenes" / "spheres.txt").write_text(
        "Bounds 200.0\nCamera Position 0 2 8\nCamera Direction 0 -0.2 -1\n"
        "Camera Up 0 1 0\nCamera FOV 60\nLight 5 10 5\n"
        "Box 0 -1 0 40 2 40\nColor 1 0 0\nSphere 0 1 0 1\n")
    config = json.loads((bench / "configs" / "demo.json").read_text())
    config.update(name="spheres", scene="portbench/scenes/spheres.txt")
    config["render"].update(width=16, height=12, ssaa=1, iterations=200)
    (bench / "configs" / "spheres.json").write_text(json.dumps(config))
    (bench / "runners" / "orbit.py").write_text(
        "from portbench.runners import frames\n\n\n"
        "def run(ctx):\n    return frames.run(ctx)\n")
    (bench / "traffic" / "orbit8.json").write_text(json.dumps(
        {"kind": "orbit", "poses": 8,
         "check": {"frames": 2, "every": 2, "pixels": 32}}))
    (bench / "metrics" / "frames_traced.frame.py").write_text(
        "def read(tr):\n    return float(tr.units) or None\n")
    (bench / "limits" / "spheres.orbit8.json").write_text(json.dumps(
        {"px_off_share": {"limit": 0.01}, "tables_off": {"limit": 0}}))
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "spheres", "source": "a test scene",
                           "file": "portbench/configs/spheres.json",
                           "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "spheres.orbit8", "config": "spheres",
                             "traffic": "orbit8", "chips": 1,
                             "why": "a test"})
    doc["end_to_end"][0]["workloads"].append("spheres.orbit8")
    doc["per_layer"].append({"name": "frames_traced.frame", "unit": "1",
                             "better": "higher", "source": "device_trace",
                             "layer": "entry", "moves": "frame_ms",
                             "workloads": ["spheres.orbit8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    out, _ = run.run("spheres.orbit8", 5, 1.0, True, device="cpu",
                     root=tmp_path)
    assert out["correct"], out["checks"]
    assert out["metrics"]["frames_traced.frame"]["value"] == out["attempted"]
    out, _ = run.run("spheres.orbit8", 5, 1.0, False, device="cpu",
                     root=tmp_path)
    assert set(out["metrics"]) == {"frame_ms", "setup_s"}
    for p, h in before.items():
        assert hashlib.sha256(p.read_bytes()).hexdigest() == h, p


def test_no_forbidden_import_and_no_old_bench_read(tmp_path):
    """A run imports no module named jax, jaxlib, flax or raymarching_tpu
    (whole top-level names) and opens nothing of benchmarks/ or
    bench.py."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
opened = []
sys.addaudithook(lambda ev, a: opened.append(str(a[0]))
                 if ev == "open" and a and isinstance(a[0], str) else None)
from portbench import run
for cell, kw in {json.dumps({"demo.frame": SMALL_FRAME,
                             "demo.fit": SMALL_FIT})}.items():
    out, _ = run.run(cell, 9, 0.5, cell == "demo.frame", device="cpu",
                     cache_dir={str(tmp_path)!r}, **kw)
    assert out["correct"], out
print(json.dumps({{"mods": run.forbidden_modules(), "opened": opened}}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["mods"] == []
    assert not [p for p in got["opened"]
                if "benchmarks" in Path(p).parts or Path(p).name == "bench.py"]


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "demo.frame", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench import run\n"
            "print(run.run('demo.frame', 1, 0.5, False, device='cpu'))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
    assert "raymarching_tpu_torch" in res.stderr


def test_render_settings_pass_through_by_name():
    """Every setting reaches the program's RenderConfig; a name it does not
    have is refused, and so is a setting the reference does not carry
    out."""
    from portbench import harness
    cfg = harness.port_config({"width": 8, "height": 6, "ssaa": 1,
                               "ray_order": "scan", "soft_shadow_k": 4.0})
    assert (cfg.width, cfg.ray_order, cfg.soft_shadow_k) == (8, "scan", 4.0)
    with pytest.raises(ValueError, match="no_such_setting"):
        harness.port_config({"no_such_setting": 1})
    st = harness.ref_settings({"width": 8, "height": 6, "ssaa": 1,
                               "surface_precision": 2e-3,
                               "normal_mode": "fd"})
    assert (st.width, st.eps) == (8, 2e-3)
    for rs in ({"soft_shadow_k": 4.0}, {"normal_mode": "analytic"},
               {"ray_order": "scan"}):
        with pytest.raises(ValueError, match=next(iter(rs))):
            harness.ref_settings(dict(width=8, height=6, ssaa=1, **rs))


def test_perturbation_edits_name_their_rows():
    """The fit mix's edits land on the rows they name, the draws from the
    seed: the same seed the same start, another seed another one."""
    import numpy as np
    from portbench import traffic
    from portbench.reference import scene as rs
    tables = rs.load(ROOT / "portbench" / "scenes" / "demo.txt").tables()
    mix = Manifest(ROOT).traffic("fit")
    a, b = traffic.perturb(tables, mix, 7), traffic.perturb(tables, mix, 8)
    changed = {k: sorted({int(i) for i in np.nonzero(
        (np.asarray(a[k]) != np.asarray(tables[k])).reshape(
            len(tables[k]) if np.ndim(tables[k]) > 1 else 1, -1)
        .any(axis=1))[0]}) for k in tables}
    assert changed == {"prim_pos": [4], "prim_aux": [4], "prim_color": [5],
                       "light_pos": [0], "light_color": [], "cam_position": [],
                       "cam_direction": [], "cam_up": [], "cam_fov": []}
    assert tables["prim_color"][4].tolist() == [1, 0, 0]   # the red sphere
    np.testing.assert_array_equal(a["prim_pos"][4] - tables["prim_pos"][4],
                                  np.float32([1.5, -1.0, 1.0]))
    assert 0.84 <= a["prim_aux"][4, 0] / tables["prim_aux"][4, 0] <= 0.86
    assert 0.3 <= a["prim_color"][5, 0] <= 0.5
    assert a["prim_color"][5, 1:].tolist() == [1, 0]
    for k in tables:
        np.testing.assert_array_equal(traffic.perturb(tables, mix, 7)[k],
                                      a[k])
    assert a["prim_color"][5, 0] != b["prim_color"][5, 0]


@pytest.mark.parametrize("cell,fault", [
    ("demo.frame", None), *[("demo.frame", f) for f in faults.FRAME_FAULTS],
    ("demo.fit", None), *[("demo.fit", f) for f in faults.FIT_FAULTS]])
def test_a_planted_fault_is_not_correct(cell, fault, tmp_path):
    out, checks = run.run(cell, 21, 1.0, False, device="cpu",
                          cache_dir=tmp_path, fault=fault, **small(cell))
    assert out["correct"] == (fault is None), checks
    assert list(out)[-1] == "checks"


@pytest.mark.cuda
def test_a_frame_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out, checks = run.run("demo.frame", 31, 2.0, False, device="cuda:0")
    assert out["correct"], checks
    assert out["device"]["platform"] == "gpu"
