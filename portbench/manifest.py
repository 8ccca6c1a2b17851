"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's entry
names its file; the mix is ``portbench/traffic/<traffic>.json``, run by the
runner of its ``kind``, ``portbench/runners/<kind>.py``; a per-layer
metric's reader is ``portbench/metrics/<metric>.py`` (a module with
``read(trace)``); a cell's limits are ``portbench/limits/<cell>.json``.  So a
configuration, a mix, a metric or a cell is added by adding its files and
its entries, and no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "portbench"
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_file(self, name: str) -> Path:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return self.root / c["file"]
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads(self.config_file(name).read_text())

    def traffic_file(self, name: str) -> Path:
        return self.bench / "traffic" / f"{name}.json"

    def traffic(self, name: str) -> dict:
        return json.loads(self.traffic_file(name).read_text())

    def limits_file(self, cell: str) -> Path:
        return self.bench / "limits" / f"{cell}.json"

    def metric_file(self, name: str) -> Path:
        return self.bench / "metrics" / f"{name}.py"

    def _of_cell(self, metrics: list, cell: str, e2e: set) -> list:
        """The metrics a cell reports: those that list it, or that list no
        cells and move an end-to-end metric the cell reports."""
        return [m for m in metrics
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in e2e)]

    def end_to_end(self, cell: str) -> list:
        ms = self.doc["end_to_end"]
        return [m for m in ms if "workloads" not in m
                or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return self._of_cell(self.doc["per_layer"], cell, e2e)

    def runner_file(self, kind: str) -> Path:
        return self.bench / "runners" / f"{kind}.py"

    def runner(self, kind: str):
        """The ``run`` function of traffic kind ``kind``'s runner."""
        return _load(self.runner_file(kind), "runners", kind).run

    def reader(self, name: str):
        """The ``read`` function of metric ``name``'s reader."""
        return _load(self.metric_file(name), "metrics", name).read


def _load(path: Path, group: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench.{group}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
