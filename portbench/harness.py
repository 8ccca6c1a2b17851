"""What every runner shares: the run's context and result, the render
settings handed to the program and to the reference, the scene both sides
read, the clock and the device's memory.

A runner is ``portbench/runners/<kind>.py`` with ``run(ctx) -> Run``; the
mix's ``kind`` names it.  It builds the program's objects from the cell's
configuration and mix, warms the cell's one shape, runs the window (traced
or not), reads the peak memory, frees the program's state, and then has the
reference check what the window produced.  Only the program
(``raymarching_tpu_torch``) is imported from outside ``portbench/``.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional

import torch

from . import check
from .reference import scene as ref_scene_mod
from .reference.render import Settings

# The reference's name of each render setting it carries out.
REF_SETTINGS = {"width": "width", "height": "height", "ssaa": "ssaa",
                "iterations": "iterations", "surface_precision": "eps",
                "offset_precision": "offset", "saturation": "saturation",
                "fd_h": "fd_h", "shadows": "shadows"}


@dataclasses.dataclass
class Ctx:
    cell: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float          # the process's start, host clock
    root: Path              # the checkout
    cache_dir: Path         # the benchmark's cache (the fit's target)
    fault: Optional[str] = None
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, what: str) -> None:
        """Note the end of a phase of set-up (printed to stderr)."""
        self.marks.append((what, now() - self.t_start))


@dataclasses.dataclass
class Run:
    attempted: int
    failed: int
    e2e: dict               # end-to-end metric name -> value
    numbers: dict           # compared number -> value
    memory_peak: int
    trace: object = None    # trace.Trace of a traced run


def now() -> float:
    return time.time()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def render_settings(ctx: Ctx) -> dict:
    """The configuration's render settings, updated by the mix's."""
    rs = dict(ctx.config["render"])
    rs.update(ctx.mix.get("render", {}))
    return rs


def port_config(rs: dict):
    """The program's ``RenderConfig`` of every setting in ``rs``; a name
    that is not one of its fields is refused."""
    from raymarching_tpu_torch.config import RenderConfig
    known = {f.name for f in dataclasses.fields(RenderConfig)}
    unknown = sorted(set(rs) - known)
    if unknown:
        raise ValueError(f"render settings the program does not have: "
                         f"{unknown}")
    return RenderConfig(**rs)


def ref_settings(rs: dict) -> Settings:
    """The reference's settings of ``rs``.  A setting the reference does
    not carry out is refused, so that no run compares what the reference
    cannot render."""
    other = sorted(k for k in rs if k not in REF_SETTINGS
                   and not (k == "normal_mode" and rs[k] == "fd"))
    if other:
        raise ValueError(f"render settings the reference does not carry "
                         f"out: {other}")
    return Settings(**{REF_SETTINGS[k]: v for k, v in rs.items()
                       if k in REF_SETTINGS})


def program_scene(ctx: Ctx):
    """The program's plan and tables of the configuration's frozen scene,
    the reference's reading of it, and the count of table elements where
    the two differ."""
    from raymarching_tpu_torch.scene.compile import compile_scene
    from raymarching_tpu_torch.scene.parser import load_scene
    path = ctx.root / ctx.config["scene"]
    ctx.mark("program imported")
    plan, tables = compile_scene(load_scene(str(path)))
    ctx.mark("scene compiled")
    scene = ref_scene_mod.load(path)
    return plan, tables, scene, check.tables_off(tables._asdict(),
                                                 scene.tables())


def peak_memory(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
