"""The traced window: torch.profiler around the measured loop, read back
from its Chrome trace into device records the metric readers take.

The window itself is a span of the benchmark's own, ``portbench.window``
(``torch.profiler.record_function``), so the device records are clipped to
the host's window in the trace's own clock.  ``busy_s`` is the union of the
device's kernels, copies and sets inside it; ``window_s`` its length.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import List, NamedTuple, Optional

WINDOW_SPAN = "portbench.window"
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Kernel(NamedTuple):
    name: str
    start: float        # us, trace clock
    dur: float          # us
    op: Optional[str]   # the CPU op that launched it, where the trace says


class Window:
    """Profile the code inside ``with Window(on):``; ``open()`` and
    ``close()`` mark the measured window (call ``close`` after the last
    synchronize).  With ``on`` false it does nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.span = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            import torch
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def open(self):
        if self.on:
            from torch.profiler import record_function
            self.span = record_function(WINDOW_SPAN)
            self.span.__enter__()

    def close(self):
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None

    def __exit__(self, *exc):
        self.close()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def read(self) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        return Trace.of(doc.get("traceEvents", doc)
                        if isinstance(doc, dict) else doc)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device records of the window: ``kernels`` (every kernel, copy and
    set inside it), ``window_s``, ``busy_s``, the idle gaps and the host op
    running across each."""

    def __init__(self, kernels: List[Kernel], w0: float, w1: float,
                 host_ops: list):
        self.kernels = kernels
        self.w0, self.w1 = w0, w1
        self.window_s = (w1 - w0) / 1e6
        busy = _union([(max(k.start, w0), min(k.start + k.dur, w1))
                       for k in kernels])
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        gaps, prev = [], w0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
        self.gaps = gaps
        self.host_ops = sorted(host_ops)   # (start, end, name)
        self.units = 0                     # frames or steps in the window
        self.seen = {}                     # what the runner saw (its kind's)

    @classmethod
    def of(cls, events) -> "Trace":
        ops_by_id, host_ops, raw = {}, [], []
        w0 = w1 = None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev.get("ts", 0)), float(ev.get("dur", 0))
            if ev.get("name") == WINDOW_SPAN:
                w0, w1 = ts, ts + dur
            elif cat == "cpu_op":
                ext = (ev.get("args") or {}).get("External id")
                if ext is not None:
                    ops_by_id.setdefault(ext, ev["name"])
                host_ops.append((ts, ts + dur, ev["name"]))
            elif cat in GPU_CATS:
                raw.append(ev)
        if w0 is None:
            raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
        kernels = []
        for ev in raw:
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0))
            if ts + dur <= w0 or ts >= w1:
                continue
            ext = (ev.get("args") or {}).get("External id")
            kernels.append(Kernel(ev["name"], ts, dur, ops_by_id.get(ext)))
        return cls(kernels, w0, w1, host_ops)

    def device_s(self, pred) -> float:
        """Seconds of the window's device records for which ``pred(k)``."""
        return sum(min(k.start + k.dur, self.w1) - max(k.start, self.w0)
                   for k in self.kernels if pred(k)) / 1e6

    def count(self, pred) -> int:
        return sum(1 for k in self.kernels if pred(k))

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for k in self.kernels:
            by_name[k.name] = by_name.get(k.name, 0.0) + k.dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        starts = [o[0] for o in self.host_ops]
        by_host = {}
        # a gap is named by the innermost host op running across its middle:
        # the latest-starting op among the last few that still runs there
        for s, e in self.gaps:
            mid, name = (s + e) / 2, "host: no op"
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(i - 64, -1), -1):
                if self.host_ops[j][1] >= mid:
                    name = self.host_ops[j][2]
                    break
            by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e6
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}
