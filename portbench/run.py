#!/usr/bin/env python3
"""Run one cell of the benchmark of ``raymarching_tpu_torch`` once.

    python3 portbench/run.py --workload demo.frame --seed 7 --seconds 40 \
        --trace 0

Runs from the root of a checkout on a machine with an NVIDIA GPU: the cell's
set-up (the program's scene tables, the kernels built into ``build/kernels``
on a first run, one warm frame or step), the measured window, then the
plain reference's check of what the window produced.  The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones from a torch.profiler window), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each compared
number with its limit, which also end standard error.

Exits non-zero and prints no result when there is no CUDA device, or when
``jax``, ``jaxlib``, ``flax`` or ``raymarching_tpu`` was imported.
"""

import os
import sys
import time


def _process_start() -> float:
    """When this process started, on the host clock (its age by
    /proc/self/stat and /proc/uptime), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Bytecode of every module the run imports, torch's too, is cached inside
# the checkout (also where the environment asks Python to write none), so a
# run after the first compiles no Python source.
PYCACHE = ROOT / "build" / "pycache"

FORBIDDEN = ("jax", "jaxlib", "flax", "raymarching_tpu")


def forbidden_modules() -> list:
    """Whole top-level names in sys.modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def apply_patch(doc: dict, patch) -> None:
    """Update ``doc`` from ``patch``, a dict value updating the dict."""
    for k, v in (patch or {}).items():
        if isinstance(v, dict):
            doc.setdefault(k, {}).update(v)
        else:
            doc[k] = v


def run(cell: str, seed: int, seconds: float, trace: bool, *, device,
        root: Path = ROOT, cache_dir=None, fault=None, config_patch=None,
        mix_patch=None, t_start: float = T_START):
    """One run of ``cell``: (result dict, checks dict).  ``config_patch``
    and ``mix_patch`` (tests only) update the configuration's and the
    mix's dicts, e.g. to shrink a frame on the CPU."""
    import torch
    from portbench import check
    from portbench.harness import Ctx
    from portbench.manifest import Manifest
    man = Manifest(root)
    entry = man.cell(cell)
    config = man.config(entry["config"])
    mix = man.traffic(entry["traffic"])
    apply_patch(config, config_patch)
    apply_patch(mix, mix_patch)
    dev = torch.device(device)
    ctx = Ctx(cell=cell, config=config, mix=mix, seed=int(seed),
              seconds=float(seconds), trace=bool(trace), device=dev,
              t_start=t_start, root=Path(root),
              cache_dir=Path(cache_dir or Path(root) / "build"
                             / "portbench"), fault=fault)
    res = man.runner(mix["kind"])(ctx)
    print("set-up: " + "; ".join(f"{what} {t:.2f} s" for what, t in ctx.marks),
          file=sys.stderr)
    correct, checks = check.judge(res.numbers,
                                  check.load_limits(man.limits_file(cell)))
    metrics = {}
    if trace:
        for m in man.per_layer(cell):
            v = man.reader(m["name"])(res.trace)
            if v is None:
                print(f"metric {m['name']}: nothing to read in the trace",
                      file=sys.stderr)
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in man.end_to_end(cell):
            metrics[m["name"]] = {"value": res.e2e[m["name"]],
                                  "unit": m["unit"]}
    cuda = dev.type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": int(entry["chips"]),
            "memory_peak_bytes": res.memory_peak}
    if trace:
        info["busy_s"] = res.trace.busy_s
        info["window_s"] = res.trace.window_s
    out = {"correct": bool(correct), "attempted": res.attempted,
           "failed": res.failed, "metrics": metrics, "device": info}
    if trace:
        out["breakdown"] = res.trace.breakdown()
    out["checks"] = checks
    return out, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    import torch
    from portbench.manifest import Manifest
    chips = int(Manifest(ROOT).cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result, checks = run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda:0")
    found = forbidden_modules()
    if found:
        print(f"modules that the run may not import: {found}",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
