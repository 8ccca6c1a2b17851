#!/usr/bin/env python3
"""Readings that set the limits of ``correct``: the control and the faults.

    python3 portbench/controls.py --workload demo.frame --seeds 11 12 13
    python3 portbench/controls.py --workload demo.fit --seeds 11 12 13 \
        --fault half

The control is the plain reference put in the program's place, computed in
the precision below the configuration's float32: bfloat16.  For a frame cell
it renders the pixels a run compares (the same seeded poses and pixels) and
is compared with the float32 reference, as a run compares the program.  For
the fit it takes the fit's checked first step at the cell's size.  With
``--fault`` the cell runs with that fault planted under the timed path
(``faults.py``) and a short window.  Each reading prints as one JSON line.
Not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _cell(man, cell: str, config_patch, mix_patch):
    """The cell's configuration and mix (patched), its reference
    settings, scene and tables."""
    from portbench.harness import ref_settings
    from portbench.reference import scene as rs
    from portbench.run import apply_patch
    entry = man.cell(cell)
    config, mix = man.config(entry["config"]), man.traffic(entry["traffic"])
    apply_patch(config, config_patch)
    apply_patch(mix, mix_patch)
    st = ref_settings(dict(config["render"], **mix.get("render", {})))
    scene = rs.load(man.root / config["scene"])
    return config, mix, st, scene, scene.tables()


def frame_control(man, cell: str, seed: int, device, config_patch=None,
                  mix_patch=None, dtype=None) -> dict:
    """px_off_share of the reference in ``dtype`` (bfloat16) against the
    float32 reference on the pixels a run of ``cell`` with ``seed``
    compares, at the poses of the first frames it keeps (which ones a run
    keeps depends on its speed; any orbit pose stands for them)."""
    import torch
    from portbench import check, traffic
    from portbench.reference.field import Field
    from portbench.reference.render import render_pixels, tables_on
    _, mix, st, scene, tables = _cell(man, cell, config_patch, mix_patch)
    pos, dirs, order = traffic.frame_schedule(tables, mix, seed)
    chk = mix["check"]
    g = traffic.rng(seed, 4)
    sides = {name: (Field(scene, device, dt), tables_on(tables, device, dt))
             for name, dt in (("ref", torch.float32),
                              ("control", dtype or torch.bfloat16))}
    off = total = 0
    for j in range(int(chk["frames"])):
        i = int(order[j % len(order)])
        py, px = traffic.pixel_sample(g, st.height, st.width,
                                      int(chk["pixels"]), device)
        out = {}
        for name, (field, t) in sides.items():
            dt = t["prim_pos"].dtype
            out[name], _, _ = render_pixels(
                field, t, st, torch.as_tensor(pos[i], device=device).to(dt),
                torch.as_tensor(dirs[i], device=device).to(dt),
                py.to(dt), px.to(dt))
        off += check.pixels_off(out["control"].float(), out["ref"])
        total += py.numel()
    return {"px_off_share": off / total}


def fit_control(man, cell: str, seed: int, device, config_patch=None,
                mix_patch=None, dtype=None, cache_dir=None) -> dict:
    """The fit's numbers of the reference in ``dtype`` (bfloat16) against
    the float32 reference, over the checked steps at the cell's size."""
    import torch
    from portbench import check, traffic
    from portbench.harness import Ctx
    from portbench.runners.fit import target as fit_target
    from portbench.reference import fit as rf
    config, mix, st, scene, tables = _cell(man, cell, config_patch,
                                           mix_patch)
    ctx = Ctx(cell, config, mix, seed, 0.0, False, torch.device(device),
              0.0, man.root, Path(cache_dir or man.root / "build"
                                  / "portbench"))
    target = fit_target(ctx, scene, tables, st)
    start = traffic.perturb(tables, mix, seed)
    runs = {}
    for name, dt, sd in (("ref", torch.float32, torch.float64),
                         ("control", dtype or torch.bfloat16,
                          dtype or torch.bfloat16)):
        runs[name] = rf.fit(scene, start, target, st,
                            steps=int(mix["check_steps"]),
                            lr=float(mix["lr"]), dtype=dt, sum_dtype=sd)
    out = check.fit_numbers(dict(runs["control"], theta0=start),
                            dict(runs["ref"], theta0=start))
    out["losses"] = {k: v["losses"] for k, v in runs.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    from portbench import run
    from portbench.manifest import Manifest
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    man = Manifest(ROOT)
    kind = man.traffic(man.cell(args.workload)["traffic"])["kind"]
    for seed in args.seeds:
        t = time.time()
        if args.fault:
            out, checks = run.run(args.workload, seed, args.seconds, False,
                                  device="cuda:0", fault=args.fault,
                                  t_start=time.time())
            reading = {k: c["value"] for k, c in checks.items()}
        elif kind == "frames":
            reading = frame_control(man, args.workload, seed, "cuda:0")
        else:
            reading = fit_control(man, args.workload, seed, "cuda:0")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault or "control (bfloat16)",
                          "reading": reading,
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
