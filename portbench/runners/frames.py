"""The ``frames`` kind: one closed-loop client, ``api.render_tables``
frame after frame, each ended by a synchronize, a new orbit pose each."""

from __future__ import annotations

import numpy as np
import torch

from portbench import check, faults, traffic
from portbench.harness import (Run, free, now, peak_memory, port_config,
                               program_scene, ref_settings, render_settings,
                               sync)
from portbench.reference.field import Field
from portbench.reference.render import render_pixels, tables_on
from portbench.trace import Window


def run(ctx) -> Run:
    from raymarching_tpu_torch import api
    from raymarching_tpu_torch.tables import tables_to_torch
    dev, mix = ctx.device, ctx.mix
    rs = render_settings(ctx)
    cfg, st = port_config(rs), ref_settings(rs)
    plan, tables, scene, n_off = program_scene(ctx)
    ref_tables = scene.tables()
    pos, dirs, order = traffic.frame_schedule(ref_tables, mix, ctx.seed)
    tt = tables_to_torch(tables, dev)
    P = torch.as_tensor(pos, device=dev)
    D = torch.as_tensor(dirs, device=dev)
    chk = mix["check"]
    K, every = int(chk["frames"]), int(chk["every"])
    residue = int(traffic.rng(ctx.seed, 3).integers(every))
    bufs = torch.empty((K, st.height, st.width, 3), dtype=torch.float32,
                       device=dev)
    kept = []       # (slot, pose) of the frames checked: the first, and
    # every ``every``-th from a seeded residue; the ring keeps the last K
    render = faults.planted(ctx.fault, api.render_tables)

    def frame(i: int):
        return render(plan, tt._replace(cam_position=P[i],
                                        cam_direction=D[i]), cfg,
                      backend="cuda", device=dev)

    n = len(order)
    with torch.no_grad():
        ctx.mark("tables on the device")
        frame(int(order[-1]))       # warm the cell's one shape
        sync(dev)
        ctx.mark("warm frame")
        lat = []
        with Window(ctx.trace) as win:
            t0 = now()
            win.open()
            k = 0
            while True:
                i = int(order[k % n])
                ts = now()
                img = frame(i)
                if k % every == residue or k == 0:
                    slot = len(kept) % K
                    bufs[slot].copy_(img)
                    kept.append((slot, i))
                sync(dev)
                te = now()
                lat.append(te - ts)
                k += 1
                if te - t0 >= ctx.seconds:
                    break
            win.close()
        setup_s = t0 - ctx.t_start
        window = te - t0
        peak = peak_memory(dev)
        tr = win.read() if ctx.trace else None
        del img, tt, render
        free(dev)

        field = Field(scene, dev, torch.float32)
        rt = tables_on(ref_tables, dev, torch.float32)
        g = traffic.rng(ctx.seed, 4)
        m = int(chk["pixels"])
        off = total = 0
        for slot, i in sorted(dict(kept).items()):   # each slot's newest
            py, px = traffic.pixel_sample(g, st.height, st.width, m, dev)
            want, _, _ = render_pixels(field, rt, st, P[i], D[i], py, px)
            got = bufs[slot][py.long(), px.long()]
            off += check.pixels_off(got, want)
            total += m
        numbers = {"px_off_share": (off / total) if total else float("nan"),
                   "tables_off": n_off}

    if tr is not None:
        tr.units = k
        tr.seen.update(
            scene=scene, settings=st, positions=pos, directions=dirs,
            counts=np.bincount([int(order[j % n]) for j in range(k)],
                               minlength=n),
            seed=ctx.seed, device=dev)
    e2e = {"frame_ms": 1e3 * window / k,
           "frame_p95_ms": 1e3 * float(np.percentile(lat, 95)),
           "setup_s": setup_s}
    return Run(k, 0, e2e, numbers, peak, tr)
