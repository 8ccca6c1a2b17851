"""The ``fit`` kind: ``optimize.fit`` on the perturbed scene toward the
unperturbed image, with the program's own optimizer.  Its first
``warm_steps`` steps are set-up, the first ``check_steps`` of them are
checked, and the window times the steps after them and ends from
``fit``'s callback."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from portbench import check, faults, traffic
from portbench.harness import (Run, free, now, peak_memory, port_config,
                               program_scene, ref_settings, render_settings,
                               sync)
from portbench.reference import fit as ref_fit
from portbench.reference.field import Field
from portbench.reference.render import Settings, render_pixels, tables_on
from portbench.trace import Window

REFERENCE = Path(__file__).resolve().parent.parent / "reference"


class _WindowClosed(Exception):
    pass


def target(ctx, scene, tables: dict, st: Settings):
    """The unperturbed scene's image at the fit's footprint, by the
    reference: rendered once into the benchmark's cache, read after."""
    dev = ctx.device
    key = hashlib.sha256(
        (ctx.root / ctx.config["scene"]).read_bytes()
        + json.dumps(st._asdict(), sort_keys=True).encode()
        + (REFERENCE / "render.py").read_bytes()).hexdigest()[:16]
    path = ctx.cache_dir / f"target_{key}.npy"
    if path.exists():
        return torch.as_tensor(np.load(path), device=dev)
    field = Field(scene, dev, torch.float32)
    rt = tables_on(tables, dev, torch.float32)
    f = dict(dtype=torch.float32, device=dev)
    py = torch.arange(st.height, **f)[:, None].expand(
        st.height, st.width).reshape(-1)
    px = torch.arange(st.width, **f)[None, :].expand(
        st.height, st.width).reshape(-1)
    img, _, _ = render_pixels(field, rt, st, rt["cam_position"],
                              rt["cam_direction"], py, px)
    img = img.reshape(st.height, st.width, 3)
    ctx.cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npy")
    np.save(tmp, img.cpu().numpy())
    tmp.replace(path)
    return img


def _mark_first_step(ctx, optimize):
    """Marks inside the first step, each after a synchronize: the end of
    its forward (``optimize.render_tables``, unwrapped after its first
    call) and of its backward (the first optimizer step's pre-hook, then
    removed).  The window's steps run with neither."""
    render = optimize.render_tables

    def first(*a, **kw):
        optimize.render_tables = render
        img = render(*a, **kw)
        sync(ctx.device)
        ctx.mark("first forward")
        return img

    def hook(opt, args, kwargs):
        handle.remove()
        sync(ctx.device)
        ctx.mark("first backward")

    optimize.render_tables = first
    handle = register_optimizer_step_pre_hook(hook)


def run(ctx) -> Run:
    from raymarching_tpu_torch import optimize
    from raymarching_tpu_torch.scene.compile import SceneTables
    dev, mix = ctx.device, ctx.mix
    rs = render_settings(ctx)
    cfg, st = port_config(rs), ref_settings(rs)
    plan, tables, scene, n_off = program_scene(ctx)
    ref_tables = scene.tables()
    start = traffic.perturb({k: np.asarray(v) for k, v in
                             tables._asdict().items()}, mix, ctx.seed)
    img = target(ctx, scene, ref_tables, st)
    ctx.mark("target ready")
    lr = float(mix["lr"])
    checked, warm = int(mix["check_steps"]), int(mix["warm_steps"])
    rec = {"losses": [], "grad0": None, "theta": None, "n": 0}
    win = Window(ctx.trace)

    def callback(step, loss, tabs):
        if step < checked:
            rec["losses"].append(loss)
        if step == 0:
            ctx.mark("first step")
            rec["grad0"] = {
                k: (torch.zeros_like(getattr(tabs, k)) if getattr(
                    tabs, k).grad is None else getattr(tabs, k).grad)
                .detach().clone() for k in SceneTables._fields}
        if step == checked - 1:
            rec["theta"] = {k: getattr(tabs, k).detach().clone()
                            for k in SceneTables._fields}
        if step == warm - 1:
            ctx.mark("warm steps")
            rec["t0"] = now()
            win.open()
        elif step >= warm:
            rec["n"] += 1
            te = now()
            if te - rec["t0"] >= ctx.seconds:
                rec["te"] = te
                win.close()
                raise _WindowClosed

    with win:
        try:
            with faults.planted_fit(ctx.fault, optimize):
                _mark_first_step(ctx, optimize)
                optimize.fit(plan, SceneTables(**start),
                             faults.target(ctx.fault, img), cfg,
                             device=dev, backend="cuda", steps=1 << 40,
                             lr=lr, callback=callback)
        except _WindowClosed:
            pass
    k = rec["n"]
    setup_s = rec["t0"] - ctx.t_start
    window = rec["te"] - rec["t0"]
    peak = peak_memory(dev)
    tr = win.read() if ctx.trace else None
    prog = {"losses": rec["losses"], "grad0": rec["grad0"],
            "theta0": start, "theta": rec["theta"]}
    free(dev)

    ref_start = traffic.perturb(ref_tables, mix, ctx.seed)
    ref = ref_fit.fit(scene, ref_start, img, st, steps=checked, lr=lr)
    numbers = check.fit_numbers(prog, dict(ref, theta0=ref_start))
    numbers["tables_off"] = n_off
    if tr is not None:
        tr.units = k
        tr.seen.update(scene=scene, settings=st, start=ref_start,
                       steps=k, seed=ctx.seed, device=dev)
    e2e = {"step_ms": 1e3 * window / k, "setup_s": setup_s}
    return Run(k, 0, e2e, numbers, peak, tr)
