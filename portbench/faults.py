"""Faults planted under the timed path, for the tests and the on-chip
readings that show the check catches them.  A run of the benchmark plants
none: every function here hands back what it was given when ``fault`` is
None.

Frames: ``stale`` (every frame is the first one rendered), ``half`` (the
lower half of the rows left black), ``altered`` (every colour shifted by
0.01 where it is produced).  Fit: ``unchanged`` (each optimizer step
returns the parameters as they were), ``half`` (the loss the mean over the
upper half of the rows, the rest left out).
"""

from __future__ import annotations

import contextlib

FRAME_FAULTS = ("stale", "half", "altered")
FIT_FAULTS = ("unchanged", "half")


def planted(fault, render):
    """``render`` (``api.render_tables``) with a frame fault planted."""
    if fault is None:
        return render
    if fault not in FRAME_FAULTS:
        raise ValueError(f"no frame fault {fault!r}")
    first = []

    def broken(*a, **kw):
        img = render(*a, **kw)
        if fault == "stale":
            if not first:
                first.append(img.clone())
            return first[0]
        if fault == "half":
            img = img.clone()
            img[img.shape[0] // 2:] = 0.0
            return img
        return img + 0.01
    return broken


@contextlib.contextmanager
def planted_fit(fault, optimize):
    """The fit with a fault planted: ``half`` renders the upper half of the
    image's rows (``optimize.render_tables``), against ``target``'s;
    ``unchanged`` puts every parameter back after each optimizer step
    (whichever optimizer the program builds), so the step returns the
    state as it was."""
    if fault not in (None, "half", "unchanged"):
        raise ValueError(f"no fit fault {fault!r}")
    if fault is None:
        yield
    elif fault == "half":
        render = optimize.render_tables

        def broken(*a, **kw):
            img = render(*a, **kw)
            return img[:img.shape[0] // 2]
        optimize.render_tables = broken
        try:
            yield
        finally:
            optimize.render_tables = render
    else:
        import torch
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)
        before = []

        def pre(opt, args, kwargs):
            before[:] = [p.detach().clone() for g in opt.param_groups
                         for p in g["params"]]

        def post(opt, args, kwargs):
            with torch.no_grad():
                for p, b in zip((p for g in opt.param_groups
                                 for p in g["params"]), before):
                    p.copy_(b)
        handles = [register_optimizer_step_pre_hook(pre),
                   register_optimizer_step_post_hook(post)]
        try:
            yield
        finally:
            for h in handles:
                h.remove()


def target(fault, img):
    return img[:img.shape[0] // 2] if fault == "half" else img
