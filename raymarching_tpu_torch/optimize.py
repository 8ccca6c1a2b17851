"""Scene fitting: gradient descent on SceneTables against a target image.

Counterpart of ``raymarching_tpu.optimize.fit`` on one device, with
``torch.optim`` in place of optax.  Each step renders through
``render_tables(differentiable=True)`` (K1 forward, exact-FD backward over
K2 on a CUDA device; their plain twins on the CPU), takes the mean squared
error against the target, and steps the optimizer on the trainable fields.
Checkpoints are the JAX package's numpy ``.npz`` format
(``raymarching_tpu.io.checkpoint``), so a fit can be rendered or resumed by
either package; the optimizer state rides in ``extra`` under the port's
own keys.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from raymarching_tpu.config import RenderConfig
from raymarching_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from raymarching_tpu.scene.compile import ScenePlan, SceneTables
from raymarching_tpu.utils.structlog import get_logger

from .api import render_tables, resolve_device
from .tables import tables_to_numpy, tables_to_torch

# checkpoint ``extra`` keys of the optimizer state: the trainable field
# names, and each state tensor as OPT_KEY.<param index>.<state name>
FIELDS_KEY = "torch_opt_fields"
OPT_KEY = "torch_opt"


def emit(event: str, **fields) -> None:
    """``structlog.emit`` for the port: one JSON event through the shared
    default logger (a no-op when none is configured).  The shared logger
    resolves its ``process`` field on first use by importing JAX; the
    port never does, and fits in one process, so that field is set to 0
    beforehand."""
    log = get_logger()
    if log is None:
        return
    if log._process is None:
        log._process = 0
    log.log(event, **fields)


@dataclasses.dataclass
class FitResult:
    tables: SceneTables     # detached tensors on the fit's device
    losses: list
    steps: int


def fit(plan: ScenePlan, tables: SceneTables, target, cfg: RenderConfig, *,
        device, steps: int = 100, lr: float = 1e-2,
        trainable: Optional[Sequence[str]] = None,
        optimizer: Optional[Callable] = None, mesh=None,
        checkpoint_path: Optional[str] = None, checkpoint_every: int = 50,
        resume: bool = False, callback: Optional[Callable] = None
        ) -> FitResult:
    """Minimise the mean squared error of the render against ``target``
    [H, W, 3] for ``steps`` steps in all.

    ``trainable``: SceneTables field names to optimise (None: all); the
    other fields are never updated.  ``optimizer``: a callable that takes
    the list of trainable tensors and returns a ``torch.optim.Optimizer``
    (default ``torch.optim.Adam`` at ``lr``).  ``callback(step, loss,
    tables)`` runs after each step; the trainable fields' ``.grad`` then
    hold that step's gradients.  With ``resume`` and an existing
    checkpoint, the tables, step and optimizer state come from it (a fresh
    optimizer when the saved state does not fit this one).  ``mesh``, the
    JAX package's ray sharding, must be None here.
    """
    if mesh is not None:
        raise NotImplementedError(
            "not ported yet: fitting over several devices (ROADMAP Queue 1 "
            "item 13)")
    device = resolve_device(device)
    names = tuple(SceneTables._fields if trainable is None else trainable)
    make_opt = optimizer or (lambda ps: torch.optim.Adam(ps, lr=lr))

    start_step, extra = 0, {}
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        tables, start_step, extra = load_checkpoint(checkpoint_path)
    tables = tables_to_torch(tables, device, requires_grad=names)
    params = [getattr(tables, n) for n in names]
    opt = make_opt(params)
    _load_opt_state(opt, params, names, extra)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)

    def save(step):
        save_checkpoint(checkpoint_path, tables_to_numpy(tables), step=step,
                        extra=_opt_state_extra(opt, names))

    losses = []
    for step in range(start_step, steps):
        opt.zero_grad(set_to_none=True)
        img = render_tables(plan, tables, cfg, differentiable=True,
                            device=device)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        emit("fit_step", step=step, loss=losses[-1])
        if callback is not None:
            callback(step, losses[-1], tables)
        if checkpoint_path and (step + 1) % checkpoint_every == 0:
            save(step + 1)
            emit("checkpoint", step=step + 1, path=checkpoint_path)
    if checkpoint_path:
        save(steps)
    return FitResult(tables=SceneTables(*(v.detach() for v in tables)),
                     losses=losses, steps=steps - start_step)


def _opt_state_extra(opt: torch.optim.Optimizer, names) -> dict:
    """The optimizer's per-parameter state as checkpoint ``extra`` arrays
    (its hyperparameters are the caller's and are not saved)."""
    extra = {FIELDS_KEY: np.asarray(names)}
    for i, state in opt.state_dict()["state"].items():
        for k, v in state.items():
            extra[f"{OPT_KEY}.{i}.{k}"] = np.asarray(
                torch.as_tensor(v).detach().cpu())
    return extra


def _load_opt_state(opt: torch.optim.Optimizer, params, names,
                    extra: dict) -> None:
    """Restore the state ``_opt_state_extra`` saved, when it was saved for
    the same trainable fields and its tensors fit the parameters; else
    leave the optimizer fresh (optimize._opt_state_from_extra)."""
    saved = extra.get(FIELDS_KEY)
    if saved is None or tuple(np.asarray(saved).tolist()) != tuple(names):
        return
    state = {}
    for key, v in extra.items():
        head, _, rest = key.partition(".")
        if head != OPT_KEY:
            continue
        i, _, name = rest.partition(".")
        i = int(i)
        if i >= len(params) or (v.ndim and v.shape != params[i].shape):
            return
        state.setdefault(i, {})[name] = torch.as_tensor(v)
    sd = opt.state_dict()
    sd["state"] = state
    opt.load_state_dict(sd)
