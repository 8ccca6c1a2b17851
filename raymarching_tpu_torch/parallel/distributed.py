"""Multi-process set-up and the frame gather over ``torch.distributed``.

Port of ``raymarching_tpu.parallel.distributed``.  One process a device:

  * ``initialize`` — the one rendezvous at process start, from its
    arguments or torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``); a no-op for one
    process with no ``init_method``;
  * ``gather_image`` — the only frame movement between processes: each
    rank's band of rows to every rank, at save time (the analogue of the
    reference's glGetTexImage readback, render.cpp:474).

NCCL is the backend on CUDA devices and gloo on the CPU; a caller may name
either.  Gloo takes CUDA tensors in ``all_reduce`` and ``broadcast`` but
gathers host tensors only, so under gloo the bands are gathered on the
host.  A failed initialisation raises: nothing falls back to another
backend or to the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None, *, device="cuda") -> None:
    """Join the default process group (no-op for a single process).

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``;
    ``init_method`` to ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``) when
    there is more than one process.  With one process and no
    ``init_method`` nothing happens; an ``init_method`` (``file://...``,
    ``tcp://host:port``) always forms a group, of one process too.
    ``backend`` defaults to ``"nccl"`` for a CUDA ``device`` and ``"gloo"``
    for the CPU.  On CUDA the process takes device ``LOCAL_RANK`` (default:
    its rank) modulo the device count, so that two gloo ranks may share
    one card; NCCL refuses two ranks on one device.  The group is used
    once (a barrier) before this returns, so a failed rendezvous raises
    here."""
    if dist.is_initialized():
        return
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1) if world_size is None
                     else world_size)
    if init_method is None:
        if world_size == 1:
            return
        init_method = "env://"
    rank = int(env.get("RANK", 0) if rank is None else rank)
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    extra = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but "
                               "torch.cuda.is_available() is false")
        local = int(env.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        if backend == "nccl":
            # bound to its device, NCCL forms its communicator here
            extra["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **extra)
    dist.barrier()


def is_primary() -> bool:
    """Rank 0 of the default group (the only process without one)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Each rank's ``x`` (one shape on every rank) of ``group`` (default:
    the whole default group), concatenated along dim 0 in rank order, on
    ``x``'s device.  One all-gather: of device tensors under NCCL, of host
    tensors under gloo (whose all-gather takes nothing else)."""
    y = x.detach()
    if dist.get_backend(group) != "nccl":
        y = y.cpu()
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.device)


def gather_image(band: torch.Tensor, mesh=None) -> np.ndarray:
    """Each rank's band of rows [H/n, W, 3] (``sharded.render_sharded``)
    -> the frame [H, W, 3] as a host float32 array on every rank of
    ``mesh`` (default: the whole default group), bands in mesh order
    (``gather_rows``).  Without a process group, or on one rank, the band
    itself."""
    from .sharded import mesh_group
    group, n = mesh_group(mesh)
    full = band.detach() if n == 1 else gather_rows(band, group)
    return full.cpu().numpy().astype(np.float32, copy=False)


def save_image_primary(path: str, band: torch.Tensor, mesh=None,
                       gamma: float = 1.0) -> None:
    """Gather the frame (``gather_image``) and write it on rank 0 only."""
    full = gather_image(band, mesh)
    if is_primary():
        from ..io.image import save_image
        save_image(path, full, gamma=gamma)
