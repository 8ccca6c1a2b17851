"""The parameter scatter: wrapper and plain twin of the segmented sum.

Every backward of the port ends in sums of per-row terms onto the leaf
rows they name: ``scene_vjp.theta_cotangents``' columns [-u g, -u,
-u |g| / 2] (and with procedural leaves -u sd, -u g.q) of each winner
row, the colour rows' cotangents, the analytic Hessian rows.  The sums
are float64 and the caller rounds them once (``scene_vjp.segment_add``
says why).  ``segment_sum`` sums given float32 columns; ``theta_sum``
makes theta_cotangents' columns itself.

CPU tensors take the plain twins: ``index_add_`` into float64 with a
spare row for the misses.  CUDA tensors launch ``csrc/segment_kernel.cu``
(a warp's rows merged by leaf in float64 shuffles, a block's sums in
shared memory while P * C of them fit), which reads the theta entry's
inputs in place, so its columns never exist in device memory.
``segment_sum.launches`` counts the launches of both entries.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

# columns the kernel's generic entry takes (csrc/segment_kernel.cu)
MAX_COLUMNS = 16


def segment_sum_plain(idx: torch.Tensor, vals: torch.Tensor, P: int
                      ) -> torch.Tensor:
    """[P, C] float64 sums of the rows of vals [R, C] by idx [R], negative
    ids dropped (misses land on a spare row P that is cut off, so no host
    sync filters them)."""
    rows = torch.where(idx >= 0, idx, P).long()
    out = torch.zeros((P + 1, vals.shape[1]), dtype=torch.float64,
                      device=vals.device)
    return out.index_add_(0, rows, vals.double())[:P]


def theta_terms(g: torch.Tensor, u: torch.Tensor,
                sd: Optional[torch.Tensor] = None,
                q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """theta_cotangents' columns of each row, g [R, 3], u [R] -> [R, 7]
    [-u g, -u, (0.5 (-u)) |g|]; with sd [R] and q [R, 3] -> [R, 9], also
    -u sd and -u ((g.x q.x + g.y q.y) + g.z q.z) (the order of the CPU's
    sum over three columns, and the kernel's).  Float32 in, float32
    out."""
    mu = -u.reshape(-1, 1)
    cols = [mu * g, mu, 0.5 * mu * g.abs()]
    if sd is not None:
        gq = (g[:, 0] * q[:, 0] + g[:, 1] * q[:, 1]) + g[:, 2] * q[:, 2]
        cols += [mu * sd.reshape(-1, 1), mu * gq[:, None]]
    return torch.cat(cols, dim=1)


def theta_sum_plain(widx: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                    P: int, sd: Optional[torch.Tensor] = None,
                    q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``theta_sum`` in plain PyTorch: ``segment_sum_plain`` of
    ``theta_terms``, any leading shape flattened."""
    if sd is not None:
        sd, q = sd.reshape(-1), q.reshape(-1, 3)
    return segment_sum_plain(widx.reshape(-1), theta_terms(
        g.reshape(-1, 3), u.reshape(-1), sd, q), P)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/segment_kernel.cu, built on first use, its entry points bound."""
    lib = build.load_library("segment_kernel")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rt_segment_sum.argtypes = [ptr, ptr, i32, i64, i32, ptr, ptr]
    lib.rt_segment_sum.restype = i32
    lib.rt_segment_theta.argtypes = [ptr, ptr, i64, i64, ptr, ptr, ptr, i64,
                                     i64, i64, i32, ptr, ptr]
    lib.rt_segment_theta.restype = i32
    return lib


def _ids(what: str, idx: torch.Tensor, R: int, dev) -> torch.Tensor:
    """idx as the kernel reads it: [R] int32 on ``dev``, contiguous."""
    if idx.device != dev or idx.numel() != R:
        raise ValueError(f"{what}: idx must hold {R} ids on {dev}, got "
                         f"{idx.numel()} on {idx.device}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: idx must be int32 or int64, got "
                         f"{idx.dtype}")
    return idx.reshape(-1).to(torch.int32).contiguous()


def _float32(what: str, dev, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")


def _run(what: str, dev, call) -> None:
    lib = _library()
    with torch.cuda.device(dev):
        code = call(lib, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, what)


def segment_sum(idx: torch.Tensor, vals: torch.Tensor, P: int
                ) -> torch.Tensor:
    """[P, C] float64 sums of the rows of vals [R, C] by idx [R] (ids
    outside [0, P) dropped).  CPU tensors take ``segment_sum_plain``; on
    the card vals must be float32 with C <= ``MAX_COLUMNS``, and idx
    int32 or int64."""
    dev = vals.device
    if dev.type == "cpu":
        return segment_sum_plain(idx, vals, P)
    R, C = vals.shape
    _float32("segment_sum", dev, vals=vals)
    if not 1 <= C <= MAX_COLUMNS:
        raise ValueError(f"segment_sum: {C} columns, the kernel takes 1 to "
                         f"{MAX_COLUMNS}")
    ids = _ids("segment_sum", idx, R, dev)
    vals = vals.contiguous()
    out = torch.zeros((P, C), dtype=torch.float64, device=dev)
    _run("segment kernel launch", dev,
         lambda lib, stream: lib.rt_segment_sum(
             ids.data_ptr(), vals.data_ptr(), C, R, P, out.data_ptr(),
             stream))
    if R and P:    # the C entry point launches nothing for zero rows
        segment_sum.launches += 1
    return out


segment_sum.launches = 0


def theta_sum(widx: torch.Tensor, g: torch.Tensor, u: torch.Tensor, P: int,
              sd: Optional[torch.Tensor] = None,
              q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``segment_sum`` of ``theta_terms(g, u, sd, q)`` by widx: widx [R],
    g [R, 3], u [R] (sd [R] and q [R, 3] with procedural leaves; any
    leading shape flattens) -> [P, 7] or [P, 9] float64.  On the card the
    kernel makes the columns in registers and reads g and q through their
    strides (K2's gradients are a structure-of-arrays view)."""
    dev = g.device
    if dev.type == "cpu":
        return theta_sum_plain(widx, g, u, P, sd, q)
    g, u = g.reshape(-1, 3), u.reshape(-1)
    if sd is not None:
        sd, q = sd.reshape(-1), q.reshape(-1, 3)
    R = g.shape[0]
    extra = {} if sd is None else {"sd": sd, "q": q}
    _float32("theta_sum", dev, g=g, u=u, **extra)
    if u.shape[0] != R or (sd is not None and (sd.shape[0] != R
                                               or q.shape[0] != R)):
        raise ValueError("theta_sum: g, u, sd and q must hold one row each "
                         "for every id")
    ids = _ids("theta_sum", widx, R, dev)
    u = u.contiguous()
    if sd is not None:
        sd = sd.contiguous()
    out = torch.zeros((P, 7 if sd is None else 9), dtype=torch.float64,
                      device=dev)
    _run("segment kernel theta launch", dev,
         lambda lib, stream: lib.rt_segment_theta(
             ids.data_ptr(), g.data_ptr(), g.stride(0), g.stride(1),
             u.data_ptr(), None if sd is None else sd.data_ptr(),
             None if q is None else q.data_ptr(),
             0 if q is None else q.stride(0),
             0 if q is None else q.stride(1), R, P, out.data_ptr(), stream))
    if R and P:
        segment_sum.launches += 1
    return out
