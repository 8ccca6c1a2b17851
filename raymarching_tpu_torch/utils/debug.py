"""Debug utilities (the port's counterpart of
``raymarching_tpu.utils.debug``).

  * ``check_finite`` raises on a NaN or infinity anywhere in tensors,
    arrays and nested containers of them;
  * ``debug_nans`` is a scoped ``torch.autograd.set_detect_anomaly``, the
    twin of the JAX package's scoped ``jax_debug_nans``: a backward that
    produces a NaN raises where it did;
  * ``print_v3`` prints a float3 (the reference's ``debug::print``).

The JAX module's ``interpret_mode`` (Pallas kernels run by the
interpreter) has no twin: a CUDA kernel has no interpret mode, and its
plain PyTorch twin is what a CPU tensor gets.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def check_finite(tree, name: str = "value") -> None:
    """Raise FloatingPointError if any leaf of ``tree`` (tensors, arrays,
    numbers, in nested lists, tuples, named tuples and dicts) holds a NaN
    or an infinity."""
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if not np.all(np.isfinite(arr)):
            bad = int(np.size(arr) - np.isfinite(arr).sum())
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad} non-finite elements "
                f"(shape {arr.shape})")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped autograd anomaly detection: inside it, a backward function
    that returns a NaN raises, naming the forward op."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def print_v3(label: str, v) -> None:
    """Print a float3 (or the x, y, z columns of [..., 3]) of a tensor or
    an array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    v = np.asarray(v)
    print(f"{label}: {v[..., 0]} {v[..., 1]} {v[..., 2]}")
