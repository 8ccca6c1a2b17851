"""Checkpoint / resume for scene-parameter pytrees.

The reference has no checkpointing at all (outputs are final images only,
SURVEY §5); for the differentiable-optimization use case we persist the
``SceneTables`` pytree plus optimizer state.  Format: a plain ``.npz``
(portable, dependency-free), the format of ``raymarching_tpu.io
.checkpoint``: a checkpoint written by either package loads in the other.
The JAX package's orbax variant is not part of the port.

The port's own copy of ``raymarching_tpu.io.checkpoint`` (same names, same behaviour; a test
holds the two equal), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from ..scene.compile import SceneTables


def save_checkpoint(path: str, tables: SceneTables, *, step: int = 0,
                    extra: Optional[dict] = None) -> None:
    """Atomically write tables (+ scalars in ``extra``) to ``path``."""
    arrays = {f"tables.{k}": np.asarray(v)
              for k, v in tables._asdict().items()}
    arrays["step"] = np.asarray(step)
    for k, v in (extra or {}).items():
        arrays[f"extra.{k}"] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Tuple[SceneTables, int, dict]:
    """-> (tables, step, extra)."""
    with np.load(path) as z:
        fields = {}
        extra = {}
        step = 0
        for k in z.files:
            if k == "step":
                step = int(z[k])
            elif k.startswith("tables."):
                fields[k[len("tables."):]] = z[k]
            elif k.startswith("extra."):
                extra[k[len("extra."):]] = z[k]
    return SceneTables(**fields), step, extra
