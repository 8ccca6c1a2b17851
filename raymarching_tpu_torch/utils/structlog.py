"""Structured per-host logging (SURVEY §5 metrics/observability row).

The reference's observability is ``std::cout`` stage banners with chrono
spans (main.cpp:21-35, 36-77).  At fleet scale that story does not compose:
N hosts interleave on stdout and nothing downstream can parse the lines.
This module emits ONE JSON object per event, each self-describing with
wall-clock timestamp, hostname, pid, and the process's rank, so logs
from every process of a job can be concatenated, sorted, and aggregated
mechanically.  The port's copy of ``raymarching_tpu.utils.structlog``: the
same records, with the rank given by the caller instead of looked up.

Design points:

  * stdlib-only, no logging-framework dependency;
  * the port runs one process per device: the ``process`` field is the
    ``rank`` the logger was configured with (default 0);
  * ``Phase``-compatible span helper so the CLI's human banners and the
    structured stream come from one timing source;
  * a module-level default logger, configured once (CLI ``--log-json``),
    so library code can emit events without threading a logger through
    every call.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import sys
import time
from typing import IO, Optional


class StructuredLogger:
    """JSON-lines event logger with per-host provenance fields.

    ``log("render", backend="mega", seconds=1.2)`` writes one line::

        {"ts": ..., "host": ..., "pid": ..., "process": 0,
         "event": "render", "backend": "mega", "seconds": 1.2}
    """

    def __init__(self, stream: Optional[IO[str]] = None,
                 path: Optional[str] = None, rank: int = 0):
        self._file = open(path, "a", buffering=1) if path else None
        self.stream = stream if stream is not None else (
            self._file or sys.stderr)
        self._static = {
            "host": socket.gethostname(),
            "pid": os.getpid(),
        }
        self._process = int(rank)

    def log(self, event: str, **fields) -> dict:
        rec = {"ts": round(time.time(), 6), **self._static,
               "process": self._process, "event": event, **fields}
        self.stream.write(json.dumps(rec) + "\n")
        return rec

    @contextlib.contextmanager
    def span(self, event: str, rays: Optional[int] = None, **fields):
        """Timed span: logs ``event`` with ``seconds`` (and Mrays/s when
        ``rays`` is given) on exit — the structured twin of timing.Phase."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            seconds = time.perf_counter() - t0
            if rays:
                fields["mrays_per_s"] = round(rays / seconds / 1e6, 4)
            self.log(event, seconds=round(seconds, 6), **fields)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


_default: Optional[StructuredLogger] = None


def configure(path: Optional[str] = None,
              stream: Optional[IO[str]] = None,
              rank: int = 0) -> StructuredLogger:
    """Install (and return) the module-level default logger; ``rank`` is
    the ``process`` field of its records."""
    global _default
    if _default is not None:
        _default.close()
    _default = StructuredLogger(stream=stream, path=path, rank=rank)
    return _default


def reset() -> None:
    """Remove the default logger, closing its file: structured logging is
    off again."""
    global _default
    if _default is not None:
        _default.close()
    _default = None


def get_logger() -> Optional[StructuredLogger]:
    """The default logger, or None when structured logging is off."""
    return _default


def emit(event: str, **fields) -> None:
    """Fire-and-forget event through the default logger (no-op when off)."""
    if _default is not None:
        _default.log(event, **fields)
