"""The share of the frame window in which no kernel, copy or set ran."""
from portbench.metrics import _lib


def read(tr):
    return _lib.idle_pct(tr)
