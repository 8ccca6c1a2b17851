"""K1's device ms a fit step (the forward)."""
from portbench.metrics import _lib


def read(tr):
    return _lib.per_unit_ms(tr, _lib.k1)
