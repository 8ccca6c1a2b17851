"""K2's device ms a fit step: its stencil entry, the FD backward."""
from portbench.metrics import _lib


def read(tr):
    return _lib.per_unit_ms(tr, _lib.k2)
