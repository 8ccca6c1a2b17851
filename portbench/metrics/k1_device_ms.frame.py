"""K1's device ms a frame: every K1 launch in the window over the frames."""
from portbench.metrics import _lib


def read(tr):
    return _lib.per_unit_ms(tr, _lib.k1)
