"""A frame's device ms outside K1: the camera pass, the block order's
permutes, the colour blend and the SSAA mean, over the frames."""
from portbench.metrics import _lib


def read(tr):
    if not tr.count(_lib.k1):
        return None
    return _lib.per_unit_ms(tr, lambda k: not _lib.k1(k))
