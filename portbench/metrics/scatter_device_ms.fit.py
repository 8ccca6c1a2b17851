"""The parameter scatter's device ms a fit step: the kernels of
``aten::index_add_`` (the float64 sums of scene_vjp.segment_add and the
colour rows' scatter)."""
from portbench.metrics import _lib


def read(tr):
    return _lib.per_unit_ms(tr, _lib.scatter)
