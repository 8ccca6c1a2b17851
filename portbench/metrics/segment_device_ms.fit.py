"""The parameter scatter's device ms a fit step: the kernels whose name
holds ``segment_sum`` (csrc/segment_kernel.cu, the float64 segmented
sums of ops/segment_kernel).  A program without that kernel reads None."""
from portbench.metrics import _lib


def segment(k) -> bool:
    return "segment_sum" in k.name


def read(tr):
    return _lib.per_unit_ms(tr, segment)
