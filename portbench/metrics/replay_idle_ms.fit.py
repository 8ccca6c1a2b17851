"""Device idle ms a step with ``rt.bwd.replay`` innermost: the fused
backward's Lambert replay under autograd (``ops/render_op._replay``),
with the colour rows' scatter."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.bwd.replay")
