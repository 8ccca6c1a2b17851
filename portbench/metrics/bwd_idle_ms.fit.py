"""Device idle ms a step with ``rt.bwd`` innermost: the fused backward less
its replay and scatters: K2's stencil wrapper, the FD chain, the
implicit-function weights."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.bwd")
