"""Device idle ms a step with ``rt.k1`` innermost: K1's host wrapper in the
forward, less its scene operands."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.k1")
