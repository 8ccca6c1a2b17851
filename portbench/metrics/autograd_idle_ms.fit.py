"""Device idle ms a step with ``rt.fit.backward`` innermost:
``loss.backward()`` outside the fused backward: the engine and the
backwards of the plain ops (the tables' selects, the loss)."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.fit.backward")
