"""Device idle ms a step with ``rt.fit.optimizer`` innermost: the
optimizer's step (``optimize.fit``'s ``opt.step()``, Adam by default)."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.fit.optimizer")
