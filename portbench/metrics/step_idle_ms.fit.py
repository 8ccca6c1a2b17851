"""Device idle ms a step with ``rt.fit.step`` innermost: ``optimize.fit``'s
own host work a step: ``zero_grad``, the loss and ``loss.item()``."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.fit.step")
