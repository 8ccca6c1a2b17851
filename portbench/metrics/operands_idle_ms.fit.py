"""Device idle ms a step with ``rt.scene_operands`` innermost:
``tables.scene_operands`` at the forward's K1 launch and the backward's
K2 launch."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.scene_operands")
