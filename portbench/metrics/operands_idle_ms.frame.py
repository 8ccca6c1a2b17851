"""Device idle ms a frame with ``rt.scene_operands`` innermost:
``tables.scene_operands``, the scene as the kernels read it, built on
the host at every K1 launch."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.scene_operands")
