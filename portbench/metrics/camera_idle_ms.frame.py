"""Device idle ms a frame with ``rt.camera`` innermost:
``api._render_rows``' camera pass with the block order, and the block
order's inverse with the SSAA mean."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.camera")
