"""Device idle ms a frame with ``rt.k1`` innermost: K1's host wrapper
(``ops/render_kernel.render_rays``) less its scene operands: the shading
operands, the arguments and the launch."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.k1")
