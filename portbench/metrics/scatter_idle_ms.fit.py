"""Device idle ms a step with ``rt.bwd.scatter`` innermost: the fused
backward's parameter scatters (``scene_vjp.theta_cotangents`` and its
kin)."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.bwd.scatter")
