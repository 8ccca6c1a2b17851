"""Device idle ms a step with ``rt.render`` innermost: the forward's
``api.render_tables`` own host work: its checks, ``tables_to_torch`` and
the colour blend."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, "rt.render")
