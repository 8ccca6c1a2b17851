"""Device idle ms a step under no ``rt.`` span: the runner's own loop and
what the program does outside its spans."""
from portbench.metrics import _spans


def read(tr):
    return _spans.idle_ms(tr, None)
