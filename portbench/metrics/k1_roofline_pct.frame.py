"""K1's share of its roofline in the frame window: the larger of the
window's operations over 67 TFLOP/s and its bytes over 3.35 TB/s, both
counted by portbench/roofline.py from the benchmark's own plain march, over
K1's device time in the window."""
from portbench import roofline
from portbench.metrics import _lib


def read(tr):
    if not tr.count(_lib.k1) or "counts" not in tr.seen:
        return None
    ops, nbytes = roofline.frame_work(tr.seen)
    return roofline.roofline_pct(ops, nbytes, tr.device_s(_lib.k1))[0]
