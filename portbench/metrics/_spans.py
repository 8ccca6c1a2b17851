"""The device's idle time put down to the program's spans.

The port opens its spans with ``utils.timing.span`` (names ``rt.*``); the
profiler writes them as ``cpu_op`` events, so the window's ``host_ops``
hold them beside the aten ops, on the same clock as the kernels.  Each
idle gap of the window is split over time by the innermost open span
there: the open ``rt.`` span with the latest start, on any thread (the
fused backward runs on autograd's device thread while ``rt.fit.backward``
stays open on the main one).  A reader returns None where the trace holds
no span of its name."""

import bisect
import heapq

PREFIX = "rt."


def spans(tr) -> list:
    """The window's ``rt.`` spans, (start, end, name) clipped to it."""
    return [(max(s, tr.w0), min(e, tr.w1), n) for s, e, n in tr.host_ops
            if n.startswith(PREFIX) and e > tr.w0 and s < tr.w1]


def _innermost(sp: list) -> list:
    """(time, name) where the innermost open span changes, in time order;
    name None where no span is open."""
    ev = sorted([(s, 1, i) for i, (s, _, _) in enumerate(sp)]
                + [(e, 0, i) for i, (_, e, _) in enumerate(sp)])
    heap, closed, out, k = [], set(), [], 0
    while k < len(ev):
        t = ev[k][0]
        while k < len(ev) and ev[k][0] == t:
            _, opens, i = ev[k]
            if opens:   # latest start first; of two, the one ending first
                heapq.heappush(heap, (-sp[i][0], sp[i][1], i))
            else:
                closed.add(i)
            k += 1
        while heap and heap[0][2] in closed:
            heapq.heappop(heap)
        name = sp[heap[0][2]][2] if heap else None
        if not out or out[-1][1] != name:
            out.append((t, name))
    return out


def idle_by_span(tr) -> dict:
    """Idle seconds of the window by innermost span name, None for idle
    time under no ``rt.`` span; the values add up to the window's idle
    time."""
    marks = _innermost(spans(tr))
    times = [t for t, _ in marks]
    out = {}
    for a, b in tr.gaps:
        i = bisect.bisect_right(times, a) - 1   # the mark in force at a
        t = a
        while t < b:
            name = marks[i][1] if i >= 0 else None
            e = min(b, times[i + 1]) if i + 1 < len(times) else b
            out[name] = out.get(name, 0.0) + (e - t) / 1e6
            t, i = e, i + 1
    return out


def idle_ms(tr, name):
    """Idle ms a frame or step with span ``name`` innermost (None: under
    no span), or None where the trace has no device record, no unit, or
    no such span (no ``rt.`` span at all, for None)."""
    if not tr.kernels or not tr.units:
        return None
    names = {n for _, _, n in spans(tr)}
    if not names or (name is not None and name not in names):
        return None
    return 1e3 * idle_by_span(tr).get(name, 0.0) / tr.units
