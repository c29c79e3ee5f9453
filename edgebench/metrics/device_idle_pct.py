"""Share of the traced window in which no kernel, copy or fill ran on the
card (the union of the profiler's device intervals), %."""
from edgebench import roofline


def read(rec):
    t = rec.trace
    if t is None:
        return None
    return roofline.idle_pct(t.busy_s, t.window_s)
