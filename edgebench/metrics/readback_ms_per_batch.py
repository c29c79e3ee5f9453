"""Host time of the label join's readback, the wait for the join plus the
copy of the answers back: the program's ``label_join.readback`` spans
inside the traced window (the profiler's clock), summed over the batches
dispatched in it, ms a batch. None where the program records no such
span."""
SPAN = "label_join.readback"


def read(rec):
    t, m = rec.trace, rec.measured
    if t is None or not m.batches:
        return None
    lo, hi = t.window_ns
    ns = [e - s for name, s, e in t.phases
          if name == SPAN and lo <= s and e <= hi]
    return sum(ns) / 1e6 / m.batches if ns else None
