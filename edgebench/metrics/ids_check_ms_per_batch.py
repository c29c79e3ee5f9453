"""Host time of the label join's id range checks: the program's
``label_join.ids_check`` spans inside the traced window (the profiler's
clock), summed over the batches dispatched in it, ms a batch. None
where the program records no such span."""
SPAN = "label_join.ids_check"


def read(rec):
    t, m = rec.trace, rec.measured
    if t is None or not m.batches:
        return None
    lo, hi = t.window_ns
    ns = [e - s for name, s, e in t.phases
          if name == SPAN and lo <= s and e <= hi]
    return sum(ns) / 1e6 / m.batches if ns else None
