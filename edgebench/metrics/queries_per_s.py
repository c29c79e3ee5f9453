"""Queries answered in the window over the window's seconds (host clock;
the batch in flight when the time is up completes and counts)."""


def read(rec):
    m = rec.measured
    return m.queries / m.window_s if m.queries else None
