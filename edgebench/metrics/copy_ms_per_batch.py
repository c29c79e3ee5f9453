"""Device time of the host-to-device and device-to-host copies in the
traced window, over the batches dispatched in it, ms."""


def read(rec):
    t, m = rec.trace, rec.measured
    if t is None or not m.batches:
        return None
    secs = t.seconds(lambda name: name.startswith("Memcpy"))
    return secs * 1e3 / m.batches if secs > 0 else None
