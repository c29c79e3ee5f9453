"""The label-join kernels' share of their bytes roofline: the least bytes
the window's batches needed (each distinct label row read once, two int64
ids and one float32 answer a query) at the card's HBM bandwidth, over the
kernels' device time in the traced window."""
from edgebench import roofline

KERNELS = ("gather_join_kernel", "multi_shard_join_kernel")


def read(rec):
    t, m = rec.trace, rec.measured
    bw = roofline.peak(rec.device_kind, "hbm_bytes_per_s")
    if t is None or bw is None or not m.join_least_bytes:
        return None
    secs = t.seconds(lambda name: any(k in name for k in KERNELS))
    if secs <= 0:
        return None
    return roofline.roofline_pct(m.join_least_bytes, secs, bw)
