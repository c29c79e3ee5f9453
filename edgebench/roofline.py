"""Peaks, least bytes and busy time (frozen).

The table of peaks is NVIDIA's data sheet for one H100 SXM (dense rates,
700 W). A share of a roofline is the least time the chip could take for
the work, over the time it took. ``join_bytes`` counts what a batch of
label joins cannot do without: each distinct label row it touches read
once, each query's two int64 row ids read once, each float32 answer
written once.
"""
from __future__ import annotations

import numpy as np

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "bf16_flops": 989e12,
                              "f32_flops": 67e12},
}


def peak(device_kind: str, key: str) -> float | None:
    """A peak of the card by its name, or None for a card not in the
    table (the share is then not reported)."""
    row = PEAKS.get(device_kind)
    return None if row is None else row[key]


def join_bytes(rows_touched: int, row_width: int, queries: int,
               elem_bytes: int = 4, id_bytes: int = 8) -> int:
    """Least bytes of one join batch."""
    return (rows_touched * row_width * elem_bytes
            + queries * 2 * id_bytes + queries * 4)


def distinct_rows(ss: np.ndarray, ts: np.ndarray) -> int:
    return int(np.unique(np.concatenate([ss, ts])).size)


def roofline_pct(least_bytes: float, seconds: float, bandwidth: float
                 ) -> float | None:
    if seconds <= 0 or least_bytes <= 0:
        return None
    return 100.0 * (least_bytes / bandwidth) / seconds


def busy_seconds(intervals: list[tuple[int, int]]) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)``
    intervals."""
    if not len(intervals):
        return 0.0
    arr = np.asarray(intervals, dtype=np.int64).reshape(-1, 2)
    arr = arr[np.argsort(arr[:, 0], kind="stable")]
    start, end = arr[:, 0], np.maximum.accumulate(arr[:, 1])
    first = np.ones(len(arr), dtype=bool)
    first[1:] = start[1:] > end[:-1]
    last = np.append(first[1:], True)
    return float((end[last] - start[first]).sum()) / 1e9


def idle_pct(busy_s: float, window_s: float) -> float | None:
    if window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - busy_s / window_s)
