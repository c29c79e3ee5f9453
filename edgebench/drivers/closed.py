"""``closed``: one client sends batches back to back, each answered by the
center's rule-3 join (``entry``: ``center``, ``pairs``: ``cross``)."""
from __future__ import annotations

import time

import numpy as np

from .. import roofline, workload
from ..network import RoadNetwork
from . import SAMPLE_LANES, Measured, _keep_whole


def drive(dep, net: RoadNetwork, traffic: dict, seconds: float, rng,
          tracer) -> Measured:
    """Batches of ``batch`` cross-district pairs, a pool of ``pool``
    distinct batches drawn from the seed and cycled, each answered by the
    center's rule-3 join (``entry``: ``center``)."""
    if traffic["entry"] != "center" or traffic["pairs"] != "cross":
        raise ValueError(f"closed loop: no entry {traffic['entry']!r} "
                         f"for pairs {traffic['pairs']!r}")
    batch = int(traffic["batch"])
    pool = [workload.cross_pairs(net, rng, batch)
            for _ in range(int(traffic["pool"]))]
    lanes = rng.integers(0, batch, size=(SAMPLE_LANES, SAMPLE_LANES))
    width = len(net.border_vertices())
    least = [roofline.join_bytes(roofline.distinct_rows(ss, ts), width,
                                 len(ss)) for ss, ts in pool]
    answer = dep.center.answer_cross_many
    for ss, ts in pool:                  # warm-up: every batch once
        answer(ss, ts)
    dep.sync()
    kept = []
    i = 0
    tracer.start()
    t0 = time.perf_counter_ns()
    end = t0 + int(seconds * 1e9)
    while True:
        b = i % len(pool)
        with tracer.phase("program: answer_cross_many"):
            out = answer(*pool[b])
        sel = lanes[i % SAMPLE_LANES]
        kept.append((b, out if _keep_whole(i) else None, sel, out[sel]))
        i += 1
        if time.perf_counter_ns() >= end:
            break
    t1 = time.perf_counter_ns()
    tracer.stop()
    m = Measured(window_s=(t1 - t0) / 1e9, attempted=i * batch,
                 queries=i * batch, batches=i,
                 join_least_bytes=sum(least[b] for b, *_ in kept))
    ss_all, ts_all, ans_all = [], [], []
    for b, whole, sel, part in kept:
        ss, ts = pool[b]
        if whole is not None:
            ss_all.append(ss)
            ts_all.append(ts)
            ans_all.append(whole)
        else:
            ss_all.append(ss[sel])
            ts_all.append(ts[sel])
            ans_all.append(part)
    m.checks.append((np.concatenate(ss_all), np.concatenate(ts_all),
                     np.concatenate(ans_all)))
    return m
