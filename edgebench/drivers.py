"""The ways a traffic mix drives the program, named by the mix's ``driver``
key. ``closed``: one client sends batches back to back.

A driver warms up every shape its mix uses, measures for ``seconds``
(the batch in flight when the time is up completes, and its time counts),
and returns what it measured and the answers to check. It reaches the
program only through ``deploy.Deployment``'s entry points.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from . import roofline, workload
from .network import RoadNetwork


# the window's batches whose answers are all kept for the check: the
# first four, then every power of two
def _keep_whole(i: int) -> bool:
    return i < 4 or (i & (i - 1)) == 0


# lanes kept from every other batch, for the check
SAMPLE_LANES = 64


@dataclass
class Measured:
    """What a driver measured in its window, and what it answered."""
    window_s: float
    attempted: int
    failed: int = 0
    queries: int = 0
    batches: int = 0
    join_least_bytes: int = 0
    # the answers to check: (ss, ts, answers)
    checks: list[tuple] = field(default_factory=list)


def closed(dep, net: RoadNetwork, traffic: dict, seconds: float, rng,
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


DRIVERS = {"closed": closed}
