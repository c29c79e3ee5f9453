"""Micro-batching queue for distance queries.

The serving front door of the edge deployment: clients submit (s, t)
requests one at a time; the batcher packs them into fixed-shape groups of
``batch_size`` (padding short groups with rid=-1 dummy pairs so the
engine — and hence the device — only ever sees static shapes) and drains
each group through one vectorized engine call.  Per-request latency is
recorded for the serving benchmarks; padding requests never reach
``completed`` or the latency statistics.

The preferred engine is a ``DistanceService`` (or an ``EdgeSystem``,
which is wrapped in one): the batcher then passes the padding mask
through, so rid=-1 dummies are excluded from the service's rule
counters too.  Any ``QueryPlane`` (an object with
``execute(ss, ts) -> distances`` — e.g. a ``BatchedQueryEngine``
snapshot), a bare callable with that signature, or a legacy object
exposing ``query_batched`` / ``query`` also plugs in.

Host-side orchestration only — the same scheduler shape as the LM
``serve.batcher.BatchedDecoder``, minus the autoregressive loop: a
distance batch completes in a single engine call.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np


@dataclass
class DistanceRequest:
    rid: int
    s: int
    t: int
    submitted_s: float = field(default_factory=time.perf_counter)
    distance: float | None = None
    finished_s: float | None = None

    @property
    def latency_s(self) -> float:
        return (self.finished_s or time.perf_counter()) - self.submitted_s


class DistanceBatcher:
    """Drains queued distance requests through a batched engine.

    ``engine`` resolution order:

    1. a ``DistanceService`` — groups run through ``service.submit``
       with the padding mask, so dummies never inflate the counters;
    2. an ``EdgeSystem`` — wrapped in its default ``service()`` (same
       masking);
    3. a bare callable ``(ss, ts) -> distances``;
    4. an object exposing ``query_batched`` / ``query`` with that
       signature, or ``execute`` (the ``QueryPlane`` protocol).

    Anything else raises ``TypeError`` naming the expected interface.

    ``pad=True`` (default) guarantees the engine always sees exactly
    ``batch_size`` pairs by filling short tail groups with rid=-1
    dummies.  For non-service engines the dummies are real (0, 0)
    queries from the engine's point of view, but they never enter
    ``completed`` or the latency statistics.  Engines that already pad
    internally to bounded shapes can run with ``pad=False``.

    ``max_queue`` bounds the admission queue (load shedding under
    overload): once that many requests are pending, further ``submit``
    calls are *dropped* — counted in ``shed_count``, never answered,
    never part of the latency statistics.  ``None`` (default) admits
    everything (the historical unbounded queue)."""

    def __init__(self, engine: Callable[[np.ndarray, np.ndarray],
                                        np.ndarray],
                 batch_size: int = 256, pad: bool = True,
                 max_queue: int | None = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        # when ``service`` is set, _run_group dispatches through
        # service.submit with the padding mask; ``engine`` then only
        # keeps the distances-only callable for introspection
        self.service = None
        from .service import DistanceService
        if isinstance(engine, DistanceService):
            self.service = engine
            self.engine = engine.distances
        elif callable(engine):
            self.engine = engine
        else:
            from ..edge.router import EdgeSystem
            if isinstance(engine, EdgeSystem):
                self.service = engine.service()
                self.engine = self.service.distances
            else:
                fn = next((getattr(engine, name)
                           for name in ("query_batched", "query", "execute")
                           if callable(getattr(engine, name, None))), None)
                if fn is None:
                    raise TypeError(
                        "DistanceBatcher engine must be a DistanceService, "
                        "an EdgeSystem, a callable (ss, ts) -> distances, "
                        "or an object exposing query_batched/query/execute "
                        "(the QueryPlane protocol); got "
                        f"{type(engine).__name__}")
                self.engine = fn
        self.batch_size = batch_size
        self.pad = pad
        self.max_queue = max_queue
        self.shed_count = 0
        self.queue: deque[DistanceRequest] = deque()
        self.completed: list[DistanceRequest] = []

    def submit(self, req: DistanceRequest) -> bool:
        """Admit a request; returns False (and counts a shed) when the
        bounded queue is full."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.shed_count += 1
            return False
        self.queue.append(req)
        return True

    def submit_pairs(self, pairs: Sequence[tuple[int, int]],
                     rid_base: int = 0) -> int:
        """Submit many pairs; returns how many were admitted."""
        admitted = 0
        for k, (s, t) in enumerate(pairs):
            admitted += self.submit(DistanceRequest(rid=rid_base + k,
                                                    s=int(s), t=int(t)))
        return admitted

    def _run_group(self, group: list[DistanceRequest]) -> None:
        ss = np.array([r.s for r in group], dtype=np.int64)
        ts = np.array([r.t for r in group], dtype=np.int64)
        if self.service is not None:
            real = np.array([r.rid >= 0 for r in group], dtype=bool)
            dist = self.service.submit(ss, ts, real=real).distances
        else:
            dist = np.asarray(self.engine(ss, ts), dtype=np.float32)
        now = time.perf_counter()
        for i, r in enumerate(group):
            r.distance = float(dist[i])
            r.finished_s = now
            if r.rid >= 0:          # padding never reaches ``completed``
                self.completed.append(r)

    def run(self) -> list[DistanceRequest]:
        """Drain the queue in fixed-size groups (short tails padded with
        rid=-1 dummies → static engine shapes); returns completed real
        requests, padding discarded."""
        while self.queue:
            group = [self.queue.popleft()
                     for _ in range(min(self.batch_size, len(self.queue)))]
            while self.pad and len(group) < self.batch_size:
                group.append(DistanceRequest(rid=-1, s=0, t=0))
            self._run_group(group)
        return self.completed

    def latency_stats(self) -> dict[str, float]:
        """Latency percentiles (ms) over completed REAL requests —
        rid=-1 padding dummies never enter ``completed``, so padded tail
        groups cannot deflate the percentiles; shed requests are counted
        separately and never measured."""
        lat = np.array([r.latency_s for r in self.completed],
                       dtype=np.float64) * 1e3
        if len(lat) == 0:
            return {"count": 0, "shed": self.shed_count, "mean_ms": 0.0,
                    "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                    "p999_ms": 0.0}
        return {"count": int(len(lat)), "shed": self.shed_count,
                "mean_ms": float(lat.mean()),
                "p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
                "p999_ms": float(np.percentile(lat, 99.9))}
