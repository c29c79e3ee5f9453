"""Discrete-event latency simulator for the §5 dynamic scenario.

Compares user-perceived latency of two deployments over the same query /
traffic-update trace:

* centralized — every query goes client → cloud; after each traffic epoch
  the cloud must rebuild its *whole-graph* index (we charge the measured
  full-PLL or BL+districts build time); queries arriving during the
  rebuild queue until the fresh index is live (stale answers are not
  allowed in either deployment — apples to apples).
* edge — §4.2: rule-1/2 queries are answered at edge servers, rule-3 at
  the center. During a rebuild window an edge server answers certified
  queries immediately via the Local Bound (Theorem 3); uncertified local
  queries and rule-3 queries wait for the (much shorter) BL rebuild.

Service is modeled as M/D/1-style FIFO per server (deterministic service
time from the latency model); network hops from ``Topology``. All times in
milliseconds; the trace is deterministic given a seed.

A copy of the JAX package's ``repro.edge.simulator``, NumPy only, but
for ``run_update_epochs``: it drives the port's ``EdgeSystem`` and
times the port's ``IncrementalBuilder`` on the system's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from ..core.graph import Graph
from ..core.partition import Partition
from .topology import Topology

if TYPE_CHECKING:                                   # pragma: no cover
    from ..serve.service import ServingPolicy

INF = float("inf")


@dataclass
class QueryEvent:
    t_ms: float
    s: int
    t: int


@dataclass(frozen=True)
class MigrationEvent:
    """One district migration on the simulated clock: the routing swap
    lands at ``t_ms`` (queries at t >= t_ms route to ``dst_host``); the
    table copy occupies the declared window [t_ms - copy_ms, t_ms).
    Inside the window the ``ServingPolicy.migration`` discipline
    applies: ``"dual"`` keeps the source host serving exactly (the
    engine-swap semantics of ``EdgeSystem.migrate`` — snapshots are
    content-addressed by index version, so nothing goes stale) and
    ``"handoff"`` flags window queries stale."""
    t_ms: float
    district: int
    src_host: int
    dst_host: int
    copy_ms: float = 0.0


def migrations_from_plan(plan, t_ms: float,
                         copy_ms: float = 0.0) -> list[MigrationEvent]:
    """Lift a ``topo.MigrationPlan`` onto the simulated clock:
    every move swaps at ``t_ms`` with the same declared copy window."""
    return [MigrationEvent(float(t_ms), m.district, m.src_host, m.dst_host,
                           float(copy_ms)) for m in plan.moves]


class _PlacementTimeline:
    """Time-varying district → edge-host routing: the base placement
    plus a migration schedule.  ``host_at`` is the routing table a
    client stub sees at time t; ``in_copy_window`` tests the declared
    migration window."""

    def __init__(self, placement, migrations=()):
        host_of = getattr(placement, "host_of", placement)
        self.base = np.asarray(host_of, dtype=np.int32)
        hosts = int(self.base.max()) + 1 if len(self.base) else 1
        self.num_hosts = int(getattr(placement, "num_hosts", hosts))
        self._moves: dict[int, list[MigrationEvent]] = {}
        for mv in (migrations or ()):
            self._moves.setdefault(int(mv.district), []).append(mv)
        for lst in self._moves.values():
            lst.sort(key=lambda m: m.t_ms)

    def host_at(self, d: int, t_ms: float) -> int:
        host = int(self.base[d])
        for mv in self._moves.get(int(d), ()):
            if t_ms >= mv.t_ms:
                host = int(mv.dst_host)
        return host

    def in_copy_window(self, d: int, t_ms: float) -> bool:
        return any(mv.t_ms - mv.copy_ms <= t_ms < mv.t_ms
                   for mv in self._moves.get(int(d), ()))


@dataclass
class SimResult:
    latencies_ms: np.ndarray
    mean_ms: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    lb_certified_frac: float = 0.0
    waited_frac: float = 0.0
    stale_frac: float = 0.0     # served stale under the stale_ok policy
    degraded_frac: float = 0.0  # flagged non-exact under injected faults
    # migration accounting (None / 0 unless a placement was simulated):
    # per-query masks for the exactness-outside-the-window assertion
    migration_stale_frac: float = 0.0   # flagged stale under "handoff"
    migration_window_mask: np.ndarray | None = field(default=None,
                                                     repr=False)
    nonexact_mask: np.ndarray | None = field(default=None, repr=False)

    @classmethod
    def from_latencies(cls, lat: np.ndarray, lb_frac=0.0, waited=0.0,
                       stale=0.0, degraded=0.0):
        if len(lat) == 0:       # empty trace: zeros, not NaN + warnings
            return cls(np.asarray(lat, dtype=np.float64), 0.0, 0.0, 0.0,
                       0.0, lb_frac, waited, stale, degraded)
        return cls(lat, float(lat.mean()), float(np.percentile(lat, 50)),
                   float(np.percentile(lat, 95)),
                   float(np.percentile(lat, 99)), lb_frac, waited, stale,
                   degraded)

    def row(self, name: str) -> dict:
        return {"system": name, "mean_ms": round(self.mean_ms, 3),
                "p50_ms": round(self.p50_ms, 3),
                "p95_ms": round(self.p95_ms, 3),
                "p99_ms": round(self.p99_ms, 3),
                "lb_certified": round(self.lb_certified_frac, 3),
                "waited": round(self.waited_frac, 3),
                "stale": round(self.stale_frac, 3),
                "degraded": round(self.degraded_frac, 3),
                "migration_stale": round(self.migration_stale_frac, 3)}


def make_trace(g: Graph, num_queries: int, horizon_ms: float,
               seed: int = 0, shape: str = "uniform") -> list[QueryEvent]:
    """Query trace with arrival times drawn from a traffic shape
    (``edge.traffic``: uniform / diurnal / flash_crowd — shared
    with the open-loop load harness).  ``uniform`` reproduces the
    historical trace bit-for-bit."""
    from .traffic import arrival_times
    rng = np.random.default_rng(seed)
    times = arrival_times(num_queries, horizon_ms, shape=shape, rng=rng)
    ss = rng.integers(0, g.num_vertices, size=num_queries)
    ts = rng.integers(0, g.num_vertices, size=num_queries)
    return [QueryEvent(float(a), int(b), int(c))
            for a, b, c in zip(times, ss, ts)]


@dataclass
class _Server:
    """FIFO single server: returns departure time for an arrival."""
    service_ms: float
    busy_until: float = 0.0

    def serve(self, arrival_ms: float) -> float:
        start = max(arrival_ms, self.busy_until)
        self.busy_until = start + self.service_ms
        return self.busy_until


@dataclass(frozen=True)
class BatchPolicy:
    """Micro-batched service (the DistanceBatcher / DistanceService
    model):
    requests accumulate at a server until ``batch_size`` are pending or
    the oldest has waited ``window_ms``; the whole batch is then served in
    one vectorized call charged ``overhead_ms + size · per_query_ms``.
    Amortization wins once traffic is heavy: per-query cost collapses
    from ``service_ms`` to ``per_query_ms`` at full batches."""
    batch_size: int = 64
    window_ms: float = 2.0
    overhead_ms: float = 0.2
    per_query_ms: float = 0.002


class _BatchedServer:
    """FIFO micro-batching server: departures are assigned when a batch
    flushes (full, window expiry, or end of trace)."""

    def __init__(self, policy: BatchPolicy):
        self.policy = policy
        self.busy_until = 0.0
        self.pending: list[tuple[int, float]] = []   # (query idx, ready_ms)
        self._min_ready = np.inf        # running min over pending ready_ms

    def _flush(self, close_ms: float, departures: np.ndarray) -> None:
        if not self.pending:
            return
        # a batch runs when closed, the server is free, AND every member
        # is ready (rebuild-window waits hold their batch back)
        start = max(close_ms, self.busy_until,
                    max(r for _, r in self.pending))
        done = start + self.policy.overhead_ms \
            + len(self.pending) * self.policy.per_query_ms
        for qi, _ in self.pending:
            departures[qi] = done
        self.busy_until = done
        self.pending.clear()
        self._min_ready = np.inf

    def _window_close_ms(self) -> float:
        # the window is anchored on the oldest *ready* time, not on the
        # submission order: a rebuild-window wait (max(arrive,
        # global_ready)) can push an earlier query's ready time past
        # later arrivals, so pending[0] need not hold the minimum
        return self._min_ready + self.policy.window_ms

    def submit(self, qi: int, ready_ms: float,
               departures: np.ndarray) -> None:
        # close an expired window before admitting the new arrival
        if self.pending:
            close = self._window_close_ms()
            if ready_ms >= close:
                self._flush(close, departures)
        self.pending.append((qi, ready_ms))
        self._min_ready = min(self._min_ready, ready_ms)
        if len(self.pending) >= self.policy.batch_size:
            self._flush(ready_ms, departures)

    def finish(self, departures: np.ndarray) -> None:
        if self.pending:
            self._flush(self._window_close_ms(), departures)


@dataclass
class UpdateSchedule:
    """Traffic epochs: the first weight change lands at ``epoch_ms`` and
    repeats every ``epoch_ms`` after; each change forces a rebuild before
    fresh answers can be served.  The interval before the first update
    (t < epoch_ms) is served from the pre-deployed index and is always
    fresh — matching ``VariableUpdateSchedule``'s k < 0 behavior (the
    old code charged a phantom rebuild window in epoch 0, making queries
    near t=0 wait for a rebuild no traffic update had triggered)."""
    epoch_ms: float
    rebuild_ms_centralized: float
    rebuild_ms_edge_bl: float      # center's BL rebuild
    rebuild_ms_edge_local: float   # per-edge-server local refresh (parallel)

    def fresh_at_centralized(self, t_ms: float) -> float:
        """Earliest time a fresh centralized index is available for t."""
        epoch_start = (t_ms // self.epoch_ms) * self.epoch_ms
        if epoch_start <= 0.0:      # before the first traffic update
            return t_ms
        ready = epoch_start + self.rebuild_ms_centralized
        return ready if t_ms < ready else t_ms

    def edge_windows(self, t_ms: float) -> tuple[float, float]:
        """(local_ready, global_ready) for time t in the edge deployment:
        local indexes refresh in parallel quickly; the BL (+ shortcut push)
        takes rebuild_ms_edge_bl."""
        epoch_start = (t_ms // self.epoch_ms) * self.epoch_ms
        if epoch_start <= 0.0:      # before the first traffic update
            return 0.0, 0.0
        local_ready = epoch_start + self.rebuild_ms_edge_local
        global_ready = epoch_start + self.rebuild_ms_edge_bl
        return local_ready, global_ready


@dataclass
class VariableUpdateSchedule:
    """Per-epoch traffic-update windows (the measured counterpart of the
    fixed-rate ``UpdateSchedule``): epoch k starts at ``epoch_starts[k]``
    and each deployment's index is fresh again at the matching absolute
    ready time.  Built from *measured* rebuild timings by
    ``run_update_epochs`` so the simulator charges what the index layer
    actually costs — incremental repair for the edge deployment, a full
    rebuild for the centralized baseline."""
    epoch_starts: np.ndarray        # (K,) ascending, ms
    centralized_ready: np.ndarray   # (K,) absolute ms
    local_ready: np.ndarray         # (K,) absolute ms
    global_ready: np.ndarray        # (K,) absolute ms

    @classmethod
    def from_timings(cls, epoch_starts, centralized_s, local_s, global_s,
                     scale: float = 1e3) -> "VariableUpdateSchedule":
        """Absolute windows from epoch starts (ms) + per-epoch rebuild
        seconds (``scale`` converts: 1e3 charges measured seconds as
        ms of simulated time)."""
        starts = np.asarray(epoch_starts, dtype=np.float64)
        return cls(starts,
                   starts + np.asarray(centralized_s) * scale,
                   starts + np.asarray(local_s) * scale,
                   starts + np.asarray(global_s) * scale)

    def _epoch(self, t_ms: float) -> int:
        return int(np.searchsorted(self.epoch_starts, t_ms,
                                   side="right")) - 1

    def fresh_at_centralized(self, t_ms: float) -> float:
        k = self._epoch(t_ms)
        if k < 0:
            return t_ms
        ready = float(self.centralized_ready[k])
        return ready if t_ms < ready else t_ms

    def edge_windows(self, t_ms: float) -> tuple[float, float]:
        k = self._epoch(t_ms)
        if k < 0:
            return 0.0, 0.0
        return float(self.local_ready[k]), float(self.global_ready[k])


def run_update_epochs(system, scenario: str, num_epochs: int,
                      epoch_ms: float, *, seed: int = 0,
                      intensity: float = 0.05, incremental: bool = True,
                      measure_full: bool = True
                      ) -> tuple[VariableUpdateSchedule, list[dict]]:
    """Drive a live ``EdgeSystem`` through scenario-generated traffic
    epochs and return a measured ``VariableUpdateSchedule`` + per-epoch
    reports.

    Each epoch draws a fresh weight delta from ``update.scenarios``
    against the *current* graph, applies it through
    ``EdgeSystem.apply_traffic_update`` (incremental by default), and —
    when ``measure_full`` — also times an honest from-scratch build of
    the same index on the new weights (a fresh ``IncrementalBuilder``
    each epoch, so no cache flatters it).  The schedule charges the edge
    deployment the *measured* repair time and the centralized baseline
    the *measured* full-rebuild time, replacing the hand-tuned constants
    of ``UpdateSchedule``.  The from-scratch build runs on the system's
    device and is timed after a device synchronise.
    """
    import time as _time

    import torch

    from ..update.incremental import IncrementalBuilder
    from ..update.scenarios import scenario_weights

    device = system.device
    rng = np.random.default_rng(seed)
    reports: list[dict] = []
    starts = (1.0 + np.arange(num_epochs)) * epoch_ms
    for k in range(num_epochs):
        w2 = scenario_weights(scenario, system.graph, system.partition,
                              rng, intensity)
        full_s = 0.0
        if measure_full:
            g2 = system.graph.with_weights(w2)
            t0 = _time.perf_counter()
            IncrementalBuilder(device=device).build_full(g2,
                                                          system.partition)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            full_s = _time.perf_counter() - t0
        rep = system.apply_traffic_update(w2, incremental=incremental)
        local = rep["local_refresh_s"]
        local_vals = list(local.values() if isinstance(local, dict)
                          else local)
        push = rep["shortcut_install_s"]
        push_vals = list(push.values() if isinstance(push, dict) else push)
        # edge servers refresh in parallel; the push lands after repair
        rep["epoch_ms"] = float(starts[k])
        rep["full_rebuild_s"] = full_s
        rep["local_parallel_s"] = max(local_vals, default=0.0)
        rep["global_ready_s"] = (rep["bl_rebuild_s"]
                                 + max(push_vals, default=0.0))
        reports.append(rep)
    schedule = VariableUpdateSchedule.from_timings(
        starts,
        [r["full_rebuild_s"] for r in reports],
        [r["local_parallel_s"] for r in reports],
        [r["global_ready_s"] for r in reports])
    return schedule, reports


def simulate_centralized(trace: list[QueryEvent], topo: Topology,
                         schedule: "UpdateSchedule | VariableUpdateSchedule"
                         ) -> SimResult:
    server = _Server(topo.latency.centralized_service_ms)
    lat = np.empty(len(trace), dtype=np.float64)
    waited = 0
    for i, ev in enumerate(trace):
        arrive_cloud = ev.t_ms + topo.latency.client_center_ms
        ready = schedule.fresh_at_centralized(arrive_cloud)
        if ready > arrive_cloud:
            waited += 1
        done = server.serve(max(arrive_cloud, ready))
        lat[i] = done + topo.latency.client_center_ms - ev.t_ms
    return SimResult.from_latencies(lat, waited=waited / max(1, len(trace)))


def _resolve_injector(faults, policy):
    """FaultInjector from an explicit plan or ``policy.faults`` (None
    when nothing is enabled — the clean path stays untouched)."""
    plan = faults if faults is not None else getattr(policy, "faults", None)
    if plan is None or not getattr(plan, "enabled", False):
        return None
    from .faults import FaultInjector
    return FaultInjector(plan)


def simulate_edge(trace: list[QueryEvent], topo: Topology,
                  schedule: "UpdateSchedule | VariableUpdateSchedule",
                  assignment: np.ndarray,
                  certified_fn, num_districts: int,
                  batch: BatchPolicy | None = None,
                  policy: "ServingPolicy | None" = None,
                  faults=None, placement=None,
                  migrations=None) -> SimResult:
    """``certified_fn(s, t) -> bool`` — whether Theorem 3 certifies the
    local answer for a same-district pair (precomputed by the caller from
    the actual indexes, so the simulation uses real certification rates;
    ``DistanceService.certifier()`` produces exactly this shape).

    With ``batch`` set, every server runs in micro-batched service mode
    (the DistanceService engine behind a DistanceBatcher) instead of
    per-query FIFO service.

    ``policy`` (a ``serve.ServingPolicy``) drives both knobs from
    the same config the functional service uses: ``policy.batch``
    supplies the micro-batching discipline when ``batch`` is not given,
    ``policy.rebuild == "stale_ok"`` switches the rebuild-window
    discipline from wait-for-push to serve-stale-immediately (uncertified
    window queries are answered from the stale index with no wait and
    counted in ``SimResult.stale_frac``; the ``install_now`` and
    ``certify_or_wait`` modes both charge the wait — functionally they
    only differ in who pays for the install), and ``policy.engine ==
    "scatter_gather"`` routes rule-3 queries to the SOURCE district's
    edge server over the ``peer_edge_ms`` link (peer border-row
    exchange) instead of forwarding through the center's WAN hops —
    the center leaves the read path, so cross-district load also stops
    queueing at one shared server.

    ``faults`` (or ``policy.faults``) attaches a deterministic
    ``edge.faults.FaultPlan``: dark servers reroute cross lanes to the
    survivor, dead peer links are charged the retry/backoff budget then
    forwarded through the center, and lanes that can only be served
    stale/unavailable are counted in ``SimResult.degraded_frac``.

    ``placement`` (a ``topo.EdgePlacement`` or a host_of array)
    consolidates the per-district queues onto shared edge *hosts* — the
    deployment shape the online repartitioner manages.  ``migrations``
    (a list of ``MigrationEvent``) moves districts between hosts on the
    simulated clock; ``policy.migration`` picks the copy-window
    discipline (``"dual"`` = source serves exactly until the swap,
    ``"handoff"`` = window queries flagged stale).  With a placement
    simulated, ``SimResult.migration_window_mask`` /
    ``SimResult.nonexact_mask`` expose per-query flags so exactness
    outside the declared window can be asserted.
    """
    stale_ok = policy is not None and policy.rebuild == "stale_ok"
    scatter = policy is not None and policy.engine == "scatter_gather"
    handoff = (policy is not None
               and getattr(policy, "migration", "dual") == "handoff")
    inj = _resolve_injector(faults, policy)
    if migrations and placement is None:
        raise ValueError("migrations require an explicit placement")
    tl = (_PlacementTimeline(placement, migrations)
          if placement is not None else None)
    if batch is None and policy is not None:
        batch = policy.batch
    if batch is not None:
        return _simulate_edge_batched(trace, topo, schedule, assignment,
                                      certified_fn, num_districts, batch,
                                      stale_ok=stale_ok, scatter=scatter,
                                      inj=inj, tl=tl, handoff=handoff)
    edge_servers = [_Server(topo.latency.edge_service_ms)
                    for _ in range(tl.num_hosts if tl is not None
                                   else num_districts)]
    center = _Server(topo.latency.center_service_ms)
    lat = np.empty(len(trace), dtype=np.float64)
    certified_n = 0
    waited = 0
    stale_n = 0
    degraded_n = 0
    if tl is not None:
        hidx = tl.host_at
        win_mask = np.zeros(len(trace), dtype=bool)
        mig_stale = np.zeros(len(trace), dtype=bool)
        nonexact = np.zeros(len(trace), dtype=bool)
    else:
        def hidx(d, t_ms):
            return d
        win_mask = mig_stale = nonexact = None

    def _mark(i, d, t_ms):
        # the query read district d's table on an edge host: flag the
        # declared copy window (and, under handoff, the staleness)
        if tl is not None and tl.in_copy_window(d, t_ms):
            win_mask[i] = True
            if handoff:
                mig_stale[i] = True
                nonexact[i] = True

    lm = topo.latency
    for i, ev in enumerate(trace):
        if inj is not None:
            inj.tick()
        ds, dt = int(assignment[ev.s]), int(assignment[ev.t])
        local_ready, global_ready = schedule.edge_windows(ev.t_ms)
        if ds == dt:
            arrive = ev.t_ms + lm.client_edge_ms
            if inj is not None and inj.server_down(ds):
                # dark district: the center's B join is a certified
                # upper bound — served over the WAN, flagged degraded;
                # with the center dark too, a flat flagged failure
                degraded_n += 1
                if nonexact is not None:
                    nonexact[i] = True
                if not inj.center_down():
                    a = ev.t_ms + lm.client_edge_ms + lm.edge_center_ms
                    done = center.serve(a)
                    lat[i] = done + lm.edge_center_ms + lm.client_edge_ms \
                        - ev.t_ms
                else:
                    lat[i] = 2 * lm.client_edge_ms
                continue
            if arrive >= global_ready:          # L_i⁺ fresh: exact at edge
                _mark(i, ds, ev.t_ms)
                done = edge_servers[hidx(ds, ev.t_ms)].serve(arrive)
                lat[i] = done + lm.client_edge_ms - ev.t_ms
                continue
            # rebuild window: LB certificate on the fresh plain L_i
            if arrive >= local_ready and certified_fn(ev.s, ev.t):
                certified_n += 1
                _mark(i, ds, ev.t_ms)
                done = edge_servers[hidx(ds, ev.t_ms)].serve(arrive)
                lat[i] = done + lm.client_edge_ms - ev.t_ms
                continue
            if stale_ok:                        # serve stale, no wait
                stale_n += 1
                if nonexact is not None:
                    nonexact[i] = True
                _mark(i, ds, ev.t_ms)
                done = edge_servers[hidx(ds, ev.t_ms)].serve(arrive)
                lat[i] = done + lm.client_edge_ms - ev.t_ms
                continue
            # must wait for the shortcut push (global_ready)
            waited += 1
            _mark(i, ds, ev.t_ms)
            done = edge_servers[hidx(ds, ev.t_ms)].serve(
                max(arrive, global_ready))
            lat[i] = done + lm.client_edge_ms - ev.t_ms
        elif scatter:
            # peer border-row exchange: one metro hop to fetch B[t] from
            # the target district's server, answered at the OWN server
            # (exchanged rows come from the same B rebuild, so the
            # freshness window is unchanged)
            arrive = ev.t_ms + lm.client_edge_ms + lm.peer_edge_ms
            if arrive < global_ready:
                if stale_ok:
                    stale_n += 1
                    if nonexact is not None:
                        nonexact[i] = True
                else:
                    waited += 1
                    arrive = global_ready
            if inj is None:
                _mark(i, ds, ev.t_ms)
                done = edge_servers[hidx(ds, ev.t_ms)].serve(arrive)
                lat[i] = done + lm.peer_edge_ms + lm.client_edge_ms \
                    - ev.t_ms
                continue
            src_dark = inj.server_down(ds)
            if src_dark and not inj.server_down(dt):
                # rule 3 from the surviving min: the target district's
                # server owns the lane — exact, same peer math
                _mark(i, dt, ev.t_ms)
                done = edge_servers[hidx(dt, ev.t_ms)].serve(arrive)
                lat[i] = done + lm.peer_edge_ms + lm.client_edge_ms \
                    - ev.t_ms
                continue
            if src_dark:                        # both districts dark
                if not inj.center_down():       # forwarded: still exact
                    a = arrive - lm.peer_edge_ms + lm.edge_center_ms
                    done = center.serve(a)
                    lat[i] = done + lm.edge_center_ms + lm.client_edge_ms \
                        - ev.t_ms
                else:                           # flagged unavailable
                    degraded_n += 1
                    if nonexact is not None:
                        nonexact[i] = True
                    lat[i] = 2 * lm.client_edge_ms
                continue
            ok, fault, charged, slow = inj.link_trial(ds, dt)
            if ok:
                if slow:                        # degraded (slow) link
                    charged += (inj.plan.slow_factor - 1) * lm.peer_edge_ms
                _mark(i, ds, ev.t_ms)
                done = edge_servers[hidx(ds, ev.t_ms)].serve(
                    arrive + charged)
                lat[i] = done + lm.peer_edge_ms + lm.client_edge_ms \
                    - ev.t_ms
            elif not inj.center_down():
                # peer link dead: forwarded-path fallback, still exact
                a = arrive - lm.peer_edge_ms + charged + lm.edge_center_ms
                done = center.serve(a)
                lat[i] = done + lm.edge_center_ms + lm.client_edge_ms \
                    - ev.t_ms
            else:
                # stale previous-generation rows (or flagged +inf),
                # served locally after the failed retries
                degraded_n += 1
                if nonexact is not None:
                    nonexact[i] = True
                _mark(i, ds, ev.t_ms)
                done = edge_servers[hidx(ds, ev.t_ms)].serve(
                    arrive - lm.peer_edge_ms + charged)
                lat[i] = done + lm.client_edge_ms - ev.t_ms
        else:
            arrive = ev.t_ms + lm.client_edge_ms + lm.edge_center_ms
            if arrive < global_ready:
                if stale_ok:    # the center's double-buffered old B serves
                    stale_n += 1
                    if nonexact is not None:
                        nonexact[i] = True
                else:
                    waited += 1
                    arrive = global_ready
            if inj is not None and inj.center_down():
                # forwarded path with the center dark: flagged local
                # stale serve instead of an error
                degraded_n += 1
                if nonexact is not None:
                    nonexact[i] = True
                _mark(i, ds, ev.t_ms)
                a = ev.t_ms + lm.client_edge_ms
                done = edge_servers[hidx(ds, ev.t_ms)].serve(a)
                lat[i] = done + lm.client_edge_ms - ev.t_ms
                continue
            done = center.serve(arrive)
            lat[i] = done + lm.edge_center_ms + lm.client_edge_ms - ev.t_ms
    res = SimResult.from_latencies(
        lat, lb_frac=certified_n / max(1, len(trace)),
        waited=waited / max(1, len(trace)),
        stale=stale_n / max(1, len(trace)),
        degraded=degraded_n / max(1, len(trace)))
    if tl is not None:
        res.migration_window_mask = win_mask
        res.nonexact_mask = nonexact
        res.migration_stale_frac = float(mig_stale.sum()) / max(1, len(trace))
    return res


def _simulate_edge_batched(trace: list[QueryEvent], topo: Topology,
                           schedule: UpdateSchedule, assignment: np.ndarray,
                           certified_fn, num_districts: int,
                           batch: BatchPolicy,
                           stale_ok: bool = False,
                           scatter: bool = False,
                           inj=None, tl=None,
                           handoff: bool = False) -> SimResult:
    """§4.2 routing with micro-batched service at every server: same
    freshness rules as the per-query path, but departures are assigned at
    batch flush time (see _BatchedServer).  ``scatter`` routes rule-3
    lanes to the source district's server over the peer link; ``inj``
    (a ``FaultInjector``) applies the same degradation ladder as the
    per-query path; ``tl`` (a ``_PlacementTimeline``) consolidates the
    queues onto edge hosts and applies the migration schedule (see
    simulate_edge)."""
    edge_servers = [_BatchedServer(batch)
                    for _ in range(tl.num_hosts if tl is not None
                                   else num_districts)]
    center = _BatchedServer(batch)
    departures = np.empty(len(trace), dtype=np.float64)
    back_ms = np.empty(len(trace), dtype=np.float64)
    certified_n = 0
    waited = 0
    stale_n = 0
    degraded_n = 0
    if tl is not None:
        hidx = tl.host_at
        win_mask = np.zeros(len(trace), dtype=bool)
        mig_stale = np.zeros(len(trace), dtype=bool)
        nonexact = np.zeros(len(trace), dtype=bool)
    else:
        def hidx(d, t_ms):
            return d
        win_mask = mig_stale = nonexact = None

    def _mark(i, d, t_ms):
        if tl is not None and tl.in_copy_window(d, t_ms):
            win_mask[i] = True
            if handoff:
                mig_stale[i] = True
                nonexact[i] = True

    lm = topo.latency
    for i, ev in enumerate(trace):
        if inj is not None:
            inj.tick()
        ds, dt = int(assignment[ev.s]), int(assignment[ev.t])
        local_ready, global_ready = schedule.edge_windows(ev.t_ms)
        if ds == dt:
            arrive = ev.t_ms + lm.client_edge_ms
            back_ms[i] = lm.client_edge_ms
            if inj is not None and inj.server_down(ds):
                degraded_n += 1     # dark district: center upper bound
                if nonexact is not None:
                    nonexact[i] = True
                if not inj.center_down():
                    back_ms[i] = lm.edge_center_ms + lm.client_edge_ms
                    center.submit(i, arrive + lm.edge_center_ms,
                                  departures)
                else:               # flat flagged failure, no service
                    departures[i] = arrive
                continue
            if arrive >= global_ready:          # L_i⁺ fresh: exact at edge
                _mark(i, ds, ev.t_ms)
                edge_servers[hidx(ds, ev.t_ms)].submit(i, arrive,
                                                       departures)
                continue
            # rebuild window: LB certificate on the fresh plain L_i
            if arrive >= local_ready and certified_fn(ev.s, ev.t):
                certified_n += 1
                _mark(i, ds, ev.t_ms)
                edge_servers[hidx(ds, ev.t_ms)].submit(i, arrive,
                                                       departures)
                continue
            if stale_ok:                        # serve stale, no wait
                stale_n += 1
                if nonexact is not None:
                    nonexact[i] = True
                _mark(i, ds, ev.t_ms)
                edge_servers[hidx(ds, ev.t_ms)].submit(i, arrive,
                                                       departures)
                continue
            waited += 1
            _mark(i, ds, ev.t_ms)
            edge_servers[hidx(ds, ev.t_ms)].submit(
                i, max(arrive, global_ready), departures)
        elif scatter:
            arrive = ev.t_ms + lm.client_edge_ms + lm.peer_edge_ms
            back_ms[i] = lm.peer_edge_ms + lm.client_edge_ms
            if arrive < global_ready:
                if stale_ok:
                    stale_n += 1
                    if nonexact is not None:
                        nonexact[i] = True
                else:
                    waited += 1
                    arrive = global_ready
            if inj is None:
                _mark(i, ds, ev.t_ms)
                edge_servers[hidx(ds, ev.t_ms)].submit(i, arrive,
                                                       departures)
                continue
            src_dark = inj.server_down(ds)
            if src_dark and not inj.server_down(dt):
                # surviving-min reroute: target server, same peer math
                _mark(i, dt, ev.t_ms)
                edge_servers[hidx(dt, ev.t_ms)].submit(i, arrive,
                                                       departures)
                continue
            if src_dark:                        # both districts dark
                if not inj.center_down():
                    back_ms[i] = lm.edge_center_ms + lm.client_edge_ms
                    center.submit(i, arrive - lm.peer_edge_ms
                                  + lm.edge_center_ms, departures)
                else:
                    degraded_n += 1
                    if nonexact is not None:
                        nonexact[i] = True
                    back_ms[i] = lm.client_edge_ms
                    departures[i] = ev.t_ms + lm.client_edge_ms
                continue
            ok, fault, charged, slow = inj.link_trial(ds, dt)
            if ok:
                if slow:
                    charged += (inj.plan.slow_factor - 1) * lm.peer_edge_ms
                _mark(i, ds, ev.t_ms)
                edge_servers[hidx(ds, ev.t_ms)].submit(i, arrive + charged,
                                                       departures)
            elif not inj.center_down():         # forwarded: still exact
                back_ms[i] = lm.edge_center_ms + lm.client_edge_ms
                center.submit(i, arrive - lm.peer_edge_ms + charged
                              + lm.edge_center_ms, departures)
            else:                               # local stale, flagged
                degraded_n += 1
                if nonexact is not None:
                    nonexact[i] = True
                _mark(i, ds, ev.t_ms)
                edge_servers[hidx(ds, ev.t_ms)].submit(
                    i, arrive - lm.peer_edge_ms + charged, departures)
        else:
            arrive = ev.t_ms + lm.client_edge_ms + lm.edge_center_ms
            back_ms[i] = lm.edge_center_ms + lm.client_edge_ms
            if arrive < global_ready:
                if stale_ok:
                    stale_n += 1
                    if nonexact is not None:
                        nonexact[i] = True
                else:
                    waited += 1
                    arrive = global_ready
            if inj is not None and inj.center_down():
                degraded_n += 1     # center dark: flagged local serve
                if nonexact is not None:
                    nonexact[i] = True
                _mark(i, ds, ev.t_ms)
                back_ms[i] = lm.client_edge_ms
                edge_servers[hidx(ds, ev.t_ms)].submit(
                    i, ev.t_ms + lm.client_edge_ms, departures)
                continue
            center.submit(i, arrive, departures)
    for srv in edge_servers:
        srv.finish(departures)
    center.finish(departures)
    lat = departures + back_ms - np.array([ev.t_ms for ev in trace])
    res = SimResult.from_latencies(
        lat, lb_frac=certified_n / max(1, len(trace)),
        waited=waited / max(1, len(trace)),
        stale=stale_n / max(1, len(trace)),
        degraded=degraded_n / max(1, len(trace)))
    if tl is not None:
        res.migration_window_mask = win_mask
        res.nonexact_mask = nonexact
        res.migration_stale_frac = float(mig_stale.sum()) / max(1, len(trace))
    return res
