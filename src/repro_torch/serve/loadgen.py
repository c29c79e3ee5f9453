"""Open-loop load harness: millions of simulated clients driving the
real ``DistanceService``.

The north-star workload ("heavy traffic from millions of users") is an
*open-loop* arrival process: clients issue queries on their own clock —
they do not wait for the previous answer before sending the next — so
offered load is independent of service speed and overload actually
builds a queue instead of self-throttling (the closed-loop fallacy).
The harness

* draws a Poisson arrival count for N clients at a per-client rate and
  shapes the arrival times with the shared traffic profiles
  (``edge.traffic``: uniform / diurnal / flash_crowd);
* runs the micro-batching discipline of ``DistanceBatcher`` /
  ``_BatchedServer`` (flush on full batch or window expiry, FIFO
  service) over a **virtual** millisecond timeline, so a 60-second
  simulated horizon does not take 60 wall-seconds;
* executes every admitted batch through the real
  ``DistanceService.submit`` — padded to one static engine shape, with
  the padding masked out of the service counters — and charges the
  *measured* wall-clock of each dispatch as that batch's virtual
  service time.  Queue-delay-inclusive latency per request is
  ``batch_departure − arrival + network RTT``, with the RTT drawn from
  the §4.1 ``Topology`` helpers (``request_rtt_ms``): cross-district
  requests pay the two-WAN-hop forwarded round trip — or only the
  metro peer link when the service's policy selects the scatter-gather
  plane;
* sheds load under overload when ``max_queue`` is set: an arrival that
  finds that many requests already waiting is dropped (the bounded-
  queue drop policy — goodput holds at capacity while p99 of admitted
  requests stays bounded by the queue depth), and the ``stale_ok``
  rebuild policy keeps serving during index-rebuild windows instead of
  queueing behind the shortcut push (bounded staleness as admission
  control).

``open_rebuild_window`` / ``close_rebuild_window`` expose the §5
rebuild window to the harness: the center rebuilds on new weights and
bumps its version but the shortcut push is withheld, so every
same-district query runs the Theorem-3 certificate path and the
service's rebuild mode (wait vs stale) is what the latency curves
measure.

A copy of the JAX package's ``repro.serve.loadgen`` over the port's
``DistanceService``: with ``service_ms_override`` its report is the
reference's on the same service answers; without it, each batch is
charged the host clock around ``submit``, which returns host numpy
after the device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from ..edge.topology import LatencyModel, Topology
from ..edge.traffic import arrival_times, poisson_count

if TYPE_CHECKING:                                   # pragma: no cover
    from ..edge.router import EdgeSystem
    from .service import DistanceService


def request_rtt_ms(topo: Topology, cross: np.ndarray,
                   scatter: bool = False) -> np.ndarray:
    """Per-request network RTT from the §4.1 ``Topology`` helpers:
    same-district requests pay the 5G edge round trip; cross-district
    requests pay two WAN hops through the center's forwarding agent
    (``forward_rtt_ms``) — or only the metro peer link
    (``peer_rtt_ms``) when the scatter-gather plane answers them
    edge-side.  All RTT math routes through here so a new path slots in
    uniformly (the old inline constants under-charged the forwarded
    path by one WAN round trip)."""
    cross_rtt = topo.peer_rtt_ms() if scatter else topo.forward_rtt_ms()
    return np.where(np.asarray(cross, dtype=bool),
                    cross_rtt, topo.edge_rtt_ms())


def open_rebuild_window(system: "EdgeSystem",
                        new_weights: np.ndarray) -> None:
    """Apply a traffic update but withhold the shortcut push: edge
    servers refresh their plain L_i (fresh certificates) while the
    center rebuilds and bumps its version, so every server is mid-
    window until ``close_rebuild_window`` installs the shortcuts."""
    g2 = system.graph.with_weights(new_weights)
    system.graph = g2
    for srv in system.servers:
        srv.refresh_local(g2, system.partition)     # augmented = None now
    system.center.rebuild(new_weights)


def close_rebuild_window(system: "EdgeSystem") -> None:
    """Install the center's shortcuts on every server (ends the
    window)."""
    for srv in system.servers:
        srv.install_shortcuts(system.graph, system.partition,
                              system.center.shortcuts_for(srv.district_id),
                              system.center.version)


@dataclass
class LoadReport:
    """One open-loop run: offered load, goodput, shed/stale fractions,
    and queue-delay-inclusive latency percentiles (virtual ms)."""
    offered: int                    # arrivals generated
    admitted: int                   # answered (offered - shed)
    shed: int
    horizon_ms: float
    num_clients: int
    shape: str
    offered_qps: float
    goodput_qps: float              # answered per simulated second
    exact_qps: float                # answered AND exact per second
    shed_frac: float
    stale_frac: float               # of admitted (stale_ok residue)
    certified_frac: float           # of admitted (Theorem-3 window hits)
    mean_ms: float
    p50_ms: float
    p99_ms: float
    p999_ms: float
    max_ms: float
    queue_peak: int
    engine_calls: int
    mean_batch_service_ms: float
    degraded_frac: float = 0.0      # of admitted (fault-flagged answers)
    latencies_ms: np.ndarray = field(default=None, repr=False)
    # (m,) int64 answered queries per source district — the load signal
    # topo.RebalancePlanner.observe_load consumes
    district_load: np.ndarray = field(default=None, repr=False)

    def row(self) -> dict:
        """Flat summary (the shape the load benchmark records as config)."""
        return {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in self.__dict__.items()
                if k not in ("latencies_ms", "district_load")}


class OpenLoopLoadGen:
    """Drives a ``DistanceService`` with an open-loop arrival stream.

    ``batch_size`` / ``window_ms`` set the micro-batching discipline
    (same semantics as ``BatchPolicy`` / ``DistanceBatcher``);
    ``max_queue`` bounds the admission queue (None = never shed);
    ``service_ms_override=(overhead_ms, per_query_ms)`` replaces the
    measured per-batch wall-clock with a deterministic service model —
    the real service still answers every batch, only the virtual time
    charged changes (for tests and noise-free expected curves).

    ``closed_loop=N`` switches ``run`` to the *closed-loop* comparison
    mode: N fixed-concurrency clients that each wait for their answer
    before thinking (exponential think time) and issuing the next
    query.  The think rate is set so the fleet *targets* the same
    offered load as the open-loop run (``num_clients ·
    per_client_qps``), but under overload a closed fleet self-throttles
    — offered load collapses to service capacity and the queue (and
    p99) stays flat, which is exactly the closed-loop fallacy the
    open-loop harness exists to avoid.  The load benchmark runs both modes
    over the same service to show the divergence; ``max_queue`` is
    ignored in closed mode (a blocked client IS the admission
    control)."""

    def __init__(self, service: "DistanceService", *,
                 batch_size: int = 1024, window_ms: float = 2.0,
                 max_queue: int | None = None,
                 latency: LatencyModel | None = None,
                 service_ms_override: tuple[float, float] | None = None,
                 closed_loop: int | None = None,
                 seed: int = 0):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if closed_loop is not None and closed_loop < 1:
            raise ValueError("closed_loop must be >= 1 clients")
        self.service = service
        self.batch_size = batch_size
        self.window_ms = window_ms
        self.max_queue = max_queue
        self.latency = latency if latency is not None else LatencyModel()
        self.service_ms_override = service_ms_override
        self.closed_loop = closed_loop
        self.rng = np.random.default_rng(seed)

    def warmup(self) -> None:
        """One all-padding batch through the service: compiles/warms the
        engine path without touching counters or the virtual clock."""
        b = self.batch_size
        zeros = np.zeros(b, dtype=np.int64)
        self.service.submit(zeros, zeros, real=np.zeros(b, dtype=bool))

    def run(self, num_clients: int, per_client_qps: float,
            horizon_ms: float, shape: str = "uniform",
            max_arrivals: int | None = None,
            update_at_frac: float | None = None,
            scenario: str = "incident",
            intensity: float = 0.02) -> LoadReport:
        """One open-loop run over a virtual ``horizon_ms`` timeline.

        ``update_at_frac`` opens a §5 rebuild window (scenario-drawn
        weight delta, shortcut push withheld) when the virtual clock
        crosses that fraction of the horizon; the window stays open for
        the rest of the run so the rebuild policy's overload behavior
        is visible in the tail percentiles.

        With ``closed_loop=N`` set on the generator, the same arguments
        define the *target* offered load (``num_clients ·
        per_client_qps``) but the stream is issued by N blocking
        clients — see the class docstring."""
        if self.closed_loop is not None:
            return self._run_closed(num_clients, per_client_qps, horizon_ms,
                                    shape=shape)
        system = self.service.system
        n_vertices = int(system.graph.num_vertices)
        offered = poisson_count(num_clients, per_client_qps, horizon_ms,
                                rng=self.rng)
        if max_arrivals is not None:
            offered = min(offered, int(max_arrivals))
        arr = arrival_times(offered, horizon_ms, shape=shape, rng=self.rng)
        ss = self.rng.integers(0, n_vertices, size=offered)
        ts = self.rng.integers(0, n_vertices, size=offered)
        assignment = system.partition.assignment
        cross = assignment[ss] != assignment[ts]
        topo = Topology(system.partition.num_districts, self.latency)
        scatter = self.service.policy.engine == "scatter_gather"
        fault_plan = getattr(self.service.policy, "faults", None)
        degraded = np.zeros(offered, dtype=bool)
        if scatter and fault_plan is not None:
            # fault-aware network view: failed/slow links, reroutes, and
            # the lanes that can only be answered degraded (flagged)
            from ..edge.faults import loadgen_network_model
            rtt, degraded, _fault_info = loadgen_network_model(
                fault_plan, topo, assignment[ss], assignment[ts], cross)
        else:
            rtt = request_rtt_ms(topo, cross, scatter=scatter)

        update_at_ms = (None if update_at_frac is None
                        else float(update_at_frac) * horizon_ms)
        latencies = np.empty(offered, dtype=np.float64)
        shed = np.zeros(offered, dtype=bool)
        n_lat = 0
        stale_n = certified_n = 0
        busy_until = 0.0
        pending: list[int] = []
        pending_first = np.inf
        batch_starts: list[float] = []   # retired as the clock passes them
        batch_sizes: list[int] = []
        started_ptr = 0
        queued = 0
        queue_peak = 0
        engine_calls = 0
        service_ms_total = 0.0
        b = self.batch_size
        pad_idx = np.zeros(b, dtype=np.int64)

        def flush(close_ms: float) -> None:
            nonlocal busy_until, pending, pending_first, n_lat
            nonlocal stale_n, certified_n, engine_calls, service_ms_total
            if not pending:
                return
            start = max(close_ms, busy_until)
            idx = np.asarray(pending, dtype=np.int64)
            k = len(idx)
            sb, tb = pad_idx.copy(), pad_idx.copy()
            sb[:k], tb[:k] = ss[idx], ts[idx]
            real = np.zeros(b, dtype=bool)
            real[:k] = True
            t0 = time.perf_counter()
            batch = self.service.submit(sb, tb, real=real)
            wall_s = time.perf_counter() - t0
            if self.service_ms_override is not None:
                overhead_ms, per_query_ms = self.service_ms_override
                service_ms = overhead_ms + k * per_query_ms
            else:
                service_ms = wall_s * 1e3
            done = start + service_ms
            latencies[idx] = done - arr[idx] + rtt[idx]
            codes = batch.exactness_codes[:k]
            stale_n += int((codes == np.uint8(2)).sum())
            certified_n += int((codes == np.uint8(1)).sum())
            busy_until = done
            batch_starts.append(start)
            batch_sizes.append(k)
            engine_calls += 1
            service_ms_total += service_ms
            n_lat += k
            pending = []
            pending_first = np.inf

        window_opened = update_at_ms is None
        for i in range(offered):
            t = float(arr[i])
            if not window_opened and t >= update_at_ms:
                from ..update.scenarios import scenario_weights
                open_rebuild_window(system, scenario_weights(
                    scenario, system.graph, system.partition, self.rng,
                    intensity))
                window_opened = True
            # retire batches whose service has started by now
            while (started_ptr < len(batch_starts)
                   and batch_starts[started_ptr] <= t):
                queued -= batch_sizes[started_ptr]
                started_ptr += 1
            # close an expired window before admitting the new arrival
            # (same ordering as _BatchedServer.submit)
            if pending and t >= pending_first + self.window_ms:
                flush(pending_first + self.window_ms)
            if self.max_queue is not None and queued >= self.max_queue:
                shed[i] = True
                continue
            pending.append(i)
            queued += 1
            queue_peak = max(queue_peak, queued)
            if pending_first == np.inf:
                pending_first = t
            if len(pending) >= b:
                flush(t)
        if pending:
            flush(pending_first + self.window_ms)

        admitted = int(offered - shed.sum())
        lat = latencies[~shed]
        horizon_s = max(horizon_ms, busy_until) / 1e3
        exact = admitted - stale_n
        if admitted:
            p50, p99, p999 = np.percentile(lat, [50, 99, 99.9])
            mean, mx = float(lat.mean()), float(lat.max())
        else:
            p50 = p99 = p999 = mean = mx = 0.0
        return LoadReport(
            offered=offered, admitted=admitted, shed=int(shed.sum()),
            horizon_ms=horizon_ms, num_clients=num_clients, shape=shape,
            offered_qps=offered / max(1e-9, horizon_ms / 1e3),
            goodput_qps=admitted / max(1e-9, horizon_s),
            exact_qps=exact / max(1e-9, horizon_s),
            shed_frac=float(shed.sum()) / max(1, offered),
            stale_frac=stale_n / max(1, admitted),
            certified_frac=certified_n / max(1, admitted),
            mean_ms=mean, p50_ms=float(p50), p99_ms=float(p99),
            p999_ms=float(p999), max_ms=mx, queue_peak=queue_peak,
            engine_calls=engine_calls,
            mean_batch_service_ms=service_ms_total / max(1, engine_calls),
            degraded_frac=int(degraded[~shed].sum()) / max(1, admitted),
            latencies_ms=lat,
            district_load=np.bincount(
                assignment[ss[~shed]],
                minlength=system.partition.num_districts).astype(np.int64))

    def _run_closed(self, num_clients: int, per_client_qps: float,
                    horizon_ms: float, shape: str = "uniform") -> LoadReport:
        """Closed-loop comparison run: ``self.closed_loop`` blocking
        clients target the open-loop offered load but wait for each
        answer before thinking and re-issuing.  Same micro-batching
        service path (real ``DistanceService.submit`` per flush); the
        ``shape`` argument is accepted for signature parity but the
        arrival pattern is emergent (think + response), not shaped."""
        import heapq

        system = self.service.system
        n_vertices = int(system.graph.num_vertices)
        assignment = system.partition.assignment
        topo = Topology(system.partition.num_districts, self.latency)
        scatter = self.service.policy.engine == "scatter_gather"
        n_closed = int(self.closed_loop)
        target_qps = num_clients * per_client_qps
        if target_qps <= 0:
            raise ValueError("target load must be positive")
        # each client thinks so the FLEET targets the open-loop offered
        # load; response time is not subtracted — that self-throttling
        # is the closed-loop behavior under measurement
        mean_think_ms = n_closed * 1e3 / target_qps

        # growing per-request records (closed-loop arrivals are not
        # known up front: each depends on the previous departure)
        req_arr: list[float] = []
        req_client: list[int] = []
        req_ss: list[int] = []
        req_ts: list[int] = []
        req_lat: list[float] = []
        pending: list[int] = []
        pending_first = np.inf
        busy_until = 0.0
        stale_n = certified_n = 0
        engine_calls = 0
        service_ms_total = 0.0
        queue_peak = 0
        b = self.batch_size
        pad_idx = np.zeros(b, dtype=np.int64)
        heap = [(float(self.rng.exponential(mean_think_ms)), c)
                for c in range(n_closed)]
        heapq.heapify(heap)

        def flush(close_ms: float) -> None:
            nonlocal busy_until, pending, pending_first
            nonlocal stale_n, certified_n, engine_calls, service_ms_total
            if not pending:
                return
            start = max(close_ms, busy_until)
            idx = np.asarray(pending, dtype=np.int64)
            k = len(idx)
            sb, tb = pad_idx.copy(), pad_idx.copy()
            sb[:k] = [req_ss[j] for j in pending]
            tb[:k] = [req_ts[j] for j in pending]
            real = np.zeros(b, dtype=bool)
            real[:k] = True
            t0 = time.perf_counter()
            batch = self.service.submit(sb, tb, real=real)
            wall_s = time.perf_counter() - t0
            if self.service_ms_override is not None:
                overhead_ms, per_query_ms = self.service_ms_override
                service_ms = overhead_ms + k * per_query_ms
            else:
                service_ms = wall_s * 1e3
            done = start + service_ms
            codes = batch.exactness_codes[:k]
            stale_n += int((codes == np.uint8(2)).sum())
            certified_n += int((codes == np.uint8(1)).sum())
            for j in pending:
                cross = assignment[req_ss[j]] != assignment[req_ts[j]]
                rtt = float(request_rtt_ms(topo, np.array([cross]),
                                           scatter=scatter)[0])
                req_lat[j] = done - req_arr[j] + rtt
                # the answer lands at the client after the return hop;
                # it thinks, then issues the next query
                nxt = done + rtt / 2.0 \
                    + float(self.rng.exponential(mean_think_ms))
                heapq.heappush(heap, (nxt, req_client[j]))
            busy_until = done
            engine_calls += 1
            service_ms_total += service_ms
            pending = []
            pending_first = np.inf

        while heap:
            t, c = heap[0]
            # a window expiring before the next issue must flush first —
            # with every client blocked in a batch the heap alone would
            # deadlock
            if pending and pending_first + self.window_ms <= t:
                flush(pending_first + self.window_ms)
                continue
            heapq.heappop(heap)
            if t > horizon_ms:
                continue                # stop issuing past the horizon
            i = len(req_arr)
            req_arr.append(t)
            req_client.append(c)
            req_ss.append(int(self.rng.integers(0, n_vertices)))
            req_ts.append(int(self.rng.integers(0, n_vertices)))
            req_lat.append(np.nan)
            pending.append(i)
            queue_peak = max(queue_peak, len(pending))
            if pending_first == np.inf:
                pending_first = t
            if len(pending) >= b:
                flush(t)
        if pending:
            flush(pending_first + self.window_ms)

        offered = len(req_arr)
        lat = np.asarray(req_lat, dtype=np.float64)
        horizon_s = max(horizon_ms, busy_until) / 1e3
        if offered:
            p50, p99, p999 = np.percentile(lat, [50, 99, 99.9])
            mean, mx = float(lat.mean()), float(lat.max())
        else:
            p50 = p99 = p999 = mean = mx = 0.0
        ss_arr = np.asarray(req_ss, dtype=np.int64)
        return LoadReport(
            offered=offered, admitted=offered, shed=0,
            horizon_ms=horizon_ms, num_clients=n_closed, shape=shape,
            offered_qps=offered / max(1e-9, horizon_ms / 1e3),
            goodput_qps=offered / max(1e-9, horizon_s),
            exact_qps=(offered - stale_n) / max(1e-9, horizon_s),
            shed_frac=0.0,
            stale_frac=stale_n / max(1, offered),
            certified_frac=certified_n / max(1, offered),
            mean_ms=mean, p50_ms=float(p50), p99_ms=float(p99),
            p999_ms=float(p999), max_ms=mx, queue_peak=queue_peak,
            engine_calls=engine_calls,
            mean_batch_service_ms=service_ms_total / max(1, engine_calls),
            latencies_ms=lat,
            district_load=np.bincount(
                assignment[ss_arr] if offered else np.zeros(0, np.int64),
                minlength=system.partition.num_districts).astype(np.int64))
