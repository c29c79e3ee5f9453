"""Unified request plane: one typed front door for distance queries.

The edge deployment is ultimately a *service* — clients submit distance
queries and the system hides routing rules, rebuild windows, and index
versions behind one interface.  This module is that interface:

* ``QueryRequest`` / ``QueryResult`` — the typed request/response pair.
  A result carries the distance, the §4.2 rule it was served under, an
  exactness flag (``exact`` | ``certified_stale`` | ``stale``), the
  index version that answered it, and the dispatch latency.
* ``ServingPolicy`` — one config object for the serving knobs: engine
  placement (``auto``/``replicated``/``sharded`` + ``shard_border``,
  ``scatter_gather``), micro-batching (a simulator ``BatchPolicy``),
  fault injection, label storage dtype, the rebuild-window mode and the
  migration-window discipline.
* ``QueryPlane`` — the protocol every execution backend implements
  (``execute(ss, ts) -> distances``): the steady-state
  ``BatchedQueryEngine`` / ``ShardedBatchedEngine`` snapshots and the
  ``ScatterGatherPlane``, the per-bucket ``BucketedPlane`` (rebuild
  windows), and the per-query ``ScalarLoopPlane``.
  ``DistanceBatcher``, the §5 simulator and the load harness all drive
  this one interface.
* ``DistanceService`` — plans a batch onto a plane
  (``plan(batch) -> QueryPlan`` holding the chosen plane), executes it,
  and aggregates per-result metadata into service-level counters.
  Padding dummies (rows a caller appends for static shapes) are
  excluded from the counters via the ``real`` mask.

Rebuild-window modes (what happens to a same-district query whose
Theorem-3 Local-Bound certificate does NOT fire while the server's
L_i⁺ is stale):

* ``install_now`` — the legacy behavior: the server installs the
  center's shortcuts inside the query path and answers exactly.  The
  only mode with a side effect on serving state.
* ``certify_or_wait`` — the query "waits for the shortcut push": the
  answer is computed from the post-push L_i⁺ (built read-only via
  ``EdgeServer.peek_augmented``) and flagged ``waited``; the serving
  state is untouched.  Same distances as ``install_now``.
* ``stale_ok`` — the stale λ upper bound from the plain L_i is served
  immediately and the result is flagged ``stale`` (``exact == False``).
  Certified answers are identical across all three modes.

Paper map: the planes implement the §4.2 query rules over Theorems 1–2
indexes; the rebuild-window modes are the three readings of the paper's
update discipline (§5): strict consistency via waiting, Theorem-3
certification, and bounded staleness.

A port of ``repro.serve.service``. The reference's ``use_kernels=False``
host-NumPy path has no counterpart: the joins run where the tables
live, and ``device="cpu"`` runs their plain versions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Protocol, Sequence, runtime_checkable

import numpy as np

from ..core.query import Rule, bucket_by_rule, route

if TYPE_CHECKING:                                   # pragma: no cover
    from ..edge.faults import FaultPlan
    from ..edge.router import EdgeSystem
    from ..edge.simulator import BatchPolicy
    from .distance_batcher import DistanceBatcher

INF = np.float32(np.inf)

# -- rebuild-window modes ----------------------------------------------------
INSTALL_NOW = "install_now"
CERTIFY_OR_WAIT = "certify_or_wait"
STALE_OK = "stale_ok"
REBUILD_MODES = (INSTALL_NOW, CERTIFY_OR_WAIT, STALE_OK)

# -- exactness flags (codes index into _EXACTNESS) ---------------------------
EXACT = "exact"
CERTIFIED_STALE = "certified_stale"
STALE = "stale"
_EXACTNESS = (EXACT, CERTIFIED_STALE, STALE)

# -- migration-window disciplines (district repartitioning, topo) -----------
MIGRATION_DUAL = "dual"
MIGRATION_HANDOFF = "handoff"
MIGRATION_MODES = (MIGRATION_DUAL, MIGRATION_HANDOFF)

ENGINE_PLACEMENTS = ("auto", "replicated", "sharded", "scatter_gather")
LABEL_DTYPE_CHOICES = ("auto", "float32", "uint16", "int16")

_COUNTER_KEYS = ("rule1", "rule2", "rule3", "lb_certified",
                 "lb_fallback_attempts")


def _fresh_counters() -> dict[str, int]:
    return {k: 0 for k in _COUNTER_KEYS}


@dataclass(frozen=True)
class ServingPolicy:
    """Every serving knob in one immutable config object.

    ``engine`` picks the steady-state plane placement: ``"auto"``
    (defer to the system's override attributes, then the shard-count
    heuristic), ``"replicated"``, ``"sharded"``, or ``"scatter_gather"``
    (the coordinator plane of ``edge.scatter_gather`` — cross-district
    lanes answered edge-side via peer border-row exchange, bit-for-bit
    with the engines).  ``shard_border`` picks the border-table
    placement inside the sharded engine (None = defer to the system
    override / byte-size heuristic).  ``batch`` carries the
    micro-batching discipline (a simulator ``BatchPolicy``) for
    ``DistanceService.batcher`` and ``simulate_edge(policy=...)``.
    ``rebuild`` is the rebuild-window mode (see module docstring).
    ``faults`` attaches a deterministic ``edge.faults.FaultPlan`` to the
    scatter-gather plane (degrade-never-error discipline; a disabled
    plan is normalized to None so it cannot perturb the clean path).
    ``label_dtype`` picks the label-storage dtype: ``"auto"`` (defer to
    the system attribute, then the byte-size heuristic — quantize to
    uint16 only when the fit is lossless, so auto never changes an
    answer), ``"float32"``, ``"uint16"``, or ``"int16"`` (explicit
    integer dtypes are honored even when the fit is lossy).
    ``migration`` is the district-migration window discipline for the
    §5 simulator: ``"dual"`` (the source host keeps serving the moving
    district exactly until the routing swap lands — no staleness, the
    engine-swap semantics of ``EdgeSystem.migrate``) or ``"handoff"``
    (queries landing inside the declared copy window are flagged stale;
    zero non-exact answers outside it).
    """
    engine: str = "auto"
    shard_border: bool | None = None
    rebuild: str = INSTALL_NOW
    batch: "BatchPolicy | None" = None
    faults: "FaultPlan | None" = None
    label_dtype: str = "auto"
    migration: str = MIGRATION_DUAL

    def __post_init__(self):
        if self.engine not in ENGINE_PLACEMENTS:
            raise ValueError(f"engine must be one of {ENGINE_PLACEMENTS}, "
                             f"got {self.engine!r}")
        if self.rebuild not in REBUILD_MODES:
            raise ValueError(f"rebuild must be one of {REBUILD_MODES}, "
                             f"got {self.rebuild!r}")
        if self.migration not in MIGRATION_MODES:
            raise ValueError(f"migration must be one of {MIGRATION_MODES}, "
                             f"got {self.migration!r}")
        if self.label_dtype not in LABEL_DTYPE_CHOICES:
            raise ValueError(
                f"label_dtype must be one of {LABEL_DTYPE_CHOICES}, "
                f"got {self.label_dtype!r}")
        if self.faults is not None and not self.faults.enabled:
            object.__setattr__(self, "faults", None)


@dataclass(frozen=True)
class QueryRequest:
    """One distance query: (s, t), optionally observed from a client in
    another district (affects the §4.2 rule — 1 vs 2 — never the
    answer)."""
    s: int
    t: int
    client_district: int | None = None


@dataclass(frozen=True)
class QueryResult:
    """One answered query with its serving metadata."""
    distance: float
    rule: Rule
    exactness: str          # EXACT | CERTIFIED_STALE | STALE
    index_version: int
    latency_s: float
    waited: bool = False    # deferred to the shortcut push mid-window
    # why (and how) the answer degraded under injected faults, e.g.
    # "peer_drop:forwarded_via_center"; None on the clean path.  A set
    # reason with exactness == "exact" means the fallback route itself
    # is exact (center forwarding, surviving-min reroute).
    degraded_reason: str | None = None

    @property
    def exact(self) -> bool:
        """True unless the answer was served stale (``stale_ok`` residue:
        a λ upper bound from the plain L_i, not certified)."""
        return self.exactness != STALE


@dataclass
class ResultBatch:
    """Vectorized result set: one array per metadata field, so the hot
    path never materializes per-query objects (``__getitem__`` /
    ``to_list`` build ``QueryResult`` views on demand).  ``real`` masks
    out padding dummies — counters never see them.

    Metadata is OFF the dispatch hot path: the §4.2 rule array is
    computed lazily from the stored routing inputs (treat submitted
    ``ss``/``ts`` as immutable, per numpy convention), and the
    steady-state engine path stores the window metadata as ``None``
    (= every result exact, no fallback, no wait); the public
    ``rules`` / ``exactness_codes`` / ``fallback`` / ``waited``
    properties materialize on demand."""
    distances: np.ndarray       # (B,) f32
    index_version: int
    latency_s: float            # wall-clock of the plane dispatch
    # routing inputs for the lazy rule computation:
    # (assignment, ss, ts, client_districts)
    _route: tuple | None = None
    _rules: np.ndarray | None = None    # (B,) int32, Rule values
    # None ⇒ all-exact steady state / all rows real (lazy zeros)
    _codes: np.ndarray | None = None    # (B,) uint8 indexing _EXACTNESS
    _fallback: np.ndarray | None = None  # (B,) bool — plain-L_i Thm-3 path
    _waited: np.ndarray | None = None   # (B,) bool — deferred to the push
    real: np.ndarray | None = None      # (B,) bool — False for padding
    _degraded: np.ndarray | None = None  # (B,) object — fault reasons
    _ds: np.ndarray | None = None       # (B,) int32 source districts

    def __len__(self) -> int:
        return len(self.distances)

    @property
    def rules(self) -> np.ndarray:
        if self._rules is None:
            assignment, ss, ts, client = self._route
            # keep the source districts for district_counts — the load
            # signal the RebalancePlanner consumes — before the routing
            # inputs are dropped
            self._ds = assignment[np.asarray(ss)].astype(np.int32)
            _, _, self._rules = bucket_by_rule(assignment, ss, ts, client)
            self._route = None
        return self._rules

    def district_counts(self, num_districts: int) -> np.ndarray:
        """(m,) int64 query count per source district (real rows only) —
        the per-batch load signal ``DistanceService.district_load``
        accumulates."""
        _ = self.rules                          # materialize _ds
        ds = self._ds
        if self.real is not None:
            ds = ds[self.real]
        return np.bincount(ds, minlength=num_districts).astype(np.int64)

    @property
    def exactness_codes(self) -> np.ndarray:
        if self._codes is None:
            self._codes = np.zeros(len(self.distances), dtype=np.uint8)
        return self._codes

    @property
    def fallback(self) -> np.ndarray:
        if self._fallback is None:
            self._fallback = np.zeros(len(self.distances), dtype=bool)
        return self._fallback

    @property
    def waited(self) -> np.ndarray:
        if self._waited is None:
            self._waited = np.zeros(len(self.distances), dtype=bool)
        return self._waited

    @property
    def degraded_reason(self) -> np.ndarray:
        if self._degraded is None:
            self._degraded = np.full(len(self.distances), None,
                                     dtype=object)
        return self._degraded

    def __getitem__(self, i: int) -> QueryResult:
        return QueryResult(float(self.distances[i]), Rule(int(self.rules[i])),
                           _EXACTNESS[int(self.exactness_codes[i])],
                           self.index_version, self.latency_s,
                           bool(self.waited[i]),
                           self.degraded_reason[i])

    def to_list(self) -> list[QueryResult]:
        return [self[i] for i in range(len(self))]

    @property
    def exact(self) -> np.ndarray:
        """(B,) bool — per-result ``QueryResult.exact``."""
        return self.exactness_codes != np.uint8(2)

    def counters(self) -> dict[str, int]:
        """§4.2 rule + Theorem-3 counters over the REAL results only
        (padding dummies excluded).  Materializes the lazy
        rule array; the service calls this off the hot path (when
        ``DistanceService.stats`` is read)."""
        rules, codes, fb = self.rules, self._codes, self._fallback
        if self.real is not None:
            rules = rules[self.real]
            codes = codes[self.real] if codes is not None else None
            fb = fb[self.real] if fb is not None else None
        counts = np.bincount(rules, minlength=4)    # one pass, rules 1..3
        return {"rule1": int(counts[Rule.LOCAL]),
                "rule2": int(counts[Rule.FORWARD_EDGE]),
                "rule3": int(counts[Rule.CROSS]),
                "lb_certified": (0 if codes is None
                                 else int((codes == np.uint8(1)).sum())),
                "lb_fallback_attempts": (0 if fb is None
                                         else int(fb.sum()))}


@runtime_checkable
class QueryPlane(Protocol):
    """Execution backend contract: answer a routed batch.

    Implemented by ``BatchedQueryEngine``, ``ShardedBatchedEngine`` and
    ``ScatterGatherPlane`` (the steady-state device snapshots),
    ``BucketedPlane`` (rebuild windows), and ``ScalarLoopPlane``
    (per-query reference).  Anything satisfying it plugs into
    ``DistanceBatcher``.
    """

    def execute(self, ss: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Answer the batch; returns (B,) float32 distances."""
        ...                                          # pragma: no cover


@dataclass
class ScalarLoopPlane:
    """Per-query Python reference path behind the same plane interface
    (parity baseline + benchmark floor).  Honors the service's rebuild
    mode per query."""
    service: "DistanceService"

    def execute(self, ss: np.ndarray, ts: np.ndarray) -> np.ndarray:
        return np.array([self.service.query(int(s), int(t)).distance
                         for s, t in zip(ss, ts)], dtype=np.float32)


@dataclass
class BucketedPlane:
    """Per-bucket §4.2 plane: cross-district via the center's B, same-
    district via each server — exact where L_i⁺ is current, Theorem-3
    certificate + rebuild-mode policy where it is stale.  Used during
    rebuild windows; sets per-result metadata arrays
    (``exactness_codes`` / ``fallback`` / ``waited``) as a side product
    of ``execute``."""
    service: "DistanceService"
    mode: str = INSTALL_NOW
    exactness_codes: np.ndarray | None = field(default=None, repr=False)
    fallback: np.ndarray | None = field(default=None, repr=False)
    waited: np.ndarray | None = field(default=None, repr=False)

    def execute(self, ss: np.ndarray, ts: np.ndarray) -> np.ndarray:
        sys_ = self.service.system
        ss = np.asarray(ss, dtype=np.int64)
        ts = np.asarray(ts, dtype=np.int64)
        nq = len(ss)
        out = np.full(nq, INF, dtype=np.float32)
        self.exactness_codes = np.zeros(nq, dtype=np.uint8)
        self.fallback = np.zeros(nq, dtype=bool)
        self.waited = np.zeros(nq, dtype=bool)
        assignment = sys_.partition.assignment
        ds = assignment[ss].astype(np.int32)
        cross = ds != assignment[ts].astype(np.int32)
        cross_idx = np.nonzero(cross)[0]
        if len(cross_idx):
            out[cross_idx] = sys_.center.answer_cross_many(
                ss[cross_idx], ts[cross_idx])
        for i, server in enumerate(sys_.servers):
            sel = np.nonzero(~cross & (ds == np.int32(i)))[0]
            if not len(sel):
                continue
            exact = server.answer_exact_batch(ss[sel], ts[sel])
            if exact is not None:
                out[sel] = exact
                continue
            # rebuild window: fused Theorem-3 certificate on plain L_i
            self.fallback[sel] = True
            lam, cert = server.answer_certified_batch(ss[sel], ts[sel])
            out[sel[cert]] = lam[cert]
            self.exactness_codes[sel[cert]] = np.uint8(1)
            rest = sel[~cert]
            if not len(rest):
                continue
            if self.mode == STALE_OK:
                # serve the λ upper bound immediately, flagged non-exact
                out[rest] = lam[~cert]
                self.exactness_codes[rest] = np.uint8(2)
            elif self.mode == CERTIFY_OR_WAIT:
                # "wait for the push": answer from the post-push L_i⁺
                # without touching the serving state
                aug = server.peek_augmented(sys_.graph, sys_.partition,
                                            sys_.center.shortcuts_for(i),
                                            sys_.center.version)
                out[rest] = aug.query_local_many(aug.local_of(ss[rest]),
                                                 aug.local_of(ts[rest]))
                self.waited[rest] = True
            else:                                    # INSTALL_NOW (legacy)
                server.install_shortcuts(sys_.graph, sys_.partition,
                                         sys_.center.shortcuts_for(i),
                                         sys_.center.version)
                out[rest] = server.answer_exact_batch(ss[rest], ts[rest])
                self.waited[rest] = True
        return out


@dataclass
class QueryPlan:
    """A batch bound to the plane that will execute it.  Produced by
    ``DistanceService.plan``; ``execute`` runs the plane, wraps the
    distances with (lazily materialized) per-result metadata, and
    enqueues the batch for the service counters."""
    service: "DistanceService"
    ss: np.ndarray
    ts: np.ndarray
    client_districts: np.ndarray | None
    plane: QueryPlane
    window: bool            # True while any server's L_i⁺ is stale

    def execute(self, real: np.ndarray | None = None) -> ResultBatch:
        t0 = time.perf_counter()
        dist = np.asarray(self.plane.execute(self.ss, self.ts),
                          dtype=np.float32)
        latency = time.perf_counter() - t0
        # per-batch metadata is plane-published: the BucketedPlane sets
        # all three window arrays, the scatter plane sets exactness +
        # degraded reasons after a faulted batch, and the steady-state
        # engines have none of the attributes (None ⇒ lazily all-exact)
        codes = getattr(self.plane, "exactness_codes", None)
        fallback = getattr(self.plane, "fallback", None)
        waited = getattr(self.plane, "waited", None)
        degraded = getattr(self.plane, "degraded", None)
        if real is not None:
            real = np.asarray(real, dtype=bool)
        batch = ResultBatch(
            dist, self.service.index_version, latency,
            (self.service.system.partition.assignment, self.ss, self.ts,
             self.client_districts),
            None, codes, fallback, waited, real, degraded)
        self.service._enqueue(batch)
        return batch


class DistanceService:
    """The serving front door over a deployed ``EdgeSystem``.

    ``plan`` routes a batch and picks a ``QueryPlane`` per the policy
    and the system's rebuild state; ``submit`` plans + executes and
    returns a ``ResultBatch``; ``query`` answers one request with full
    metadata.  ``stats`` aggregates per-result metadata across the
    service's lifetime (padding dummies excluded via ``real`` masks).
    Construct directly or via ``EdgeSystem.service(policy)``.
    """

    # flush threshold for the deferred counter queue: bounds how many
    # ResultBatch references (and their routing inputs) stay alive
    # between ``stats`` reads
    _MAX_PENDING = 32

    def __init__(self, system: "EdgeSystem",
                 policy: ServingPolicy | None = None):
        self.system = system
        self.policy = policy if policy is not None else ServingPolicy()
        self._stats: dict[str, int] = _fresh_counters()
        # per-district query counts over the service lifetime
        self._district_load = np.zeros(system.partition.num_districts,
                                       dtype=np.int64)
        self._pending: list[ResultBatch] = []

    # -- introspection ------------------------------------------------------

    @property
    def index_version(self) -> int:
        return self.system.center.version

    @property
    def stats(self) -> dict[str, int]:
        """Aggregated per-result counters over the service lifetime.
        Counter aggregation runs OFF the dispatch hot path: submitted
        batches queue here and are folded in when ``stats`` is read (or
        every ``_MAX_PENDING`` submits)."""
        if self._pending:
            pending, self._pending = self._pending, []
            m = len(self._district_load)
            for batch in pending:
                self._absorb(batch.counters())
                self._district_load += batch.district_counts(m)
        return self._stats

    @property
    def district_load(self) -> np.ndarray:
        """(m,) int64 per-district query counts (source district of each
        real query) over the service lifetime."""
        _ = self.stats                          # fold the pending queue
        return self._district_load

    def _absorb(self, counters: dict[str, int]) -> None:
        for k, v in counters.items():
            self._stats[k] += v

    def _enqueue(self, batch: ResultBatch) -> None:
        self._pending.append(batch)
        if len(self._pending) >= self._MAX_PENDING:
            _ = self.stats                      # fold the queue in

    # -- planning -----------------------------------------------------------

    def _resolve_engine(self):
        """Steady-state engine snapshot per the policy's placement and
        storage dtype, asked of the router's cache on every call (its
        key holds the index version, the placement and, for the scatter
        plane, the fault plan) so that no service keeps a stale engine's
        device tables alive (only called once ``plan`` verified the
        window is closed)."""
        p = self.policy
        dtype = (self.system.label_dtype if p.label_dtype == "auto"
                 else p.label_dtype)
        if p.engine == "scatter_gather":
            return self.system._current_scatter_plane(faults=p.faults,
                                                      label_dtype=dtype)
        prefer = {"auto": self.system.prefer_sharded,
                  "replicated": False, "sharded": True}[p.engine]
        border = (self.system.shard_border if p.shard_border is None
                  else p.shard_border)
        return self.system._current_engine(prefer_sharded=prefer,
                                           shard_border=border,
                                           label_dtype=dtype)

    def plan(self, ss: np.ndarray, ts: np.ndarray,
             client_districts: np.ndarray | None = None) -> QueryPlan:
        """Bind the batch to the plane that will execute it (the §4.2
        routing itself happens inside the plane — row-id transform for
        the engines, bucket loop for the fallback — so planning costs
        only the freshness check and the cached engine lookup)."""
        ss = np.asarray(ss, dtype=np.int64)
        ts = np.asarray(ts, dtype=np.int64)
        window = any(srv.augmented is None
                     or srv.augmented_version != self.system.center.version
                     for srv in self.system.servers)
        engine = None if window else self._resolve_engine()
        plane = (engine if engine is not None else
                 BucketedPlane(self, self.policy.rebuild))
        return QueryPlan(self, ss, ts, client_districts, plane, window)

    # -- execution ----------------------------------------------------------

    def submit(self, ss: np.ndarray, ts: np.ndarray,
               client_districts: np.ndarray | None = None,
               real: np.ndarray | None = None) -> ResultBatch:
        """Answer a batch: ``plan`` + plane dispatch + metadata wrap.
        ``real`` masks padding dummies out of the counters."""
        return self.plan(ss, ts, client_districts).execute(real=real)

    def distances(self, ss: np.ndarray, ts: np.ndarray,
                  client_districts: np.ndarray | None = None) -> np.ndarray:
        """Distances-only fast path (the ``(ss, ts) -> distances``
        callable shape legacy code duck-typed)."""
        return self.submit(ss, ts, client_districts).distances

    def submit_requests(self, requests: Sequence[QueryRequest]
                        ) -> list[QueryResult]:
        """Typed front door: a sequence of ``QueryRequest`` in, one
        ``QueryResult`` per request out (submission order)."""
        if not len(requests):
            return []
        ss = np.array([r.s for r in requests], dtype=np.int64)
        ts = np.array([r.t for r in requests], dtype=np.int64)
        client = self.system.partition.assignment[ss].astype(np.int32)
        for i, r in enumerate(requests):
            if r.client_district is not None:
                client[i] = np.int32(r.client_district)
        return self.submit(ss, ts, client_districts=client).to_list()

    def query(self, s: int, t: int,
              client_district: int | None = None) -> QueryResult:
        """Answer one query on the scalar path (mirrors the historical
        per-query route exactly, including ``install_now`` semantics)."""
        t0 = time.perf_counter()
        sys_ = self.system
        ds = int(sys_.partition.assignment[s])
        dt = int(sys_.partition.assignment[t])
        client = ds if client_district is None else client_district
        rule = route(ds, dt, client)
        exactness = EXACT
        fallback = waited = False
        if rule == Rule.CROSS:
            dist = float(sys_.center.answer_cross(s, t))
        else:
            server = sys_.servers[ds]
            exact = server.answer_exact(s, t)
            if exact is not None:
                dist = exact
            else:                       # rebuild window: Theorem-3 path
                fallback = True
                lam, ok = server.answer_certified(s, t)
                if ok:
                    dist, exactness = lam, CERTIFIED_STALE
                elif self.policy.rebuild == STALE_OK:
                    dist, exactness = lam, STALE
                elif self.policy.rebuild == CERTIFY_OR_WAIT:
                    aug = server.peek_augmented(sys_.graph, sys_.partition,
                                                sys_.center.shortcuts_for(ds),
                                                sys_.center.version)
                    sl = int(aug.local_of(np.array([s]))[0])
                    tl = int(aug.local_of(np.array([t]))[0])
                    dist, waited = float(aug.query_local(sl, tl)), True
                else:                   # INSTALL_NOW (legacy side effect)
                    server.install_shortcuts(sys_.graph, sys_.partition,
                                             sys_.center.shortcuts_for(ds),
                                             sys_.center.version)
                    dist, waited = server.answer_exact(s, t), True
        self._absorb({"rule1": int(rule == Rule.LOCAL),
                      "rule2": int(rule == Rule.FORWARD_EDGE),
                      "rule3": int(rule == Rule.CROSS),
                      "lb_certified": int(exactness == CERTIFIED_STALE),
                      "lb_fallback_attempts": int(fallback)})
        self._district_load[ds] += 1
        return QueryResult(dist, rule, exactness, self.index_version,
                           time.perf_counter() - t0, waited)

    # -- companions ---------------------------------------------------------

    def scalar_plane(self) -> ScalarLoopPlane:
        """The per-query reference path as a ``QueryPlane``."""
        return ScalarLoopPlane(self)

    def certifier(self):
        """``(s, t) -> bool`` — whether Theorem 3 certifies the local
        answer, memoized; the shape ``simulate_edge`` consumes (so the
        simulator draws certification rates from the real indexes)."""
        cache: dict[tuple[int, int], bool] = {}
        assignment = self.system.partition.assignment
        servers = self.system.servers

        def certified(s: int, t: int) -> bool:
            key = (int(s), int(t))
            if key not in cache:
                srv = servers[int(assignment[key[0]])]
                _, ok = srv.answer_certified(*key)
                cache[key] = ok
            return cache[key]

        return certified

    def batcher(self, batch_size: int | None = None,
                pad: bool = True) -> "DistanceBatcher":
        """A ``DistanceBatcher`` front-ending this service; the group
        size defaults to ``policy.batch.batch_size``.  Padding dummies
        are masked out of the service counters automatically."""
        from .distance_batcher import DistanceBatcher
        if batch_size is None:
            batch_size = (self.policy.batch.batch_size
                          if self.policy.batch is not None else 256)
        return DistanceBatcher(self, batch_size=batch_size, pad=pad)
