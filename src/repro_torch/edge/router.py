"""System facade: center + all edge servers + engine snapshots,
version-aware.

``EdgeSystem`` is the functional model of the deployment.  The request
plane — §4.2 routing, typed results, rebuild-window policy — lives in
``serve.service``; get a front door with ``EdgeSystem.service()``.

Paper map: the service planes implement the §4.2 query rules (rule 1
same-district local, rule 2 same-district via another client's server,
rule 3 cross-district through the border table B at the computing
center); during a rebuild window (center pushed a new index version,
shortcuts not yet installed) answers are served from the stale L_i
under the Theorem-3 certificate (λ ≤ Local Bound ⇒ still exact), and
the uncertified residue is resolved per the policy's rebuild mode.
``_current_engine`` snapshots one index version into a batched serving
engine — replicated on the system's device, or district-sharded over
the logical shards of the system's ``EdgeMesh`` — and swaps it whenever
the center's version or the placement moves.

Everything that holds tensors lives on ``device``: ``deploy(device=None)``
means the CUDA card and raises without one; ``device="cpu"`` runs the
kernels' plain versions.  Traffic updates run the paper's full cycle
or the delta-scoped one (``apply_traffic_update(incremental=True)``),
topology updates (closures/openings) the scoped structural one; the
center repairs B on ``device`` either way.  ``migrate`` installs a new
district → edge-host placement (``topo.rebalance``).
``_current_scatter_plane`` snapshots one index version into the
scatter-gather coordinator plane (``edge.scatter_gather``): the servers'
own label stores on the system's device, cross-district lanes answered
edge-side from peer-exchanged border rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..core.graph import Graph
from ..core.partition import Partition
from ..device import resolve_device
from .center import ComputingCenter
from .server import EdgeServer
from .sharded_oracle import EdgeMesh, default_edge_mesh

if TYPE_CHECKING:                                   # pragma: no cover
    from ..serve.service import DistanceService, ServingPolicy

# sentinel: "use the EdgeSystem attribute" (None already means auto-pick)
_SELF = object()

# auto-pick threshold for row-sharding the border table B: replicating B
# costs n·q·4 bytes per shard and no assembly, so it stays replicated
# until it is big enough to matter (override per-system with
# ``EdgeSystem.shard_border``)
SHARD_BORDER_AUTO_BYTES = 64 << 20

# auto-pick threshold for quantized label storage: once the float32
# index footprint (B + dense district tables) crosses this, the engines
# store uint16 codes instead — but ONLY when the fitted spec is lossless
# (integer-second weights), so auto never changes a single answer
QUANT_AUTO_BYTES = 32 << 20


@dataclass
class EdgeSystem:
    graph: Graph
    partition: Partition
    center: ComputingCenter
    servers: list[EdgeServer]
    stats: dict = field(default_factory=lambda: {
        "rule1": 0, "rule2": 0, "rule3": 0, "lb_certified": 0,
        "lb_fallback_attempts": 0})
    # engine selection: None = auto (sharded iff the mesh has more than
    # one shard), True/False = force sharded/replicated
    prefer_sharded: bool | None = None
    # border-table placement within the sharded engine: None = auto (row-
    # shard B once its replicated footprint n·q·4 exceeds
    # SHARD_BORDER_AUTO_BYTES), True/False = force sharded/replicated B.
    # Only consulted when the sharded engine is selected.
    shard_border: bool | None = None
    # label storage dtype: None/"auto" = float32 until the index crosses
    # QUANT_AUTO_BYTES and the fitted uint16 spec is lossless;
    # "float32" / "uint16" / "int16" force the storage (an explicit
    # integer dtype is honored even when the fit is lossy)
    label_dtype: str | None = None
    # district → edge-host routing table (topo.rebalance); None = the
    # blocked default layout.  ``migrate`` swaps it atomically — its key
    # joins every engine cache key, so the next batch routes on the new
    # table while in-flight batches keep the snapshot (= the old owner)
    # they started with
    placement: object | None = None
    # the logical edge shards of the sharded engine (the port's
    # counterpart of the JAX runtime's device list); None =
    # ``default_edge_mesh(device=self.device)``
    mesh: EdgeMesh | None = None
    # steady-state serving engines, snapshots of one index version and
    # placement: one per label dtype and layout asked for, all dropped
    # when the version or the placement moves (the only engine cache;
    # services ask it on every plan)
    _engines: dict = field(default_factory=dict, repr=False)
    _engines_version: tuple | None = field(default=None, repr=False)
    # (key, ScatterGatherPlane): the scatter plane of one index version,
    # fault plan, label dtype and placement
    _scatter: tuple | None = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.center.device

    def edge_mesh(self) -> EdgeMesh:
        """The system's ``mesh``, or the default one on its device."""
        if self.mesh is not None:
            return self.mesh
        return default_edge_mesh(device=self.device)

    @classmethod
    def deploy(cls, g: Graph, part: Partition, builder: str = "reference",
               device: torch.device | str | None = None) -> "EdgeSystem":
        """Build B at the center (``builder="reference"`` on the host,
        ``"torch"`` with the staged builder on ``device``), every edge
        server's local index, and push the shortcuts down."""
        device = resolve_device(device)
        center = ComputingCenter(g, part, builder=builder, device=device)
        center.rebuild()
        servers = [EdgeServer.bootstrap(g, part, i, device=device)
                   for i in range(part.num_districts)]
        for s in servers:
            s.install_shortcuts(g, part, center.shortcuts_for(s.district_id),
                                center.version)
        return cls(g, part, center, servers)

    def apply_traffic_update(self, new_weights: np.ndarray,
                             incremental: bool = False) -> dict:
        """Traffic-epoch update cycle; returns timings.

        ``incremental=False`` — the paper's full cycle: every edge server
        refreshes its local index, the center rebuilds B from scratch
        with its builder (``"reference"`` or ``"torch"``), shortcuts are
        pushed back down everywhere.

        ``incremental=True`` — delta-scoped cycle (``update``): only
        districts with a dirty intra edge refresh their local index,
        the center repairs B on ``device`` (bit for bit equal to a full
        staged rebuild), and shortcuts are reinstalled only where the
        shortcut matrix or the local index moved.  Clean districts'
        servers just adopt the new version number: their L_i⁺ inputs
        are bitwise unchanged, so they keep serving without entering a
        rebuild window.
        """
        if incremental:
            rep = self.center.apply_delta(new_weights)
            if rep["noop"]:
                return self._noop_report()
            self.graph = self.center.graph      # same topology, new weights
            dirty = set(int(i) for i in rep["delta"].dirty_districts)
            return {**self._scoped_refresh(dirty, rep),
                    "incremental": rep["incremental"]}
        g2 = self.graph.with_weights(new_weights)
        self.graph = g2
        local_s = [srv.refresh_local(g2, self.partition)
                   for srv in self.servers]
        bl_s = self.center.rebuild(new_weights)
        shortcut_s = [srv.install_shortcuts(
            g2, self.partition,
            self.center.shortcuts_for(srv.district_id),
            self.center.version) for srv in self.servers]
        return {"local_refresh_s": local_s, "bl_rebuild_s": bl_s,
                "shortcut_install_s": shortcut_s,
                "incremental": False}

    def apply_topology_update(self, g_new: Graph,
                              incremental: bool = True) -> dict:
        """Structural update cycle — road closures/openings.

        ``incremental=True`` (default): classify the topology diff
        (``topo``), repair B with the scoped structural path, and
        refresh only the edge servers whose inputs moved — a district's
        local index reads its intra arc set (dirty districts refresh)
        and its Definition-4 border list (every server refreshes when
        ``border_changed``).  ``incremental=False`` runs the paper's
        full redeploy cycle.  Either way the partition and vertex set
        are fixed.
        """
        if not incremental:
            self.graph = g_new
            self.center.set_topology(g_new)
            local_s = [srv.refresh_local(g_new, self.partition)
                       for srv in self.servers]
            bl_s = self.center.rebuild()
            shortcut_s = [srv.install_shortcuts(
                g_new, self.partition,
                self.center.shortcuts_for(srv.district_id),
                self.center.version) for srv in self.servers]
            return {"local_refresh_s": local_s, "bl_rebuild_s": bl_s,
                    "shortcut_install_s": shortcut_s,
                    "incremental": False, "border_changed": True}
        rep = self.center.apply_structural(g_new)
        self.graph = self.center.graph
        if rep["noop"]:
            return {**self._noop_report(), "border_changed": False}
        if rep["border_changed"]:
            # border sets moved: every server's L_i border rows are laid
            # out against the new border lists — refresh everywhere
            dirty = set(range(len(self.servers)))
        else:
            dirty = set(int(i) for i in rep["delta"].dirty_districts)
        return {**self._scoped_refresh(dirty, rep),
                "incremental": rep["incremental"],
                "border_changed": rep["border_changed"]}

    def _noop_report(self) -> dict:
        return {"local_refresh_s": {}, "bl_rebuild_s": 0.0,
                "shortcut_install_s": {}, "incremental": True,
                "dirty_districts": [], "stale_shortcut_districts": [],
                "clean_districts": list(range(len(self.servers)))}

    def _scoped_refresh(self, dirty: set, rep: dict) -> dict:
        """After a scoped center repair: dirty districts refresh their
        local index, dirty and stale ones reinstall shortcuts, the rest
        adopt the new version in place."""
        g = self.graph
        stale = set(rep["stale_districts"])
        local_s: dict[int, float] = {}
        shortcut_s: dict[int, float] = {}
        clean: list[int] = []
        for i, srv in enumerate(self.servers):
            if i in dirty:
                local_s[i] = srv.refresh_local(g, self.partition)
            if i in dirty or i in stale or srv.augmented is None:
                shortcut_s[i] = srv.install_shortcuts(
                    g, self.partition, self.center.shortcuts_for(i),
                    self.center.version)
            else:
                # nothing this server depends on moved — keep serving
                srv.augmented_version = self.center.version
                clean.append(i)
        return {"local_refresh_s": local_s,
                "bl_rebuild_s": rep["seconds"],
                "shortcut_install_s": shortcut_s,
                "dirty_districts": sorted(dirty),
                "stale_shortcut_districts": sorted(stale),
                "clean_districts": clean}

    def migrate(self, plan_or_placement) -> dict:
        """Install a new district → host placement atomically (the
        ``RebalancePlanner`` execute step).

        The placement key joins every engine cache key, so the swap is a
        pointer write: batches planned after this call route on the new
        table (the next ``_current_engine`` call re-packs the blocks —
        districts' cached dense tables are copied, not recomputed);
        batches already in flight keep the engine snapshot — and
        therefore the old owner — they started with.  Index versions are
        untouched, so exactness is preserved through the swap."""
        plan = plan_or_placement
        placement = getattr(plan, "placement", plan)
        m = self.partition.num_districts
        if placement.num_districts != m:
            raise ValueError(f"placement covers {placement.num_districts} "
                             f"districts, system has {m}")
        old = self.placement
        self.placement = placement
        return {"placement_version": placement.version,
                "num_hosts": placement.num_hosts,
                "moved_districts":
                    [] if old is None and plan is placement
                    else [mv.district for mv in getattr(plan, "moves", ())],
                "previous_version":
                    None if old is None else old.version}

    def service(self, policy: "ServingPolicy | None" = None
                ) -> "DistanceService":
        """A typed request-plane front door over this system (see
        ``serve.service``).  Each call returns a fresh service with its
        own counters; the engine snapshots underneath are shared through
        ``_current_engine``'s cache, so services are cheap."""
        from ..serve.service import DistanceService
        return DistanceService(self, policy)

    def _merge_stats(self, counters: dict) -> None:
        for k, v in counters.items():
            self.stats[k] += v

    def _resolve_quant(self, label_dtype):
        """Map a ``label_dtype`` knob value to the QuantSpec the engine
        packs with (None ⇒ float32 storage).  Auto quantizes only when
        the float32 index footprint crosses QUANT_AUTO_BYTES AND the
        fitted uint16 spec round-trips losslessly — so turning auto on
        can never change an answer.  An explicit integer dtype is
        honored even when lossy (the caller asked for the bytes)."""
        from ..core.quantize import LABEL_DTYPES, fit_label_spec
        if label_dtype == "float32":
            return None
        btable = self.center.border_labels.table
        locals_ = [srv.augmented for srv in self.servers]
        if label_dtype in (None, "auto"):
            est = 4 * (btable.size
                       + sum(len(li.vertices) ** 2 for li in locals_))
            if est <= QUANT_AUTO_BYTES:
                return None
            spec = fit_label_spec(btable, locals_)
            return spec if spec.lossless else None
        return fit_label_spec(btable, locals_,
                              dtype=LABEL_DTYPES[label_dtype])

    def _current_engine(self, prefer_sharded=_SELF, shard_border=_SELF,
                        label_dtype=_SELF):
        """Engine snapshot for the current index version, or None while
        any district's shortcuts are stale (rebuild window). A one-shard
        mesh gets the replicated ``BatchedQueryEngine`` on the system's
        device; a mesh of more shards shards the district tables over
        them (``ShardedBatchedEngine``), and within the sharded engine B
        itself is row-sharded once its replicated footprint crosses
        SHARD_BORDER_AUTO_BYTES. ``label_dtype`` picks the storage dtype
        (see ``_resolve_quant``). ``prefer_sharded`` / ``shard_border``
        / ``label_dtype`` override the auto choices (arguments take
        precedence over the instance attributes; the request plane
        passes its ``ServingPolicy`` placement through them)."""
        if prefer_sharded is _SELF:
            prefer_sharded = self.prefer_sharded
        if shard_border is _SELF:
            shard_border = self.shard_border
        if label_dtype is _SELF:
            label_dtype = self.label_dtype
        if any(srv.augmented is None
               or srv.augmented_version != self.center.version
               for srv in self.servers):
            return None
        mesh = self.edge_mesh()
        num_devices = mesh.size
        sharded = (num_devices > 1 if prefer_sharded is None
                   else bool(prefer_sharded))
        btable = self.center.border_labels.table
        shard_border = sharded and (
            btable.size * 4 > SHARD_BORDER_AUTO_BYTES
            if shard_border is None else bool(shard_border))
        # the placement maps districts to edge hosts; it becomes the
        # shard layout when the host and shard counts line up (one host
        # a shard), and joins the key either way so a migration always
        # swaps the snapshot
        placement = self.placement
        pkey = None if placement is None else placement.key()
        host_of = placement.host_of \
            if placement is not None \
            and placement.num_hosts == num_devices else None
        version = (self.center.version,
                   tuple(srv.augmented_version for srv in self.servers),
                   pkey)
        if self._engines_version != version:
            # drop the stale engines' device tables BEFORE building a
            # replacement: holding both doubles peak device memory
            self._engines.clear()
            self._engines_version = version
        # replicated: one engine a storage dtype; sharded: at most one
        # resident, keyed by dtype, B layout and mesh (shard count)
        key = label_dtype or "auto"
        if sharded:
            key = (key, shard_border, num_devices, mesh)
        engine = self._engines.get(key)
        if engine is None:
            from .engine import BatchedQueryEngine, ShardedBatchedEngine
            quant = self._resolve_quant(label_dtype)
            locals_ = [srv.augmented for srv in self.servers]
            if sharded:
                # drop the other sharded snapshot first, as the stale
                # ones above: E shards' tables are the layout whose
                # purpose is memory, and two of them double its peak
                for k in [k for k in self._engines if isinstance(k, tuple)]:
                    del self._engines[k]
                engine = ShardedBatchedEngine(
                    btable, locals_, self.partition.assignment, mesh=mesh,
                    axis=mesh.axis, shard_border=shard_border, quant=quant,
                    placement=host_of)
            else:
                engine = BatchedQueryEngine(
                    btable, locals_, self.partition.assignment, quant=quant,
                    device=self.device)
            self._engines[key] = engine
        return engine

    def _current_scatter_plane(self, faults=None, label_dtype=_SELF):
        """Scatter-gather coordinator plane for the current index
        version, or None during a rebuild window (same freshness rule as
        ``_current_engine``).  Building the plane pushes each server its
        own district's B rows; peer exchanges then run lazily per batch
        and persist on the servers across plane rebuilds of the same
        version.  ``faults`` (an ``edge.faults.FaultPlan``) attaches a
        deterministic injector; the plan is part of the cache key, so
        switching plans rebuilds the plane (and its injector epoch).
        ``label_dtype`` stores the plane's tables as quantized codes
        exactly like the engines (see ``_resolve_quant``); the placement
        (``EdgeSystem.placement``) decides which exchanges are
        co-hosted, and joins the key."""
        if label_dtype is _SELF:
            label_dtype = self.label_dtype
        if any(srv.augmented is None
               or srv.augmented_version != self.center.version
               for srv in self.servers):
            return None
        if faults is not None and not faults.enabled:
            faults = None
        pkey = None if self.placement is None else self.placement.key()
        key = (self.center.version,
               tuple(srv.augmented_version for srv in self.servers),
               faults, label_dtype or "auto", pkey)
        if self._scatter is None or self._scatter[0] != key:
            from .scatter_gather import ScatterGatherPlane
            quant = self._resolve_quant(label_dtype)
            # drop the stale plane's device tables before building anew
            self._scatter = None
            self._scatter = (key, ScatterGatherPlane.from_system(
                self, faults=faults, quant=quant))
        return self._scatter[1]

    def current_engine(self):
        """Public accessor for the active serving-engine snapshot (None
        during a rebuild window)."""
        return self._current_engine()

    def query_loop(self, ss: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Per-query Python reference path (parity + benchmark baseline);
        the ``ScalarLoopPlane`` of the request plane."""
        svc = self.service()
        out = svc.scalar_plane().execute(np.asarray(ss, dtype=np.int64),
                                         np.asarray(ts, dtype=np.int64))
        self._merge_stats(svc.stats)
        return out
