"""Online district repartitioning: watch load, plan migrations, execute
them over the live engine-swap machinery.

The paper fixes the district → edge-server assignment offline; under
real traffic the assignment drifts out of balance (a stadium empties, a
closure storm reroutes commuters).  This module closes the loop:

* ``EdgePlacement`` is the versioned routing table — district → edge
  host.  The default blocked layout (district ``i`` on host
  ``i // ceil(m/E)``) is exactly the layout the sharded engines already
  bake in, so "no placement" and "blocked placement" are bitwise
  indistinguishable.
* ``RebalancePlanner`` accumulates per-district query load (from
  ``DistanceService.district_load`` or a loadgen ``LoadReport``) and
  per-district resident bytes, and greedily plans at most ``max_moves``
  migrations that strictly shrink the hottest host's load without
  blowing a byte budget.
* ``EdgeSystem.migrate(plan)`` installs the new placement atomically:
  the placement version joins every engine/plane cache key, so the next
  batch routes on the new table while in-flight batches keep answering
  on the engine snapshot they started with (old owner) — there is no
  window where a query sees half a placement.

Only the *routing* moves; district label tables are content-addressed
by index version, so a migration never invalidates answers — exactness
is preserved through the swap.

A host NumPy copy of ``repro.topo.rebalance``: ``district_bytes_of``
reads the ``LocalIndex`` fields the servers keep on the host
(``vertices``, ``border_dist``), never their device copies.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class EdgePlacement:
    """Versioned district → edge-host routing table."""

    host_of: np.ndarray          # int32 (m,) host id per district
    num_hosts: int
    version: int = 0

    def __post_init__(self):
        host_of = np.asarray(self.host_of, dtype=np.int32)
        object.__setattr__(self, "host_of", host_of)
        if len(host_of) and (host_of.min() < 0
                             or host_of.max() >= self.num_hosts):
            raise ValueError("host_of entries must lie in "
                             f"[0, {self.num_hosts})")

    @classmethod
    def blocked(cls, num_districts: int, num_hosts: int) -> "EdgePlacement":
        """The engines' default layout: district i on host i // ceil(m/E)."""
        dpd = max(1, -(-num_districts // max(1, num_hosts)))
        host = (np.arange(num_districts, dtype=np.int64) // dpd) \
            .astype(np.int32)
        return cls(host, num_hosts)

    @property
    def num_districts(self) -> int:
        return len(self.host_of)

    def districts_of(self, host: int) -> np.ndarray:
        return np.nonzero(self.host_of == np.int32(host))[0] \
            .astype(np.int32)

    def move(self, district: int, host: int) -> "EdgePlacement":
        """New placement with one district moved (version bumped)."""
        new = self.host_of.copy()
        new[district] = host
        return EdgePlacement(new, self.num_hosts, self.version + 1)

    def host_totals(self, per_district: np.ndarray) -> np.ndarray:
        """Aggregate a per-district quantity to per-host totals."""
        return np.bincount(self.host_of,
                           weights=np.asarray(per_district, dtype=np.float64),
                           minlength=self.num_hosts)

    def key(self) -> tuple:
        """Hashable identity for engine/plane cache keys."""
        return (self.version, self.num_hosts, self.num_districts)


@dataclass(frozen=True)
class MigrationMove:
    district: int
    src_host: int
    dst_host: int
    load: float                  # observed query load moving with it
    bytes: int                   # resident bytes moving with it


@dataclass(frozen=True)
class MigrationPlan:
    moves: tuple[MigrationMove, ...]
    placement: EdgePlacement     # the resulting routing table
    host_load_before: np.ndarray = field(repr=False)
    host_load_after: np.ndarray = field(repr=False)
    host_bytes_after: np.ndarray = field(repr=False)

    @property
    def imbalance_before(self) -> float:
        return _imbalance(self.host_load_before)

    @property
    def imbalance_after(self) -> float:
        return _imbalance(self.host_load_after)

    def summary(self) -> dict:
        return {"moves": [(m.district, m.src_host, m.dst_host)
                          for m in self.moves],
                "imbalance_before": round(self.imbalance_before, 3),
                "imbalance_after": round(self.imbalance_after, 3),
                "placement_version": self.placement.version}


def _imbalance(host_load: np.ndarray) -> float:
    """Peak-to-mean ratio: 1.0 is perfectly balanced."""
    mean = float(np.mean(host_load))
    if mean <= 0:
        return 1.0
    return float(np.max(host_load)) / mean


def district_bytes_of(system) -> np.ndarray:
    """Per-district resident bytes on the edge plane: the hub-aligned
    dense local table (k², the engines' packed block) plus the stage-A
    border rows (k·b) at float32."""
    out = np.zeros(system.partition.num_districts, dtype=np.int64)
    for i, srv in enumerate(system.servers):
        li = srv.plain if srv.augmented is None else srv.augmented
        k = len(li.vertices)
        b = li.border_dist.shape[1] if li.border_dist.ndim == 2 else 0
        out[i] = 4 * (k * k + k * b)
    return out


class RebalancePlanner:
    """Greedy load/byte-aware migration planner.

    Feed it per-district query counts (``observe_load``, cumulative) and
    optionally resident bytes (``observe_bytes``); ``plan()`` returns a
    ``MigrationPlan`` moving at most ``max_moves`` districts off the
    hottest hosts, or ``None`` while the peak-to-mean load ratio stays
    under ``imbalance_threshold``.  Each move must strictly reduce the
    hottest host's load and keep every host under ``byte_budget`` (when
    set), so a plan never oscillates: re-planning from the post-plan
    state observes a smaller peak.
    """

    def __init__(self, placement: EdgePlacement, *, max_moves: int = 2,
                 imbalance_threshold: float = 1.25,
                 byte_budget: int | None = None):
        if max_moves < 1:
            raise ValueError("max_moves must be >= 1")
        if imbalance_threshold < 1.0:
            raise ValueError("imbalance_threshold must be >= 1.0")
        self.placement = placement
        self.max_moves = max_moves
        self.imbalance_threshold = float(imbalance_threshold)
        self.byte_budget = byte_budget
        m = placement.num_districts
        self.district_load = np.zeros(m, dtype=np.float64)
        self.district_bytes = np.zeros(m, dtype=np.int64)

    @classmethod
    def for_system(cls, system, num_hosts: int, **kw) -> "RebalancePlanner":
        """Planner seeded from a live ``EdgeSystem``: current placement
        (or the blocked default) and measured resident bytes."""
        placement = system.placement
        if placement is None:
            placement = EdgePlacement.blocked(
                system.partition.num_districts, num_hosts)
        p = cls(placement, **kw)
        p.observe_bytes(district_bytes_of(system))
        return p

    def observe_load(self, district_load: np.ndarray) -> None:
        """Accumulate per-district query counts (e.g.
        ``DistanceService.district_load`` deltas or a loadgen report's
        ``district_load``)."""
        load = np.asarray(district_load, dtype=np.float64)
        if load.shape != self.district_load.shape:
            raise ValueError("district_load has wrong length "
                             f"({len(load)} != {len(self.district_load)})")
        self.district_load += load

    def observe_bytes(self, district_bytes: np.ndarray) -> None:
        bts = np.asarray(district_bytes, dtype=np.int64)
        if bts.shape != self.district_bytes.shape:
            raise ValueError("district_bytes has wrong length")
        self.district_bytes = bts

    def imbalance(self) -> float:
        return _imbalance(self.placement.host_totals(self.district_load))

    def plan(self) -> MigrationPlan | None:
        placement = self.placement
        host_load = placement.host_totals(self.district_load)
        host_bytes = placement.host_totals(self.district_bytes)
        before = host_load.copy()
        host_of = placement.host_of.copy()
        moves: list[MigrationMove] = []
        for _ in range(self.max_moves):
            hot = int(np.argmax(host_load))
            mean = float(host_load.sum()) / max(1, placement.num_hosts)
            if mean <= 0 or host_load[hot] <= self.imbalance_threshold * mean:
                break
            resident = np.nonzero(host_of == hot)[0]
            if len(resident) <= 1:
                break                       # can't empty a host entirely
            cold = int(np.argmin(host_load))
            # heaviest first: the biggest single-step peak reduction that
            # doesn't just trade places with the cold host
            done = True
            for d in resident[np.argsort(-self.district_load[resident],
                                         kind="stable")]:
                d = int(d)
                load_d = self.district_load[d]
                if load_d <= 0:
                    break                   # rest are zero-load: no gain
                if host_load[cold] + load_d >= host_load[hot]:
                    continue                # move would not reduce the peak
                if self.byte_budget is not None and \
                        host_bytes[cold] + self.district_bytes[d] \
                        > self.byte_budget:
                    continue
                moves.append(MigrationMove(d, hot, cold, float(load_d),
                                           int(self.district_bytes[d])))
                host_of[d] = cold
                host_load[hot] -= load_d
                host_load[cold] += load_d
                host_bytes[hot] -= self.district_bytes[d]
                host_bytes[cold] += self.district_bytes[d]
                done = False
                break
            if done:
                break
        if not moves:
            return None
        new_placement = EdgePlacement(host_of, placement.num_hosts,
                                      placement.version + 1)
        return MigrationPlan(tuple(moves), new_placement, before,
                             host_load, host_bytes)

    def commit(self, plan: MigrationPlan) -> None:
        """Adopt the plan's placement as the planner's new baseline."""
        self.placement = plan.placement
