"""Computing center (§4.2): owns the border labels B, rebuilds them each
traffic epoch, answers rule-3 (cross-district) queries, forwards rule-2
queries, and pushes Border Auxiliary Shortcuts down to the edge servers.

Index versions are double-buffered: while version k+1 is building, version
k keeps serving (the paper instead lets edge servers fall back to the
Local Bound).

B is built either on the host (``builder="reference"``: Algorithm 1,
pruned Dijkstra from every border) or on ``device`` by the staged dense
builder (``builder="torch"``, the counterpart of the JAX package's
``builder="jax"``: ``update.IncrementalBuilder.build_full`` over
``core.torch_builder``, stages A–C on the min-plus CUDA kernels). Either
way B is kept resident on ``device`` per version for the rule-3 join;
the staged builder hands over its own device tensor.

``apply_delta`` (weights) and ``apply_structural`` (closures/openings)
repair B delta-scoped through ``update.IncrementalBuilder`` on
``device``, whatever ``builder`` is (as in the JAX package, the repair
is defined over the staged builder's cached stage outputs, and is bit
for bit equal to a full staged rebuild), and invalidate only the
districts whose shortcut inputs (their borders' B rows) moved. The
repaired table's device tensor becomes B's device copy for the new
version.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.border_labeling import build_border_labels_reference
from ..core.graph import Graph
from ..core.labels import BorderLabels
from ..core.partition import Partition, borders_of
from ..core.shortcuts import border_shortcut_matrix
from ..device import resolve_device
from ..kernels.label_join import ops as lj
from ..topo.structural import classify_structural
from ..update.delta import classify_delta
from ..update.incremental import IncrementalBuilder

BUILDERS = ("reference", "torch")


@dataclass
class ComputingCenter:
    graph: Graph
    partition: Partition
    border_labels: BorderLabels | None = None
    version: int = 0
    last_build_seconds: float = 0.0
    # "reference" (Algorithm 1 on the host) or "torch" (the staged dense
    # pipeline on ``device``)
    builder: str = "reference"
    # where B is kept for the rule-3 join (None = the CUDA device)
    device: torch.device | str | None = None
    _shortcut_cache: dict[int, np.ndarray] = field(default_factory=dict)
    # border lists depend on topology + partition only — weight updates
    # never move them, so they are computed once per deployment instead
    # of inside every shortcuts_for call
    _border_lists: list[np.ndarray] | None = field(default=None, repr=False)
    # (version, B on device)
    _btable_dev: tuple[int, torch.Tensor] | None = field(default=None,
                                                         repr=False)
    _inc: IncrementalBuilder | None = field(default=None, repr=False)

    def __post_init__(self):
        if self.builder == "jax":
            raise ValueError("builder='jax' is the JAX package's staged "
                             "builder; the port's counterpart is 'torch'")
        if self.builder not in BUILDERS:
            raise ValueError(f"builder={self.builder!r}: expected one of "
                             f"{BUILDERS}")
        self.device = resolve_device(self.device)

    def incremental_builder(self) -> IncrementalBuilder:
        """The staged builder behind ``builder="torch"`` (its ``state``
        and ``timings`` describe the last rebuild)."""
        if self._inc is None:
            self._inc = IncrementalBuilder(device=self.device)
        return self._inc

    def rebuild(self, new_weights: np.ndarray | None = None) -> float:
        """Rebuild B from fresh edge weights; returns build seconds."""
        if new_weights is not None:
            self.graph = self.graph.with_weights(new_weights)
        t0 = time.perf_counter()
        table_dev = None
        if self.builder == "torch":
            inc = self.incremental_builder()
            self.border_labels = inc.build_full(self.graph, self.partition)
            table_dev = inc.state.table_device
        else:
            self.border_labels = build_border_labels_reference(
                self.graph, self.partition)
        self.last_build_seconds = time.perf_counter() - t0
        self.version += 1
        self._shortcut_cache.clear()
        self._btable_dev = None if table_dev is None \
            else (self.version, table_dev)
        return self.last_build_seconds

    def set_topology(self, g_new: Graph) -> None:
        """Take a new topology (same vertex set and partition) before a
        ``rebuild``: the border lists and every shortcut matrix are
        derived from it, so both are dropped."""
        self.graph = g_new
        self._forget_borders()

    def _forget_borders(self) -> None:
        self._border_lists = None
        self._shortcut_cache.clear()

    def _adopt_repair(self, g_new: Graph, labels: BorderLabels,
                      seconds: float) -> None:
        """Install a repaired B as the next version, with the repaired
        table's device tensor as its device copy."""
        self.last_build_seconds = seconds
        self.graph = g_new
        self.border_labels = labels
        self.version += 1
        table_dev = self.incremental_builder().state.table_device
        self._btable_dev = None if table_dev is None \
            else (self.version, table_dev)

    def _invalidate(self, changed: np.ndarray) -> list[int]:
        """Scoped invalidation: district i's shortcut matrix reads only
        the B rows of its own borders — drop it iff one of those rows
        moved. Returns the stale districts."""
        stale = [i for i, b in enumerate(self._borders())
                 if len(b) and changed[b].any()]
        for i in stale:
            self._shortcut_cache.pop(i, None)
        return stale

    def apply_delta(self, new_weights: np.ndarray) -> dict:
        """Delta-scoped rebuild: repair B for a weight update and bump the
        version, invalidating only the shortcut matrices whose inputs
        moved. Returns a report::

            {"seconds", "incremental", "delta", "stale_districts",
             "changed_rows", "noop"}

        ``stale_districts`` are the districts whose Border Auxiliary
        Shortcuts changed (their edge servers must reinstall);
        everything else keeps serving the same shortcuts. A delta with
        no dirty edges is a no-op (no version bump).
        """
        delta = classify_delta(self.graph, self.partition, new_weights)
        if delta.is_empty and self.border_labels is not None:
            return {"seconds": 0.0, "incremental": True, "delta": delta,
                    "stale_districts": [], "noop": True,
                    "changed_rows": np.zeros(self.graph.num_vertices,
                                             dtype=bool)}
        g2 = self.graph.with_weights(new_weights)
        t0 = time.perf_counter()
        labels, rep = self.incremental_builder().apply_delta(
            g2, self.partition, delta)
        self._adopt_repair(g2, labels, time.perf_counter() - t0)
        changed = rep["changed_rows"]
        return {"seconds": self.last_build_seconds,
                "incremental": rep["incremental"], "delta": delta,
                "stale_districts": self._invalidate(changed),
                "changed_rows": changed, "noop": False}

    def apply_structural(self, g_new: Graph) -> dict:
        """Structural rebuild for a topology change (closures/openings):
        classify via ``topo``, repair B with the scoped structural path,
        bump the version, and invalidate only the shortcut matrices
        whose inputs moved. Same report as ``apply_delta`` plus
        ``"border_changed"``.

        Border lists are topology-derived, so unlike the weight path
        they are re-derived whenever the border sets moved (and the
        whole shortcut cache dropped with them — stale border lists
        would index B with the wrong rows)."""
        delta = classify_structural(self.graph, self.partition, g_new)
        if delta.is_empty and self.border_labels is not None:
            self.graph = g_new      # fresh CSR identity, same topology
            return {"seconds": 0.0, "incremental": True, "delta": delta,
                    "stale_districts": [], "noop": True,
                    "border_changed": False,
                    "changed_rows": np.zeros(self.graph.num_vertices,
                                             dtype=bool)}
        t0 = time.perf_counter()
        labels, rep = self.incremental_builder().apply_structural(
            g_new, self.partition, delta)
        self._adopt_repair(g_new, labels, time.perf_counter() - t0)
        changed = rep["changed_rows"]
        if delta.border_changed or rep.get("border_changed"):
            self._forget_borders()
            stale = list(range(self.partition.num_districts))
        else:
            stale = self._invalidate(changed)
        return {"seconds": self.last_build_seconds,
                "incremental": rep["incremental"], "delta": delta,
                "stale_districts": stale, "changed_rows": changed,
                "border_changed": delta.border_changed, "noop": False}

    def _borders(self) -> list[np.ndarray]:
        if self._border_lists is None:
            self._border_lists = borders_of(self.graph, self.partition)
        return self._border_lists

    def shortcuts_for(self, district_id: int) -> np.ndarray:
        """Border Auxiliary Shortcuts pushed to one edge server."""
        assert self.border_labels is not None, "rebuild() first"
        if district_id not in self._shortcut_cache:
            b = self._borders()[district_id]
            self._shortcut_cache[district_id] = border_shortcut_matrix(
                self.border_labels, b)
        return self._shortcut_cache[district_id]

    def border_rows_for(self, district_id: int
                        ) -> tuple[np.ndarray, np.ndarray]:
        """``(vertices, rows)`` — the B rows of one district's vertices,
        pushed to its edge server alongside the shortcuts (host rows).
        This is the center's only role in the scatter-gather read path:
        it computes B and distributes each district its slice; the
        servers then answer rule-3 queries peer-to-peer
        (``EdgeServer.exchange_border_rows``) without the center ever
        seeing a query."""
        assert self.border_labels is not None, "rebuild() first"
        vertices = np.nonzero(
            self.partition.assignment == np.int32(district_id))[0] \
            .astype(np.int64)
        rows = np.ascontiguousarray(self.border_labels.table[vertices],
                                    dtype=np.float32)
        return vertices, rows

    def border_table_device(self) -> torch.Tensor:
        """B of the current version, resident on ``device``."""
        assert self.border_labels is not None, "rebuild() first"
        if self._btable_dev is None or self._btable_dev[0] != self.version:
            self._btable_dev = None         # free the old copy first
            self._btable_dev = (self.version, lj.upload(
                np.asarray(self.border_labels.table, dtype=np.float32),
                self.device))
        return self._btable_dev[1]

    def answer_cross(self, s: int, t: int) -> float:
        assert self.border_labels is not None
        return self.border_labels.query(s, t)

    def answer_cross_many(self, ss: np.ndarray,
                          ts: np.ndarray) -> np.ndarray:
        """Rule-3 bucket: one fused gather-join over the device-resident
        B."""
        assert self.border_labels is not None
        return lj.join_gathered(self.border_table_device(), ss, ts)
