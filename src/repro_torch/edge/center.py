"""Computing center (§4.2): owns the border labels B, rebuilds them each
traffic epoch, answers rule-3 (cross-district) queries, forwards rule-2
queries, and pushes Border Auxiliary Shortcuts down to the edge servers.

Index versions are double-buffered: while version k+1 is building, version
k keeps serving (the paper instead lets edge servers fall back to the
Local Bound).

B is built on the host (``builder="reference"``: Algorithm 1, pruned
Dijkstra from every border) and kept resident on ``device`` per version
for the rule-3 join. The staged dense builder (``builder="jax"`` in the
JAX package) and the delta-scoped repairs ``apply_delta`` /
``apply_structural`` come with later slices.
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

BUILDERS = ("reference",)


@dataclass
class ComputingCenter:
    graph: Graph
    partition: Partition
    border_labels: BorderLabels | None = None
    version: int = 0
    last_build_seconds: float = 0.0
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

    def __post_init__(self):
        if self.builder not in BUILDERS:
            raise NotImplementedError(
                f"builder={self.builder!r} is not ported yet (ROADMAP "
                "Queue 1 item 5, the staged builder); use 'reference'")
        self.device = resolve_device(self.device)

    def rebuild(self, new_weights: np.ndarray | None = None) -> float:
        """Rebuild B from fresh edge weights; returns build seconds."""
        if new_weights is not None:
            self.graph = self.graph.with_weights(new_weights)
        t0 = time.perf_counter()
        self.border_labels = build_border_labels_reference(
            self.graph, self.partition)
        self.last_build_seconds = time.perf_counter() - t0
        self.version += 1
        self._shortcut_cache.clear()
        self._btable_dev = None
        return self.last_build_seconds

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
