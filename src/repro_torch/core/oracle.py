"""DistanceOracle — the user-facing API tying the whole index together.

``DistanceOracle.build`` reproduces the paper's two-phase construction and
reports the two Table-2 timing columns separately:

  * BL        — time to build the border labels B (Algorithm 1);
  * Districts — cumulative time to compute every district's auxiliary
                shortcuts from B *plus* building all local indexes L_i⁺.

Queries follow §4.2 routing: same-district → L_i⁺ (Theorem 2), otherwise →
B (Theorem 1).

B and the local indexes are built on the host (the reference and
hierarchical builders); the oracle serves on ``device`` (None = the CUDA
card, raising without one; ``"cpu"`` runs the joins' plain versions),
where ``query_many`` keeps B's device copy. Each timing column is read
on the host clock after a device synchronise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.label_join import ops as lj
from .border_labeling import (build_border_labels_hierarchical,
                              build_border_labels_reference)
from .graph import Graph
from .labels import BorderLabels
from .local_index import LocalIndex, build_all_local_indexes
from .partition import Partition
from .query import query_batch

INF = np.float32(np.inf)

_BUILDERS = {"reference": build_border_labels_reference,
             "hierarchical": build_border_labels_hierarchical}


@dataclass
class BuildStats:
    bl_seconds: float = 0.0
    districts_seconds: float = 0.0
    bl_bytes: int = 0
    local_bytes: int = 0
    num_borders: int = 0

    def as_row(self) -> dict:
        return {
            "bl_s": round(self.bl_seconds, 4),
            "districts_s": round(self.districts_seconds, 4),
            "bl_mb": round(self.bl_bytes / 1e6, 3),
            "local_mb": round(self.local_bytes / 1e6, 3),
            "borders": self.num_borders,
        }


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@dataclass
class DistanceOracle:
    graph: Graph
    partition: Partition
    border_labels: BorderLabels
    local_indexes: list[LocalIndex]
    stats: BuildStats = field(default_factory=BuildStats)
    # where the joins run (None = the CUDA device)
    device: torch.device | str | None = None
    # B resident on ``device``, uploaded by the first query_many
    _btable: torch.Tensor | None = field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @classmethod
    def build(cls, g: Graph, part: Partition, builder: str = "reference",
              device: torch.device | str | None = None
              ) -> "DistanceOracle":
        if builder not in _BUILDERS:
            raise ValueError(f"unknown builder {builder!r}")
        device = resolve_device(device)
        t0 = _clock(device)
        bl = _BUILDERS[builder](g, part)
        t1 = _clock(device)
        locals_ = build_all_local_indexes(g, part, bl=bl, device=device)
        t2 = _clock(device)
        stats = BuildStats(
            bl_seconds=t1 - t0,
            districts_seconds=t2 - t1,
            bl_bytes=bl.size_bytes(),
            local_bytes=sum(li.size_bytes() for li in locals_),
            num_borders=bl.num_borders,
        )
        return cls(g, part, bl, locals_, stats, device)

    def border_table_device(self) -> torch.Tensor:
        """B resident on ``device`` (uploaded once per oracle)."""
        if self._btable is None:
            self._btable = lj.upload(
                self.border_labels.table.astype(np.float32, copy=False),
                self.device)
        return self._btable

    def query(self, s: int, t: int) -> float:
        return float(self.query_many(np.array([s]), np.array([t]))[0])

    def query_many(self, ss: np.ndarray, ts: np.ndarray) -> np.ndarray:
        return query_batch(self.border_labels, self.local_indexes,
                           self.partition.assignment, ss, ts,
                           btable=self.border_table_device())

    def rebuild(self, new_weights: np.ndarray,
                builder: str = "reference") -> "DistanceOracle":
        """Full re-index after a traffic update (the computing-center job)."""
        return DistanceOracle.build(self.graph.with_weights(new_weights),
                                    self.partition, builder=builder,
                                    device=self.device)
