"""Per-district local indexes L_i (plain) and L_i⁺ (shortcut-augmented).

An edge server owns one LocalIndex: labels in local vertex numbering plus
the maps back to global ids. ``plain`` labels (no shortcuts) are what the
server can build *by itself* from its own district subgraph — they power
the Local Bound fallback (Theorem 3) while the computing center is still
rebuilding B. ``augmented`` labels additionally fold in the Border
Auxiliary Shortcuts pushed down by the center and answer same-district
queries globally-exactly (Theorem 2).

The labels are built on the host (NumPy PLL); the serving layouts — the
dense hub table, the vertex→border distances and the padded sparse
labels — are uploaded to ``device`` once per index (a new index version
is a new ``LocalIndex``) and the batched joins run there through
``kernels.label_join.ops``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.label_join import ops as lj
from .graph import Graph
from .labels import BorderLabels, SparseLabels
from .partition import Partition, borders_of
from .pll import pll_subgraph
from .shortcuts import border_shortcut_matrix, shortcut_edges

INF = np.float32(np.inf)


@dataclass
class LocalIndex:
    district_id: int
    vertices: np.ndarray        # (k,) int32 global ids, ascending
    border_locals: np.ndarray   # (b,) int64 positions of borders
    labels: SparseLabels        # L_i⁺ if augmented else L_i (local ids)
    augmented: bool
    # distances from every local vertex to every district border, via the
    # local labels only — precomputed once, powers LB in O(b) per endpoint
    border_dist: np.ndarray = field(default=None)  # type: ignore[assignment]
    # where the serving layouts live; None = the CUDA device (raises
    # without one — pass "cpu" to run the joins' plain versions)
    device: torch.device | str | None = None
    # lazily-built dense hub-aligned table (see dense_table); hubs of L_i
    # are local ids, so the hub axis is the district's own vertex range
    _dense: np.ndarray | None = field(default=None, repr=False)
    # device copies, built on first use (one index object = one version)
    _dense_dev: torch.Tensor | None = field(default=None, repr=False)
    _border_dist_dev: torch.Tensor | None = field(default=None, repr=False)
    _sparse_dev: tuple | None = field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.border_dist is None:
            k = len(self.vertices)
            b = len(self.border_locals)
            bd = np.full((k, b), INF, dtype=np.float32)
            for j, bloc in enumerate(self.border_locals):
                bd[:, j] = self.labels.query_many(
                    np.arange(k), np.full(k, int(bloc)))
            self.border_dist = bd

    def local_of(self, global_ids: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.vertices, global_ids)

    def query_local(self, s_local: int, t_local: int) -> float:
        return self.labels.query(s_local, t_local)

    def dense_table(self) -> np.ndarray:
        """Hub-aligned dense layout of the local labels: ``(k, k)`` float32
        with ``table[v, h] = λ-entry dist(v, h)`` and +inf where ``h`` is
        not a hub of ``v`` — the same serving layout as BorderLabels
        (slot j ≡ local vertex j), so same-district joins run through the
        identical dense ``label_join`` kernel as rule-3. Built once per
        index version and cached on the host (the engine packs it)."""
        if self._dense is None:
            self._dense = self.labels.to_dense_hub_table(
                self.labels.num_vertices)
        return self._dense

    def dense_table_device(self) -> torch.Tensor:
        """``dense_table()`` resident on ``device`` (cached)."""
        if self._dense_dev is None:
            self._dense_dev = torch.from_numpy(self.dense_table()) \
                .to(self.device)
        return self._dense_dev

    def border_dist_device(self) -> torch.Tensor:
        """``border_dist`` resident on ``device`` (cached)."""
        if self._border_dist_dev is None:
            self._border_dist_dev = torch.from_numpy(
                np.ascontiguousarray(self.border_dist, dtype=np.float32)) \
                .to(self.device)
        return self._border_dist_dev

    def sparse_device(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The padded sparse labels ``(hubs, dists)`` on ``device``
        (cached) — the rule-1/2 join of a rebuild window reads them."""
        if self._sparse_dev is None:
            self._sparse_dev = (
                torch.from_numpy(self.labels.hubs).to(self.device),
                torch.from_numpy(self.labels.dists).to(self.device))
        return self._sparse_dev

    def query_local_many(self, s_locals: np.ndarray,
                         t_locals: np.ndarray) -> np.ndarray:
        """Vectorized λ(s,t,L_i) for a bucket of same-district queries
        (local ids), through the dense label_join kernel over the
        device-resident hub-aligned table."""
        return lj.join_gathered(self.dense_table_device(), s_locals,
                                t_locals)

    def local_bound_many(self, s_locals: np.ndarray,
                         t_locals: np.ndarray) -> np.ndarray:
        """Vectorized Definition-5 Local Bound over the device-resident
        vertex→border distance table."""
        return lj.bound_gathered(self.border_dist_device(), s_locals,
                                 t_locals)

    def size_bytes(self) -> int:
        return self.labels.size_bytes()


def build_local_index(g: Graph, part: Partition, district_id: int,
                      bl: BorderLabels | None = None,
                      device: torch.device | str | None = None
                      ) -> LocalIndex:
    """Build L_i (bl=None) or L_i⁺ (bl given → shortcuts folded in)."""
    vertices = np.nonzero(part.assignment == np.int32(district_id))[0] \
        .astype(np.int32)
    district_borders = borders_of(g, part)[district_id]
    pos = {int(v): i for i, v in enumerate(vertices)}
    border_locals = np.array([pos[int(b)] for b in district_borders],
                             dtype=np.int64)
    extra = None
    if bl is not None and len(district_borders) > 1:
        sc = border_shortcut_matrix(bl, district_borders)
        extra = shortcut_edges(border_locals, sc)
    labels, verts = pll_subgraph(g, vertices, extra_edges=extra)
    return LocalIndex(district_id, verts, border_locals, labels,
                      augmented=bl is not None, device=device)


def build_all_local_indexes(g: Graph, part: Partition,
                            bl: BorderLabels | None = None,
                            device: torch.device | str | None = None
                            ) -> list[LocalIndex]:
    """Every district's L_i (bl=None) or L_i⁺, serving on ``device``."""
    return [build_local_index(g, part, i, bl=bl, device=device)
            for i in range(part.num_districts)]
