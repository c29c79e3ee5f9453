"""Label data structures and 2-hop joins (Definition 1).

Two layouts:

* ``SparseLabels`` — the classic per-vertex hub list, padded to a fixed
  width so batched joins vectorize (hub ids int32 with -1 padding, dists
  float32 with +inf padding). Used for per-district local indexes
  ``L_i`` / ``L_i⁺``.
* ``BorderLabels`` — the paper's observation that a border label never
  exceeds the border count q (§5.1) makes a *hub-aligned dense table*
  ``(n, q)`` the natural TPU layout: slot j of every row refers to border
  ``border_ids[j]``, pruned entries are +inf, and a query is a fused
  ``min(row_s + row_t)`` reduction (``kernels/label_join``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

INF = np.float32(np.inf)


@dataclass
class SparseLabels:
    """Padded per-vertex hub labels. ``hubs[v]`` sorted ascending by hub id
    (with -1 padding at the tail) so joins can merge or mask."""

    hubs: np.ndarray   # (n, L) int32, -1 = empty slot
    dists: np.ndarray  # (n, L) float32, +inf = empty slot

    @property
    def num_vertices(self) -> int:
        return int(self.hubs.shape[0])

    @property
    def width(self) -> int:
        return int(self.hubs.shape[1])

    def label_sizes(self) -> np.ndarray:
        return (self.hubs >= 0).sum(axis=1).astype(np.int64)

    def size_bytes(self) -> int:
        """Index size counted the paper's way: one 2-tuple <hub,dist> of
        32-bit values per stored label entry."""
        return int(self.label_sizes().sum()) * 8

    def query(self, s: int, t: int) -> float:
        """λ(s,t,L) via masked pairwise join (reference implementation)."""
        hs, ds = self.hubs[s], self.dists[s]
        ht, dt = self.hubs[t], self.dists[t]
        eq = (hs[:, None] == ht[None, :]) & (hs[:, None] >= 0)
        tot = ds[:, None] + dt[None, :]
        return float(np.min(np.where(eq, tot, INF), initial=INF))

    def query_many(self, ss: np.ndarray, ts: np.ndarray) -> np.ndarray:
        hs, ds = self.hubs[ss], self.dists[ss]          # (Q, L)
        ht, dt = self.hubs[ts], self.dists[ts]
        eq = (hs[:, :, None] == ht[:, None, :]) & (hs[:, :, None] >= 0)
        tot = ds[:, :, None] + dt[:, None, :]
        return np.min(np.where(eq, tot, INF), axis=(1, 2),
                      initial=INF).astype(np.float32)

    def to_dense_hub_table(self, num_hubs: int | None = None) -> np.ndarray:
        """Densify to the hub-aligned layout (inverse of
        ``BorderLabels.to_sparse``): ``table[v, h]`` is the stored
        distance from v to hub h, +inf where h is not a hub of v. Valid
        when hub ids are dense in [0, num_hubs) — true for local indexes,
        whose hubs are local vertex ids. This is the batched-serving
        layout: a 2-hop join becomes the same fused ``min(row_s + row_t)``
        reduction BorderLabels uses (``kernels/label_join``)."""
        if num_hubs is None:
            num_hubs = max(self.num_vertices, int(self.hubs.max()) + 1)
        table = np.full((self.num_vertices, num_hubs), INF,
                        dtype=np.float32)
        rows = np.repeat(np.arange(self.num_vertices), self.width)
        hubs = self.hubs.ravel()
        mask = hubs >= 0
        table[rows[mask], hubs[mask]] = self.dists.ravel()[mask]
        return table


@dataclass
class BorderLabels:
    """Dense hub-aligned border-label table B (TPU layout)."""

    border_ids: np.ndarray  # (q,) int32 global vertex id of hub slot j
    table: np.ndarray       # (n, q) float32; +inf = pruned / unreachable

    @property
    def num_vertices(self) -> int:
        return int(self.table.shape[0])

    @property
    def num_borders(self) -> int:
        return int(self.table.shape[1])

    def label_sizes(self) -> np.ndarray:
        return np.isfinite(self.table).sum(axis=1).astype(np.int64)

    def size_bytes(self) -> int:
        return int(self.label_sizes().sum()) * 8

    def query(self, s: int, t: int) -> float:
        return float(np.min(self.table[s] + self.table[t], initial=INF))

    def query_many(self, ss: np.ndarray, ts: np.ndarray) -> np.ndarray:
        return np.min(self.table[ss] + self.table[ts], axis=1,
                      initial=INF).astype(np.float32)

    def to_sparse(self) -> SparseLabels:
        """Convert to padded sparse layout (for storage-size comparisons)."""
        finite = np.isfinite(self.table)
        width = max(1, int(finite.sum(axis=1).max()))
        n = self.num_vertices
        hubs = -np.ones((n, width), dtype=np.int32)
        dists = np.full((n, width), INF, dtype=np.float32)
        for v in range(n):
            sel = np.nonzero(finite[v])[0]
            hubs[v, :len(sel)] = self.border_ids[sel]
            dists[v, :len(sel)] = self.table[v, sel]
        return SparseLabels(hubs, dists)


def pack_sparse(label_lists: list[list[tuple[int, float]]],
                width: int | None = None) -> SparseLabels:
    """Pack python label lists into the padded layout (hub-id ascending)."""
    n = len(label_lists)
    if width is None:
        width = max(1, max((len(l) for l in label_lists), default=1))
    hubs = -np.ones((n, width), dtype=np.int32)
    dists = np.full((n, width), INF, dtype=np.float32)
    for v, lab in enumerate(label_lists):
        lab = sorted(lab)[:width]
        for j, (h, d) in enumerate(lab):
            hubs[v, j] = h
            dists[v, j] = d
    return SparseLabels(hubs, dists)
