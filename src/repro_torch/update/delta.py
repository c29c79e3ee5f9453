"""Traffic-delta classification: which parts of the index can a weight
update actually touch?

A traffic epoch hands the center a fresh CSR-aligned weight array for the
same topology (``Graph.with_weights``).  Everything the hierarchical
builder computes factors through the district structure, so the repair
scope follows directly from where the dirty edges sit:

* an *intra-district* dirty edge dirties exactly one district — its
  stage-A distances, its overlay border block, and (transitively) any
  stage-C rows whose closure inputs move;
* a *cross-district* dirty edge never appears in any district's dense
  adjacency; it only moves its single entry of the border overlay
  (both endpoints are borders by Definition 4).

``classify_delta`` reduces a ``new_weights`` array to that scope in one
vectorized pass.  The result is consumed by ``update.incremental``
(index repair), ``ComputingCenter.apply_delta`` (scoped shortcut
invalidation), and ``EdgeSystem.apply_traffic_update(...,
incremental=True)`` (which edge servers must refresh their local index
at all).

Host NumPy, a copy of ``repro.update.delta`` kept in this package so
the port imports nothing of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.graph import Graph
from ..core.partition import Partition


@dataclass(frozen=True)
class WeightDelta:
    """Scope of one traffic update, classified against a base weight
    snapshot (symmetric CSR arc pairs — ``with_weights`` validates)."""

    dirty_arcs: np.ndarray        # bool (2m,) CSR arcs whose weight moved
    num_dirty_edges: int          # undirected dirty edge count
    num_edges: int                # undirected edge count of the graph
    dirty_districts: np.ndarray   # int32 ascending: districts with a dirty
                                  # intra-district edge
    cross_dirty: bool             # any cross-district (border-overlay) edge
                                  # moved
    num_districts: int

    @property
    def is_empty(self) -> bool:
        # anchored on the arc mask, not the halved edge count: an invalid
        # asymmetric update dirties one arc and must NOT classify as a
        # no-op (with_weights rejects it downstream, same as a rebuild)
        return not bool(self.dirty_arcs.any())

    @property
    def frac_dirty(self) -> float:
        """Dirty share of the undirected edge set (the sweep axis of
        ``benchmarks/bench_update.py``)."""
        return self.num_dirty_edges / max(1, self.num_edges)

    @property
    def frac_districts_dirty(self) -> float:
        return len(self.dirty_districts) / max(1, self.num_districts)

    def summary(self) -> dict:
        return {"dirty_edges": self.num_dirty_edges,
                "frac_dirty": round(self.frac_dirty, 4),
                "dirty_districts": self.dirty_districts.tolist(),
                "cross_dirty": self.cross_dirty}


def classify_delta(g: Graph, part: Partition,
                   new_weights: np.ndarray) -> WeightDelta:
    """Classify ``new_weights`` against ``g``'s current weights.

    Topology is fixed (same CSR arrays); only weights move.  One NumPy
    pass over the arcs finds the dirty set, splits it into intra-district
    (→ dirty districts) and cross-district (→ overlay entries) arcs.
    """
    new_weights = np.asarray(new_weights, dtype=np.float32)
    if new_weights.shape != g.weights.shape:
        raise ValueError("weight array shape mismatch (topology changes "
                         "are a rebuild, not a delta)")
    dirty = g.weights != new_weights
    src = g.arc_sources()
    d_src = part.assignment[src[dirty]]
    d_dst = part.assignment[g.indices[dirty]]
    intra = d_src == d_dst
    dirty_districts = np.unique(d_src[intra]).astype(np.int32)
    # symmetric updates dirty both CSR arcs of an edge together
    return WeightDelta(dirty, int(dirty.sum()) // 2, g.num_edges,
                       dirty_districts, bool((~intra).any()),
                       part.num_districts)


def weights_from_arc_updates(g: Graph, u, v, w) -> np.ndarray:
    """CSR-aligned weight array with the undirected edges (u_i, v_i) set
    to ``w_i`` — the validated entry point for sparse traffic updates.

    Every named edge is checked against ``g``'s arc set; an unknown pair
    raises a ``ValueError`` naming the offending ``(u, v)`` instead of
    being silently dropped or misclassified as dirty downstream.  Both
    CSR arcs of each edge are written, so the result always passes
    ``with_weights`` symmetry validation.  A pair listed twice keeps the
    last weight (both occurrences hit the same two arcs).
    """
    u = np.atleast_1d(np.asarray(u, dtype=np.int64))
    v = np.atleast_1d(np.asarray(v, dtype=np.int64))
    if u.shape != v.shape:
        raise ValueError("endpoint arrays must have the same length")
    w = np.broadcast_to(np.asarray(w, dtype=np.float32), u.shape)
    n = g.num_vertices
    oob = (u < 0) | (u >= n) | (v < 0) | (v >= n) | (u == v)
    if oob.any():
        j = int(np.nonzero(oob)[0][0])
        raise ValueError(f"({int(u[j])}, {int(v[j])}) is not a valid "
                         f"edge of a graph with {n} vertices")
    keys = g._arc_keys()                       # canonical key per CSR arc
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    want = np.minimum(u, v) * n + np.maximum(u, v)
    lo = np.searchsorted(skeys, want, side="left")
    missing = (lo >= len(skeys)) | (skeys[np.minimum(lo, len(skeys) - 1)]
                                    != want)
    if missing.any():
        j = int(np.nonzero(missing)[0][0])
        raise ValueError(f"edge ({int(u[j])}, {int(v[j])}) is not in the "
                         "graph's arc set (a closure/opening is a "
                         "structural delta — see topo.structural)")
    out = g.weights.copy()
    # both CSR arcs of an edge share the canonical key and sort adjacent
    out[order[lo]] = w
    out[order[lo + 1]] = w
    return out
