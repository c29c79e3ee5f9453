"""Structural deltas: road closures/openings as first-class updates.

``update`` repairs the index when edge *weights* move on a fixed
topology.  Real traffic also closes and opens roads — arcs vanish from
and appear in the CSR itself, so degrees change, and (when a cross-
district arc is involved) the Definition-4 border sets can change too.
Modelling a closure as ``w = +inf`` would keep the arc resident in every
dense adjacency block and freeze the border sets at their stale values;
this module instead diffs two genuine CSR topologies.

Following the dual-hierarchy idea (PAPERS.md, arXiv 2506.18013 — keep a
small fast-changing structure separate from the stable one), a
structural delta is classified by which layer of the hierarchy it can
actually reach:

* an *intra-district* closure/opening changes one district's dense
  adjacency — its stage-A sweep re-runs, its overlay block is patched —
  and can NEVER change any border set (Definition 4 reads only cross
  arcs);
* a *cross-district* closure/opening moves only its border-overlay
  entry, UNLESS it was an endpoint's last cross arc (closure) or its
  first (opening), in which case a border vertex is demoted/promoted
  and the stable layer itself — border sets, packed shapes, label
  width q — must be rebuilt (``border_changed``);
* weight changes on surviving edges classify exactly like
  ``update.delta`` weight deltas.

``classify_structural`` is consumed by
``IncrementalBuilder.apply_structural`` (scoped repair, bit-for-bit
equal to a full rebuild), ``ComputingCenter.apply_structural`` (scoped
shortcut invalidation) and ``EdgeSystem.apply_topology_update`` (which
edge servers must refresh).  ``close_edges`` / ``open_edges`` are the
validated graph editors every closure scenario goes through.

Host NumPy, a copy of ``repro.topo.structural`` kept in this package so
the port imports nothing of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.graph import Graph, from_edges
from ..core.partition import Partition, border_mask


@dataclass(frozen=True)
class StructuralDelta:
    """Scope of one topology update, classified old graph → new graph.

    The vertex set is fixed (closures never renumber vertices); the
    undirected edge set and the weights of surviving edges may both
    move.
    """

    added: np.ndarray             # (A, 2) int64, u < v: edges only in new
    removed: np.ndarray           # (R, 2) int64, u < v: edges only in old
    num_reweighted: int           # surviving edges whose weight moved
    dirty_districts: np.ndarray   # int32 ascending: districts whose intra
                                  # arc set or intra weights changed
    cross_dirty: bool             # any cross-district edge added/removed/
                                  # reweighted (border-overlay scope)
    border_changed: bool          # Definition-4 border sets differ — the
                                  # stable layer must rebuild
    num_edges_old: int
    num_edges_new: int
    num_districts: int

    @property
    def is_empty(self) -> bool:
        return (len(self.added) == 0 and len(self.removed) == 0
                and self.num_reweighted == 0)

    @property
    def num_dirty_edges(self) -> int:
        return len(self.added) + len(self.removed) + self.num_reweighted

    @property
    def frac_dirty(self) -> float:
        """Dirty share of the (old) undirected edge set — the sweep axis
        of ``benchmarks/bench_topology.py``."""
        return self.num_dirty_edges / max(1, self.num_edges_old)

    @property
    def frac_districts_dirty(self) -> float:
        return len(self.dirty_districts) / max(1, self.num_districts)

    def summary(self) -> dict:
        return {"added": len(self.added), "removed": len(self.removed),
                "reweighted": self.num_reweighted,
                "frac_dirty": round(self.frac_dirty, 4),
                "dirty_districts": self.dirty_districts.tolist(),
                "cross_dirty": self.cross_dirty,
                "border_changed": self.border_changed}


def _edges_sorted(g: Graph) -> tuple[np.ndarray, ...]:
    """(keys, u, v, w) of the undirected edge list, sorted by canonical
    u·n+v key.  ``from_edges`` dedupes parallel edges, so keys are
    unique for every graph built through it; ``np.unique`` guards the
    general case."""
    u, v, w = g.edge_list()
    keys = u.astype(np.int64) * g.num_vertices + v.astype(np.int64)
    order = np.argsort(keys, kind="stable")
    return keys[order], u[order], v[order], w[order]


def classify_structural(g_old: Graph, part: Partition,
                        g_new: Graph) -> StructuralDelta:
    """Diff two topologies over the same vertex set into a repair scope.

    One vectorized pass over both sorted edge lists splits the edges
    into added / removed / reweighted, buckets each dirty edge as
    intra-district (→ ``dirty_districts``) or cross-district
    (→ ``cross_dirty``), and compares the Definition-4 border masks to
    decide whether the stable layer survives (``border_changed``).
    """
    if g_old.num_vertices != g_new.num_vertices:
        raise ValueError(
            "structural deltas keep the vertex set fixed "
            f"(old n={g_old.num_vertices}, new n={g_new.num_vertices}); "
            "growing the network is a rebuild, not a delta")
    k0, u0, v0, w0 = _edges_sorted(g_old)
    k1, u1, v1, w1 = _edges_sorted(g_new)
    surv0 = np.isin(k0, k1, assume_unique=True)
    surv1 = np.isin(k1, k0, assume_unique=True)
    # both key arrays are sorted unique, so the surviving subsequences
    # align elementwise
    rew = w0[surv0] != w1[surv1]
    added = np.stack([u1[~surv1].astype(np.int64),
                      v1[~surv1].astype(np.int64)], axis=1) \
        if (~surv1).any() else np.zeros((0, 2), dtype=np.int64)
    removed = np.stack([u0[~surv0].astype(np.int64),
                        v0[~surv0].astype(np.int64)], axis=1) \
        if (~surv0).any() else np.zeros((0, 2), dtype=np.int64)

    du = np.concatenate([u1[~surv1], u0[~surv0], u0[surv0][rew]])
    dv = np.concatenate([v1[~surv1], v0[~surv0], v0[surv0][rew]])
    da, db = part.assignment[du], part.assignment[dv]
    intra = da == db
    dirty_districts = np.unique(da[intra]).astype(np.int32)
    cross_dirty = bool((~intra).any())
    # border sets depend ONLY on cross arcs, so they can move only when
    # a cross edge appeared or vanished — skip the mask diff otherwise
    structural_cross = bool(
        (part.assignment[du[:len(added) + len(removed)]]
         != part.assignment[dv[:len(added) + len(removed)]]).any())
    border_changed = structural_cross and not np.array_equal(
        border_mask(g_old, part), border_mask(g_new, part))
    return StructuralDelta(added, removed, int(rew.sum()),
                           dirty_districts, cross_dirty, border_changed,
                           g_old.num_edges, g_new.num_edges,
                           part.num_districts)


def _canonical_pairs(g: Graph, u, v) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """Validate endpoint arrays against ``g`` and return (lo, hi, key)."""
    u = np.atleast_1d(np.asarray(u, dtype=np.int64))
    v = np.atleast_1d(np.asarray(v, dtype=np.int64))
    if u.shape != v.shape:
        raise ValueError("endpoint arrays must have the same length")
    n = g.num_vertices
    oob = (u < 0) | (u >= n) | (v < 0) | (v >= n)
    if oob.any():
        j = int(np.nonzero(oob)[0][0])
        raise ValueError(f"edge ({int(u[j])}, {int(v[j])}) is out of "
                         f"range for a graph with {n} vertices")
    loops = u == v
    if loops.any():
        j = int(np.nonzero(loops)[0][0])
        raise ValueError(f"({int(u[j])}, {int(v[j])}) is a self-loop")
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    return lo, hi, lo * n + hi


def _reject_repeats(want: np.ndarray, n: int) -> None:
    su = np.sort(want)
    rep = su[1:] == su[:-1]
    if rep.any():
        k = int(su[1:][rep][0])
        raise ValueError(f"edge ({k // n}, {k % n}) listed more than once")


def close_edges(g: Graph, u, v) -> Graph:
    """Remove the undirected edges (u_i, v_i) from ``g``.

    Closures are genuine CSR removals — degrees drop and a border
    vertex whose last cross arc closes is demoted — not ``w = +inf``
    markers.  Raises ``ValueError`` naming the first offending pair if
    any edge is absent (or listed twice)."""
    lo, hi, want = _canonical_pairs(g, u, v)
    _reject_repeats(want, g.num_vertices)
    eu, ev, ew = g.edge_list()
    keys = eu.astype(np.int64) * g.num_vertices + ev.astype(np.int64)
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    pos = np.searchsorted(skeys, want)
    missing = (pos >= len(skeys)) | (skeys[np.minimum(pos, len(skeys) - 1)]
                                     != want)
    if missing.any():
        j = int(np.nonzero(missing)[0][0])
        raise ValueError(f"cannot close ({int(lo[j])}, {int(hi[j])}): "
                         "no such edge in the graph")
    keep = np.ones(len(keys), dtype=bool)
    keep[order[pos]] = False
    return from_edges(g.num_vertices, eu[keep], ev[keep], ew[keep])


def open_edges(g: Graph, u, v, w) -> Graph:
    """Add the undirected edges (u_i, v_i) with weights ``w_i``.

    Raises ``ValueError`` naming the first offending pair if an edge
    already exists (re-weighting an open road is a weight delta, not a
    structural one) or repeats within the call."""
    lo, hi, want = _canonical_pairs(g, u, v)
    w = np.broadcast_to(np.asarray(w, dtype=np.float32), lo.shape).copy()
    if not np.isfinite(w).all() or (w <= 0).any():
        j = int(np.nonzero(~np.isfinite(w) | (w <= 0))[0][0])
        raise ValueError(f"edge ({int(lo[j])}, {int(hi[j])}) needs a "
                         f"finite positive weight, got {float(w[j])}")
    _reject_repeats(want, g.num_vertices)
    eu, ev, ew = g.edge_list()
    keys = eu.astype(np.int64) * g.num_vertices + ev.astype(np.int64)
    present = np.isin(want, keys)
    if present.any():
        j = int(np.nonzero(present)[0][0])
        raise ValueError(f"cannot open ({int(lo[j])}, {int(hi[j])}): "
                         "edge already exists (use a weight delta)")
    return from_edges(g.num_vertices,
                      np.concatenate([eu, lo.astype(np.int32)]),
                      np.concatenate([ev, hi.astype(np.int32)]),
                      np.concatenate([ew, w]))
