"""Traffic-scenario generators: realistic weight deltas for the
simulator, the update benchmarks, and the parity tests.

Every generator maps ``(g, part, rng, intensity)`` to a fresh CSR-aligned
weight array for ``Graph.with_weights`` — symmetric by construction
(factors are drawn per *undirected* edge and broadcast to both CSR
arcs).  ``intensity`` is approximately the dirty fraction of the
undirected edge set, so benchmarks can sweep delta size uniformly across
scenarios:

* ``rush_hour`` — a contiguous corridor (the edges around a shortest
  route between two random endpoints) slows down by 1.5–3×;
* ``incident``  — a handful of scattered edges slow down ×10 (a crash /
  road closure without the closure);
* ``regional``  — whole districts slow down together (weather, an
  event), including their cross edges;
* ``jitter``    — uniformly scattered small perturbations (sensor noise
  / background drift), the least spatially-coherent delta.

The four stress different repair scopes: incident and rush_hour dirty
few districts (stage A mostly skipped), regional dirties whole
districts plus the overlay, jitter touches everything a little.

Host NumPy, a copy of ``repro.update.scenarios``: the same seed gives
the same weights in both packages.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import Graph
from ..core.partition import Partition


def _unique_edges(g: Graph) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """(u, v, arc_to_edge, num_edges): one row per undirected edge plus
    the CSR-arc → edge map that broadcasts per-edge factors to both
    arcs."""
    key = g._arc_keys()
    uniq, first, inv = np.unique(key, return_index=True,
                                 return_inverse=True)
    return g.arc_sources()[first], g.indices[first], inv, len(uniq)


def _scale_edges(g: Graph, edge_mask: np.ndarray, factors: np.ndarray,
                 inv: np.ndarray, num: int) -> np.ndarray:
    f = np.ones(num, dtype=np.float32)
    f[edge_mask] = factors
    return (g.weights * f[inv]).astype(np.float32)


def _edge_count(intensity: float, num: int) -> int:
    return max(1, min(num, int(round(intensity * num))))


def uniform_jitter(g: Graph, part: Partition, rng: np.random.Generator,
                   intensity: float = 1.0, lo: float = 0.9,
                   hi: float = 1.1) -> np.ndarray:
    """Scattered background drift: an ``intensity`` share of edges scaled
    by U[lo, hi)."""
    _, _, inv, num = _unique_edges(g)
    k = _edge_count(intensity, num)
    mask = np.zeros(num, dtype=bool)
    mask[rng.choice(num, size=k, replace=False)] = True
    return _scale_edges(g, mask, rng.uniform(lo, hi, size=k)
                        .astype(np.float32), inv, num)


def incident(g: Graph, part: Partition, rng: np.random.Generator,
             intensity: float = 0.005, factor: float = 10.0) -> np.ndarray:
    """A few edges around one location slow down hard (×``factor``):
    BFS rings grow from a random site until the ball holds the target
    edge count — an incident is spatially coherent, unlike ``jitter``."""
    u, v, inv, num = _unique_edges(g)
    k = _edge_count(intensity, num)
    n = g.num_vertices
    ball = np.zeros(n, dtype=bool)
    ball[rng.integers(0, n)] = True
    mask = ball[u] & ball[v]
    while mask.sum() < k:
        ring = np.zeros(n, dtype=bool)
        for x in np.nonzero(ball)[0]:
            nbrs, _ = g.neighbors(int(x))
            ring[nbrs] = True
        if not (ring & ~ball).any():
            break               # component saturated (disconnected graph)
        ball |= ring
        mask = ball[u] & ball[v]
    # trim the surplus so the dirty count matches the target exactly
    sel = np.nonzero(mask)[0]
    k = min(k, len(sel))
    mask = np.zeros(num, dtype=bool)
    mask[sel[:k]] = True
    return _scale_edges(g, mask, np.full(k, factor, dtype=np.float32),
                        inv, num)


def regional_slowdown(g: Graph, part: Partition,
                      rng: np.random.Generator, intensity: float = 0.15,
                      lo: float = 1.4, hi: float = 1.8) -> np.ndarray:
    """Whole districts slow down together: districts are added (in random
    order) until the edges touching the region reach ``intensity`` of the
    edge set; every touched edge — cross edges included — is scaled."""
    u, v, inv, num = _unique_edges(g)
    region = np.zeros(part.num_districts, dtype=bool)
    mask = np.zeros(num, dtype=bool)
    for d in rng.permutation(part.num_districts):
        region[d] = True
        mask = region[part.assignment[u]] | region[part.assignment[v]]
        if mask.sum() >= intensity * num:
            break
    k = int(mask.sum())
    return _scale_edges(g, mask, rng.uniform(lo, hi, size=k)
                        .astype(np.float32), inv, num)


def rush_hour_corridor(g: Graph, part: Partition,
                       rng: np.random.Generator, intensity: float = 0.05,
                       lo: float = 1.5, hi: float = 3.0) -> np.ndarray:
    """Congestion along a route: the hop-shortest path between two random
    endpoints, dilated ring by ring until the corridor holds an
    ``intensity`` share of the edges, all slowed by U[lo, hi)."""
    u, v, inv, num = _unique_edges(g)
    n = g.num_vertices
    s, t = rng.integers(0, n, size=2)
    # BFS parents from s; walk back from t for the corridor spine
    parent = np.full(n, -1, dtype=np.int64)
    parent[s] = s
    frontier = [int(s)]
    while frontier:
        nxt = []
        for x in frontier:
            nbrs, _ = g.neighbors(x)
            for y in nbrs:
                if parent[y] < 0:
                    parent[y] = x
                    nxt.append(int(y))
        frontier = nxt
    ball = np.zeros(n, dtype=bool)
    x = int(t) if parent[t] >= 0 else int(s)
    while True:
        ball[x] = True
        if x == int(s):
            break
        x = int(parent[x])
    mask = np.zeros(num, dtype=bool)
    while True:
        mask = ball[u] & ball[v]
        if mask.sum() >= intensity * num:
            break
        ring = np.zeros(n, dtype=bool)  # dilate one hop
        for x in np.nonzero(ball)[0]:
            nbrs, _ = g.neighbors(int(x))
            ring[nbrs] = True
        if not (ring & ~ball).any():
            break               # component saturated (disconnected graph)
        ball |= ring
    k = int(mask.sum())
    return _scale_edges(g, mask, rng.uniform(lo, hi, size=k)
                        .astype(np.float32), inv, num)


SCENARIOS = {
    "rush_hour": rush_hour_corridor,
    "incident": incident,
    "regional": regional_slowdown,
    "jitter": uniform_jitter,
}


def scenario_weights(name: str, g: Graph, part: Partition,
                     rng: np.random.Generator, intensity: float,
                     **params) -> np.ndarray:
    """Dispatch one scenario by name (see ``SCENARIOS``)."""
    return SCENARIOS[name](g, part, rng, intensity=intensity, **params)
