"""Road-network graph substrate.

Graphs are undirected weighted road networks stored in CSR form (numpy),
which is the layout every builder (numpy oracles, vectorized JAX builders,
Pallas kernels) consumes. Distances are float32; ``INF`` marks
unreachability. Vertex ids are dense ``int32`` in ``[0, n)``.

Includes synthetic generators that mimic road-network structure (sparse,
near-planar, low-degree) so the paper's experiments (Table 2 / Fig. 5
scale sweeps) can run offline, plus a DIMACS ``.gr`` parser for the real
challenge-9 datasets when present.

Host NumPy, a copy of ``repro.core.graph`` kept in this package so the
PyTorch port imports nothing of the JAX package.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Iterable

import numpy as np

INF = np.float32(np.inf)


@dataclass(frozen=True)
class Graph:
    """Undirected weighted graph in CSR form.

    ``indptr`` has length ``n+1``; ``indices[indptr[v]:indptr[v+1]]`` are the
    neighbors of ``v`` and ``weights[...]`` the corresponding edge weights.
    Both directions of every undirected edge are materialized.
    """

    indptr: np.ndarray   # int64 (n+1,)
    indices: np.ndarray  # int32 (2m,)
    weights: np.ndarray  # float32 (2m,)

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        """Number of undirected edges."""
        return int(self.indices.shape[0] // 2)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def neighbors(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[v], self.indptr[v + 1]
        return self.indices[lo:hi], self.weights[lo:hi]

    def arc_sources(self) -> np.ndarray:
        """Source vertex of every CSR arc (int32, parallel to
        ``indices``/``weights``) — the expansion every vectorized pass
        over the arcs starts from."""
        return np.repeat(np.arange(self.num_vertices, dtype=np.int32),
                         np.diff(self.indptr))

    def edge_list(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (u, v, w) with u < v, one row per undirected edge."""
        src = self.arc_sources()
        mask = src < self.indices
        return src[mask], self.indices[mask], self.weights[mask]

    def with_weights(self, new_weights: np.ndarray,
                     validate: bool = True) -> "Graph":
        """Same topology, new (CSR-aligned) weights — dynamic updates.

        Distances are undirected, so both CSR arcs of an edge must carry
        the same weight; ``validate`` asserts that (use
        ``perturb_weights`` to generate symmetric updates).
        """
        new_weights = np.asarray(new_weights, dtype=np.float32)
        if new_weights.shape != self.weights.shape:
            raise ValueError("weight array shape mismatch")
        if validate:
            key = self._arc_keys()
            order = np.argsort(key, kind="stable")
            w = new_weights[order]
            if not np.allclose(w[0::2], w[1::2]):
                raise ValueError("asymmetric weight update on an "
                                 "undirected road network")
        return Graph(self.indptr, self.indices, new_weights)

    def _arc_keys(self) -> np.ndarray:
        """Canonical undirected key per CSR arc (both arcs share a key)."""
        n = self.num_vertices
        src = self.arc_sources().astype(np.int64)
        dst = self.indices.astype(np.int64)
        return np.minimum(src, dst) * n + np.maximum(src, dst)

    def dense_adjacency(self, vertices: np.ndarray | None = None) -> np.ndarray:
        """Dense (k,k) min-plus adjacency of an induced subgraph.

        Diagonal is 0; absent edges are INF. Used by the blocked
        Bellman-Ford builders and the min-plus kernels.
        """
        if vertices is None:
            vertices = np.arange(self.num_vertices, dtype=np.int32)
        k = len(vertices)
        pos = -np.ones(self.num_vertices, dtype=np.int64)
        pos[vertices] = np.arange(k)
        adj = np.full((k, k), INF, dtype=np.float32)
        np.fill_diagonal(adj, 0.0)
        for local, v in enumerate(vertices):
            nbrs, w = self.neighbors(int(v))
            sel = pos[nbrs] >= 0
            tgt = pos[nbrs[sel]]
            np.minimum.at(adj[local], tgt, w[sel])
        return adj


def from_edges(n: int, u: np.ndarray, v: np.ndarray, w: np.ndarray) -> Graph:
    """Build an undirected CSR graph from an edge list (parallel edges are
    kept; oracles take the min implicitly through relaxation)."""
    u = np.asarray(u, dtype=np.int32)
    v = np.asarray(v, dtype=np.int32)
    w = np.asarray(w, dtype=np.float32)
    if np.any(u == v):
        keep = u != v  # drop self loops, they never help shortest paths
        u, v, w = u[keep], v[keep], w[keep]
    # dedupe parallel edges keeping the minimum weight (canonical u<v key)
    if len(u):
        lo = np.minimum(u, v).astype(np.int64)
        hi = np.maximum(u, v).astype(np.int64)
        key = lo * n + hi
        order = np.argsort(key, kind="stable")
        key, lo, hi, w = key[order], lo[order], hi[order], w[order]
        first = np.ones(len(key), dtype=bool)
        first[1:] = key[1:] != key[:-1]
        group = np.cumsum(first) - 1
        wmin = np.full(int(group[-1]) + 1, np.inf, dtype=np.float32)
        np.minimum.at(wmin, group, w)
        u, v, w = lo[first].astype(np.int32), hi[first].astype(np.int32), \
            wmin.astype(np.float32)

    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    ww = np.concatenate([w, w])
    order = np.argsort(src, kind="stable")
    src, dst, ww = src[order], dst[order], ww[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(indptr, dst.astype(np.int32), ww.astype(np.float32))


# ---------------------------------------------------------------------------
# Synthetic road networks
# ---------------------------------------------------------------------------

def grid_road_network(rows: int, cols: int, seed: int = 0,
                      drop_frac: float = 0.05,
                      highway_frac: float = 0.01) -> Graph:
    """Grid-like road network: 4-connected grid with random weights, a small
    fraction of edges dropped (dead ends / rivers) and a few long 'highway'
    shortcuts. Always returns a connected graph (a spanning tree of the grid
    is protected from dropping)."""
    rng = np.random.default_rng(seed)
    n = rows * cols

    def vid(r, c):
        return r * cols + c

    us, vs = [], []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                us.append(vid(r, c)); vs.append(vid(r, c + 1))
            if r + 1 < rows:
                us.append(vid(r, c)); vs.append(vid(r + 1, c))
    us = np.array(us, dtype=np.int32)
    vs = np.array(vs, dtype=np.int32)
    w = rng.uniform(1.0, 10.0, size=len(us)).astype(np.float32)

    # protect a random spanning tree so connectivity survives drops
    protected = _spanning_tree_mask(n, us, vs, rng)
    drop = (rng.random(len(us)) < drop_frac) & ~protected
    us, vs, w = us[~drop], vs[~drop], w[~drop]

    n_hw = max(0, int(highway_frac * len(us)))
    if n_hw:
        hu = rng.integers(0, n, size=n_hw).astype(np.int32)
        hv = rng.integers(0, n, size=n_hw).astype(np.int32)
        ok = hu != hv
        hu, hv = hu[ok], hv[ok]
        # highways are fast relative to euclidean grid distance
        rr = np.abs(hu // cols - hv // cols) + np.abs(hu % cols - hv % cols)
        hw = (rr * rng.uniform(0.5, 0.9, size=len(hu))).astype(np.float32)
        us = np.concatenate([us, hu])
        vs = np.concatenate([vs, hv])
        w = np.concatenate([w, np.maximum(hw, 1.0)])
    return from_edges(n, us, vs, w)


def random_geometric_network(n: int, avg_degree: float = 3.0,
                             seed: int = 0) -> Graph:
    """Near-planar random network: points in the unit square, each connected
    to its k nearest neighbors (grid-bucketed), euclidean weights. Connected
    via a chain over a space-filling ordering."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2)).astype(np.float32)
    k = max(2, int(round(avg_degree)))
    # bucket into a sqrt(n) grid and connect within 3x3 neighborhoods
    g = max(1, int(np.sqrt(n / 4)))
    cell = np.minimum((pts * g).astype(np.int64), g - 1)
    cell_id = cell[:, 0] * g + cell[:, 1]
    order = np.argsort(cell_id, kind="stable")
    us, vs, ws = [], [], []
    bucket_of: dict[int, list[int]] = {}
    for idx in order:
        bucket_of.setdefault(int(cell_id[idx]), []).append(int(idx))
    for idx in range(n):
        cx, cy = int(cell[idx, 0]), int(cell[idx, 1])
        cand: list[int] = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if 0 <= cx + dx < g and 0 <= cy + dy < g:
                    cand.extend(bucket_of.get((cx + dx) * g + cy + dy, ()))
        cand = [c for c in cand if c != idx]
        if not cand:
            continue
        cand = np.array(cand, dtype=np.int64)
        d = np.linalg.norm(pts[cand] - pts[idx], axis=1)
        nearest = cand[np.argsort(d)[:k]]
        for j, dd in zip(nearest, np.sort(d)[:k]):
            us.append(idx); vs.append(int(j)); ws.append(float(dd) + 1e-3)
    # connectivity chain along Hilbert-ish (cell-id) order
    so = np.argsort(cell_id, kind="stable")
    for a, b in zip(so[:-1], so[1:]):
        us.append(int(a)); vs.append(int(b))
        ws.append(float(np.linalg.norm(pts[a] - pts[b])) + 1e-3)
    return from_edges(n, np.array(us), np.array(vs),
                      np.array(ws, dtype=np.float32))


def _spanning_tree_mask(n: int, us: np.ndarray, vs: np.ndarray,
                        rng: np.random.Generator) -> np.ndarray:
    """Mark a subset of edges forming a spanning forest (union-find)."""
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = int(parent[x])
        return x

    mask = np.zeros(len(us), dtype=bool)
    order = rng.permutation(len(us))
    for e in order:
        ru, rv = find(int(us[e])), find(int(vs[e]))
        if ru != rv:
            parent[ru] = rv
            mask[e] = True
    return mask


def perturb_weights(g: Graph, rng: np.random.Generator,
                    lo: float = 0.5, hi: float = 2.0,
                    frac: float = 1.0) -> np.ndarray:
    """Symmetric random traffic update: scales a ``frac`` share of
    undirected edges by U[lo, hi), both CSR arcs consistently. Returns a
    CSR-aligned weight array for ``with_weights``."""
    key = g._arc_keys()
    uniq, inv = np.unique(key, return_inverse=True)
    factors = np.ones(len(uniq), dtype=np.float32)
    touched = rng.random(len(uniq)) < frac
    factors[touched] = rng.uniform(lo, hi, size=int(touched.sum())) \
        .astype(np.float32)
    return (g.weights * factors[inv]).astype(np.float32)


# ---------------------------------------------------------------------------
# Exact oracles (numpy/heapq) — ground truth for every test
# ---------------------------------------------------------------------------

def dijkstra(g: Graph, source: int,
             targets: np.ndarray | None = None) -> np.ndarray:
    """Single-source shortest distances. Returns float32 (n,)."""
    n = g.num_vertices
    dist = np.full(n, INF, dtype=np.float32)
    dist[source] = 0.0
    remaining = None if targets is None else set(int(t) for t in targets)
    pq: list[tuple[float, int]] = [(0.0, source)]
    while pq:
        d, v = heapq.heappop(pq)
        if d > dist[v]:
            continue
        if remaining is not None:
            remaining.discard(v)
            if not remaining:
                break
        nbrs, w = g.neighbors(v)
        nd = d + w
        for u, du in zip(nbrs, nd):
            if du < dist[u]:  # re-check live value (parallel-edge safe)
                dist[u] = du
                heapq.heappush(pq, (float(du), int(u)))
    return dist


def bidirectional_dijkstra(g: Graph, s: int, t: int) -> float:
    """Point-to-point bidirectional Dijkstra — the paper's 'online search'
    baseline family ([7,17,19])."""
    if s == t:
        return 0.0
    n = g.num_vertices
    dist = [np.full(n, INF, dtype=np.float32) for _ in range(2)]
    dist[0][s] = 0.0
    dist[1][t] = 0.0
    pq = [[(0.0, s)], [(0.0, t)]]
    settled = [np.zeros(n, dtype=bool), np.zeros(n, dtype=bool)]
    best = float(INF)
    side = 0
    while pq[0] and pq[1]:
        side = 0 if pq[0][0][0] <= pq[1][0][0] else 1
        d, v = heapq.heappop(pq[side])
        if d > dist[side][v]:
            continue
        settled[side][v] = True
        if settled[1 - side][v]:
            best = min(best, float(dist[0][v] + dist[1][v]))
        if d >= best:
            break
        nbrs, w = g.neighbors(v)
        nd = d + w
        for u, du in zip(nbrs, nd):
            if du < dist[side][u]:
                dist[side][u] = du
                heapq.heappush(pq[side], (float(du), int(u)))
                other = dist[1 - side][u]
                if other < INF:
                    best = min(best, float(du + other))
    return best


def all_pairs_dijkstra(g: Graph, sources: Iterable[int]) -> np.ndarray:
    """Stack of Dijkstra rows — small-graph ground truth."""
    return np.stack([dijkstra(g, int(s)) for s in sources])


def is_connected(g: Graph) -> bool:
    n = g.num_vertices
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        v = stack.pop()
        nbrs, _ = g.neighbors(v)
        for u in nbrs:
            if not seen[u]:
                seen[u] = True
                stack.append(int(u))
    return bool(seen.all())


def load_dimacs_gr(path: str) -> Graph:
    """Parse a DIMACS challenge-9 ``.gr`` file (``a u v w`` arcs,
    1-based).  Delegates to the streaming ``repro_torch.ingest.dimacs``
    reader — the one parser in the port — which tolerates ``c``/``p``
    lines anywhere, collapses duplicate arcs to the min weight, and
    raises ``DimacsFormatError`` (with the line number) on 0-based or
    out-of-range vertex ids."""
    from ..ingest.dimacs import load_gr_graph   # deferred: ingest
    return load_gr_graph(path)                  # imports core.graph
