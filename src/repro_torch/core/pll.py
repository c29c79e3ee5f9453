"""Pruned Landmark Labeling (Akiba et al. [1]) — §2.1 of the paper.

``pll`` runs one pruned Dijkstra per vertex in pushing order O, using the
standard dense scatter trick for O(1)-amortized prune queries. It is both
the paper's principal baseline (full hub labeling) and the builder used for
per-district local indexes L_i / L_i⁺.

The hub set can be restricted (``roots=``), which is exactly Border
Labeling's Algorithm 1 — see border_labeling.py.
"""
from __future__ import annotations

import heapq

import numpy as np

from .graph import Graph
from .labels import SparseLabels, pack_sparse
from .ordering import degree_order

INF = np.float32(np.inf)


def pll(g: Graph, order: np.ndarray | None = None,
        roots: np.ndarray | None = None) -> SparseLabels:
    """Build a pruned 2-hop labeling.

    Args:
      g: graph.
      order: full pushing order O (defaults to degree order over ``roots``).
      roots: if given, only these vertices act as hubs (Border Labeling);
        otherwise every vertex is a potential hub (classic PLL).
    """
    n = g.num_vertices
    if order is None:
        order = degree_order(g, subset=roots)
    elif roots is not None:
        keep = np.zeros(n, dtype=bool)
        keep[np.asarray(roots, dtype=np.int64)] = True
        order = order[keep[order]]

    labels: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    # scatter buffer: T[h] = dist(root, h) for h in L(root), else inf
    T = np.full(n, INF, dtype=np.float32)
    dist = np.full(n, INF, dtype=np.float32)

    for root in order:
        root = int(root)
        for h, d in labels[root]:
            T[h] = d
        T[root] = 0.0

        dist[:] = INF
        dist[root] = 0.0
        pq: list[tuple[float, int]] = [(0.0, root)]
        visited: list[int] = []
        while pq:
            d, v = heapq.heappop(pq)
            if d > dist[v]:
                continue
            visited.append(v)
            # prune test: λ(root, v, current labels) <= d ?
            lam = INF
            for h, dh in labels[v]:
                th = T[h]
                if th < INF:
                    s = th + dh
                    if s < lam:
                        lam = s
            if v != root and lam <= d:
                continue  # pruned: no label, no expansion
            labels[v].append((root, float(d)))
            nbrs, w = g.neighbors(v)
            nd = d + w
            for u, du in zip(nbrs, nd):
                if du < dist[u]:  # re-check live value (parallel-edge safe)
                    dist[u] = du
                    heapq.heappush(pq, (float(du), int(u)))

        for h, _ in labels[root][:-1]:
            T[h] = INF
        T[root] = INF

    return pack_sparse(labels)


def pll_subgraph(g: Graph, vertices: np.ndarray,
                 extra_edges: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
                 order: np.ndarray | None = None
                 ) -> tuple[SparseLabels, np.ndarray]:
    """PLL over an induced subgraph (plus optional shortcut edges), with
    labels in *local* vertex indexing. Returns (labels, vertices) where
    ``vertices[local] = global id``. Used for district indexes."""
    from .graph import from_edges

    vertices = np.asarray(vertices, dtype=np.int32)
    k = len(vertices)
    pos = -np.ones(g.num_vertices, dtype=np.int64)
    pos[vertices] = np.arange(k)

    us, vs, ws = [], [], []
    for local, vglob in enumerate(vertices):
        nbrs, w = g.neighbors(int(vglob))
        sel = pos[nbrs] >= 0
        for u, wu in zip(pos[nbrs[sel]], w[sel]):
            if local < u:  # each undirected edge once
                us.append(local); vs.append(int(u)); ws.append(float(wu))
    if extra_edges is not None:
        eu, ev, ew = extra_edges
        us.extend(int(x) for x in eu)
        vs.extend(int(x) for x in ev)
        ws.extend(float(x) for x in ew)
    sub = from_edges(k, np.array(us, dtype=np.int32),
                     np.array(vs, dtype=np.int32),
                     np.array(ws, dtype=np.float32))
    return pll(sub, order=order), vertices
