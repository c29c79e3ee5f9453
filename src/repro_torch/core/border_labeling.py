"""Border Labeling — §3.1, Algorithm 1, Theorem 1.

Two builders that produce identical indexes:

* ``build_border_labels_reference`` — Algorithm 1 verbatim: a pruned
  Dijkstra from every border vertex, in global degree order. This is the
  fast CPU path (and the oracle the TPU path is validated against).
* ``build_border_labels_hierarchical`` — the TPU-native adaptation. The
  per-hub priority-queue search is replaced by three dense min-plus stages
  (per-district multi-source distances → border-overlay closure → one
  min-plus product per district) followed by a *rank-ordered vectorized
  prune* that provably keeps exactly the labels PLL-style pruning keeps:
  a label (b_k, u) survives iff the 2-hop estimate through
  earlier-ranked hubs exceeds d_G(b_k, u); if a pruned vertex v sits on the
  b_k→u shortest path then λ_{k-1}(b_k,u) ≤ λ_{k-1}(b_k,v) + d(v,u)
  ≤ d(b_k,u), so post-hoc pruning and traversal-stopping agree.

Every stage is a dense min-plus product — the shape `kernels/minplus`
implements with VMEM-tiled Pallas blocks on TPU. The numpy versions here
are the reference oracles for those kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import Graph, dijkstra
from .labels import BorderLabels
from .ordering import degree_order, rank_of
from .partition import Partition, borders_of
from .pll import pll

INF = np.float32(np.inf)


# ---------------------------------------------------------------------------
# Reference builder (Algorithm 1)
# ---------------------------------------------------------------------------

def build_border_labels_reference(g: Graph, part: Partition,
                                  order: np.ndarray | None = None
                                  ) -> BorderLabels:
    borders = np.sort(np.concatenate(
        [b for b in borders_of(g, part)] or
        [np.zeros(0, dtype=np.int32)])).astype(np.int32)
    if len(borders) == 0:
        # single district: every vertex interior; B is empty
        return BorderLabels(borders, np.full((g.num_vertices, 0), INF,
                                             dtype=np.float32))
    sparse = pll(g, order=order, roots=borders)
    slot = -np.ones(g.num_vertices, dtype=np.int64)
    slot[borders] = np.arange(len(borders))
    table = np.full((g.num_vertices, len(borders)), INF, dtype=np.float32)
    valid = sparse.hubs >= 0
    rows = np.repeat(np.arange(g.num_vertices), valid.sum(axis=1))
    cols = slot[sparse.hubs[valid]]
    table[rows, cols] = sparse.dists[valid]
    return BorderLabels(borders, table)


# ---------------------------------------------------------------------------
# Hierarchical dense builder (TPU adaptation)
# ---------------------------------------------------------------------------

@dataclass
class DistrictDistances:
    """Stage A output for one district."""
    vertices: np.ndarray        # (k,) int32 global ids
    border_locals: np.ndarray   # (b,) int64 positions of borders in vertices
    dist: np.ndarray            # (b, k) float32  d_{D_i}(border, v)


def minplus(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Dense (m,k)x(k,n) min-plus product — numpy oracle for the kernel."""
    out = np.full((a.shape[0], b.shape[1]), INF, dtype=np.float32)
    # loop over the contraction dim keeps memory O(mn) instead of O(mkn)
    for k in range(a.shape[1]):
        np.minimum(out, a[:, k:k + 1] + b[k:k + 1, :], out=out)
    return out


def minplus_closure(w: np.ndarray, max_iters: int | None = None) -> np.ndarray:
    """All-pairs closure by repeated min-plus squaring (log-diameter)."""
    d = w.astype(np.float32).copy()
    np.fill_diagonal(d, 0.0)
    iters = max_iters or max(1, int(np.ceil(np.log2(max(2, d.shape[0])))))
    for _ in range(iters):
        nd = minplus(d, d)
        if np.array_equal(
                np.nan_to_num(nd, posinf=3.4e38),
                np.nan_to_num(d, posinf=3.4e38)):
            break
        d = nd
    return d


def intra_district_distances(g: Graph, part: Partition
                             ) -> list[DistrictDistances]:
    """Stage A: d_{D_i}(b, v) for every district, borders as sources.

    CPU path runs restricted Dijkstras; the TPU path runs the same
    computation as blocked multi-source relaxation (kernels/sssp_relax).
    """
    from .graph import from_edges

    out = []
    blists = borders_of(g, part)
    for did, vertices in enumerate(part.districts()):
        k = len(vertices)
        if k == 0:
            out.append(DistrictDistances(vertices.astype(np.int32),
                                         np.zeros(0, dtype=np.int64),
                                         np.zeros((0, 0), dtype=np.float32)))
            continue
        borders = blists[did]
        pos = -np.ones(g.num_vertices, dtype=np.int64)
        pos[vertices] = np.arange(k)
        us, vs, ws = [], [], []
        for local, vglob in enumerate(vertices):
            nbrs, w = g.neighbors(int(vglob))
            sel = pos[nbrs] >= 0
            for u, wu in zip(pos[nbrs[sel]], w[sel]):
                if local < u:
                    us.append(local); vs.append(int(u)); ws.append(float(wu))
        sub = from_edges(k, np.array(us, dtype=np.int32),
                         np.array(vs, dtype=np.int32),
                         np.array(ws, dtype=np.float32))
        bl = pos[borders]
        dist = np.stack([dijkstra(sub, int(b)) for b in bl]) if len(bl) \
            else np.zeros((0, k), dtype=np.float32)
        out.append(DistrictDistances(vertices.astype(np.int32),
                                     bl.astype(np.int64),
                                     dist.astype(np.float32)))
    return out


def overlay_matrix(g: Graph, part: Partition,
                   intra: list[DistrictDistances],
                   border_ids: np.ndarray) -> np.ndarray:
    """Stage B input: border overlay graph as a dense (q,q) weight matrix —
    intra-district border-to-border distances + original cross edges."""
    q = len(border_ids)
    slot = -np.ones(g.num_vertices, dtype=np.int64)
    slot[border_ids] = np.arange(q)
    w = np.full((q, q), INF, dtype=np.float32)
    np.fill_diagonal(w, 0.0)
    for dd in intra:
        if len(dd.border_locals) == 0:
            continue
        bslots = slot[dd.vertices[dd.border_locals]]
        block = dd.dist[:, dd.border_locals]        # (b, b)
        w[np.ix_(bslots, bslots)] = np.minimum(w[np.ix_(bslots, bslots)],
                                               block)
    # original cross-district edges (both endpoints are borders by Def. 4)
    src = g.arc_sources()
    cross = part.assignment[src] != part.assignment[g.indices]
    su, sv = slot[src[cross]], slot[g.indices[cross]]
    ww = g.weights[cross]
    np.minimum.at(w, (su, sv), ww)
    return w


def full_table(intra: list[DistrictDistances], closure: np.ndarray,
               border_ids: np.ndarray, n: int) -> np.ndarray:
    """Stage C: B'(v, b) = min_{b'∈B_j} d_{D_j}(b', v) + d_G(b', b)."""
    q = len(border_ids)
    slot = -np.ones(n, dtype=np.int64)
    slot[border_ids] = np.arange(q)
    table = np.full((n, q), INF, dtype=np.float32)
    for dd in intra:
        if len(dd.border_locals) == 0:
            continue  # isolated district (m=1): no borders anywhere
        bslots = slot[dd.vertices[dd.border_locals]]
        # (k, b) x (b, q) min-plus
        table[dd.vertices] = minplus(dd.dist.T.copy(), closure[bslots])
    return table


def prune_table(table: np.ndarray, border_ids: np.ndarray,
                rank: np.ndarray) -> np.ndarray:
    """Stage D: rank-ordered vectorized prune (== PLL pruning, see module
    docstring). Processes hub slots from highest priority (rank 0) down,
    masking entries whose 2-hop estimate via earlier kept hubs is <= d."""
    n, q = table.shape
    out = np.full_like(table, INF)
    order = np.argsort(rank[border_ids], kind="stable")
    for j in order:
        b = int(border_ids[j])
        # λ_{k-1}(b_j, v) over kept labels: min_h out[v,h] + out[b_j,h]
        wrow = out[b]                       # (q,) earlier kept hubs only
        finite = np.isfinite(wrow)
        if finite.any():
            lam = np.min(out[:, finite] + wrow[finite][None, :], axis=1)
        else:
            lam = np.full(n, INF, dtype=np.float32)
        keep = table[:, j] < lam            # prune iff λ <= d
        keep &= np.isfinite(table[:, j])
        keep[b] = np.isfinite(table[b, j])  # root always keeps its 0 label
        out[keep, j] = table[keep, j]
    return out


def build_border_labels_hierarchical(g: Graph, part: Partition,
                                     prune: bool = True,
                                     order: np.ndarray | None = None
                                     ) -> BorderLabels:
    blists = borders_of(g, part)
    border_ids = np.sort(np.concatenate(
        blists or [np.zeros(0, dtype=np.int32)])).astype(np.int32)
    n = g.num_vertices
    if len(border_ids) == 0:
        return BorderLabels(border_ids, np.full((n, 0), INF, np.float32))
    intra = intra_district_distances(g, part)
    w = overlay_matrix(g, part, intra, border_ids)
    closure = minplus_closure(w)
    table = full_table(intra, closure, border_ids, n)
    if prune:
        push_order = order if order is not None \
            else degree_order(g, subset=border_ids)
        table = prune_table(table, border_ids, rank_of(push_order, n))
    return BorderLabels(border_ids, table)
