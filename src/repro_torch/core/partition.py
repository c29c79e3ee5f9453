"""District decomposition (Definition 3) and border extraction (Definition 4).

The paper assumes a partition of the road network into ``m`` mutually
exclusive districts and derives everything else from the induced border
vertex sets. Road networks are near-planar, so balanced multi-seed BFS
growing (a Lloyd/GRASP-style partitioner) produces compact districts with
small borders — the property the BL index size depends on. A light
Kernighan-Lin-flavored boundary refinement pass further shrinks the border
count.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import Graph


@dataclass(frozen=True)
class Partition:
    """``assignment[v]`` = district id in [0, m). Derived fields cached."""

    assignment: np.ndarray  # int32 (n,)
    num_districts: int

    def districts(self) -> list[np.ndarray]:
        order = np.argsort(self.assignment, kind="stable")
        splits = np.searchsorted(self.assignment[order],
                                 np.arange(1, self.num_districts))
        return [d.astype(np.int32) for d in np.split(order, splits)]


def border_mask(g: Graph, part: Partition) -> np.ndarray:
    """Definition 4: v is a border iff it has an edge leaving its district."""
    n = g.num_vertices
    src = g.arc_sources()
    cross = part.assignment[src] != part.assignment[g.indices]
    mask = np.zeros(n, dtype=bool)
    mask[src[cross]] = True
    return mask


def borders_of(g: Graph, part: Partition) -> list[np.ndarray]:
    """Border vertex set B_i per district, ids sorted ascending."""
    mask = border_mask(g, part)
    out = []
    for i in range(part.num_districts):
        sel = (part.assignment == np.int32(i)) & mask
        out.append(np.nonzero(sel)[0].astype(np.int32))
    return out


def bfs_grow_partition(g: Graph, num_districts: int, seed: int = 0,
                       refine_iters: int = 2) -> Partition:
    """Balanced multi-seed BFS growing.

    Seeds are spread with a farthest-point heuristic (BFS hops), then
    districts grow one frontier ring at a time, smallest district first,
    which keeps sizes within a small factor of n/m. Optionally runs a
    boundary-refinement pass that moves border vertices to the neighboring
    district when it strictly reduces cut degree without unbalancing.
    """
    n = g.num_vertices
    m = int(num_districts)
    if m <= 1 or n <= m:
        return Partition(np.zeros(n, dtype=np.int32), 1)
    rng = np.random.default_rng(seed)

    seeds = _farthest_point_seeds(g, m, rng)
    assignment = -np.ones(n, dtype=np.int32)
    frontiers: list[list[int]] = [[int(s)] for s in seeds]
    sizes = np.zeros(m, dtype=np.int64)
    for i, s in enumerate(seeds):
        assignment[s] = i
        sizes[i] = 1

    active = set(range(m))
    while active:
        # grow the currently smallest active district by one BFS ring
        i = min(active, key=lambda j: sizes[j])
        nxt: list[int] = []
        for v in frontiers[i]:
            nbrs, _ = g.neighbors(v)
            for u in nbrs:
                if assignment[u] < 0:
                    assignment[u] = i
                    sizes[i] += 1
                    nxt.append(int(u))
        frontiers[i] = nxt
        if not nxt:
            active.discard(i)

    # unreachable leftovers (disconnected graphs): give them district 0
    assignment[assignment < 0] = 0

    part = Partition(assignment, m)
    for _ in range(refine_iters):
        part = _refine_boundary(g, part)
    return part


def grid_partition(g: Graph, rows: int, cols: int, grid_rows: int,
                   grid_cols: int) -> Partition:
    """Geometric partition for grid networks (fast, deterministic):
    district = coarse cell of the underlying (rows x cols) lattice."""
    n = g.num_vertices
    assert n == rows * cols
    r = np.arange(n) // cols
    c = np.arange(n) % cols
    pr = np.minimum(r * grid_rows // rows, grid_rows - 1)
    pc = np.minimum(c * grid_cols // cols, grid_cols - 1)
    return Partition((pr * grid_cols + pc).astype(np.int32),
                     grid_rows * grid_cols)


def _farthest_point_seeds(g: Graph, m: int,
                          rng: np.random.Generator) -> np.ndarray:
    n = g.num_vertices
    seeds = [int(rng.integers(n))]
    hops = _bfs_hops(g, seeds[0])
    for _ in range(m - 1):
        cand = int(np.argmax(np.where(np.isfinite(hops), hops, -1.0)))
        if cand in seeds:  # disconnected remainder: random unseen vertex
            unseen = np.nonzero(~np.isfinite(hops))[0]
            cand = int(unseen[rng.integers(len(unseen))]) if len(unseen) \
                else int(rng.integers(n))
        seeds.append(cand)
        hops = np.minimum(hops, _bfs_hops(g, cand))
    return np.array(seeds, dtype=np.int32)


def _bfs_hops(g: Graph, source: int) -> np.ndarray:
    n = g.num_vertices
    hops = np.full(n, np.inf, dtype=np.float32)
    hops[source] = 0
    frontier = [source]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for v in frontier:
            nbrs, _ = g.neighbors(v)
            for u in nbrs:
                if hops[u] == np.inf:
                    hops[u] = d
                    nxt.append(int(u))
        frontier = nxt
    return hops


def _refine_boundary(g: Graph, part: Partition) -> Partition:
    """One KL-ish sweep: move a border vertex to its majority neighboring
    district if that strictly reduces its cross-edges and keeps balance
    within 1.25x of the mean district size."""
    n = g.num_vertices
    assignment = part.assignment.copy()
    m = part.num_districts
    sizes = np.bincount(assignment, minlength=m).astype(np.int64)
    cap = int(np.ceil(1.25 * n / m))
    from .partition import border_mask as _bm  # local alias
    border = np.nonzero(_bm(g, Partition(assignment, m)))[0]
    for v in border:
        nbrs, _ = g.neighbors(int(v))
        if len(nbrs) == 0:
            continue
        cur = assignment[v]
        counts = np.bincount(assignment[nbrs], minlength=m)
        best = int(np.argmax(counts))
        if best != cur and counts[best] > counts[cur] and \
                sizes[best] + 1 <= cap and sizes[cur] > 1:
            assignment[v] = best
            sizes[best] += 1
            sizes[cur] -= 1
    return Partition(assignment, m)
