"""The benchmark's road networks, made from the seed (frozen).

A copy of the arithmetic of ``repro_torch.ingest.synth.synthetic_continent``
and of ``ingest.csr.CSRBuilder.finalize``, kept here so that a later change
to the program cannot change the graphs the benchmark measures on. A
``gx × gy`` mosaic of ``r × c`` grid districts: full grid meshes inside a
district, ``border_links`` random crossings per shared district boundary,
integer weights drawn uniformly from ``{1..weight_high}``. The same
``(shape, seed)`` gives the same CSR and the same district assignment.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass(frozen=True)
class RoadNetwork:
    """An undirected road network in CSR form (both arc directions) and
    its district assignment."""
    indptr: np.ndarray          # int32 (n + 1,)
    indices: np.ndarray         # int32 (2m,)
    weights: np.ndarray         # float32 (2m,), integer values
    assignment: np.ndarray      # int32 (n,)
    num_districts: int

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_arcs(self) -> int:
        return int(self.indices.shape[0])

    def arc_sources(self) -> np.ndarray:
        return np.repeat(np.arange(self.num_vertices, dtype=np.int32),
                         np.diff(self.indptr))

    def border_vertices(self) -> np.ndarray:
        """Every vertex with an arc that leaves its district, ascending.
        Every path between two districts passes through one."""
        src = self.arc_sources()
        cross = self.assignment[src] != self.assignment[self.indices]
        return np.unique(src[cross]).astype(np.int64)

    def district_members(self) -> tuple[np.ndarray, np.ndarray]:
        """``(order, start)``: the vertices sorted by district, and where
        each district's run starts in ``order`` (``start[m] = n``)."""
        order = np.argsort(self.assignment, kind="stable").astype(np.int64)
        start = np.searchsorted(self.assignment[order],
                                np.arange(self.num_districts + 1))
        return order, start.astype(np.int64)


def continent(grid: tuple[int, int], district: tuple[int, int], *,
              border_links: int, seed: int,
              weight_high: int = 15) -> RoadNetwork:
    """The synthetic continent of ``grid = (gx, gy)`` districts of
    ``district = (r, c)`` vertices each; ``n = gx·c · gy·r``."""
    gx, gy = int(grid[0]), int(grid[1])
    r, c = int(district[0]), int(district[1])
    if gx < 1 or gy < 1 or r < 2 or c < 2 or border_links < 1:
        raise ValueError(f"bad continent shape {grid} × {district}, "
                         f"border_links {border_links}")
    H, W = gy * r, gx * c
    n = H * W
    rng = np.random.default_rng(seed)
    us: list[np.ndarray] = []
    vs: list[np.ndarray] = []
    ws: list[np.ndarray] = []

    def emit(u: np.ndarray, v: np.ndarray) -> None:
        us.append(u)
        vs.append(v)
        ws.append(rng.integers(1, weight_high + 1, size=len(u))
                  .astype(np.float64))

    rows = np.arange(H, dtype=np.int64)
    cols = np.arange(W - 1, dtype=np.int64)
    cols = cols[(cols + 1) % c != 0]
    u = (rows[:, None] * W + cols[None, :]).ravel()
    emit(u, u + 1)
    rows = np.arange(H - 1, dtype=np.int64)
    rows = rows[(rows + 1) % r != 0]
    cols = np.arange(W, dtype=np.int64)
    u = (rows[:, None] * W + cols[None, :]).ravel()
    emit(u, u + W)

    k = min(border_links, r, c)
    bu: list[np.ndarray] = []
    bv: list[np.ndarray] = []
    for bx in range(1, gx):
        col = bx * c - 1
        for jy in range(gy):
            pick = rng.choice(r, size=k, replace=False) + jy * r
            uu = pick.astype(np.int64) * W + col
            bu.append(uu)
            bv.append(uu + 1)
    for by in range(1, gy):
        row = by * r - 1
        for jx in range(gx):
            pick = rng.choice(c, size=k, replace=False) + jx * c
            uu = row * W + pick.astype(np.int64)
            bu.append(uu)
            bv.append(uu + W)
    if bu:
        emit(np.concatenate(bu), np.concatenate(bv))

    indptr, indices, weights = _csr(n, np.concatenate(us),
                                    np.concatenate(vs), np.concatenate(ws))
    drow = np.arange(H, dtype=np.int64) // r
    dcol = np.arange(W, dtype=np.int64) // c
    assignment = (drow[:, None] * gx + dcol[None, :]).ravel() \
        .astype(np.int32)
    return RoadNetwork(indptr, indices, weights, assignment, gx * gy)


def _csr(n: int, u: np.ndarray, v: np.ndarray, w: np.ndarray):
    """Undirected CSR of the arcs: parallel arcs collapse to the least
    weight, both directions are kept, rows sorted by source."""
    w = w.astype(np.float32)
    keep = u != v
    u, v, w = u[keep], v[keep], w[keep]
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
    eu = lo[first].astype(np.int32)
    ev = hi[first].astype(np.int32)
    src = np.concatenate([eu, ev])
    dst = np.concatenate([ev, eu])
    ww = np.concatenate([wmin, wmin])
    order = np.argsort(src, kind="stable")
    src, dst, ww = src[order], dst[order], ww[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr.astype(np.int32), dst, ww


def write_gr(net: RoadNetwork, path: Path, comment: str) -> int:
    """The network as a gzip DIMACS challenge-9 ``.gr`` file: 1-based
    ids, both arc directions, integer weights. Returns the arc count."""
    src = net.arc_sources().astype(np.int64) + 1
    dst = net.indices.astype(np.int64) + 1
    w = net.weights.astype(np.int64)
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write(f"c {comment}\np sp {net.num_vertices} {len(src)}\n")
        lines = map("a {} {} {}\n".format, src.tolist(), dst.tolist(),
                    w.tolist())
        f.writelines(lines)
    return int(len(src))
