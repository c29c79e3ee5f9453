"""Deterministic "synthetic continent" generator.

CI cannot download DIMACS extracts, but the benchmarks must stop
running on toy grids.  ``synthetic_continent`` composes a ``gx × gy``
mosaic of ``r × c`` grid districts into one 10⁵–10⁶-vertex road-shaped
graph: district interiors are full grid meshes (dense local streets),
while adjacent districts are joined by only ``border_links`` randomly
placed crossing edges per shared boundary (sparse highways).  That
reproduces the property the paper's partition-based oracle exploits —
small border sets per district — so the natural district partition has
q ≪ n and index build stays feasible at 10⁵ vertices.

Weights are integer "seconds" drawn uniformly from ``{1..weight_high}``
(townscout-style), so every shortest-path distance is integral and the
uint16 ``QuantSpec`` round-trips losslessly.  Everything is generated
vectorized from one seed and fed through ``CSRBuilder`` in chunks; the
same ``(seed, shape)`` always yields the same graph.

A copy of ``repro.ingest.synth``: ``synthetic_continent`` and the
structural ``closure_storm`` scenario give the same graphs for the same
seed in both packages.
"""
from __future__ import annotations

import numpy as np

from ..core.partition import Partition
from ..core.quantize import QuantSpec
from .csr import CSRArrays, CSRBuilder


def synthetic_continent(grid: tuple[int, int] = (4, 4),
                        district: tuple[int, int] = (16, 16),
                        *,
                        border_links: int = 2,
                        seed: int = 0,
                        weight_high: int = 15,
                        quant: QuantSpec | None = None,
                        chunk_arcs: int = 1 << 20,
                        ) -> tuple[CSRArrays, Partition]:
    """Build the continent and its natural district partition.

    ``grid = (gx, gy)`` districts horizontally/vertically, each an
    ``r × c`` mesh (``district = (r, c)``), so ``n = gx*c * gy*r``.
    Returns ``(CSRArrays, Partition)`` — call ``.to_graph()`` on the
    CSR to hand the float32 graph to the builders.  Connected whenever
    ``border_links >= 1``.
    """
    gx, gy = int(grid[0]), int(grid[1])
    r, c = int(district[0]), int(district[1])
    if gx < 1 or gy < 1:
        raise ValueError(f"grid must be >= 1x1, got {grid}")
    if r < 2 or c < 2:
        raise ValueError(f"district must be >= 2x2, got {district}")
    if border_links < 1:
        raise ValueError("border_links must be >= 1 "
                         f"(got {border_links}); districts would "
                         "disconnect")
    if weight_high < 1:
        raise ValueError(f"weight_high must be >= 1, got {weight_high}")
    H, W = gy * r, gx * c
    n = H * W
    rng = np.random.default_rng(seed)
    builder = CSRBuilder(n, quant=quant)

    def emit(u: np.ndarray, v: np.ndarray) -> None:
        w = rng.integers(1, weight_high + 1,
                         size=len(u)).astype(np.float64)
        for i in range(0, len(u), chunk_arcs):
            builder.add_arcs(u[i:i + chunk_arcs], v[i:i + chunk_arcs],
                             w[i:i + chunk_arcs])

    # district-interior streets: full grid mesh, minus the edges that
    # would cross a district boundary
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

    # cross-district highways: border_links random crossings per shared
    # boundary segment (O(gx*gy) segments — the only Python loop)
    k = min(border_links, r, c)
    bu: list[np.ndarray] = []
    bv: list[np.ndarray] = []
    for bx in range(1, gx):          # vertical boundaries
        col = bx * c - 1
        for jy in range(gy):
            pick = rng.choice(r, size=k, replace=False) + jy * r
            uu = pick.astype(np.int64) * W + col
            bu.append(uu)
            bv.append(uu + 1)
    for by in range(1, gy):          # horizontal boundaries
        row = by * r - 1
        for jx in range(gx):
            pick = rng.choice(c, size=k, replace=False) + jx * c
            uu = row * W + pick.astype(np.int64)
            bu.append(uu)
            bv.append(uu + W)
    if bu:
        emit(np.concatenate(bu), np.concatenate(bv))

    csr = builder.finalize()
    drow = (np.arange(H, dtype=np.int64) // r)
    dcol = (np.arange(W, dtype=np.int64) // c)
    assignment = (drow[:, None] * gx + dcol[None, :]) \
        .ravel().astype(np.int32)
    return csr, Partition(assignment, gx * gy)


def closure_storm(g, part: Partition, *, num_epochs: int = 5,
                  intensity: float = 0.02, reopen_frac: float = 0.5,
                  intra_bias: float = 0.9, sites: int = 2, seed: int = 0):
    """Yield ``(graph, info)`` per epoch of a road-closure storm: a
    *structural* dynamic scenario (arcs leave and re-enter the CSR, not
    just reweight — see ``repro.topo``).

    Each epoch first reopens ``reopen_frac`` of the currently-closed
    pool at the original weights, then closes ``~intensity · |E|`` open
    edges.  A storm is spatially coherent: closures concentrate in
    ``sites`` randomly-struck districts per epoch, and ``intra_bias``
    is the probability a closure is a *side street* — an intra-district
    edge of the struck districts touching no Definition-4 border
    vertex.  Side-street closures leave the border sets AND the border
    degree ranks alone, so the scoped structural-repair path (stage A
    on the struck districts, scoped stage D) is what the scenario
    exercises; the ``1 - intra_bias`` remainder may fell highways
    (cross edges), which can demote borders and force the honest full
    fallback.  Edges whose closure would isolate a vertex are skipped.
    Deterministic per ``(graph, seed)``; ``info`` carries the per-epoch
    ``closed`` / ``reopened`` pairs and counts.
    """
    from ..core.partition import border_mask
    from ..topo.structural import close_edges, open_edges

    if not 0.0 <= intra_bias <= 1.0:
        raise ValueError("intra_bias must be in [0, 1]")
    if not 0.0 <= reopen_frac <= 1.0:
        raise ValueError("reopen_frac must be in [0, 1]")
    if not 1 <= sites <= part.num_districts:
        raise ValueError("sites must be in [1, num_districts]")
    rng = np.random.default_rng(seed)
    pool_u: list[int] = []          # closed, not yet reopened
    pool_v: list[int] = []
    pool_w: list[float] = []
    for _ in range(int(num_epochs)):
        info = {}
        # reopen part of the closed pool at the original weights
        k_open = int(round(reopen_frac * len(pool_u)))
        if k_open:
            pick = rng.choice(len(pool_u), size=k_open, replace=False)
            keep = np.ones(len(pool_u), dtype=bool)
            keep[pick] = False
            ru = np.array([pool_u[i] for i in pick], dtype=np.int64)
            rv = np.array([pool_v[i] for i in pick], dtype=np.int64)
            rw = np.array([pool_w[i] for i in pick], dtype=np.float32)
            g = open_edges(g, ru, rv, rw)
            pool_u = [x for x, k in zip(pool_u, keep) if k]
            pool_v = [x for x, k in zip(pool_v, keep) if k]
            pool_w = [x for x, k in zip(pool_w, keep) if k]
            info["reopened"] = (ru, rv)
        else:
            info["reopened"] = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        # close fresh edges in the struck districts, side-street-biased,
        # never isolating a vertex
        u, v, w = g.edge_list()
        num = len(u)
        target = max(1, int(round(intensity * num)))
        struck = np.zeros(part.num_districts, dtype=bool)
        struck[rng.choice(part.num_districts, size=sites,
                          replace=False)] = True
        border = border_mask(g, part)
        hit = struck[part.assignment[u]] | struck[part.assignment[v]]
        intra = (part.assignment[u] == part.assignment[v]) \
            & ~border[u] & ~border[v] & hit
        want_intra = rng.random(target) < intra_bias
        cand_i = np.nonzero(intra)[0]
        cand_x = np.nonzero(~intra & hit)[0]
        n_i = min(int(want_intra.sum()), len(cand_i))
        n_x = min(target - n_i, len(cand_x))
        sel = np.concatenate([
            rng.choice(cand_i, size=n_i, replace=False) if n_i else
            np.zeros(0, np.int64),
            rng.choice(cand_x, size=n_x, replace=False) if n_x else
            np.zeros(0, np.int64)]).astype(np.int64)
        # drop selections that would take any endpoint's degree to zero
        deg = np.diff(g.indptr).astype(np.int64)
        keep_sel = []
        for i in sel:
            a, b = int(u[i]), int(v[i])
            if deg[a] > 1 and deg[b] > 1:
                keep_sel.append(int(i))
                deg[a] -= 1
                deg[b] -= 1
        sel = np.array(keep_sel, dtype=np.int64)
        cu = u[sel].astype(np.int64)
        cv = v[sel].astype(np.int64)
        cw = w[sel].astype(np.float32)
        if len(sel):
            g = close_edges(g, cu, cv)
            pool_u.extend(int(x) for x in cu)
            pool_v.extend(int(x) for x in cv)
            pool_w.extend(float(x) for x in cw)
        info["closed"] = (cu, cv)
        info["num_closed"] = int(len(cu))
        info["num_reopened"] = int(len(info["reopened"][0]))
        info["pool"] = len(pool_u)
        info["num_edges"] = int(len(g.weights) // 2)
        yield g, info
