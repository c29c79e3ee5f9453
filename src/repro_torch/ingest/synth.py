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

A copy of ``repro.ingest.synth.synthetic_continent`` (the structural
``closure_storm`` scenario arrives with the dynamic-topology slice).
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
