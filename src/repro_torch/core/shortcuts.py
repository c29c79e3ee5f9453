"""Border Auxiliary Shortcuts — §3.2, Theorem 2.

For district D_i, a shortcut edge (b_m, b_n, λ(b_m, b_n, B)) is added for
every border pair; the augmented district D_i⁺ then admits a standard local
2-hop index L_i⁺ that answers *same-district* queries with the global
distance (any escape-and-return path collapses onto a shortcut).

λ between borders is exact by Theorem 1 (constraint 1), so the shortcut
matrix is just a pairwise join over the border rows of B — a min-plus
product of the border block with its own transpose, which on TPU is again
`kernels/minplus`.
"""
from __future__ import annotations

import numpy as np

from .border_labeling import minplus
from .labels import BorderLabels

INF = np.float32(np.inf)


def border_shortcut_matrix(bl: BorderLabels,
                           district_borders: np.ndarray) -> np.ndarray:
    """(b_i, b_i) matrix of global border-to-border distances for one
    district: S[m, n] = λ(b_m, b_n, B)."""
    if len(district_borders) == 0:
        return np.zeros((0, 0), dtype=np.float32)
    rows = bl.table[district_borders]          # (b_i, q)
    s = minplus(rows, rows.T.copy())
    np.fill_diagonal(s, 0.0)
    return s.astype(np.float32)


def shortcut_edges(border_locals: np.ndarray, shortcut: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Upper-triangle shortcut edge list in *local* district indexing,
    ready for ``pll_subgraph(extra_edges=...)``. Infinite entries (borders
    in different components) are dropped."""
    b = len(border_locals)
    us, vs, ws = [], [], []
    for m in range(b):
        for n in range(m + 1, b):
            w = shortcut[m, n]
            if np.isfinite(w):
                us.append(int(border_locals[m]))
                vs.append(int(border_locals[n]))
                ws.append(float(w))
    return (np.array(us, dtype=np.int32), np.array(vs, dtype=np.int32),
            np.array(ws, dtype=np.float32))
