"""Vertex ordering O (hub-pushing priority).

The paper (§6) uses a degree-based pushing order — high-degree vertices are
pushed first — which it credits for cheap preprocessing. We implement that
plus a degree+tiebreak variant for determinism, and expose a rank array so
builders can compare priorities in O(1).
"""
from __future__ import annotations

import numpy as np

from .graph import Graph


def degree_order(g: Graph, subset: np.ndarray | None = None) -> np.ndarray:
    """Vertices sorted by decreasing degree (stable, id tiebreak).

    Returns the vertex ids in pushing order. ``subset`` restricts the
    ordering to those vertices (e.g. the border set B).
    """
    deg = g.degrees
    ids = np.arange(g.num_vertices, dtype=np.int32) if subset is None \
        else np.asarray(subset, dtype=np.int32)
    # sort by (-degree, id): lexsort keys are applied last-key-major
    order = np.lexsort((ids, -deg[ids].astype(np.int64)))
    return ids[order]


def rank_of(order: np.ndarray, n: int) -> np.ndarray:
    """rank[v] = position of v in ``order`` (n for vertices not in it).

    Lower rank = higher priority = pushed earlier.
    """
    rank = np.full(n, n, dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return rank
