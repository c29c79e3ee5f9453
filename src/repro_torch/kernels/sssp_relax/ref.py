"""Plain PyTorch versions of the APSP and the multi-source relaxation.

Mirror ``floyd_warshall_ref`` and ``multi_source_ref`` of the JAX
package's ``kernels/sssp_relax/ref.py``: the same rank-1 Floyd–Warshall
loop (the same IEEE float operations in the same order, so bit for bit
with the JAX reference), and exactly ``iters`` sweeps, no early exit.
"""
from __future__ import annotations

import torch

from ..minplus.ref import relax_ref


def with_zero_diagonal(adj: torch.Tensor) -> torch.Tensor:
    """``min(adj, diag 0 / +inf elsewhere)``, in a new tensor: the
    distance of every vertex to itself is 0."""
    n = adj.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    return torch.minimum(
        adj, torch.where(eye, 0.0, float("inf")).to(adj.dtype))


def floyd_warshall_ref(adj: torch.Tensor) -> torch.Tensor:
    """Exact all-pairs shortest distances of a dense (n, n) adjacency
    (diag 0, +inf = no edge, weights non-negative) — the per-district
    APSP oracle."""
    d = with_zero_diagonal(adj)
    for k in range(adj.shape[0]):
        d = torch.minimum(d, d[:, k, None] + d[k, None, :])
    return d


def multi_source_ref(adj: torch.Tensor, init: torch.Tensor,
                     iters: int) -> torch.Tensor:
    """``iters`` Bellman-Ford sweeps from ``init`` rows (..., S, V)."""
    d = init
    for _ in range(iters):
        d = relax_ref(d, adj)
    return d
