"""Plain PyTorch version of the multi-source relaxation.

Mirrors ``multi_source_ref`` of the JAX package's
``kernels/sssp_relax/ref.py``: exactly ``iters`` sweeps, no early exit.
``floyd_warshall_ref`` waits for the Floyd–Warshall kernel's port.
"""
from __future__ import annotations

import torch

from ..minplus.ref import relax_ref


def multi_source_ref(adj: torch.Tensor, init: torch.Tensor,
                     iters: int) -> torch.Tensor:
    """``iters`` Bellman-Ford sweeps from ``init`` rows (..., S, V)."""
    d = init
    for _ in range(iters):
        d = relax_ref(d, adj)
    return d
