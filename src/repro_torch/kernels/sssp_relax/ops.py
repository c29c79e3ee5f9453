"""Public entry point of the multi-source relaxation.

Mirrors ``multi_source`` of the JAX package's
``kernels/sssp_relax/ops.py``: stage A of the staged builder when only
border rows are needed. Each sweep is one ``minplus.kernel.relax``
launch over every district at once (the plain version on the CPU).
"""
from __future__ import annotations

import torch

from ..minplus import kernel


def multi_source(adj: torch.Tensor, init: torch.Tensor,
                 iters: int) -> tuple[torch.Tensor, int]:
    """Up to ``iters`` fused Bellman-Ford sweeps from ``init`` (..., S, V)
    rows over ``adj`` (..., V, V), float32. Returns the distances and
    the number of sweeps that ran.

    Stops after the first sweep that returns its input bit for bit: a
    sweep of a fixpoint reproduces it, so every sweep left would too,
    and the result equals that of all ``iters`` sweeps. The check costs
    one device-to-host sync per sweep."""
    d = init
    for sweep in range(1, iters + 1):
        nxt = kernel.relax(d, adj)
        if torch.equal(nxt, d):
            return nxt, sweep
        d = nxt
    return d, iters
