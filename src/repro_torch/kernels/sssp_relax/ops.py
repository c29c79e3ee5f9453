"""Public entry points of the APSP and the multi-source relaxation.

Mirrors the JAX package's ``kernels/sssp_relax/ops.py``. There is no
``use_pallas`` and no ``bk``: the tensor's device decides — the CUDA
kernels on the card, their plain versions on the CPU — and the tile is
the kernel's own.

* ``floyd_warshall(adj)``: dense district APSP by the blocked
  Floyd–Warshall kernel (``kernel.py``), computed in float32 and cast
  back to ``adj.dtype``, as ``floyd_warshall_pallas`` does;
* ``multi_source``: stage A of the staged builder when only border rows
  are needed. Each sweep is one ``minplus.kernel.relax`` launch over
  every district at once (the plain version on the CPU).
"""
from __future__ import annotations

import torch

from ..minplus import kernel as mp_kernel
from . import kernel


def floyd_warshall(adj: torch.Tensor) -> torch.Tensor:
    """Dense district APSP (diag 0, +inf absent), in ``adj.dtype``."""
    return kernel.floyd_warshall(adj.float().contiguous()).to(adj.dtype)


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
        nxt = mp_kernel.relax(d, adj)
        if torch.equal(nxt, d):
            return nxt, sweep
        d = nxt
    return d, iters
