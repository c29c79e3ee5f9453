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
  every district at once (the plain version on the CPU), with the
  occupancy map of the adjacency (``occupancy_map``) computed once per
  call where the adjacency is large enough for the map to pay.
"""
from __future__ import annotations

import torch

from ..minplus import kernel as mp_kernel
from . import kernel

# multi_source builds the occupancy map only for an adjacency of at
# least this many bytes. Below it a sweep is bound by its launch, not by
# A's bytes (A also stays in L2 between sweeps), so skipping A's empty
# tiles saves nothing while the map costs a pass over A. chip_smoke.py's
# phase builder_times times a shape on each side: n = 4096's 4 MiB, and
# n = 102 400's 156 MiB for one district and 2.4 GiB for sixteen.
OCCUPANCY_MIN_BYTES = 32 << 20


def floyd_warshall(adj: torch.Tensor) -> torch.Tensor:
    """Dense district APSP (diag 0, +inf absent), in ``adj.dtype``."""
    return kernel.floyd_warshall(adj.float().contiguous()).to(adj.dtype)


def occupancy_map(adj: torch.Tensor) -> torch.Tensor | None:
    """The occupancy map ``multi_source`` passes to its sweeps over
    ``adj``: ``relax_occupancy(adj)``, or None (every tile read) below
    ``OCCUPANCY_MIN_BYTES``."""
    if adj.numel() * adj.element_size() < OCCUPANCY_MIN_BYTES:
        return None
    return mp_kernel.relax_occupancy(adj)


def multi_source(adj: torch.Tensor, init: torch.Tensor,
                 iters: int) -> tuple[torch.Tensor, int]:
    """Up to ``iters`` fused Bellman-Ford sweeps from ``init`` (..., S, V)
    rows over ``adj`` (..., V, V), float32. Returns the distances and
    the number of sweeps that ran. The occupancy map of ``adj``
    (``occupancy_map``) is computed once and passed to every sweep, so
    no sweep reads a tile of ``adj`` that holds no finite entry.

    Stops after the first sweep that returns its input bit for bit: a
    sweep of a fixpoint reproduces it, so every sweep left would too,
    and the result equals that of all ``iters`` sweeps. The check costs
    one device-to-host sync per sweep."""
    d = init
    occupancy = occupancy_map(adj)
    for sweep in range(1, iters + 1):
        nxt = mp_kernel.relax(d, adj, occupancy)
        if torch.equal(nxt, d):
            return nxt, sweep
        d = nxt
    return d, iters
