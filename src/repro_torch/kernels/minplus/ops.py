"""Public entry points of the min-plus products.

Mirrors the JAX package's ``kernels/minplus/ops.py``. There is no
``use_pallas``: the tensors' device decides, as in ``label_join.ops`` —
the CUDA kernels of ``kernel.py`` on the card, their plain versions on
the CPU. Inputs of another dtype than float32 (bf16, say) are widened
to float32, computed, and cast back, as ``minplus_pallas`` does.
"""
from __future__ import annotations

import math

import torch

from ..sssp_relax.ops import multi_source
from . import kernel


def _widened(fn, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32 and y.dtype == torch.float32:
        return fn(x.contiguous(), y.contiguous())
    return fn(x.float().contiguous(), y.float().contiguous()).to(x.dtype)


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical matmul C[..., i, j] = min_k A[..., i, k] + B[..., k, j]."""
    return _widened(kernel.minplus, a, b)


def relax(d: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """One fused Bellman-Ford sweep D' = min(D, D ⊗ A)."""
    return _widened(kernel.relax, d, a)


def bellman_ford(init: torch.Tensor, adj: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Multi-source shortest distances on a dense adjacency by ``iters``
    fused relax sweeps (iters >= graph hop-diameter for exactness);
    stops as soon as a sweep returns its input, which gives the same
    bits (see ``sssp_relax.ops.multi_source``)."""
    return multi_source(adj, init, iters)[0]


def closure(w: torch.Tensor) -> torch.Tensor:
    """All-pairs min-plus closure by repeated squaring: the diagonal is
    set to min(w, 0), then ⌈log2 q⌉ squarings (at least one), the
    reference's fixed schedule."""
    q = w.shape[0]
    eye = torch.eye(q, dtype=torch.bool, device=w.device)
    d = torch.minimum(w, torch.where(eye, 0.0, float("inf")).to(w.dtype))
    for _ in range(max(1, math.ceil(math.log2(max(2, q))))):
        d = minplus(d, d)
    return d
