"""Public entry points of the min-plus products.

Mirrors the JAX package's ``kernels/minplus/ops.py``. There is no
``use_pallas``: the tensors' device decides, as in ``label_join.ops`` —
the CUDA kernels of ``kernel.py`` on the card, their plain versions on
the CPU. Inputs of another dtype than float32 (bf16, say) are widened
to float32, computed, and cast back, as ``minplus_pallas`` does.
``minplus_kmajor`` and ``closure_squarings`` are the port's own entry
points for the builder: the product with A given k-major, and the
closure's squarings in one launch with the warm closure's early exit.
"""
from __future__ import annotations

import math

import torch

from ..sssp_relax.ops import multi_source
from . import kernel, ref


def _widened(fn, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32 and y.dtype == torch.float32:
        return fn(x.contiguous(), y.contiguous())
    return fn(x.float().contiguous(), y.float().contiguous()).to(x.dtype)


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical matmul C[..., i, j] = min_k A[..., i, k] + B[..., k, j]."""
    return _widened(kernel.minplus, a, b)


def minplus_kmajor(a_t: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same product with A given k-major: C[..., i, j] =
    min_k A_t[..., k, i] + B[..., k, j], i.e. ``minplus(a_t.mT, b)``
    without a transposed copy of A."""
    return _widened(kernel.minplus_kmajor, a_t, b)


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


def closure_steps(q: int) -> int:
    """The reference's squaring count: ⌈log2 q⌉, at least one."""
    return max(1, math.ceil(math.log2(max(2, q))))


def closure_squarings(d: torch.Tensor, steps: int, check_from: int
                      ) -> tuple[torch.Tensor, torch.Tensor | int]:
    """Up to ``steps`` squarings D ← D ⊗ D, stopping from squaring
    ``check_from`` on at the first that returns its input; returns D and
    that squaring's index, else ``steps`` (read it with ``int()``).
    float32 up to ``kernel.CLOSURE_MAX_Q`` on the card: the fused
    closure kernel, one launch. Above it, and for other dtypes (rounded
    back at every squaring, as the reference's ``minplus`` does), the
    loop of ``minplus`` squarings (and for an empty D)."""
    if d.dtype != torch.float32 or not d.numel() \
            or (d.device.type == "cuda" and d.shape[0] > kernel.CLOSURE_MAX_Q):
        return ref.squarings(d, steps, check_from, minplus)
    return kernel.closure(d.contiguous(), steps, check_from)


def closure(w: torch.Tensor) -> torch.Tensor:
    """All-pairs min-plus closure by repeated squaring: the diagonal is
    set to min(w, 0), then ⌈log2 q⌉ squarings (at least one), the
    reference's fixed schedule."""
    q = w.shape[0]
    eye = torch.eye(q, dtype=torch.bool, device=w.device)
    d = torch.minimum(w, torch.where(eye, 0.0, float("inf")).to(w.dtype))
    steps = closure_steps(q)
    return closure_squarings(d, steps, steps)[0]
