"""Plain PyTorch versions of the min-plus (tropical) kernels.

They mirror the JAX package's ``kernels/minplus/ref.py`` with an
optional leading batch (district) axis. The contraction is taken in
chunks of k, so the temporary is O(batch·m·chunk·n) and never the full
O(batch·m·k·n) broadcast: ``min`` is exact and order-free and every
term is one float32 add, so chunking changes no bit. The CPU runs them
(``kernel.minplus`` / ``kernel.relax`` take them for tensors on the
CPU), and the card's checks hold the CUDA kernels against them.
"""
from __future__ import annotations

import torch

# elements of the chunked broadcast temporary (64 MiB of float32)
_TEMP_ELEMENTS = 1 << 24


def _chunk(batch: int, m: int, k: int, n: int) -> int:
    return max(1, min(k, _TEMP_ELEMENTS // max(1, batch * m * n)))


def _min_plus_into(acc: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """acc = min(acc, a ⊗ b) over the last two axes, k in chunks."""
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    batch = acc.numel() // max(1, m * n)
    step = _chunk(batch, m, k, n)
    for k0 in range(0, k, step):
        ak = a[..., :, k0:k0 + step, None]          # (..., m, c, 1)
        bk = b[..., None, k0:k0 + step, :]          # (..., 1, c, n)
        acc = torch.minimum(acc, torch.amin(ak + bk, dim=-2))
    return acc


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[..., i, j] = min_k A[..., i, k] + B[..., k, j]; +inf where the
    contraction is empty. a: (..., m, k), b: (..., k, n) → (..., m, n)."""
    shape = (*a.shape[:-1], b.shape[-1])
    acc = torch.full(shape, float("inf"), dtype=a.dtype, device=a.device)
    return _min_plus_into(acc, a, b)


def relax_ref(d: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """One Bellman-Ford sweep: D' = min(D, D ⊗ A), D (..., s, v),
    A (..., v, v). Out of place: D is never written."""
    return _min_plus_into(d, d, a)
