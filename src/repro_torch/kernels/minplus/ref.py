"""Plain PyTorch versions of the min-plus (tropical) kernels.

They mirror the JAX package's ``kernels/minplus/ref.py`` with an
optional leading batch (district) axis. The contraction is taken in
chunks of k, so the temporary is O(batch·m·chunk·n) and never the full
O(batch·m·k·n) broadcast: ``min`` is exact and order-free and every
term is one float32 add, so chunking changes no bit. The CPU runs them
(the wrappers of ``kernel.py`` take them for tensors on the CPU), and
the card's checks hold the CUDA kernels against them.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

# elements of the chunked broadcast temporary (64 MiB of float32)
_TEMP_ELEMENTS = 1 << 24

# the relax kernel's tiles of A: KTILE k rows x STRIP columns, one byte
# of the occupancy map each (kKBlock and kStrip in csrc/minplus.cu)
KTILE = 32
STRIP = 128


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


def minplus_kmajor_ref(a_t: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[..., i, j] = min_k A_t[..., k, i] + B[..., k, j]: the product with
    A given k-major, a_t (..., k, m), b (..., k, n) → (..., m, n)."""
    return minplus_ref(a_t.transpose(-1, -2), b)


def squarings(d: torch.Tensor, steps: int, check_from: int,
              product: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
              ) -> tuple[torch.Tensor, int]:
    """Up to ``steps`` Jacobi squarings D ← D ⊗ D by ``product``; from
    squaring ``check_from`` on, stop at the first squaring that returns
    its input (a fixpoint: the squarings left would reproduce it).
    Returns D and that squaring's index (``steps`` when none did) — the
    warm closure's loop rule; ``check_from >= steps`` is the fixed
    schedule."""
    for s in range(steps):
        nd = product(d, d)
        if s >= check_from and torch.equal(nd, d):
            return d, s
        d = nd
    return d, steps


def closure_ref(d: torch.Tensor, steps: int,
                check_from: int) -> tuple[torch.Tensor, int]:
    """Plain version of the fused closure kernel: ``squarings`` with
    ``minplus_ref``."""
    return squarings(d, steps, check_from, minplus_ref)


def relax_occupancy(a: torch.Tensor) -> torch.Tensor:
    """Which tiles of ``a`` (..., v, v) hold a finite entry: uint8
    (..., ⌈v/STRIP⌉, ⌈v/KTILE⌉), entry [s, t] for column strip s and
    k-tile t (rows t·KTILE …, columns s·STRIP …). One pass over ``a`` on
    its device: the minimum of each tile (padded with +inf where v is
    ragged) is finite. The pass reduces each row's strips first (the
    contiguous axis, at the memory rate), then the KTILE rows of a tile
    in the 128× smaller result."""
    v = a.shape[-1]
    strips, ktiles = -(-v // STRIP), -(-v // KTILE)
    flat = a.reshape(-1, v, v)
    if (ktiles * KTILE, strips * STRIP) != (v, v):
        flat = torch.nn.functional.pad(
            flat, (0, strips * STRIP - v, 0, ktiles * KTILE - v),
            value=float("inf"))
    low = flat.view(-1, ktiles, KTILE, strips, STRIP).amin(-1).amin(2)
    occ = (low < float("inf")).to(torch.uint8).transpose(1, 2).contiguous()
    return occ.reshape(*a.shape[:-2], strips, ktiles)


def relax_ref(d: torch.Tensor, a: torch.Tensor,
              occupancy: torch.Tensor | None = None) -> torch.Tensor:
    """One Bellman-Ford sweep: D' = min(D, D ⊗ A), D (..., s, v),
    A (..., v, v). Out of place: D is never written. With
    ``occupancy`` (``relax_occupancy(a)``), the tiles it marks empty
    are read as +inf, as the kernel never reads them."""
    if occupancy is not None:
        v = a.shape[-1]
        keep = occupancy.bool().transpose(-1, -2) \
            .repeat_interleave(KTILE, -2).repeat_interleave(STRIP, -1)
        a = torch.where(keep[..., :v, :v], a, float("inf"))
    return _min_plus_into(d, d, a)
