"""Plain PyTorch version of the flash-attention kernel (GQA-aware): the
dense-softmax oracle of the JAX package's ``flash_attention/ref.py``.

On the host, above ``SCORE_BLOCK_BYTES`` of float32 scores,
``attention_ref`` runs in blocks of query rows (``attention_rows_ref``),
as the reference's kernel runs in blocks in interpret mode on the CPU,
so a 32 768-token sequence (137 GB of scores at 32 heads) fits.
"""
from __future__ import annotations

import math

import torch
from torch._guards import detect_fake_mode

NEG_INF = -1e30

# float32 scores attention_ref holds at once on the host before it splits
# the rows (elsewhere it runs whole)
SCORE_BLOCK_BYTES = 1 << 30


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start: int,
            causal: bool) -> torch.Tensor:
    """Query rows ``start`` onward (``q``) against all of ``k`` / ``v``,
    the causal mask at those absolute rows."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    q5 = q.reshape(b, s, kv, g, hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", q5, k.float()) \
        / math.sqrt(hd)
    if causal:
        qi = torch.arange(start, start + s, device=q.device)[:, None]
        kj = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(kj > qi, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def attention_rows_ref(q_rows: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, start: int, *,
                       causal: bool = True) -> torch.Tensor:
    """Rows ``start`` to ``start + R`` of ``attention_ref(q, k, v)``, from
    those rows of q alone: q_rows (B, R, H, hd), k / v (B, T, KV, hd).
    The causal mask sits at the rows' absolute positions (row ``start +
    i`` attends keys ``<= start + i``), so the keys past the last row,
    masked for every row, are left out. Float32 compute, ``q``'s dtype
    out."""
    if causal:
        last = min(k.shape[1], start + q_rows.shape[1])
        k, v = k[:, :last], v[:, :last]
    return _attend(q_rows, k, v, start, causal)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,KV,hd) with H % KV == 0. Returns
    (B,S,H,hd) in ``q.dtype``. Computed in float32 (the kernel's
    accumulator type); masked scores are ``NEG_INF``, not ``-inf``. On
    the host rows run in blocks of at most ``SCORE_BLOCK_BYTES`` of
    scores; fake tensors (the dry run's, which hold nothing) and other
    devices run whole."""
    b, s, h, _ = q.shape
    rows = max(1, SCORE_BLOCK_BYTES // (4 * b * h * max(k.shape[1], 1)))
    if s <= rows or q.device.type != "cpu" \
            or detect_fake_mode((q,)) is not None:
        return _attend(q, k, v, 0, causal)
    return torch.cat([attention_rows_ref(q[:, i:i + rows], k, v, i,
                                         causal=causal)
                      for i in range(0, s, rows)], dim=1)
