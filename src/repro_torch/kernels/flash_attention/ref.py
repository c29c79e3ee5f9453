"""Plain PyTorch version of the flash-attention kernel (GQA-aware): the
dense-softmax oracle of the JAX package's ``flash_attention/ref.py``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,KV,hd) with H % KV == 0. Returns
    (B,S,H,hd) in ``q.dtype``. Computed in float32 (the kernel's
    accumulator type); masked scores are ``NEG_INF``, not ``-inf``."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    q5 = q.reshape(b, s, kv, g, hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", q5, k.float()) \
        / math.sqrt(hd)
    if causal:
        qi = torch.arange(s, device=q.device)[:, None]
        kj = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(kj > qi, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)
