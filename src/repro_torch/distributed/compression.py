"""Error-feedback int8 gradient compression.

The port of the JAX package's ``distributed/compression.py``, on
tensors. ``compress_decompress`` quantizes each leaf to int8 with a
per-leaf scale (max |x| / 127) before the (simulated) wire and keeps the
quantization residual in an error-feedback buffer that is added back the
next step — the standard EF-SGD construction that preserves convergence.
It plugs into ``make_train_step(grad_transform=...)``.
"""
from __future__ import annotations

from typing import Any

import torch

from ..tree import tree_leaves, tree_map


def init_error_feedback(params: Any) -> Any:
    """float32 zeros shaped as ``params``, on each leaf's device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale): codes = clip(round(x / scale), ±127)
    with scale = max |x| / 127 + 1e-12 (round half to even)."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clip(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(grads: Any, error_buf: Any) -> tuple[Any, Any]:
    """Returns (compressed-then-decompressed grads, new error buffer)."""
    def one(g, e):
        g32 = g.float() + e
        deq = dequantize_int8(*quantize_int8(g32))
        return deq, g32 - deq

    out = tree_map(one, grads, error_buf)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def compressed_bytes(params: Any) -> tuple[int, int]:
    """(fp32 bytes, int8+scale bytes) for the DP gradient all-reduce."""
    leaves = tree_leaves(params)
    n = sum(p.numel() for p in leaves)
    return 4 * n, n + 4 * len(leaves)
