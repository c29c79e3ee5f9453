"""Public entry point for flash attention, and its HBM byte model.

``flash_attention(q, k, v, *, causal=True)`` is the kernel wrapper: the
CUDA kernel for tensors on the card, the dense-softmax plain version
(``ref.attention_ref``) for tensors on the CPU.
"""
from __future__ import annotations

from .kernel import flash_attention

__all__ = ["flash_attention", "hbm_bytes_per_call"]


def hbm_bytes_per_call(q_shape, kv_shape, dtype_bytes: int = 2) -> int:
    """Analytic HBM traffic of the fused kernel: Q+K+V read, O written —
    the score tensor never leaves on-chip memory."""
    b, s, h, hd = q_shape
    t, kv = kv_shape[1], kv_shape[2]
    return dtype_bytes * (b * s * h * hd * 2 + 2 * b * t * kv * hd)
