"""GQA flash attention on the card.

``flash_attention(q, k, v, causal=)`` wraps ``csrc/flash_attention.cu``,
which replaces the JAX package's Pallas kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/kernel.py``): q (B,S,H,hd), k/v
(B,T,KV,hd) with H % KV == 0, float32 or bfloat16, hd in {16, 32, 64,
128}, each with a contiguous last dim → (B,S,H,hd) in q's dtype. On a
CUDA tensor the wrapper launches the kernel (building it on first use)
or raises; on a CPU tensor it runs the plain version of ``ref.py``.
There is no other path. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build
from .ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

# kernel launches since the last reset (plain-version calls on the CPU
# are not launches)
LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_Q_TILES = 65535 * 64               # gridDim.y x query rows per block


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, ctypes.c_int, i64, i64, i64, i64, i64,
                       i64, p, ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must share a device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must all be float32 "
                         f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError("flash_attention: q must be (B,S,H,hd) and k, v "
                         f"(B,T,KV,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    h, kv, hd = q.shape[2], k.shape[2], q.shape[3]
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: H = {h} is not a multiple of "
                         f"KV = {kv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k and v "
                         "must be contiguous")
    if q.shape[1] > _MAX_Q_TILES:
        raise ValueError(f"flash_attention: S = {q.shape[1]} exceeds "
                         f"{_MAX_Q_TILES}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention of q over k/v per head, K/V head h // (H/KV);
    causal: key j attends for query i when j <= i."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    fn = _lib().repro_flash_attention
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    scale = 1.0 / float(hd) ** 0.5
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, s, t, h, kv, hd, strides, scale,
                 int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
