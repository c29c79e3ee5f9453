"""GQA flash attention on the card.

``flash_attention(q, k, v, causal=)`` replaces the JAX package's Pallas
kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/kernel.py``): q (B,S,H,hd), k/v
(B,T,KV,hd) with H % KV == 0, one floating dtype, each with a
contiguous last dim → (B,S,H,hd) in q's dtype. Two hand-written kernels
serve it on the card, picked by dtype (any other dtype raises there):

* bfloat16 and float16: ``csrc/flash_attention_bf16.cu``, the
  tensor-core kernel (TMA, ``wgmma``, warp specialisation); hd a
  multiple of 8 up to ``MAX_HEAD_DIM``; q, k, v 16-byte aligned with
  strides that are multiples of 8 elements (TMA's rule), else
  ``ValueError``;
* float32: ``csrc/flash_attention.cu``, on the CUDA cores; any hd up to
  ``MAX_HEAD_DIM``.

On a CUDA tensor the wrapper launches the kernel for its dtype (building
it on first use) or raises; on a CPU tensor it runs the plain version of
``ref.py``, for any hd and any floating dtype (computed in float32,
returned in q's dtype, as the JAX package's ``attention_ref`` does).
There is no other path. ``LAUNCHES`` counts the launches of both
kernels.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import build
from .ref import attention_ref

_CSRC = Path(__file__).resolve().parent / "csrc"

# kernel launches since the last reset (plain-version calls on the CPU
# are not launches)
LAUNCHES = {"flash_attention": 0}

# the widest head dim either kernel has an instance for
MAX_HEAD_DIM = 192
# dtype → (source, C entry point, head dim multiple, query rows per block);
# the 16-bit types' head dim is a multiple of 8 (TMA: 16-byte strides)
_TENSOR_CORE = _CSRC / "flash_attention_bf16.cu"
_KERNELS = {
    torch.bfloat16: (_TENSOR_CORE, "repro_flash_attention_bf16", 8, 128),
    torch.float16: (_TENSOR_CORE, "repro_flash_attention_f16", 8, 128),
    torch.float32: (_CSRC / "flash_attention.cu",
                    "repro_flash_attention_f32", 1, 64),
}
SOURCES = tuple(dict.fromkeys(source for source, *_ in _KERNELS.values()))
_TMA_ALIGN = 16                         # bytes: base address and strides


def _entry(dtype: torch.dtype):
    source, name, _, _ = _KERNELS[dtype]
    fn = getattr(build.load(source), name)
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, p,
                       ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must share a device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not q.dtype.is_floating_point or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must share one "
                         f"floating dtype, got {q.dtype}, {k.dtype}, "
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
    if hd == 0:
        raise ValueError("flash_attention: head dim 0")
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k and v "
                         "must be contiguous")
    if q.device.type == "cuda":
        _check_cuda(q, k, v)


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel for q's dtype takes beyond the plain version."""
    if q.dtype not in _KERNELS:
        raise ValueError(f"flash_attention: no kernel takes {q.dtype} on "
                         "the card (float32, bfloat16 or float16); the "
                         "plain version computes it on the CPU")
    _, _, multiple, rows = _KERNELS[q.dtype]
    hd = q.shape[3]
    if hd > MAX_HEAD_DIM or hd % multiple:
        raise ValueError(f"flash_attention: head dim {hd} on the card must "
                         f"be at most {MAX_HEAD_DIM}"
                         + (f" and a multiple of {multiple} for {q.dtype}"
                            if multiple > 1 else ""))
    if multiple == 1 and q.shape[1] > 65535 * rows:
        # gridDim.y x query rows per block
        raise ValueError(f"flash_attention: S = {q.shape[1]} exceeds "
                         f"{65535 * rows}")
    if multiple > 1 and q.shape[0] * q.shape[2] > 65535:    # gridDim.y
        raise ValueError(f"flash_attention: B·H = {q.shape[0] * q.shape[2]}"
                         f" exceeds 65535 for {q.dtype}")
    if multiple > 1:                    # the TMA kernel
        size = q.element_size()
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % _TMA_ALIGN or any(
                    st * size % _TMA_ALIGN for st in x.stride()[:3]):
                raise ValueError(
                    f"flash_attention: {q.dtype} {name} must be "
                    f"{_TMA_ALIGN}-byte aligned with strides in "
                    f"multiples of {_TMA_ALIGN} "
                    f"bytes (TMA), got strides {tuple(x.stride())} at "
                    f"{x.data_ptr() % _TMA_ALIGN} bytes past alignment")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention of q over k/v per head, K/V head h // (H/KV);
    causal: key j attends for query i when j <= i. It has no backward
    (nor has the JAX package's Pallas kernel): under autograd, with an
    input that requires grad, it raises instead of returning attention
    that carries no gradient."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward; train with "
            "attention_impl='dense' (as the JAX package does)")
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    fn = _entry(q.dtype)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    # the tensor-core kernel takes exp2 of scores scaled by log2(e) /
    # sqrt(hd)
    scale = 1.0 / math.sqrt(hd)
    if q.dtype != torch.float32:
        scale *= math.log2(math.e)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, t, h, kv, hd, strides, scale, int(causal),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: error "
                           f"{err} (CUDA error; 1000: no tensor-map encoder "
                           f"in the driver; 2000 + n: tensor map refused "
                           f"with CUresult n)")
    LAUNCHES["flash_attention"] += 1
    return out
