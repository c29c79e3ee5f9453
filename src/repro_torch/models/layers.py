"""Shared neural layers (functional; params are plain dicts of tensors).

The port of the JAX package's ``models/layers.py``: dtypes,
initialisers, the norms, RoPE, the three MLPs, the one-hot embedding
lookup and the chunked cross-entropy with its hand-written backward.
The tensor-parallel pins (``constrain_tp``, ``constrain_matrix``) are
left out: outside a device mesh they are the identity.
"""
from __future__ import annotations

import math
import struct

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init helpers (``lead`` prepends stacked axes, such as the layer axis L)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device: torch.device,
               lead: tuple[int, ...] = ()) -> torch.Tensor:
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def head_rms_norm(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """qk-norm: RMS over the head_dim of (..., heads, head_dim)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python number."""
    return struct.unpack("f", struct.pack("f", x))[0]


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    """The reference's ``1 / theta ** (arange(half) / half)`` as its
    traced model computes it: XLA folds the constant when it compiles,
    dividing by ``half`` as a float32 multiply by ``1 / half`` and
    rounding the power and its reciprocal once. Here the multiply is
    exact in float64 and rounded to float32, and the rest is float64
    rounded once, so the card and the host agree too (a float32 ``pow``
    differs between them by an ulp, and at position p an ulp of a
    frequency turns its angle by about p ulps: 0.03 rad at 524 287)."""
    half = head_dim // 2
    # Python-number factors: no host-to-device copy (which would wait for
    # the stream to drain) on every call
    exps = (torch.arange(0, half, dtype=torch.float64, device=device)
            * _f32(1.0 / half)).float().double()
    return (1.0 / torch.pow(_f32(theta), exps)).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs           # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, f: int, mlp_type: str,
             dtype: torch.dtype, device: torch.device,
             lead: tuple[int, ...] = ()) -> dict:
    def w(d_in, d_out):
        return dense_init(gen, d_in, d_out, dtype, device, lead)
    if mlp_type == "swiglu":
        return {"wi": w(d, f), "wg": w(d, f), "wo": w(f, d)}
    return {"wi": w(d, f), "wo": w(f, d)}


def mlp_apply(p: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif mlp_type == "squared_relu":
        h = torch.square(F.relu(x @ p["wi"]))
    elif mlp_type == "gelu":
        h = F.gelu(x @ p["wi"], approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return h @ p["wo"]


def onehot_embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                        chunk: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Embedding lookup as a chunked one-hot matmul (the JAX package's
    SPMD-friendly form of the gather; the same values, since each output
    is one product with 1.0). Sequence chunks of ``chunk`` tokens (the
    whole sequence when it does not divide), each recomputed in the
    backward under autograd, as the reference's ``jax.checkpoint`` body
    is, so the one-hot block stays transient."""
    b, s = tokens.shape
    if s % chunk != 0:
        chunk = s

    def body(tb: torch.Tensor) -> torch.Tensor:
        oh = F.one_hot(tb.long(), embed.shape[0]).to(embed.dtype)
        return oh @ embed

    remat = torch.is_grad_enabled() and embed.requires_grad
    out = [checkpoint(body, tokens[:, i:i + chunk], use_reentrant=False)
           if remat else body(tokens[:, i:i + chunk])
           for i in range(0, s, chunk)]
    return torch.cat(out, dim=1).to(out_dtype)


# ---------------------------------------------------------------------------
# chunked cross-entropy (never materializes the full (B,S,V) logits)
# ---------------------------------------------------------------------------

def _chunks(s: int, chunk: int) -> list[slice]:
    if s % chunk != 0:
        chunk = s  # fall back for tiny smoke shapes
    return [slice(i, i + chunk) for i in range(0, s, chunk)]


def _xent_fwd(x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
              chunk: int) -> torch.Tensor:
    b, s, _ = x.shape
    w32 = lm_head.float()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for sl in _chunks(s, chunk):
        logits = x[:, sl].float() @ w32
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, sl, None].long())[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (b * s)


def _xent_bwd(chunk: int, x: torch.Tensor, lm_head: torch.Tensor,
              labels: torch.Tensor, g: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    w32 = lm_head.float()
    scale = (g / (b * s)).float()
    dw = torch.zeros((d, lm_head.shape[1]), dtype=torch.float32,
                     device=x.device)
    dx = torch.empty_like(x)
    for sl in _chunks(s, chunk):
        x32 = x[:, sl].float()
        p = torch.softmax(x32 @ w32, dim=-1)
        lb = labels[:, sl, None].long()
        # dlogits = (p - one_hot(labels)) * scale
        p.scatter_add_(-1, lb, torch.full(lb.shape, -1.0, device=x.device))
        dlogits = p.mul_(scale)
        dx[:, sl] = (dlogits @ w32.T).to(x.dtype)
        dw.addmm_(x32.reshape(-1, d).T, dlogits.reshape(-1, dw.shape[1]))
    return dx, dw.to(lm_head.dtype)


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lm_head, labels, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, lm_head, labels)
        return _xent_fwd(x, lm_head, labels, chunk)

    @staticmethod
    def backward(ctx, g):
        x, lm_head, labels = ctx.saved_tensors
        dx, dw = _xent_bwd(ctx.chunk, x, lm_head, labels, g)
        return dx, dw, None, None


def chunked_softmax_xent(x: torch.Tensor, lm_head: torch.Tensor,
                         labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean CE over (B,S) with logits computed per sequence chunk.

    x: (B, S, D) final hidden states; lm_head: (D, V); labels: (B, S).
    Only one (B, chunk, V) float32 logits block lives at a time, forward
    and backward: the backward is hand-written (a
    ``torch.autograd.Function``, as the reference's ``custom_vjp``) and
    recomputes each chunk's logits, accumulating the lm_head gradient in
    float32 across chunks. Like the reference, it returns dx in x's
    dtype and dw rounded to lm_head's dtype: with tied embeddings in
    bf16 compute, the head's gradient reaches the float32 embedding
    through bf16. A chunk that does not divide S falls back to S.
    """
    return _ChunkedXent.apply(x, lm_head, labels, chunk)
