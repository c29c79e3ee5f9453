"""Shared neural layers (functional; params are plain dicts of tensors).

The port of the JAX package's ``models/layers.py`` for the serving
path: dtypes, initialisers, the norms, RoPE and the three MLPs. The
tensor-parallel pins (``constrain_tp``) are left out: outside a device
mesh they are the identity. ``onehot_embed_lookup`` and
``chunked_softmax_xent`` are training and SPMD code and wait for the
training slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a Python-number base: no host-to-device copy (which would wait for
    # the stream to drain) on every call
    return 1.0 / torch.pow(theta, exps)


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
