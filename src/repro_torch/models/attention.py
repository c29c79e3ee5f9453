"""GQA attention (RoPE, optional qk-norm) and MLA (DeepSeek-V2): init,
full-sequence apply (prefill) and decode apply (one new token against a
fixed-size cache written at ``pos``).

The port of the JAX package's ``models/attention.py``. Caches are dicts
of tensors. Differences, all deliberate: no tensor-parallel pins (the
identity outside a mesh); ``gqa_decode`` and ``mla_decode`` write the
new token's entries into the cache in place; the ``"stub"`` roofline
probe raises ``NotImplementedError`` (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from .layers import apply_rope, dense_init, head_rms_norm, rms_norm

NEG_INF = -1e30


def gqa_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             device: torch.device, lead: tuple[int, ...] = (),
             d_in: int | None = None, d_out: int | None = None) -> dict:
    """``d_in`` / ``d_out``: the widths read and written (default
    ``d_model``; Zamba2's shared block attends at 2 · d_model)."""
    d = d_in or cfg.d_model
    hd = cfg.resolved_head_dim

    def w(a, b):
        return dense_init(gen, a, b, dtype, device, lead)

    p = {"wq": w(d, cfg.num_heads * hd),
         "wk": w(d, cfg.num_kv_heads * hd),
         "wv": w(d, cfg.num_kv_heads * hd),
         "wo": w(cfg.num_heads * hd, d_out or cfg.d_model)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=torch.float32,
                                 device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=torch.float32,
                                 device=device)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None) -> torch.Tensor:
    """q: (B,S,H,hd) k/v: (B,T,kv,hd); grouped by splitting q into kv
    groups. mask: (B,1,S,T) additive or None. The scores come out of the
    einsum in the inputs' dtype and are widened to float32 for the
    softmax; the weights are rounded back to v's dtype."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask[:, :, None]     # (B,1,1,S,T) broadcast
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, hd)


def causal_mask(s: int, t: int, offset: int = 0,
                device: torch.device | None = None) -> torch.Tensor:
    """(1,1,S,T) additive mask. query i attends to keys <= i + offset."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    return torch.where(kj <= qi, zero, neg)[None, None]


def gqa_apply(p: dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ p["wq"], cfg.num_heads, hd)
    k = _split_heads(x @ p["wk"], cfg.num_kv_heads, hd)
    v = _split_heads(x @ p["wv"], cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    s = x.shape[1]
    if cfg.attention_impl == "flash":
        from ..kernels.flash_attention.ops import flash_attention
        out = flash_attention(q, k, v, causal=causal)
    elif cfg.attention_impl == "dense":
        mask = causal_mask(s, s, device=x.device) if causal else None
        out = _sdpa(q, k, v, mask)
    elif cfg.attention_impl == "stub":
        raise NotImplementedError(
            "attention_impl='stub' is the JAX package's roofline probe; "
            "not ported (ROADMAP queue 1 item 10)")
    else:
        raise ValueError(cfg.attention_impl)
    return out.reshape(x.shape[0], s, -1) @ p["wo"]


def gqa_init_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device: torch.device,
                   lead: tuple[int, ...] = (),
                   d_in: int | None = None) -> dict:
    """``d_in`` is ignored, as in the reference: the cache holds keys
    and values by head, whatever width they were projected from."""
    hd = cfg.resolved_head_dim
    shape = (*lead, batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
               pos: int) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, D); cache k/v: (B, T, kv, hd); pos: the write slot.
    Writes the new key and value into ``cache`` at ``pos`` (in place)
    and attends to cache entries < pos+1. Returns (y, cache)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ p["wq"], cfg.num_heads, hd)
    k_new = _split_heads(x @ p["wk"], cfg.num_kv_heads, hd)
    v_new = _split_heads(x @ p["wv"], cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k_new = head_rms_norm(k_new, p["k_norm"], cfg.norm_eps)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    k[:, pos] = k_new[:, 0].to(k.dtype)
    v[:, pos] = v_new[:, 0].to(v.dtype)
    t = k.shape[1]
    mask = causal_mask(1, t, offset=pos, device=x.device)  # (1,1,1,T)
    out = _sdpa(q, k, v, mask)
    return out.reshape(b, 1, -1) @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             device: torch.device, lead: tuple[int, ...] = ()) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    def w(a, b):
        return dense_init(gen, a, b, dtype, device, lead)

    def ones(n):
        return torch.ones((*lead, n), dtype=torch.float32, device=device)

    return {"wq_a": w(d, qr),                     # down
            "q_a_norm": ones(qr),
            "wq_b": w(qr, h * (dn + dr)),         # up
            "wkv_a": w(d, r + dr),                # latent + k_rope
            "kv_a_norm": ones(r),
            "wk_b": w(r, h * dn),
            "wv_b": w(r, h * dv),
            "wo": w(h * dv, d)}


def _mla_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor):
    b, s, _ = x.shape
    h, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = rms_norm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps) @ p["wq_b"]
    q = q.reshape(b, s, h, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]                                   # (B,S,r+dr)
    latent = rms_norm(kv[..., :r], p["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., r:][:, :, None, :], positions,
                        cfg.rope_theta)                   # (B,S,1,dr)
    return q_nope, q_rope, latent, k_rope


def _mla_attend(p: dict, cfg: ArchConfig, q_nope, q_rope, latent, k_rope,
                mask: torch.Tensor | None) -> torch.Tensor:
    """Dense attention over the latent: the keys' no-RoPE part and the
    values are expanded from it per head. The two score products are
    summed in the inputs' dtype and widened to float32 after, as in the
    reference."""
    b, s, h, dn = q_nope.shape
    t = latent.shape[1]
    dv = cfg.v_head_dim
    k_nope = (latent @ p["wk_b"]).reshape(b, t, h, dn)
    v = (latent @ p["wv_b"]).reshape(b, t, h, dv)
    scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btxd->bhst", q_rope, k_rope)).float()
    scores = scores / math.sqrt(dn + cfg.qk_rope_head_dim)
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", w, v)
    return out.reshape(b, s, h * dv) @ p["wo"]


def mla_apply(p: dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, cfg, x, positions)
    s = x.shape[1]
    mask = causal_mask(s, s, device=x.device) if causal else None
    return _mla_attend(p, cfg, q_nope, q_rope, latent, k_rope, mask)


def mla_init_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device: torch.device,
                   lead: tuple[int, ...] = ()) -> dict:
    """MLA caches the compressed latent (+ rope key) — the published
    memory win: r + dr values per token instead of 2·H·hd."""
    return {"latent": torch.zeros((*lead, batch, max_len, cfg.kv_lora_rank),
                                  dtype=dtype, device=device),
            "k_rope": torch.zeros((*lead, batch, max_len, 1,
                                   cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
               pos: int) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, D); cache latent (B, T, r), k_rope (B, T, 1, dr); pos:
    the write slot. Writes the new latent and rope key into ``cache`` at
    ``pos`` (in place) and attends to cache entries < pos+1. Returns
    (y, cache)."""
    b = x.shape[0]
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, latent_new, k_rope_new = _mla_qkv(p, cfg, x, posb)
    latent, k_rope = cache["latent"], cache["k_rope"]
    latent[:, pos] = latent_new[:, 0].to(latent.dtype)
    k_rope[:, pos] = k_rope_new[:, 0].to(k_rope.dtype)
    t = latent.shape[1]
    mask = causal_mask(1, t, offset=pos, device=x.device)  # (1,1,1,T)
    y = _mla_attend(p, cfg, q_nope, q_rope, latent, k_rope, mask)
    return y, cache
