"""GQA attention (RoPE, optional qk-norm) and MLA (DeepSeek-V2): init,
full-sequence apply (prefill) and decode apply (one new token against a
fixed-size cache written at ``pos``).

The port of the JAX package's ``models/attention.py``. Caches are dicts
of tensors. ``attention_impl="stub"`` is the roofline probe's byte model
of the fused kernel (``launch/roofline.py``). Differences, all
deliberate: no tensor-parallel pins (the identity outside a mesh);
``gqa_decode`` and ``mla_decode`` write the new token's entries into
the cache in place; above ``SCORE_BLOCK_BYTES`` of float32 scores MLA
attends in blocks of query rows (the same function; decode never
blocks).
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from .layers import apply_rope, dense_init, head_rms_norm, rms_norm

NEG_INF = -1e30

# float32 scores (B, H, S, T) that MLA attention holds at once; above it
# the query rows run in blocks, on every device (DeepSeek-V2 at 32 768
# tokens would hold 550 GB a sequence)
SCORE_BLOCK_BYTES = 1 << 30


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
        # roofline probe: QKVO traffic only — the HBM byte model of the
        # fused flash kernel (scores stay on chip); its flops are added
        # back analytically by launch/roofline.py
        g = cfg.num_heads // cfg.num_kv_heads
        out = torch.repeat_interleave(v[:, :s] if v.shape[1] >= s else v,
                                      g, dim=2) + 0.0 * q
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


def _mla_q(p: dict, cfg: ArchConfig, x: torch.Tensor,
           positions: torch.Tensor):
    """The queries' no-RoPE and RoPE parts (B, S, H, dn) / (B, S, H, dr)."""
    b, s, _ = x.shape
    dn = cfg.qk_nope_head_dim
    q = rms_norm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps) @ p["wq_b"]
    q = q.reshape(b, s, cfg.num_heads, dn + cfg.qk_rope_head_dim)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_kv(p: dict, cfg: ArchConfig, x: torch.Tensor,
            positions: torch.Tensor):
    """What the cache stores: the latent (B, S, r) and the RoPE key
    (B, S, 1, dr)."""
    r = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]                                   # (B,S,r+dr)
    latent = rms_norm(kv[..., :r], p["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., r:][:, :, None, :], positions,
                        cfg.rope_theta)                   # (B,S,1,dr)
    return latent, k_rope


def _mla_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor):
    return (*_mla_q(p, cfg, x, positions), *_mla_kv(p, cfg, x, positions))


def _mla_attend(p: dict, cfg: ArchConfig, q_nope, q_rope, latent, k_rope,
                causal: bool, offset: int = 0) -> torch.Tensor:
    """Dense attention over the latent: the keys' no-RoPE part and the
    values are expanded from it per head. The two score products are
    summed in the inputs' dtype and widened to float32 after, as in the
    reference. ``causal``: query i attends keys <= i + ``offset``. Above
    ``SCORE_BLOCK_BYTES`` of float32 scores the query rows run in blocks
    (``mla_attend_rows``)."""
    b, s, h, dn = q_nope.shape
    t = latent.shape[1]
    dv = cfg.v_head_dim
    k_nope = (latent @ p["wk_b"]).reshape(b, t, h, dn)
    v = (latent @ p["wv_b"]).reshape(b, t, h, dv)
    rows = score_block_rows(b, h, t)
    if s > rows:
        out = mla_attend_rows(cfg, q_nope, q_rope, k_nope, k_rope, v,
                              causal, offset, rows)
        return out.reshape(b, s, h * dv) @ p["wo"]
    scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btxd->bhst", q_rope, k_rope)).float()
    scores = scores / math.sqrt(dn + cfg.qk_rope_head_dim)
    if causal:
        scores = scores + causal_mask(s, t, offset=offset,
                                      device=q_nope.device)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", w, v)
    return out.reshape(b, s, h * dv) @ p["wo"]


def score_block_rows(b: int, h: int, t: int) -> int:
    """Query rows whose (B, H, rows, T) float32 scores fit in
    ``SCORE_BLOCK_BYTES`` (at least one)."""
    return max(1, SCORE_BLOCK_BYTES // (4 * b * h * t))


def mla_attend_rows(cfg: ArchConfig, q_nope, q_rope, k_nope, k_rope, v,
                    causal: bool, offset: int, rows: int) -> torch.Tensor:
    """``_mla_attend``'s attention ``rows`` query rows at a time: every
    row's softmax stands alone, so this is the same function with at most
    (B, H, rows, T) float32 scores held at once. q_nope / q_rope (B, S,
    H, d), k_nope / v (B, T, H, d) expanded from the latent, k_rope (B,
    T, 1, dr); query i attends keys <= i + ``offset`` when ``causal``.
    The keys and values are laid out (B, H, T, d) once a call; each
    block's causal mask is built for its rows alone, and the keys past
    its last row, masked for every row in it, are left out. Returns (B,
    S, H, dv) in v's dtype."""
    b, s, h, dn = q_nope.shape
    t = k_nope.shape[1]
    scale = math.sqrt(dn + cfg.qk_rope_head_dim)
    k_t = k_nope.permute(0, 2, 3, 1).contiguous()        # (B,H,dn,T)
    v_h = v.permute(0, 2, 1, 3).contiguous()             # (B,H,T,dv)
    kr_t = k_rope[:, :, 0].transpose(1, 2)               # (B,dr,T)
    out = torch.empty((b, s, h, v_h.shape[-1]), dtype=v_h.dtype,
                      device=v_h.device)
    for i in range(0, s, rows):
        j = min(s, i + rows)
        last = min(t, offset + j) if causal else t
        qn = q_nope[:, i:j].transpose(1, 2)              # (B,H,R,dn)
        qr = q_rope[:, i:j].reshape(b, (j - i) * h, -1)  # (B,R·H,dr)
        rope = (qr @ kr_t[..., :last]).view(b, j - i, h, last)
        scores = (qn @ k_t[..., :last] + rope.transpose(1, 2)).float()
        del rope
        scores.div_(scale)
        if causal:
            scores.add_(causal_mask(j - i, last, offset=offset + i,
                                    device=scores.device))
        w = torch.softmax(scores, dim=-1).to(v_h.dtype)
        del scores
        out[:, i:j] = (w @ v_h[:, :, :last]).transpose(1, 2)
    return out


def mla_apply(p: dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, cfg, x, positions)
    return _mla_attend(p, cfg, q_nope, q_rope, latent, k_rope, causal)


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
    y = _mla_attend(p, cfg, q_nope, q_rope, latent, k_rope, True,
                    offset=pos)
    return y, cache
