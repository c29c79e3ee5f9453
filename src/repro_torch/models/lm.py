"""LM assembly for the dense family: init / forward (prefill) / decode.

The port of the dense-family half of the JAX package's ``models/lm.py``.
Params are a dict with the JAX package's keys; layer weights are
stacked along a leading ``L`` axis and layer ``i`` is ``t[i]`` (a view).
``lax.scan`` and ``fori_loop`` over the layers become Python loops. The
attention inside ``forward`` is ``cfg.attention_impl``: ``"flash"`` runs
the flash-attention kernel (``kernels/flash_attention``), ``"dense"``
the materialised softmax. ``decode_step`` always attends densely over
its cache, as the JAX package's does.

The other families — ``moe``, ``ssm``, ``hybrid``, ``vlm``, ``audio`` —
and MLA attention raise ``NotImplementedError`` (ROADMAP queue 1 item
10), as does the training loss.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .attention import gqa_apply, gqa_decode, gqa_init, gqa_init_cache
from .layers import (dense_init, dtype_of, embed_init, mlp_apply, mlp_init,
                     rms_norm)

Params = dict


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP queue 1 item 10); the port runs the dense family")
    if cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP queue 1 "
            "item 10); the port runs GQA")


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: views of each leaf's slice ``i``."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, gen: torch.Generator,
                device: torch.device | str | None = None) -> Params:
    """Random params in ``cfg.param_dtype`` on ``device`` (``None``: the
    card), drawn from ``gen``, which must live on that device."""
    _require_dense(cfg)
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    d, L = cfg.d_model, cfg.num_layers
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_size, d, dtype, device),
        "final_norm": torch.ones((d,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.vocab_size, dtype,
                                       device)
    ones = torch.ones((L, d), dtype=torch.float32, device=device)
    params["layers"] = {
        "attn_norm": ones, "mlp_norm": ones.clone(),
        "attn": gqa_init(gen, cfg, dtype, device, lead=(L,)),
        "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp_type, dtype, device,
                        lead=(L,)),
    }
    return params


def cast_params(params: Params, cfg: ArchConfig) -> Params:
    """Cast matmul weights to compute dtype (norm vectors stay f32; as in
    the JAX package, "matmul weight" means ndim >= 2, so the stacked
    per-layer norms are cast too). Tensors already in that dtype are
    returned as they are, not copied."""
    cd = dtype_of(cfg.compute_dtype)
    return _map(lambda a: a.to(cd) if a.dim() >= 2 else a, params)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _dense_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    x = x + gqa_apply(p["attn"], cfg, h, positions, causal=cfg.causal)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_type)


def _embed_inputs(params: Params, cfg: ArchConfig,
                  batch: dict) -> torch.Tensor:
    """The token path: an embedding gather in compute dtype (the JAX
    package's ``onehot_embed`` matmul gives the same values)."""
    cd = dtype_of(cfg.compute_dtype)
    return params["embed"][batch["tokens"].long()].to(cd)


def forward(params: Params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """batch["tokens"]: (B, S) integer. Returns the final hidden states
    (B, S, D) in compute dtype."""
    _require_dense(cfg)
    params = cast_params(params, cfg)
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    layers = params["layers"]
    for i in range(layers["attn_norm"].shape[0]):
        x = _dense_block(_layer(layers, i), cfg, x, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_head_weight(params: Params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device | str | None = None) -> Any:
    """Zeroed KV cache in compute dtype: {"layers": {"k", "v"}}, each
    (L, B, max_len, KV, hd)."""
    _require_dense(cfg)
    return {"layers": gqa_init_cache(cfg, batch, max_len,
                                     dtype_of(cfg.compute_dtype),
                                     resolve_device(device),
                                     lead=(cfg.num_layers,))}


def decode_step(params: Params, cfg: ArchConfig, cache: Any,
                tokens: torch.Tensor, pos: int | torch.Tensor
                ) -> tuple[torch.Tensor, Any]:
    """One serving step: tokens (B,1) integer, pos the write slot.
    Returns (logits (B,1,V) float32, cache).

    Each layer writes its new key and value into ``cache`` in place (a
    view of the stacked tensors), so the returned cache is the one
    passed in; it holds the values the JAX package's returned cache
    holds."""
    _require_dense(cfg)
    params = cast_params(params, cfg)
    pos = int(pos)
    x = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    layers, caches = params["layers"], cache["layers"]
    for i in range(layers["attn_norm"].shape[0]):
        pl = _layer(layers, i)
        h = rms_norm(x, pl["attn_norm"], cfg.norm_eps)
        a, _ = gqa_decode(pl["attn"], cfg, h, _layer(caches, i), pos)
        x = x + a
        h = rms_norm(x, pl["mlp_norm"], cfg.norm_eps)
        x = x + mlp_apply(pl["mlp"], h, cfg.mlp_type)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ lm_head_weight(params, cfg)).float()
    return logits, cache
