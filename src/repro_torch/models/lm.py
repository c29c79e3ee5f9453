"""LM assembly for the dense family: init / forward / loss / decode.

The port of the dense-family half of the JAX package's ``models/lm.py``.
Params are a dict with the JAX package's keys; layer weights are
stacked along a leading ``L`` axis and layer ``i`` is ``t[i]`` (a view).
``forward`` and ``loss_fn`` also take ``params["layers"]`` as a list of
per-layer dicts (``split_layers``), which is how the train step gives
autograd one leaf per layer. ``lax.scan`` and ``fori_loop`` over the
layers become Python loops; each layer's weights are cast to the compute
dtype inside the layer. While autograd records, ``cfg.remat`` puts each
layer under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
per layer; ``remat_group`` its two-level form), so a layer's activations
and bf16 weights are recomputed in the backward; under ``torch.no_grad``
(serving) nothing is checkpointed. The attention inside ``forward`` is
``cfg.attention_impl``: ``"flash"`` runs the flash-attention kernel
(``kernels/flash_attention``; it has no backward and raises under
autograd), ``"dense"`` the materialised softmax. ``decode_step`` always
attends densely over its cache, as the JAX package's does.

The other families — ``moe``, ``ssm``, ``hybrid``, ``vlm``, ``audio`` —
and MLA attention raise ``NotImplementedError`` (ROADMAP queue 1 item
10).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from .attention import gqa_apply, gqa_decode, gqa_init, gqa_init_cache
from .layers import (chunked_softmax_xent, dense_init, dtype_of, embed_init,
                     mlp_apply, mlp_init, onehot_embed_lookup, rms_norm)

Params = dict
MOE_AUX_COEF = 0.01


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


def split_layers(params: Params) -> Params:
    """``params`` with ``"layers"`` as a list of per-layer dicts (views of
    the stacked tensors; the other entries as they are)."""
    layers = params["layers"]
    if isinstance(layers, list):
        return params
    return {**params, "layers": [_layer(layers, i) for i in
                                 range(layers["attn_norm"].shape[0])]}


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
    return tree_map(lambda a: a.to(cd) if a.dim() >= 2 else a, params)


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
    """The token path in compute dtype: an embedding gather, or with
    ``cfg.onehot_embed`` the chunked one-hot matmul (the same values)."""
    cd = dtype_of(cfg.compute_dtype)
    embed = params["embed"].to(cd)
    if cfg.onehot_embed:
        return onehot_embed_lookup(embed, batch["tokens"], cfg.ce_chunk, cd)
    return embed[batch["tokens"].long()]


def forward(params: Params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """batch["tokens"]: (B, S) integer. Returns the final hidden states
    (B, S, D) in compute dtype."""
    _require_dense(cfg)
    cd = dtype_of(cfg.compute_dtype)
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    layers = split_layers(params)["layers"]
    # every stacked layer leaf has ndim >= 2, so cast_params casts them
    # all; here one layer at a time, inside the checkpointed region

    def layer(x, p):
        return _dense_block(tree_map(lambda a: a.to(cd), p), cfg, x,
                            positions)

    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))

    def run(x, group):
        for p in group:
            x = checkpoint(layer, x, p, use_reentrant=False) if remat \
                else layer(x, p)
        return x

    g = cfg.remat_group
    if remat and g > 1 and len(layers) % g == 0:
        # two-level checkpointing: only group boundaries are kept; a
        # group's layers are recomputed, each checkpointed again, during
        # that group's backward
        for k in range(0, len(layers), g):
            x = checkpoint(run, x, layers[k:k + g], use_reentrant=False)
    else:
        x = run(x, layers)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_head_weight(params: Params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def loss_fn(params: Params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (B, S): the forward pass, then the chunked
    cross-entropy over ``cfg.ce_chunk``-token blocks with the head in
    compute dtype. Differentiable (``loss.backward()``); the dense family
    only (the MoE auxiliary loss, ``MOE_AUX_COEF``, waits for MoE)."""
    x = forward(params, cfg, batch)
    w = lm_head_weight(params, cfg).to(dtype_of(cfg.compute_dtype))
    return chunked_softmax_xent(x, w, batch["labels"], cfg.ce_chunk)


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
