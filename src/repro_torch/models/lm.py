"""LM assembly: init / forward / loss / decode for every family.

The port of the JAX package's ``models/lm.py``: the ``dense``, ``moe``,
``vlm`` and ``audio`` families (pre-norm attention, GQA or MLA, with an
MLP or an MoE FFN), ``ssm`` (Mamba2 SSD blocks only) and ``hybrid``
(Zamba2: a Mamba2 backbone and one *shared* attention + MLP block
applied after every ``shared_attn_every``-th layer on [hidden ;
embedded input], 2 · d_model wide). Params are a dict with the JAX
package's keys; layer weights are stacked along a leading ``L`` axis
and layer ``i`` is ``t[i]`` (a view); a ``moe`` config with
``first_k_dense`` has a second stack, ``dense_layers``, that runs first,
and a ``hybrid`` config has the unstacked ``shared`` block. ``forward``
and ``loss_fn`` also take either stack as a list of per-layer dicts
(``split_layers``), which is how the train step gives autograd one leaf
per layer. ``lax.scan`` and ``fori_loop`` over the layers become Python
loops; each layer's weights are cast to the compute dtype inside the
layer (every stacked leaf has ndim >= 2, so the JAX package's
``cast_params`` casts them all, the stacked 1-D SSM vectors too), the
shared block once by ``cast_params``' ndim rule (its norms stay
float32). While autograd records, ``cfg.remat`` puts each layer, with
the shared application that follows it, under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` per
layer; ``remat_group`` its two-level form), so a layer's activations
and bf16 weights are recomputed in the backward; under
``torch.no_grad`` (serving) nothing is checkpointed. The GQA attention
inside ``forward`` (the shared block's too, which always attends
causally) is ``cfg.attention_impl``: ``"flash"`` runs the
flash-attention kernel (``kernels/flash_attention``; it has no backward
and raises under autograd), ``"dense"`` the materialised softmax; MLA
always attends densely over its latent, as the reference's does.
``decode_step`` always attends densely over its cache, runs MoE layers
dropless (capacity factor E), as the JAX package's does, and steps each
Mamba2 layer's state and conv windows in place.

Inputs by frontend: ``"none"`` embeds ``batch["tokens"]``; ``"patch"``
(vlm) puts ``batch["patches"]`` (B, P, d) before the embedded tokens and
``loss_fn`` scores the text positions only; ``"frame"`` (audio) takes
``batch["frames"]`` (B, S, d) as the hidden states.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from .attention import (gqa_apply, gqa_decode, gqa_init, gqa_init_cache,
                        mla_apply, mla_decode, mla_init, mla_init_cache)
from .layers import (chunked_softmax_xent, dense_init, dtype_of, embed_init,
                     mlp_apply, mlp_init, onehot_embed_lookup, rms_norm)
from .mamba2 import (mamba2_apply, mamba2_decode, mamba2_init,
                     mamba2_init_cache)
from .moe import aux_load_balance_loss, moe_apply, moe_init

Params = dict
MOE_AUX_COEF = 0.01
# the layer stacks, in the order forward and decode_step run them
STACKS = ("dense_layers", "layers")


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: views of each leaf's slice ``i``."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _depth(stack: dict | list) -> int:
    if isinstance(stack, list):
        return len(stack)
    return tree_leaves(stack)[0].shape[0]


def split_layers(params: Params) -> Params:
    """``params`` with each layer stack (``layers``, ``dense_layers``) as
    a list of per-layer dicts (views of the stacked tensors; the other
    entries as they are)."""
    return {k: [_layer(v, i) for i in range(_depth(v))]
            if k in STACKS and isinstance(v, dict) else v
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
               device: torch.device, lead: tuple[int, ...]) -> dict:
    if cfg.use_mla:
        return mla_init(gen, cfg, dtype, device, lead)
    return gqa_init(gen, cfg, dtype, device, lead)


def _layer_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                device: torch.device, n: int, moe_layer: bool) -> Params:
    """A stack of ``n`` blocks: Mamba2 (``ssm``, ``hybrid``), else
    attention, each with an MoE FFN or an MLP."""
    ones = torch.ones((n, cfg.d_model), dtype=torch.float32, device=device)
    if cfg.family in ("ssm", "hybrid"):
        return {"norm": ones,
                "mixer": mamba2_init(gen, cfg, dtype, device, (n,))}
    p = {"attn_norm": ones, "mlp_norm": ones.clone(),
         "attn": _attn_init(gen, cfg, dtype, device, (n,))}
    if moe_layer:
        p["moe"] = moe_init(gen, cfg, dtype, device, (n,))
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
                            device, lead=(n,))
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device: torch.device | str | None = None) -> Params:
    """Random params in ``cfg.param_dtype`` (the MoE router in float32)
    on ``device`` (``None``: the card), drawn from ``gen``, which must
    live on that device."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_size, d, dtype, device),
        "final_norm": torch.ones((d,), dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.vocab_size, dtype,
                                       device)
    moe = cfg.family == "moe"
    if moe and cfg.first_k_dense:
        params["dense_layers"] = _layer_init(gen, cfg, dtype, device,
                                             cfg.first_k_dense, False)
        params["layers"] = _layer_init(
            gen, cfg, dtype, device, cfg.num_layers - cfg.first_k_dense,
            True)
    else:
        params["layers"] = _layer_init(gen, cfg, dtype, device,
                                       cfg.num_layers, moe)
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        d2 = 2 * d
        ones = torch.ones((d2,), dtype=torch.float32, device=device)
        params["shared"] = {
            "attn_norm": ones,
            "attn": gqa_init(gen, cfg, dtype, device, d_in=d2, d_out=d2),
            "mlp_norm": ones.clone(),
            "mlp": mlp_init(gen, d2, cfg.d_ff, cfg.mlp_type, dtype, device),
            "out_proj": dense_init(gen, d2, d, dtype, device)}
    return params


def cast_params(params: Params, cfg: ArchConfig) -> Params:
    """Cast matmul weights to compute dtype (norm vectors stay f32; as in
    the JAX package, "matmul weight" means ndim >= 2, so the stacked
    per-layer norms and the stacked MoE router are cast too). Tensors
    already in that dtype are returned as they are, not copied."""
    cd = dtype_of(cfg.compute_dtype)
    return tree_map(lambda a: a.to(cd) if a.dim() >= 2 else a, params)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _dense_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm attention (GQA or MLA), then the MoE FFN where the layer
    has one, else the MLP."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    attend = mla_apply if cfg.use_mla else gqa_apply
    x = x + attend(p["attn"], cfg, h, positions, causal=cfg.causal)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if "moe" in p:
        return x + moe_apply(p["moe"], cfg, h)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_type)


def _ssm_block(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return x + mamba2_apply(p["mixer"], cfg,
                            rms_norm(x, p["norm"], cfg.norm_eps))


def _shared_block(ps: dict, cfg: ArchConfig, x: torch.Tensor,
                  emb0: torch.Tensor, positions: torch.Tensor
                  ) -> torch.Tensor:
    """Zamba2's shared attention + MLP block on [x ; emb0] (2 · d wide,
    always causal), projected back to d and added to x."""
    h = torch.cat([x, emb0], dim=-1)
    a = rms_norm(h, ps["attn_norm"], cfg.norm_eps)
    h = h + gqa_apply(ps["attn"], cfg, a, positions, causal=True)
    m = rms_norm(h, ps["mlp_norm"], cfg.norm_eps)
    h = h + mlp_apply(ps["mlp"], m, cfg.mlp_type)
    return x + h @ ps["out_proj"]


def _applies_shared(cfg: ArchConfig, i: int) -> bool:
    """Whether the shared block follows layer ``i`` (``hybrid``)."""
    every = cfg.shared_attn_every
    return cfg.family == "hybrid" and every > 0 and i % every == every - 1


def _embed_inputs(params: Params, cfg: ArchConfig,
                  batch: dict) -> torch.Tensor:
    """The hidden states that enter the first layer, in compute dtype:
    the frames (``frame``), or the token path (an embedding gather, or
    with ``cfg.onehot_embed`` the chunked one-hot matmul: the same
    values) with the patches before it (``patch``)."""
    cd = dtype_of(cfg.compute_dtype)
    if cfg.frontend == "frame":
        return batch["frames"].to(cd)
    embed = params["embed"].to(cd)
    if cfg.onehot_embed:
        x = onehot_embed_lookup(embed, batch["tokens"], cfg.ce_chunk, cd)
    else:
        x = embed[batch["tokens"].long()]
    if cfg.frontend == "patch" and "patches" in batch:
        x = torch.cat([batch["patches"].to(cd), x], dim=1)
    return x


def forward(params: Params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """batch["tokens"]: (B, S) integer (``batch["frames"]`` for the
    ``frame`` frontend; ``batch["patches"]`` before the tokens for
    ``patch``). Returns the final hidden states (B, S', D) in compute
    dtype; S' includes the patches."""
    cd = dtype_of(cfg.compute_dtype)
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    split = split_layers(params)
    emb0 = x
    shared = cast_params(params["shared"], cfg) if "shared" in params \
        else None
    # every stacked layer leaf has ndim >= 2, so cast_params casts them
    # all; here one layer at a time, inside the checkpointed region

    def layer(x, p, i):
        p = tree_map(lambda a: a.to(cd), p)
        if "mixer" not in p:
            return _dense_block(p, cfg, x, positions)
        x = _ssm_block(p, cfg, x)
        if _applies_shared(cfg, i):
            x = _shared_block(shared, cfg, x, emb0, positions)
        return x

    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))

    def run(x, group, start):
        for i, p in enumerate(group, start):
            x = checkpoint(layer, x, p, i, use_reentrant=False) if remat \
                else layer(x, p, i)
        return x

    def run_stack(x, stack):
        g = cfg.remat_group
        if remat and g > 1 and len(stack) % g == 0:
            # two-level checkpointing: only group boundaries are kept; a
            # group's layers are recomputed, each checkpointed again,
            # during that group's backward
            for k in range(0, len(stack), g):
                x = checkpoint(run, x, stack[k:k + g], k,
                               use_reentrant=False)
            return x
        return run(x, stack, 0)

    for name in STACKS:
        if name in split:
            x = run_stack(x, split[name])
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_head_weight(params: Params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _first_moe_params(params: Params) -> dict:
    """The MoE params of the first layer of ``layers``, as they are (the
    router uncast)."""
    layers = params["layers"]
    if isinstance(layers, list):
        return layers[0]["moe"]
    return _layer(layers["moe"], 0)


def loss_fn(params: Params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy against ``batch["labels"]`` (B, S)
    over the text positions: the forward pass, then the chunked
    cross-entropy over ``cfg.ce_chunk``-token blocks with the head in
    compute dtype; for the ``moe`` family plus ``MOE_AUX_COEF`` times
    the load-balance loss of the first MoE layer's router (uncast) on
    the final hidden states. Differentiable (``loss.backward()``)."""
    x = forward(params, cfg, batch)
    if cfg.frontend == "patch" and "patches" in batch:
        x = x[:, batch["patches"].shape[1]:]     # score text positions only
    w = lm_head_weight(params, cfg).to(dtype_of(cfg.compute_dtype))
    loss = chunked_softmax_xent(x, w, batch["labels"], cfg.ce_chunk)
    if cfg.family == "moe":
        aux = aux_load_balance_loss(_first_moe_params(params), cfg, x)
        loss = loss + MOE_AUX_COEF * aux
    return loss


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device | str | None = None) -> Any:
    """Zeroed cache in compute dtype, one entry a layer stack: GQA
    {"k", "v"}, each (L, B, max_len, KV, hd), or with MLA {"latent"
    (L, B, max_len, r), "k_rope" (L, B, max_len, 1, dr)}; a ``moe``
    config with ``first_k_dense`` has ``dense_layers`` beside
    ``layers``. Mamba2 layers (``ssm``, ``hybrid``) hold {"ssm" (L, B,
    H, P, N) float32, "conv_x" / "conv_b" / "conv_c" (L, B, w-1, ch)};
    a ``hybrid`` config adds ``shared``, a GQA cache for each of the
    L // shared_attn_every applications of its shared block."""
    device = resolve_device(device)
    cd = dtype_of(cfg.compute_dtype)
    if cfg.family in ("ssm", "hybrid"):
        out = {"layers": mamba2_init_cache(cfg, batch, cd, device,
                                           lead=(cfg.num_layers,))}
        napp = sum(_applies_shared(cfg, i) for i in range(cfg.num_layers))
        if napp:
            out["shared"] = gqa_init_cache(cfg, batch, max_len, cd, device,
                                           lead=(napp,),
                                           d_in=2 * cfg.d_model)
        return out
    make = mla_init_cache if cfg.use_mla else gqa_init_cache
    dense = cfg.first_k_dense if cfg.family == "moe" else 0
    out = {"layers": make(cfg, batch, max_len, cd, device,
                          lead=(cfg.num_layers - dense,))}
    if dense:
        out["dense_layers"] = make(cfg, batch, max_len, cd, device,
                                   lead=(dense,))
    return out


def _shared_decode(ps: dict, cfg: ArchConfig, x: torch.Tensor,
                   emb0: torch.Tensor, cache: dict, pos: int
                   ) -> torch.Tensor:
    """The shared block at one position, against its application's GQA
    cache (written in place)."""
    h = torch.cat([x, emb0], dim=-1)
    a = rms_norm(h, ps["attn_norm"], cfg.norm_eps)
    att, _ = gqa_decode(ps["attn"], cfg, a, cache, pos)
    h = h + att
    m = rms_norm(h, ps["mlp_norm"], cfg.norm_eps)
    h = h + mlp_apply(ps["mlp"], m, cfg.mlp_type)
    return x + h @ ps["out_proj"]


def _layer_decode(pl: dict, cfg: ArchConfig, x: torch.Tensor, cl: dict,
                  pos: int) -> torch.Tensor:
    """One layer at one position: a Mamba2 step, or attention then the
    MoE FFN (dropless: decode batches are tiny) or the MLP."""
    if "mixer" in pl:
        y, _ = mamba2_decode(pl["mixer"], cfg,
                             rms_norm(x, pl["norm"], cfg.norm_eps), cl)
        return x + y
    attend = mla_decode if cfg.use_mla else gqa_decode
    h = rms_norm(x, pl["attn_norm"], cfg.norm_eps)
    a, _ = attend(pl["attn"], cfg, h, cl, pos)
    x = x + a
    h = rms_norm(x, pl["mlp_norm"], cfg.norm_eps)
    if "moe" in pl:
        return x + moe_apply(pl["moe"], cfg, h,
                             capacity_factor=float(cfg.num_experts))
    return x + mlp_apply(pl["mlp"], h, cfg.mlp_type)


def decode_step(params: Params, cfg: ArchConfig, cache: Any,
                tokens: torch.Tensor, pos: int | torch.Tensor
                ) -> tuple[torch.Tensor, Any]:
    """One serving step: tokens (B,1) integer, pos the write slot.
    Returns (logits (B,1,V) float32, cache).

    Each layer writes its new cache entries into ``cache`` in place (a
    view of the stacked tensors), so the returned cache is the one
    passed in; it holds the values the JAX package's returned cache
    holds. In a ``hybrid`` config the shared block's ``k``-th
    application reads and writes ``cache["shared"]`` entry ``k``, on
    [hidden ; the current token's embedding]."""
    params = cast_params(params, cfg)
    pos = int(pos)
    x = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    emb0 = x
    for name in STACKS:
        if name not in params:
            continue
        layers, caches = params[name], cache[name]
        for i in range(_depth(layers)):
            x = _layer_decode(_layer(layers, i), cfg, x, _layer(caches, i),
                              pos)
            if _applies_shared(cfg, i):
                x = _shared_decode(
                    params["shared"], cfg, x, emb0,
                    _layer(cache["shared"], i // cfg.shared_attn_every),
                    pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ lm_head_weight(params, cfg)).float()
    return logits, cache
