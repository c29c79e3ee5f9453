"""Mixture-of-Experts layer (OLMoE / DeepSeek-V2 style).

The port of the JAX package's ``models/moe.py``. Token dispatch is the
sort-based capacity scheme: the (tokens × top-k) assignments are sorted
by expert id (a stable sort, as ``jnp.argsort``) and packed into an
(E, C) buffer, every expert runs a dense (C, d)→(C, f)→(C, d) SwiGLU FFN
(one batched matmul over the stacked experts, the reference's
``jax.vmap``), and results come back weighted by the router gate. Tokens
beyond an expert's capacity are dropped (they write to a trash row); the
router is softmax-then-top-k with normalised gates, plus shared experts
that every token visits (DeepSeek-V2).

Differences, both deliberate:

* the combine sums each token's k contributions in float32 in one fixed
  order, ascending expert id (the order in which the reference's
  scatter-add meets them), with k gathers and adds instead of a
  scatter-add, so it gives the same bits on every run and device (a
  CUDA ``index_add_`` adds in whatever order its atomics land);
* ``_moe_apply_shardmap``, the reference's expert-parallel path under a
  JAX device mesh (``shard_map`` plus a ``psum`` over the model axis),
  is not ported: the port has no activation-sharding context, so
  ``moe_apply`` always runs the global dispatch (``_moe_apply_global``).
  ``_dispatch_ffn`` keeps the local-expert form that path calls (ids
  outside [0, e) are dropped).

Each stage runs under a ``torch.profiler.record_function`` range
(``moe/router``, ``moe/dispatch``, ``moe/experts``, ``moe/combine``,
``moe/shared``) so that a profile splits a layer's time by stage.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..configs.base import ArchConfig
from .layers import dense_init, mlp_apply


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             device: torch.device, lead: tuple[int, ...] = ()) -> dict:
    """The router (d, E) in float32 whatever ``dtype`` is, the experts
    stacked (E, d, f) / (E, f, d), and with ``num_shared_experts`` a
    shared SwiGLU MLP of width f · num_shared_experts."""
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    e = cfg.num_experts

    def stack(d_in, d_out):
        return dense_init(gen, d_in, d_out, dtype, device, (*lead, e))

    p = {"router": dense_init(gen, d, e, torch.float32, device, lead),
         "wi": stack(d, f), "wg": stack(d, f), "wo": stack(f, d)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"wi": dense_init(gen, d, fs, dtype, device, lead),
                       "wg": dense_init(gen, d, fs, dtype, device, lead),
                       "wo": dense_init(gen, fs, d, dtype, device, lead)}
    return p


def route(router: torch.Tensor, tokens: torch.Tensor,
          k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(gates (T, k) float32, expert ids (T, k) int64): softmax of the
    float32 router logits, top-k (ties to the lower id, as
    ``jax.lax.top_k``), gates normalised to sum to 1."""
    logits = tokens.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    return gates / torch.sum(gates, dim=-1, keepdim=True), ids


def capacity(capacity_factor: float, t: int, k: int, e: int) -> int:
    """Slots an expert keeps: min(t·k, max(k, ⌊cf·t·k/e⌋)), in the
    reference's order of float operations."""
    return min(t * k, max(k, int(capacity_factor * t * k / e)))


def dispatch_plan(expert_ids: torch.Tensor, e: int, cap: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing's integer outputs, as the reference computes them:
    ``order`` (the stable sort of the flat (T·k) assignments by expert,
    ids outside [0, e) sorted last), ``keep`` (per sorted assignment:
    a local expert and within its capacity) and ``slot`` (its row of the
    (e·cap + 1, d) buffer; dropped assignments get the trash row
    e·cap)."""
    flat = expert_ids.reshape(-1)
    valid = (flat >= 0) & (flat < e)
    sort_key = torch.where(valid, flat, torch.full_like(flat, e))
    order = torch.argsort(sort_key, stable=True)
    sorted_expert = sort_key[order]
    first = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    pos = torch.arange(flat.numel(), device=flat.device) - first
    keep = (sorted_expert < e) & (pos < cap)
    slot = torch.where(keep, sorted_expert * cap + pos,
                       torch.full_like(pos, e * cap))
    return order, keep, slot


def _dispatch_ffn(tokens: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                  wo: torch.Tensor, expert_ids: torch.Tensor,
                  gate_vals: torch.Tensor, e: int, k: int, cap: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """Sort-based capacity dispatch over ``e`` (local) experts; returns
    the gate-weighted expert outputs (T, d) in float32. expert_ids
    entries outside [0, e) are dropped (non-local)."""
    t, d = tokens.shape
    with record_function("moe/dispatch"):
        order, keep, slot = dispatch_plan(expert_ids, e, cap)
        sorted_token = order // k
        buf = torch.zeros((e * cap + 1, d), dtype=dtype,
                          device=tokens.device)
        buf[slot] = tokens[sorted_token].to(dtype)
        expert_in = buf[:e * cap].reshape(e, cap, d)
    with record_function("moe/experts"):
        expert_out = mlp_apply({"wi": wi, "wg": wg, "wo": wo}, expert_in,
                               "swiglu")
    with record_function("moe/combine"):
        flat_out = expert_out.reshape(e * cap, d)
        # sorted position of each flat assignment; a token's positions in
        # ascending order meet its experts in ascending id
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.numel(), device=order.device)
        at = torch.sort(rank.view(t, k), dim=1).values
        rows = torch.where(keep, slot, torch.zeros_like(slot))
        gate = gate_vals.reshape(-1)[order].to(dtype)
        out = torch.zeros((t, d), dtype=torch.float32, device=tokens.device)
        for j in range(k):
            a = at[:, j]
            c = flat_out[rows[a]] * gate[a, None]
            out = out + torch.where(keep[a, None], c,
                                    torch.zeros_like(c)).float()
    return out


def moe_apply(p: dict, cfg: ArchConfig, x: torch.Tensor,
              capacity_factor: float | None = None) -> torch.Tensor:
    """Dispatch + expert FFN + combine over x (B, S, d); the result in
    x's dtype. ``capacity_factor`` defaults to the config's (decode
    passes ``float(num_experts)``: dropless)."""
    return _moe_apply_global(p, cfg, x, capacity_factor)


def _moe_apply_global(p: dict, cfg: ArchConfig, x: torch.Tensor,
                      capacity_factor: float | None = None) -> torch.Tensor:
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = x.reshape(b * s, d)
    with record_function("moe/router"):
        gates, ids = route(p["router"], tokens, k)
    cap = capacity(capacity_factor, tokens.shape[0], k, e)
    out = _dispatch_ffn(tokens, p["wi"], p["wg"], p["wo"], ids, gates, e,
                        k, cap, x.dtype).to(x.dtype)
    if "shared" in p:
        with record_function("moe/shared"):
            out = out + mlp_apply(p["shared"], tokens, "swiglu")
    return out.reshape(b, s, d)


def aux_load_balance_loss(p: dict, cfg: ArchConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (importance × load)."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    probs = torch.softmax(tokens.float() @ p["router"].float(), dim=-1)
    _, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    load = torch.nn.functional.one_hot(ids, cfg.num_experts).float() \
        .mean(dim=(0, 1))
    importance = probs.mean(dim=0)
    return cfg.num_experts * torch.sum(load * importance)
