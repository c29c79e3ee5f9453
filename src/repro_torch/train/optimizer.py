"""AdamW with warmup-cosine schedule (self-contained, fp32 states).

The port of the JAX package's ``train/optimizer.py``: the same config,
schedule, clipping, bias corrections and decay rule, op for op in
float32. One deliberate difference: ``adamw_update`` updates params,
``m`` and ``v`` **in place** (under ``torch.no_grad``, a slice at a
time) and returns the same tensors, where the reference returns new
trees — at Qwen3-4B's width another copy of params, ``m`` and ``v``
would need 48 GB more than the card's 80 GB holds beside them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..tree import tree_leaves, tree_map

# elements of one in-place update slice: bounds the update's temporaries
# (three float32 slices) however large a stacked leaf is
_SLICE = 1 << 24


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor, any integer or float
    dtype) in float32: linear warmup, then cosine down to ``min_lr``."""
    step = step.float()
    warm = cfg.peak_lr * step / max(1, cfg.warmup_steps)
    frac = torch.clip((step - cfg.warmup_steps)
                      / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) \
        * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> dict:
    """float32 zeros ``m`` and ``v`` shaped as ``params`` (on each leaf's
    device) and an int32 ``step`` of 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32. Each leaf's
    squares are summed by ``torch.sum`` a ``_SLICE`` at a time (a
    cascade on the CPU, a tree on the card: within 1e-7 of the exact sum,
    as the reference's ``jnp.sum``); a BLAS dot sums into one float32
    accumulator a thread, 8e-5 off at 2^25 elements on one thread."""
    total = None
    for g in tree_leaves(tree):
        for s in g.float().reshape(-1).split(_SLICE):
            sq = torch.sum(s * s)
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _slices(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    return t.view(-1).split(_SLICE)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Any, grads: Any,
                 state: dict) -> tuple[Any, dict, dict]:
    """One AdamW step: clip by the global norm, update ``m`` and ``v``,
    bias-correct, add decoupled decay on every leaf with ``ndim >= 2``
    (the stacked per-layer norm vectors too, as in the reference), step
    the params. Params, ``m`` and ``v`` are written in place (each must
    be contiguous) and returned with a new ``step``; metrics hold
    ``grad_norm`` and ``lr`` (0-dim float32 tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def update(p, g, m, v):
        decay = p.dim() >= 2
        for ps, gs, ms, vs in zip(*map(_slices, (p, g, m, v))):
            g32 = gs.float() * scale
            ms.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
            vs.mul_(cfg.b2).add_(g32 * (1 - cfg.b2) * g32)
            delta = ms / b1c
            delta.div_(torch.sqrt(vs / b2c).add_(cfg.eps))
            if decay:
                delta.add_(cfg.weight_decay * ps.float())
            ps.copy_(ps.float() - lr * delta)

    # matched by key: a tree made here and one carried from the JAX
    # package order their dicts differently
    tree_map(update, params, grads, state["m"], state["v"])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
