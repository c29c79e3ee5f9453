"""serve_step / prefill_step builders.

The serving half of the JAX package's ``train/train_step.py``:
``make_serve_step`` and ``make_prefill_step``. PyTorch runs eagerly, so
a builder returns the plain function (the JAX package's callers jit
it). ``make_train_step`` waits for the training slice (ROADMAP queue 1
item 10).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models.lm import cast_params, decode_step, forward, lm_head_weight


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, tokens, pos) -> (logits, cache)."""
    def serve_step(params, cache, tokens, pos):
        return decode_step(params, cfg, cache, tokens, pos)
    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """prefill_step(params, batch) -> last-position logits (B, 1, V)
    float32: the full forward, then the LM head on the last position
    (serving fills the KV cache with decode_step after)."""
    def prefill_step(params, batch) -> torch.Tensor:
        x = forward(params, cfg, batch)
        w = lm_head_weight(cast_params(params, cfg), cfg)
        return (x[:, -1:] @ w).float()
    return prefill_step
