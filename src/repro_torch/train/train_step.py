"""train_step / eval_step / serve_step / prefill_step builders.

The port of the JAX package's ``train/train_step.py``. PyTorch runs
eagerly, so a builder returns the plain function (the JAX package's
callers jit it). ``make_train_step`` closes over (cfg, opt_cfg,
n_micro): the batch is split into ``n_micro`` microbatches whose
gradients accumulate in float32 (the optimizer steps once), and
``grad_transform`` (gradient compression, say) sees the gradients
before the optimizer does. The reference's ``grad_shardings`` (a ZeRO-3
layout for the accumulator on a device mesh) has no counterpart: there
is no mesh.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..configs.base import ArchConfig
from ..models.lm import (STACKS, _depth, _layer, cast_params, decode_step,
                         forward, lm_head_weight, loss_fn)
from ..tree import tree_leaves, tree_map
from .optimizer import OptimizerConfig, adamw_update


def _grad_leaves(params: dict, grads: dict) -> dict:
    """Leaves for autograd that alias ``params``, each with ``.grad`` set
    to its slot in ``grads`` (same shapes and dtypes), so that the
    backward accumulates into ``grads`` in place. Each stacked layer
    tree (``layers``, and ``dense_layers`` where the config has one)
    becomes one leaf per layer (a list, as ``forward`` takes it): a
    backward through slices of one stacked leaf would allocate a
    full-size gradient for every layer. Other trees (a ``hybrid``
    config's ``shared`` block) stay one leaf a tensor: autograd sums
    their gradients over every use."""
    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t

    def tree(p, g):
        return {k: tree(p[k], g[k]) if isinstance(p[k], dict)
                else leaf(p[k], g[k]) for k in p}

    out = {}
    for k, p in params.items():
        if k in STACKS:
            out[k] = [tree(_layer(p, i), _layer(grads[k], i))
                      for i in range(_depth(p))]
        else:
            out[k] = tree(p, grads[k]) if isinstance(p, dict) \
                else leaf(p, grads[k])
    return out


def value_and_grad(params: dict, cfg: ArchConfig,
                   batch: dict) -> tuple[torch.Tensor, dict]:
    """(loss, grads) of ``loss_fn`` at ``params``: grads has params'
    keys, shapes and dtypes; the loss is detached."""
    grads = tree_map(torch.zeros_like, params)
    with torch.enable_grad():
        loss = loss_fn(_grad_leaves(params, grads), cfg, batch)
        loss.backward()
    return loss.detach(), grads


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig,
                    n_micro: int = 1,
                    grad_transform: Callable[[Any], Any] | None = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). Params and the optimizer state are updated in place
    (``adamw_update``) and returned; metrics hold ``loss``,
    ``grad_norm`` and ``lr`` (0-dim float32 tensors on the params'
    device). The batch's tensors are on that device."""

    def split_micro(batch):
        return [{k: v.reshape(n_micro, v.shape[0] // n_micro,
                              *v.shape[1:])[i] for k, v in batch.items()}
                for i in range(n_micro)]

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = value_and_grad(params, cfg, batch)
        else:
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for mb in split_micro(batch):
                l, g = value_and_grad(params, cfg, mb)
                loss = loss + l
                tree_map(lambda acc, x: acc.add_(x.float()), grads, g)
                del g
            loss = loss / n_micro
            for g in tree_leaves(grads):
                g.div_(n_micro)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        metrics = dict(metrics, loss=loss)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ArchConfig):
    """eval_step(params, batch) -> loss (0-dim float32), no gradient."""
    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(params, cfg, batch)
    return eval_step


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
