"""Storage-less stand-ins for every model input — the dry run's
zero-allocation contract.

The port of the JAX package's ``launch/specs.py``. Where the reference
returns ``jax.ShapeDtypeStruct`` trees from ``jax.eval_shape``, these
return trees of fake tensors: the port's own ``init_params`` /
``init_cache`` / ``init_opt_state`` run under a ``FakeTensorMode``,
which gives every tensor its shape and dtype and allocates nothing.
The fake tensors report the host device, so whatever runs on them
takes the plain PyTorch versions of the kernels.

Each function joins the fake mode that is active, or opens its own. A
run that mixes fake tensors of two modes fails, so a caller that goes
on to run a step on the specs (``launch/dryrun.py``) enters one mode
around both.
"""
from __future__ import annotations

import contextlib

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.base import ArchConfig, ShapeSpec
from ..models.layers import dtype_of
from ..models.lm import init_cache, init_params
from ..train.optimizer import init_opt_state
from ..tree import tree_map

# the device the fake tensors report
HOST = torch.device("cpu")


def fake_mode():
    """The active ``FakeTensorMode`` (entered again: a no-op), or a new
    one."""
    mode = detect_fake_mode()
    return contextlib.nullcontext() if mode is not None \
        else FakeTensorMode()


def _sds(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=HOST)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    with fake_mode():
        out = {"labels": _sds((b, s), torch.int32)}
        if cfg.frontend == "frame":
            out["frames"] = _sds((b, s, cfg.d_model), torch.float32)
        else:
            out["tokens"] = _sds((b, s), torch.int32)
        if cfg.frontend == "patch":
            out["patches"] = _sds((b, cfg.num_patches, cfg.d_model),
                                  torch.float32)
    return out


def decode_specs(cfg: ArchConfig, shape: ShapeSpec
                 ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """(cache tree, tokens, pos) for serve_step."""
    b, s = shape.global_batch, shape.seq_len
    with fake_mode():
        return (init_cache(cfg, b, s, HOST), _sds((b, 1), torch.int32),
                _sds((), torch.int32))


def param_specs(cfg: ArchConfig) -> dict:
    with fake_mode():
        return init_params(cfg, torch.Generator(), HOST)


def opt_specs(params_shape: dict) -> dict:
    with fake_mode():
        return init_opt_state(params_shape)


def serving_param_specs(cfg: ArchConfig) -> dict:
    """Serving holds matmul weights in the compute dtype (bf16)."""
    cd = dtype_of(cfg.compute_dtype)
    with fake_mode():
        return tree_map(lambda a: _sds(tuple(a.shape), cd)
                        if a.dim() >= 2 else a, param_specs(cfg))


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Everything the step consumes, keyed by role."""
    with fake_mode():
        if shape.kind == "train":
            out = {"params": param_specs(cfg)}
            out["opt"] = opt_specs(out["params"])
            out["batch"] = batch_specs(cfg, shape)
        elif shape.kind == "prefill":
            out = {"params": serving_param_specs(cfg)}
            out["batch"] = batch_specs(cfg, shape)
        else:  # decode
            out = {"params": serving_param_specs(cfg)}
            cache, tokens, pos = decode_specs(cfg, shape)
            out["cache"], out["tokens"], out["pos"] = cache, tokens, pos
    return out
