"""Activation-sharding context.

The port of the JAX package's ``distributed/act_sharding.py``. The
model code is mesh-agnostic; a launcher installs an
``ActivationSharding`` describing where batch / sequence / hidden live,
and ``constrain`` pins activations at block boundaries. The context is
thread-local, as in the reference.

Each ``constrain*`` returns its input's values unchanged, which is what
``jax.lax.with_sharding_constraint`` means for values. A plain tensor
comes back as it is; a ``DTensor`` is redistributed to the placements
of the spec the reference would pin (chosen by the same divisibility
tests), on the tensor's own ``DeviceMesh``, whose dims are the
context's mesh axes in order.

The port's model code calls none of them: the one reader of the context
is ``models/moe.py::moe_apply``, which takes the expert-parallel path
while a context with both axes is installed.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from .sharding import PartitionSpec as P, placements

_STATE = threading.local()


@dataclass(frozen=True)
class ActivationSharding:
    mesh: object                         # AbstractMesh (names and sizes)
    batch_axes: tuple | str | None       # e.g. ("pod", "data")
    model_axis: str | None = "model"
    seq_axes: tuple | str | None = None  # set for sequence parallelism

    def spec_hidden(self, ndim: int) -> P:
        """(B, S, D)-style activations: batch sharded, rest replicated."""
        return P(self.batch_axes, *([None] * (ndim - 1)))

    def spec_seq(self, ndim: int) -> P:
        """Sequence-parallel regions: (B, S, D) with S sharded."""
        return P(self.batch_axes, self.seq_axes or self.model_axis,
                 *([None] * (ndim - 2)))


@contextlib.contextmanager
def activation_sharding(ctx: ActivationSharding | None):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def current() -> ActivationSharding | None:
    return getattr(_STATE, "ctx", None)


def _size(mesh, axes) -> int:
    names = (axes,) if isinstance(axes, str) else axes
    return math.prod(mesh.shape[a] for a in names)


def _pin(x: torch.Tensor, ctx: ActivationSharding, spec: P) -> torch.Tensor:
    """``x`` laid out as ``spec`` on the context's mesh: a DTensor is
    redistributed, anything else returned as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(ctx.mesh, spec))


def constrain_tp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Shard dimension ``dim`` over the model axis (batch over dp axes) —
    the explicit tensor-parallel pin for MLP hidden / attention heads."""
    ctx = current()
    if ctx is None or ctx.batch_axes is None or ctx.model_axis is None:
        return x
    if x.shape[dim] % ctx.mesh.shape[ctx.model_axis] != 0:
        return x
    spec = [None] * x.dim()
    spec[0] = ctx.batch_axes
    spec[dim] = ctx.model_axis
    return _pin(x, ctx, P(*spec))


def constrain_rows(x: torch.Tensor) -> torch.Tensor:
    """Shard dim 0 (a token-major flat dim) over the data axes — the pin
    of the MoE dispatch intermediates."""
    ctx = current()
    if ctx is None or ctx.batch_axes is None:
        return x
    if x.shape[0] % _size(ctx.mesh, ctx.batch_axes) != 0:
        return x
    return _pin(x, ctx, P(ctx.batch_axes, *([None] * (x.dim() - 1))))


def constrain_matrix(x: torch.Tensor) -> torch.Tensor:
    """Pin a (D_in, D_out) matrix cotangent to the FSDP×TP weight layout
    (the reference uses it on manually computed weight grads, e.g. the
    chunked-CE dW)."""
    ctx = current()
    if ctx is None or ctx.batch_axes is None or x.dim() != 2:
        return x
    fsdp = ctx.batch_axes
    d0 = fsdp if x.shape[0] % _size(ctx.mesh, fsdp) == 0 else None
    d1 = ctx.model_axis if (ctx.model_axis and x.shape[1]
                            % ctx.mesh.shape[ctx.model_axis] == 0) else None
    return _pin(x, ctx, P(d0, d1))


def constrain(x: torch.Tensor, kind: str = "hidden") -> torch.Tensor:
    """Pin an activation to the installed layout (no-op when unset).

    kind="seq" shards the sequence dim over the model axis (sequence
    parallelism); it falls back to the batch-only layout when S doesn't
    divide.
    """
    ctx = current()
    if ctx is None or ctx.batch_axes is None:
        return x
    if kind == "seq" and x.dim() >= 3:
        if x.shape[1] % _size(ctx.mesh, ctx.seq_axes or ctx.model_axis) == 0:
            return _pin(x, ctx, ctx.spec_seq(x.dim()))
    return _pin(x, ctx, ctx.spec_hidden(x.dim()))
