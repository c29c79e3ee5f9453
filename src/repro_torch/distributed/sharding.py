"""Sharding rules: FSDP (ZeRO-3) + TP + EP + SP over the production mesh.

The port of the JAX package's ``distributed/sharding.py``, rule for
rule. Axes: ``pod`` (multi-pod DP), ``data`` (DP/FSDP), ``model``
(TP/EP). Parameters are sharded over *both* the fsdp axes (ZeRO-3) and
the model axis (tensor/expert parallel); a dimension is only sharded
when its size is divisible by the axis extent (``_maybe``), so every
assigned architecture takes the same rules. Activations: batch over
(pod, data); decode caches shard sequence over ``model``
(sequence-parallel KV) and batch over the data axes — for
global_batch=1 long-context decode the sequence dim takes every axis
instead.

A spec is the port's ``PartitionSpec``: a tuple with one entry a tensor
dim, each ``None``, an axis name, or a tuple of axis names. The mesh is
anything with ``axis_names`` and a ``shape`` dict (``AbstractMesh``).
``to_placements`` turns a spec tree into DTensor placements, the
reference's ``to_named``.
"""
from __future__ import annotations

import math
from typing import Any

from torch.distributed.tensor import Replicate, Shard

from ..configs.base import ArchConfig, ShapeSpec
from ..tree import tree_map

MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: one entry a tensor dim (``None``, an
    axis name, or a tuple of axis names), as ``jax.sharding.PartitionSpec``,
    which also stores a one-name tuple as the name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return int(math.prod(mesh.shape[a] for a in axes))


def _maybe(mesh, axes, size: int):
    """axes if size divides evenly, else None (replicate that dim)."""
    if axes is None:
        return None
    n = axis_size(mesh, axes)
    return axes if (n > 0 and size % n == 0) else None


def _pspec_for_param(mesh, path: str, shape: tuple[int, ...],
                     stacked: bool) -> P:
    """Sharding for one parameter leaf. ``stacked`` = leading layer dim
    present (never sharded)."""
    fsdp = dp_axes(mesh)
    fsdp = fsdp if len(fsdp) > 1 else fsdp[0] if fsdp else None
    dims = shape[1:] if stacked else shape
    lead = (None,) if stacked else ()

    def spec(*entries):
        return P(*lead, *entries)

    if len(dims) <= 1:
        return spec(*([None] * len(dims)))

    name = path.split("/")[-1]
    d0, d1 = dims[0], dims[-1]

    if name == "embed":                      # (V, D)
        return spec(_maybe(mesh, MODEL_AXIS, d0), _maybe(mesh, fsdp, d1))
    if name == "lm_head":                    # (D, V)
        return spec(_maybe(mesh, fsdp, d0), _maybe(mesh, MODEL_AXIS, d1))
    if len(dims) == 3:                       # MoE expert stacks (E, d, f)
        return spec(_maybe(mesh, MODEL_AXIS, dims[0]),
                    _maybe(mesh, fsdp, dims[1]), None)
    if name in ("wo", "out_proj"):           # contraction-parallel
        return spec(_maybe(mesh, MODEL_AXIS, d0), _maybe(mesh, fsdp, d1))
    if name == "router":                     # (D, E): replicate experts
        return spec(_maybe(mesh, fsdp, d0), None)
    if name == "conv_w":                     # (w, ch): tiny
        return spec(None, None)
    # default 2D projection (D_in, D_out): FSDP x TP
    return spec(_maybe(mesh, fsdp, d0), _maybe(mesh, MODEL_AXIS, d1))


def param_pspecs(mesh, cfg: ArchConfig, params_shape: Any) -> Any:
    """PartitionSpec tree matching a params (shape-)tree. Stacked layer
    collections ('layers', 'dense_layers') get a leading None dim."""

    def walk(tree, prefix, stacked):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}",
                            stacked or k in ("layers", "dense_layers"))
                    for k, v in tree.items()}
        return _pspec_for_param(mesh, prefix, tuple(tree.shape), stacked)

    return walk(params_shape, "", False)


def serving_param_pspecs(mesh, cfg: ArchConfig, params_shape: Any) -> Any:
    """Weight layout for inference: TP over ``model`` only, REPLICATED
    over the data axes. ZeRO-3 makes no sense weights-stationary — with
    FSDP specs a decode step gathers every layer's parameters per
    token."""
    fsdp_names = set(dp_axes(mesh))

    def keep(entry):
        if entry is None:
            return None
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        kept = tuple(n for n in names if n not in fsdp_names)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept

    def strip_fsdp(p: P) -> P:
        if len(p) >= 4 or (len(p) == 3 and p[0] is None
                           and p[1] == MODEL_AXIS):
            # stacked MoE expert tensors: hundreds of GB — keep the
            # contraction-dim fsdp sharding (partial sums, no gathers);
            # only 2D projections get replicated over data
            return p
        return P(*[keep(e) for e in p])

    return tree_map(strip_fsdp, param_pspecs(mesh, cfg, params_shape))


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------

def batch_pspecs(mesh, cfg: ArchConfig, shape: ShapeSpec) -> Any:
    bspec = _maybe(mesh, dp_axes(mesh), shape.global_batch)
    out = {"labels": P(bspec, None)}
    if cfg.frontend == "frame":
        out["frames"] = P(bspec, None, None)
    else:
        out["tokens"] = P(bspec, None)
    if cfg.frontend == "patch":
        out["patches"] = P(bspec, None, None)
    return out


def cache_pspecs(mesh, cfg: ArchConfig, batch: int,
                 cache_shapes: Any) -> Any:
    """Decode-cache specs (leaf-wise by dim pattern on a cache shape
    tree): batch over the data axes when divisible; the KV/latent
    sequence dim is sequence-parallel over ``model`` (over *all* axes
    when batch=1, i.e. long-context decode)."""
    dp = dp_axes(mesh)
    bspec = _maybe(mesh, dp, batch)
    seq_axes = MODEL_AXIS if bspec is not None else (*dp, MODEL_AXIS)

    def leaf_spec(path_name, a):
        nd = a.dim()
        # stacked leading layer dim everywhere
        if path_name.endswith("ssm"):        # (L,B,H,P,N)
            return P(None, bspec, _maybe(mesh, MODEL_AXIS, a.shape[2]),
                     None, None)
        if path_name.endswith("conv"):       # (L,B,w-1,ch)
            return P(None, bspec, None, None)
        if nd == 5:                          # (L,B,T,kv,hd) attention kv
            return P(None, bspec, _maybe(mesh, seq_axes, a.shape[2]),
                     None, None)
        if nd == 4:                          # (L,B,T,r) mla latent/k_rope
            return P(None, bspec, _maybe(mesh, seq_axes, a.shape[2]), None)
        if nd == 3:
            return P(None, bspec, None)
        return P(*([None] * nd))

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        return leaf_spec(prefix, tree)

    return walk(cache_shapes, "")


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(mesh, spec: P) -> list:
    """One placement a mesh dim: ``Shard(d)`` where tensor dim ``d``'s
    entry names that axis, ``Replicate()`` otherwise. A dim sharded over
    several axes is ``Shard(d)`` on each of them, in mesh order (JAX's
    major-to-minor order)."""
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_shape(mesh, spec: P, shape: tuple[int, ...]) -> tuple[int, ...]:
    """The shard of ``shape`` one device holds under ``spec`` (every
    sharded dim divides: ``_maybe`` shards no other)."""
    entries = (*spec, *[None] * (len(shape) - len(spec)))
    return tuple(n // axis_size(mesh, e) for n, e in zip(shape, entries))


def to_placements(mesh, tree_pspec: Any) -> Any:
    """The reference's ``to_named``: each spec of the tree as DTensor
    placements on ``mesh``'s dims."""
    return tree_map(lambda s: placements(mesh, s), tree_pspec)
