"""Dry run: every (architecture × input shape) step on fake tensors
over the production meshes, with its FLOPs, bytes and per-device
argument bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_4b \\
        --shape train_4k --mesh pod

The port of the JAX package's ``launch/dryrun.py``. The reference lowers
and compiles each step with ``jax.jit`` on 512 fake host devices and
reads XLA's ``memory_analysis`` and ``cost_analysis``. The port runs the
step eagerly on the storage-less inputs of ``launch/specs.py`` (a
``FakeTensorMode``: nothing is allocated, on the host or the card),
under two counters:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions, attention calls; elementwise work counts nothing);
* bytes: ``BytesCounterMode``, the input and output bytes of every aten
  op that is not a view — the eager, unfused traffic, an upper bound
  on what a fused program moves. The reference's figure is XLA's
  post-fusion ``bytes accessed``, so the two are not expected to match.

Both are global counts divided by the chip count (the reference's
partitioned module is one device's share). The activation-sharding
context is installed as the reference installs it, so an MoE config
runs ``moe_apply``'s expert-parallel path over the mesh's logical
shards. ``argument_mb_per_dev`` is exact: each input leaf's local shard
bytes under its spec (``distributed/sharding.py``), summed.

A kernel the port calls through ``ctypes`` is invisible to
``FlopCounterMode``; on fake (host) tensors the kernels' plain versions
run instead, so ``attention_impl="flash"`` counts the plain version's
products (all S × T scores). The roofline probes therefore run
``attention_impl="stub"`` and add flash back analytically
(``launch/roofline.py::flash_attention_cost``), as the reference does.

Not ported, having no compiler behind them in eager PyTorch: the
result's ``lower_s``, ``compile_s``, ``output_mb_per_dev``,
``temp_mb_per_dev``, ``peak_mb_per_dev`` and ``collectives``, and
``collective_bytes`` (it parses XLA HLO text); they are absent from the
result, not zero. The reference's ``--xla_force_host_platform_device_count``
has no counterpart here: the counts need no devices, and no
``DeviceMesh``. Where one of the production shape is wanted
(``launch/mesh.py::to_device_mesh``), torch's ``"fake"`` process-group
backend (``torch.testing._internal.distributed.fake_pg.FakeStore``)
gives it 256 or 512 ranks in one process.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from dataclasses import replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs.base import (ARCH_IDS, SHAPES, ArchConfig, ShapeSpec,
                            get_config, shape_applicable)
from ..distributed.act_sharding import (ActivationSharding,
                                        activation_sharding)
from ..distributed.sharding import (P, batch_pspecs, cache_pspecs, dp_axes,
                                    local_shape, param_pspecs,
                                    serving_param_pspecs)
from ..train.optimizer import OptimizerConfig
from ..train.train_step import (make_prefill_step, make_serve_step,
                                make_train_step)
from ..tree import tree_leaves, tree_map
from .mesh import AbstractMesh, make_production_mesh
from .specs import fake_mode, input_specs

MODEL_AXIS_NAME = "model"


class BytesCounterMode(TorchDispatchMode):
    """Sums the input and output tensor bytes of every aten op that is
    not a view (``total``), and counts those ops (``ops``)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "aten" and not func.is_view:
            tensors = [t for t in tree_flatten((args, kwargs, out))[0]
                       if isinstance(t, torch.Tensor)]
            self.total += sum(t.numel() * t.element_size() for t in tensors)
            self.ops += 1
        return out


def default_micro(shape: ShapeSpec, mesh) -> int:
    """Grad-accumulation factor: target ~2 sequences per device per
    microbatch for the 4k train shape."""
    if shape.kind != "train":
        return 1
    dp = math.prod(mesh.shape[a] for a in dp_axes(mesh))
    per_dev = max(1, shape.global_batch // dp)
    return max(1, per_dev // 2)


def best_remat_group(n_layers: int) -> int:
    """Largest-balance divisor near sqrt(L) for two-level checkpointing."""
    target = math.sqrt(n_layers)
    divs = [d for d in range(1, n_layers + 1) if n_layers % d == 0]
    return min(divs, key=lambda d: abs(d - target))


def cell_config(cfg: ArchConfig, shape: ShapeSpec, remat: bool | None = None,
                **cfg_overrides) -> ArchConfig:
    """The configuration a cell runs: one-hot embedding (unless
    ``onehot_embed`` is given), the two-level remat group, and flash for
    prefill unless ``attention_impl`` is given (MLA and attention-free
    configs keep theirs)."""
    cfg = replace(cfg, **{"onehot_embed": True, **cfg_overrides})
    if cfg.remat_group == 0:
        cfg = replace(cfg, remat_group=best_remat_group(
            cfg.num_layers - cfg.first_k_dense))
    if remat is not None:
        cfg = replace(cfg, remat=remat)
    if (shape.kind == "prefill" and "attention_impl" not in cfg_overrides
            and not cfg.use_mla and cfg.num_heads):
        # production prefill runs the fused flash kernel; pass
        # attention_impl="dense" explicitly for the naive baseline
        cfg = replace(cfg, attention_impl="flash")
    return cfg


def _shard_bytes(mesh, spec: P, t: torch.Tensor) -> int:
    return math.prod(local_shape(mesh, spec, tuple(t.shape))) \
        * t.element_size()


def lower(cfg: ArchConfig, shape: ShapeSpec, mesh: AbstractMesh,
          n_micro: int | None = None, serving_fsdp_params: bool = False,
          return_artifacts: bool = False):
    """One step of ``cfg`` at ``shape`` on fake tensors, with the
    parameter layout and activation context the reference lowers it
    with on ``mesh``. Returns the result dict, or with
    ``return_artifacts`` (result, the ``FlopCounterMode``, the
    ``BytesCounterMode``)."""
    dp = dp_axes(mesh)
    dp_total = math.prod(mesh.shape[a] for a in dp)
    micro = 1
    if shape.kind == "train":
        micro = n_micro if n_micro is not None else default_micro(shape,
                                                                  mesh)
    eff_batch = shape.global_batch // micro
    act_ctx = ActivationSharding(
        mesh, dp if eff_batch % dp_total == 0 else None)
    # serving-params policy: TP-only (no per-layer gathers) while the
    # data-replicated bf16 share fits next to the KV cache; past ~4 GB a
    # device the ZeRO layout + gather wins
    tp_share_gb = 2e-9 * cfg.param_count() / mesh.shape[MODEL_AXIS_NAME]
    flops, nbytes = FlopCounterMode(display=False), BytesCounterMode()
    with fake_mode():
        specs = input_specs(cfg, shape)
        if shape.kind == "train" or serving_fsdp_params \
                or tp_share_gb > 4.0:
            pspecs = param_pspecs(mesh, cfg, specs["params"])
        else:
            pspecs = serving_param_pspecs(mesh, cfg, specs["params"])
        arg_specs = {"params": pspecs}
        if shape.kind == "train":
            step = make_train_step(cfg, OptimizerConfig(), n_micro=micro)
            arg_specs["opt"] = {"m": pspecs, "v": pspecs, "step": P()}
            arg_specs["batch"] = batch_pspecs(mesh, cfg, shape)
            args = (specs["params"], specs["opt"], specs["batch"])
        elif shape.kind == "prefill":
            step = make_prefill_step(cfg)
            arg_specs["batch"] = batch_pspecs(mesh, cfg, shape)
            args = (specs["params"], specs["batch"])
        else:
            step = make_serve_step(cfg)
            bspec = batch_pspecs(mesh, cfg, shape)["labels"][0]
            arg_specs.update(
                cache=cache_pspecs(mesh, cfg, shape.global_batch,
                                   specs["cache"]),
                tokens=P(bspec, None), pos=P())
            # decode_step reads pos as a Python int; the FLOPs and bytes
            # of a step do not depend on it
            args = (specs["params"], specs["cache"], specs["tokens"],
                    shape.seq_len - 1)
        by_role = {role: sum(tree_leaves(tree_map(
            lambda s, t: _shard_bytes(mesh, s, t), arg_specs[role],
            specs[role]))) for role in arg_specs}
        with activation_sharding(act_ctx), flops, nbytes:
            step(*args)
    ndev = mesh.size
    result = {
        "mesh": "x".join(str(n) for n in mesh.axis_sizes),
        "kind": shape.kind, "n_micro": micro, "devices": ndev,
        "flops_total": flops.get_total_flops() / ndev,
        "bytes_accessed": nbytes.total / ndev,
        "argument_mb_per_dev": sum(by_role.values()) / 1e6,
        "argument_mb_by_role": {k: v / 1e6 for k, v in by_role.items()},
        "params": cfg.param_count(),
    }
    if return_artifacts:
        return result, flops, nbytes
    return result


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               n_micro: int | None = None, remat: bool | None = None,
               return_artifacts: bool = False,
               serving_fsdp_params: bool = False, **cfg_overrides):
    shape = SHAPES[shape_name]
    cfg = cell_config(get_config(arch), shape, remat, **cfg_overrides)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    out = lower(cfg, shape, make_production_mesh(multi_pod=multi_pod),
                n_micro, serving_fsdp_params, return_artifacts)
    result = out[0] if return_artifacts else out
    result = {"arch": arch, "shape": shape_name, **result}
    print(f"[dryrun] {arch} {shape_name} mesh={result['mesh']}: "
          f"args {result['argument_mb_per_dev']:.2f} MB/dev, "
          f"flops {result['flops_total']:.3e}, "
          f"bytes {result['bytes_accessed']:.3e} a device")
    return (result, *out[1:]) if return_artifacts else result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--micro", type=int, default=None)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cache: dict[str, dict] = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            cache = json.load(f)

    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                key = f"{arch}|{shape_name}|{'mp' if multi_pod else 'sp'}"
                if key in cache and "error" not in cache[key]:
                    continue
                t0 = time.perf_counter()
                try:
                    cache[key] = lower_cell(arch, shape_name, multi_pod,
                                            n_micro=args.micro)
                except Exception as e:      # noqa: BLE001
                    traceback.print_exc()
                    cache[key] = {"arch": arch, "shape": shape_name,
                                  "mesh": "2x16x16" if multi_pod
                                  else "16x16",
                                  "error": f"{type(e).__name__}: {e}"}
                cache[key]["wall_s"] = time.perf_counter() - t0
                with open(args.out, "w") as f:
                    json.dump(cache, f, indent=1)
    errors = [k for k, v in cache.items() if "error" in v]
    skips = [k for k, v in cache.items() if "skipped" in v]
    print(f"\n[dryrun] done: {len(cache)} cells, {len(skips)} skipped, "
          f"{len(errors)} errors")
    for k in errors:
        print(f"  ERROR {k}: {cache[k]['error']}")
    if errors:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
