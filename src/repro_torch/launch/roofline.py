"""Roofline cost probe + three-term analysis.

    PYTHONPATH=src python -m repro_torch.launch.roofline --arch qwen3_4b \\
        --shape prefill_32k

The port of the JAX package's ``launch/roofline.py``. The probe counts
an unrolled variant of the step at two depths (L0, L1) with
single-chunk CE, takes the per-layer delta and extrapolates::

    total(L) = fixed + L * per_layer        (exact for layer-homogeneous
                                             stacks, which all ten are)

The counts are ``launch/dryrun.py``'s: ``FlopCounterMode`` and the
eager bytes counter on fake tensors (no storage anywhere), one device's
share of the production mesh. ``probe_shape`` takes any ``ShapeSpec``,
so a caller can probe the shapes it times.

Terms (per step, per card; H100 SXM constants from ``launch/mesh.py``):
    compute_s    = HLO_FLOPs / 989e12
    memory_s     = HLO_bytes / 3.35e12
    collective_s = collective_bytes / (25e9 * links)

The port's probes have no collective figure (no compiler, no HLO), so
``collective_bytes_total`` is ``None`` in a probe, ``collective_s`` is
``None`` in its terms and ``dominant`` is taken over compute and
memory. ``model_flops``, ``active_params``, ``flash_attention_cost`` and
every formula are the reference's; ``arch`` may also be an
``ArchConfig`` and ``shape_name`` a ``ShapeSpec``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from ..configs.base import (ARCH_IDS, SHAPES, ArchConfig, ShapeSpec,
                            get_config, shape_applicable)
from . import mesh as hw
from .dryrun import cell_config, lower
from .mesh import make_production_mesh

PROBE_LAYERS = {  # (L0, L1) per family — small, layer-ratio-preserving
    "default": (2, 4),
    # hybrid: probe in whole shared-groups (6 mamba + 1 shared) so the
    # per-layer delta carries the production shared-block ratio
    "hybrid": (6, 12),
}


def _resolve(arch, shape) -> tuple[ArchConfig, ShapeSpec]:
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    return cfg, shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def _probe_cfg_overrides(cfg, shape, n_layers):
    o = dict(num_layers=n_layers, scan_layers=False, remat_group=1,
             ce_chunk=shape.seq_len)
    if cfg.first_k_dense:
        o["first_k_dense"] = 1
        o["num_layers"] = n_layers + 1
    return o


def probe_shape(arch, shape_name, overrides: dict | None = None,
                mesh=None) -> dict:
    """Count L0/L1 probes of ``arch``'s config (an id or an
    ``ArchConfig``) at ``shape_name`` (a name of ``SHAPES`` or a
    ``ShapeSpec``) on ``mesh`` (default: the 16 x 16 production mesh);
    return extrapolated per-step, per-device costs."""
    cfg, shape = _resolve(arch, shape_name)
    mesh = mesh or make_production_mesh()
    l0, l1 = PROBE_LAYERS.get(cfg.family, PROBE_LAYERS["default"])
    runs = []
    for nl in (l0, l1):
        over = {**_probe_cfg_overrides(cfg, shape, nl), **(overrides or {})}
        runs.append(lower(cell_config(cfg, shape, **over), shape, mesh,
                          n_micro=1))
    r0, r1 = runs
    dl = l1 - l0

    def extrap(key):
        per_layer = (r1[key] - r0[key]) / dl
        fixed = r0[key] - l0 * per_layer
        return fixed + cfg.num_layers * per_layer, per_layer, fixed

    flops, flops_pl, flops_fixed = extrap("flops_total")
    bytes_, _, _ = extrap("bytes_accessed")
    return {"arch": arch, "shape": shape_name, "mesh": r0["mesh"],
            "kind": r0["kind"], "hlo_flops": flops, "hlo_bytes": bytes_,
            "flops_per_layer": flops_pl, "flops_fixed": flops_fixed,
            "collective_bytes_total": None}


def probe_cell(arch: str, shape_name: str, multi_pod: bool = False) -> dict:
    """Count unrolled L0/L1 probes, return extrapolated per-step costs."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    return probe_shape(arch, shape_name,
                       mesh=make_production_mesh(multi_pod=multi_pod))


def probe_cell_with(arch: str, shape_name: str, overrides: dict,
                    multi_pod: bool = False) -> dict:
    return probe_shape(arch, shape_name, overrides,
                       make_production_mesh(multi_pod=multi_pod))


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def model_flops(arch, shape_name) -> float:
    """6·N·D (train) / 2·N_active per token (decode/prefill fwd-only)."""
    _, shape = _resolve(arch, shape_name)
    n = active_params(arch)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per sequence


def active_params(arch) -> float:
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    n = cfg.param_count()
    if cfg.num_experts:
        f = cfg.moe_d_ff or cfg.d_ff
        dense_share = (cfg.num_experts - cfg.experts_per_token) \
            * 3 * cfg.d_model * f * (cfg.num_layers - cfg.first_k_dense)
        n = n - dense_share
    return float(n)


def roofline_terms(probe: dict, chips: int = 256,
                   links_per_chip: float = hw.NVLINK_LINKS) -> dict:
    """Three terms in seconds. The probe's flops / bytes / collective
    bytes are one device's share, so they divide by per-card rates
    directly; the global-FLOPs quantities multiply back by ``chips``.
    ``collective_s`` is None where the probe has no collective figure."""
    comp = probe["hlo_flops"] / hw.PEAK_FLOPS_BF16
    mem = probe["hlo_bytes"] / hw.HBM_BW
    coll_bytes = probe.get("collective_bytes_total")
    coll = None if coll_bytes is None \
        else coll_bytes / (hw.ICI_BW * links_per_chip)
    terms = [("compute", comp), ("memory", mem)]
    if coll is not None:
        terms.append(("collective", coll))
    dominant, bound = max(terms, key=lambda t: t[1])
    mf = model_flops(probe["arch"], probe["shape"])
    hlo_global = probe["hlo_flops"] * chips
    ideal_s = mf / (chips * hw.PEAK_FLOPS_BF16)
    return {
        **probe,
        "chips": chips,
        "compute_s": comp, "memory_s": mem, "collective_s": coll,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": mf / hlo_global if hlo_global else
        float("nan"),
        # MFU upper bound this configuration can reach: ideal model-flops
        # time over the binding roofline term
        "mfu_bound": ideal_s / bound if bound else float("nan"),
        "step_time_bound_s": bound,
    }


def flash_attention_cost(arch, shape_name, chips: int = 256
                         ) -> tuple[float, float]:
    """Analytic per-device (flops, HBM bytes) of fused flash attention —
    added back onto stub-attention probes. Scores never hit HBM; traffic
    is Q/K/V reads + O writes (×3.5 for train: fwd + bwd re-reads +
    remat recompute)."""
    cfg, shape = _resolve(arch, shape_name)
    if cfg.attention_free or not cfg.num_heads:
        return 0.0, 0.0
    hd = cfg.resolved_head_dim
    s = t = shape.seq_len
    b = shape.global_batch
    causal = 0.5 if cfg.causal else 1.0
    layers = cfg.num_layers
    flops = 4.0 * b * cfg.num_heads * s * t * hd * causal * layers
    bytes_ = 2.0 * (2 * b * s * cfg.num_heads * hd
                    + 2 * b * t * cfg.num_kv_heads * hd) * layers
    mult = 3.5 if shape.kind == "train" else 1.0
    # per-device: heads (or sequence) shard over the model axis; batch
    # over data — total work divides by the full chip count
    return flops * mult / chips, bytes_ * mult / chips


def optimized_cell(arch: str, shape_name: str) -> dict:
    """The 'after' measurement: stub-attention probe (= flash HBM byte
    model) + analytic flash add-back, on the current sharding rules."""
    probe = probe_cell(arch, shape_name)
    if "skipped" in probe:
        return probe
    base = roofline_terms(probe)
    cfg = get_config(arch)
    # decode attention is already linear (1×T scores) — flash only
    # changes train/prefill
    if cfg.num_heads and not cfg.use_mla \
            and SHAPES[shape_name].kind in ("train", "prefill"):
        stub = probe_cell_with(arch, shape_name,
                               {"attention_impl": "stub"})
        aflops, abytes = flash_attention_cost(arch, shape_name)
        stub["hlo_flops"] += aflops
        stub["hlo_bytes"] += abytes
        opt = roofline_terms(stub)
        opt["flash_flops_added"] = aflops
        opt["flash_bytes_added"] = abytes
    else:
        opt = base
    return {"baseline_current_code": base, "optimized": opt}


def _ms(x) -> str:
    return "n/a" if x is None else f"{x * 1e3:.2f}ms"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="results/roofline.json")
    ap.add_argument("--optimized", action="store_true",
                    help="run the stub-attention + flash add-back probes")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cache = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            cache = json.load(f)
    for arch in archs:
        for shape_name in shapes:
            key = f"{arch}|{shape_name}"
            if key in cache and "error" not in cache[key]:
                continue
            t0 = time.perf_counter()
            try:
                if args.optimized:
                    cache[key] = optimized_cell(arch, shape_name)
                    r = cache[key].get("optimized")
                    tag = "[perf]"
                else:
                    p = probe_cell(arch, shape_name)
                    cache[key] = p if "skipped" in p else roofline_terms(p)
                    r = None if "skipped" in p else cache[key]
                    tag = "[roofline]"
                if r is not None:
                    print(f"{tag} {key}: dominant={r['dominant']} "
                          f"compute={_ms(r['compute_s'])} "
                          f"memory={_ms(r['memory_s'])} "
                          f"collective={_ms(r['collective_s'])} "
                          f"useful={r['useful_flops_ratio']:.2f}")
            except Exception as e:   # noqa: BLE001
                import traceback
                traceback.print_exc()
                cache[key] = {"arch": arch, "shape": shape_name,
                              "error": f"{type(e).__name__}: {e}"}
            cache[key]["wall_s"] = time.perf_counter() - t0
            with open(args.out, "w") as f:
                json.dump(cache, f, indent=1)
    if any("error" in v for v in cache.values()):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
