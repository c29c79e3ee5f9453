#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (one ``nvcc``
per source, all at once), measures the card's sustained (min, +) term
rate beside the issue ceiling its instructions allow (phase
``minplus_peak``; the ceiling is the operations rate of the min-plus
bounds), holds each kernel against its plain PyTorch version on the
card (``relax`` with and without its occupancy map; the fused closure
on each side of its cap; the k-major product; the join at every vector
width, on float32, bfloat16 and float16 rows and 16-bit codes), and
drives the port's twenty-two paths:

* serving at n = 4096 — deploy with the staged builder on the card
  (``builder="torch"``) → ``DistanceService.submit`` in float32 and
  uint16 storage → a rebuild window (B rebuilt by the staged builder)
  under all three modes → back to steady state;
* the paper's oracle API at n = 4096 — ``DistanceOracle.build`` under
  the hierarchical and the reference builder, serving on the card, its
  Table-2 columns (BL, Districts) and ``query_many`` on the serving
  batch against Dijkstra and the deployed system's answers;
* the sharded layouts at n = 4096 — ``ServingPolicy(engine="sharded")``
  on the deployed system for 4 and 8 logical shards on the card, B
  replicated and row-sharded, float32 and uint16, one sharded-kernel
  launch a batch held against its plain version and every answer
  against the replicated engine's; then a ``RebalancePlanner`` plan
  from the service's load and ``EdgeSystem.migrate``; and the
  row-sharded join at the center's size (65 536 rule-3 queries over
  n = 102 400's B, 8 shards, one launch);
* the scatter-gather read path at n = 4096 —
  ``ServingPolicy(engine="scatter_gather")`` on the deployed system (16
  edge servers, each a logical shard of the card) in float32 and
  uint16, one sharded-kernel launch a batch (uint16 dequantized in the
  kernel) held against its plain version and the answers against the
  replicated and sharded engines and the scalar loop; the plane's bytes, exchanges and the host split of a
  submit; three fault plans, each replayed twice byte for byte with no
  unflagged wrong answer; ``DistanceBatcher`` at 1024; the open-loop
  load harness at the reference benchmark's parameters (0.5x and 1.5x
  the measured capacity, a bounded queue, 10^6 clients) on the
  replicated and scatter placements;
* the computing center at n = 102 400 — B built on the card by the
  staged builder, held against the host's Dijkstra stage A and
  hierarchical builder, then the rule-3 join;
* stage B on each side of the fused closure's cap — B built on the card
  at q = 160 (one closure launch) and q = 239 (the tiled kernel's
  squarings), each held against the host reference;
* the APSP entry point — ``sssp_relax.ops.floyd_warshall`` on every
  district of n = 102 400 ((6400, 6400) each) through the Floyd–Warshall
  kernel, held against its plain version, stage A's border rows and
  Dijkstra, and its three phases timed apart;
* updates — ``IncrementalBuilder.apply_delta`` on the card-built B at
  n = 102 400 for four traffic scenarios and ``apply_structural`` for
  three closure-storm epochs (scoped and full rungs), each held against
  a full staged build on the new graph (stage A's host packing and its
  sweeps timed apart); then one
  ``apply_traffic_update(incremental=True)`` and one
  ``apply_topology_update`` of the deployed n = 4096 system, whose
  answers are held against Dijkstra;
* the §5 latency simulator at n = 4096 — ``run_update_epochs`` (repairs
  and the centralized baseline's full build of B on the card), the
  simulator's edge (forwarded and scatter) against centralized latency
  over a 5000-query trace, and a rebuild window under the load harness
  in the ``stale_ok`` and ``certify_or_wait`` modes;
* the dense-LM serving path at the full width of Qwen3-4B (random
  weights from a seed) — ``make_prefill_step`` through the flash-
  attention kernel (36 layers, bf16, 2 x 4096 tokens) against the dense
  prefill, an f32 4-layer check of flash against dense, of the card
  against the host (forward and ``decode_step``) and of ``decode_step``
  against the forward pass, and ``BatchedDecoder`` answering 8
  requests;
* DIMACS ingest at the vertex count of USA-road-d.NY — a synthetic
  continent (262 144 vertices, 64 districts) written as a gzip ``.gr``
  file, streamed back through ``load_gr_csr`` (held against the
  generator's CSR), B built on the card from it (q = 448: stage B's
  tiled squarings), held against the host hierarchical builder, and
  65 536 rule-3 queries through the join, against Dijkstra;
* the dense LM's training path at Qwen3-4B's full width —
  ``make_train_step`` (float32 params, bf16 compute, per-layer remat,
  the chunked cross-entropy, in-place AdamW) at full depth on one
  512-token batch, the loss falling; ``run_training`` at 2 layers with
  checkpoints, an injected fault (restore and replay) and a resume; and
  a float32 step on the card against the same step on the host;
* the MoE family at OLMoE-1B-7B's published config, full depth and
  width (bf16 weights, random from a seed) — a flash prefill of
  2 x 4096 tokens (16 flash launches), its capacity drops at cf 1.25,
  two prefills equal bit for bit, the dense prefill as the yardstick
  (compared where both routed a token alike), ``BatchedDecoder`` at
  batch 4 on 8 requests, a profile of one MoE layer by stage; a float32
  check at 2 layers on the card against the host, and 3 train steps at
  2 layers;
* MLA and shared experts at DeepSeek-V2's published width, cut to 3
  layers (one dense, two MoE) — a prefill of 1 x 2048 (capacity 96),
  one MoE layer's profile, decode steps at batch 4 from the MLA cache;
* the frontends — InternVL2-26B at full depth, a flash prefill of 256
  patches + 1792 text tokens (48 flash launches) against the dense
  prefill; HuBERT-XLarge at full depth, a non-causal forward over 4096
  frames through the flash kernel (48 launches, head dim 80) against
  the dense forward;
* the SSM family at Mamba2-1.3B's published config, full depth and
  width (bf16 weights, random from a seed) — a prefill of 2 x 4096
  tokens through the chunked SSD (torch ops; no kernel of the port),
  two prefills compared bit for bit, one mixer profiled by stage,
  ``BatchedDecoder`` at batch 4 on 8 requests and a decode profile; a
  float32 check at 2 layers on the card against the host (two chunks
  and the one-chunk fallback; decode against the forward pass), and 3
  train steps at full depth;
* the hybrid family at Zamba2-1.2B's published config, full depth and
  width — a flash prefill of 2 x 4096 tokens (6 flash launches, one a
  shared-block application) against the dense prefill,
  ``BatchedDecoder`` at batch 4 and a decode profile; a float32 check
  at 6 layers (one shared application) on the card against the host,
  and 3 train steps at full depth;
* the three other dense configs, each as Qwen3-4B above (flash prefill
  against dense, one flash launch a layer; ``BatchedDecoder`` and a
  decode profile; the f32 card-vs-host check) at its published width:
  StarCoder2-7B at 8 of 32 layers (36 / 4 heads: a group of 9, GELU; 2
  x 4096 tokens; its shape cells run all 32), then 3 train steps at 8
  layers and a float32 train step at 2 layers against the host;
  DeepSeek-67B cut to 8 of 95 layers (2 x 4096 tokens; its shape cells
  run 24); Nemotron-4-340B cut to 4 of 96 layers (96 /
  8 heads at hd 192 through the bf16 kernel's hd-192 instance, squared
  ReLU; 1 x 2048 tokens; its f32 check at 1 layer and a vocabulary of
  32 768);
* the launch and sharding tooling — the roofline (``launch/roofline.py``:
  fake-tensor probes, H100 constants) of each LM path timed above,
  beside its measured seconds and MFU; a 2-layer Qwen3-4B flash prefill
  on the card under ``FlopCounterMode`` equal to the fake-tensor
  probe's count; the dry run's argument bytes equal to the serving
  params held on the card; ``moe_apply``'s expert-parallel path on
  OLMoE's full-width layer (data 1 x model 4) against the host; and
  ``python -m repro_torch.launch.dryrun`` for one cell in a subprocess;
* the JAX package's four LM input shapes (``configs/base.py`` SHAPES) at
  published widths: 29 of the 31 (arch, shape) cells that apply
  (``SHAPE_CELLS``; ``NOT_ON_ONE_CARD`` gives the two left out, in
  bytes), each at full depth where one card holds it and at the batch
  it holds or the script's time allows — e.g. ``prefill_32k`` on
  Qwen3-4B (8 x 32 768 tokens, 36 flash launches) and InternVL2-26B (2
  x (256 patches + 32 768 tokens), 48 launches over 33 024 positions),
  ``decode_32k`` on Qwen3-4B (batch 12 over a 32 768-row cache),
  ``long_500k`` on Zamba2-1.2B (a 524 288-row shared cache), and
  ``train_4k`` on Qwen3-4B (1 x 4096); each with a float32 step of the
  same path on the card against the host at a cut depth and the full
  length, the decode caches filled with seeded draws (the written slot
  and every other slot checked), a profile, peak memory and the path's
  roofline; and the flash kernel at 32 768 tokens (33 024 positions),
  held against its plain version on slices of query rows, at batch 1
  and on the last sequence of each prefill's first launch.

It checks answers against the scalar loop, the plain versions, the host
builders and Dijkstra, the dense attention path, and times every
kernel at the paths' shapes with CUDA events, with its inputs read from
HBM where the shape allows it.
Prints one JSON object per phase, the ``kernels`` line, the card's name
and power limit, and last ``{"ok": true, "device": ...}``. Any failure
exits non-zero before the last line; so does a host without a CUDA
device, or a directory that lacks ``src/repro_torch``. Imports nothing
of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, 700 W), set by main()
# from the port's launch/mesh.py, so the kernel table's bounds and the
# roofline read one source: the HBM3 rate, the float32 rate outside the
# tensor cores, and the bf16 dense tensor-core peak (the bound of
# attention's products)
PEAK_BYTES_PER_S: float
PEAK_F32_OPS_PER_S: float
PEAK_BF16_TENSOR_FLOPS_PER_S: float
# the min-plus operations bound is the issue ceiling of the term form
# with the fewest instructions a term (from its SASS; phase minplus_peak)
# on 128 lanes per SM at the max SM clock; beside it, the figure of
# earlier rows: 2 instructions per term (FADD, FMNMX)
MINPLUS_LANES_PER_SM = 128
# instructions per term of each minplus_peak.cu form as its source writes
# it, used where cuobjdump is missing: 2 FADD + 2 FMNMX, 2 FADD + 1 VIMNMX3
# per two terms
NOMINAL_INSTRUCTIONS_PER_TERM = {0: 2.0, 1: 1.5}
# H100 SXM L2 size; timed calls cycle through copies of their inputs so
# that rows come from HBM, within a device-memory budget for the copies
L2_BYTES = 50 << 20
MAX_COPIES = 128
COPY_BUDGET_BYTES = 4 << 30

SMALL = dict(grid=(4, 4), district=(16, 16), border_links=2, seed=7)
LARGE = dict(grid=(4, 4), district=(80, 80), border_links=2, seed=7)
BATCH = 4096
CENTER_BATCHES = (4096, 65536)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


START = time.perf_counter()


def emit(obj: dict) -> None:
    """One line of JSON; a phase's line also gets the seconds since the
    script started (where the run's time goes)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def sync(torch, dev) -> None:
    """Bring a fault of a launch to light where it happened."""
    if dev.type == "cuda":
        torch.cuda.synchronize()


def max_abs_err(a, b) -> float:
    """Largest |a − b| over entries that are not both +inf (0.0 when the
    two agree bit for bit)."""
    import torch
    a, b = a.double(), b.double()
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    diff = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


# -- phase 2: kernels against their plain versions ---------------------------

# (Q, W): widths of 1 to 1024 (row pitches of 4 B to 4 KB: every vector
# width of the join, 16, 8, 4 and, for codes, 2 bytes), batches 1 to
# 65 536; each table also sliced one element off its alignment
JOIN_SHAPES = [(1, 1), (5, 7), (64, 128), (100, 257), (512, 512),
               (3, 1024), (257, 33), (9, 0), (4096, 96), (65536, 96),
               (4096, 256), (45, 6), (64, 12), (4096, 93), (1, 133),
               (45, 96), (65536, 93)]


def on_card_at(torch, dev, host: np.ndarray, offset: int):
    """``host`` copied to the card as a contiguous table that starts
    ``offset`` elements past its allocation's (256-byte) alignment."""
    flat = torch.empty(host.size + offset, dtype=getattr(
        torch, host.dtype.name), device=dev)
    table = flat[offset:].view(host.shape)
    table.copy_(torch.from_numpy(host))
    return table


def copy_at(torch, x, offset: int):
    """A copy of the card tensor ``x``, contiguous, ``offset`` elements
    past its allocation's alignment."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    return flat[offset:].view(x.shape).copy_(x)


def phase_kernels(torch, dev, kernel, ref, errs: dict) -> dict:
    rng = np.random.default_rng(0)
    layouts = set()
    for (q, w), offset in [(shape, o) for shape in JOIN_SHAPES
                           for o in (0, 1)]:
        rows = q + 5
        s = rng.uniform(0.5, 50.0, (rows, w)).astype(np.float32)
        t = rng.uniform(0.5, 50.0, (rows + 3, w)).astype(np.float32)
        s[rng.random(s.shape) < 0.3] = np.inf
        t[rng.random(t.shape) < 0.3] = np.inf
        S, T = on_card_at(torch, dev, s, offset), on_card_at(torch, dev, t,
                                                             offset)
        layouts.add(("float32",) + kernel.join_layout(S, T, q))
        rs = torch.from_numpy(rng.integers(0, rows, q)).to(dev)
        rt = torch.from_numpy(rng.integers(0, rows + 3, q)).to(dev)
        got = kernel.gather_join(S, rs, T, rt)
        lam, lb = kernel.gather_join(S, rs, T, rt, with_lb=True)
        sync(torch, dev)
        want = ref.gather_join_ref(S, rs, T, rt)
        want_lam, want_lb = ref.gather_join_ref(S, rs, T, rt, with_lb=True)
        check(torch.equal(got, want), f"label_join f32 {q}x{w}")
        check(torch.equal(lam, want_lam) and torch.equal(lb, want_lb),
              f"label_join_lb {q}x{w}")
        errs["label_join"] = max(errs["label_join"], max_abs_err(got, want))
        errs["label_join_lb"] = max(errs["label_join_lb"],
                                    max_abs_err(lb, want_lb),
                                    max_abs_err(lam, want_lam))
        for sentinel, npdt in ((0xFFFF, np.uint16), (0x7FFF, np.int16)):
            cs = rng.integers(0, sentinel + 1, (rows, w)).astype(npdt)
            ct = rng.integers(0, sentinel + 1, (rows + 3, w)).astype(npdt)
            cs[rng.random(cs.shape) < 0.3] = sentinel
            CS = on_card_at(torch, dev, cs.view(np.int16), offset)
            CT = on_card_at(torch, dev, ct.view(np.int16), offset)
            layouts.add(("codes",) + kernel.join_layout(CS, CT, q))
            got = kernel.gather_join(CS, rs, CT, rt, quant=(sentinel, 0.5))
            sync(torch, dev)
            want = ref.gather_join_ref(CS, rs, CT, rt,
                                       quant=(sentinel, 0.5))
            check(torch.equal(got, want),
                  f"label_join {npdt.__name__} {q}x{w}")
            errs["label_join"] = max(errs["label_join"],
                                     max_abs_err(got, want))
        # 16-bit float rows: widened, joined in float32, rounded once
        for dt in (torch.bfloat16, torch.float16):
            HS = copy_at(torch, S.to(dt), offset)
            HT = copy_at(torch, T.to(dt), offset)
            layouts.add(("float16",) + kernel.join_layout(HS, HT, q))
            got = kernel.gather_join(HS, rs, HT, rt)
            lam, lb = kernel.gather_join(HS, rs, HT, rt, with_lb=True)
            sync(torch, dev)
            want = ref.gather_join_ref(HS, rs, HT, rt)
            want_lam, want_lb = ref.gather_join_ref(HS, rs, HT, rt,
                                                    with_lb=True)
            check(got.dtype == dt and torch.equal(got, want),
                  f"label_join {dt} {q}x{w}")
            check(lam.dtype == dt and torch.equal(lam, want_lam)
                  and torch.equal(lb, want_lb), f"label_join_lb {dt} {q}x{w}")
            errs["label_join"] = max(errs["label_join"],
                                     max_abs_err(got, want))
            errs["label_join_lb"] = max(errs["label_join_lb"],
                                        max_abs_err(lb, want_lb),
                                        max_abs_err(lam, want_lam))
    widths = {kind: sorted({v for k, v, _ in layouts if k == kind})
              for kind in ("float32", "codes", "float16")}
    check(widths == {"float32": [4, 8, 16], "codes": [2, 4, 8, 16],
                     "float16": [2, 4, 8, 16]},
          f"the join shapes missed a vector width: {widths}")
    return {"phase": "kernels_vs_plain", "shapes": JOIN_SHAPES,
            "table_offsets_elements": [0, 1],
            "dtypes": ["float32", "uint16", "int16", "bfloat16",
                       "float16"],
            "layouts_vec_bytes_lanes": sorted(layouts),
            "tolerance": "bitwise", "ok": True}


# min-plus shapes (batch or None, m, k, n): unaligned ones, then the
# builder's — the closure squarings at q = 93 / 96 and stage C at both
# sizes, (m, kmax, bmax) x (m, bmax, q)
MINPLUS_SHAPES = [(None, 1, 1, 1), (None, 5, 7, 3), (None, 130, 70, 33),
                  (3, 37, 0, 5), (2, 200, 300, 65), (None, 93, 93, 93),
                  (None, 96, 96, 96), (16, 256, 8, 93), (16, 6400, 8, 96),
                  (1, 6400, 8, 96), (3, 65, 33, 129), (1, 1, 0, 5),
                  (2, 130, 257, 64), (None, 239, 239, 239),
                  (None, 448, 448, 448), (None, 1024, 1024, 1024)]
# k-major products (batch or None, m, k, n), A given as (batch, k, m):
# stage C at both sizes, n % 4 != 0 (scalar stores), several column
# tiles, k = 0, 1, 32 and 33 (the tiled kernel on a transposed copy)
KMAJOR_SHAPES = [(16, 256, 8, 93), (16, 6400, 8, 96), (1, 6400, 8, 96),
                 (None, 5, 1, 3), (3, 300, 32, 97), (2, 130, 8, 2048),
                 (4, 129, 8, 1030), (3, 37, 0, 5), (2, 100, 33, 64)]
# closures (q, +inf share): each side of the fused kernel's cap (160),
# at the fixed schedule and from squaring 0 and 2 on
CLOSURE_CASES = [(1, 0.0), (7, 0.9), (93, 0.9), (96, 0.0), (128, 0.9),
                 (160, 0.9), (160, 0.0), (161, 0.9), (239, 0.9)]
# relax shapes (batch or None, s, v): unaligned ones, then stage A's
# sweep at both sizes, (m, bmax, kmax) x (m, kmax, kmax), and the
# repairs' subset sweeps over 1, 2 or 4 districts
RELAX_SHAPES = [(None, 1, 1), (None, 8, 33), (2, 13, 300), (3, 5, 129),
                (16, 8, 256), (16, 8, 6400), (1, 8, 256), (1, 8, 6400),
                (2, 8, 6400), (4, 8, 6400)]


# banded adjacencies: finite within this many places of the diagonal,
# as a grid district's (80 columns, vertices in row order) is
RELAX_BAND = 80


def rand_dist(torch, gen, shape, inf_frac: float):
    """Seeded distances in [0.5, 50) with a share of +inf, on the card."""
    dev = gen.device
    x = torch.rand(shape, generator=gen, device=dev) * 49.5 + 0.5
    x[torch.rand(shape, generator=gen, device=dev) < inf_frac] = \
        float("inf")
    return x


def banded_dist(torch, gen, shape, band: int):
    """Seeded distances finite only within ``band`` of the diagonal of
    the last two axes (half of them there +inf), on the card."""
    x = rand_dist(torch, gen, shape, 0.5)
    i = torch.arange(shape[-1], device=x.device)
    x[..., (i[:, None] - i[None, :]).abs() > band] = float("inf")
    return x


def phase_minplus_kernels(torch, dev, errs: dict) -> dict:
    from repro_torch.kernels.minplus import kernel, ops, ref
    gen = torch.Generator(device=dev).manual_seed(1)
    layouts = {}
    for batch, m, k, n in MINPLUS_SHAPES:
        lead = () if batch is None else (batch,)
        a = rand_dist(torch, gen, (*lead, m, k), 0.3)
        b = rand_dist(torch, gen, (*lead, k, n), 0.3)
        got = kernel.minplus(a, b)
        sync(torch, dev)
        want = ref.minplus_ref(a, b)
        check(torch.equal(got, want), f"minplus {lead}x{m}x{k}x{n}")
        errs["minplus"] = max(errs["minplus"], max_abs_err(got, want))
        layouts[f"{lead}x{m}x{k}x{n}"] = kernel.minplus_layout(a, b)
    for batch, m, k, n in KMAJOR_SHAPES:
        lead = () if batch is None else (batch,)
        a_t = rand_dist(torch, gen, (*lead, k, m), 0.3)
        b = rand_dist(torch, gen, (*lead, k, n), 0.3)
        before = dict(kernel.LAUNCHES)
        got = kernel.minplus_kmajor(a_t, b)
        sync(torch, dev)
        deep = k > kernel.KMAJOR_MAX_K
        check(kernel.LAUNCHES["minplus_kmajor"] - before["minplus_kmajor"]
              == int(not deep) and kernel.LAUNCHES["minplus"]
              - before["minplus"] == int(deep),
              f"minplus_kmajor {lead}x{k}x{m}x{n} dispatch")
        want = ref.minplus_kmajor_ref(a_t, b)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"minplus_kmajor {lead}x{k}x{m}x{n}")
        errs["minplus_kmajor"] = max(errs["minplus_kmajor"],
                                     max_abs_err(got, want))
    depths = {}
    for q, inf_frac in CLOSURE_CASES:
        d0 = rand_dist(torch, gen, (q, q), inf_frac)
        d0.fill_diagonal_(0.0)
        steps = ops.closure_steps(q)
        for check_from in (steps, 0, 2):
            before = dict(kernel.LAUNCHES)
            got, depth = ops.closure_squarings(d0, steps, check_from)
            depth = int(depth)
            fused = q <= kernel.CLOSURE_MAX_Q
            check(kernel.LAUNCHES["minplus_closure"]
                  - before["minplus_closure"] == int(fused)
                  and kernel.LAUNCHES["minplus"] - before["minplus"]
                  == (0 if fused else min(steps, depth + 1)),
                  f"closure q={q} dispatch")
            want, want_depth = ref.closure_ref(d0, steps, check_from)
            what = f"closure q={q} inf {inf_frac} from {check_from}"
            check(depth == want_depth, f"{what}: depth {depth} vs "
                  f"{want_depth}")
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  what)
            errs["minplus_closure" if fused else "minplus"] = max(
                errs["minplus_closure" if fused else "minplus"],
                max_abs_err(got, want))
            depths[f"q{q}_inf{inf_frac}_from{check_from}"] = depth
    # a warm start from a fixpoint (integral weights): the first checked
    # squaring returns its input
    d0 = torch.ceil(rand_dist(torch, gen, (96, 96), 0.9))
    d0.fill_diagonal_(0.0)
    fix = ops.closure(d0)
    got, depth = kernel.closure(fix, ops.closure_steps(96), 3)
    check(int(depth) == 3 and torch.equal(got, fix),
          f"warm closure at a fixpoint: depth {int(depth)}")
    kept_share = {}
    for batch, s, v in RELAX_SHAPES:
        lead = () if batch is None else (batch,)
        d = rand_dist(torch, gen, (*lead, s, v), 0.5)
        for kind in ("random", "banded"):
            a = rand_dist(torch, gen, (*lead, v, v),
                          0.99 if v > 1000 else 0.9) if kind == "random" \
                else banded_dist(torch, gen, (*lead, v, v), RELAX_BAND)
            occ = kernel.relax_occupancy(a)
            kept = d.clone()
            got = kernel.relax(d, a)
            got_map = kernel.relax(d, a, occ)
            sync(torch, dev)
            want = ref.relax_ref(d, a)
            what = f"relax {kind} {lead}x{s}x{v}"
            check(torch.equal(got, want), what)
            check(torch.equal(got_map, want)
                  and torch.equal(ref.relax_ref(d, a, occ), want),
                  f"{what} with the occupancy map")
            check(torch.equal(d, kept), f"{what} wrote its input")
            errs["relax"] = max(errs["relax"], max_abs_err(got, want),
                                max_abs_err(got_map, want))
            kept_share[f"{kind} {lead}x{s}x{v}"] = float(occ.float().mean())
            del a, occ, want, got, got_map
    return {"phase": "kernels_vs_plain_minplus",
            "minplus_shapes": MINPLUS_SHAPES, "minplus_layouts": layouts,
            "kmajor_shapes": KMAJOR_SHAPES,
            "closure_cases": CLOSURE_CASES,
            "closure_cap": kernel.CLOSURE_MAX_Q, "closure_depths": depths,
            "relax_shapes": RELAX_SHAPES,
            "relax_inputs": f"random (90 % / 99 % +inf) and banded (finite "
            f"within {RELAX_BAND} of the diagonal), each without and with "
            "the occupancy map", "relax_occupancy_kept": kept_share,
            "dtype": "float32", "tolerance": "bitwise", "ok": True}


# -- phase 3: the serving path at n = 4096 -----------------------------------

# the kernels the serving path (deploy, window rebuild, submits) launches
SERVING_KERNELS = ("label_join", "label_join_lb", "relax", "minplus_closure",
                   "minplus_kmajor")

def mixed_batch(part, rng, size: int):
    """Seeded mixed-rule batch: cross-district pairs, same-district pairs,
    s == t lanes, and client districts that turn some rule 1 into 2."""
    n = len(part.assignment)
    members = part.districts()
    ss = rng.integers(0, n, size)
    ts = rng.integers(0, n, size)
    same = rng.random(size) < 0.5
    for i in np.nonzero(same)[0]:
        d = members[int(part.assignment[ss[i]])]
        ts[i] = d[rng.integers(len(d))]
    ss[::17] = ts[::17]
    client = part.assignment[ss].astype(np.int32)
    other = rng.random(size) < 0.2
    client[other] = rng.integers(0, part.num_districts, int(other.sum()))
    return ss.astype(np.int64), ts.astype(np.int64), client


def spot_check_dijkstra(g, ss, ts, got, dijkstra, count: int) -> int:
    for i in range(count):
        d = dijkstra(g, int(ss[i]), targets=np.array([ts[i]]))[ts[i]]
        check(np.float32(d) == got[i],
              f"dijkstra mismatch at ({ss[i]}, {ts[i]}): {d} vs {got[i]}")
    return count


def reset_launches(*modules) -> None:
    for mod in modules:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def launch_counts(*modules) -> dict:
    return {k: v for mod in modules for k, v in mod.LAUNCHES.items()}


# the min-plus wrappers whose first calls a path holds, and each one's
# entry in the error table
HELD = {"relax": "relax", "minplus": "minplus",
        "minplus_kmajor": "minplus_kmajor", "closure": "minplus_closure"}


def _clone(x):
    return x.clone() if hasattr(x, "clone") else x


@contextlib.contextmanager
def hold_first_calls(mod, seen: set, held: list):
    """While active, the first call of each wrapper of ``HELD`` at each
    set of operand shapes (and, for ``closure``, squaring count and
    first check) not in ``seen`` keeps copies of its arguments (a
    ``relax`` call's occupancy map too, or None) and of its result in
    ``held``, for ``check_held``. Each call still launches its kernel
    once, as the path does."""
    real = {name: getattr(mod, name) for name in HELD}

    def holding(name):
        def call(*args):
            out = real[name](*args)
            key = (name,) + tuple(tuple(a.shape) if hasattr(a, "shape")
                                  else a for a in args)
            if key not in seen:
                seen.add(key)
                outs = out if isinstance(out, tuple) else (out,)
                held.append((key, [_clone(a) for a in args],
                             [_clone(o) for o in outs]))
            return out
        return call

    for name in real:
        setattr(mod, name, holding(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(mod, name, fn)


def check_held(torch, held: list, errs: dict, what: str) -> list:
    """Holds each kept kernel result against the plain version on the
    same arguments, bit for bit — a ``relax`` result both against the
    plain version without the occupancy map and with the map (the one
    it ran with, or ``relax_occupancy`` of its A where the path ran
    none), a ``closure`` result and its depth against ``closure_ref``;
    returns the calls (name, shapes; for ``relax``: whether the path
    passed a map, and the map's kept share; for ``closure``: squarings,
    first check and depth) and empties ``held``."""
    from repro_torch.kernels.minplus import ref
    plain = {"relax": ref.relax_ref, "minplus": ref.minplus_ref,
             "minplus_kmajor": ref.minplus_kmajor_ref,
             "closure": ref.closure_ref}
    rows = []
    for key, args, outs in held:
        name = key[0]
        row = [name, list(key[1])]
        if name == "closure":
            want, want_depth = plain[name](*args)
            depth = int(outs[1])
            check(depth == want_depth, f"{what}: closure {row[1]} depth "
                  f"{depth} differs from its plain version's {want_depth}")
            wants = [want]
            row += [args[1], args[2], depth]
        elif name == "relax":
            row.append(list(key[2]))
            x, y = args[:2]
            occ = args[2] if len(args) > 2 else None
            occ_ran = occ is not None
            if not occ_ran:
                occ = ref.relax_occupancy(y)
            wants = [plain[name](x, y), plain[name](x, y, occ)]
            row += [occ_ran, float(occ.float().mean())]
        else:
            row.append(list(key[2]))
            wants = [plain[name](*args)]
        for want in wants:
            check(torch.equal(outs[0].view(torch.int32),
                              want.view(torch.int32)),
                  f"{what}: {name} {row[1:3]} differs from its plain "
                  "version")
            errs[HELD[name]] = max(errs[HELD[name]],
                                   max_abs_err(outs[0], want))
        rows.append(row)
        del wants
    held.clear()
    return rows


def phase_serving(torch, dev, launches: dict,
                  errs: dict) -> tuple[dict, dict]:
    from repro_torch.core import (build_border_labels_reference, dijkstra,
                                  perturb_weights)
    from repro_torch.edge import BatchedQueryEngine, EdgeSystem
    from repro_torch.ingest import synthetic_continent
    from repro_torch.kernels.label_join import kernel, ref
    from repro_torch.kernels.minplus import kernel as mp_kernel
    from repro_torch.serve import (CERTIFY_OR_WAIT, INSTALL_NOW, STALE_OK,
                                   ServingPolicy)

    csr, part = synthetic_continent(**SMALL)
    g = csr.to_graph()
    rng = np.random.default_rng(11)
    ss, ts, client = mixed_batch(part, rng, BATCH)

    reset_launches(kernel, mp_kernel)
    seen, held = set(), []
    t0 = time.perf_counter()
    with hold_first_calls(mp_kernel, seen, held):
        system = EdgeSystem.deploy(g, part, builder="torch", device=dev)
    deploy_s = time.perf_counter() - t0
    build_held = check_held(torch, held, errs, "deploy build")
    check({"relax", "closure", "minplus_kmajor"} <= {h[0] for h in build_held},
          f"the deploy's build held no sweep, closure or stage C: "
          f"{build_held}")
    center_build_s = system.center.last_build_seconds
    build_timings = dict(system.center.incremental_builder().timings)
    check(np.array_equal(system.center.border_labels.table,
                         build_border_labels_reference(g, part).table),
          "card-built B differs from the host reference B")
    svc32 = system.service(ServingPolicy(label_dtype="float32"))
    svc16 = system.service(ServingPolicy(label_dtype="uint16"))
    b32 = svc32.submit(ss, ts, client_districts=client)
    b16 = svc16.submit(ss, ts, client_districts=client)
    loop = system.query_loop(ss, ts)

    # window: new integer-second weights, locals refreshed, B rebuilt,
    # shortcut push withheld
    w2 = np.maximum(1.0, np.rint(perturb_weights(g, rng))) \
        .astype(np.float32)
    g2 = system.graph.with_weights(w2)
    system.graph = g2
    for srv in system.servers:
        srv.refresh_local(g2, part)
    system.center.rebuild(w2)
    check(system.current_engine() is None, "window did not open")
    check(np.array_equal(system.center.border_labels.table,
                         build_border_labels_reference(g2, part).table),
          "card-rebuilt B differs from the host reference B")
    t0 = time.perf_counter()
    stale = system.service(ServingPolicy(rebuild=STALE_OK)).submit(
        ss, ts, client_districts=client)
    wait = system.service(ServingPolicy(rebuild=CERTIFY_OR_WAIT)).submit(
        ss, ts, client_districts=client)
    check(system.current_engine() is None,
          "certify_or_wait touched the serving state")
    now = system.service(ServingPolicy(rebuild=INSTALL_NOW)).submit(
        ss, ts, client_districts=client)
    window_s = time.perf_counter() - t0
    for srv in system.servers:             # close the window
        if srv.augmented_version != system.center.version:
            srv.install_shortcuts(g2, part,
                                  system.center.shortcuts_for(
                                      srv.district_id),
                                  system.center.version)
    after32 = svc32.submit(ss, ts, client_districts=client)
    after16 = svc16.submit(ss, ts, client_districts=client)
    launches.update(launch_counts(kernel, mp_kernel))

    # steady state: f32 == u16 == scalar loop == plain ops on the tables
    check(np.array_equal(b32.distances, b16.distances), "f32 vs uint16")
    check(np.array_equal(b32.distances, loop), "engine vs scalar loop")
    eng32, eng16 = svc32.plan(ss, ts).plane, svc16.plan(ss, ts).plane
    check(isinstance(eng32, BatchedQueryEngine) and eng32.quant is None,
          "float32 engine not selected")
    check(isinstance(eng16, BatchedQueryEngine)
          and eng16.quant is not None and eng16.quant.lossless,
          "lossless uint16 engine not selected")
    for eng, batch in ((eng32, after32), (eng16, after16)):
        rs, rt_ = (torch.from_numpy(x).to(dev) for x in eng.row_ids(ss, ts))
        quant = None if eng.quant is None else eng.quant.key()
        plain = ref.gather_join_ref(eng.table, rs, eng.table, rt_,
                                    quant=quant).cpu().numpy()
        check(np.array_equal(plain, batch.distances),
              "engine vs plain version on the same tables")
    rules = np.bincount(b32.rules, minlength=4)[1:].tolist()
    check(all(r > 0 for r in rules), f"batch lacks a rule: {rules}")
    check(b32.exact.all() and not b32.fallback.any(), "steady flags")
    spots = spot_check_dijkstra(g, ss, ts, b32.distances, dijkstra, 6)

    # window: certified answers agree across modes, flags as specified
    cert = stale.exactness_codes == 1
    same = part.assignment[ss] == part.assignment[ts]
    check(cert.any() and (~stale.exact).any(), "window lacks both kinds")
    check(np.array_equal(stale.fallback, same)
          and np.array_equal(wait.fallback, same), "fallback flags")
    check(np.array_equal(stale.distances[cert], wait.distances[cert])
          and np.array_equal(stale.distances[cert], now.distances[cert]),
          "certified answers differ across modes")
    check(np.array_equal(wait.exactness_codes == 1, cert)
          and np.array_equal(now.exactness_codes == 1, cert),
          "certificates differ across modes")
    residue = same & ~cert
    check(np.all(stale.exactness_codes[residue] == 2)
          and not stale.waited.any(), "stale_ok residue flags")
    check(np.array_equal(wait.waited, residue)
          and wait.exact.all(), "certify_or_wait residue flags")
    check(np.array_equal(wait.distances, now.distances),
          "certify_or_wait vs install_now")
    check(np.array_equal(after32.distances, now.distances)
          and np.array_equal(after16.distances, now.distances),
          "post-window steady state vs install_now")
    spots += spot_check_dijkstra(g2, ss, ts, after32.distances, dijkstra, 6)
    check(all(launches[k] > 0 for k in SERVING_KERNELS),
          f"main path missed a kernel: {launches}")
    # stage B: one fused closure launch per build (deploy and window), no
    # tiled squaring (q = 93 <= the cap)
    check(launches["minplus_closure"] == 2 and launches["minplus"] == 0,
          f"stage B did not run as one launch per build: {launches}")

    shapes = {
        "engine_f32": (eng32.table, *eng32.row_ids(ss, ts), None),
        "engine_u16": (eng16.table, *eng16.row_ids(ss, ts),
                       eng16.quant.key()),
    }
    # the Local Bound's shape on this path: one district's border_dist
    # and that district's same-district lanes
    d0 = int(np.argmax(np.bincount(part.assignment[ss][same],
                                   minlength=part.num_districts)))
    sel = np.nonzero(same & (part.assignment[ss] == d0))[0]
    plain0 = system.servers[d0].plain
    shapes["lb_window"] = (plain0.border_dist_device(),
                           plain0.local_of(ss[sel]),
                           plain0.local_of(ts[sel]), None)
    out = {"phase": "serving_n4096", "n": int(g.num_vertices),
           "districts": int(part.num_districts),
           "borders": int(len(system.center.border_labels.border_ids)),
           "combined_table": list(eng32.table.shape),
           "batch": BATCH, "rules_1_2_3": rules,
           "certified": int(cert.sum()), "residue": int(residue.sum()),
           "deploy_s": deploy_s, "center_build_s": center_build_s,
           "edge_local_build_s": deploy_s - center_build_s,
           "center_build_steps": build_timings,
           "build_held_against_plain": build_held,
           "b_equals_host_reference": True, "window_submit_s": window_s,
           "dijkstra_spot_pairs": spots, "launches": dict(launches),
           "ok": True}
    return out, {"system": system, "svc32": svc32, "svc16": svc16,
                 "ss": ss, "ts": ts, "client": client, "shapes": shapes,
                 "first_answers": b32.distances,
                 "build_state": system.center.incremental_builder().state}


# -- phase 4: the rule-3 join at n = 102 400 ---------------------------------

def host_stage_a(g, part, packed) -> np.ndarray:
    """The host's stage A (restricted Dijkstra from every border) in the
    staged builder's padded (m, bmax, kmax) layout."""
    from repro_torch.core.border_labeling import intra_district_distances
    out = np.full((packed.num_districts, packed.bmax, packed.kmax), np.inf,
                  dtype=np.float32)
    for i, dd in enumerate(intra_district_distances(g, part)):
        out[i, :dd.dist.shape[0], :dd.dist.shape[1]] = dd.dist
    return out


def phase_center(torch, dev, errs: dict
                 ) -> tuple[dict, dict, object, dict]:
    from repro_torch.core import (QuantSpec, build_border_labels_hierarchical,
                                  dijkstra)
    from repro_torch.edge import ComputingCenter
    from repro_torch.ingest import synthetic_continent
    from repro_torch.kernels.label_join import kernel, ops, ref
    from repro_torch.kernels.minplus import kernel as mp_kernel

    csr, part = synthetic_continent(**LARGE)
    g = csr.to_graph()
    t0 = time.perf_counter()
    host_b = build_border_labels_hierarchical(g, part).table
    build_s = time.perf_counter() - t0

    # B built on the card by the staged builder
    reset_launches(kernel, mp_kernel)
    center = ComputingCenter(g, part, builder="torch", device=dev)
    seen, held = set(), []
    with hold_first_calls(mp_kernel, seen, held):
        staged_s = center.rebuild()
    build_launches = launch_counts(mp_kernel)
    build_held = check_held(torch, held, errs, "center build")
    check(any(h[0] == "relax" for h in build_held)
          and any(h[0] == "closure" for h in build_held)
          and any(h[0] == "minplus_kmajor" for h in build_held),
          f"no stage-A sweep, closure or stage-C product held: {build_held}")
    state = center.incremental_builder().state
    steps = dict(center.incremental_builder().timings)
    bl = center.border_labels
    check(np.array_equal(bl.table, host_b),
          "card-built B differs from the host hierarchical B at n = 102400")
    t0 = time.perf_counter()
    check(np.array_equal(state.intra, host_stage_a(g, part, state.packed)),
          "card stage A differs from the host Dijkstra stage A")
    host_stage_a_s = time.perf_counter() - t0
    check(build_launches["relax"] > 0
          and build_launches["minplus_closure"] == 1
          and build_launches["minplus_kmajor"] == 1
          and build_launches["minplus"] == 0,
          f"the staged build's launches: {build_launches}")

    spec = QuantSpec.fit(bl.table)
    check(spec.lossless, "B does not quantize losslessly")
    codes = ops.upload(spec.quantize(bl.table), dev)
    btab = center.border_table_device()
    check(btab is state.table_device, "B was uploaded again")
    rng = np.random.default_rng(5)
    n = g.num_vertices
    reset_launches(kernel)
    shapes = {}
    spots = 0
    for q in CENTER_BATCHES:
        ss = rng.integers(0, n, 2 * q)
        ts = rng.integers(0, n, 2 * q)
        cross = np.nonzero(part.assignment[ss] != part.assignment[ts])[0]
        ss, ts = ss[cross[:q]], ts[cross[:q]]
        a = center.answer_cross_many(ss, ts)
        b = ops.join_quantized_gathered(codes, ss, ts, sentinel=spec.sentinel,
                                        scale=spec.scale)
        check(np.array_equal(a, b), f"rule-3 f32 vs uint16 at Q={q}")
        rs = torch.from_numpy(ss).to(dev)
        rt_ = torch.from_numpy(ts).to(dev)
        plain = ref.gather_join_ref(btab, rs, btab, rt_)
        check(np.array_equal(plain.cpu().numpy(), a),
              f"rule-3 kernel vs plain at Q={q}")
        errs["label_join"] = max(errs["label_join"], max_abs_err(
            torch.from_numpy(a), plain.cpu()))
        spots += spot_check_dijkstra(g, ss, ts, a, dijkstra, 2)
        shapes[f"rule3_f32_q{q}"] = (btab, ss, ts, None)
        shapes[f"rule3_u16_q{q}"] = (codes, ss, ts, spec.key())
    out = {"phase": "rule3_n102400", "n": int(n),
           "districts": int(part.num_districts),
           "kmax": state.packed.kmax, "bmax": state.packed.bmax,
           "borders": int(bl.table.shape[1]),
           "adjacency_gb": state.packed.adj.nbytes / 1e9,
           "b_table_mb": bl.table.nbytes / 1e6,
           "staged_build_s": staged_s, "staged_build_steps": steps,
           "build_held_against_plain": build_held,
           "stage_a_sweeps": steps["stage_a_sweeps"],
           "stage_a_pack_s": steps["stage_a_pack_s"],
           "stage_a_sweeps_s": steps["stage_a_sweeps_s"],
           "hierarchical_build_s": build_s,
           "host_stage_a_s": host_stage_a_s,
           "b_equals_host_hierarchical": True,
           "intra_equals_host_dijkstra": True,
           "build_launches": build_launches,
           "batches": list(CENTER_BATCHES),
           "dijkstra_spot_pairs": spots,
           "join_launches": dict(kernel.LAUNCHES), "ok": True}
    return out, shapes, state, {"inc": center.incremental_builder(),
                                "graph": g, "partition": part}


# -- phase 4b: stage B on each side of the fused closure's cap ----------------

# synthetic continents whose overlays sit at the cap (q = 160: the fused
# closure's largest) and above it (q = 239: the tiled kernel's squarings)
AT_CAP = dict(grid=(5, 5), district=(12, 12), border_links=2, seed=7)
ABOVE_CAP = dict(grid=(6, 6), district=(10, 10), border_links=2, seed=7)


def phase_closure_cap(torch, dev, errs: dict, launches: dict
                      ) -> tuple[dict, dict]:
    """B built on the card by the staged builder at q = 160 (one fused
    closure launch) and q = 239 (⌈log2 q⌉ tiled squarings), each held
    against the host reference; the second build is the tiled kernel's
    path: its launches go into ``launches["minplus"]``."""
    from repro_torch.core import build_border_labels_reference
    from repro_torch.edge import ComputingCenter
    from repro_torch.ingest import synthetic_continent
    from repro_torch.kernels.minplus import kernel as mp_kernel, ops

    rows, states = [], {}
    for tag, cfg in (("at_cap", AT_CAP), ("above_cap", ABOVE_CAP)):
        csr, part = synthetic_continent(**cfg)
        g = csr.to_graph()
        center = ComputingCenter(g, part, builder="torch", device=dev)
        seen, held = set(), []
        reset_launches(mp_kernel)
        with hold_first_calls(mp_kernel, seen, held):
            build_s = center.rebuild()
        counts = launch_counts(mp_kernel)
        held_rows = check_held(torch, held, errs, f"build {tag}")
        q = len(center.border_labels.border_ids)
        check(np.array_equal(center.border_labels.table,
                             build_border_labels_reference(g, part).table),
              f"card-built B differs from the host reference at q = {q}")
        fused = q <= mp_kernel.CLOSURE_MAX_Q
        check(fused == (tag == "at_cap"), f"{tag}: q = {q}")
        check(counts["minplus_closure"] == int(fused)
              and counts["minplus"] == (0 if fused
                                        else ops.closure_steps(q))
              and counts["minplus_kmajor"] == 1 and counts["relax"] > 0,
              f"{tag} build's launches: {counts}")
        if not fused:
            launches["minplus"] = counts["minplus"]
        states[tag] = center.incremental_builder().state
        rows.append({"build": tag, "n": int(g.num_vertices),
                     "districts": int(part.num_districts), "q": q,
                     "build_s": build_s, "launches": counts,
                     "held_against_plain": held_rows,
                     "b_equals_host_reference": True})
    return {"phase": "closure_cap", "cap": mp_kernel.CLOSURE_MAX_Q,
            "builds": rows, "ok": True}, states


# -- phase 5: times ----------------------------------------------------------

def event_ms(torch, fn, reps: int) -> float:
    """Mean time per call of ``fn`` called back to back, between two CUDA
    events: device time plus whatever host time the calls cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(torch, fn, inputs: list, calls: int = 20,
              replays: int = 20) -> float:
    """Device time per call of ``fn(*inputs[i])``: at least ``calls``
    calls, cycling through ``inputs``, captured in one CUDA graph; the
    graph replayed ``replays`` times between two events, so host time
    between launches drops out."""
    calls = len(inputs) * -(-calls // len(inputs))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn(*inputs[0])
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
    return event_ms(torch, graph.replay, replays) / calls


def cold_inputs(args: tuple, touched: int) -> tuple[list, bool]:
    """Copies of the tensors ``args`` to cycle through, so that between
    two reads of one copy the other copies' touched bytes (``touched``
    per call) sweep at least twice the L2 and every call reads its
    inputs from HBM. Returns the copies and whether that margin was
    reached (a tiny call would need more copies than ``MAX_COPIES``)."""
    want = -(-2 * L2_BYTES // max(touched, 1)) + 1
    size = sum(x.numel() * x.element_size() for x in args)
    budget = COPY_BUDGET_BYTES // (size + 1)
    k = int(max(2, min(want, MAX_COPIES, budget)))
    copies = [args] + [tuple(x.clone() for x in args) for _ in range(k - 1)]
    return copies, (k - 1) * touched >= 2 * L2_BYTES


def join_lanes_ms(torch, kernel, ref, table, rs, rt, quant, with_lb: bool,
                  inputs) -> dict:
    """The join kernel at every lane count a query could take (1 to 32),
    through the C entry's lanes override, each held against the plain
    version once: what the entry's own pick of lanes is worth."""
    fn = kernel._lib().repro_label_join
    q, w = rs.shape[0], table.shape[1]
    code, sentinel, scale = (kernel._FLOAT_CODES[table.dtype], 0, 1.0) \
        if quant is None else (1 if quant[0] == 0xFFFF else 2, quant[0],
                               quant[1])
    # float rows come back in their own type, codes in float32
    out_dtype = table.dtype if quant is None else torch.float32

    def run(lanes):
        def call(tab, a, b):
            out = torch.empty(q, dtype=out_dtype, device=tab.device)
            lb = torch.empty(q, dtype=out_dtype, device=tab.device) \
                if with_lb else None
            err = fn(code, int(with_lb), lanes, tab.data_ptr(),
                     a.data_ptr(), tab.shape[0], tab.data_ptr(), b.data_ptr(),
                     tab.shape[0], q, w, sentinel, scale, out.data_ptr(),
                     0 if lb is None else lb.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"join with {lanes} lanes: CUDA error {err}")
            return out if lb is None else (out, lb)
        return call

    want = ref.gather_join_ref(table, rs, table, rt, quant=quant,
                               with_lb=with_lb)
    out = {}
    for lanes in (1, 2, 4, 8, 16, 32):
        got = run(lanes)(table, rs, rt)
        check(all(torch.equal(x, y) for x, y in zip(
            got if with_lb else (got,), want if with_lb else (want,))),
            f"join with {lanes} lanes differs from the plain version")
        out[lanes] = device_ms(torch, run(lanes), inputs)
    return out


def time_shape(torch, kernel, ref, name, table, ss, ts, quant) -> dict:
    with_lb = name.startswith("lb")
    ss = np.ascontiguousarray(ss, dtype=np.int64)
    ts = np.ascontiguousarray(ts, dtype=np.int64)
    rs, rt = torch.from_numpy(ss).cuda(), torch.from_numpy(ts).cuda()
    q, w = len(ss), table.shape[1]
    itemsize = table.element_size()
    # bytes the join must move: every distinct row it reads once (both
    # sides read the same table), the row ids, and the outputs
    rows = len(np.union1d(ss, ts))
    table_bytes = rows * w * itemsize
    nbytes = table_bytes + 16 * q + (8 if with_lb else 4) * q
    ops = (4 if with_lb else 2) * q * w
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    cold, from_hbm = cold_inputs((table, rs, rt), table_bytes + 16 * q)
    warm = [(table, rs, rt)]

    def launch(tab, a, b):
        return kernel.gather_join(tab, a, tab, b, quant=quant,
                                  with_lb=with_lb)

    def plain(tab, a, b):
        return ref.gather_join_ref(tab, a, tab, b, quant=quant,
                                   with_lb=with_lb)

    before = dict(kernel.LAUNCHES)
    kernel_ms = device_ms(torch, launch, cold)
    warm_ms = device_ms(torch, launch, warm)
    call_ms = event_ms(torch, lambda: launch(*warm[0]), 200)
    kernel.LAUNCHES.update(before)      # timing launches are not the path's
    vec, lanes = kernel.join_layout(table, table, q)
    lanes_ms = join_lanes_ms(torch, kernel, ref, table, rs, rt, quant,
                             with_lb, cold)
    plain_ms = device_ms(torch, plain, cold)
    library_ms = None
    if quant is None and not with_lb:
        library_ms = device_ms(torch, lambda tab, a, b: torch.amin(
            tab[a].float() + tab[b].float(), 1), cold)
    copies = len(cold)
    del cold
    bound_ms = max(bytes_ms, ops_ms)
    return {"shape": name, "kernel": "label_join_lb" if with_lb
            else "label_join", "q": q, "w": w, "itemsize": itemsize,
            "distinct_rows": rows, "bytes": nbytes, "ops": ops,
            "copies": copies, "rows_from_hbm": from_hbm,
            "vec_bytes": vec, "lanes": lanes, "lanes_ms": lanes_ms,
            "kernel_ms": kernel_ms, "l2_warm_ms": warm_ms,
            "wrapper_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": bound_ms / kernel_ms if from_hbm else None}


def builder_shapes(torch, tag: str, st, stages: str = "abc") -> dict:
    """The staged builder's kernel inputs at one size, rebuilt on the
    card from its host ``BuildState``: stage A's sweep (the converged
    distances and the dense adjacency), stage B's closure (its input:
    the overlay with a 0 diagonal) and stage C's k-major product; only
    the ``stages`` named."""
    slot = st.packed.border_slot
    crows = np.where((slot >= 0)[..., None],
                     st.closure[np.clip(slot, 0, None)], np.inf)
    q = st.overlay.shape[0]
    d0 = np.minimum(st.overlay, np.where(np.eye(q, dtype=bool), 0.0, np.inf))
    up = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).cuda()
          for x in (st.intra, st.packed.adj, d0, crows)]
    intra, adj, d0, crows = up
    shapes = {f"stage_a_{tag}": ("relax", (intra, adj)),
              f"closure_{tag}": ("minplus_closure", (d0,)),
              f"stage_c_{tag}": ("minplus_kmajor", (intra, crows))}
    shapes = {k: v for k, v in shapes.items()
              if {"relax": "a", "minplus_closure": "b",
                  "minplus_kmajor": "c"}[v[0]] in stages}
    if "a" in stages and adj.shape[0] > 1:
        # a one-district repair's sweep: the dirty district alone
        shapes[f"stage_a_{tag}_one_district"] = (
            "relax", (intra[:1].clone(), adj[:1].clone()))
    return shapes


def closure_input_shape(torch, tag: str, st) -> dict:
    """One squaring of the tiled kernel at the closure input of a build
    above the fused kernel's cap."""
    q = st.overlay.shape[0]
    d0 = np.minimum(st.overlay, np.where(np.eye(q, dtype=bool), 0.0, np.inf))
    d0 = torch.from_numpy(np.ascontiguousarray(d0, np.float32)).cuda()
    return {f"squaring_{tag}": ("minplus", (d0, d0))}


def time_builder_shape(torch, name: str, kernel_name: str, args: tuple,
                       peak: dict) -> dict:
    """One builder kernel at one shape: its time with inputs from HBM,
    its plain version's, and its bounds. ``relax`` is timed as
    ``multi_source`` calls it (``kernel_ms``: with the occupancy map
    where ``sssp_relax.ops.occupancy_map`` builds one, else without), and
    also with the map (``mapped_ms``) and without it (``dense_ms``);
    ``occupancy_ms`` is the cost of building the map, and
    ``map_pays_after_sweeps`` how many sweeps repay it. Its bytes bound
    counts what these inputs need (D read, D' written, 4 bytes per finite
    entry of A), its dense bound A whole (the bound of earlier rows).
    ``minplus_closure`` is the whole closure at the fixed schedule (one
    launch), beside the tiled kernel's loop of as many squarings
    (``loop_ms``) and one of them (``squaring_ms``); ``minplus_kmajor``
    is stage C's product beside the tiled kernel on a transposed copy
    made beforehand (``generic_ms``) and with the copy (the earlier
    path, ``generic_with_copy_ms``)."""
    from repro_torch.kernels.minplus import kernel, ops, ref
    from repro_torch.kernels.sssp_relax import ops as sssp_ops
    relax = kernel_name == "relax"
    x = args[0]
    row = {"shape": name, "kernel": kernel_name,
           "dims": [list(a.shape) for a in args]}
    before = dict(kernel.LAUNCHES)
    if kernel_name == "minplus_closure":
        q = x.shape[0]
        steps = ops.closure_steps(q)

        def fn(d):
            return kernel.closure(d, steps, steps)[0]

        def plain(d):
            return ref.closure_ref(d, steps, steps)[0]

        terms = steps * q ** 3
        row["steps"] = steps
    elif kernel_name == "minplus_kmajor":
        fn, plain = kernel.minplus_kmajor, ref.minplus_kmajor_ref
        terms = x.numel() * args[1].shape[-1]
    else:
        fn = getattr(kernel, kernel_name)
        plain = ref.relax_ref if relax else ref.minplus_ref
        batch = x.shape[0] if x.dim() == 3 else 1
        terms = batch * x.shape[-2] * x.shape[-1] * args[1].shape[-1]
        if not relax:
            row["layout"] = kernel.minplus_layout(*args)
    out = fn(*args)
    in_bytes = sum(a.numel() for a in args) * 4
    dense_bytes = in_bytes + out.numel() * 4
    row["terms"] = terms
    if relax:
        y = args[1]
        occ = kernel.relax_occupancy(y)
        uses_map = sssp_ops.occupancy_map(y) is not None
        args = (x, y, occ)
        finite = int(torch.isfinite(y).sum())
        nbytes = (x.numel() + out.numel() + finite) * 4
        # the terms these inputs need: one per D row and finite A entry
        terms = x.shape[-2] * finite
        row.update(finite_a=finite, terms_needed=terms,
                   occupancy_kept=float(occ.float().mean()),
                   multi_source_uses_map=uses_map,
                   occupancy_ms=event_ms(
                       torch, lambda: kernel.relax_occupancy(y), 10),
                   dense_bytes=dense_bytes,
                   dense_bytes_ms=dense_bytes / PEAK_BYTES_PER_S * 1e3)
    else:
        nbytes = dense_bytes
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = terms / peak["terms_per_s"] * 1e3
    if in_bytes >= 2 * L2_BYTES:        # each call streams from HBM
        inputs, from_hbm, calls, replays = [args], True, 4, 3
    else:
        (inputs, from_hbm), calls, replays = \
            cold_inputs(args, in_bytes), 20, 20
    kernel_ms = device_ms(torch, fn, inputs, calls, replays)
    if relax:
        row["mapped_ms"] = kernel_ms
        row["dense_ms"] = device_ms(torch, lambda d, a, o: fn(d, a), inputs,
                                    calls, replays)
        saved = row["dense_ms"] - row["mapped_ms"]
        row["map_pays_after_sweeps"] = \
            row["occupancy_ms"] / saved if saved > 0 else None
        if not uses_map:
            kernel_ms = row["dense_ms"]
    elif kernel_name == "minplus_closure":
        def loop(d):
            for _ in range(steps):
                d = kernel.minplus(d, d)
            return d
        row["loop_ms"] = device_ms(torch, loop, inputs, calls, replays)
        # where the launch's time goes: no squaring (load and store), one
        # squaring
        row["no_squaring_ms"] = device_ms(
            torch, lambda d: kernel.closure(d, 0, 0)[0], inputs, calls,
            replays)
        row["one_squaring_ms"] = device_ms(
            torch, lambda d: kernel.closure(d, 1, 1)[0], inputs, calls,
            replays)
        row["squaring_ms"] = device_ms(torch, lambda d: kernel.minplus(d, d),
                                       inputs, calls, replays)
        check(torch.equal(loop(x), out), f"{name}: the fused closure "
              "differs from the tiled kernel's squarings")
    elif kernel_name == "minplus_kmajor":
        copied = [(a.transpose(-1, -2).contiguous(), b) for a, b in inputs]
        row["generic_ms"] = device_ms(torch, kernel.minplus, copied, calls,
                                      replays)
        row["generic_with_copy_ms"] = device_ms(
            torch, lambda a, b: kernel.minplus(a.transpose(-1, -2)
                                               .contiguous(), b),
            inputs, calls, replays)
        check(torch.equal(kernel.minplus(*copied[0]), out),
              f"{name}: the k-major product differs from the tiled kernel")
        del copied
    kernel.LAUNCHES.update(before)      # timing launches are not the path's
    plain_ms = device_ms(torch, lambda *a: plain(*a[:2]) if relax
                         else plain(*a), inputs, min(calls, 4),
                         min(replays, 3))
    copies = len(inputs)
    del inputs
    bound_ms = max(bytes_ms, ops_ms)
    row.update(bytes=nbytes, copies=copies, inputs_from_hbm=from_hbm,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
               bytes_ms=bytes_ms, ops_ms=ops_ms,
               ops_ms_2_instructions=2 * terms / peak["two_instruction_"
                                                      "ops_per_s"] * 1e3,
               ops_ms_measured_rate=terms / peak["measured_terms_per_s"]
               * 1e3,
               bound_ms=bound_ms,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               share_of_bound=bound_ms / kernel_ms if from_hbm else None)
    if relax:
        row["share_of_dense_bound"] = \
            row["dense_bytes_ms"] / kernel_ms if from_hbm else None
    return row


def phase_builder_times(torch, states: dict, at_cap: dict, above_cap: dict,
                        peak: dict) -> dict:
    shapes = {}
    for tag, st in states.items():
        shapes.update(builder_shapes(torch, tag, st))
    for tag, st in at_cap.items():
        shapes.update(builder_shapes(torch, tag, st, stages="b"))
    for tag, st in above_cap.items():
        shapes.update(closure_input_shape(torch, tag, st))
    # a large-q squaring of the tiled kernel: (1024, 1024), 90 % +inf
    gen = torch.Generator(device="cuda").manual_seed(3)
    big = rand_dist(torch, gen, (1024, 1024), 0.9)
    shapes["squaring_q1024"] = ("minplus", (big, big))
    rows = [time_builder_shape(torch, name, kname, args, peak)
            for name, (kname, args) in shapes.items()]
    return {"phase": "builder_times", "timer": "device ms per launch from "
            "CUDA-graph replays timed with CUDA events; below 2x the L2 the "
            "calls cycle through copies of the inputs (inputs_from_hbm), "
            "above it each call streams its inputs from HBM; relax as "
            "multi_source calls it (kernel_ms), with the occupancy map "
            "(mapped_ms) and without it (dense_ms); occupancy_ms: "
            "relax_occupancy, CUDA events around 10 back-to-back calls "
            "(device and host time), once per multi_source call; "
            "minplus_closure: the whole closure (steps squarings, one "
            "launch), loop_ms: the same squarings as tiled launches, "
            "squaring_ms: one of them; minplus_kmajor: stage C, "
            "generic_ms: the tiled kernel on a transposed copy, "
            "generic_with_copy_ms: the copy and the tiled kernel; "
            "minplus rows: layout, the tiled kernel's launch shape; "
            "squaring_q448: the NY-scale build's own overlay (phase "
            "ingest_dimacs_ny_scale)",
            "bound": "max(bytes at 3.35 TB/s, terms / the (min, +) issue "
            "ceiling of phase minplus_peak); closure: terms = steps x q^3, "
            "bytes = D read + written once; relax: bytes = D + D' + "
            "4 x finite entries of A, terms = rows x finite entries of A "
            "(dense_bytes_ms: A whole, as in earlier rows); "
            "ops_ms_2_instructions: 2 instructions per term on SMs x 128 "
            "lanes x max SM clock; ops_ms_measured_rate: at the fastest "
            "rate measured", "library_ms": "null: no single "
            "PyTorch call computes a (min, +) product",
            "sm_count": peak["sm_count"],
            "max_sm_clock_mhz": peak["max_sm_clock_mhz"], "rows": rows,
            "ok": True}


def cuobjdump_sass(lib: Path, pattern: str) -> dict:
    """The instructions (address, mnemonic before its first dot, operand
    text) of each function of ``lib`` whose name matches ``pattern``,
    from ``cuobjdump -sass``; {} where the tool is missing."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)(\S*)\s*([^;]*)", line)
        if m and name:
            out.setdefault(name, []).append(
                (int(m.group(1), 16), m.group(2), m.group(4)))
    return out


def mnemonic_counts(instrs: list) -> dict:
    counts: dict = {}
    for _, mnemonic, _ in instrs:
        counts[mnemonic] = counts.get(mnemonic, 0) + 1
    return counts


def loop_body(instrs: list) -> list:
    """The instructions of the longest loop of a function: from the
    target of a backward ``BRA`` (an absolute address in cuobjdump's
    text) to the branch; [] where there is none."""
    import re
    best: list = []
    for addr, mnemonic, operands in instrs:
        m = re.search(r"0x([0-9a-f]+)", operands)
        if mnemonic != "BRA" or not m or int(m.group(1), 16) >= addr:
            continue
        body = [i for i in instrs if int(m.group(1), 16) <= i[0] <= addr]
        if len(body) > len(best):
            best = body
    return best


def term_instructions(body: list) -> dict:
    """Per (min, +) term of a loop body whose only float adds are its
    terms' (one FADD a term): the instructions that compute the terms
    (FADD, FMNMX, VIMNMX3) and all the loop's instructions."""
    counts = mnemonic_counts(body)
    terms = counts.get("FADD", 0)
    if not terms:
        return {}
    arith = terms + counts.get("FMNMX", 0) + counts.get("VIMNMX3", 0)
    return {"terms": terms, "term_instructions_per_term": arith / terms,
            "instructions_per_term": len(body) / terms, "loop": counts}


# the (min, +) peak: blocks per SM and iterations of each timed launch
PEAK_BLOCKS_PER_SM = 8
PEAK_ITERS = 4096


def phase_minplus_peak(torch, smi: str) -> dict:
    """The (min, +) issue ceiling and the sustained rate of the two term
    forms the kernels can use (``minplus_peak.cu``). Each form's
    instructions per term come from its SASS loop (where cuobjdump is
    missing, from ``NOMINAL_INSTRUCTIONS_PER_TERM``); the ceiling, the
    operations rate of the min-plus bounds, is SMs x 128 lanes x max SM
    clock over the fewest. The rates in registers on all SMs, timed with
    CUDA events, show that the card sustains it."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.minplus import kernel
    lib = build.load(kernel.PEAK_SOURCE)
    fn = lib.repro_minplus_peak
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    blocks = sms * PEAK_BLOCKS_PER_SM
    out = torch.empty(blocks * 256, device="cuda")
    per_iteration = lib.repro_minplus_peak_terms()
    terms = blocks * 256 * PEAK_ITERS * per_iteration
    sass = cuobjdump_sass(build.library_path(kernel.PEAK_SOURCE),
                          "minplus_peak")
    forms = {}
    for form, label in ((0, "fadd_fmnmx"), (1, "fadd_vimin3")):
        def run():
            err = fn(out.data_ptr(), form, blocks, PEAK_ITERS,
                     torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"minplus_peak launch failed: CUDA error {err}")
        ms = event_ms(torch, run, 5)
        check(bool(torch.isfinite(out).all()), "minplus_peak output")
        body = next((term_instructions(loop_body(instrs))
                     for name, instrs in sass.items()
                     if f"ILi{form}E" in name), {})
        # a loop of u iterations computes u x terms_per_iteration sums;
        # fewer FADDs would mean the compiler shared sums between terms
        check(not body or body["terms"] % per_iteration == 0,
              f"minplus_peak form {form}: {body.get('terms')} FADDs in its "
              f"loop, not a multiple of {per_iteration} terms")
        ipt = body.get("term_instructions_per_term",
                       NOMINAL_INSTRUCTIONS_PER_TERM[form])
        forms[label] = {"ms": ms, "terms_per_s": terms / ms * 1e3,
                        "terms_per_sm_per_clock":
                            terms / ms * 1e3 / sms / (clock_mhz * 1e6),
                        "term_instructions_per_term": ipt,
                        "instructions_per_term_from":
                            "sass loop" if body else "nominal",
                        "sass_loop": body}
    lanes = sms * MINPLUS_LANES_PER_SM * clock_mhz * 1e6
    fewest = min(forms, key=lambda k: forms[k]["term_instructions_per_term"])
    fastest = max(forms, key=lambda k: forms[k]["terms_per_s"])
    ceiling = lanes / forms[fewest]["term_instructions_per_term"]
    measured = forms[fastest]["terms_per_s"]
    check(measured <= ceiling * 1.001, f"minplus_peak: measured "
          f"{measured:.4g} terms/s above the issue ceiling {ceiling:.4g}")
    return {"phase": "minplus_peak", "nvidia_smi": smi, "sm_count": sms,
            "max_sm_clock_mhz": clock_mhz, "blocks": blocks,
            "iterations": PEAK_ITERS, "terms_per_launch": terms,
            "forms": forms, "ceiling_form": fewest,
            "terms_per_s": ceiling,
            "terms_per_sm_per_clock": ceiling / sms / (clock_mhz * 1e6),
            "fastest": fastest, "measured_terms_per_s": measured,
            "measured_share_of_ceiling": measured / ceiling,
            "two_instruction_ops_per_s": lanes,
            "two_instruction_terms_per_s": lanes / 2,
            "sass": {name: mnemonic_counts(instrs)
                     for name, instrs in sass.items()},
            "rate": "terms_per_s: the issue ceiling, SMs x 128 lanes x "
            "max SM clock / term instructions per term of ceiling_form "
            "(its SASS loop); measured_terms_per_s: the fastest form in "
            "registers", "timer": "CUDA events around 5 launches after 3 "
            "warm-ups", "ok": True}


# -- phase 5b: the Floyd–Warshall APSP entry point ---------------------------

# (n, integral) cases held against the plain version: bit for bit on
# integral weights, rtol 1e-5 on real ones (the JAX package's tolerance
# for its blocked kernel against the rank-1 loop)
FW_SIZES = (1, 33, 100, 128, 130, 257, 300)
FW_RTOL = 1e-5


def fw_bound(n: int, peak: dict) -> dict:
    """Bytes, terms and bounds of one (n, n) APSP: the matrix read once
    and written once; n^3 (min, +) terms at the issue ceiling (and,
    beside it, at 2 instructions per term on 128 lanes and at the
    fastest rate measured)."""
    nbytes = 2 * n * n * 4
    terms = n ** 3
    return {"bytes": nbytes, "terms": terms,
            "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "ops_ms": terms / peak["terms_per_s"] * 1e3,
            "ops_ms_2_instructions":
                2 * terms / peak["two_instruction_ops_per_s"] * 1e3,
            "ops_ms_measured_rate":
                terms / peak["measured_terms_per_s"] * 1e3}


def fw_phase_ms(torch, kernel, adj) -> dict:
    """Device ms per launch of phases 1, 2 and 3 of the pivot block in
    the middle of ``adj``'s working copy (CUDA events around 20 launches
    of each after 3 warm-ups; phase 3 reads the scratch panel its phase
    2 wrote)."""
    fn = kernel.phase_entry()
    d = kernel.working_copy(adj)
    n = d.shape[0]
    ct = torch.empty((kernel.TILE, n), dtype=torch.float32, device=d.device)
    kb = n // kernel.TILE // 2
    times = {}
    for phase in (1, 2, 3):
        def run():
            err = fn(d.data_ptr(), ct.data_ptr(), n, kb, phase,
                     torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"floyd_warshall phase {phase} launch failed: "
                  f"CUDA error {err}")
        times[f"phase{phase}_ms"] = event_ms(torch, run, 20)
    times["per_pivot_ms"] = sum(times.values())
    times["pivots"] = n // kernel.TILE
    times["sum_ms"] = times["per_pivot_ms"] * times["pivots"]
    return times


def district_graph(adj: np.ndarray):
    """The district's subgraph from its dense adjacency (host)."""
    from repro_torch.core import from_edges
    u, v = np.nonzero(np.isfinite(adj) & ~np.eye(len(adj), dtype=bool))
    keep = u < v
    return from_edges(len(adj), u[keep].astype(np.int32),
                      v[keep].astype(np.int32), adj[u[keep], v[keep]])


def phase_fw_kernels(torch, dev, errs: dict, launches: dict, st,
                     peak: dict) -> dict:
    from repro_torch.core import dijkstra
    from repro_torch.kernels import build
    from repro_torch.kernels.sssp_relax import kernel, ops, ref
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for n in FW_SIZES:
        for integral in (True, False):
            adj = rand_dist(torch, gen, (n, n), 0.8)
            if integral:
                adj = torch.ceil(adj)
            adj = torch.minimum(adj, adj.T).contiguous()
            got = kernel.floyd_warshall(adj)
            sync(torch, dev)
            want = ref.floyd_warshall_ref(adj)
            err = max_abs_err(got, want)
            if integral:
                check(torch.equal(got, want), f"floyd_warshall {n} integral")
            else:
                fin = torch.isfinite(want)
                check(torch.equal(torch.isfinite(got), fin)
                      and bool(((got - want).abs()[fin]
                                <= FW_RTOL * want.abs()[fin]).all()),
                      f"floyd_warshall {n} real: beyond rtol {FW_RTOL}")
            errs["floyd_warshall"] = max(errs["floyd_warshall"], err)
            cases.append({"n": n, "integral": integral, "max_abs_err": err})
    small = torch.ceil(rand_dist(torch, gen, (70, 70), 0.7) / 10)
    small = torch.minimum(small, small.T).contiguous()
    got16 = ops.floyd_warshall(small.bfloat16())
    check(got16.dtype == torch.bfloat16 and torch.equal(
        got16, ref.floyd_warshall_ref(small).bfloat16()),
          "floyd_warshall bf16")

    # the main path: the per-district APSP of every district at n = 102 400
    packed = st.packed
    m, kmax = packed.num_districts, packed.kmax
    adjs = [torch.from_numpy(packed.adj[i]).to(dev) for i in range(m)]
    reset_launches(kernel)
    t0 = time.perf_counter()
    apsp = [ops.floyd_warshall(a) for a in adjs]
    sync(torch, dev)
    all_s = time.perf_counter() - t0
    launches["floyd_warshall"] = kernel.LAUNCHES["floyd_warshall"]
    check(launches["floyd_warshall"] == m * kernel.launches_per_call(kmax),
          f"the APSP path launched {launches['floyd_warshall']} times")
    for i in range(m):
        k = int((packed.vertex_ids[i] >= 0).sum())
        pos = packed.border_pos[i][packed.border_pos[i] >= 0]
        rows = apsp[i][torch.from_numpy(pos).to(dev)].cpu().numpy()
        check(np.array_equal(rows[:, :k], st.intra[i, :len(pos), :k]),
              f"district {i}: APSP border rows differ from stage A")
        want = ref.floyd_warshall_ref(adjs[i])
        check(torch.equal(apsp[i], want), f"district {i}: floyd_warshall "
              "differs from its plain version at n = 6400")
        del want
    host0 = apsp[0].cpu().numpy()
    sub = district_graph(packed.adj[0])
    spots = [0, kmax // 2 + 17, kmax - 1]
    for s in spots:
        check(np.array_equal(host0[s], dijkstra(sub, s)),
              f"district 0: APSP row {s} differs from Dijkstra")
    del apsp

    # times at the main shape: the 164 MB matrix streams from HBM
    b = fw_bound(kmax, peak)
    before = dict(kernel.LAUNCHES)
    kernel_ms = device_ms(torch, kernel.floyd_warshall, [(adjs[0],)], 4, 3)
    phases = fw_phase_ms(torch, kernel, adjs[0])
    kernel.LAUNCHES.update(before)      # timing launches are not the path's
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(2):
        ref.floyd_warshall_ref(adjs[0])
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop) / 2
    bound_ms = max(b["bytes_ms"], b["ops_ms"])
    sass = cuobjdump_sass(build.library_path(kernel.SOURCE), "fw_phase3")
    phase3_loop = {name: term_instructions(loop_body(instrs))
                   for name, instrs in sass.items()}
    row = {"shape": f"fw_n{kmax}", "kernel": "floyd_warshall",
           "dims": [kmax, kmax], **b,
           "cuda_launches_per_call": kernel.launches_per_call(kmax),
           "inputs_from_hbm": True, "kernel_ms": kernel_ms,
           "phase_ms": phases, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if b["bytes_ms"] >= b["ops_ms"]
           else "operations", "share_of_bound": bound_ms / kernel_ms,
           "share_of_2_instruction_bound":
               b["ops_ms_2_instructions"] / kernel_ms,
           "share_of_measured_rate_bound":
               b["ops_ms_measured_rate"] / kernel_ms}
    del adjs
    return {"phase": "floyd_warshall_kernels", "cases": cases,
            "tolerance": f"integral: bitwise; real: rtol {FW_RTOL}; bf16 "
            "(small integers): bitwise", "districts": m, "kmax": kmax,
            "all_districts_s": all_s, "border_rows_equal_stage_a": True,
            "dijkstra_rows": spots, "plain_bitwise_districts": m,
            "launches": launches["floyd_warshall"], "timer": "kernel: "
            "device ms per call from CUDA-graph replays (4 calls x 3 "
            "replays); phase_ms: CUDA events around 20 launches of one "
            "phase of the middle pivot block; plain: CUDA events around "
            "2 eager calls", "bound": "max(matrix read + written at 3.35 "
            "TB/s, n^3 terms at the (min, +) issue ceiling of phase "
            "minplus_peak); ops_ms_2_instructions: 2 instructions per term "
            "on SMs x 128 lanes x max SM clock; ops_ms_measured_rate: at "
            "the fastest rate measured",
            "sass_fw_phase3": {name: mnemonic_counts(instrs)
                               for name, instrs in sass.items()},
            "fw_phase3_product_loop": phase3_loop,
            "library_ms": "null: no single "
            "PyTorch call computes a (min, +) closure", "rows": [row],
            "ok": True}


# -- phase 5c: delta-scoped repairs of B at n = 102 400 ----------------------

def off_bb_paths(st, g, part, w2) -> bool:
    """Whether every edge that ``w2`` moves is an intra-district edge off
    every border-to-border shortest path of its district, and only gets
    slower: then no border-to-border distance moves and the repair can
    reuse the closure (the builder's own stage-A rows decide)."""
    src = g.arc_sources()
    dirty = np.nonzero(g.weights != w2)[0]
    packed = st.packed
    local = np.full(g.num_vertices, -1, dtype=np.int64)
    live = packed.vertex_ids >= 0
    local[packed.vertex_ids[live]] = np.nonzero(live)[1]
    for a in dirty:
        u, v = int(src[a]), int(g.indices[a])
        i = int(part.assignment[u])
        if i != int(part.assignment[v]) or w2[a] < g.weights[a]:
            return False
        bp = packed.border_pos[i][packed.border_pos[i] >= 0]
        d = st.intra[i, :len(bp)]
        lhs = d[:, local[u]][:, None] + g.weights[a] + d[:, local[v]][None, :]
        if (lhs == d[:, bp]).any():
            return False
    return True


def phase_updates_large(torch, dev, ctx: dict, errs: dict) -> dict:
    from repro_torch.ingest import closure_storm
    from repro_torch.kernels.minplus import kernel as mp_kernel
    from repro_torch.update import IncrementalBuilder, scenario_weights
    inc, g, part = ctx["inc"], ctx["graph"], ctx["partition"]
    # scenario, intensity: a side-street incident (its seed picked so the
    # closure is reused), a corridor and a regional slowdown (scoped),
    # then jitter over every district (the full rung)
    seed = next(s for s in range(100) if off_bb_paths(
        inc.state, g, part, scenario_weights(
            "incident", g, part, np.random.default_rng(s), 0.0005)))
    plan = [("incident", 0.0005, seed), ("rush_hour", 0.002, 1),
            ("regional", 0.05, 2), ("jitter", 0.01, 3)]
    epochs = []
    cur = g
    for name, intensity, s in plan:
        w2 = scenario_weights(name, cur, part, np.random.default_rng(s),
                              intensity)
        cur = cur.with_weights(w2)
        epochs.append(("delta", name, intensity, cur))
    # closures: two side-street epochs (scoped), then one on highways
    # (border churn: the full rung)
    for bias, intensity, s in ((1.0, 0.0005, 4), (0.0, 0.001, 5)):
        for g_new, _ in closure_storm(cur, part, num_epochs=2 if bias
                                      else 1, intensity=intensity,
                                      intra_bias=bias, sites=1, seed=s):
            epochs.append(("structural", f"closure_storm_bias{bias}",
                           intensity, g_new))
        cur = g_new
    rows = []
    total = {"relax": 0, "minplus": 0, "minplus_closure": 0,
             "minplus_kmajor": 0}
    seen, held, held_shapes = set(), [], []
    for kind, name, intensity, g_new in epochs:
        reset_launches(mp_kernel)
        sync(torch, dev)
        t0 = time.perf_counter()
        with hold_first_calls(mp_kernel, seen, held):
            labels, rep = getattr(inc, f"apply_{kind}")(g_new, part)
        sync(torch, dev)
        repair_s = time.perf_counter() - t0
        repair_launches = launch_counts(mp_kernel)
        steps = dict(inc.timings)
        shapes_now = check_held(torch, held, errs, name)
        held_shapes += shapes_now
        full = IncrementalBuilder(device=dev)
        t0 = time.perf_counter()
        want = full.build_full(g_new, part)
        full_s = time.perf_counter() - t0
        check(np.array_equal(labels.table, want.table)
              and np.array_equal(labels.border_ids, want.border_ids),
              f"{name}: repaired B differs from a full build")
        check(np.array_equal(inc.state.table_device.cpu().numpy(),
                             labels.table),
              f"{name}: the device table is not the repaired one")
        for k in total:
            total[k] += repair_launches[k]
        rows.append({"kind": kind, "scenario": name, "intensity": intensity,
                     "incremental": rep["incremental"],
                     "border_changed": rep.get("border_changed"),
                     "dirty_districts": len(rep["dirty_districts"]),
                     "affected_districts": len(rep.get(
                         "affected_districts", rep["dirty_districts"])),
                     "closure_reused": rep["closure_reused"],
                     "repruned_rows": rep["repruned_rows"],
                     "changed_rows": int(rep["changed_rows"].sum()),
                     "repair_s": repair_s, "repair_steps": steps,
                     "stage_a_pack_s": steps.get("stage_a_pack_s"),
                     "stage_a_sweeps_s": steps.get("stage_a_sweeps_s"),
                     "stage_a_sweeps": steps.get("stage_a_sweeps"),
                     "launches": repair_launches,
                     "held_against_plain": shapes_now, "full_build_s": full_s,
                     "full_build_steps": dict(full.timings),
                     "equals_full_build": True})
        del full, want
    m = part.num_districts
    check(any(r["incremental"] and r["dirty_districts"] < m for r in rows
              if r["kind"] == "delta"), "no scoped weight repair")
    check(any(r["closure_reused"] or isinstance(r["repruned_rows"], int)
              for r in rows if r["incremental"] and r["changed_rows"]),
          "no repair reached closure reuse or the scoped stage D")
    check(any(r["incremental"] for r in rows if r["kind"] == "structural"),
          "no scoped structural repair")
    check(any(not r["incremental"] for r in rows
              if r["kind"] == "structural"), "no structural full rung")
    check(total["relax"] > 0 and total["minplus_closure"] > 0
          and total["minplus_kmajor"] > 0 and total["minplus"] == 0,
          f"the repairs' launches: {total}")
    check(any(s[0] == "relax" and 0 < s[1][0] < m for s in held_shapes)
          and any(s[0] == "closure" for s in held_shapes)
          and any(s[0] == "minplus_kmajor" for s in held_shapes),
          f"no subset sweep, warm closure or stage-C product held: "
          f"{held_shapes}")
    # the warm closure: one launch and one host copy of its depth per
    # restarted closure, at most one a repair
    check(all(r["launches"]["minplus_closure"] <= 1 for r in rows),
          "a repair launched the closure more than once")
    return {"phase": "updates_n102400", "n": int(g.num_vertices),
            "districts": m, "incident_seed": seed, "epochs": rows,
            "launches": total, "held_against_plain": "the first relax / "
            "minplus call at each operand shape of the repairs, kernel "
            "result == plain version on the same operands, bitwise",
            "timer": "host clock, device synchronised (repair_s includes "
            "device copies of the held calls' operands); full_build_s: a "
            "fresh staged build on the same graph", "ok": True}


# -- phase 5d: the update cycle of the deployed n = 4096 system --------------

def scipy_dijkstra(g, sources: np.ndarray) -> np.ndarray:
    """Exact distances from ``sources`` (float64 sums of the float32
    weights; integral weights make them exact in float32 too)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    n = g.num_vertices
    mat = csr_matrix((g.weights.astype(np.float64), g.indices, g.indptr),
                     shape=(n, n))
    return dijkstra(mat, directed=True, indices=sources)


def phase_updates_small(torch, dev, state: dict, errs: dict) -> dict:
    from repro_torch.core import dijkstra
    from repro_torch.ingest import closure_storm
    from repro_torch.kernels.label_join import kernel as lj_kernel
    from repro_torch.kernels.minplus import kernel as mp_kernel
    from repro_torch.update import scenario_weights
    system = state["system"]
    part = system.partition
    reset_launches(mp_kernel, lj_kernel)
    steps = {}
    before = [srv.augmented for srv in system.servers]
    w2 = scenario_weights("incident", system.graph, part,
                          np.random.default_rng(21), 0.002)
    seen, held = set(), []
    t0 = time.perf_counter()
    with hold_first_calls(mp_kernel, seen, held):
        traffic = system.apply_traffic_update(w2, incremental=True)
    steps["traffic_s"] = time.perf_counter() - t0
    b_steps = {"traffic": dict(system.center.incremental_builder().timings)}
    held_shapes = check_held(torch, held, errs, "traffic update")
    for i in traffic["clean_districts"]:
        check(system.servers[i].augmented is before[i]
              and system.servers[i].augmented_version
              == system.center.version,
              f"clean district {i} entered a rebuild window")
    check(traffic["incremental"] and system.current_engine() is not None,
          "traffic update left the system without an engine")
    g_new, _ = next(iter(closure_storm(system.graph, part, num_epochs=1,
                                       intensity=0.002, intra_bias=1.0,
                                       sites=1, seed=8)))
    before = [srv.augmented for srv in system.servers]
    t0 = time.perf_counter()
    with hold_first_calls(mp_kernel, seen, held):
        topology = system.apply_topology_update(g_new)
    steps["topology_s"] = time.perf_counter() - t0
    b_steps["topology"] = dict(system.center.incremental_builder().timings)
    held_shapes += check_held(torch, held, errs, "topology update")
    for i in topology["clean_districts"]:
        check(system.servers[i].augmented is before[i],
              f"clean district {i} entered a rebuild window")
    check(system.current_engine() is not None,
          "topology update left the system without an engine")
    ss, ts, client = mixed_batch(part, np.random.default_rng(23), BATCH)
    t0 = time.perf_counter()
    got = system.service().submit(ss, ts, client_districts=client)
    steps["submit_s"] = time.perf_counter() - t0
    launches = launch_counts(mp_kernel, lj_kernel)
    check(all(launches[k] > 0 for k in ("relax", "minplus_kmajor",
                                        "label_join")),
          f"the update path missed a kernel: {launches}")
    check(any(s[0] == "relax" for s in held_shapes),
          f"no subset sweep held: {held_shapes}")
    g = system.graph
    uniq, inv = np.unique(ss, return_inverse=True)
    exact = scipy_dijkstra(g, uniq)[inv, ts].astype(np.float32)
    check(np.array_equal(got.distances, exact),
          "answers after the updates differ from Dijkstra")
    spots = spot_check_dijkstra(g, ss, ts, got.distances, dijkstra, 6)
    check(got.exact.all(), "answers after the updates not flagged exact")
    m = part.num_districts

    def summary(rep):
        return {"incremental": rep["incremental"],
                "border_changed": rep.get("border_changed"),
                "dirty_districts": rep["dirty_districts"],
                "stale_shortcut_districts": rep["stale_shortcut_districts"],
                "clean_districts": rep["clean_districts"],
                "bl_repair_s": rep["bl_rebuild_s"],
                "local_refresh_s": sum(rep["local_refresh_s"].values()),
                "shortcut_install_s": sum(
                    rep["shortcut_install_s"].values())}

    return {"phase": "updates_n4096", "n": int(g.num_vertices),
            "districts": m, "traffic": summary(traffic),
            "topology": summary(topology), "steps_s": steps,
            "b_repair_steps": b_steps, "stage_a_split_s": {
                k: [v.get("stage_a_pack_s"), v.get("stage_a_sweeps_s")]
                for k, v in b_steps.items()},
            "batch": BATCH, "equals_dijkstra": "all answers (scipy "
            "Dijkstra) + spot pairs (the port's)", "dijkstra_spot_pairs":
            spots, "launches": launches, "held_against_plain": held_shapes,
            "ok": True}


# -- phase 8b: the §5 latency simulator at n = 4096 ---------------------------

SIM_QUERIES = 5_000
SIM_HORIZON_MS = 60_000.0
WINDOW_LOAD_MULT = 0.4
WINDOW_HORIZON_MS = 1_000.0


def phase_latency_sim(torch, dev, state: dict) -> dict:
    """Measured traffic epochs on the deployed system (repairs and the
    centralized baseline's from-scratch build of B on the card), the §5
    simulator's edge-against-centralized latency over them (forwarded
    and scatter), then a rebuild window under the load harness in the
    ``stale_ok`` and ``certify_or_wait`` modes. Changes the system's
    weights."""
    from repro_torch.core import dijkstra
    from repro_torch.edge import (LatencyModel, Topology, make_trace,
                                  run_update_epochs, simulate_centralized,
                                  simulate_edge)
    from repro_torch.kernels.label_join import kernel as lj_kernel
    from repro_torch.kernels.minplus import kernel as mp_kernel
    from repro_torch.serve import (CERTIFY_OR_WAIT, STALE_OK,
                                   OpenLoopLoadGen, ServingPolicy,
                                   close_rebuild_window, open_rebuild_window)
    from repro_torch.update import scenario_weights

    system = state["system"]
    part = system.partition
    ss, ts = state["ss"], state["ts"]
    reset_launches(mp_kernel, lj_kernel)
    t0 = time.perf_counter()
    schedule, reports = run_update_epochs(system, "incident", 2, 4_000.0,
                                          seed=3, intensity=0.02)
    epochs_s = time.perf_counter() - t0
    counts = launch_counts(mp_kernel, lj_kernel)
    check(all(counts[k] > 0 for k in ("relax", "minplus_closure",
                                      "minplus_kmajor")),
          f"the epochs did not build on the card: {counts}")
    check(system.current_engine() is not None, "the epochs left a window")
    g = system.graph
    got = system.service().submit(ss, ts).distances
    uniq, inv = np.unique(ss, return_inverse=True)
    exact = scipy_dijkstra(g, uniq)[inv, ts].astype(np.float32)
    check(np.array_equal(got, exact), "answers after the epochs differ "
          "from Dijkstra")
    spots = spot_check_dijkstra(g, ss, ts, got, dijkstra, 4)
    epochs = [{k: rep[k] for k in ("epoch_ms", "incremental", "bl_rebuild_s",
                                   "full_rebuild_s", "local_parallel_s",
                                   "global_ready_s")} for rep in reports]

    trace = make_trace(g, SIM_QUERIES, SIM_HORIZON_MS, seed=5)
    topo = Topology(part.num_districts, LatencyModel())
    certified = system.service().certifier()
    sims = {"centralized": simulate_centralized(trace, topo, schedule)}
    for name, pol in (("edge_forwarded", ServingPolicy()),
                      ("edge_scatter", ServingPolicy(
                          engine="scatter_gather"))):
        sims[name] = simulate_edge(trace, topo, schedule, part.assignment,
                                   certified, part.num_districts,
                                   policy=pol)
    sim_rows = {name: {**r.row(name), "mean_ms_unrounded": r.mean_ms,
                       "p95_ms_unrounded": r.p95_ms,
                       "p99_ms_unrounded": r.p99_ms}
                for name, r in sims.items()}
    check(all(np.isfinite(r.latencies_ms).all() and len(r.latencies_ms)
              == SIM_QUERIES for r in sims.values()),
          "a simulated latency is missing or not finite")

    # a rebuild window under the load harness
    w2 = scenario_weights("incident", g, part, np.random.default_rng(7),
                          0.02)
    open_rebuild_window(system, w2)
    check(system.current_engine() is None, "the window did not open")
    sb, tb = ss[:LOAD_BATCH], ts[:LOAD_BATCH]
    probe = system.service(ServingPolicy(rebuild=STALE_OK))
    cap = host_p50_ms(torch, lambda: probe.submit(sb, tb), 5)
    cap_qps = LOAD_BATCH / (cap["p50_ms"] / 1e3)
    clients = max(1, int(round(WINDOW_LOAD_MULT * cap_qps
                               / LOAD_PER_CLIENT_QPS)))
    window = {}
    for mode in (STALE_OK, CERTIFY_OR_WAIT):
        svc = system.service(ServingPolicy(rebuild=mode))
        t0 = time.perf_counter()
        rep = OpenLoopLoadGen(svc, batch_size=LOAD_BATCH,
                              window_ms=LOAD_WINDOW_MS, seed=2).run(
            clients, LOAD_PER_CLIENT_QPS, WINDOW_HORIZON_MS)
        window[mode] = {**rep.row(), "wall_s": time.perf_counter() - t0}
    check(window[STALE_OK]["stale_frac"] + window[STALE_OK]["certified_frac"]
          > 0.0, "the window served nothing stale or certified")
    check(window[CERTIFY_OR_WAIT]["stale_frac"] == 0.0,
          "certify_or_wait served a stale answer")
    t0 = time.perf_counter()
    close_rebuild_window(system)
    close_s = time.perf_counter() - t0
    check(system.current_engine() is not None, "the window did not close")
    g = system.graph
    got = system.service().submit(ss, ts).distances
    exact = scipy_dijkstra(g, uniq)[inv, ts].astype(np.float32)
    check(np.array_equal(got, exact), "answers after the window differ "
          "from Dijkstra")
    return {"phase": "latency_sim_n4096", "n": int(g.num_vertices),
            "districts": int(part.num_districts), "epochs": epochs,
            "epochs_s": epochs_s, "epoch_launches": counts,
            "trace": {"queries": SIM_QUERIES, "horizon_ms": SIM_HORIZON_MS,
                      "seed": 5}, "simulated_ms": sim_rows,
            "window": {"capacity_batch_ms": cap, "capacity_qps": cap_qps,
                       "clients": clients, "rows": window,
                       "close_s": close_s},
            "equals_dijkstra": "after the epochs and after the window",
            "dijkstra_spot_pairs": spots,
            "timer": "epochs: host clock, device synchronised (each "
            "epoch's seconds are charged as simulated ms); simulated_ms: "
            "the simulator's virtual clock; window: the open-loop "
            "harness's virtual ms, each batch charged its host clock",
            "ok": True}


# -- phase 3b: the paper's oracle API at n = 4096 ----------------------------

ORACLE_BUILDERS = ("hierarchical", "reference")


def phase_oracle(torch, dev, state: dict, launches: dict) -> dict:
    """``DistanceOracle.build`` on the card under both builders; its
    ``query_many`` on the serving batch against Dijkstra and, bit for
    bit, against the deployed system's answers on the same graph."""
    from repro_torch.core import DistanceOracle, dijkstra
    from repro_torch.ingest import synthetic_continent
    from repro_torch.kernels.label_join import kernel

    csr, part = synthetic_continent(**SMALL)
    g = csr.to_graph()
    ss, ts, want = state["ss"], state["ts"], state["first_answers"]
    rows = {}
    for builder in ORACLE_BUILDERS:
        t0 = time.perf_counter()
        oracle = DistanceOracle.build(g, part, builder=builder, device=dev)
        build_s = time.perf_counter() - t0
        reset_launches(kernel)
        t0 = time.perf_counter()
        got = oracle.query_many(ss, ts)
        query_s = time.perf_counter() - t0
        counts = dict(kernel.LAUNCHES)
        check(counts["label_join"] > 0, f"query_many launched no join: "
              f"{counts}")
        check(np.array_equal(got, want), f"oracle ({builder}) differs from "
              "the deployed system's answers")
        spots = spot_check_dijkstra(g, ss, ts, got, dijkstra, 6)
        check(oracle.border_table_device().is_cuda, "B is not on the card")
        rows[builder] = {**oracle.stats.as_row(),
                         "bl_seconds": oracle.stats.bl_seconds,
                         "districts_seconds": oracle.stats.districts_seconds,
                         "build_s": build_s, "query_many_s": query_s,
                         "join_launches": counts,
                         "dijkstra_spot_pairs": spots}
        del oracle
    launches["oracle_label_join"] = rows[ORACLE_BUILDERS[0]][
        "join_launches"]["label_join"]
    return {"phase": "oracle_n4096", "n": int(g.num_vertices),
            "districts": int(part.num_districts), "batch": len(ss),
            "builders": rows, "equals_deployed_system": "bit for bit, "
            "every builder", "timer": "host clock after a device "
            "synchronise (bl_s: Table 2's BL column, districts_s: its "
            "Districts column)", "ok": True}


# -- phase 3c: the sharded serving layouts at n = 4096 -----------------------

SHARD_COUNTS = (4, 8)


@contextlib.contextmanager
def hold_sharded_calls(mod, held: list):
    """While active, every call the path makes to
    ``mod.multi_shard_gather_join`` (the sharded kernel's wrapper) keeps
    copies of its tensors and its result in ``held`` (the call itself
    launches once, as the path does)."""
    real = mod.multi_shard_gather_join

    def call(blocks, borders, owner, rs, rt, **kw):
        out = real(blocks, borders, owner, rs, rt, **kw)
        held.append(([_clone(x) for x in blocks],
                     [_clone(x) for x in borders],
                     [_clone(x) for x in (owner, rs, rt)], kw, out.clone()))
        return out

    mod.multi_shard_gather_join = call
    try:
        yield
    finally:
        mod.multi_shard_gather_join = real


def check_sharded_held(torch, held: list, errs: dict, what: str) -> int:
    """Each kept sharded-kernel result against the plain version on the
    same arguments, bit for bit; returns the count and empties ``held``."""
    from repro_torch.kernels.label_join import ref
    for blocks, borders, ids, kw, out in held:
        want = ref.multi_shard_gather_join_ref(blocks, borders, *ids, **kw)
        check(torch.equal(out, want), f"{what}: the sharded kernel "
              f"({len(blocks)} shards) differs from its plain version")
        errs["label_join_sharded"] = max(errs["label_join_sharded"],
                                         max_abs_err(out, want))
    count = len(held)
    held.clear()
    return count


def host_p50_ms(torch, fn, reps: int = 30) -> dict:
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return {"p50_ms": float(np.percentile(samples, 50)),
            "min_ms": float(min(samples))}


def tensor_bytes(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def phase_sharded(torch, dev, state: dict, launches: dict,
                  errs: dict) -> tuple[dict, dict]:
    """``ServingPolicy(engine="sharded")`` on the deployed n = 4096
    system for E in SHARD_COUNTS logical shards on the card, B replicated
    and row-sharded, float32 and uint16: one sharded-kernel launch a
    batch, bit for bit with the replicated engine and with its plain
    version; then a rebalance plan fed by the service's load and
    ``migrate``."""
    from repro_torch.core import dijkstra
    from repro_torch.edge import ShardedBatchedEngine, default_edge_mesh
    from repro_torch.kernels.label_join import kernel, ops
    from repro_torch.serve import ServingPolicy
    from repro_torch.topo import RebalancePlanner

    system = state["system"]
    part = system.partition
    g = system.graph
    ss, ts, client = state["ss"], state["ts"], state["client"]
    n, q = system.center.border_labels.table.shape
    want, rep_latency = {}, {}
    for dtype in ("float32", "uint16"):
        svc = system.service(ServingPolicy(engine="replicated",
                                           label_dtype=dtype))
        want[dtype] = svc.submit(ss, ts, client_districts=client).distances
        rep_latency[dtype] = host_p50_ms(torch, lambda: svc.submit(
            ss, ts, client_districts=client))
    check(np.array_equal(want["float32"], want["uint16"]),
          "replicated f32 vs uint16")

    rows, held, shapes = [], [], {}
    reset_launches(kernel)
    held_count = path_launches = 0
    for e in SHARD_COUNTS:
        system.mesh = default_edge_mesh(e, device=dev)
        for border in (False, True):
            for dtype in ("float32", "uint16"):
                svc = system.service(ServingPolicy(
                    engine="sharded", shard_border=border, label_dtype=dtype))
                before = kernel.LAUNCHES["label_join_sharded"]
                with hold_sharded_calls(ops, held):
                    got = svc.submit(ss, ts, client_districts=client)
                per_batch = kernel.LAUNCHES["label_join_sharded"] - before
                path_launches += per_batch
                held_count += check_sharded_held(
                    torch, held, errs, f"sharded E={e} border={border} "
                    f"{dtype}")
                eng = svc.plan(ss, ts).plane
                check(isinstance(eng, ShardedBatchedEngine)
                      and eng.num_devices == e
                      and eng.shard_border == border, "sharded engine not "
                      f"selected: {type(eng).__name__}")
                check(np.array_equal(got.distances, want[dtype]),
                      f"sharded E={e} border={border} {dtype} differs from "
                      "the replicated engine")
                check(got.exact.all(), "sharded answers not flagged exact")
                check(per_batch == 1, f"{per_batch} launches a batch over "
                      f"{e} shards, not 1")
                item = 4 if dtype == "float32" else 2
                d = eng.data
                shard_bytes = {
                    "district": eng.district_table_bytes_per_device(),
                    "border": eng.border_table_bytes_per_device()}
                check(shard_bytes["district"] == d.districts_per_device
                      * d.kmax * d.width * item
                      and shard_bytes["border"] == (-(-n // e) if border
                                                    else n) * q * item,
                      "per-shard bytes differ from the memory model")
                card = {"district": tensor_bytes(eng.blocks),
                        "border": tensor_bytes(eng.btables)}
                check(card["district"] == e * shard_bytes["district"]
                      and card["border"] == e * shard_bytes["border"],
                      "the card does not hold E times one shard")
                rows.append({
                    "shards": e, "shard_border": border, "dtype": dtype,
                    "per_shard_bytes": shard_bytes,
                    "whole_card_bytes": card,
                    "launches_a_batch": per_batch,
                    "submit_host_ms": host_p50_ms(torch, lambda: svc.submit(
                        ss, ts, client_districts=client))})
                if e == SHARD_COUNTS[-1]:
                    ids = [torch.from_numpy(x).to(dev)
                           for x in eng.row_ids(ss, ts)]
                    tag = "row" if border else "rep"
                    shapes[f"sharded_e{e}_{tag}_{dtype}"] = multi_shape(
                        "sharded", eng.blocks, eng.btables, ids,
                        eng.btables[0].shape[0] if border else None,
                        None if eng.quant is None else eng.quant.key(),
                        False)
        spots = spot_check_dijkstra(g, ss, ts, got.distances, dijkstra, 4)
    # the path's launches: the checked submits (not the latency loops)
    launches["label_join_sharded"] = path_launches

    # rebalance: hot traffic on the first shard's districts, a plan from
    # the service's load, then migrate; the next batch routes anew
    e = SHARD_COUNTS[-1]
    system.mesh = default_edge_mesh(e, device=dev)
    svc = system.service(ServingPolicy(engine="sharded"))
    planner = RebalancePlanner.for_system(system, num_hosts=e)
    hot = np.isin(part.assignment[ss], planner.placement.districts_of(0))
    svc.submit(ss, ts, client_districts=client)
    for _ in range(3):
        svc.submit(ss[hot], ts[hot])
    planner.observe_load(svc.district_load)
    plan = planner.plan()
    check(plan is not None, "the planner found no move for a hot shard")
    old = svc.plan(ss, ts).plane
    old_key = system._engines_version
    report = system.migrate(plan)
    got = svc.submit(ss, ts, client_districts=client)
    new = svc.plan(ss, ts).plane
    check(new is not old and system._engines_version != old_key,
          "migrate did not swap the engine")
    check(np.array_equal(new.data.device_of,
                         plan.placement.host_of.astype(np.int64)),
          "the engine does not route on the new placement")
    check(np.array_equal(got.distances, want["float32"]),
          "answers changed through the migration")
    spots += spot_check_dijkstra(g, ss, ts, got.distances, dijkstra, 2)
    rebalance = {**plan.summary(), "report": report,
                 "district_load": svc.district_load.tolist(),
                 "engine_key_before": repr(old_key[2]),
                 "engine_key_after": repr(system._engines_version[2])}
    system.mesh = None
    system.placement = None
    return ({"phase": "sharded_n4096", "n": int(n), "q": int(q),
             "batch": len(ss), "shard_counts": list(SHARD_COUNTS),
             "replicated_submit_host_ms": rep_latency, "rows": rows,
             "held_against_plain": held_count,
             "equals_replicated_engine": "bit for bit, every row",
             "dijkstra_spot_pairs": spots,
             "rebalance": rebalance,
             "launches": {"label_join_sharded":
                          launches["label_join_sharded"]},
             "bytes": "per_shard_bytes: one shard's district block and "
             "share of B (the reference's per-device formulas); "
             "whole_card_bytes: all E shards on the one card",
             "timer": "submit: host clock, device synchronised, 30 "
             "submits", "ok": True},
            shapes)


# -- phase 3d: the scatter-gather read path at n = 4096 ----------------------

# the sharded engine the plane is held against (E logical shards)
SCATTER_SHARDS = 8
# the load harness at the reference benchmark's parameters
# (benchmarks/bench_load.py): batch, window, rate a client, horizon, the
# multiples of the measured capacity, the bounded queue, the
# million-client point at 0.7 x capacity
LOAD_BATCH = 1024
LOAD_WINDOW_MS = 2.0
LOAD_PER_CLIENT_QPS = 0.5
LOAD_HORIZON_MS = 2_000.0
LOAD_MULTS = (0.5, 1.5)
LOAD_MAX_QUEUE = 8 * LOAD_BATCH
MEGA_CLIENTS = 1_000_000


def scrub_border_rows(system) -> None:
    """Back to the post-push state: each server keeps only its own
    border rows, so that a faulted plane runs its peer exchanges (and
    their faults) again."""
    for srv in system.servers:
        own = srv._border_rows.get(srv.district_id)
        srv._border_rows = {} if own is None else {srv.district_id: own}


def scatter_host_split(torch, plane, ss, ts, reps: int = 30) -> dict:
    """Host clock of the plane's three steps on a warm batch, p50 of
    ``reps``: the coordinator's routing (``prepare_queries`` and the
    exchange check over the cross lanes' owners), the launch (the row
    ids up once in lane order, one wrapper call; no wait), and the
    consolidation (the answers copied back, which waits for the
    device)."""
    samples = {"route_ms": [], "launch_ms": [], "consolidate_ms": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coords = plane._route(ss, ts)
        t1 = time.perf_counter()
        answers = plane._launch(*coords)
        t2 = time.perf_counter()
        plane._consolidate(answers)
        t3 = time.perf_counter()
        for key, dt in zip(samples, (t1 - t0, t2 - t1, t3 - t2)):
            samples[key].append(dt * 1e3)
    return {k: float(np.percentile(v, 50)) for k, v in samples.items()}


def load_rows(torch, system, engine: str, ss, ts) -> dict:
    """The open-loop harness at the reference benchmark's parameters on
    one placement: the capacity of one warm full batch of the serving
    batch's first lanes, then 0.5x and 1.5x that (unbounded queue),
    1.5x with the bounded queue, and the million-client point."""
    from repro_torch.serve import OpenLoopLoadGen, ServingPolicy
    svc = system.service(ServingPolicy(engine=engine))
    sb, tb = ss[:LOAD_BATCH], ts[:LOAD_BATCH]
    cap = host_p50_ms(torch, lambda: svc.submit(sb, tb), 20)
    cap_qps = LOAD_BATCH / (cap["p50_ms"] / 1e3)

    def run(label, clients, qps, horizon, **kw):
        gen = OpenLoopLoadGen(svc, batch_size=LOAD_BATCH,
                              window_ms=LOAD_WINDOW_MS, seed=0,
                              max_queue=kw.pop("max_queue", None))
        gen.warmup()
        t0 = time.perf_counter()
        rep = gen.run(clients, qps, horizon, **kw)
        wall = time.perf_counter() - t0
        check(rep.admitted > 0 and np.isfinite(rep.p999_ms),
              f"load {engine} {label}: no answers")
        return {**rep.row(), "wall_s": wall}

    rows = {}
    for mult in LOAD_MULTS:
        clients = max(1, int(round(mult * cap_qps / LOAD_PER_CLIENT_QPS)))
        rows[f"open_x{mult:g}"] = run(f"x{mult:g}", clients,
                                      LOAD_PER_CLIENT_QPS, LOAD_HORIZON_MS)
    mult = LOAD_MULTS[-1]
    clients = max(1, int(round(mult * cap_qps / LOAD_PER_CLIENT_QPS)))
    rows[f"bounded_x{mult:g}"] = run("bounded", clients, LOAD_PER_CLIENT_QPS,
                                     LOAD_HORIZON_MS,
                                     max_queue=LOAD_MAX_QUEUE)
    check(rows[f"bounded_x{mult:g}"]["shed_frac"] > 0.0,
          f"load {engine}: the bounded queue shed nothing at {mult}x")
    per_client = 0.7 * cap_qps / MEGA_CLIENTS
    horizon = 1.05 * MEGA_CLIENTS / (0.7 * cap_qps) * 1e3
    rows["mega_1m_clients"] = run("mega", MEGA_CLIENTS, per_client, horizon,
                                  max_arrivals=4_000_000)
    check(rows["mega_1m_clients"]["offered"] >= MEGA_CLIENTS,
          "the million-client point offered fewer than 10^6 arrivals")
    return {"capacity_qps": cap_qps, "capacity_batch_ms": cap, "rows": rows}


def phase_scatter(torch, dev, state: dict, launches: dict,
                  errs: dict) -> tuple[dict, dict]:
    """``ServingPolicy(engine="scatter_gather")`` on the deployed n = 4096
    system, float32 and uint16: bit for bit with the replicated and
    sharded engines and the scalar loop, one sharded-kernel launch a
    batch (uint16 dequantized in the kernel) held against its plain
    version; bytes, exchange stats and the host split
    of a submit; three fault plans replayed twice; the distance batcher;
    the open-loop harness on the replicated and scatter placements."""
    from repro_torch.core import dijkstra
    from repro_torch.edge import (FaultPlan, ScatterGatherPlane,
                                  default_edge_mesh, district_outage_storm)
    from repro_torch.kernels.label_join import kernel, ops
    from repro_torch.serve import ServingPolicy

    system = state["system"]
    part = system.partition
    g = system.graph
    ss, ts, client = state["ss"], state["ts"], state["client"]
    m = part.num_districts
    n, q = system.center.border_labels.table.shape
    want, rep_latency = {}, {}
    for dtype in ("float32", "uint16"):
        svc = system.service(ServingPolicy(engine="replicated",
                                           label_dtype=dtype))
        want[dtype] = svc.submit(ss, ts, client_districts=client).distances
        rep_latency[dtype] = host_p50_ms(torch, lambda: svc.submit(
            ss, ts, client_districts=client))
    system.mesh = default_edge_mesh(SCATTER_SHARDS, device=dev)
    sharded = system.service(ServingPolicy(engine="sharded")).submit(
        ss, ts, client_districts=client).distances
    system.mesh = None
    loop = system.query_loop(ss, ts)
    check(np.array_equal(want["float32"], loop)
          and np.array_equal(want["uint16"], loop)
          and np.array_equal(sharded, loop),
          "replicated / sharded engines differ from the scalar loop")

    rows, held, shapes = {}, [], {}
    reset_launches(kernel)
    # the path's launches: the checked submits (not the timing loops)
    path = {k: 0 for k in kernel.LAUNCHES}
    for dtype in ("float32", "uint16"):
        svc = system.service(ServingPolicy(engine="scatter_gather",
                                           label_dtype=dtype))
        plane = svc.plan(ss, ts).plane
        check(isinstance(plane, ScatterGatherPlane)
              and (plane.quant is None) == (dtype == "float32"),
              f"scatter plane ({dtype}) not selected: "
              f"{type(plane).__name__}")
        check(plane.data.btable is None and plane.data.district_table is None,
              "the coordinator holds a copy of B or of the district tables")
        before = dict(kernel.LAUNCHES)
        with hold_sharded_calls(kernel, held):
            got = svc.submit(ss, ts, client_districts=client)
        per_batch = {k: kernel.LAUNCHES[k] - before[k] for k in before}
        for k, v in per_batch.items():
            path[k] += v
        held_count = check_sharded_held(torch, held, errs,
                                        f"scatter ({dtype})")
        check(per_batch["label_join_sharded"] == 1 and held_count == 1
              and sum(per_batch.values()) == 1,
              f"scatter {dtype}: {per_batch} launches a batch over {m} "
              "servers, not 1")
        check(np.array_equal(got.distances, loop),
              f"scatter {dtype} differs from the engines and the loop")
        check(got.exact.all() and all(r is None for r in
                                      got.degraded_reason),
              f"scatter {dtype}: clean answers flagged")
        spots = spot_check_dijkstra(g, ss, ts, got.distances, dijkstra, 4)
        views = [v for v in plane._bviews if v is not None]
        card = tensor_bytes(plane._blocks) + tensor_bytes(views)
        check(card == plane.size_bytes() and all(
            x.is_cuda for x in plane._blocks + views),
            "the plane's tensors are not the card's bytes")
        exchange = dict(plane.exchange_stats)
        submit = host_p50_ms(torch, lambda: svc.submit(
            ss, ts, client_districts=client))
        split = scatter_host_split(torch, plane, ss, ts)
        # the service's own step before the plane: the freshness check
        # over the servers and the router's cache lookup
        split["plan_ms"] = host_p50_ms(torch, lambda: svc.plan(
            ss, ts, client))["p50_ms"]
        rows[dtype] = {"launches_a_batch": per_batch,
                       "held_against_plain": held_count,
                       "exchange_stats": exchange,
                       "server_bytes": plane.server_bytes(),
                       "card_bytes": card, "submit_host_ms": submit,
                       "host_split_ms": split,
                       "dijkstra_spot_pairs": spots}
        ids = [torch.from_numpy(x.astype(np.int64)).to(dev)
               for x in plane._route(ss, ts)]
        views = [plane._no_rows if v is None else v for v in plane._bviews]
        quant = None if plane.quant is None else plane.quant.key()
        shapes[f"scatter_m{m}_{dtype}"] = multi_shape(
            "scatter", plane._blocks, views, ids, None, quant,
            quant is not None)

    # faults: link drops (retries, forwarded via the center), an outage
    # storm (surviving-min reroutes, upper bounds), the center dark
    plans = {
        "link_drop": FaultPlan(seed=7, peer_drop_rate=0.3,
                               peer_timeout_rate=0.2, peer_slow_rate=0.1,
                               max_retries=2),
        "outage_storm": district_outage_storm(m, dark_frac=0.25, seed=2),
        "center_down": FaultPlan(seed=3, peer_drop_rate=0.5,
                                 server_outage_rate=0.1, center_down=True),
    }
    faults = {}
    for label, plan in plans.items():
        runs = []
        for _ in range(2):
            scrub_border_rows(system)
            plane = ScatterGatherPlane.from_system(system, faults=plan)
            before = dict(kernel.LAUNCHES)
            t0 = time.perf_counter()
            out = plane.execute(ss, ts)
            sec = time.perf_counter() - t0
            counts = {k: kernel.LAUNCHES[k] - before[k] for k in before}
            runs.append((out.tobytes(), plane.exactness_codes.tobytes(),
                         tuple(plane.degraded), dict(plane.exchange_stats),
                         tuple(plane.faults.events)))
        check(runs[0] == runs[1], f"faults {label}: two replays differ")
        codes, reasons = plane.exactness_codes, plane.degraded
        wrong = out != loop
        check((codes[wrong] == 2).all()
              and all(reasons[i] is not None for i in np.nonzero(wrong)[0]),
              f"faults {label}: a wrong answer is not flagged")
        kinds: dict = {}
        for r in reasons:
            if r is not None:
                kinds[r] = kinds.get(r, 0) + 1
        check(kinds, f"faults {label}: nothing degraded")
        faults[label] = {"plan": {k: v for k, v in plan.__dict__.items()
                                  if v not in (0, 0.0, (), False)},
                         "reasons": kinds,
                         "stale_flagged": int((codes == 2).sum()),
                         "exact_lanes": int((out == loop).sum()),
                         "exchange_stats": runs[0][3],
                         "launches": counts, "execute_s": sec,
                         "replays_byte_for_byte": True}
    scrub_border_rows(system)

    # the distance batcher at batch 1024: a padded tail never leaks
    svc = system.service(ServingPolicy(engine="scatter_gather"))
    batcher = svc.batcher(batch_size=LOAD_BATCH)
    k = 3 * LOAD_BATCH - 100
    batcher.submit_pairs(zip(ss[:k].tolist(), ts[:k].tolist()))
    t0 = time.perf_counter()
    done = batcher.run()
    batcher_s = time.perf_counter() - t0
    check(len(done) == k and all(r.rid >= 0 for r in done)
          and np.array_equal(np.array([r.distance for r in done],
                                      np.float32), loop[:k]),
          "the distance batcher's answers or padding")
    stats = svc.stats
    check(stats["rule1"] + stats["rule2"] + stats["rule3"] == k,
          f"padding reached the counters: {stats}")
    lat = batcher.latency_stats()

    load = {engine: load_rows(torch, system, engine, ss, ts)
            for engine in ("replicated", "scatter_gather")}

    launches["label_join_sharded"] += path["label_join_sharded"]
    launches["label_join"] += path["label_join"]
    return ({"phase": "scatter_n4096", "n": int(n), "q": int(q),
             "servers": m, "batch": len(ss),
             "replicated_submit_host_ms": rep_latency, "rows": rows,
             "equals": "replicated engine, sharded engine (E = "
             f"{SCATTER_SHARDS}) and scalar loop, bit for bit",
             "path_launches": path, "faults": faults,
             "batcher": {"batch": LOAD_BATCH, "requests": k,
                         "run_s": batcher_s, "latency_ms": lat},
             "load": load,
             "timer": "submit: host clock, device synchronised, 30 submits; "
             "host split: p50 of 30 warm batches; load: virtual ms of the "
             "open-loop harness, each batch charged its host clock; "
             "wall_s: host clock of a run", "ok": True}, shapes)


# -- phase 4c: the row-sharded join at the center's size ---------------------

CENTER_SHARDS = 8


def phase_sharded_center(torch, dev, center_shapes: dict, part,
                         errs: dict) -> tuple[dict, dict]:
    """65 536 rule-3 queries over n = 102 400's B (q = 96) row-sharded
    over CENTER_SHARDS logical shards, each with a one-row +inf district
    block (no query reads it): one sharded-kernel launch reading B's
    rows in place, bit for bit with the replicated rule-3 join and with
    its plain version."""
    from repro_torch.edge import default_edge_mesh
    from repro_torch.kernels.label_join import ops

    mesh = default_edge_mesh(CENTER_SHARDS, device=dev)
    out, shapes, held = {}, {}, []
    for dtype, key in (("float32", "rule3_f32_q65536"),
                       ("uint16", "rule3_u16_q65536")):
        table, ss, ts, quant = center_shapes[key]
        n, q = table.shape
        rpd = -(-n // CENTER_SHARDS)
        bshards = [table[d * rpd:(d + 1) * rpd] for d in range(CENTER_SHARDS)]
        fill = float("inf") if quant is None else -1      # 0xFFFF as int16
        blocks = [torch.full((1, q), fill, dtype=table.dtype, device=dev)
                  for _ in range(CENTER_SHARDS)]
        dpd = -(-part.num_districts // CENTER_SHARDS)
        owner = torch.from_numpy(part.assignment[ss].astype(np.int64)
                                 // dpd).to(dev)
        rs = torch.from_numpy(ss + 1).to(dev)
        rt = torch.from_numpy(ts + 1).to(dev)
        want = ops.join_quantized_gathered(
            table, ss, ts, sentinel=quant[0], scale=quant[1]) \
            if quant is not None else ops.join_gathered(table, ss, ts)
        with hold_sharded_calls(ops, held):
            got = ops.join_sharded_border_gathered(blocks, bshards, owner, rs,
                                                   rt, mesh=mesh, quant=quant)
        count = check_sharded_held(torch, held, errs,
                                   f"center row-sharded {dtype}")
        check(count == 1, f"{count} launches over {CENTER_SHARDS} shards, "
              "not 1")
        check(np.array_equal(got.cpu().numpy(), want), "row-sharded rule-3 "
              f"{dtype} differs from the replicated join")
        shapes[f"center_e{CENTER_SHARDS}_row_{dtype}"] = multi_shape(
            "sharded", blocks, bshards, [owner, rs, rt], rpd, quant, False)
        out[dtype] = {
            "batch_ms": event_ms(torch, lambda: ops.join_sharded_border_gathered(
                blocks, bshards, owner, rs, rt, mesh=mesh, quant=quant), 20),
            "replicated_join_ms": event_ms(
                torch, lambda: ops.join_gathered(table, ss, ts) if quant is None
                else ops.join_quantized_gathered(table, ss, ts,
                                                 sentinel=quant[0],
                                                 scale=quant[1]), 20),
            "b_shard_rows": rpd, "q": int(q)}
    return ({"phase": "sharded_center_n102400", "shards": CENTER_SHARDS,
             "batch": int(len(center_shapes["rule3_f32_q65536"][1])),
             "rows": out, "equals_replicated_join": True,
             "note": "n = 102 400 is the center alone: its edge servers' "
             "host PLL limits the deployed stack to n = 4096, so each "
             "shard's district block is one +inf row no query reads",
             "timer": "batch_ms / replicated_join_ms: CUDA events around "
             "20 back-to-back calls (the wrapper and its one launch; host "
             "ids to device and back included)",
             "ok": True}, shapes)


def multi_shape(kind, blocks, borders, ids, rows_pd, quant,
                dequant_first) -> dict:
    """A whole-batch call of the sharded kernel as a path makes it
    (``kind``: "sharded" engine or "scatter" plane), kept for
    ``phase_sharded_times``."""
    return {"kind": kind, "blocks": list(blocks), "borders": list(borders),
            "ids": [x.contiguous() for x in ids],
            "kw": {"rows_per_border_shard": rows_pd, "quant": quant,
                   "dequant_first": dequant_first}}


def multi_bound(shape) -> tuple[int, int]:
    """Bytes and operations the whole batch needs on these inputs: owner
    and both row ids of every lane once, the output, the distinct rows
    the owned lanes read (block rows at W; border rows at q, per source:
    a shard's copy of B or view, or B's row when row-sharded); an add
    and a min per element folded."""
    blocks, borders = shape["blocks"], shape["borders"]
    owner, rs, rt = (x.cpu().numpy() for x in shape["ids"])
    rows_pd = shape["kw"]["rows_per_border_shard"]
    e, w, bw = len(blocks), blocks[0].shape[1], borders[0].shape[1]
    item = blocks[0].element_size()
    mine = (owner >= 0) & (owner < e)
    o, a, c = owner[mine], rs[mine], rt[mine]
    base = np.array([b.shape[0] for b in blocks])[o]
    both = np.concatenate([np.stack([o, a, a < base], 1),
                           np.stack([o, c, c < base], 1)])
    both[:, 1] -= np.where(both[:, 2] == 1, 0, np.concatenate([base, base]))
    blk = both[both[:, 2] == 1][:, :2]
    brd = both[both[:, 2] == 0][:, :2]
    if rows_pd is not None:
        brd = brd[:, 1:]                # one B row, whichever lane reads it
    rows = (len(np.unique(blk, axis=0)) * w
            + len(np.unique(brd, axis=0)) * bw)
    nbytes = 28 * len(owner) + rows * item
    ops_ = 2 * int(np.where((a < base) & (c < base), w, bw).sum())
    return nbytes, ops_


def gathered_rows(torch, ref, blocks, borders, owner, rs, rt, rows_pd,
                  quant, dequant_first):
    """Every lane's two rows as the plain version gathers them from its
    owner's tables (float32; codes dequantized first where the path
    dequantizes), for the library call."""
    if rows_pd is not None:
        whole = torch.cat([ref.storage16(b) for b in borders])
        borders = [whole] * len(blocks)
    s_rows = t_rows = None
    for d, (block, border) in enumerate(zip(blocks, borders)):
        mine = owner == d
        s_d, t_d = ref.sharded_gather_rows(
            block, border, torch.where(mine, rs, 0), torch.where(mine, rt, 0),
            quant=quant)
        if dequant_first:
            s_d, t_d = (ref.dequantize_ref(x, quant) for x in (s_d, t_d))
        if s_rows is None:
            s_rows, t_rows = s_d, t_d
        else:
            s_rows = torch.where(mine[:, None], s_d, s_rows)
            t_rows = torch.where(mine[:, None], t_d, t_rows)
    return s_rows.contiguous(), t_rows.contiguous()


def per_shard_path(torch, kernel, ops, ref, shape, dev):
    """The design the whole-batch launch replaces, on the same inputs:
    for the sharded engine E one-entry launches over the batch and the
    ``torch.minimum`` fold (after the ragged assembly and its fold for a
    row-sharded B); for the scatter plane one launch a server over its
    own lanes (the uint16 rows gathered, dequantized and joined by the
    dense kernel) and the concatenation. Returns (fn, extra, order):
    ``fn`` takes ``extra(inputs)``, the per-copy setup, and answers the
    lanes in ``order`` (None: lane order)."""
    from repro_torch.edge import default_edge_mesh
    e = len(shape["blocks"])
    kw = shape["kw"]
    quant, rows_pd = kw["quant"], kw["rows_per_border_shard"]
    if shape["kind"] == "sharded":
        mesh = default_edge_mesh(e, device=dev)

        def fn(*x):
            blocks, borders, (owner, rs, rt) = x[:e], x[e:2 * e], x[2 * e:]
            if rows_pd is not None:
                cross_base = blocks[0].shape[0]
                border = ops.assemble_border_rows(list(borders), rs, rt,
                                                  cross_base, mesh=mesh,
                                                  quant=quant)
                rs, rt = ops.assembled_row_ids(rs, rt, cross_base)
                borders = [border] * e
            return mesh.pmin([kernel.sharded_gather_join(
                blocks[d], borders[d], owner, d, rs, rt, quant=quant)
                for d in range(e)])
        return fn, lambda x: x, None
    owner = shape["ids"][0].cpu().numpy()
    order = torch.from_numpy(np.argsort(owner, kind="stable")).to(dev)
    counts = np.bincount(owner, minlength=e)
    cuts = np.concatenate([[0], np.cumsum(counts)])

    def extra(x):
        return (*x[:2 * e], *(i[order].contiguous() for i in x[2 * e:]))

    def fn(*x):
        blocks, borders, (owner, rs, rt) = x[:e], x[e:2 * e], x[2 * e:]
        parts = []
        for d in np.nonzero(counts)[0]:
            lo, hi = int(cuts[d]), int(cuts[d + 1])
            o, a, c = owner[lo:hi], rs[lo:hi], rt[lo:hi]
            if quant is None:
                parts.append(kernel.sharded_gather_join(
                    blocks[d], borders[d], o, int(d), a, c))
            else:
                s_rows, t_rows = ref.sharded_gather_rows(
                    blocks[d], borders[d], a, c, quant=quant)
                parts.append(ops.join_partial_gathered(
                    ref.dequantize_ref(s_rows, quant),
                    ref.dequantize_ref(t_rows, quant)))
        return torch.cat(parts)
    return fn, extra, order


def time_sharded_shape(torch, kernel, ops, ref, name, shape, dev) -> dict:
    """The whole batch's launch at a path's shape: device ms from
    CUDA-graph replays cycling through copies of its inputs, against its
    bound, its plain version, the ``amin`` of the gathered sums and the
    per-shard path it replaces."""
    blocks, borders, ids = shape["blocks"], shape["borders"], shape["ids"]
    kw = shape["kw"]
    e = len(blocks)
    nbytes, ops_ = multi_bound(shape)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops_ / PEAK_F32_OPS_PER_S * 1e3
    args = (*blocks, *borders, *ids)
    cold, from_hbm = cold_inputs(args, nbytes)

    def split(x):
        return list(x[:e]), list(x[e:2 * e]), x[2 * e:]

    def launch(*x):
        b, bt, (o, a, c) = split(x)
        return kernel.multi_shard_gather_join(b, bt, o, a, c, **kw)

    def plain(*x):
        b, bt, (o, a, c) = split(x)
        return ref.multi_shard_gather_join_ref(b, bt, o, a, c, **kw)

    path, extra, order = per_shard_path(torch, kernel, ops, ref, shape, dev)
    before = dict(kernel.LAUNCHES)
    want = plain(*args)
    check(torch.equal(launch(*args), want), f"{name}: the kernel differs "
          "from its plain version")
    check(torch.equal(path(*extra(args)),
                      want if order is None else want[order]),
          f"{name}: the per-shard path differs from the kernel")
    kernel_ms = device_ms(torch, launch, cold)
    warm_ms = device_ms(torch, launch, [args])
    call_ms = event_ms(torch, lambda: launch(*args), 200)
    path_inputs = [extra(x) for x in cold]
    path_ms = device_ms(torch, path, path_inputs)
    path_call_ms = event_ms(torch, lambda: path(*path_inputs[0]), 50)
    del path_inputs
    kernel.LAUNCHES.update(before)      # timing launches are not the path's
    vec, lanes = kernel.multi_shard_join_layout(blocks, borders,
                                                ids[0].shape[0])
    plain_ms = device_ms(torch, plain, cold, calls=4, replays=5)
    library_ms = None
    if kw["quant"] is None or kw["dequant_first"]:
        rows = [gathered_rows(torch, ref, *split(x)[:2], *split(x)[2],
                              kw["rows_per_border_shard"], kw["quant"],
                              kw["dequant_first"]) for x in cold]
        library_ms = device_ms(torch, lambda s_, t_: torch.amin(s_ + t_, 1),
                               rows)
        del rows
    copies = len(cold)
    del cold
    bound_ms = max(bytes_ms, ops_ms)
    owner = ids[0]
    return {"shape": name, "kernel": "label_join_sharded",
            "path": shape["kind"], "shards": e, "q": int(owner.shape[0]),
            "w": int(blocks[0].shape[1]), "border_w": int(borders[0].shape[1]),
            "itemsize": blocks[0].element_size(),
            "row_sharded": kw["rows_per_border_shard"] is not None,
            "dequant_first": kw["dequant_first"],
            "owned_lanes": int(((owner >= 0) & (owner < e)).sum()),
            "bytes": nbytes, "ops": ops_, "copies": copies,
            "rows_from_hbm": from_hbm, "vec_bytes": vec, "lanes": lanes,
            "kernel_ms": kernel_ms, "l2_warm_ms": warm_ms,
            "wrapper_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": bound_ms / kernel_ms if from_hbm else None,
            "per_shard_path_ms": path_ms,
            "per_shard_path_call_ms": path_call_ms}


def phase_sharded_times(torch, dev, shapes: dict) -> dict:
    from repro_torch.kernels.label_join import kernel, ops, ref
    rows = [time_sharded_shape(torch, kernel, ops, ref, name, shape, dev)
            for name, shape in shapes.items()]
    return {"phase": "sharded_times", "timer": "device ms of the whole "
            "batch's launch from CUDA-graph replays timed with CUDA events, "
            "cycling through copies of the inputs so rows come from HBM "
            "(rows_from_hbm); l2_warm_ms: the same inputs every call; "
            "wrapper_call_ms: back-to-back wrapper calls; bound: owner + "
            "row ids of every lane, the distinct rows the owned lanes read, "
            "the output, at 3.35 TB/s; library: torch.amin of the sums of "
            "the rows the plain version gathers (every lane, gathered and "
            "dequantized beforehand; null where the codes are joined, then "
            "scaled); per_shard_path_ms: the design it replaces on the same "
            "inputs, the same replays (sharded: E one-entry launches + the "
            "torch.minimum fold, after the ragged assembly for a row-sharded "
            "B; scatter: one launch a server over its own lanes, uint16 "
            "gathered, dequantized and joined by the dense kernel, + the "
            "concatenation); per_shard_path_call_ms: its back-to-back calls, "
            "host included", "rows": rows, "ok": True}


# the join's 16-bit rows (bf16 / f16 tables, as the TPU kernel takes
# them; no serving path stores them): the f32 shapes they are cast from,
# the engine's 4096 x 256 and rule 3's 65 536 x 96
HALF_JOIN_SHAPES = (("engine", "engine_f32"),
                    ("rule3_q65536", "rule3_f32_q65536"))


def half_join_rows(torch, kernel, ref, shapes: dict) -> list:
    """``time_shape`` on each of HALF_JOIN_SHAPES' tables cast to bf16
    and to f16, after the kernel's output on those inputs is held bit for
    bit against its plain version."""
    rows = []
    for tag, key in HALF_JOIN_SHAPES:
        table, ss, ts, quant = shapes[key]
        rs = torch.from_numpy(np.asarray(ss, np.int64)).to(table.device)
        rt = torch.from_numpy(np.asarray(ts, np.int64)).to(table.device)
        for dtype in (torch.bfloat16, torch.float16):
            half = table.to(dtype)
            before = dict(kernel.LAUNCHES)
            got = kernel.gather_join(half, rs, half, rt)
            kernel.LAUNCHES.update(before)  # a check, not the path
            want = ref.gather_join_ref(half, rs, half, rt)
            check(got.dtype == dtype and torch.equal(got, want),
                  f"{tag} {dtype}: the join differs from its plain version")
            name = f"{tag}_{str(dtype).split('.')[1]}"
            rows.append({**time_shape(torch, kernel, ref, name, half, ss,
                                      ts, quant),
                         "bit_equal_to_plain": True})
            del half
    return rows


def phase_times(torch, state: dict, shapes: dict) -> dict:
    from repro_torch.kernels.label_join import kernel, ref

    rows = [time_shape(torch, kernel, ref, name, *args)
            for name, args in shapes.items()]
    rows += half_join_rows(torch, kernel, ref, shapes)
    # launches per submit and host-clock submit latency, steady state
    ss, ts, client = state["ss"], state["ts"], state["client"]
    per_submit = {}
    latency = {}
    for label, svc in (("float32", state["svc32"]),
                       ("uint16", state["svc16"])):
        before = kernel.LAUNCHES["label_join"]
        svc.submit(ss, ts, client_districts=client)
        per_submit[label] = kernel.LAUNCHES["label_join"] - before
        latency[label] = host_p50_ms(torch, lambda: svc.submit(
            ss, ts, client_districts=client))
    return {"phase": "times", "timer": "kernel/plain/library: device ms "
            "per call from CUDA-graph replays timed with CUDA events, "
            "cycling through copies of the inputs so rows come from HBM "
            "(rows_from_hbm); l2_warm_ms: the same table every call; "
            "wrapper_call_ms: back-to-back wrapper calls; bound: distinct "
            "rows read once + ids + outputs at 3.35 TB/s", "rows": rows,
            "launches_per_submit": per_submit,
            "submit_latency_host_ms_batch4096": latency, "ok": True}


# -- phase 6: flash attention against its plain version ----------------------

# (B, S, T, H, KV, hd, causal, dtype): the five cases of the JAX
# package's tests/test_flash_attention.py in float32, its bf16 case, an
# unaligned Qwen-shaped case (in both types), a non-causal one, bf16 at
# other head dims (192: Nemotron-4-340B) and at ragged S != T, HuBERT-
# XLarge's hd 80 in bf16, f16 and f32 and hd 192 in f32, then the LM
# paths' shapes (Qwen3-4B, OLMoE-1B-7B, InternVL2-26B's prefills,
# Zamba2-1.2B's shared block, HuBERT-XLarge's forward)
FLASH_SHAPES = [(1, 16, 16, 4, 4, 32, True, "float32"),
                (2, 32, 32, 4, 2, 32, True, "float32"),
                (1, 64, 64, 8, 2, 16, False, "float32"),
                (2, 24, 24, 6, 2, 32, True, "float32"),
                (1, 128, 128, 4, 1, 64, True, "float32"),
                (1, 32, 32, 4, 4, 32, True, "bfloat16"),
                (1, 1000, 1000, 32, 8, 128, True, "float32"),
                (1, 1000, 1000, 32, 8, 128, True, "bfloat16"),
                (2, 300, 300, 32, 8, 128, False, "bfloat16"),
                (1, 77, 77, 4, 4, 16, True, "bfloat16"),
                (2, 130, 100, 8, 8, 64, False, "bfloat16"),
                (2, 500, 500, 16, 4, 192, True, "bfloat16"),
                (1, 300, 1000, 32, 8, 128, True, "bfloat16"),
                (1, 1000, 300, 32, 8, 128, False, "bfloat16"),
                (2, 4096, 4096, 32, 8, 128, True, "bfloat16"),
                (2, 4096, 4096, 16, 16, 128, True, "bfloat16"),
                (1, 2048, 2048, 48, 8, 128, True, "bfloat16"),
                (2, 4096, 4096, 32, 32, 128, True, "bfloat16"),
                (2, 300, 260, 16, 16, 80, False, "bfloat16"),
                (2, 300, 260, 16, 16, 80, True, "float16"),
                (2, 300, 260, 48, 8, 80, False, "float32"),
                (2, 500, 500, 16, 4, 192, True, "float32"),
                (1, 4096, 4096, 16, 16, 80, False, "bfloat16"),
                (1, 4096, 4096, 16, 16, 80, False, "float16"),
                # groups of 9 (StarCoder2-7B, 36 / 4) and 12
                # (Nemotron-4-340B, 96 / 8) at hd 128 and 192, ragged, then
                # the three prefills' own shapes (DeepSeek-67B's group: 8)
                (1, 1000, 1000, 36, 4, 128, True, "bfloat16"),
                (1, 300, 260, 36, 4, 128, False, "bfloat16"),
                (1, 200, 200, 36, 4, 192, True, "bfloat16"),
                (1, 260, 260, 96, 8, 128, True, "bfloat16"),
                (1, 300, 260, 96, 8, 192, False, "bfloat16"),
                (2, 4096, 4096, 36, 4, 128, True, "bfloat16"),
                (2, 4096, 4096, 64, 8, 128, True, "bfloat16"),
                (1, 2048, 2048, 96, 8, 192, True, "bfloat16")]
# (B, S, H, KV, hd): q, k, v as the head-split views of one fused (B, S,
# H + 2 KV, hd) projection, strided in the sequence and head axes
FLASH_STRIDED = [(2, 1000, 32, 8, 128)]
# float32: both sides compute in f32 on unit-normal inputs; only the
# order of the sums and the online rescaling differ (the JAX package's
# own test allows 2e-4)
FLASH_F32_ATOL = 2e-5
# bf16 and f16: the tensor-core kernel rounds each p to the input type
# before P.V (relative error <= u, the type's unit roundoff: 2^-9 in bf16,
# 2^-12 in f16) while l sums the unrounded p, so its f32 result is off by
# at most u * sum_j p_j |v_j| / l. The bound allows twice that, plus the
# f32 bound above for the order of sums, plus one ulp of the input type
# (at the larger magnitude) for the output's one rounding:
#   |got - want| <= ulp + 2u * attention(q, k, |v|) + FLASH_F32_ATOL
# stored mantissa bits of each 16-bit type: ulp = 2^(e - bits), 2u =
# 2^-(bits + 1)
HALF_MANTISSA_BITS = {"torch.bfloat16": 7, "torch.float16": 10}


def half_bound_ratio(got, q, k, v, causal: bool,
                     start: int | None = None) -> float:
    """Largest |got - want| over the bound above, elementwise; want and
    attention(q, k, |v|) from the plain version in f32 on the same 16-bit
    inputs. With ``start``, ``got`` and ``q`` are the query rows from
    ``start`` on and the plain version runs on those rows alone
    (``attention_rows_ref``: the mask at their absolute positions)."""
    import torch

    from repro_torch.kernels.flash_attention import ref
    bits = HALF_MANTISSA_BITS[str(q.dtype)]
    qf, kf, vf = q.float(), k.float(), v.float()
    if start is None:
        want = ref.attention_ref(qf, kf, vf, causal=causal)
        mass = ref.attention_ref(qf, kf, vf.abs(), causal=causal)
    else:
        want = ref.attention_rows_ref(qf, kf, vf, start, causal=causal)
        mass = ref.attention_rows_ref(qf, kf, vf.abs(), start,
                                      causal=causal)
    g = got.float()
    mag = torch.maximum(g.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    bound = ulp + 2.0 ** -(bits + 1) * mass + FLASH_F32_ATOL
    return float(((g - want).abs() / bound).max())


def flash_inputs(torch, dev, b, s, t, h, kv, hd, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    return (torch.randn((b, s, h, hd), generator=gen, device=dev).to(dt),
            torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dt),
            torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dt))


def flash_strided_inputs(torch, dev, b, s, h, kv, hd, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, s, h + 2 * kv, hd), generator=gen,
                      device=dev).bfloat16()
    return qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]


def phase_flash_kernels(torch, dev, errs: dict) -> dict:
    from repro_torch.kernels.flash_attention import kernel, ref
    cases = [(shape, False) for shape in FLASH_SHAPES] + [
        ((b, s, s, h, kv, hd, True, "bfloat16"), True)
        for b, s, h, kv, hd in FLASH_STRIDED]
    rows = []
    for i, ((b, s, t, h, kv, hd, causal, dtype), strided) in \
            enumerate(cases):
        if strided:
            q, k, v = flash_strided_inputs(torch, dev, b, s, h, kv, hd, i)
        else:
            q, k, v = flash_inputs(torch, dev, b, s, t, h, kv, hd, dtype, i)
        got = kernel.flash_attention(q, k, v, causal=causal)
        sync(torch, dev)
        want = ref.attention_ref(q, k, v, causal=causal)
        err = max_abs_err(got, want)
        shape = [b, s, t, h, kv, hd, causal, dtype]
        check(got.dtype == q.dtype and got.shape == q.shape
              and bool(torch.isfinite(got).all()), f"flash {shape} output")
        row = {"shape": shape, "strided": strided, "max_abs_err": err}
        if dtype == "float32":
            check(err <= FLASH_F32_ATOL,
                  f"flash {shape}: {err} > {FLASH_F32_ATOL}")
        else:
            row["bound_ratio"] = half_bound_ratio(got, q, k, v, causal)
            check(row["bound_ratio"] <= 1.0,
                  f"flash {shape}: beyond the {dtype} bound (ratio "
                  f"{row['bound_ratio']}, max abs {err})")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        rows.append(row)
        del q, k, v, got, want
    return {"phase": "kernels_vs_plain_flash", "rows": rows,
            "tolerance": f"float32: <= {FLASH_F32_ATOL} absolute; bf16 "
            "(f16): <= 1 bf16 (f16) ulp of the larger of the two + 2^-8 "
            f"(2^-11) * attention(q, k, |v|) + {FLASH_F32_ATOL}, "
            "elementwise (bound_ratio: the largest |got - want| over that "
            "bound)",
            "ok": True}


# -- phase 7: the dense-LM serving path at published widths -----------------

LM_ARCH = "qwen3_4b"
LM_PREFILL = (2, 4096)                  # batch, tokens per sequence
# f32 throughout (TF32 off): flash and dense attention, the card and the
# host, and decode over the cache against the full forward, differ only
# in the order of sums and the online rescaling, ~1e-6 relative per
# operation
LM_TIGHT_REL = 1e-4
# bf16 flash prefill against bf16 dense prefill at full depth: the dense
# path rounds its scores to bf16 before the softmax and its weights
# before the PV product (2^-9 relative each, on scores of order 1), the
# flash kernel keeps the scores in f32 and rounds its weights to bf16
# before the PV product; the difference passes through 36 random layers.
# Measured 0.0199 on an H100 80GB (seed 1) with the f32 CUDA-core
# kernel; the bound leaves 5x room, and the measured value is reported
# beside it
LM_BF16_REL = 0.1
LM_SERVER = dict(batch=4, max_len=128, requests=8, prompt=(8, 32), new=16)
# the f32 check of Qwen3-4B and StarCoder2-7B: 4 layers at full width, 2
# sequences of 256 tokens; the host computes the first 64 positions'
# forward and 3 decode steps
LM_TIGHT = dict(layers=4, batch=2, tokens=256, host_tokens=64, host_steps=3,
                vocab=None)
# StarCoder2-7B's training depth: f32 params, grads and AdamW's two
# moments take 16 B a parameter; 8 of its 32 layers and the untied
# embedding and head are 2.19 B parameters, 35 GB
STARCODER2_TRAIN = dict(layers=8, batch=1, tokens=512, steps=3, peak_lr=1e-3)

# the dense configs' serving phases. published: (layers, d_model, heads,
# kv heads, head dim, d_ff, vocab, mlp) of the config file; layers: the
# depth run (None: the published one); init: "cast" draws float32
# weights and casts them to bf16 (the serving path's cast), "bf16" draws
# them in bf16 where float32 would not fit; tight: the float32 check of
# the card against the host (vocab: a cut of the vocabulary for that
# check alone, or None); launches: the key its main prefill's flash
# launches are counted under; train: StarCoder2's training (the first
# card training of a GELU MLP)
DENSE_LM = {
    "lm_qwen3_4b": dict(
        arch=LM_ARCH, published=(36, 2560, 32, 8, 128, 9728, 151936,
                                 "swiglu"),
        layers=None, prefill=LM_PREFILL, init="cast",
        tight={**LM_TIGHT, "seed": 0}, launches="flash_attention", seed=1,
        server_seed=13, reduced=["f32 card-vs-host check at 4 of 36 layers"]),
    "lm_starcoder2_7b": dict(
        arch="starcoder2_7b", published=(32, 4608, 36, 4, 128, 18432, 49152,
                                         "gelu"),
        layers=8, prefill=(2, 4096), init="cast",
        tight={**LM_TIGHT, "seed": 61}, launches="flash_attention_starcoder2",
        seed=62, server_seed=63, train=STARCODER2_TRAIN,
        reduced=["depth 32 -> 8 layers: the script's time limit (the "
                 "shape_*_starcoder2_7b cells run all 32 at 32 768 tokens)",
                 "f32 card-vs-host check at 4 of 32 layers",
                 "training at 8 of 32 layers: f32 params, grads and AdamW's "
                 "two moments (16 B a parameter) of 2.19 B parameters are "
                 "35 GB; the f32 card-vs-host train step at 2 layers",
                 "no biases, LayerNorm or 4096-token sliding window (the "
                 "config models none; full causal attention over 4096)"]),
    "lm_deepseek_67b": dict(
        arch="deepseek_67b", published=(95, 8192, 64, 8, 128, 22016, 102400,
                                        "swiglu"),
        layers=8, prefill=(2, 4096), init="bf16",
        tight=dict(layers=2, batch=2, tokens=128, host_tokens=32,
                   host_steps=3, vocab=None, seed=71),
        launches="flash_attention_deepseek67b", seed=72, server_seed=73,
        reduced=["depth 95 -> 8 layers: the script's time limit (its "
                 "shape_prefill_32k and shape_decode_32k cells run 24 "
                 "layers at 32 768 tokens)",
                 "f32 card-vs-host check at 2 layers"]),
    "lm_nemotron_4_340b": dict(
        arch="nemotron_4_340b", published=(96, 18432, 96, 8, 192, 73728,
                                           256000, "squared_relu"),
        layers=4, prefill=(1, 2048), init="bf16",
        tight=dict(layers=1, batch=1, tokens=16, host_tokens=16,
                   host_steps=3, vocab=32768, seed=81),
        launches="flash_attention_nemotron", seed=82, server_seed=83,
        reduced=["depth 96 -> 4 layers: 4 x 6.91 GB + 18.9 GB of embedding "
                 "and head = 46.5 GB in bf16 (8 layers would be 74 GB); "
                 "drawn in bf16 (4 layers in f32 would be 93 GB)",
                 "f32 card-vs-host check at 1 layer and vocabulary 32 768 "
                 "of 256 000 (forward returns hidden states and the "
                 "embedding's rows are independent): 18.6 GB in f32 on the "
                 "card and as much on the host"]),
}


# DeepSeek-67B's depth in its shape cells: 24 x 1.38 GB + 3.36 GB of
# embedding and head = 36.6 GB in bf16, which leaves room for a 32 768-token
# prefill's transients or a decode cache of 11 sequences
DEEPSEEK67B_LAYERS = 24


def rel_diff(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def timed(torch, fn, reps: int) -> tuple[object, list]:
    """``fn()`` ``reps`` times, each between two synchronisations; the
    last result and the host seconds of each call."""
    out, secs = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs


def lm_tight_check(torch, dev, arch: str, t: dict) -> dict:
    """Full width, ``t["layers"]`` layers, float32: the flash prefill
    against the dense one on the card; the card's forward (flash)
    against the host's (dense) at the first ``t["host_tokens"]``
    positions (attention is causal: they see the same keys); and
    decode_step on the card, fed the same tokens one at a time, against
    the card's forward at every position, its first ``t["host_steps"]``
    steps also against decode_step on the host."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.lm import (decode_step, forward, init_cache,
                                       init_params, lm_head_weight)
    from repro_torch.train.train_step import make_prefill_step
    b, s, n = t["batch"], t["tokens"], t["host_tokens"]
    cfg = replace(get_config(arch), num_layers=t["layers"],
                  compute_dtype="float32",
                  **({"vocab_size": t["vocab"]} if t["vocab"] else {}))
    flash = replace(cfg, attention_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(t["seed"])
    params = init_params(cfg, gen, dev)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        device=dev)
    got = make_prefill_step(flash)(params, {"tokens": tok})
    want = make_prefill_step(cfg)(params, {"tokens": tok})
    prefill_rel = rel_diff(got, want)
    check(prefill_rel <= LM_TIGHT_REL,
          f"f32 {arch} flash prefill vs dense: {prefill_rel} > "
          f"{LM_TIGHT_REL}")
    full = forward(params, flash, {"tokens": tok}) \
        @ lm_head_weight(params, flash)
    host = _copy_tree(params, "cpu")
    t0 = time.perf_counter()
    on_host = forward(host, cfg, {"tokens": tok[:, :n].cpu()}) \
        @ lm_head_weight(host, cfg)
    host_s = time.perf_counter() - t0
    host_rel = rel_diff(full[:, :n].cpu(), on_host)
    check(host_rel <= LM_TIGHT_REL, f"f32 {arch} forward on the card vs "
          f"the host: {host_rel} > {LM_TIGHT_REL}")
    del on_host
    cache = init_cache(cfg, b, s, dev)
    host_cache = init_cache(cfg, b, t["host_steps"], "cpu")
    rels = torch.empty(s, dtype=torch.float64, device=dev)
    host_rels = []
    for i in range(s):
        logits, cache = decode_step(params, cfg, cache, tok[:, i:i + 1], i)
        d = (logits[:, 0] - full[:, i]).double()
        rels[i] = d.abs().max() / full[:, i].double().abs().max()
        if i < t["host_steps"]:
            on_host, host_cache = decode_step(host, cfg, host_cache,
                                              tok[:, i:i + 1].cpu(), i)
            host_rels.append(rel_diff(logits.cpu(), on_host))
    decode_rel = float(rels.max())
    check(decode_rel <= LM_TIGHT_REL,
          f"f32 {arch} decode vs forward: {decode_rel} > {LM_TIGHT_REL}")
    check(max(host_rels) <= LM_TIGHT_REL, f"f32 {arch} decode on the card "
          f"vs the host: {host_rels} > {LM_TIGHT_REL}")
    del params, host, cache, host_cache, full
    return {"layers": t["layers"], "batch": b, "tokens": s,
            "vocab": cfg.vocab_size,
            "prefill_flash_vs_dense_rel": prefill_rel,
            "forward_card_vs_host_rel": host_rel, "host_positions": n,
            "host_forward_s": host_s,
            "decode_vs_forward_rel_max": decode_rel,
            "decode_card_vs_host_rel": host_rels,
            "tolerance_rel": LM_TIGHT_REL,
            "measure": "max |a-b| / max |b| over the logits; the card "
            "attends through the f32 flash kernel, the host densely"}


def phase_lm_dense(torch, dev, launches: dict, name: str,
                   pending: dict | None = None) -> dict:
    """The dense config ``DENSE_LM[name]`` at its published width (bf16
    weights, random from a seed), after its float32 card-vs-host check:
    the main path (one flash prefill through ``make_prefill_step``, its
    launches read: one a layer; a decode step, which launches none;
    ``BatchedDecoder`` answering ``LM_SERVER``'s requests and a decode
    profile), then two timed flash prefills and the dense prefill as
    the bf16 yardstick; StarCoder2-7B then trains (the host half of its
    float32 train step in ``pending``'s worker, ``start_host_checks``)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.lm import (cast_params, decode_step, init_cache,
                                       init_params)
    from repro_torch.train.train_step import make_prefill_step

    spec = DENSE_LM[name]
    full = get_config(spec["arch"])
    check((full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
           full.resolved_head_dim, full.d_ff, full.vocab_size, full.mlp_type)
          == spec["published"], f"not the published config: {full}")
    tight = lm_tight_check(torch, dev, spec["arch"], spec["tight"])
    torch.cuda.empty_cache()

    cfg = replace(full, num_layers=spec["layers"] or full.num_layers)
    if spec["init"] == "bf16":
        cfg = replace(cfg, param_dtype="bfloat16")
    flash = replace(cfg, attention_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    if spec["init"] == "cast":
        params = cast_params(params, cfg)       # f32 freed
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    w_gb = weight_gb(params)
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    n_params = sum(t.numel() for t in _leaves(params))
    b, s = spec["prefill"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=dev)}
    prefill = make_prefill_step(flash)
    key = spec["launches"]

    # the main path: one flash prefill, read its launches, then decode
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa)
    logits, first = timed(torch, lambda: prefill(params, batch), 1)
    launches[key] = fa.LAUNCHES["flash_attention"]
    check(launches[key] == cfg.num_layers,
          f"{name}: flash prefill launched {launches[key]} times, not "
          f"{cfg.num_layers}")
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{name} prefill logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cache = init_cache(cfg, b, 8, dev)
    before = fa.LAUNCHES["flash_attention"]
    step_logits, _ = decode_step(params, cfg, cache,
                                 batch["tokens"][:, :1], 0)
    sync(torch, dev)
    check(fa.LAUNCHES["flash_attention"] == before,
          f"{name}: decode_step launched the flash kernel")
    check(bool(torch.isfinite(step_logits).all()), f"{name} decode logits")
    del cache

    server = serve_requests(torch, cfg, params, dev, seed=spec["server_seed"])
    decode_profile = profile_decode(torch, params, cfg, dev)

    # timed prefills: flash (each + num_layers launches), then the dense
    # yardstick (its first run a warm-up)
    before = fa.LAUNCHES["flash_attention"]
    _, flash_s = timed(torch, lambda: prefill(params, batch), 2)
    check(fa.LAUNCHES["flash_attention"] - before == 2 * cfg.num_layers,
          f"{name}: a timed flash prefill did not launch once per layer")
    dense_prefill = make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    dense_logits, dense_s = timed(
        torch, lambda: dense_prefill(params, batch), 3)
    dense_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bf16_rel = rel_diff(logits, dense_logits)
    check(bool(torch.isfinite(dense_logits).all()),
          f"{name} dense prefill logits")
    check(bf16_rel <= LM_BF16_REL,
          f"{name}: bf16 flash prefill vs dense: {bf16_rel} > {LM_BF16_REL}")
    del params
    torch.cuda.empty_cache()
    out = {"phase": name, "arch": spec["arch"],
           "layers": cfg.num_layers, "published_layers": full.num_layers,
           "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "mlp": cfg.mlp_type, "rope_theta": cfg.rope_theta,
           "norm_eps": cfg.norm_eps, "vocab": cfg.vocab_size,
           "params_in_tree": n_params, "param_count": cfg.param_count(),
           "weights_gb_bf16": w_gb, "weights_bytes": w_bytes,
           "weights_drawn_in": "bf16" if spec["init"] == "bf16"
           else "f32, cast to bf16", "init_s": init_s,
           "reduced": spec["reduced"], "tight_f32": tight,
           "prefill": {"batch": b, "tokens": b * s,
                       "flash_first_s": first[0], "flash_s": flash_s,
                       "flash_tokens_per_s": b * s / min(flash_s),
                       "dense_s": dense_s[1:],
                       "dense_tokens_per_s": b * s / min(dense_s[1:]),
                       "flash_vs_dense_rel_bf16": bf16_rel,
                       "tolerance_rel_bf16": LM_BF16_REL,
                       "peak_memory_gb_flash": peak_gb,
                       "peak_memory_gb_dense": dense_peak_gb,
                       "flash_launches": launches[key],
                       "timer": "host clock between synchronisations"},
           "server": server, "decode_profile": decode_profile,
           "decode_launches_flash": 0}
    if "train" in spec:
        out["train_tight_f32"] = lm_train_tight(torch, dev, spec["arch"],
                                                pending=pending[name])
        torch.cuda.empty_cache()
        out["train"] = train_full_depth(torch, dev, spec["arch"],
                                        spec["train"], seed=64,
                                        layers=spec["train"]["layers"])
    return {**out, "ok": True}


def serve_requests(torch, cfg, params, dev, seed: int) -> dict:
    """``BatchedDecoder`` answering ``LM_SERVER``'s requests (random
    prompts from ``seed``, two lockstep groups at its batch): every
    request completes within its token budget, and decode launches no
    flash kernel."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.serve import BatchedDecoder, Request
    rng = np.random.default_rng(seed)
    dec = BatchedDecoder(cfg, params, batch_size=LM_SERVER["batch"],
                         max_len=LM_SERVER["max_len"], device=dev)
    steps = [0]
    step = dec._step

    def counted(*args):
        steps[0] += 1
        return step(*args)

    dec._step = counted
    lo, hi = LM_SERVER["prompt"]
    for rid in range(LM_SERVER["requests"]):
        prompt = rng.integers(0, cfg.vocab_size,
                              int(rng.integers(lo, hi + 1))).tolist()
        dec.submit(Request(rid=rid, prompt=prompt,
                           max_new_tokens=LM_SERVER["new"]))
    before = fa.LAUNCHES["flash_attention"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = dec.run()
    server_s = time.perf_counter() - t0
    check(fa.LAUNCHES["flash_attention"] == before,
          "the server's decode launched the flash kernel")
    check(sorted(r.rid for r in done) == list(range(LM_SERVER["requests"])),
          "not every request completed")
    check(all(len(r.tokens) == LM_SERVER["new"]
              and all(0 <= x < cfg.vocab_size for x in r.tokens)
              for r in done), "a request missed its token budget")
    lat_ms = [r.latency_s * 1e3 for r in done]
    return {**LM_SERVER, "completed": len(done), "decode_steps": steps[0],
            "ms_per_decode_step": server_s * 1e3 / steps[0],
            "server_s": server_s,
            "latency_ms_p50": float(np.percentile(lat_ms, 50)),
            "latency_ms_max": float(max(lat_ms)),
            "timer": "host clock; a step includes its argmax and the copy "
            "of the tokens to the host"}


def device_profile(torch, fn, calls: int) -> dict:
    """``fn()`` ``calls`` times under ``torch.profiler``: CUDA kernels
    launched a call, the device time they take, the host time a call
    (profiler on, so it is inflated), the device's idle share, the top 5
    kernels, and the device time of the copy kernels (``copy`` in the
    kernel's name: the eager program's layout copies and casts). Only
    the card's activity is recorded, and it is read from the profiler's
    raw events (``kineto_results``): the host's aten ops are tens of
    thousands of events a prefill, and turning tens of thousands of
    kernels into ``key_averages``' event tree took 0.2–0.3 ms a kernel
    (``parse_s``: the seconds this reading took)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # a record_function range (the MoE and Mamba2 stages) can also show
    # on the device timeline as a span around its kernels: not a kernel
    ranges = MOE_STAGES + MAMBA2_STAGES
    count, device_ns = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA \
                and not e.is_user_annotation() and e.name() not in ranges:
            count[e.name()] += 1
            device_ns[e.name()] += e.duration_ns()
    parse_s = time.perf_counter() - t0
    device_us = sum(device_ns.values()) / 1e3
    check(device_us > 0, "torch.profiler recorded no device time")
    copy_us = sum(ns for name, ns in device_ns.items()
                  if "copy" in name.lower()) / 1e3
    return {"calls": calls, "kernels_per_call": sum(count.values()) / calls,
            "device_ms_per_call": device_us / 1e3 / calls,
            "host_ms_per_call_profiled": host_s * 1e3 / calls,
            "device_idle_share": 1 - device_us / 1e6 / host_s,
            "copy_kernels_ms_per_call": copy_us / 1e3 / calls,
            "top_kernels_ms_per_call": {
                name[:60]: ns / 1e6 / calls
                for name, ns in device_ns.most_common(5)},
            "parse_s": parse_s}


def profile_decode(torch, params, cfg, dev, steps: int = 3) -> dict:
    """Where a decode step's time goes: ``steps`` steps at the server's
    batch under ``torch.profiler`` (``device_profile``)."""
    from repro_torch.models.lm import decode_step, init_cache
    b = LM_SERVER["batch"]
    cache = init_cache(cfg, b, LM_SERVER["max_len"], dev)
    tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    decode_step(params, cfg, cache, tok, 0)
    pos = iter(range(1, steps + 1))
    prof = device_profile(
        torch, lambda: decode_step(params, cfg, cache, tok, next(pos)),
        steps)
    return {"steps": steps, "kernels_per_step": prof["kernels_per_call"],
            "device_ms_per_step": prof["device_ms_per_call"],
            "host_ms_per_step_profiled": prof["host_ms_per_call_profiled"],
            "device_idle_share": prof["device_idle_share"],
            "top_kernels_ms_per_step": prof["top_kernels_ms_per_call"]}


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes of each flash kernel in an ``nvcc
    -Xptxas -v`` log, by kernel name with its template arguments."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(flash_fwd\w*?)I"
                      r"(?:\d+(__nv_bfloat16|__half))?((?:Li\d+E)+)E", line)
        if m:
            args = ([m.group(2)] if m.group(2) else []) + re.findall(
                r"Li(\d+)E", m.group(3))
            name = f"{m.group(1)}<{', '.join(args)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.setdefault(name, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


# (row name, (B, S, H, KV, hd), causal, dtype): the LM paths' flash
# shapes in bf16 (the causal prefills and HuBERT-XLarge's non-causal
# forward), HuBERT's in float16, Nemotron-4-340B's heads (96 / 8, hd
# 192) in float32, and the prefills of StarCoder2-7B (a group of 9),
# DeepSeek-67B and Nemotron-4-340B (the bf16 hd-192 instance); the
# first is the kernels line's
FLASH_TIMED = [("flash_b2_s4096", (2, 4096, 32, 8, 128), True, "bfloat16"),
               ("flash_olmoe_b2_s4096", (2, 4096, 16, 16, 128), True,
                "bfloat16"),
               ("flash_internvl2_b1_s2048", (1, 2048, 48, 8, 128), True,
                "bfloat16"),
               ("flash_zamba2_b2_s4096", (2, 4096, 32, 32, 128), True,
                "bfloat16"),
               ("flash_hubert_b1_s4096", (1, 4096, 16, 16, 80), False,
                "bfloat16"),
               ("flash_hubert_f16_b1_s4096", (1, 4096, 16, 16, 80), False,
                "float16"),
               ("flash_f32_hd192_b1_s2048", (1, 2048, 96, 8, 192), True,
                "float32"),
               ("flash_starcoder2_b2_s4096", (2, 4096, 36, 4, 128), True,
                "bfloat16"),
               ("flash_deepseek67b_b2_s4096", (2, 4096, 64, 8, 128), True,
                "bfloat16"),
               ("flash_nemotron_b1_s2048", (1, 2048, 96, 8, 192), True,
                "bfloat16")]
# the 32 768-token prefills of SHAPES["prefill_32k"] (Qwen3-4B's GQA
# 32 / 8, Zamba2-1.2B's shared MHA 32 / 32, OLMoE-1B-7B's MHA 16 / 16,
# HuBERT-XLarge's non-causal hd 80, Nemotron-4-340B's GQA 96 / 8 at hd
# 192, the bf16 192 instance, InternVL2-26B's 48 / 8 over 256 patches +
# 32 768 tokens, StarCoder2-7B's group of 9 and DeepSeek-67B's 64 / 8):
# the dense plain version would hold
# (B, H, S, S) float32 scores, up to 412 GB, so these rows hold the
# kernel against the plain version on FLASH_SLICE_ROWS query rows at the
# start, the middle and the end (all keys, the mask at the rows'
# absolute positions), and time the plain version on those rows
FLASH_LONG = [("flash_b1_s32768", (1, 32768, 32, 8, 128), True, "bfloat16"),
              ("flash_zamba2_b1_s32768", (1, 32768, 32, 32, 128), True,
               "bfloat16"),
              ("flash_olmoe_b1_s32768", (1, 32768, 16, 16, 128), True,
               "bfloat16"),
              ("flash_hubert_b1_s32768", (1, 32768, 16, 16, 80), False,
               "bfloat16"),
              ("flash_nemotron_b1_s32768", (1, 32768, 96, 8, 192), True,
               "bfloat16"),
              ("flash_internvl2_b1_s33024", (1, 33024, 48, 8, 128), True,
               "bfloat16"),
              ("flash_starcoder2_b1_s32768", (1, 32768, 36, 4, 128), True,
               "bfloat16"),
              ("flash_deepseek67b_b1_s32768", (1, 32768, 64, 8, 128), True,
               "bfloat16")]
FLASH_SLICE_ROWS = 512


def slice_starts(s: int) -> tuple:
    """The first row of each checked slice: the first, a middle and the
    last FLASH_SLICE_ROWS rows of s."""
    r = FLASH_SLICE_ROWS
    return (0, (s - r) // 2 // r * r, s - r)


def flash_slices_check(torch, got, q, k, v, causal: bool) -> dict:
    """``got`` (the kernel's output on q, k, v) against the plain version
    on the rows of ``slice_starts``: the largest bf16 / f16 bound ratio
    and |got - want| over them."""
    from repro_torch.kernels.flash_attention import ref
    ratio = err = 0.0
    r = FLASH_SLICE_ROWS
    for r0 in slice_starts(q.shape[1]):
        rows = slice(r0, r0 + r)
        ratio = max(ratio, half_bound_ratio(got[:, rows], q[:, rows], k, v,
                                            causal, start=r0))
        want = ref.attention_rows_ref(q[:, rows].float(), k.float(),
                                      v.float(), r0, causal=causal)
        err = max(err, max_abs_err(got[:, rows], want))
    return {"slice_rows": r, "slice_starts": list(slice_starts(q.shape[1])),
            "bound_ratio": ratio, "max_abs_err": err}


def phase_flash_times(torch, dev, logs: dict, errs: dict) -> dict:
    """The flash kernel at the LM paths' prefill shapes, its plain
    version and the library yardstick (SDPA; timed here only, never
    called by the port), with inputs read from HBM; at 32 768 tokens
    (FLASH_LONG) the kernel held against the plain version on slices of
    rows and the plain version timed on those rows; the registers and
    spills of both flash kernels from this run's build log."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ops, ref

    rows = []
    for i, (name, (b, s, h, kv, hd), causal, dtype) in enumerate(
            FLASH_TIMED + FLASH_LONG):
        sliced = i >= len(FLASH_TIMED)

        def sdpa(q, k, v, causal=causal):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)

        def launch(q, k, v, causal=causal):
            return kernel.flash_attention(q, k, v, causal=causal)

        def plain(q, k, v, causal=causal):
            return ref.attention_ref(q, k, v, causal=causal)

        def plain_slices(q, k, v, causal=causal):
            r = FLASH_SLICE_ROWS
            return [ref.attention_rows_ref(q[:, r0:r0 + r], k, v, r0,
                                           causal=causal)
                    for r0 in slice_starts(q.shape[1])]

        q, k, v = flash_inputs(torch, dev, b, s, s, h, kv, hd, dtype,
                               99 + i)
        check_row = {}
        if sliced:
            before = kernel.LAUNCHES["flash_attention"]
            got = kernel.flash_attention(q, k, v, causal=causal)
            sync(torch, dev)
            check(kernel.LAUNCHES["flash_attention"] == before + 1,
                  f"{name}: the kernel did not launch")
            kernel.LAUNCHES["flash_attention"] = before
            check(got.dtype == q.dtype and got.shape == q.shape
                  and bool(torch.isfinite(got).all()), f"{name} output")
            check_row = flash_slices_check(torch, got, q, k, v, causal)
            check(check_row["bound_ratio"] <= 1.0,
                  f"{name}: beyond the {dtype} bound on its row slices "
                  f"({check_row})")
            errs["flash_attention"] = max(errs["flash_attention"],
                                          check_row["max_abs_err"])
            del got
        nbytes = ops.hbm_bytes_per_call(q.shape, k.shape, q.element_size())
        # 4·B·H·S·T·hd, half of it under the causal mask; float32 runs on
        # the CUDA cores, the 16-bit types on the tensor cores
        flops = (2 if causal else 4) * b * h * s * s * hd
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = flops / (PEAK_F32_OPS_PER_S if dtype == "float32"
                          else PEAK_BF16_TENSOR_FLOPS_PER_S) * 1e3
        in_bytes = sum(x.numel() * x.element_size() for x in (q, k, v))
        cold, from_hbm = cold_inputs((q, k, v), in_bytes)
        before = dict(kernel.LAUNCHES)
        kernel_ms = device_ms(torch, launch, cold, 4, 3)
        kernel.LAUNCHES.update(before)  # timing launches are not the path's
        if sliced:
            plain_ms = None
            check_row["plain_slices_ms"] = device_ms(torch, plain_slices,
                                                     cold[:1], 1, 2)
        else:
            plain_ms = device_ms(torch, plain, cold, 2, 2)
        library_ms = device_ms(torch, sdpa, cold, 4, 3)
        copies = len(cold)
        del cold, q, k, v
        bound_ms = max(bytes_ms, ops_ms)
        rows.append({"shape": name, "kernel": "flash_attention",
                     "dims": [b, s, s, h, kv, hd], "dtype": dtype,
                     "causal": causal, "bytes": nbytes, "flops": flops,
                     "copies": copies, "inputs_from_hbm": from_hbm,
                     "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bytes_ms": bytes_ms,
                     "ops_ms": ops_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations",
                     "share_of_bound": bound_ms / kernel_ms,
                     "kernel_tflops": flops / kernel_ms / 1e9,
                     **check_row})
    registers = {}
    for src in kernel.SOURCES:
        if src in logs:
            registers.update(ptxas_usage(logs[src]))
    return {"phase": "flash_times", "registers": registers or "not built "
            "in this run", "timer": "device ms per launch from "
            "CUDA-graph replays timed with CUDA events, cycling through "
            "copies of the inputs", "bound": "max(q, k, v, out bytes at "
            "3.35 TB/s, 4·B·H·S·T·hd (2·B·H·S·T·hd causal) at the 989 "
            "TFLOP/s bf16 / f16 dense tensor-core peak, or float32's 67 "
            "TFLOP/s outside the tensor cores)", "library": "torch.nn."
            "functional.scaled_dot_product_attention(is_causal=causal, "
            "enable_gqa=True) on (B, H, S, hd) views", "rows": rows,
            "ok": True}


# -- phase 8: DIMACS ingest at NY scale ---------------------------------------

# a continent with the vertex count of USA-road-d.NY (264 346; the
# smallest challenge-9 extract, ingest.DATASETS), written as the gzip
# .gr file a real extract arrives as, under the git-ignored build/
NY_SCALE = dict(grid=(8, 8), district=(64, 64), border_links=2, seed=11)
GR_DIR = ROOT / "build" / "chip_smoke"
INGEST_QUERIES = 65536
INGEST_DIJKSTRA = 32
# the host hierarchical builder takes minutes at this size (its prune is
# O(n q^2) numpy), so it runs in a worker process beside the later
# phases and the run waits for it, at most this long, before its end
HOST_CHECK_TIMEOUT_S = 600


def write_gr(csr, path: Path) -> int:
    """A CSR as a gzip DIMACS ``.gr`` file (1-based ids, both arc
    directions, integer weights: the challenge-9 form); returns the arc
    count."""
    import gzip
    us = np.repeat(np.arange(csr.num_vertices), np.diff(csr.indptr))
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt", compresslevel=6) as f:
        f.write("c synthetic continent at USA-road-d.NY's vertex count\n"
                f"p sp {csr.num_vertices} {len(us)}\n")
        np.savetxt(f, np.column_stack(
            [us + 1, csr.indices + 1, csr.weights.astype(np.int64)]),
            fmt="a %d %d %d")
    return len(us)


def host_work(kind: str, indptr, indices, weights, assignment,
              districts: int, out: str) -> None:
    """(Worker process.) ``kind`` "table": the host hierarchical
    builder's table of the graph, saved to ``out`` (.npy); "partition":
    ``bfs_grow_partition`` into ``districts`` (what a real ``.gr`` deploy
    runs first, since the file carries no partition). Its seconds go to
    ``out`` + .json."""
    sys.path.insert(0, str(SRC))
    from repro_torch.core import (Graph, Partition, bfs_grow_partition,
                                  build_border_labels_hierarchical)
    g = Graph(indptr, indices, weights)
    t0 = time.perf_counter()
    if kind == "table":
        np.save(out, build_border_labels_hierarchical(
            g, Partition(assignment, districts)).table)
    else:
        bfs_grow_partition(g, districts, seed=0)
    seconds = time.perf_counter() - t0
    Path(out + ".json").write_text(json.dumps({"seconds": seconds}))


def phase_ingest(torch, dev, launches: dict, errs: dict,
                 peak: dict) -> tuple[dict, dict]:
    """The paper's entry point at NY scale: a .gr file streamed through
    ``load_gr_csr``, B built on the card from it (q above the fused
    closure's cap: stage B's tiled squarings), 65 536 rule-3 queries
    through the gathered join; each kernel's first call held against its
    plain version, answers against Dijkstra. B is held against the host
    hierarchical builder by ``finish_ingest_check``, whose worker process
    this phase starts; returns the phase's line and what that check
    needs."""
    import multiprocessing

    from repro_torch.edge import ComputingCenter
    from repro_torch.ingest import DATASETS, load_gr_csr, synthetic_continent
    from repro_torch.ingest.dimacs import DEFAULT_CHUNK_ARCS
    from repro_torch.kernels.label_join import kernel, ref
    from repro_torch.kernels.minplus import kernel as mp_kernel, ops

    ny = DATASETS["USA-road-d.NY"]
    t0 = time.perf_counter()
    csr, part = synthetic_continent(**NY_SCALE)
    synth_s = time.perf_counter() - t0
    path = GR_DIR / "continent_ny_scale.gr.gz"
    t0 = time.perf_counter()
    arcs = write_gr(csr, path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = load_gr_csr(str(path))
    parse_s = time.perf_counter() - t0
    for name in ("indptr", "indices", "weights"):
        check(np.array_equal(getattr(got, name), getattr(csr, name)),
              f"the .gr file's CSR {name} differs from the generator's")
    g = got.to_graph()
    n = g.num_vertices
    workers = {}
    for kind in ("table", "partition"):
        out = GR_DIR / f"host_{kind}.npy"
        workers[kind] = (multiprocessing.get_context("spawn").Process(
            target=host_work, daemon=True,
            args=(kind, g.indptr, g.indices, g.weights, part.assignment,
                  part.num_districts, str(out))), out)
        workers[kind][0].start()

    # the main path: the center deployed on the card from the file's graph
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernel, mp_kernel)
    center = ComputingCenter(g, part, builder="torch", device=dev)
    seen, held = set(), []
    with hold_first_calls(mp_kernel, seen, held):
        build_s = center.rebuild()
    build_launches = launch_counts(mp_kernel)
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    build_held = check_held(torch, held, errs, "ingest build")
    state = center.incremental_builder().state
    steps = dict(center.incremental_builder().timings)
    q = len(center.border_labels.border_ids)
    check(q > mp_kernel.CLOSURE_MAX_Q, f"q = {q} is not above the fused "
          f"closure's cap {mp_kernel.CLOSURE_MAX_Q}")
    check({"relax", "minplus", "minplus_kmajor"}
          <= {h[0] for h in build_held},
          f"no stage-A sweep, tiled squaring or stage-C product held: "
          f"{build_held}")
    check(build_launches["relax"] > 0
          and build_launches["minplus"] == ops.closure_steps(q)
          and build_launches["minplus_closure"] == 0
          and build_launches["minplus_kmajor"] == 1,
          f"the NY-scale build's launches: {build_launches}")

    rng = np.random.default_rng(17)
    ss = rng.integers(0, n, 2 * INGEST_QUERIES)
    ts = rng.integers(0, n, 2 * INGEST_QUERIES)
    cross = np.nonzero(part.assignment[ss] != part.assignment[ts])[0]
    ss, ts = ss[cross[:INGEST_QUERIES]], ts[cross[:INGEST_QUERIES]]
    check(len(ss) == INGEST_QUERIES, "too few cross-district pairs")
    reset_launches(kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers = center.answer_cross_many(ss, ts)
    first_s = time.perf_counter() - t0
    join_launches = kernel.LAUNCHES["label_join"]
    check(join_launches == 1, f"one batch made {join_launches} launches")
    launches["relax"] += build_launches["relax"]
    launches["minplus"] += build_launches["minplus"]
    launches["minplus_kmajor"] += build_launches["minplus_kmajor"]
    launches["label_join"] += join_launches

    btab = center.border_table_device()
    rs, rt_ = torch.from_numpy(ss).to(dev), torch.from_numpy(ts).to(dev)
    plain = ref.gather_join_ref(btab, rs, btab, rt_).cpu().numpy()
    check(np.array_equal(plain, answers),
          "NY-scale rule-3 join differs from its plain version")
    errs["label_join"] = max(errs["label_join"], max_abs_err(
        torch.from_numpy(answers), torch.from_numpy(plain)))
    exact = scipy_dijkstra(g, ss[:INGEST_DIJKSTRA])
    want = exact[np.arange(INGEST_DIJKSTRA), ts[:INGEST_DIJKSTRA]]
    check(np.array_equal(want.astype(np.float32),
                         answers[:INGEST_DIJKSTRA]),
          "NY-scale rule-3 answers differ from Dijkstra")
    submit_s = [first_s]
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        center.answer_cross_many(ss, ts)
        submit_s.append(time.perf_counter() - t0)
    device_bytes = torch.cuda.memory_allocated()
    join_row = time_shape(torch, kernel, ref, "rule3_f32_ny", btab, ss, ts,
                          None)
    _, squaring = closure_input_shape(torch, f"q{q}", state)[
        f"squaring_q{q}"]
    squaring_row = time_builder_shape(torch, f"squaring_q{q}", "minplus",
                                      squaring, peak)
    out = {"phase": "ingest_dimacs_ny_scale", "n": int(n),
           "arcs": int(arcs), "ny_vertices": ny.num_vertices,
           "ny_arcs": ny.num_arcs, "districts": int(part.num_districts),
           "kmax": state.packed.kmax, "bmax": state.packed.bmax, "q": q,
           "file_bytes": path.stat().st_size, "synth_s": synth_s,
           "write_s": write_s, "chunk_arcs": DEFAULT_CHUNK_ARCS,
           "parse_s": parse_s, "arcs_per_s": arcs / parse_s,
           "csr_equals_generator": True, "build_s": build_s, "build_steps": steps,
           "stage_a_pack_s": steps["stage_a_pack_s"],
           "stage_a_sweeps_s": steps["stage_a_sweeps_s"],
           "stage_a_sweeps": steps["stage_a_sweeps"],
           "stage_b_s": steps["stage_b_s"], "stage_c_s": steps["stage_c_s"],
           "build_launches": build_launches,
           "build_held_against_plain": build_held,
           "adjacency_gb": state.packed.adj.nbytes / 1e9,
           "b_table_mb": center.border_labels.table.nbytes / 1e6,
           "build_peak_memory_gb": build_peak_gb,
           "device_bytes_before": base_bytes,
           "device_bytes_after": device_bytes,
           "b_vs_host_hierarchical": "phase ingest_host_check",
           "queries": len(ss),
           "join_launches": join_launches,
           "answer_cross_many_s": submit_s,
           "join_kernel_ms": join_row["kernel_ms"], "join_row": join_row,
           "tiled_squaring": "phase builder_times, row "
           f"squaring_q{q}",
           "dijkstra_spot_pairs": INGEST_DIJKSTRA,
           "timer": "host clock between synchronisations; kernel rows: "
           "CUDA-graph replays (as phases times and builder_times)",
           "ok": True}
    pending = {"workers": workers, "card_table": center.border_labels.table,
               "squaring_row": squaring_row}
    del center, state, btab
    path.unlink()
    return out, pending


def finish_ingest_check(pending: dict) -> dict:
    """Waits for the host work of the NY-scale graph and holds the
    card-built B against the host hierarchical builder's, bit for bit."""
    t0 = time.perf_counter()
    seconds = {}
    for kind, (worker, out) in pending["workers"].items():
        worker.join(timeout=HOST_CHECK_TIMEOUT_S)
        check(worker.exitcode == 0, f"the host {kind} worker ended with "
              f"{worker.exitcode} (None: still running after "
              f"{HOST_CHECK_TIMEOUT_S} s)")
        stamp = Path(str(out) + ".json")
        seconds[kind] = json.loads(stamp.read_text())["seconds"]
        stamp.unlink()
    waited_s = time.perf_counter() - t0
    out = pending["workers"]["table"][1]
    host_b = np.load(out)
    out.unlink()
    check(np.array_equal(pending["card_table"], host_b),
          "card-built B differs from the host hierarchical B at NY scale")
    return {"phase": "ingest_host_check", "shape": list(host_b.shape),
            "host_hierarchical_build_s": seconds["table"],
            "bfs_grow_partition_s": seconds["partition"],
            "waited_s": waited_s, "b_equals_host_hierarchical": True,
            "timer": "host clock in two worker processes, which ran beside "
            "the phases after ingest_dimacs_ny_scale", "ok": True}


# -- phase 9: the dense LM's training path at Qwen3-4B's width ----------------

# the Qwen3-4B train steps of phase lm_train_qwen3_4b, at 4 of 36 layers:
# shape_train_4k_qwen3_4b runs the step at full depth over 4096 tokens
LM_TRAIN = dict(layers=4, batch=1, tokens=512, steps=5, peak_lr=1e-3)
LM_TRAIN_LOOP = dict(layers=2, steps=8, every=4, fault=6, resume_to=10)
LM_TRAIN_TIGHT = dict(layers=2, batch=1, tokens=256)
# float32 compute on both sides (TF32 off): the loss and the gradient
# norm differ only in the order of sums; a param after one Adam step is
# held by its L2 norm (Adam divides each gradient by its own magnitude,
# so elements whose gradient is near eps amplify that order). Where a
# leaf's L2 cannot dilute that (a zero-initialised bias, whose every
# element after the step is lr · g / (|g| + eps)), an element whose
# clipped gradient is within a few eps of 0 takes the order of sums of
# its near-cancelling sum into its step (Mamba2-1.3B's and Zamba2-1.2B's
# conv_bias_x at 4096 tokens). Such a leaf is held stage by stage
# instead (lm_train_tight), each stage at the same tolerance
LM_TRAIN_REL = 1e-4


def _rel2(torch, a, b) -> float:
    a, b = a.double(), b.to(a.device).double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def train_tight_opt():
    """The optimizer of the float32 train checks: the lr at its peak from
    the first step."""
    from repro_torch.train.optimizer import OptimizerConfig
    return OptimizerConfig(warmup_steps=1)


def train_tight_inputs(torch, arch: str, t: dict, host: dict | None = None):
    """The float32 train check's config (full width, ``t["layers"]``
    layers, ``t["vocab"]`` where given), params (drawn on the host, or
    ``host``: the same params as a worker drew them, ``shared_inputs``),
    batch and step: the same in every process."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.train_step import make_train_step
    cfg = replace(get_config(arch), num_layers=t["layers"],
                  compute_dtype="float32",
                  **({"vocab_size": t["vocab"]} if t.get("vocab") else {}))
    if host is None:
        host = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = synthetic_batch(cfg, DataConfig(t["tokens"], t["batch"], seed=2),
                            0)
    return cfg, host, batch, make_train_step(cfg, train_tight_opt())


@contextlib.contextmanager
def step_gradients(torch):
    """While active, each ``adamw_update`` the train steps call keeps the
    gradients it is given (``kept``: one tree a step; the update reads
    them and leaves them as they are)."""
    from repro_torch.train import train_step as tts
    real, kept = tts.adamw_update, []

    def keeping(cfg, params, grads, state):
        kept.append(grads)
        return real(cfg, params, grads, state)

    tts.adamw_update = keeping
    try:
        yield kept
    finally:
        tts.adamw_update = real


def lm_train_tight(torch, dev, arch: str = LM_ARCH,
                   t: dict = LM_TRAIN_TIGHT, pending: tuple | None = None
                   ) -> dict:
    """One float32 train step of ``arch`` at full width and
    ``t["layers"]`` layers (and ``t["vocab"]``, where given) on the card
    and on the host through the port, from the same params and batch;
    the host's step here, or in the worker of ``pending`` (see
    ``start_host_checks``)."""
    from repro_torch.train.data import to_device
    from repro_torch.train.optimizer import adamw_update, init_opt_state
    shared = shared_inputs(torch, pending)
    cfg, host, batch, step = train_tight_inputs(
        torch, arch, t, shared["params"] if shared else None)
    card = _copy_tree(host, dev)
    t0 = time.perf_counter()
    with routing_recorder(torch) as on_card, step_gradients(torch) as gc:
        pc, _, mc = step(card, init_opt_state(card), to_device(batch, dev))
    sync(torch, dev)
    card_s = time.perf_counter() - t0
    wait = {}
    if pending is None:
        t0 = time.perf_counter()
        with routing_recorder(torch) as on_host, \
                step_gradients(torch) as gh:
            ph, _, mh = step(_copy_tree(host, "cpu"), init_opt_state(host),
                             to_device(batch, "cpu"))
        host_s = time.perf_counter() - t0
    else:
        result, wait = wait_host_check(torch, pending)
        ph, mh, host_s, on_host, gh = result["params"], result["metrics"], \
            result["seconds"], result["routing"], [result["grads"]]
    # an MoE config: every step's gradient sums over all tokens, so the
    # params compare only if the card and the host routed every token
    # alike (each layer's forward and its recomputation)
    routed = {}
    if on_card:
        _, differ = routing_agreement(on_card, on_host)
        routed = {"assignments": sum(c["ids"].numel() for c in on_card),
                  "assignments_routed_differently": differ}
        check(differ == 0, f"f32 {arch} train step: {differ} assignments "
              "routed differently on the card and the host")
    rels = {k: rel_diff(mc[k].cpu(), mh[k]) for k in ("loss", "grad_norm")}
    leaves = {}
    for path, a, b in _paired_leaves(pc, ph):
        leaves[path] = _rel2(torch, a, b)       # summed where a lies
    # a leaf beyond the tolerance after the whole step (see LM_TRAIN_REL)
    # is held stage by stage: its gradient card vs host, and its param
    # after the card's step against the host's AdamW fed the card's
    # gradients (the clip scale of their global norm, the same update)
    by_stage = {}
    beyond = [path for path, rel in leaves.items() if rel > LM_TRAIN_REL]
    if beyond:
        on_card_grads = _copy_tree(gc[0], "cpu")
        host_step, _, _ = adamw_update(train_tight_opt(), host,
                                       on_card_grads, init_opt_state(host))
        grads_host = dict(_named_leaves(gh[0]))
        grads_card = dict(_named_leaves(on_card_grads))
        stepped = dict(_named_leaves(host_step))
        card_after = dict(_named_leaves(pc))
        for path in beyond:
            g = grads_card[path].abs()
            by_stage[path] = {
                "grad_rel2": _rel2(torch, grads_card[path], grads_host[path]),
                "step_on_card_grads_rel2": _rel2(
                    torch, card_after[path].cpu(), stepped[path]),
                "card_grad_abs_min": float(g.min()),
                "card_grad_abs_median": float(g.median())}
        del on_card_grads, host_step
    del host
    worst = max(list(rels.values()) + [v for k, v in leaves.items()
                                       if k not in by_stage]
                + [v[k] for v in by_stage.values()
                   for k in ("grad_rel2", "step_on_card_grads_rel2")])
    check(worst <= LM_TRAIN_REL, f"f32 train step on the card vs the host: "
          f"{worst} > {LM_TRAIN_REL} ({rels}, {leaves}, {by_stage})")
    return {"layers": t["layers"], "batch": t["batch"],
            "tokens": t["tokens"],
            "positions": prefill_positions(cfg, t["tokens"]),
            "vocab": cfg.vocab_size,
            "loss": float(mc["loss"]),
            "loss_rel": rels["loss"], "grad_norm_rel": rels["grad_norm"],
            "param_rel2_max": max(leaves.values()),
            "param_rel2": leaves, "held_by_stage": by_stage,
            "tolerance_rel": LM_TRAIN_REL, **routed,
            "inputs_from_worker": bool(shared),
            "card_step_s": card_s, "host_step_s": host_s,
            **wait,
            "measure": "loss, grad_norm: max |a-b| / max |b|; params after "
            "the step: ||a-b||_2 / ||b||_2; a leaf beyond the tolerance "
            "there (held_by_stage): its gradient, and its param against "
            "the host's AdamW fed the card's gradients, each by "
            "||a-b||_2 / ||b||_2, beside its gradient's smallest and "
            "median magnitude (before the clip by min(1, 1 / grad_norm))"}


def _copy_tree(tree: dict, dev) -> dict:
    return {k: _copy_tree(v, dev) if isinstance(v, dict)
            else v.to(dev, copy=True) for k, v in tree.items()}


def _paired_leaves(a: dict, b: dict, path: str = ""):
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _paired_leaves(v, b[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", v, b[k]


@contextlib.contextmanager
def optimizer_events(torch, tts):
    """While active, each ``adamw_update`` the train steps call records
    a CUDA event before and after it (``events``: one pair a step)."""
    real = tts.adamw_update
    events = []

    def timed_update(*args):
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        out = real(*args)
        pair[1].record()
        events.append(pair)
        return out

    tts.adamw_update = timed_update
    try:
        yield events
    finally:
        tts.adamw_update = real


def lm_train_loop(torch, dev) -> dict:
    """``run_training`` at full width and 2 layers: checkpoints every 4
    steps, a fault injected before step 6 (restore step 4, replay), then
    a resume from step 8's checkpoint to step 10; the loss of every step
    the loop runs, checkpoint bytes, save and restore seconds."""
    import shutil
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.distributed import checkpoint as ckpt_mod
    from repro_torch.models.lm import init_params
    from repro_torch.train import loop as tloop
    from repro_torch.train.data import DataConfig
    from repro_torch.train.optimizer import OptimizerConfig
    lp = LM_TRAIN_LOOP
    cfg = replace(get_config(LM_ARCH), num_layers=lp["layers"])
    directory = GR_DIR / "ckpt"
    shutil.rmtree(directory, ignore_errors=True)
    oc = OptimizerConfig(peak_lr=LM_TRAIN["peak_lr"], warmup_steps=1)
    dcfg = DataConfig(LM_TRAIN["tokens"], LM_TRAIN["batch"], seed=4)
    losses, saves, snapshots, restores = [], [], [], []
    real_make, real_save = tloop.make_train_step, ckpt_mod._save_host
    real_snapshot = ckpt_mod.AsyncCheckpointer.save
    real_restore = tloop.restore_checkpoint

    def make(*a, **k):
        step = real_make(*a, **k)

        def recorded(*args):
            out = step(*args)
            losses.append(float(out[2]["loss"]))
            return out
        return recorded

    def timed(fn, into):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            into.append(time.perf_counter() - t0)
            return out
        return call

    armed = {"on": True}

    def fault_hook(step):
        if step == lp["fault"] and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected node failure")

    logs = []
    tloop.make_train_step = make
    ckpt_mod._save_host = timed(real_save, saves)
    ckpt_mod.AsyncCheckpointer.save = timed(real_snapshot, snapshots)
    tloop.restore_checkpoint = timed(real_restore, restores)
    try:
        def init():
            return init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(5), dev)
        t0 = time.perf_counter()
        first = tloop.run_training(
            cfg, oc, dcfg, tloop.LoopConfig(
                total_steps=lp["steps"], checkpoint_every=lp["every"],
                checkpoint_dir=str(directory), log_every=1), init,
            fault_hook=fault_hook, log=logs.append, device=dev)
        first_s = time.perf_counter() - t0
        del first.params, first.opt_state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        second = tloop.run_training(
            cfg, oc, dcfg, tloop.LoopConfig(
                total_steps=lp["resume_to"], checkpoint_every=lp["every"],
                checkpoint_dir=str(directory), log_every=1), init,
            fault_hook=fault_hook, log=logs.append, device=dev)
        second_s = time.perf_counter() - t0
    finally:
        tloop.make_train_step = real_make
        ckpt_mod._save_host = real_save
        ckpt_mod.AsyncCheckpointer.save = real_snapshot
        tloop.restore_checkpoint = real_restore
    step_dir = directory / f"step_{lp['every']}"
    ckpt_bytes = sum(p.stat().st_size for p in step_dir.iterdir())
    latest = ckpt_mod.latest_step(str(directory))
    shutil.rmtree(directory)
    f = lp["fault"]
    # the loop's step calls: 0 .. f-1, then (after restoring step
    # `every`) every .. steps-1, then the resume's steps .. resume_to-1
    replay = losses[f:f + f - lp["every"]]
    before = losses[lp["every"]:f]
    check(first.step == lp["steps"] and first.restarts == 1
          and second.step == lp["resume_to"] and latest == lp["steps"],
          f"loop steps {first.step}, {second.step}, restarts "
          f"{first.restarts}, latest checkpoint {latest}")
    check(any("restoring last checkpoint" in m for m in logs)
          and f"resumed from checkpoint step {lp['steps']}" in logs,
          f"the loop's log lacks the restore or the resume: {logs}")
    check(len(losses) == f + (lp["steps"] - lp["every"])
          + (lp["resume_to"] - lp["steps"])
          and all(np.isfinite(losses)), f"loop losses: {losses}")
    replay_rel = max(abs(a - b) / abs(b) for a, b in zip(replay, before))
    check(replay[0] == before[0] and replay_rel <= 1e-5,
          f"the replay after the restore differs: {replay} vs {before}")
    return {"layers": lp["layers"], "steps": lp["steps"],
            "checkpoint_every": lp["every"], "fault_at": f,
            "resume_to": lp["resume_to"], "losses": losses,
            "replay_rel_max": replay_rel, "restarts": first.restarts,
            "checkpoint_bytes": ckpt_bytes, "snapshot_s": snapshots,
            "save_s": saves, "restore_s": restores,
            "first_run_s": first_s, "resume_run_s": second_s,
            "timer": "host clock; snapshot_s: AsyncCheckpointer.save (the "
            "copy to the host, on the step's path), save_s: the writer "
            "thread's npz files, hash and rename, restore_s: "
            "restore_checkpoint (hash check, read, upload)"}


def train_full_depth(torch, dev, arch: str, tr: dict, seed: int,
                     layers: int | None = None,
                     profile: bool = False) -> dict:
    """``tr["steps"]`` train steps at full width and depth, or at
    ``layers`` (float32 params, bf16 compute, per-layer remat, dense
    attention) on one batch drawn from ``seed``: the first loss is near
    ln V and the loss falls; step, forward + backward and AdamW times,
    peak memory; with ``profile`` one more step under ``torch.profiler``
    (``device_profile``)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params
    from repro_torch.train import train_step as tts
    from repro_torch.train.data import DataConfig, synthetic_batch, to_device
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    cfg = get_config(arch)
    cfg = replace(cfg, num_layers=layers or cfg.num_layers)
    check(cfg.remat and cfg.param_dtype == "float32"
          and cfg.compute_dtype == "bfloat16"
          and cfg.attention_impl == "dense", f"train config: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    opt = init_opt_state(params)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    batch = to_device(synthetic_batch(
        cfg, DataConfig(tr["tokens"], tr["batch"], seed=seed), 0), dev)
    if cfg.frontend == "patch":
        # the patches go before the tokens; the loss scores the tokens
        check(tuple(batch["patches"].shape) == (tr["batch"], cfg.num_patches,
                                                cfg.d_model)
              and batch["patches"].dtype == torch.float32
              and batch["labels"].shape == batch["tokens"].shape,
              f"{arch} train batch: {batch['patches'].shape}")
    step = tts.make_train_step(cfg, OptimizerConfig(
        peak_lr=tr["peak_lr"], warmup_steps=1))
    losses, step_s, fwd_bwd_ms, opt_ms = [], [], [], []
    with optimizer_events(torch, tts) as events:
        for _ in range(tr["steps"]):
            start = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            begin, end = events[-1]
            fwd_bwd_ms.append(start.elapsed_time(begin))
            opt_ms.append(begin.elapsed_time(end))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = device_profile(torch, lambda: step(params, opt, batch), 1) \
        if profile else None
    n_params = sum(t.numel() for t in _leaves(params))
    del params, opt, batch
    torch.cuda.empty_cache()
    ln_v = float(np.log(cfg.vocab_size))
    check(all(np.isfinite(losses)), f"{arch} train losses: {losses}")
    check(abs(losses[0] - ln_v) <= 1.0,
          f"{arch}: first loss {losses[0]} is not near ln(V) = {ln_v}")
    check(losses[-1] < losses[0], f"{arch}: the loss did not fall: {losses}")
    warm = float(np.median(step_s[1:]))
    return {"layers": cfg.num_layers, "published_layers":
            get_config(arch).num_layers, "params_in_tree": n_params,
            "init_s": init_s, "state_gb": state_gb, "batch": tr["batch"],
            "tokens": tr["tokens"],
            "positions": prefill_positions(cfg, tr["tokens"]),
            "peak_lr": tr["peak_lr"],
            "losses": losses, "ln_vocab": ln_v, "step_s": step_s,
            "ms_per_step": 1e3 * warm, "fwd_bwd_ms": fwd_bwd_ms,
            "optimizer_ms": opt_ms,
            "tokens_per_s": tr["batch"] * tr["tokens"] / warm,
            "max_memory_allocated_gb": peak_gb,
            **({"profile": prof} if profile else {}),
            "timer": "step_s: host clock between synchronisations (the "
            "first step pays cuBLAS set-up; ms_per_step and tokens_per_s "
            "take the median of the others); fwd_bwd_ms / optimizer_ms: "
            "CUDA events around the step and around adamw_update"}


def phase_lm_train(torch, dev, pending: dict) -> dict:
    from repro_torch.configs import get_config

    tight = lm_train_tight(torch, dev, pending=pending["lm_train_qwen3_4b"])
    torch.cuda.empty_cache()
    loop = lm_train_loop(torch, dev)
    torch.cuda.empty_cache()

    cfg = get_config(LM_ARCH)
    train = train_full_depth(torch, dev, LM_ARCH, LM_TRAIN, seed=6,
                             layers=LM_TRAIN["layers"])
    return {"phase": "lm_train_qwen3_4b", "arch": LM_ARCH,
            "reduced": [f"train steps at {LM_TRAIN['layers']} of "
                        f"{cfg.num_layers} layers: shape_train_4k_qwen3_4b "
                        "runs the step at full depth over 4096 tokens"],
            "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "params": cfg.param_count(),
            "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
            **train, "tight_f32": tight, "loop": loop, "ok": True}


# -- phase 10: the MoE family, MLA and the frontends (slice 11) ---------------

OLMOE_ARCH = "olmoe_1b_7b"
OLMOE_PREFILL = (2, 4096)               # batch, tokens per sequence
OLMOE_TIGHT = dict(layers=2, batch=1, tokens=128)
OLMOE_TRAIN = dict(layers=2, batch=1, tokens=512, steps=3, peak_lr=1e-3)
DEEPSEEK_ARCH = "deepseek_v2_236b"
# first_k_dense 1 + 2 MoE layers: the published widths, 9.33 B parameters
# (18.7 GB in bf16); the full 60 layers would need ~472 GB
DEEPSEEK_LAYERS = 3
DEEPSEEK_PREFILL = (1, 2048)
DEEPSEEK_DECODE = dict(batch=4, max_len=64, steps=8)
VLM_ARCH = "internvl2_26b"
VLM_PREFILL = (1, 1792)                 # batch, text tokens (+ 256 patches)
AUDIO_ARCH = "hubert_xlarge"
AUDIO_FRAMES = (1, 4096)
# the record_function ranges of models/moe.py, one a stage of a layer
MOE_STAGES = ("moe/router", "moe/dispatch", "moe/experts", "moe/combine",
              "moe/shared")


@contextlib.contextmanager
def routing_recorder(torch):
    """While active, every MoE dispatch records its routing: per call (a
    layer), each token's expert ids in ascending order (T, k) and
    whether each of those assignments was kept (T, k), on the device."""
    from repro_torch.models import moe
    real = moe.dispatch_plan
    calls = []

    def recorded(expert_ids, e, cap):
        order, keep, slot = real(expert_ids, e, cap)
        kept = torch.empty_like(keep)
        kept[order] = keep
        ids, at = torch.sort(expert_ids, dim=1)
        calls.append({"ids": ids, "cap": cap,
                      "kept": kept.view(expert_ids.shape).gather(1, at)})
        return order, keep, slot

    moe.dispatch_plan = recorded
    try:
        yield calls
    finally:
        moe.dispatch_plan = real


def routing_agreement(a: list, b: list) -> tuple:
    """(tokens whose expert ids and kept flags agree in every recorded
    layer (T,) bool, assignments whose expert ids differ, summed over
    layers). Near-ties of the float32 router probabilities can route a
    token differently on two paths; that is rounding, and the values of
    such a token are not compared."""
    check(len(a) == len(b), f"{len(a)} against {len(b)} MoE layers")
    agree, differ = None, 0
    for x, y in zip(a, b):
        ids, kept = (y[k].to(x[k].device) for k in ("ids", "kept"))
        same = (x["ids"] == ids) & (x["kept"] == kept)
        differ += int((x["ids"] != ids).sum())
        row = same.all(dim=1)
        agree = row if agree is None else agree & row
    return agree, differ


def drop_shares(calls: list) -> list:
    """Per layer, the share of (token, expert) assignments dropped."""
    return [1.0 - float(c["kept"].float().mean()) for c in calls]


def weight_gb(params: dict) -> float:
    return sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9


def stage_profile(torch, fn, stages: tuple, reps: int = 3) -> dict:
    """``fn()`` ``reps`` times under ``torch.profiler``: the device time
    of the kernels launched inside each ``record_function`` range of
    ``stages``, a call, and of all kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in stages}
    kernels_us = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in out:
            out[e.name] += e.device_time_total / 1e3 / reps
        elif e.device_type == DeviceType.CUDA and e.name not in stages:
            # (a range's span on the device timeline is not a kernel)
            kernels_us += e.device_time_total
    device_ms = kernels_us / 1e3 / reps
    check(device_ms > 0, "the profiler saw no device time")
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.key not in stages),
                 key=lambda e: -e.self_device_time_total)[:6]
    return {"device_ms_profiled": device_ms, "stage_device_ms": out,
            "stage_share": {k: v / device_ms for k, v in out.items()},
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                               / reps for e in top}}


def moe_layer_profile(torch, params, cfg, x, reps: int = 3) -> dict:
    """One MoE layer (layer 0 of ``layers``, cast to the compute dtype)
    on the hidden states ``x`` under ``torch.profiler``: the device time
    of the kernels launched inside each stage's range (router, sort and
    dispatch, the experts' batched matmuls, combine, shared experts), a
    call; and the layer's device time with CUDA events."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.lm import _layer
    from repro_torch.models.moe import moe_apply
    from repro_torch.tree import tree_map
    cd = dtype_of(cfg.compute_dtype)
    p = tree_map(lambda a: a.to(cd), _layer(params["layers"], 0)["moe"])
    moe_apply(p, cfg, x)
    layer_ms = event_ms(torch, lambda: moe_apply(p, cfg, x), reps)
    stages = tuple(name for name in MOE_STAGES
                   if name != "moe/shared" or "shared" in p)
    return {"tokens": x.shape[0] * x.shape[1], "layer_ms_events": layer_ms,
            **stage_profile(torch, lambda: moe_apply(p, cfg, x), stages,
                            reps),
            "timer": "torch.profiler: device time of the kernels launched "
            "inside each record_function range, a call; layer_ms_events: "
            "CUDA events around the call"}


def olmoe_tight(torch, dev) -> tuple[dict, dict, object]:
    """OLMoE at full width and 2 layers in float32 (TF32 off), on the
    card and on the host from the same params: the routing of both
    (assignments whose ids differ are counted), then the logits at every
    position before the first token routed differently in any layer
    (the attention is causal, and capacity goes to tokens in order, so
    those positions see the same routing) within LM_TIGHT_REL. Returns
    the check, the card's params and the config."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.lm import forward, init_params, lm_head_weight
    t = OLMOE_TIGHT
    cfg = replace(get_config(OLMOE_ARCH), num_layers=t["layers"],
                  compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(21),
                         dev)
    host = _copy_tree(params, "cpu")
    gen = torch.Generator(device=dev).manual_seed(22)
    tok = torch.randint(0, cfg.vocab_size, (t["batch"], t["tokens"]),
                        generator=gen, device=dev)
    with routing_recorder(torch) as on_card:
        card = forward(params, cfg, {"tokens": tok}) \
            @ lm_head_weight(params, cfg)
        sync(torch, dev)
    t0 = time.perf_counter()
    with routing_recorder(torch) as on_host:
        want = forward(host, cfg, {"tokens": tok.cpu()}) \
            @ lm_head_weight(host, cfg)
    host_s = time.perf_counter() - t0
    agree, differ = routing_agreement(on_host, on_card)
    n = t["batch"] * t["tokens"]
    first = n if bool(agree.all()) else int((~agree).nonzero()[0, 0])
    check(t["batch"] == 1 and first > 0, f"no position before the first "
          f"routing difference ({differ} assignments differ)")
    rel = rel_diff(card[0, :first].cpu(), want[0, :first])
    check(rel <= LM_TIGHT_REL, f"f32 OLMoE on the card vs the host: "
          f"{rel} > {LM_TIGHT_REL}")
    return ({"layers": t["layers"], "batch": t["batch"],
             "tokens": t["tokens"], "assignments": n * cfg.experts_per_token
             * t["layers"], "assignments_routed_differently": differ,
             "positions_compared": first, "logits_rel": rel,
             "tolerance_rel": LM_TIGHT_REL, "host_forward_s": host_s,
             "drop_share_card": drop_shares(on_card),
             "measure": "max |a-b| / max |b| over the logits of the "
             "positions before the first token routed differently"},
            params, cfg)


def olmoe_train(torch, dev, params, cfg) -> dict:
    """3 train steps at full width, 2 layers, float32 params and bf16
    compute, on one 512-token batch: the losses fall, the MoE auxiliary
    term is reported a step."""
    from dataclasses import replace

    from repro_torch.models import lm
    from repro_torch.train.data import DataConfig, synthetic_batch, to_device
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    tr = OLMOE_TRAIN
    cfg = replace(cfg, compute_dtype="bfloat16")
    check(cfg.param_dtype == "float32" and cfg.remat
          and cfg.moe_capacity_factor == 1.25, f"train config: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    opt = init_opt_state(params)
    sync(torch, dev)
    state_gb = torch.cuda.memory_allocated() / 1e9
    batch = to_device(synthetic_batch(
        cfg, DataConfig(tr["tokens"], tr["batch"], seed=7), 0), dev)
    step = make_train_step(cfg, OptimizerConfig(peak_lr=tr["peak_lr"],
                                                warmup_steps=1))
    aux, real = [], lm.aux_load_balance_loss

    def recorded(*a):
        out = real(*a)
        aux.append(out.detach())
        return out

    losses, step_s = [], []
    lm.aux_load_balance_loss = recorded
    try:
        for _ in range(tr["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
    finally:
        lm.aux_load_balance_loss = real
    aux = [float(a) for a in aux]
    check(all(np.isfinite(losses + aux)), f"losses {losses}, aux {aux}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    n_params = sum(t.numel() for t in _leaves(params))
    return {"layers": cfg.num_layers, "params": n_params,
            "state_gb": state_gb, "batch": tr["batch"],
            "tokens": tr["tokens"], "losses": losses, "aux": aux,
            "aux_coef": lm.MOE_AUX_COEF, "step_s": step_s,
            "tokens_per_s": tr["batch"] * tr["tokens"] / min(step_s[1:]),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9, "timer": "host clock between synchronisations"}


def phase_lm_olmoe(torch, dev, launches: dict) -> dict:
    """OLMoE-1B-7B at its published config, full depth and width, bf16
    weights: a flash prefill of 2 x 4096 tokens (its launches read), the
    capacity drops at cf 1.25, two prefills equal bit for bit, the
    dense prefill as the yardstick, BatchedDecoder at batch 4, and a
    profile of one MoE layer; before it, the f32 card-vs-host check and
    3 train steps at 2 layers."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.lm import (_embed_inputs, cast_params, forward,
                                       init_params, lm_head_weight)
    from repro_torch.models.moe import capacity
    from repro_torch.train.train_step import make_prefill_step

    tight, small, small_cfg = olmoe_tight(torch, dev)
    train = olmoe_train(torch, dev, small, small_cfg)
    del small
    torch.cuda.empty_cache()

    cfg = replace(get_config(OLMOE_ARCH), param_dtype="bfloat16")
    check((cfg.num_layers, cfg.d_model, cfg.num_experts,
           cfg.experts_per_token, cfg.moe_d_ff, cfg.vocab_size)
          == (16, 2048, 64, 8, 1024, 50304), f"not the published config: "
          f"{cfg}")
    flash = replace(cfg, attention_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(23)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    w_gb, n_params = weight_gb(params), sum(t.numel()
                                            for t in _leaves(params))
    b, s = OLMOE_PREFILL
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=dev)}
    prefill = make_prefill_step(flash)
    cap = capacity(cfg.moe_capacity_factor, b * s, cfg.experts_per_token,
                   cfg.num_experts)

    # the main path: one flash prefill, its launches read
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa)
    with routing_recorder(torch) as first_routing:
        logits, first_s = timed(torch, lambda: prefill(params, batch), 1)
    launches["flash_attention_olmoe"] = fa.LAUNCHES["flash_attention"]
    check(launches["flash_attention_olmoe"] == cfg.num_layers,
          f"OLMoE flash prefill launched {fa.LAUNCHES['flash_attention']} "
          f"times, not {cfg.num_layers}")
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "OLMoE prefill logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(first_routing) == cfg.num_layers
          and all(c["cap"] == cap for c in first_routing),
          f"capacity {[c['cap'] for c in first_routing]}, not {cap}")
    drops = drop_shares(first_routing)
    again = prefill(params, batch)
    check(torch.equal(again, logits), "two OLMoE prefills differ")
    before = fa.LAUNCHES["flash_attention"]
    _, flash_s = timed(torch, lambda: prefill(params, batch), 2)
    check(fa.LAUNCHES["flash_attention"] - before == 2 * cfg.num_layers,
          "a timed OLMoE prefill did not launch once per layer")
    dense_prefill = make_prefill_step(cfg)
    dense_logits, dense_s = timed(
        torch, lambda: dense_prefill(params, batch), 2)
    check(bool(torch.isfinite(dense_logits).all()), "dense prefill logits")

    # the yardstick: every position's logits, flash against dense, where
    # the two paths routed the token alike in every layer
    head = lm_head_weight(cast_params(params, cfg), cfg)
    with routing_recorder(torch) as r_flash:
        h_flash = forward(params, flash, batch).reshape(b * s, -1)
    with routing_recorder(torch) as r_dense:
        h_dense = forward(params, cfg, batch).reshape(b * s, -1)
    agree, differ = routing_agreement(r_flash, r_dense)
    rows = agree.nonzero()[:, 0]
    check(rows.numel() > 0, "no token routed alike by flash and dense")
    bf16_rel = max(rel_diff(h_flash[rows[i:i + 1024]] @ head,
                            h_dense[rows[i:i + 1024]] @ head)
                   for i in range(0, rows.numel(), 1024))
    check(bf16_rel <= LM_BF16_REL,
          f"bf16 OLMoE flash prefill vs dense: {bf16_rel} > {LM_BF16_REL}")
    del h_flash, h_dense, r_flash, r_dense

    server = serve_requests(torch, cfg, params, dev, seed=17)
    decode_profile = profile_decode(torch, params, cfg, dev)
    expert_bytes = sum(params["layers"]["moe"][w].numel() * 2
                       for w in ("wi", "wg", "wo"))
    x = _embed_inputs(params, cfg, batch)
    layer = moe_layer_profile(torch, params, cfg, x)
    del params, x
    torch.cuda.empty_cache()
    return {"phase": "lm_olmoe_1b_7b", "arch": OLMOE_ARCH,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads],
            "experts": [cfg.num_experts, cfg.experts_per_token],
            "moe_d_ff": cfg.moe_d_ff, "vocab": cfg.vocab_size,
            "params_in_tree": n_params, "param_count": cfg.param_count(),
            "weights_gb_bf16": w_gb, "init_s": init_s, "tight_f32": tight,
            "train_2_layers": train,
            "prefill": {"batch": b, "tokens": b * s, "capacity": cap,
                        "capacity_factor": cfg.moe_capacity_factor,
                        "drop_share_by_layer": drops,
                        "flash_first_s": first_s[0], "flash_s": flash_s,
                        "flash_tokens_per_s": b * s / min(flash_s),
                        "dense_s": dense_s,
                        "dense_tokens_per_s": b * s / min(dense_s),
                        "two_prefills_bit_equal": True,
                        "flash_vs_dense_rel_bf16": bf16_rel,
                        "tokens_compared": int(rows.numel()),
                        "assignments_routed_differently": differ,
                        "tolerance_rel_bf16": LM_BF16_REL,
                        "peak_memory_gb_flash": peak_gb,
                        "flash_launches": launches["flash_attention_olmoe"],
                        "timer": "host clock between synchronisations"},
            "server": server, "decode_profile": decode_profile,
            "decode_expert_bytes": expert_bytes,
            "decode_bytes_bound_ms": expert_bytes / PEAK_BYTES_PER_S * 1e3,
            "moe_layer_profile": layer, "decode_launches_flash": 0,
            "ok": True}


def phase_lm_deepseek(torch, dev) -> dict:
    """DeepSeek-V2 at its published width (d 5120, 128 heads, MLA, 160
    routed + 2 shared experts top-6) cut to 3 layers (first_k_dense 1 +
    2 MoE), bf16 weights: a prefill of 1 x 2048 (cap 96 at cf 1.25),
    two prefills equal bit for bit, a profile of one MoE layer, and
    decode steps at batch 4 from the MLA cache."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.lm import (_embed_inputs, decode_step,
                                       init_cache, init_params)
    from repro_torch.models.moe import capacity
    from repro_torch.train.train_step import make_prefill_step

    full = get_config(DEEPSEEK_ARCH)
    check((full.d_model, full.num_heads, full.kv_lora_rank,
           full.q_lora_rank, full.num_experts, full.num_shared_experts,
           full.experts_per_token, full.moe_d_ff, full.first_k_dense)
          == (5120, 128, 512, 1536, 160, 2, 6, 1536, 1),
          f"not the published config: {full}")
    cfg = replace(full, num_layers=DEEPSEEK_LAYERS, param_dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(31)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    w_gb, n_params = weight_gb(params), sum(t.numel()
                                            for t in _leaves(params))
    b, s = DEEPSEEK_PREFILL
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=dev)}
    prefill = make_prefill_step(cfg)
    cap = capacity(cfg.moe_capacity_factor, b * s, cfg.experts_per_token,
                   cfg.num_experts)
    torch.cuda.reset_peak_memory_stats()
    with routing_recorder(torch) as routing:
        logits, first_s = timed(torch, lambda: prefill(params, batch), 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "DeepSeek prefill logits")
    check(len(routing) == cfg.num_layers - cfg.first_k_dense
          and all(c["cap"] == cap for c in routing),
          f"capacity {[c['cap'] for c in routing]}, not {cap}")
    again, prefill_s = timed(torch, lambda: prefill(params, batch), 2)
    check(torch.equal(again, logits), "two DeepSeek prefills differ")
    layer = moe_layer_profile(torch, params, cfg,
                              _embed_inputs(params, cfg, batch))

    d = DEEPSEEK_DECODE
    cache = init_cache(cfg, d["batch"], d["max_len"], dev)
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(cache))
    per_token_values = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    gqa_values = 2 * cfg.num_heads * cfg.qk_nope_head_dim
    tok = torch.randint(0, cfg.vocab_size, (d["batch"], d["steps"]),
                        generator=gen, device=dev)
    step_s = []
    for i in range(d["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = decode_step(params, cfg, cache, tok[:, i:i + 1], i)
        check(bool(torch.isfinite(out).all()), f"decode step {i} logits")
        step_s.append(time.perf_counter() - t0)
    written = bool(cache["layers"]["latent"][:, :, :d["steps"]].any()) \
        and not bool(cache["layers"]["latent"][:, :, d["steps"]:].any())
    check(written, "the MLA cache was not written at exactly the decoded "
          "positions")
    routed_bytes = sum(params["layers"]["moe"][w].numel() * 2
                       for w in ("wi", "wg", "wo"))
    del params, cache
    torch.cuda.empty_cache()
    return {"phase": "lm_deepseek_v2_width", "arch": DEEPSEEK_ARCH,
            "layers": cfg.num_layers, "published_layers": full.num_layers,
            "first_k_dense": cfg.first_k_dense, "d_model": cfg.d_model,
            "heads": cfg.num_heads,
            "mla": [cfg.kv_lora_rank, cfg.q_lora_rank,
                    cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                    cfg.v_head_dim],
            "experts": [cfg.num_experts, cfg.num_shared_experts,
                        cfg.experts_per_token], "moe_d_ff": cfg.moe_d_ff,
            "params_in_tree": n_params, "param_count": cfg.param_count(),
            "weights_gb_bf16": w_gb, "init_s": init_s,
            "prefill": {"batch": b, "tokens": b * s, "capacity": cap,
                        "drop_share_by_layer": drop_shares(routing),
                        "first_s": first_s[0], "s": prefill_s,
                        "tokens_per_s": b * s / min(prefill_s),
                        "two_prefills_bit_equal": True,
                        "peak_memory_gb": peak_gb,
                        "timer": "host clock between synchronisations"},
            "moe_layer_profile": layer,
            "decode": {**d, "step_s": step_s,
                       "ms_per_step": 1e3 * float(np.median(step_s[1:])),
                       "cache_bytes": cache_bytes,
                       "cache_values_per_token_layer": per_token_values,
                       "gqa_values_per_token_layer_same_heads": gqa_values,
                       "routed_expert_bytes": routed_bytes,
                       "bytes_bound_ms_routed_experts":
                       routed_bytes / PEAK_BYTES_PER_S * 1e3,
                       "timer": "host clock between synchronisations"},
            "ok": True}


def phase_lm_frontends(torch, dev, launches: dict) -> dict:
    """InternVL2-26B at full depth (bf16): a flash prefill of 256
    patches + 1792 text tokens (its launches read) against the dense
    prefill; HuBERT-XLarge at full depth: a non-causal forward over 1 x
    4096 frames through the flash kernel's hd-80 instance (its launches
    read) against the dense forward."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.lm import forward, init_params
    from repro_torch.train.train_step import make_prefill_step

    cfg = replace(get_config(VLM_ARCH), param_dtype="bfloat16")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.num_patches, cfg.frontend) == (48, 6144, 48, 8, 256, "patch"),
          f"not the published config: {cfg}")
    flash = replace(cfg, attention_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(41)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    w_gb = weight_gb(params)
    b, s = VLM_PREFILL
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=dev),
             "patches": torch.randn((b, cfg.num_patches, cfg.d_model),
                                    generator=gen, device=dev)}
    prefill = make_prefill_step(flash)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa)
    logits, first_s = timed(torch, lambda: prefill(params, batch), 1)
    launches["flash_attention_internvl2"] = fa.LAUNCHES["flash_attention"]
    check(launches["flash_attention_internvl2"] == cfg.num_layers,
          f"InternVL2 flash prefill launched "
          f"{fa.LAUNCHES['flash_attention']} times, not {cfg.num_layers}")
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "InternVL2 logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, flash_s = timed(torch, lambda: prefill(params, batch), 2)
    dense_logits, dense_s = timed(
        torch, lambda: make_prefill_step(cfg)(params, batch), 2)
    vlm_rel = rel_diff(logits, dense_logits)
    check(vlm_rel <= LM_BF16_REL,
          f"bf16 InternVL2 flash prefill vs dense: {vlm_rel} > "
          f"{LM_BF16_REL}")
    positions = b * (cfg.num_patches + s)
    del params, batch
    torch.cuda.empty_cache()

    audio = replace(get_config(AUDIO_ARCH), param_dtype="bfloat16")
    check((audio.num_layers, audio.d_model, audio.resolved_head_dim,
           audio.causal, audio.frontend, audio.attention_impl)
          == (48, 1280, 80, False, "frame", "dense"),
          f"not the published config: {audio}")
    params = init_params(audio, gen, dev)
    ab, af = AUDIO_FRAMES
    frames = {"frames": torch.randn((ab, af, audio.d_model), generator=gen,
                                    device=dev)}
    audio_flash = replace(audio, attention_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa)
    hidden, first_flash_s = timed(
        torch, lambda: forward(params, audio_flash, frames), 1)
    launches["flash_attention_hubert"] = fa.LAUNCHES["flash_attention"]
    check(launches["flash_attention_hubert"] == audio.num_layers,
          f"HuBERT flash forward launched {fa.LAUNCHES['flash_attention']} "
          f"times, not {audio.num_layers}")
    check(tuple(hidden.shape) == (ab, af, audio.d_model)
          and bool(torch.isfinite(hidden).all()), "HuBERT hidden states")
    audio_flash_peak = torch.cuda.max_memory_allocated() / 1e9
    _, audio_flash_s = timed(
        torch, lambda: forward(params, audio_flash, frames), 3)
    torch.cuda.reset_peak_memory_stats()
    dense_hidden, audio_s = timed(
        torch, lambda: forward(params, audio, frames), 3)
    audio_peak = torch.cuda.max_memory_allocated() / 1e9
    audio_rel = rel_diff(hidden, dense_hidden)
    check(audio_rel <= LM_BF16_REL,
          f"bf16 HuBERT flash forward vs dense: {audio_rel} > "
          f"{LM_BF16_REL}")
    audio_params = sum(t.numel() for t in _leaves(params))
    del params, hidden, dense_hidden, frames
    torch.cuda.empty_cache()
    return {"phase": "lm_frontends",
            "internvl2": {"arch": VLM_ARCH, "layers": cfg.num_layers,
                          "d_model": cfg.d_model,
                          "heads": [cfg.num_heads, cfg.num_kv_heads],
                          "head_dim": cfg.resolved_head_dim,
                          "param_count": cfg.param_count(),
                          "weights_gb_bf16": w_gb, "init_s": init_s,
                          "batch": b, "patches": cfg.num_patches,
                          "text_tokens": s, "positions": positions,
                          "flash_first_s": first_s[0], "flash_s": flash_s,
                          "flash_tokens_per_s": positions / min(flash_s),
                          "dense_s": dense_s,
                          "dense_tokens_per_s": positions / min(dense_s),
                          "flash_vs_dense_rel_bf16": vlm_rel,
                          "tolerance_rel_bf16": LM_BF16_REL,
                          "flash_launches":
                          launches["flash_attention_internvl2"],
                          "peak_memory_gb_flash": peak_gb},
            "hubert": {"arch": AUDIO_ARCH, "layers": audio.num_layers,
                       "d_model": audio.d_model,
                       "head_dim": audio.resolved_head_dim,
                       "causal": audio.causal, "params": audio_params,
                       "batch": ab, "frames": af,
                       "flash_first_s": first_flash_s[0],
                       "flash_forward_s": audio_flash_s,
                       "flash_frames_per_s": ab * af / min(audio_flash_s),
                       "flash_launches": launches["flash_attention_hubert"],
                       "peak_memory_gb_flash": audio_flash_peak,
                       "forward_s": audio_s,
                       "frames_per_s": ab * af / min(audio_s[1:]),
                       "peak_memory_gb": audio_peak,
                       "flash_vs_dense_rel_bf16": audio_rel,
                       "tolerance_rel_bf16": LM_BF16_REL},
            "timer": "host clock between synchronisations", "ok": True}


# -- phase 11: Mamba2 / SSD and the Zamba2 hybrid (slice 12) ------------------

MAMBA_ARCH = "mamba2_1_3b"
ZAMBA_ARCH = "zamba2_1_2b"
# a multiple of ssm_chunk 128: a (T, T) single-chunk fallback at 4096
# would hold 4.3 GB per sequence for each f32 (Q, Q, H) tensor
SSM_PREFILL = (2, 4096)                 # batch, tokens per sequence
# float32 at full width, card against host: two chunks of 128, and 200
# tokens (200 % 128 != 0: one chunk of 200)
SSM_TIGHT = dict(batch=1, tokens=(256, 200))
MAMBA_TIGHT_LAYERS = 2
ZAMBA_TIGHT_LAYERS = 6                  # one shared application (layer 5)
# the two configs' train step runs at full depth in their shape_train_4k
# cells, over 4096 tokens
SSM_TRAIN_CUT = ("no train steps here: the full-depth steps at 1 x 512 "
                 "tokens moved to the shape_train_4k phase at 1 x 4096")
# the record_function ranges of models/mamba2.py's mamba2_apply
MAMBA2_STAGES = ("mamba2/in_proj", "mamba2/conv", "mamba2/ssd",
                 "mamba2/out")


def ssm_tight(torch, dev, arch: str, layers: int) -> dict:
    """Full width, ``layers`` layers, float32 (TF32 off): the logits of
    the forward pass on the card against the host at every position, at
    two chunks and at the one-chunk fallback (the hybrid's shared block
    through the f32 flash kernel on the card, dense attention on the
    host); then ``decode_step`` on the card, fed the same tokens one at
    a time, against the card's forward pass at every position."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.lm import (decode_step, forward, init_cache,
                                       init_params, lm_head_weight)
    cfg = replace(get_config(arch), num_layers=layers,
                  compute_dtype="float32")
    card_cfg = replace(cfg, attention_impl="flash") \
        if cfg.family == "hybrid" else cfg
    gen = torch.Generator(device=dev).manual_seed(51)
    params = init_params(cfg, gen, dev)
    host = _copy_tree(params, "cpu")
    out = {"layers": layers, "batch": SSM_TIGHT["batch"],
           "attention_on_card": card_cfg.attention_impl,
           "tolerance_rel": LM_TIGHT_REL}
    full = tok = None
    for t in SSM_TIGHT["tokens"]:
        tok = torch.randint(0, cfg.vocab_size, (SSM_TIGHT["batch"], t),
                            generator=gen, device=dev)
        before = fa.LAUNCHES["flash_attention"]
        full = forward(params, card_cfg, {"tokens": tok}) \
            @ lm_head_weight(params, cfg)
        sync(torch, dev)
        flash = fa.LAUNCHES["flash_attention"] - before
        t0 = time.perf_counter()
        want = forward(host, cfg, {"tokens": tok.cpu()}) \
            @ lm_head_weight(host, cfg)
        host_s = time.perf_counter() - t0
        rel = rel_diff(full.cpu(), want)
        check(rel <= LM_TIGHT_REL, f"f32 {arch} at T={t} on the card vs "
              f"the host: {rel} > {LM_TIGHT_REL}")
        out[f"tokens_{t}"] = {"chunks": t // cfg.ssm_chunk
                              if t % cfg.ssm_chunk == 0 else 1,
                              "logits_rel": rel, "host_forward_s": host_s,
                              "flash_launches": flash}
    t = SSM_TIGHT["tokens"][-1]
    cache = init_cache(cfg, SSM_TIGHT["batch"], t, dev)
    rels = torch.empty(t, dtype=torch.float64, device=dev)
    for i in range(t):
        logits, cache = decode_step(params, cfg, cache, tok[:, i:i + 1], i)
        d = (logits[:, 0] - full[:, i]).double()
        rels[i] = d.abs().max() / full[:, i].double().abs().max()
    decode_rel = float(rels.max())
    check(decode_rel <= LM_TIGHT_REL,
          f"f32 {arch} decode vs forward: {decode_rel} > {LM_TIGHT_REL}")
    out["decode_vs_forward_rel_max"] = decode_rel
    out["decode_tokens"] = t
    out["measure"] = "max |a-b| / max |b| over the logits"
    return out


def mamba2_layer_profile(torch, params, cfg, x) -> dict:
    """One Mamba2 mixer (layer 0, cast to the compute dtype) on the
    hidden states ``x``: its device time by stage (``torch.profiler``)
    and its time with CUDA events."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.lm import _layer
    from repro_torch.models.mamba2 import mamba2_apply
    from repro_torch.tree import tree_map
    cd = dtype_of(cfg.compute_dtype)
    p = tree_map(lambda a: a.to(cd), _layer(params["layers"], 0)["mixer"])
    layer_ms = event_ms(torch, lambda: mamba2_apply(p, cfg, x), 3)
    prof = stage_profile(torch, lambda: mamba2_apply(p, cfg, x),
                         MAMBA2_STAGES)
    b, t, _ = x.shape
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = cfg.ssm_chunk if t % cfg.ssm_chunk == 0 else t
    # the SSD's four products: C·B (Q·Q·N), W·X (Q·Q·P), the chunk
    # states (Q·N·P) and C·S (Q·N·P), a (chunk, head)
    ssd_flops = 2 * b * t * h * (q * n + q * pd + 2 * n * pd)
    return {"tokens": b * t, "layer_ms_events": layer_ms, **prof,
            "ssd_flops": ssd_flops,
            "ssd_ops_bound_ms_f32": ssd_flops / PEAK_F32_OPS_PER_S * 1e3,
            "timer": "torch.profiler: device time of the kernels launched "
            "inside each record_function range, a call; layer_ms_events: "
            "CUDA events around the call"}


def ssm_prefill(torch, dev, cfg, seed: int):
    """bf16 weights at full depth and width, random from ``seed``, and
    a prefill batch of ``SSM_PREFILL``: (params, batch, init seconds,
    weights GB)."""
    from repro_torch.models.lm import init_params
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    b, s = SSM_PREFILL
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=dev)}
    return params, batch, init_s, weight_gb(params)


def phase_lm_mamba2(torch, dev) -> dict:
    """Mamba2-1.3B at its published config, full depth and width, bf16
    weights: a prefill of 2 x 4096 tokens (no kernel of the port: the
    SSD is torch ops), two prefills compared bit for bit, one mixer
    profiled by stage, BatchedDecoder at batch 4 and a decode profile;
    before it the f32 card-vs-host check at 2 layers (training runs in
    ``shape_train_4k_mamba2_1_3b``)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.lm import _embed_inputs
    from repro_torch.train.train_step import make_prefill_step

    tight = ssm_tight(torch, dev, MAMBA_ARCH, MAMBA_TIGHT_LAYERS)
    torch.cuda.empty_cache()
    cfg = replace(get_config(MAMBA_ARCH), param_dtype="bfloat16")
    check((cfg.family, cfg.num_layers, cfg.d_model, cfg.ssm_heads,
           cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk,
           cfg.tie_embeddings, cfg.vocab_size)
          == ("ssm", 48, 2048, 64, 64, 128, 128, True, 50280),
          f"not the published config: {cfg}")
    params, batch, init_s, w_gb = ssm_prefill(torch, dev, cfg, 53)
    b, s = SSM_PREFILL
    prefill = make_prefill_step(cfg)

    # the main path: one prefill (it launches no kernel of the port)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa)
    logits, first_s = timed(torch, lambda: prefill(params, batch), 1)
    check(fa.LAUNCHES["flash_attention"] == 0,
          "the Mamba2 prefill launched the flash kernel")
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "Mamba2 prefill logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    again, prefill_s = timed(torch, lambda: prefill(params, batch), 3)
    bit_equal = bool(torch.equal(again, logits))
    repeat_diff = float((again - logits).abs().max())
    layer = mamba2_layer_profile(torch, params, cfg,
                                 _embed_inputs(params, cfg, batch))
    server = serve_requests(torch, cfg, params, dev, seed=19)
    decode_profile = profile_decode(torch, params, cfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    del params, batch, logits, again
    torch.cuda.empty_cache()
    return {"phase": "lm_mamba2_1_3b", "arch": MAMBA_ARCH,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "ssm_heads": cfg.ssm_heads, "ssm_head_dim": cfg.ssm_head_dim,
            "ssm_state": cfg.ssm_state, "ssm_chunk": cfg.ssm_chunk,
            "vocab": cfg.vocab_size, "params_in_tree": n_params,
            "param_count": cfg.param_count(), "weights_gb_bf16": w_gb,
            "init_s": init_s, "tight_f32": tight,
            "prefill": {"batch": b, "tokens": b * s, "first_s": first_s[0],
                        "s": prefill_s,
                        "tokens_per_s": b * s / min(prefill_s),
                        "two_prefills_bit_equal": bit_equal,
                        "two_prefills_max_abs_diff": repeat_diff,
                        "peak_memory_gb": peak_gb,
                        "timer": "host clock between synchronisations"},
            "mixer_profile": layer, "server": server,
            "decode_profile": decode_profile, "reduced": [SSM_TRAIN_CUT],
            "ok": True}


def phase_lm_zamba2(torch, dev, launches: dict) -> dict:
    """Zamba2-1.2B at its published config, full depth and width, bf16
    weights: a flash prefill of 2 x 4096 tokens (its launches read: one
    a shared application, 6), the dense prefill as the yardstick,
    BatchedDecoder at batch 4 and a decode profile; before it the f32
    card-vs-host check at 6 layers (one shared application; training
    runs in ``shape_train_4k_zamba2_1_2b``)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.lm import (_embed_inputs, _shared_block,
                                       cast_params)
    from repro_torch.train.train_step import make_prefill_step

    tight = ssm_tight(torch, dev, ZAMBA_ARCH, ZAMBA_TIGHT_LAYERS)
    torch.cuda.empty_cache()
    cfg = replace(get_config(ZAMBA_ARCH), param_dtype="bfloat16")
    check((cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
           cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
           cfg.shared_attn_every, cfg.ssm_state, cfg.vocab_size)
          == ("hybrid", 38, 2048, 32, 32, 128, 8192, 6, 64, 32000),
          f"not the published config: {cfg}")
    apps = cfg.num_layers // cfg.shared_attn_every
    flash = replace(cfg, attention_impl="flash")
    params, batch, init_s, w_gb = ssm_prefill(torch, dev, cfg, 57)
    b, s = SSM_PREFILL
    prefill = make_prefill_step(flash)

    # the main path: one flash prefill, its launches read
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa)
    logits, first_s = timed(torch, lambda: prefill(params, batch), 1)
    launches["flash_attention_zamba2"] = fa.LAUNCHES["flash_attention"]
    check(launches["flash_attention_zamba2"] == apps,
          f"Zamba2 flash prefill launched {fa.LAUNCHES['flash_attention']} "
          f"times, not {apps}")
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "Zamba2 prefill logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    again, flash_s = timed(torch, lambda: prefill(params, batch), 2)
    bit_equal = bool(torch.equal(again, logits))
    dense_logits, dense_s = timed(
        torch, lambda: make_prefill_step(cfg)(params, batch), 2)
    check(bool(torch.isfinite(dense_logits).all()), "dense prefill logits")
    bf16_rel = rel_diff(logits, dense_logits)
    max_abs = float((logits - dense_logits).abs().max())
    check(bf16_rel <= LM_BF16_REL,
          f"bf16 Zamba2 flash prefill vs dense: {bf16_rel} > {LM_BF16_REL}")
    x = _embed_inputs(params, cfg, batch)
    layer = mamba2_layer_profile(torch, params, cfg, x)
    shared = cast_params(params["shared"], cfg)
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    before = dict(fa.LAUNCHES)
    shared_ms = event_ms(
        torch, lambda: _shared_block(shared, flash, x, x, positions), 3)
    fa.LAUNCHES.update(before)      # timing launches are not the path's
    del x, shared
    before = fa.LAUNCHES["flash_attention"]
    server = serve_requests(torch, cfg, params, dev, seed=23)
    decode_profile = profile_decode(torch, params, cfg, dev)
    check(fa.LAUNCHES["flash_attention"] == before,
          "Zamba2 decode launched the flash kernel")
    n_params = sum(t.numel() for t in _leaves(params))
    del params, batch, logits, again, dense_logits
    torch.cuda.empty_cache()
    return {"phase": "lm_zamba2_1_2b", "arch": ZAMBA_ARCH,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "shared_attn_every": cfg.shared_attn_every,
            "shared_applications": apps,
            "shared_heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "ssm_state": cfg.ssm_state, "vocab": cfg.vocab_size,
            "params_in_tree": n_params, "param_count": cfg.param_count(),
            "weights_gb_bf16": w_gb, "init_s": init_s, "tight_f32": tight,
            "prefill": {"batch": b, "tokens": b * s,
                        "flash_first_s": first_s[0], "flash_s": flash_s,
                        "flash_tokens_per_s": b * s / min(flash_s),
                        "dense_s": dense_s,
                        "dense_tokens_per_s": b * s / min(dense_s),
                        "two_prefills_bit_equal": bit_equal,
                        "flash_vs_dense_rel_bf16": bf16_rel,
                        "flash_vs_dense_max_abs_bf16": max_abs,
                        "tolerance_rel_bf16": LM_BF16_REL,
                        "peak_memory_gb_flash": peak_gb,
                        "flash_launches": launches["flash_attention_zamba2"],
                        "timer": "host clock between synchronisations"},
            "mixer_profile": layer,
            "shared_block_ms_events": shared_ms,
            "server": server, "decode_profile": decode_profile,
            "decode_launches_flash": 0, "reduced": [SSM_TRAIN_CUT],
            "ok": True}


# each kernel at the shape its path's main run gives it (phase 3 for the
# distance kernels, phase 4b's build above the fused closure's cap for
# the tiled min-plus kernel, phase 7's prefill for flash attention, one
# district of n = 102 400 for Floyd–Warshall), and the TPU kernel it
# replaces (the tiled, fused-closure and k-major kernels all replace
# minplus_pallas)
# -- phase 13: the JAX package's four LM input shapes (slice 17) --------------

# The cells of configs/base.py SHAPES (the JAX package's input shapes for
# the LM family, gated by shape_applicable) run on the card through the
# port's entry points at published widths and depths, each at the largest
# batch one card holds (a prefill within about 10 s a call): shape, arch,
# the batch run, the seed of the weights and inputs, and the float32
# card-vs-host check of the same path at a cut depth and the full length
# (``host_worker``: its host half runs in that worker process of
# HOST_WORKERS beside the LM phases, see start_host_checks; Zamba2's
# prefill check runs 2 layers, two Mamba2 mixers and no shared
# application: 6 layers would add the shared block's float32 attention
# at 32 768 tokens, the host arithmetic of Qwen3-4B's whole 1-layer
# check). A decode cell steps at pos = seq_len - 1
# over a cache of seq_len rows whose contents are seeded normal draws
# (fill_cache): the JAX package's decode cells lower against a cache of
# that shape whose contents are data, and filling it token by token
# through decode_step (as serving does) would take 32 767 eager steps, or
# 524 287.
# why a prefill cell runs fewer sequences than the card holds
TIME_CUT = "the script's time limit (the card holds more)"
SHAPE_CELLS = {
    "shape_prefill_32k_qwen3_4b": dict(
        shape="prefill_32k", arch=LM_ARCH, batch=8, seed=131,
        tight=dict(layers=1, batch=1, seed=132, host_worker="prefill"),
        launches="flash_attention_prefill_32k_qwen3_4b"),
    "shape_prefill_32k_zamba2_1_2b": dict(
        shape="prefill_32k", arch=ZAMBA_ARCH, batch=4, seed=133,
        tight=dict(layers=2, batch=1, seed=141, host_worker="prefill"),
        launches="flash_attention_prefill_32k_zamba2"),
    "shape_decode_32k_qwen3_4b": dict(
        shape="decode_32k", arch=LM_ARCH, batch=12, seed=134,
        tight=dict(layers=2, batch=1, seed=135)),
    "shape_long_500k_zamba2_1_2b": dict(
        shape="long_500k", arch=ZAMBA_ARCH, batch=1, seed=136,
        tight=dict(layers=6, batch=1, seed=137)),
    "shape_long_500k_mamba2_1_3b": dict(
        shape="long_500k", arch=MAMBA_ARCH, batch=1, seed=138,
        tight=dict(layers=2, batch=1, seed=139)),
    "shape_train_4k_qwen3_4b": dict(
        shape="train_4k", arch=LM_ARCH, batch=1, seed=140,
        train=dict(batch=1, tokens=4096, steps=3, peak_lr=1e-3),
        tight=dict(layers=1, batch=1, tokens=4096, vocab=None,
                   host_worker="train")),
    # the MoE, MLA and audio-encoder configs (PERF.md section 4 reckons
    # each batch and depth from bytes), the cells whose host half takes
    # longest last: ``layers`` where one card does not hold the published
    # depth; ``rows``: the float32 check holds row slices of the first
    # attention layer at the full key length (a whole host pass would
    # take minutes)
    "shape_prefill_32k_hubert_xlarge": dict(
        shape="prefill_32k", arch=AUDIO_ARCH, batch=8, seed=146,
        tight=dict(rows="flash", layers=1, batch=1, seed=147),
        launches="flash_attention_prefill_32k_hubert"),
    "shape_decode_32k_olmoe_1b_7b": dict(
        shape="decode_32k", arch=OLMOE_ARCH, batch=12, seed=148,
        tight=dict(layers=2, batch=2, seed=149)),
    "shape_decode_32k_deepseek_v2_236b": dict(
        shape="decode_32k", arch=DEEPSEEK_ARCH, batch=16,
        layers=DEEPSEEK_LAYERS, seed=150,
        tight=dict(layers=2, batch=1, seed=151)),
    "shape_train_4k_olmoe_1b_7b": dict(
        shape="train_4k", arch=OLMOE_ARCH, batch=1, layers=9, seed=152,
        train=dict(batch=1, tokens=4096, steps=3, peak_lr=1e-3),
        tight=dict(layers=1, batch=1, tokens=4096, vocab=None,
                   host_worker="train")),
    "shape_prefill_32k_olmoe_1b_7b": dict(
        shape="prefill_32k", arch=OLMOE_ARCH, batch=8, seed=142,
        tight=dict(layers=1, batch=1, seed=143, host_worker="moe"),
        launches="flash_attention_prefill_32k_olmoe"),
    "shape_prefill_32k_deepseek_v2_236b": dict(
        shape="prefill_32k", arch=DEEPSEEK_ARCH, batch=1,
        layers=DEEPSEEK_LAYERS, seed=144,
        tight=dict(rows="mla", batch=1, seed=145, host_worker="moe"),
        launches="flash_attention_prefill_32k_deepseek_v2"),
    # the SSM, hybrid and audio-encoder cells, and Nemotron-4-340B's
    # prefill through the bf16 hd-192 flash instance (PERF.md section 4
    # reckons each batch from bytes): Mamba2's prefill launches no kernel
    # of the port (its SSD is torch ops) and holds (B, 256, 128, 128, 64)
    # float32 temporaries a layer, 1.07 GB a sequence each; its decode
    # runs decode_32k's whole global batch (100 MB of state a sequence);
    # Zamba2's decode holds 3.26 GB of shared cache a sequence; the train
    # cells run full depth; Zamba2's check at 6 layers takes the shared
    # block under autograd (its host half the longest of these, in the
    # worker that frees first); Nemotron runs batch 1 (at 2 its 46.5 GB
    # of weights and two (S, 73 728) FFN intermediates a sequence ran out
    # of memory, 15.3 GB of it reserved but fragmented) and its check
    # holds row slices of its first attention layer at a cut vocabulary
    # (the embedding's rows are independent, and 256 000 rows would be
    # 37.7 GB in float32)
    "shape_prefill_32k_mamba2_1_3b": dict(
        shape="prefill_32k", arch=MAMBA_ARCH, batch=4, seed=153,
        tight=dict(layers=2, batch=1, seed=154, host_worker="prefill"),
        launches="flash_attention_prefill_32k_mamba2"),
    "shape_decode_32k_mamba2_1_3b": dict(
        shape="decode_32k", arch=MAMBA_ARCH, batch=128, seed=155,
        tight=dict(layers=2, batch=2, seed=156)),
    "shape_decode_32k_zamba2_1_2b": dict(
        shape="decode_32k", arch=ZAMBA_ARCH, batch=18, seed=157,
        tight=dict(layers=6, batch=2, seed=158)),
    "shape_train_4k_mamba2_1_3b": dict(
        shape="train_4k", arch=MAMBA_ARCH, batch=1, seed=159,
        train=dict(batch=1, tokens=4096, steps=3, peak_lr=1e-3),
        tight=dict(layers=1, batch=1, tokens=4096, vocab=None,
                   host_worker="train")),
    "shape_train_4k_zamba2_1_2b": dict(
        shape="train_4k", arch=ZAMBA_ARCH, batch=1, seed=160,
        train=dict(batch=1, tokens=4096, steps=3, peak_lr=1e-3),
        tight=dict(layers=6, batch=1, tokens=4096, vocab=None,
                   host_worker="prefill")),
    # peak lr 1e-4: at 1e-3 (the other cells') its loss rose, 6.75 ->
    # 6.91 -> 8.88 over three steps: Adam's first steps move every weight
    # by about lr, and random cluster labels on random frames give little
    # to descend
    "shape_train_4k_hubert_xlarge": dict(
        shape="train_4k", arch=AUDIO_ARCH, batch=4, seed=161,
        train=dict(batch=4, tokens=4096, steps=3, peak_lr=1e-4),
        tight=dict(layers=1, batch=1, tokens=4096, vocab=None,
                   host_worker="train")),
    "shape_prefill_32k_nemotron_4_340b": dict(
        shape="prefill_32k", arch="nemotron_4_340b", batch=1,
        layers=DENSE_LM["lm_nemotron_4_340b"]["layers"], seed=162,
        tight=dict(rows="flash", layers=1, batch=1, seed=163, vocab=32768),
        launches="flash_attention_prefill_32k_nemotron"),
    # InternVL2-26B (256 patch embeddings before the text: its prefill
    # attends over 33 024 positions, its train step over 4352 and scores
    # the 4096 text positions), StarCoder2-7B (GQA 36 / 4, a group of 9),
    # DeepSeek-67B (64 / 8) and Nemotron-4-340B's decode (hd 192), each
    # batch and depth reckoned from bytes in PERF.md section 4: a
    # prefill's batch is cut for the script's time; DeepSeek-67B runs
    # DEEPSEEK67B_LAYERS and Nemotron-4-340B its lm_* phase's 4; the train
    # cells run the depth whose 16 B of float32 state a parameter, with
    # the dense f32 scores' backward, one card holds. The prefill checks
    # hold row slices of the first attention layer (a whole host pass at
    # 32 768 tokens and these widths would take minutes); Nemotron's
    # decode check runs 1 layer at a cut vocabulary (2 layers and the
    # published 256 000 rows are 65 GB of float32 params, which the host
    # would hold beside the train checks' workers); DeepSeek-67B's and
    # InternVL2's train checks cut the vocabulary for their host halves'
    # time and memory (the embedding's rows are independent). The train
    # checks' host halves run last in their workers: StarCoder2's and
    # InternVL2's one after the other in "moe", DeepSeek-67B's in
    # "prefill", so that at most two of them hold the host's memory at
    # once; Mamba2-1.3B's train check runs in "train", which frees first,
    # so that InternVL2's is ready before its cell
    "shape_prefill_32k_internvl2_26b": dict(
        shape="prefill_32k", arch=VLM_ARCH, batch=2, seed=164,
        batch_cut=TIME_CUT,
        tight=dict(rows="flash", layers=1, batch=1, seed=165),
        launches="flash_attention_prefill_32k_internvl2"),
    "shape_prefill_32k_starcoder2_7b": dict(
        shape="prefill_32k", arch="starcoder2_7b", batch=2, seed=166,
        batch_cut=TIME_CUT,
        tight=dict(rows="flash", layers=1, batch=1, seed=167),
        launches="flash_attention_prefill_32k_starcoder2"),
    "shape_prefill_32k_deepseek_67b": dict(
        shape="prefill_32k", arch="deepseek_67b", batch=2,
        layers=DEEPSEEK67B_LAYERS, seed=168,
        batch_cut=TIME_CUT,
        tight=dict(rows="flash", layers=1, batch=1, seed=169),
        launches="flash_attention_prefill_32k_deepseek67b"),
    "shape_decode_32k_internvl2_26b": dict(
        shape="decode_32k", arch=VLM_ARCH, batch=5, seed=170,
        tight=dict(layers=2, batch=1, seed=171)),
    "shape_decode_32k_starcoder2_7b": dict(
        shape="decode_32k", arch="starcoder2_7b", batch=24, seed=172,
        tight=dict(layers=2, batch=1, seed=173)),
    "shape_decode_32k_deepseek_67b": dict(
        shape="decode_32k", arch="deepseek_67b", batch=11,
        layers=DEEPSEEK67B_LAYERS, seed=174,
        tight=dict(layers=2, batch=1, seed=175)),
    "shape_decode_32k_nemotron_4_340b": dict(
        shape="decode_32k", arch="nemotron_4_340b", batch=28,
        layers=DENSE_LM["lm_nemotron_4_340b"]["layers"], seed=176,
        tight=dict(layers=1, batch=1, seed=177, vocab=32768)),
    "shape_train_4k_starcoder2_7b": dict(
        shape="train_4k", arch="starcoder2_7b", batch=1, layers=15,
        seed=178, train=dict(batch=1, tokens=4096, steps=3, peak_lr=1e-3),
        tight=dict(layers=1, batch=1, tokens=4096, vocab=None,
                   host_worker="moe")),
    "shape_train_4k_deepseek_67b": dict(
        shape="train_4k", arch="deepseek_67b", batch=1, layers=2, seed=179,
        train=dict(batch=1, tokens=4096, steps=3, peak_lr=1e-3),
        tight=dict(layers=1, batch=1, tokens=4096, vocab=32768,
                   host_worker="prefill")),
    "shape_train_4k_internvl2_26b": dict(
        shape="train_4k", arch=VLM_ARCH, batch=1, layers=6, seed=180,
        train=dict(batch=1, tokens=4096, steps=3, peak_lr=1e-3),
        tight=dict(layers=1, batch=1, tokens=4096, vocab=32768,
                   host_worker="moe")),
}
# the SHAPES cells that applies to a config but one card cannot run at
# any depth: (arch, shape) -> why, in bytes. A train_4k cell holds 16 B
# of float32 state a parameter (the param, its gradient and AdamW's two
# moments) of the embedding and the head at least, and a whole layer
NOT_ON_ONE_CARD = {
    ("nemotron_4_340b", "train_4k"): (
        "the embedding and the head alone are 2 x 256 000 x 18 432 = 9.44 "
        "B parameters, 151 GB of float32 state; one layer (3.45 B "
        "parameters) 55.3 GB more; one card holds 80 GB"),
    ("deepseek_v2_236b", "train_4k"): (
        "the embedding and the head are 2 x 102 400 x 5120 = 1.05 B "
        "parameters, 16.8 GB of float32 state, and one MoE layer's 160 "
        "experts 3.77 B parameters, 60.4 GB: 77 GB before any activation "
        "on a card of 80 GB"),
}
# the worker processes of the cells' host halves and their threads: the
# jobs of one worker run one after another, in SHAPE_CELLS' order (the
# host's 8 cores also serve the NY-scale ingest check's two workers and
# the LM phases' launches); "roofline" probes every cell's path on fake
# tensors (path_probe: 0.2–14 s of host time a cell) ahead of it. Each
# result carries its worker's peak resident memory so far
# (host_max_rss_gb): the host has 96 GiB
HOST_WORKERS = {"prefill": 4, "train": 2, "moe": 2, "roofline": 1}
# the host halves of earlier phases' float32 train steps (LM_TRAIN_TIGHT),
# run in the "train" worker ahead of train_4k's: (phase, arch)
TRAIN_TIGHT_HOST = (("lm_train_qwen3_4b", LM_ARCH),
                    ("lm_starcoder2_7b", "starcoder2_7b"))
# timed decode steps after the main path's one
SHAPE_DECODE_STEPS = 5


def shape_config(spec: dict):
    """(published config, ShapeSpec) of a cell; the shape must apply."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, shape_applicable
    full, shape = get_config(spec["arch"]), SHAPES[spec["shape"]]
    ok, reason = shape_applicable(full, shape)
    check(ok, f"{spec['shape']} does not apply to {spec['arch']}: {reason}")
    return full, shape


def shape_out(name: str, spec: dict, full, shape, cfg, batch: int,
              reduced: list) -> dict:
    return {"phase": name, "shape": shape.name, "kind": shape.kind,
            "seq_len": shape.seq_len,
            "shape_global_batch": shape.global_batch, "arch": spec["arch"],
            "batch": batch, "layers": cfg.num_layers,
            "published_layers": full.num_layers, "d_model": cfg.d_model,
            "reduced": [f"batch {shape.global_batch} -> {batch}: "
                        + spec.get("batch_cut", "one card")]
            * (batch != shape.global_batch) + reduced}


@contextlib.contextmanager
def whole_large_blocks(torch):
    """While active, the caching allocator splits no cached block of 1 GiB
    or more (``max_split_size_mb``): a large request takes a cached block
    of its own size or a new one, and when the card is full the cached
    whole blocks are freed first; after it, the cache is emptied. A
    decode cell runs in it: otherwise a bf16 draw (``bf16_params``)
    splits the blocks its float32 transients leave (21.7 GB for one of
    Nemotron-4-340B's stacked FFN weights) to hold the bf16 weights drawn
    after them, and the holes left, together 22.6 GiB, were none large
    enough for a decode cache's 10.5 GiB of keys or values; and a step's
    own transients (MLA's expanded keys and values, 16 GiB each at
    DeepSeek-V2's batch 16) must not be split either, once the weights
    leave no holes for them."""
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("max_split_size_mb:1024")
    try:
        yield
    finally:
        # the default: no block is too large to split
        torch.cuda.memory._set_allocator_settings(
            "max_split_size_mb:2147483647")
        torch.cuda.empty_cache()


def bf16_params(torch, dev, cfg, seed: int):
    """The cell's weights in bf16, drawn in bf16 on the card from
    ``seed``: (params, the generator, init seconds, weights bytes)."""
    from dataclasses import replace

    from repro_torch.models.lm import init_params
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(replace(cfg, param_dtype="bfloat16"), gen, dev)
    sync(torch, dev)
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    return params, gen, time.perf_counter() - t0, w_bytes


# query rows a block of MLA attention holds on the fake tensors of a
# prefill's probe: at the card's 1 GiB budget 32 768 tokens run in 512 or
# 1024 blocks, and the probe counts each op of each block (minutes); in
# 1024-row blocks it counts the same work but for the keys past a causal
# block's diagonal, (1024 - the card's rows) / S of the scores (3 % at
# 32 768)
PROBE_MLA_ROWS = 1024


def path_probe(arch: str, layers: int | None, kind: str, b: int,
               s: int) -> dict:
    """``roofline_probe`` at a shape cell's path, an MLA prefill's probe
    in blocks of PROBE_MLA_ROWS query rows, and the probe's seconds (a
    worker of ``start_host_checks`` runs it ahead of the cell)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    t0 = time.perf_counter()
    budget, extra, cfg = attention.SCORE_BLOCK_BYTES, {}, get_config(arch)
    if cfg.use_mla and kind != "decode":
        extra = {"card_mla_block_rows": attention.score_block_rows(
            b, cfg.num_heads, s), "probe_mla_block_rows": PROBE_MLA_ROWS}
        attention.SCORE_BLOCK_BYTES = max(
            budget, 4 * b * cfg.num_heads * s * PROBE_MLA_ROWS)
    try:
        probed = roofline_probe(arch, layers, kind, b, s)
    finally:
        attention.SCORE_BLOCK_BYTES = budget
    return {**probed, **extra, "probe_s": time.perf_counter() - t0}


def path_roofline(torch, path: str, secs: float, pending: tuple) -> dict:
    """``launch/roofline.py`` at a cell's path, shape and depth on one
    card (the FLOPs at 989 TFLOP/s bf16 and the eager program's bytes,
    every aten op's inputs and outputs, at 3.35 TB/s; ``path_probe``,
    run by its worker, ``pending``) beside the measured seconds."""
    result, wait = wait_host_check(torch, pending)
    return {**roofline_row(path, result["probed"], secs),
            "probe_waited_s": wait["waited_s"]}


def _named_leaves(tree: dict, path: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def fill_cache(torch, cache: dict, seed: int, dev) -> None:
    """Every cache leaf, one layer (or shared application) at a time in
    the tree's order, filled with normal draws of a generator on the card
    seeded with ``seed``: keys and values, SSM states and conv windows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _, leaf in _named_leaves(cache):
        for i in range(leaf.shape[0]):
            leaf[i].normal_(generator=gen)


# the cache leaves a step writes one slot of: keys and values, MLA's
# latent and RoPE key
KV_LEAVES = ("k", "v", "latent", "k_rope")


def kv_slots_check(torch, cache: dict, seed: int, dev, pos: int) -> dict:
    """After one step at ``pos`` over a cache filled by ``fill_cache``:
    the draws made again, leaf by leaf, must equal every key and value
    (or latent and RoPE key) slot but ``pos`` bit for bit, and slot
    ``pos`` of each must differ from its draw (the step wrote it; what it
    wrote is held card vs host in float32 by ``decode_tight_long``); the
    SSM state and the conv windows are rewritten whole by a step and not
    compared."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    slots = 0
    for path, leaf in _named_leaves(cache):
        kind = path.rsplit("/", 1)[-1]
        for i in range(leaf.shape[0]):
            draw = torch.empty_like(leaf[i]).normal_(generator=gen)
            if kind not in KV_LEAVES:
                continue
            got = leaf[i]
            check(torch.equal(got[:, :pos], draw[:, :pos])
                  and torch.equal(got[:, pos + 1:], draw[:, pos + 1:]),
                  f"{path}[{i}]: a slot other than {pos} changed")
            check(not torch.equal(got[:, pos], draw[:, pos]),
                  f"{path}[{i}]: slot {pos} was not written")
            slots += 1
            del draw
    return {"kv_leaves_checked": slots, "written_slot": pos,
            "other_slots_unchanged": True, "written_slot_changed": True}


def prefill_tight_inputs(torch, arch: str, s: int, t: dict,
                         shared: dict | None = None):
    """The float32 prefill check's config (full width, ``t["layers"]``
    layers, flash attention), params and ``t["batch"]`` x ``s`` tokens,
    drawn on the host from ``t["seed"]`` (or ``shared``: the same params
    and tokens as a worker drew them, ``shared_inputs``): the same in
    every process."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params
    cfg = replace(get_config(arch), num_layers=t["layers"],
                  compute_dtype="float32", attention_impl="flash")
    if shared is not None:
        return cfg, shared["params"], shared["tokens"]
    gen = torch.Generator().manual_seed(t["seed"])
    params = init_params(cfg, gen, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (t["batch"], s), generator=gen)
    return cfg, params, tok


def share_inputs(torch, inputs: dict, out: str) -> None:
    """(Worker process.) A job's inputs, saved beside its result's file
    before the job runs, for ``shared_inputs``."""
    torch.save(inputs, out + ".inputs.part")
    os.replace(out + ".inputs.part", out + ".inputs")


def shared_inputs(torch, pending: tuple | None) -> dict | None:
    """The inputs the worker of ``pending`` drew for its job
    (``share_inputs``), mapped from their file, which is removed; None
    where the worker has not come to that job yet, and the caller draws
    the same inputs itself. Drawing float32 params of a layer and a
    vocabulary at full width on one host core takes 4–10 s."""
    if pending is None:
        return None
    path = Path(f"{pending[1]}.inputs")
    if not path.exists():
        return None
    inputs = torch.load(path, mmap=True)
    path.unlink()
    return inputs


def host_check_work(jobs: list, threads: int) -> None:
    """(Worker process.) The host halves of phases' float32 checks, one
    after another on ``threads`` threads, each job (kind, arch, s, t,
    out) saved to ``out`` with ``torch.save`` as it ends: for
    ``prefill_32k`` the last position's logits of
    ``prefill_tight_inputs`` through ``make_prefill_step`` (attention by
    the flash wrapper's plain version, in blocks of query rows), or for
    an MoE config the hidden states of every position through
    ``forward`` and the routing of each layer; for ``mla_rows`` the
    rows of ``mla_rows_inputs``' MLA output at ``slice_starts``; for
    ``train_4k`` and ``train`` the params and metrics after one step of
    ``train_tight_inputs``, its gradients (and an MoE config's routing);
    for ``roofline`` a cell's ``path_probe``; and its seconds and
    wall-clock end."""
    import resource
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch.models.lm import forward
    from repro_torch.train.data import to_device
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_prefill_step
    torch.set_num_threads(threads)
    for kind, arch, s, t, out in jobs:
        t0 = time.perf_counter()
        if kind == "prefill_32k":
            cfg, params, tok = prefill_tight_inputs(torch, arch, s, t)
            share_inputs(torch, {"params": params, "tokens": tok}, out)
            if cfg.num_experts:
                with routing_recorder(torch) as routing:
                    result = {"hidden": forward(params, cfg,
                                                {"tokens": tok})}
                result["routing"] = routing
            else:
                result = {"logits": make_prefill_step(cfg)(
                    params, {"tokens": tok})}
        elif kind == "mla_rows":
            result = {"rows": mla_rows_host(torch, arch, s, t)}
        elif kind == "roofline":
            result = {"probed": path_probe(arch, t["layers"], t["kind"],
                                           t["batch"], s)}
        else:
            _, params, batch, step = train_tight_inputs(torch, arch, t)
            share_inputs(torch, {"params": params}, out)  # before the step
            with routing_recorder(torch) as routing, \
                    step_gradients(torch) as grads:
                p, _, m = step(params, init_opt_state(params),
                               to_device(batch, "cpu"))
            result = {"params": p, "metrics": m, "routing": routing,
                      "grads": grads[0]}
        result["seconds"] = time.perf_counter() - t0
        result["done_at"] = time.time()
        result["max_rss_gb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6       # kB on Linux
        torch.save(result, out + ".part")
        os.replace(out + ".part", out)
        del result


def start_host_checks() -> dict:
    """Starts one ``host_check_work`` process for each of HOST_WORKERS,
    with the jobs that name it: TRAIN_TIGHT_HOST's, then the cells of
    SHAPE_CELLS whose float32 check does (minutes of host arithmetic at
    32 768 or 4096 tokens, run beside the LM phases), every cell's
    roofline probe (``<cell>_roofline``) and LAUNCH_PATHS' probes
    (``launch_roofline_<i>``); returns (worker, output file, threads,
    start) by phase."""
    import multiprocessing

    from repro_torch.configs.base import SHAPES
    GR_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(name, "train", "train", arch, LM_TRAIN_TIGHT["tokens"],
             LM_TRAIN_TIGHT) for name, arch in TRAIN_TIGHT_HOST]
    jobs += [(name, spec["tight"]["host_worker"],
              "mla_rows" if spec["tight"].get("rows") == "mla"
              else spec["shape"], spec["arch"],
              SHAPES[spec["shape"]].seq_len, spec["tight"])
             for name, spec in SHAPE_CELLS.items()
             if spec["tight"].get("host_worker")]
    jobs += [(f"{name}_roofline", "roofline", "roofline", spec["arch"],
              SHAPES[spec["shape"]].seq_len,
              dict(layers=spec.get("layers"), kind=SHAPES[spec["shape"]].kind,
                   batch=spec["batch"]))
             for name, spec in SHAPE_CELLS.items()]
    jobs += [(f"launch_roofline_{i}", "roofline", "roofline", arch, s,
              dict(layers=layers, kind=kind, batch=b))
             for i, (_, arch, layers, (kind, b, s))
             in enumerate(LAUNCH_PATHS)]
    pending = {}
    for worker_name, threads in HOST_WORKERS.items():
        mine = [job for job in jobs if job[1] == worker_name]
        outs = {job[0]: GR_DIR / f"{job[0]}_host.pt" for job in mine}
        for out in outs.values():
            out.unlink(missing_ok=True)
            Path(f"{out}.inputs").unlink(missing_ok=True)
        worker = multiprocessing.get_context("spawn").Process(
            target=host_check_work, daemon=True,
            args=([(kind, arch, s, t, str(outs[name]))
                   for name, _, kind, arch, s, t in mine], threads))
        worker.start()
        for name in outs:
            pending[name] = (worker, outs[name], threads, time.time())
    return pending


def wait_host_check(torch, pending: tuple) -> tuple[dict, dict]:
    """Waits for one cell's result from its ``start_host_checks`` worker;
    the result, and the seconds waited, the worker's threads and the
    seconds from the worker's start to the result."""
    worker, out, threads, started = pending
    t0 = time.perf_counter()
    while not out.exists() and worker.is_alive() \
            and time.perf_counter() - t0 < HOST_CHECK_TIMEOUT_S:
        time.sleep(0.2)
    waited_s = time.perf_counter() - t0
    check(out.exists(), f"no host result {out.name}: the worker ended with "
          f"{worker.exitcode} (None: still running after "
          f"{HOST_CHECK_TIMEOUT_S} s)")
    # mapped, not read: a train step's gradients are read only where a
    # leaf is held stage by stage
    result = torch.load(out, mmap=True)
    out.unlink()
    # the job's inputs, where the caller drew its own (shared_inputs)
    Path(f"{out}.inputs").unlink(missing_ok=True)
    return result, {"host_threads": threads, "waited_s": waited_s,
                    "host_ready_after_s": result["done_at"] - started,
                    "host_max_rss_gb": result.get("max_rss_gb")}


def attention_applications(cfg) -> int:
    """Flash launches of one prefill: one a layer, or one a hybrid's
    shared application; none where MLA attends or no layer attends
    (``ssm``)."""
    if cfg.use_mla or cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers


@contextlib.contextmanager
def last_sequence_of_first_flash(torch):
    """While active, the first call of the flash wrapper keeps copies of
    its last sequence (batch index B - 1): q, k, v and the output,
    filled into ``kept`` after that call."""
    from repro_torch.kernels.flash_attention import ops
    real = ops.flash_attention
    kept = {}

    def keeping(q, k, v, **kw):
        out = real(q, k, v, **kw)
        if not kept:
            kept.update(q=q[-1:].clone(), k=k[-1:].clone(),
                        v=v[-1:].clone(), out=out[-1:].clone(),
                        batch=q.shape[0], causal=kw.get("causal", True))
        return out

    ops.flash_attention = keeping
    try:
        yield kept
    finally:
        ops.flash_attention = real


def prefill_tight_long(torch, dev, arch: str, s: int, t: dict,
                       pending: tuple) -> dict:
    """float32, full width, ``t["layers"]`` layers, ``t["batch"]``
    sequences of ``s`` tokens through ``make_prefill_step`` with flash
    attention (the SSD and the conv too, in a hybrid's Mamba2 layers):
    on the card through the float32 kernel, on the host
    (``pending``: the worker of ``host_check_work`` and its output)
    through its plain version; the last position's logits card vs
    host."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.lm import forward
    from repro_torch.train.train_step import make_prefill_step
    shared = shared_inputs(torch, pending)
    cfg, host, tok = prefill_tight_inputs(torch, arch, s, t, shared)
    params = _copy_tree(host, dev)
    del host
    step = make_prefill_step(cfg)
    batch = {"tokens": tok.to(dev)}
    before = fa.LAUNCHES["flash_attention"]
    with routing_recorder(torch) as routing:
        got, card_s = timed(torch, lambda: forward(params, cfg, batch)
                            if cfg.num_experts else step(params, batch), 1)
    launched = fa.LAUNCHES["flash_attention"] - before
    fa.LAUNCHES["flash_attention"] = before     # a check, not the path
    check(launched == attention_applications(cfg), f"f32 {arch} prefill at "
          f"{s}: {launched} flash launches")
    result, wait = wait_host_check(torch, pending)
    host_s = result["seconds"]
    if cfg.num_experts:
        # each position's hidden state where the card and the host routed
        # the token alike (the layer's capacity decisions included)
        check(t["layers"] == 1, "an MoE check compares per token at 1 layer")
        agree, differ = routing_agreement(routing, result["routing"])
        agree = agree.cpu()
        check(bool(agree.any()), f"f32 {arch}: no token routed alike")
        d = got.shape[-1]
        rel = rel_diff(got.reshape(-1, d).cpu()[agree],
                       result["hidden"].reshape(-1, d)[agree])
        compared = {"hidden_rel": rel, "assignments": agree.numel()
                    * cfg.experts_per_token,
                    "assignments_routed_differently": differ,
                    "positions_compared": int(agree.sum()),
                    "measure": "max |a-b| / max |b| over the final hidden "
                    "states of every position the card and the host "
                    "routed alike (expert ids and capacity kept); the "
                    "card attends through the f32 flash kernel, the host "
                    "(a worker process) through its plain version in "
                    "blocks of query rows"}
    else:
        rel = rel_diff(got.cpu(), result["logits"])
        compared = {"last_logits_rel": rel,
                    "measure": "max |a-b| / max |b| over the last "
                    "position's logits; the card attends through the f32 "
                    "flash kernel, the host (a worker process beside the "
                    "LM phases) through its plain version in blocks of "
                    "query rows"}
    check(rel <= LM_TIGHT_REL, f"f32 {arch} prefill at {s} tokens, card vs "
          f"host: {rel} > {LM_TIGHT_REL}")
    del params
    return {"layers": t["layers"], "batch": t["batch"], "tokens": s,
            "flash_launches": launched, "rel": rel,
            "tolerance_rel": LM_TIGHT_REL, "inputs_from_worker": bool(shared),
            "card_s": card_s[0], "host_s": host_s, **wait, **compared}


def mla_rows_inputs(torch, arch: str, s: int, t: dict):
    """The float32 MLA check's config (full width), the attention params
    of one layer and ``t["batch"]`` x ``s`` hidden states of unit
    variance, drawn on the host from ``t["seed"]``: the same in every
    process."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.attention import mla_init
    cfg = replace(get_config(arch), num_layers=1, compute_dtype="float32")
    gen = torch.Generator().manual_seed(t["seed"])
    p = mla_init(gen, cfg, torch.float32, torch.device("cpu"))
    x = torch.randn((t["batch"], s, cfg.d_model), generator=gen)
    return cfg, p, x


def mla_rows_host(torch, arch: str, s: int, t: dict) -> list:
    """(Worker process.) The rows of ``slice_starts(s)`` of ``mla_apply``
    on ``mla_rows_inputs``, causal, each from those rows' queries against
    every key they see: the keys and values expanded from the latent
    once, then ``mla_attend_rows`` at the rows' offset (a whole pass
    would be 88 TFLOP a sequence)."""
    from repro_torch.models import attention
    cfg, p, x = mla_rows_inputs(torch, arch, s, t)
    b, h, r = x.shape[0], cfg.num_heads, FLASH_SLICE_ROWS
    pos = torch.arange(s)[None].expand(b, s)
    latent, k_rope = attention._mla_kv(p, cfg, x, pos)
    k_nope = (latent @ p["wk_b"]).reshape(b, s, h, cfg.qk_nope_head_dim)
    v = (latent @ p["wv_b"]).reshape(b, s, h, cfg.v_head_dim)
    out = []
    for r0 in slice_starts(s):
        qn, qr = attention._mla_q(p, cfg, x[:, r0:r0 + r], pos[:, r0:r0 + r])
        rows = attention.mla_attend_rows(
            cfg, qn, qr, k_nope, k_rope, v, True, r0,
            attention.score_block_rows(b, h, s))
        out.append(rows.reshape(b, r, -1) @ p["wo"])
    return out


def mla_rows_check(torch, dev, arch: str, s: int, t: dict,
                   pending: tuple) -> dict:
    """float32, full width: one layer's ``mla_apply`` over ``t["batch"]``
    x ``s`` tokens on the card (its query rows in blocks), and on the
    host (``pending``: the worker of ``host_check_work``) the first, a
    middle and the last FLASH_SLICE_ROWS rows at the full key length;
    those rows card vs host."""
    from repro_torch.models.attention import mla_apply, score_block_rows
    cfg, p, x = mla_rows_inputs(torch, arch, s, t)
    p, x = _copy_tree(p, dev), x.to(dev)
    pos = torch.arange(s, device=dev)[None].expand(x.shape[0], s)
    torch.cuda.reset_peak_memory_stats()
    got, card_s = timed(torch, lambda: mla_apply(p, cfg, x, pos), 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    r = FLASH_SLICE_ROWS
    got = [got[:, r0:r0 + r].cpu() for r0 in slice_starts(s)]
    del p, x
    result, wait = wait_host_check(torch, pending)
    rels = [rel_diff(a, b) for a, b in zip(got, result["rows"])]
    rel = max(rels)
    check(rel <= LM_TIGHT_REL, f"f32 {arch} MLA rows at {s} tokens, card vs "
          f"host: {rels} > {LM_TIGHT_REL}")
    return {"layers": 1, "batch": t["batch"], "tokens": s,
            "slice_rows": r, "slice_starts": list(slice_starts(s)),
            "rel_by_slice": rels, "rel": rel, "tolerance_rel": LM_TIGHT_REL,
            "block_rows_on_card": score_block_rows(t["batch"],
                                                   cfg.num_heads, s),
            "card_peak_memory_gb": peak_gb, "card_s": card_s[0],
            "host_s": result["seconds"], **wait,
            "measure": "max |a-b| / max |b| over each slice of one "
            "layer's MLA output (after wo), causal; inputs of unit "
            "variance and the layer's weights drawn on the host from the "
            "seed; the host's rows in a worker process"}


def flash_rows_check(torch, dev, arch: str, s: int, t: dict, rows_pool):
    """float32, full width, ``t["layers"]`` layer(s) (and ``t["vocab"]``,
    where given): one prefill of ``t["batch"]`` x ``s`` frames (or
    tokens) through ``make_prefill_step`` on the card, weights and inputs
    drawn there from ``t["seed"]``, the first attention layer through the
    float32 flash kernel; that launch's output held against the plain
    version on the host on the rows of ``slice_starts`` at the full key
    length (a whole host pass of the layer would take minutes). The host
    computes its rows on ``rows_pool``, an executor of one thread that
    runs the checks' rows one after another (at once, their threads
    starved the main path's launches); returns ``finish()``, which waits
    for them (the caller runs the main path on the card meanwhile) and
    compares."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.models.lm import init_params
    from repro_torch.train.train_step import make_prefill_step
    cfg = replace(get_config(arch), num_layers=t["layers"],
                  compute_dtype="float32", attention_impl="flash",
                  **({"vocab_size": t["vocab"]} if t.get("vocab") else {}))
    gen = torch.Generator(device=dev).manual_seed(t["seed"])
    params = init_params(cfg, gen, dev)
    batch = lm_inputs(torch, cfg, t["batch"], s, gen, dev)
    before = fa.LAUNCHES["flash_attention"]
    with last_sequence_of_first_flash(torch) as kept:
        logits, card_s = timed(
            torch, lambda: make_prefill_step(cfg)(params, batch), 1)
    launched = fa.LAUNCHES["flash_attention"] - before
    fa.LAUNCHES["flash_attention"] = before     # a check, not the path
    check(launched == attention_applications(cfg)
          and bool(torch.isfinite(logits).all()), f"f32 {arch} prefill at "
          f"{s}: {launched} flash launches")
    del params, batch, logits
    n = kept["q"].shape[1]                      # + the patches, if any
    check(n == prefill_positions(cfg, s), f"f32 {arch}: the first flash "
          f"call attended over {n} positions")
    r, starts, causal = FLASH_SLICE_ROWS, slice_starts(n), kept["causal"]
    k, v = kept["k"].cpu(), kept["v"].cpu()
    qs = [kept["q"][:, r0:r0 + r].cpu() for r0 in starts]
    got = [kept["out"][:, r0:r0 + r].cpu() for r0 in starts]
    kept.clear()
    host = {}

    def host_rows():
        t0 = time.perf_counter()
        host["rows"] = [ref.attention_rows_ref(q, k, v, r0, causal=causal)
                        for q, r0 in zip(qs, starts)]
        host["s"] = time.perf_counter() - t0

    rows = rows_pool.submit(host_rows)

    def finish() -> dict:
        t0 = time.perf_counter()
        rows.result(HOST_CHECK_TIMEOUT_S)
        waited_s = time.perf_counter() - t0
        rels = [rel_diff(a, b) for a, b in zip(got, host["rows"])]
        errs = [max_abs_err(a, b) for a, b in zip(got, host["rows"])]
        rel = max(rels)
        check(rel <= LM_TIGHT_REL, f"f32 {arch} first attention layer at "
              f"{s}, card vs host: {rels} > {LM_TIGHT_REL}")
        return {"layers": t["layers"], "batch": t["batch"], "tokens": s,
                "positions": n, "vocab": cfg.vocab_size,
                "flash_launches": launched,
                "causal": causal, "slice_rows": r,
                "slice_starts": list(starts), "rel_by_slice": rels,
                "max_abs_err": max(errs), "rel": rel,
                "tolerance_rel": LM_TIGHT_REL, "card_s": card_s[0],
                "host_s": host["s"], "waited_s": waited_s,
                "measure": "max |a-b| / max |b| over each slice of the "
                "first attention layer's output: the card's float32 flash "
                "kernel against the plain version on the host (a thread "
                "beside the main path), from the card's own q, k, v of "
                "that layer"}
    return finish


def lm_inputs(torch, cfg, b: int, s: int, gen, dev) -> dict:
    """A prefill's batch drawn from ``gen``: ``b`` x ``s`` frames of unit
    variance for the ``frame`` frontend (HuBERT), else tokens, and for
    the ``patch`` frontend (InternVL2) then ``b`` x ``num_patches``
    patch embeddings of unit variance in float32, the inputs the JAX
    package's ``launch/specs.py`` ``batch_specs`` gives a VLM cell."""
    if cfg.frontend == "frame":
        return {"frames": torch.randn((b, s, cfg.d_model), generator=gen,
                                      device=gen.device).to(dev)}
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                   device=gen.device).to(dev)}
    if cfg.frontend == "patch":
        out["patches"] = torch.randn((b, cfg.num_patches, cfg.d_model),
                                     generator=gen, device=gen.device,
                                     dtype=torch.float32).to(dev)
    return out


def prefill_positions(cfg, s: int) -> int:
    """Positions a prefill of ``s`` tokens attends over: the patches
    before the text for the ``patch`` frontend."""
    return s + (cfg.num_patches if cfg.frontend == "patch" else 0)


def decode_tight_long(torch, dev, arch: str, max_len: int, t: dict) -> dict:
    """float32, full width, ``t["layers"]`` layers (and ``t["vocab"]``,
    where given): one ``decode_step`` at pos = max_len - 1 over a cache
    of ``max_len`` rows filled by ``fill_cache``, on the card and on the
    host from the same params, cache and token; the logits and every
    written cache entry (the slot's keys and values, the SSM states and
    conv windows) card vs host."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.lm import decode_step, init_cache, init_params
    cfg = replace(get_config(arch), num_layers=t["layers"],
                  compute_dtype="float32",
                  **({"vocab_size": t["vocab"]} if t.get("vocab") else {}))
    gen = torch.Generator(device=dev).manual_seed(t["seed"])
    params = init_params(cfg, gen, dev)
    host = _copy_tree(params, "cpu")
    cache = init_cache(cfg, t["batch"], max_len, dev)
    fill_cache(torch, cache, t["seed"] + 1, dev)
    t0 = time.perf_counter()
    host_cache = _copy_tree(cache, "cpu")
    copy_s = time.perf_counter() - t0
    cache_gb = sum(x.numel() * x.element_size()
                   for x in _leaves(cache)) / 1e9
    tok = torch.randint(0, cfg.vocab_size, (t["batch"], 1), generator=gen,
                        device=dev)
    pos = max_len - 1
    with routing_recorder(torch) as on_card:
        got, card_s = timed(torch, lambda: decode_step(params, cfg, cache,
                                                       tok, pos)[0], 1)
    t0 = time.perf_counter()
    with routing_recorder(torch) as on_host:
        want, _ = decode_step(host, cfg, host_cache, tok.cpu(), pos)
    host_s = time.perf_counter() - t0
    # an MoE config: the sequences whose token the card and the host
    # routed alike in every layer (decode is dropless, so one sequence's
    # routing cannot move another's)
    rows, differ = slice(None), 0
    if on_card:
        agree, differ = routing_agreement(on_card, on_host)
        rows = agree.cpu()
        check(bool(rows.any()), f"f32 {arch} decode: no token routed alike")
    rel = rel_diff(got.cpu()[rows], want[rows])
    entries = {}
    for (path, a), (_, b) in zip(_named_leaves(cache),
                                 _named_leaves(host_cache)):
        written = (a[:, :, pos], b[:, :, pos]) \
            if path.rsplit("/", 1)[-1] in KV_LEAVES else (a, b)
        entries[path] = rel_diff(written[0].cpu()[:, rows],
                                 written[1][:, rows])
    worst = max([rel, *entries.values()])
    check(worst <= LM_TIGHT_REL, f"f32 {arch} decode at pos {pos}, card vs "
          f"host: logits {rel}, cache {entries} > {LM_TIGHT_REL}")
    del params, host, cache, host_cache
    return {"layers": t["layers"], "batch": t["batch"], "cache_rows": max_len,
            "vocab": cfg.vocab_size, "pos": pos, "cache_gb_f32": cache_gb,
            "logits_rel": rel,
            "written_cache_rel": entries, "tolerance_rel": LM_TIGHT_REL,
            **({"assignments": t["batch"] * cfg.experts_per_token
                * len(on_card), "assignments_routed_differently": differ,
                "sequences_compared": int(rows.sum())} if on_card else {}),
            "card_s": card_s[0], "host_s": host_s, "cache_to_host_s": copy_s,
            "measure": "max |a-b| / max |b|: logits, the written slot of "
            "each key and value (or MLA latent and RoPE key) cache, each "
            "SSM state and conv window; an MoE config's over the sequences "
            "routed alike"}


def phase_shape_prefill(torch, dev, launches: dict, name: str,
                        pending: dict, errs: dict, finish=None) -> dict:
    """SHAPES["prefill_32k"] on ``SHAPE_CELLS[name]``'s config at full
    depth (or the cell's ``layers``), bf16: before it the float32
    card-vs-host check at a cut depth and the full length (a
    ``rows="flash"`` check ran before the cells: ``finish`` waits for its
    host rows and compares); the main
    path, one flash prefill through ``make_prefill_step`` (its flash
    launches read: one a layer, one a shared application, none where MLA
    attends) with finite last-position logits, timed and
    profiled in one call (device ms, idle share; the copies
    ``last_sequence_of_first_flash`` keeps, 0.7 or 1.1 GB, inside it)
    and its peak memory read; that first launch's last sequence held
    against the plain version on row slices (``flash_slices_check``:
    the batch and grid arithmetic at the path's own batch; an MLA config
    launches none); the roofline of the path; the seconds of each
    step."""
    from dataclasses import replace

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.train.train_step import make_prefill_step
    spec = SHAPE_CELLS[name]
    full, shape = shape_config(spec)
    s, b = shape.seq_len, spec["batch"]
    steps_s = {}
    t0 = time.perf_counter()
    rows = spec["tight"].get("rows")
    if rows == "mla":
        tight = mla_rows_check(torch, dev, spec["arch"], s, spec["tight"],
                               pending[name])
    elif rows == "flash":
        tight = finish
    else:
        tight = prefill_tight_long(torch, dev, spec["arch"], s,
                                   spec["tight"], pending[name])
    torch.cuda.empty_cache()
    steps_s["tight_f32"] = time.perf_counter() - t0
    cfg = replace(full, attention_impl="flash",
                  num_layers=spec.get("layers", full.num_layers))
    params, gen, init_s, w_bytes = bf16_params(torch, dev, cfg, spec["seed"])
    batch = lm_inputs(torch, cfg, b, s, gen, dev)
    prefill = make_prefill_step(cfg)
    apps = attention_applications(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa)
    out = {}
    t0 = time.perf_counter()
    with last_sequence_of_first_flash(torch) as kept:
        prof = device_profile(
            torch, lambda: out.update(logits=prefill(params, batch)), 1)
    steps_s["main_path_profiled"] = time.perf_counter() - t0
    logits, secs = out.pop("logits"), prof["host_ms_per_call_profiled"] / 1e3
    key = spec["launches"]
    launches[key] = fa.LAUNCHES["flash_attention"]
    check(launches[key] == apps,
          f"{name}: {launches[key]} flash launches, not {apps}")
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{name} logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    held = None
    if apps:
        # the main path's own first launch, at its batch, against the
        # plain version on the row slices of its last sequence
        check(kept.get("batch") == b
              and kept["q"].shape[1] == prefill_positions(cfg, s),
              f"{name}: the first flash call had batch {kept.get('batch')} "
              f"and {kept['q'].shape[1]} positions, not {b} and "
              f"{prefill_positions(cfg, s)}")
        t0 = time.perf_counter()
        held = flash_slices_check(torch, kept["out"], kept["q"], kept["k"],
                                  kept["v"], kept["causal"])
        check(held["bound_ratio"] <= 1.0, f"{name}: the first flash "
              f"launch's last sequence is beyond the bf16 bound ({held})")
        errs["flash_attention"] = max(errs["flash_attention"],
                                      held["max_abs_err"])
        held["sequence"] = b - 1
        steps_s["flash_slices"] = time.perf_counter() - t0
    del kept, params, batch, logits
    torch.cuda.empty_cache()
    if rows == "flash":
        t0 = time.perf_counter()
        tight = tight()
        steps_s["tight_f32_host_rows_wait"] = time.perf_counter() - t0
    reduced = [f"layers {full.num_layers} -> {cfg.num_layers}: one card"] \
        * (cfg.num_layers != full.num_layers)
    reduced.append(
        f"f32 card-vs-host check at {tight['layers']} of {full.num_layers} "
        f"layers, batch {tight['batch']}, the full {s} tokens"
        + (f" ({tight['flash_launches']} flash launches)"
           if "flash_launches" in tight else "")
        + (f", on rows {tight['slice_starts']} + {tight['slice_rows']} of "
           f"its first attention layer" if rows else "")
        + (f", vocabulary {tight['vocab']} of {full.vocab_size}"
           if tight.get("vocab", full.vocab_size) != full.vocab_size
           else ""))
    t0 = time.perf_counter()
    roofline = path_roofline(torch, f"{spec['arch']} prefill", secs,
                             pending[f"{name}_roofline"])
    steps_s["roofline"] = time.perf_counter() - t0
    return {**shape_out(name, spec, full, shape, cfg, b, reduced),
            "weights_gb_bf16": w_bytes / 1e9, "init_s": init_s,
            "tight_f32": tight, "first_flash_last_sequence": held,
            "prefill_s": secs,
            "tokens": b * s, "tokens_per_s": b * s / secs,
            "positions": b * prefill_positions(cfg, s),
            "positions_per_s": b * prefill_positions(cfg, s) / secs,
            "flash_launches": launches[key],
            "max_memory_allocated_gb": peak_gb, "profile": prof,
            "roofline": roofline, "steps_s": steps_s,
            "timer": "prefill_s: host clock between synchronisations of "
            "the main path's one call (the first at the shape), which runs "
            "under torch.profiler (profile); tokens_per_s counts text "
            "tokens, positions_per_s the patches before them too",
            "ok": True}


def phase_shape_decode(torch, dev, name: str, pending: dict) -> dict:
    """SHAPES["decode_32k"] or ["long_500k"] on ``SHAPE_CELLS[name]``'s
    config at full depth (or the cell's ``layers``), bf16: before it the
    float32 card-vs-host step at a cut depth and the full cache length;
    the cache of ``seq_len`` rows at the cell's batch from
    ``init_cache``, filled by ``fill_cache``; the main path, one
    ``decode_step`` at pos = seq_len - 1 (finite logits; the written slot
    changed and every other slot is unchanged), then timed steps, a
    profile (device ms, idle share, the copy kernels), the least bytes
    a step must move and the operations it does (an MoE config's experts
    as this step routed its tokens), and the roofline of the eager
    program."""
    from dataclasses import replace

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.lm import decode_step, init_cache
    spec = SHAPE_CELLS[name]
    full, shape = shape_config(spec)
    t_len, b = shape.seq_len, spec["batch"]
    steps_s = {}
    t0 = time.perf_counter()
    tight = decode_tight_long(torch, dev, spec["arch"], t_len, spec["tight"])
    torch.cuda.empty_cache()
    steps_s["tight_f32"] = time.perf_counter() - t0
    cfg = replace(full, num_layers=spec.get("layers", full.num_layers))
    params, gen, init_s, w_bytes = bf16_params(torch, dev, cfg, spec["seed"])
    t0 = time.perf_counter()
    cache = init_cache(cfg, b, t_len, dev)
    sync(torch, dev)
    steps_s["cache_alloc"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fill_cache(torch, cache, spec["seed"] + 1, dev)
    sync(torch, dev)
    fill_s = time.perf_counter() - t0
    cache_bytes = sum(x.numel() * x.element_size() for x in _leaves(cache))
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device=dev)
    pos = t_len - 1
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    before = fa.LAUNCHES["flash_attention"]
    logits, first = timed(
        torch, lambda: decode_step(params, cfg, cache, tok, pos)[0], 1)
    check(fa.LAUNCHES["flash_attention"] == before,
          f"{name}: decode launched the flash kernel")
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{name} logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    slots = kv_slots_check(torch, cache, spec["seed"] + 1, dev, pos) \
        if cfg.family != "ssm" else \
        {"kv_leaves_checked": 0, "note": "no attention cache (SSM)"}
    steps_s["slots_check"] = time.perf_counter() - t0
    _, step_s = timed(torch, lambda: decode_step(params, cfg, cache, tok,
                                                 pos), SHAPE_DECODE_STEPS)
    t0 = time.perf_counter()
    prof = device_profile(
        torch, lambda: decode_step(params, cfg, cache, tok, pos), 3)
    steps_s["profiled"] = time.perf_counter() - t0
    # one more step at the same pos and token (the same routing; the slot
    # written again with the same values) records which experts it runs
    with routing_recorder(torch) as routing:
        decode_step(params, cfg, cache, tok, pos)
    # the least a step moves: every weight it reads once (the embedding
    # table is a gather of b rows unless the head reads it whole; of an
    # MoE layer's routed experts those its tokens chose), the cache read
    # once (SSM states also written), one slot of keys and values written
    embed = params["embed"]
    gathered = 0 if cfg.tie_embeddings \
        else embed.numel() * embed.element_size() * (1 - b / embed.shape[0])
    state = sum(x.numel() * x.element_size()
                for path, x in _named_leaves(cache) if path.endswith("ssm"))
    unrouted = experts_routed = 0
    if routing:
        moe = params["layers"]["moe"]
        expert_bytes = sum(moe[w][0, 0].numel() * moe[w].element_size()
                           for w in ("wi", "wg", "wo"))
        experts_routed = sum(int(torch.unique(c["ids"]).numel())
                             for c in routing)
        unrouted = (len(routing) * cfg.num_experts - experts_routed) \
            * expert_bytes
    least_bytes = w_bytes - gathered - unrouted + cache_bytes + state
    weights_read = (w_bytes - gathered - unrouted) / 2      # bf16 elements
    if cfg.use_mla:
        # the port expands the latent into each head's keys and values
        # every step (the absorbed form, which folds wk_b and wv_b into
        # the query and the output, is not in the JAX package), then
        # attends: per layer and sequence
        r, h = cfg.kv_lora_rank, cfg.num_heads
        dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        attn_flops = cfg.num_layers * b * (
            2 * t_len * r * h * (dn + dv) + 2 * h * t_len * (dn + dr + dv))
    else:
        attn = (cfg.num_layers // cfg.shared_attn_every
                if cfg.family == "hybrid"
                else 0 if cfg.family == "ssm" else cfg.num_layers)
        attn_flops = 4 * b * cfg.num_heads * t_len \
            * cfg.resolved_head_dim * attn
    # a routed expert's weights serve only the tokens routed to it: 2
    # FLOPs an element an assignment, not 2 a token
    flops = 2 * weights_read * b + attn_flops
    if routing:
        per_expert = expert_bytes / 2
        flops -= 2 * b * experts_routed * per_expert
        flops += 2 * per_expert * sum(c["ids"].numel() for c in routing)
    bytes_ms = least_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_BF16_TENSOR_FLOPS_PER_S * 1e3
    step_ms = 1e3 * float(np.median(step_s))
    del params, cache, logits
    torch.cuda.empty_cache()
    reduced = [f"layers {full.num_layers} -> {cfg.num_layers}: one card"] \
        * (cfg.num_layers != full.num_layers)
    reduced.append(f"f32 card-vs-host step at {tight['layers']} of "
                   f"{full.num_layers} layers, batch {tight['batch']}, the "
                   f"full {tight['cache_rows']} cache rows"
                   + (f", vocabulary {tight['vocab']} of {full.vocab_size}"
                      if tight["vocab"] != full.vocab_size else ""))
    return {**shape_out(name, spec, full, shape, cfg, b, reduced),
            "weights_gb_bf16": w_bytes / 1e9, "init_s": init_s,
            "tight_f32": tight, "cache_gb": cache_bytes / 1e9,
            "cache_fill_s": fill_s, "steps_s": steps_s, "pos": pos,
            "slots": slots,
            "first_step_ms": 1e3 * first[0],
            "step_ms": [1e3 * x for x in step_s],
            "ms_per_step": step_ms, "tokens_per_s": b / step_ms * 1e3,
            "memory_allocated_before_step_gb": base_gb,
            "max_memory_allocated_gb": peak_gb,
            "step_transient_gb": peak_gb - base_gb, "profile": prof,
            "least_bytes": least_bytes, "least_flops": flops,
            **({"experts_routed_by_layer": [int(torch.unique(c["ids"])
                                                .numel()) for c in routing],
                "experts": cfg.num_experts} if routing else {}),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "device_share_of_bound": max(bytes_ms, ops_ms)
            / prof["device_ms_per_call"] if prof["device_ms_per_call"]
            else None,
            "roofline": path_roofline(torch, f"{spec['arch']} decode",
                                      step_ms / 1e3,
                                      pending[f"{name}_roofline"]),
            "timer": "step_ms: host clock between synchronisations, the "
            "median of SHAPE_DECODE_STEPS steps at the same pos; profile: "
            "3 more under torch.profiler", "ok": True}


def phase_shape_train(torch, dev, name: str, pending: dict) -> dict:
    """SHAPES["train_4k"] on ``SHAPE_CELLS[name]``'s config at full depth
    (f32 params, grads and AdamW moments, bf16 compute, per-layer remat,
    dense attention): before it the float32 card-vs-host step at 1 layer
    and the full length; then ``train_full_depth``'s steps at 1 x 4096
    (the loss falls) and one more step profiled; at ``layers`` where the
    cell gives them."""
    from dataclasses import replace

    spec = SHAPE_CELLS[name]
    full, shape = shape_config(spec)
    tr = spec["train"]
    check(tr["tokens"] == shape.seq_len, f"{name}: not the shape's length")
    tight = lm_train_tight(torch, dev, spec["arch"], spec["tight"],
                           pending.get(name))
    torch.cuda.empty_cache()
    layers = spec.get("layers")
    train = train_full_depth(torch, dev, spec["arch"], tr, seed=spec["seed"],
                             layers=layers, profile=True)
    reduced = [f"layers {full.num_layers} -> {layers}: one card's 80 GB "
               f"(16 B of float32 state a parameter)"] * bool(layers)
    reduced.append(f"f32 card-vs-host step at {tight['layers']} of "
                   f"{full.num_layers} layers, {tight['tokens']} tokens"
                   + (f" after {tight['positions'] - tight['tokens']} "
                      "patches" if tight["positions"] != tight["tokens"]
                      else "")
                   + (f", vocabulary {tight['vocab']} of {full.vocab_size}: "
                      "the host half's time and memory" if tight["vocab"]
                      != full.vocab_size else ""))
    cfg = replace(full, num_layers=layers or full.num_layers)
    return {**shape_out(name, spec, full, shape, cfg, tr["batch"], reduced),
            "tight_f32": tight, **train,
            "roofline": path_roofline(torch, f"{spec['arch']} train",
                                      train["ms_per_step"] / 1e3,
                                      pending[f"{name}_roofline"]),
            "ok": True}


def host_memory() -> dict:
    """The host's available memory now and this process's peak resident
    memory so far, GB (the workers report theirs with each result)."""
    import resource
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return {"available_gb": int(info["MemAvailable"].split()[0]) / 1e6,
            "main_max_rss_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1e6}


def phase_shapes(torch, dev, launches: dict, pending: dict,
                 errs: dict) -> list:
    """Every cell of SHAPE_CELLS, one phase line each, freeing the card
    between them; ``pending``: ``start_host_checks``' workers. The card
    halves of the ``rows="flash"`` checks run first, so that their host
    rows (one thread, in the cells' order: ``flash_rows_check``) run
    beside the cells."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs.base import SHAPES
    with ThreadPoolExecutor(max_workers=1) as rows_pool:
        rows = {name: flash_rows_check(torch, dev, spec["arch"],
                                       SHAPES[spec["shape"]].seq_len,
                                       spec["tight"], rows_pool)
                for name, spec in SHAPE_CELLS.items()
                if spec["tight"].get("rows") == "flash"}
        torch.cuda.empty_cache()
        out = []
        for name, spec in SHAPE_CELLS.items():
            kind = spec["shape"]
            t0 = time.perf_counter()
            if kind == "prefill_32k":
                row = phase_shape_prefill(torch, dev, launches, name,
                                          pending, errs, rows.get(name))
            elif kind == "train_4k":
                row = phase_shape_train(torch, dev, name, pending)
            else:
                with whole_large_blocks(torch):
                    row = phase_shape_decode(torch, dev, name, pending)
            row["phase_s"] = time.perf_counter() - t0
            row["host_memory"] = host_memory()
            emit(row)
            out.append(row)
            torch.cuda.empty_cache()
    return out


# -- phase 12: the launch and sharding tooling (slice 13) ---------------------

# the measured paths run on one card: the roofline's mesh and chip count
ONE_CARD = ((1, 1), ("data", "model"))
FLOP_CHECK_LAYERS = 2
EP_CHECK = dict(mesh=((1, 4), ("data", "model")), batch=2, tokens=512,
                cf=1.25, step=0.1)
# float32, TF32 off: the card's and the host's matmuls differ only in the
# order of their sums (d = 2048, f = 1024 terms), ≈ 1e-6 on outputs of
# order 1
EP_TOL = 1e-5
DRYRUN_CELL = ("qwen3_4b", "decode_32k")
# the dry-run CLI as `python -m`, in a process where `import jax` fails
DRYRUN_NO_JAX = ("import runpy, sys; sys.modules['jax'] = None; "
                 "runpy.run_module('repro_torch.launch.dryrun', "
                 "run_name='__main__')")
LAUNCH_WALL_LIMIT_S = 30.0


def roofline_probe(arch: str, layers: int | None, kind: str, b: int,
                   s: int) -> dict:
    """The roofline of the work a path does, from the port's probe on
    fake tensors at that path's shape and depth (None: the published
    one) on one card, with the path's gather embedding: stub attention
    plus flash's analytic add-back where the model attends (the
    reference's optimized probe), and the bound. memory_s counts the
    eager program's traffic, every aten op's inputs and outputs: what
    the port's unfused steps move. Plain numbers and names only, so that
    a worker process can hand it over."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import AbstractMesh
    shape = ShapeSpec(f"{kind}_{b}x{s}", s, b, kind)
    cfg = get_config(arch)
    cfg = replace(cfg, num_layers=layers or cfg.num_layers)
    # decode attends densely over its cache: the probe counts it
    flash = bool(cfg.num_heads) and not cfg.use_mla and kind != "decode"
    over = {"onehot_embed": False, **(
        {"attention_impl": "stub"} if flash else {})}
    probe = roofline.probe_shape(cfg, shape, over, AbstractMesh(*ONE_CARD))
    add = roofline.flash_attention_cost(cfg, shape, chips=1) \
        if flash else (0.0, 0.0)
    if flash and cfg.family == "hybrid":
        # flash_attention_cost counts every layer; a hybrid attends once
        # a shared application
        share = (cfg.num_layers // cfg.shared_attn_every) / cfg.num_layers
        add = (add[0] * share, add[1] * share)
    probe["hlo_flops"] += add[0]
    probe["hlo_bytes"] += add[1]
    t = roofline.roofline_terms(probe, chips=1)
    return {"arch": arch, "layers": cfg.num_layers, "shape": shape.name,
            "hlo_flops": t["hlo_flops"], "hlo_bytes": t["hlo_bytes"],
            "flash_flops_added": add[0], "flash_bytes_added": add[1],
            "compute_s": t["compute_s"], "memory_s": t["memory_s"],
            "dominant": t["dominant"], "bound_s": t["step_time_bound_s"],
            "model_flops": t["model_flops"]}


def roofline_row(path: str, probed: dict, secs: float) -> dict:
    """``roofline_probe``'s terms beside a path's measured seconds: mfu =
    model_flops / (measured_s · bf16 peak); flops_share is the same with
    the FLOPs the step runs (the probe's count plus flash's), which
    model_flops (2 or 6 · params · tokens) exceeds where the embedding
    and the head are a large share of a cut model (a gather, and the
    head at one position a prefill)."""
    return {"path": path, **probed, "measured_s": secs,
            "mfu": probed["model_flops"]
            / (secs * PEAK_BF16_TENSOR_FLOPS_PER_S),
            "flops_share": probed["hlo_flops"]
            / (secs * PEAK_BF16_TENSOR_FLOPS_PER_S),
            "bound_share": probed["bound_s"] / secs}


# the LM phases' paths whose roofline phase launch_roofline sets beside
# their measured seconds: (path, arch, layers or None, (kind, batch,
# tokens)); their probes run in the "roofline" worker
LAUNCH_PATHS = (
    ("lm_qwen3_4b prefill", LM_ARCH, None, ("prefill", *LM_PREFILL)),
    ("lm_train_qwen3_4b step", LM_ARCH, LM_TRAIN["layers"],
     ("train", LM_TRAIN["batch"], LM_TRAIN["tokens"])),
    ("lm_olmoe_1b_7b prefill", OLMOE_ARCH, None, ("prefill", *OLMOE_PREFILL)),
    ("lm_mamba2_1_3b prefill", MAMBA_ARCH, None, ("prefill", *SSM_PREFILL)),
    ("lm_zamba2_1_2b prefill", ZAMBA_ARCH, None, ("prefill", *SSM_PREFILL)),
    *((f"{name} prefill", spec["arch"], spec["layers"],
       ("prefill", *spec["prefill"]))
      for name, spec in DENSE_LM.items() if name != "lm_qwen3_4b"),
    ("lm_starcoder2_7b train step", "starcoder2_7b",
     STARCODER2_TRAIN["layers"],
     ("train", STARCODER2_TRAIN["batch"], STARCODER2_TRAIN["tokens"])))


def start_dryrun_cli():
    """The dry-run CLI on DRYRUN_CELL in a subprocess with ``jax``
    blocked, started ahead of phase launch_roofline, which reads it."""
    out_json = ROOT / "build" / "chip_smoke" / "dryrun.json"
    out_json.parent.mkdir(parents=True, exist_ok=True)
    arch, shape = DRYRUN_CELL
    return subprocess.Popen(
        [sys.executable, "-c", DRYRUN_NO_JAX, "--arch", arch, "--shape",
         shape, "--mesh", "pod", "--out", str(out_json), "--force"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def roofline_flop_check(torch, dev) -> dict:
    """Qwen3-4B at full width, 2 layers, a bf16 flash prefill of
    LM_PREFILL on the card under FlopCounterMode (the flash kernel, a
    ctypes call, counts nothing), in the configuration of the probe's
    first depth with the gather embedding: with flash_attention_cost
    added back, it must equal the fake-tensor probe's stub count plus
    the same add-back, as integers."""
    from dataclasses import replace

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.lm import cast_params, init_params
    from repro_torch.train.train_step import make_prefill_step
    b, s = LM_PREFILL
    shape = ShapeSpec("prefill_flop_check", s, b, "prefill")
    base = get_config(LM_ARCH)
    over = roofline._probe_cfg_overrides(base, shape, FLOP_CHECK_LAYERS)
    stub_cfg = dryrun.cell_config(base, shape, attention_impl="stub",
                                  onehot_embed=False, **over)
    flash_cfg = replace(stub_cfg, attention_impl="flash")
    stub = dryrun.lower(stub_cfg, shape, AbstractMesh(*ONE_CARD))
    gen = torch.Generator(device=dev).manual_seed(21)
    params = cast_params(init_params(flash_cfg, gen, dev), flash_cfg)
    tok = torch.randint(0, base.vocab_size, (b, s), generator=gen,
                        device=dev, dtype=torch.int32)
    before = fa.LAUNCHES["flash_attention"]
    with FlopCounterMode(display=False) as fc:
        logits = make_prefill_step(flash_cfg)(params, {"tokens": tok,
                                                       "labels": tok})
    sync(torch, dev)
    launched = fa.LAUNCHES["flash_attention"] - before
    check(launched == FLOP_CHECK_LAYERS,
          f"flop check: {launched} flash launches")
    check(bool(torch.isfinite(logits).all()), "flop check logits")
    add = roofline.flash_attention_cost(flash_cfg, shape, chips=1)[0]
    card = int(fc.get_total_flops()) + int(add)
    fake = int(stub["flops_total"]) + int(add)
    check(card == fake, f"card flops {card} != fake-tensor probe {fake}")
    del params, logits
    return {"layers": FLOP_CHECK_LAYERS, "batch": b, "tokens": s,
            "card_flops_plus_flash": card, "stub_flops_plus_flash": fake,
            "flash_flops_added": int(add), "flash_launches": launched,
            "equal": card == fake}


def argument_bytes_check(torch, lm: dict) -> dict:
    """The dry run's exact argument bytes on a one-device mesh: its
    params role must be the serving params phase lm_qwen3_4b held on the
    card; and the dry run of the full model allocates no device memory
    (its tensors are fake)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    b, s = LM_PREFILL
    shape = ShapeSpec("prefill_2x4096", s, b, "prefill")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = dryrun.lower(dryrun.cell_config(get_config(LM_ARCH), shape),
                       shape, AbstractMesh(*ONE_CARD))
    grew = torch.cuda.max_memory_allocated() - held
    check(grew == 0, f"the dry run allocated {grew} B on the card")
    params = round(res["argument_mb_by_role"]["params"] * 1e6)
    check(params == lm["weights_bytes"],
          f"dry-run params {params} B != {lm['weights_bytes']} B on the card")
    return {"argument_mb_per_dev": res["argument_mb_per_dev"],
            "argument_mb_by_role": res["argument_mb_by_role"],
            "params_bytes": params, "card_params_bytes": lm["weights_bytes"],
            "equal": True, "device_bytes_allocated": grew}


def ep_check(torch, dev) -> dict:
    """OLMoE-1B-7B's MoE layer at full width in float32, moe_apply's
    expert-parallel path (data 1 x model 4: 16 experts a shard) on the
    card and on the host: every shard's routing plan equal as integers,
    drops included (expert 0 overflows), outputs within EP_TOL."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.distributed.act_sharding import (ActivationSharding,
                                                      activation_sharding)
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import moe
    cfg = replace(get_config(OLMOE_ARCH), compute_dtype="float32")
    e, b, s = cfg.num_experts, EP_CHECK["batch"], EP_CHECK["tokens"]
    gen = torch.Generator(device=dev).manual_seed(23)
    pc = moe.moe_init(gen, cfg, torch.float32, dev)
    # an orthonormal router and tokens that give each expert one of e
    # levels EP_CHECK["step"] apart (a random order a token, expert 0
    # above all): the top-k's gaps are far above the devices' float32
    # differences, so routing must agree, and expert 0 overflows
    q = torch.linalg.qr(torch.randn((cfg.d_model, e), generator=gen,
                                    device=dev)).Q.contiguous()
    levels = torch.argsort(torch.rand((b * s, e), generator=gen,
                                      device=dev), dim=1).float()
    levels[:, 0] = e
    pc["router"] = q
    xc = (EP_CHECK["step"] * levels @ q.T).reshape(b, s, cfg.d_model)
    ph = {k: v.cpu() for k, v in pc.items()}
    xh = xc.cpu()
    top = torch.topk(xh.reshape(b * s, -1) @ ph["router"],
                     cfg.experts_per_token + 1, dim=-1).values
    gap = float((top[:, -2] - top[:, -1]).min())
    check(gap > 1e-3, f"EP: top-k gap {gap}")
    ctx = ActivationSharding(AbstractMesh(*EP_CHECK["mesh"]), "data")
    plans = []
    real = moe.dispatch_plan

    def recorded(ids, e, cap):
        out = real(ids, e, cap)
        plans.append((e, cap, [ids, *out]))
        return out

    moe.dispatch_plan = recorded
    try:
        with activation_sharding(ctx):
            got = moe.moe_apply(pc, cfg, xc, EP_CHECK["cf"])
            sync(torch, dev)
            t0 = time.perf_counter()
            want = moe.moe_apply(ph, cfg, xh, EP_CHECK["cf"])
            host_s = time.perf_counter() - t0
    finally:
        moe.dispatch_plan = real
    shards = EP_CHECK["mesh"][0][1]
    check(len(plans) == 2 * shards, f"EP: {len(plans)} dispatches")
    dropped = []
    for (e, cap, a), (e_h, cap_h, w) in zip(plans[:shards], plans[shards:]):
        check((e, cap) == (e_h, cap_h), "EP: experts or capacity differ")
        for u, v in zip(a, w):
            check(torch.equal(u.cpu(), v), "EP: routing differs from host")
        ids, order, keep, _ = w
        local = ((ids >= 0) & (ids < e)).reshape(-1)[order]
        dropped.append(int((local & ~keep).sum()))
    err = float((got.cpu() - want).abs().max())
    check(err <= EP_TOL, f"EP card vs host {err} > {EP_TOL}")
    check(sum(dropped) > 0, "EP: no assignment was dropped")
    return {"arch": OLMOE_ARCH, "mesh": EP_CHECK["mesh"],
            "experts_a_shard": cfg.num_experts // shards,
            "tokens": EP_CHECK["batch"] * EP_CHECK["tokens"],
            "capacity": plans[0][1], "dropped_by_shard": dropped,
            "min_topk_gap": gap,
            "routing_equal": True, "max_abs_err": err, "tolerance": EP_TOL,
            "host_s": host_s}


def phase_launch_roofline(torch, dev, smi: str, lm: dict, secs: list,
                          pending: dict, cli) -> dict:
    """The launch and sharding tooling on the card's machine: the
    roofline of each of LAUNCH_PATHS beside the seconds the LM phases
    measured (``secs``, in that order; no new timing runs; the probes
    from the "roofline" worker, ``pending``), the FLOP counter against
    what the card runs, the dry run's argument bytes against the card's,
    the expert-parallel MoE path card vs host, and the dry-run CLI in
    its subprocess (``cli``, from ``start_dryrun_cli``; this machine has
    no JAX)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out_json = ROOT / "build" / "chip_smoke" / "dryrun.json"
    arch, shape = DRYRUN_CELL
    parts = {}
    try:
        for name, fn in (("roofline", lambda: [
                path_roofline(torch, path, sec,
                              pending[f"launch_roofline_{i}"])
                for i, ((path, *_), sec) in enumerate(zip(LAUNCH_PATHS,
                                                         secs))]),
                         ("flop_check", lambda: roofline_flop_check(torch,
                                                                    dev)),
                         ("argument_bytes", lambda: argument_bytes_check(
                             torch, lm)),
                         ("ep", lambda: ep_check(torch, dev))):
            t1 = time.perf_counter()
            parts[name] = fn()
            parts[name + "_s"] = time.perf_counter() - t1
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        _, cli_err = cli.communicate(timeout=120)
        parts["dryrun_cli_wait_s"] = time.perf_counter() - t1
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    check(cli.returncode == 0, f"dryrun CLI exited {cli.returncode}: "
          f"{cli_err[-2000:]}")
    cell = json.loads(out_json.read_text())[f"{arch}|{shape}|sp"]
    check("error" not in cell, f"dryrun CLI cell: {cell}")
    wall = time.perf_counter() - t0
    return {"phase": "launch_roofline", "nvidia_smi": smi,
            "peak_flops_bf16": PEAK_BF16_TENSOR_FLOPS_PER_S,
            "hbm_bytes_per_s": PEAK_BYTES_PER_S, **parts,
            "dryrun_cli": {"cell": cell, "returncode": cli.returncode,
                           "jax_blocked": True,
                           "jax_installed_here":
                           importlib.util.find_spec("jax") is not None},
            "wall_s": wall, "wall_limit_s": LAUNCH_WALL_LIMIT_S,
            "within_wall_limit": wall < LAUNCH_WALL_LIMIT_S, "ok": True}


KERNELS = {
    "label_join": ("engine_f32", "label_join/csrc/label_join.cu",
                   "src/repro/kernels/label_join/kernel.py:63"),
    "label_join_lb": ("lb_window", "label_join/csrc/label_join.cu",
                      "src/repro/kernels/label_join/kernel.py:86"),
    # join_pallas as ops.py:211 and :259 run it under shard_map
    "label_join_sharded": ("sharded_e8_rep_float32",
                           "label_join/csrc/label_join.cu",
                           "src/repro/kernels/label_join/kernel.py:63"),
    "minplus": ("squaring_above_cap", "minplus/csrc/minplus.cu",
                "src/repro/kernels/minplus/kernel.py:83"),
    "minplus_closure": ("closure_n4096", "minplus/csrc/minplus.cu",
                        "src/repro/kernels/minplus/kernel.py:83"),
    "minplus_kmajor": ("stage_c_n4096", "minplus/csrc/minplus.cu",
                       "src/repro/kernels/minplus/kernel.py:83"),
    "relax": ("stage_a_n4096", "minplus/csrc/minplus.cu",
              "src/repro/kernels/minplus/kernel.py:108"),
    "flash_attention": ("flash_b2_s4096",
                        "flash_attention/csrc/flash_attention_bf16.cu",
                        "src/repro/kernels/flash_attention/kernel.py:94"),
    "floyd_warshall": ("fw_n6400", "sssp_relax/csrc/floyd_warshall.cu",
                       "src/repro/kernels/sssp_relax/kernel.py:77"),
}


# what a kernel's row adds to its entry in the kernels line, where it
# has it: the relax kernel's second bound, occupancy and the map's cost,
# the Floyd–Warshall kernel's phase times, the operations bounds at 2
# instructions a term and at the measured rate
KERNEL_EXTRAS = ("dense_bytes_ms", "dense_ms", "mapped_ms", "occupancy_kept",
                 "occupancy_ms", "multi_source_uses_map", "phase_ms",
                 "ops_ms_2_instructions", "ops_ms_measured_rate", "steps",
                 "loop_ms", "squaring_ms", "no_squaring_ms",
                 "one_squaring_ms", "generic_ms", "generic_with_copy_ms")


# the launches of a kernel on each of its paths' main runs, where it has
# more than one path (the kernels line's ``launches`` is the first)
KERNEL_PATHS = {"flash_attention": {
    "lm_qwen3_4b": "flash_attention",
    "lm_olmoe_1b_7b": "flash_attention_olmoe",
    "lm_frontends_internvl2": "flash_attention_internvl2",
    "lm_frontends_hubert": "flash_attention_hubert",
    "lm_zamba2_1_2b": "flash_attention_zamba2",
    **{name: spec["launches"] for name, spec in DENSE_LM.items()
       if name != "lm_qwen3_4b"},
    **{name: spec["launches"] for name, spec in SHAPE_CELLS.items()
       if "launches" in spec}}}


def kernels_line(rows: list, launches: dict, errs: dict) -> dict:
    by_shape = {r["shape"]: r for r in rows}
    out = []
    for name, (shape, source, replaces) in KERNELS.items():
        r = by_shape[shape]
        paths = {path: launches[key]
                 for path, key in KERNEL_PATHS.get(name, {}).items()}
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/" + source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": r["kernel_ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "shape": r["shape"],
                    "inputs_from_hbm": r.get("rows_from_hbm",
                                             r.get("inputs_from_hbm")),
                    **({"launches_by_path": paths} if paths else {}),
                    **{k: r[k] for k in KERNEL_EXTRAS if k in r}})
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    global PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S, PEAK_BF16_TENSOR_FLOPS_PER_S
    from repro_torch.launch import mesh as hw
    PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S, PEAK_BF16_TENSOR_FLOPS_PER_S = (
        hw.HBM_BW, hw.PEAK_FLOPS_F32, hw.PEAK_FLOPS_BF16)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.label_join import kernel, ref
    from repro_torch.kernels.minplus import kernel as mp_kernel
    from repro_torch.kernels.sssp_relax import kernel as fw_kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    logs = build.build([kernel.SOURCE, mp_kernel.SOURCE,
                        mp_kernel.PEAK_SOURCE, *fa_kernel.SOURCES,
                        fw_kernel.SOURCE])
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for log in logs.values()
             for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas})

    errs = {name: 0.0 for name in KERNELS}
    launches: dict = {}
    dev = torch.device("cuda")
    peak = phase_minplus_peak(torch, smi)
    emit(peak)
    emit(phase_kernels(torch, dev, kernel, ref, errs))
    emit(phase_minplus_kernels(torch, dev, errs))
    serving, state = phase_serving(torch, dev, launches, errs)
    emit(serving)
    emit(phase_oracle(torch, dev, state, launches))
    sharded, sharded_shapes = phase_sharded(torch, dev, state, launches, errs)
    emit(sharded)
    scatter, scatter_shapes = phase_scatter(torch, dev, state, launches,
                                            errs)
    emit(scatter)
    center, center_shapes, large_state, repair_ctx = phase_center(
        torch, dev, errs)
    emit(center)
    sharded_center, center_sharded_shapes = phase_sharded_center(
        torch, dev, center_shapes, repair_ctx["partition"], errs)
    emit(sharded_center)
    sharded_times = phase_sharded_times(
        torch, dev, {**sharded_shapes, **center_sharded_shapes,
                     **scatter_shapes})
    emit(sharded_times)
    del sharded_shapes, center_sharded_shapes, scatter_shapes
    cap, cap_states = phase_closure_cap(torch, dev, errs, launches)
    emit(cap)
    shapes = {**state["shapes"], **center_shapes}
    times = phase_times(torch, state, shapes)
    emit(times)
    builder_times = phase_builder_times(
        torch, {"n4096": state["build_state"], "n102400": large_state},
        {"at_cap": cap_states["at_cap"]},
        {"above_cap": cap_states["above_cap"]}, peak)
    del cap_states
    fw = phase_fw_kernels(torch, dev, errs, launches, large_state, peak)
    emit(fw)
    del shapes, center_shapes, large_state
    torch.cuda.empty_cache()
    emit(phase_updates_large(torch, dev, repair_ctx, errs))
    del repair_ctx
    emit(phase_updates_small(torch, dev, state, errs))
    emit(phase_latency_sim(torch, dev, state))
    del state
    torch.cuda.empty_cache()
    ingest, ingest_pending = phase_ingest(torch, dev, launches, errs, peak)
    emit(ingest)
    # the NY-scale build's stage-B squaring (q = 448) beside q = 239, 1024
    builder_times["rows"].append(ingest_pending.pop("squaring_row"))
    emit(builder_times)
    torch.cuda.empty_cache()
    host_checks = start_host_checks()
    emit(phase_flash_kernels(torch, dev, errs))
    lm = phase_lm_dense(torch, dev, launches, "lm_qwen3_4b")
    emit(lm)
    torch.cuda.empty_cache()
    flash_times = phase_flash_times(torch, dev, logs, errs)
    emit(flash_times)
    torch.cuda.empty_cache()
    olmoe = phase_lm_olmoe(torch, dev, launches)
    emit(olmoe)
    emit(phase_lm_deepseek(torch, dev))
    emit(phase_lm_frontends(torch, dev, launches))
    mamba = phase_lm_mamba2(torch, dev)
    emit(mamba)
    zamba = phase_lm_zamba2(torch, dev, launches)
    emit(zamba)
    # after the phases above, so that the worker has its host half ready
    lm_train = phase_lm_train(torch, dev, host_checks)
    emit(lm_train)
    torch.cuda.empty_cache()
    dense = {}
    for name in ("lm_starcoder2_7b", "lm_deepseek_67b",
                 "lm_nemotron_4_340b"):
        dense[name] = phase_lm_dense(torch, dev, launches, name, host_checks)
        emit(dense[name])
        torch.cuda.empty_cache()
    starcoder2 = dense["lm_starcoder2_7b"]
    dryrun_cli = start_dryrun_cli()
    try:
        phase_shapes(torch, dev, launches, host_checks, errs)
    except BaseException:
        dryrun_cli.kill()
        dryrun_cli.wait()
        raise
    emit(phase_launch_roofline(torch, dev, smi, lm, [
        min(lm["prefill"]["flash_s"]), lm_train["ms_per_step"] / 1e3,
        min(olmoe["prefill"]["flash_s"]), min(mamba["prefill"]["s"]),
        min(zamba["prefill"]["flash_s"]),
        *(min(out["prefill"]["flash_s"]) for out in dense.values()),
        starcoder2["train"]["ms_per_step"] / 1e3], host_checks, dryrun_cli))
    emit(finish_ingest_check(ingest_pending))
    emit(kernels_line(times["rows"] + sharded_times["rows"]
                      + builder_times["rows"] + flash_times["rows"]
                      + fw["rows"], launches, errs))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
