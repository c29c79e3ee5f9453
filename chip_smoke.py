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
width), and drives the port's seventeen paths:

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
  replicated and row-sharded, float32 and uint16, each shard's sharded
  kernel call held against its plain version and every answer against
  the replicated engine's; then a ``RebalancePlanner`` plan from the
  service's load and ``EdgeSystem.migrate``; and the row-sharded join at
  the center's size (65 536 rule-3 queries over n = 102 400's B, 8
  shards);
* the scatter-gather read path at n = 4096 —
  ``ServingPolicy(engine="scatter_gather")`` on the deployed system (16
  edge servers, each a logical shard of the card) in float32 and
  uint16, every server's partial launch held against its plain version
  and the answers against the replicated and sharded engines and the
  scalar loop; the plane's bytes, exchanges and the host split of a
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
  prefill, an f32 4-layer check of flash against dense and of
  ``decode_step`` against the forward pass, and ``BatchedDecoder``
  answering 8 requests;
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
  frames with dense attention (the bf16 flash kernel refuses its head
  dim 80);
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
  and 3 train steps at full depth.

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

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 rate and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# bf16 dense tensor-core peak: the bound of attention's products
PEAK_BF16_TENSOR_FLOPS_PER_S = 989e12
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


def emit(obj: dict) -> None:
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
    widths = {kind: sorted({v for k, v, _ in layouts if k == kind})
              for kind in ("float32", "codes")}
    check(widths == {"float32": [4, 8, 16], "codes": [2, 4, 8, 16]},
          f"the join shapes missed a vector width: {widths}")
    return {"phase": "kernels_vs_plain", "shapes": JOIN_SHAPES,
            "table_offsets_elements": [0, 1],
            "dtypes": ["float32", "uint16", "int16"],
            "layouts_vec_bytes_lanes": sorted(layouts),
            "tolerance": "bitwise", "ok": True}


# min-plus shapes (batch or None, m, k, n): unaligned ones, then the
# builder's — the closure squarings at q = 93 / 96 and stage C at both
# sizes, (m, kmax, bmax) x (m, bmax, q)
MINPLUS_SHAPES = [(None, 1, 1, 1), (None, 5, 7, 3), (None, 130, 70, 33),
                  (3, 37, 0, 5), (2, 200, 300, 65), (None, 93, 93, 93),
                  (None, 96, 96, 96), (16, 256, 8, 93), (16, 6400, 8, 96),
                  (1, 6400, 8, 96)]
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
    for batch, m, k, n in MINPLUS_SHAPES:
        lead = () if batch is None else (batch,)
        a = rand_dist(torch, gen, (*lead, m, k), 0.3)
        b = rand_dist(torch, gen, (*lead, k, n), 0.3)
        got = kernel.minplus(a, b)
        sync(torch, dev)
        want = ref.minplus_ref(a, b)
        check(torch.equal(got, want), f"minplus {lead}x{m}x{k}x{n}")
        errs["minplus"] = max(errs["minplus"], max_abs_err(got, want))
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
            "minplus_shapes": MINPLUS_SHAPES, "kmajor_shapes": KMAJOR_SHAPES,
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
    code, sentinel, scale = (0, 0, 1.0) if quant is None else (
        1 if quant[0] == 0xFFFF else 2, quant[0], quant[1])

    def run(lanes):
        def call(tab, a, b):
            out = torch.empty(q, device=tab.device)
            lb = torch.empty(q, device=tab.device) if with_lb else None
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
            "generic_with_copy_ms: the copy and the tiled kernel",
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
def hold_sharded_calls(ops, held: list):
    """While active, every call the path makes to the sharded kernel's
    wrapper keeps copies of its tensors and its result in ``held`` (the
    call itself launches once, as the path does)."""
    real = ops.sharded_gather_join

    def call(block, border, owner, shard, rs, rt, **kw):
        out = real(block, border, owner, shard, rs, rt, **kw)
        held.append(([_clone(x) for x in (block, border, owner)], shard,
                     [rs.clone(), rt.clone()], kw, out.clone()))
        return out

    ops.sharded_gather_join = call
    try:
        yield
    finally:
        ops.sharded_gather_join = real


def check_sharded_held(torch, held: list, errs: dict, what: str) -> int:
    """Each kept sharded-kernel result against the plain version on the
    same arguments, bit for bit; returns the count and empties ``held``."""
    from repro_torch.kernels.label_join import ref
    for (block, border, owner), shard, (rs, rt), kw, out in held:
        want = ref.sharded_gather_join_ref(block, border, owner, shard, rs,
                                           rt, **kw)
        check(torch.equal(out, want), f"{what}: shard {shard}'s kernel "
              "differs from its plain version")
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
    and row-sharded, float32 and uint16: bit for bit with the replicated
    engine, every shard's kernel call with its plain version; then a
    rebalance plan fed by the service's load and ``migrate``."""
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
                check(per_batch == e, f"{per_batch} launches a batch, "
                      f"{e} shards")
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
                    owner, rs, rt = (torch.from_numpy(x).to(dev)
                                     for x in eng.row_ids(ss, ts))
                    quant = None if eng.quant is None else eng.quant.key()
                    bt = eng.btables[0]
                    if border:
                        cross_base = eng.blocks[0].shape[0]
                        bt = ops.assemble_border_rows(
                            eng.btables, rs, rt, cross_base, mesh=eng.mesh,
                            quant=quant)
                        rs, rt = ops.assembled_row_ids(rs, rt, cross_base)
                    tag = "row" if border else "rep"
                    shapes[f"sharded_e{e}_{tag}_{dtype}"] = (
                        eng.blocks[0], bt, owner, 0, rs, rt, quant)
        spots = spot_check_dijkstra(g, ss, ts, got.distances, dijkstra, 4)
    # the path's launches: the checked submits (not the latency loops)
    launches["label_join_sharded"] = path_launches

    # the MIN seam on this path: E answer partials of (Q,), and the
    # row-sharded assembly's E partials of (2Q, q)
    seam = {}
    for e in SHARD_COUNTS:
        mesh = default_edge_mesh(e, device=dev)
        answers = [torch.rand(len(ss), device=dev) for _ in range(e)]
        rows_ = [torch.rand(2 * len(ss), q, device=dev) for _ in range(e)]
        seam[f"e{e}_answers_ms"] = event_ms(torch,
                                            lambda: mesh.pmin(answers), 50)
        seam[f"e{e}_assembly_ms"] = event_ms(torch,
                                             lambda: mesh.pmin(rows_), 50)

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
             "dijkstra_spot_pairs": spots, "seam_ms": seam,
             "rebalance": rebalance,
             "launches": {"label_join_sharded":
                          launches["label_join_sharded"]},
             "bytes": "per_shard_bytes: one shard's district block and "
             "share of B (the reference's per-device formulas); "
             "whole_card_bytes: all E shards on the one card",
             "timer": "submit: host clock, device synchronised, 30 "
             "submits; seam: CUDA events around 50 folds", "ok": True},
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


@contextlib.contextmanager
def hold_join_calls(mod, held: list):
    """While active, every call the path makes to ``mod.gather_join``
    keeps copies of its tensors and its result in ``held`` (the call
    itself launches once, as the path does)."""
    real = mod.gather_join

    def call(s_table, rs, t_table, rt, **kw):
        out = real(s_table, rs, t_table, rt, **kw)
        held.append(([_clone(x) for x in (s_table, rs, t_table, rt)], kw,
                     out.clone()))
        return out

    mod.gather_join = call
    try:
        yield
    finally:
        mod.gather_join = real


def check_join_held(torch, held: list, errs: dict, what: str) -> int:
    """Each kept join result against the plain version on the same
    arguments, bit for bit; returns the count and empties ``held``."""
    from repro_torch.kernels.label_join import ref
    for (s_table, rs, t_table, rt), kw, out in held:
        want = ref.gather_join_ref(s_table, rs, t_table, rt, **kw)
        check(torch.equal(out, want), f"{what}: the join kernel differs "
              "from its plain version")
        errs["label_join"] = max(errs["label_join"], max_abs_err(out, want))
    count = len(held)
    held.clear()
    return count


def scatter_host_split(torch, plane, ss, ts, reps: int = 30) -> dict:
    """Host clock of the plane's three steps on a warm batch, p50 of
    ``reps``: the coordinator's routing (``prepare_queries``, the lanes
    grouped by owner, the exchange check), the partial launches (the
    row ids up once, one wrapper call a server; no wait), and the
    consolidation (the partials concatenated, copied back — which waits
    for the device — and put in lane order)."""
    samples = {"route_ms": [], "launch_ms": [], "consolidate_ms": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        groups, rs, rt = plane._route(ss, ts)
        t1 = time.perf_counter()
        lanes, parts = plane._launch(groups, rs, rt)
        t2 = time.perf_counter()
        plane._consolidate(np.empty(len(ss), np.float32), lanes, parts)
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
    sharded engines and the scalar loop, every partial launch held
    against its plain version; bytes, exchange stats and the host split
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
        holder = hold_sharded_calls(kernel, held) if dtype == "float32" \
            else hold_join_calls(ops, held)
        with holder:
            got = svc.submit(ss, ts, client_districts=client)
        per_batch = {k: kernel.LAUNCHES[k] - before[k] for k in before}
        for k, v in per_batch.items():
            path[k] += v
        held_count = check_sharded_held(torch, held, errs,
                                        "scatter partial") \
            if dtype == "float32" else check_join_held(
                torch, held, errs, "scatter partial (uint16)")
        owners = len(np.unique(part.assignment[ss]))
        name = "label_join_sharded" if dtype == "float32" else "label_join"
        check(per_batch[name] == owners and held_count == owners
              and sum(per_batch.values()) == owners,
              f"scatter {dtype}: {per_batch} launches a batch, {owners} "
              "owning servers")
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
        if dtype == "float32":
            groups, rs, rt = plane._route(ss, ts)
            d, sel = max(groups, key=lambda gr: len(gr[1]))
            ids = torch.from_numpy(np.stack(
                [np.full(len(sel), d), rs[sel], rt[sel]]).astype(
                    np.int64)).to(dev)
            shapes["scatter_partial_f32"] = (
                plane._blocks[d], plane._bviews[d], ids[0].contiguous(), d,
                ids[1].contiguous(), ids[2].contiguous(), None)

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
    block (no query reads it): bit for bit with the replicated rule-3
    join, every shard's call with its plain version."""
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
        check(count == CENTER_SHARDS, f"{count} launches, {CENTER_SHARDS} "
              "shards")
        check(np.array_equal(got.cpu().numpy(), want), "row-sharded rule-3 "
              f"{dtype} differs from the replicated join")
        assembled = ops.assemble_border_rows(bshards, rs, rt, 1, mesh=mesh,
                                             quant=quant)
        shapes[f"center_e{CENTER_SHARDS}_row_{dtype}"] = (
            blocks[0], assembled, owner, 0,
            *ops.assembled_row_ids(rs, rt, 1), quant)
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
             "20 back-to-back calls (wrapper, ragged assembly, 8 launches "
             "and both seams; host ids to device and back included)",
             "ok": True}, shapes)


def sharded_bound(torch, block, border, owner, shard, rs, rt):
    """Bytes and operations one shard's launch needs on these inputs:
    owner and both row ids of every lane once, the distinct rows its own
    lanes read (block rows at W, border rows at q), the output; an add
    and a min per lane folded."""
    own = (owner == shard).cpu().numpy()
    rs_, rt_ = rs.cpu().numpy()[own], rt.cpu().numpy()[own]
    cross_base, w = block.shape[0], block.shape[1]
    bw, item = border.shape[1], block.element_size()
    qn = rs.shape[0]
    blk = np.union1d(rs_[rs_ < cross_base], rt_[rt_ < cross_base])
    brd = np.union1d(rs_[rs_ >= cross_base], rt_[rt_ >= cross_base])
    nbytes = 28 * qn + (len(blk) * w + len(brd) * bw) * item
    both_blk = (rs_ < cross_base) & (rt_ < cross_base)
    ops_ = 2 * int(np.where(both_blk, w, bw).sum())
    return nbytes, ops_


def time_sharded_shape(torch, kernel, ref, name, block, border, owner,
                       shard, rs, rt, quant) -> dict:
    """One shard's launch at a path's shape: device ms from CUDA-graph
    replays cycling through copies of its inputs, against its bound, its
    plain version and the ``amin`` of the gathered sums."""
    nbytes, ops_ = sharded_bound(torch, block, border, owner, shard, rs, rt)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops_ / PEAK_F32_OPS_PER_S * 1e3
    cold, from_hbm = cold_inputs((block, border, owner, rs, rt), nbytes)

    def launch(b, bt, o, a, c):
        return kernel.sharded_gather_join(b, bt, o, shard, a, c, quant=quant)

    def plain(b, bt, o, a, c):
        return ref.sharded_gather_join_ref(b, bt, o, shard, a, c,
                                           quant=quant)

    before = dict(kernel.LAUNCHES)
    kernel_ms = device_ms(torch, launch, cold)
    warm_ms = device_ms(torch, launch, [(block, border, owner, rs, rt)])
    call_ms = event_ms(torch, lambda: launch(block, border, owner, rs, rt),
                       200)
    kernel.LAUNCHES.update(before)      # timing launches are not the path's
    vec, lanes = kernel.sharded_join_layout(block, border, rs.shape[0])
    plain_ms = device_ms(torch, plain, cold)
    library_ms = None
    if quant is None:
        # the rows the plain version gathers, pads and selects, per copy
        rows = [ref.sharded_gather_rows(b, bt, a, c)
                for b, bt, _, a, c in cold]
        library_ms = device_ms(torch, lambda s_, t_: torch.amin(s_ + t_, 1),
                               rows)
        del rows
    copies = len(cold)
    del cold
    bound_ms = max(bytes_ms, ops_ms)
    return {"shape": name, "kernel": "label_join_sharded",
            "q": int(rs.shape[0]), "w": int(block.shape[1]),
            "border_w": int(border.shape[1]), "itemsize": block.element_size(),
            "owned_lanes": int((owner == shard).sum()),
            "bytes": nbytes, "ops": ops_, "copies": copies,
            "rows_from_hbm": from_hbm, "vec_bytes": vec, "lanes": lanes,
            "kernel_ms": kernel_ms, "l2_warm_ms": warm_ms,
            "wrapper_call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": bound_ms / kernel_ms if from_hbm else None}


def phase_sharded_times(torch, shapes: dict) -> dict:
    from repro_torch.kernels.label_join import kernel, ref
    rows = [time_sharded_shape(torch, kernel, ref, name, *args)
            for name, args in shapes.items()]
    return {"phase": "sharded_times", "timer": "device ms per shard launch "
            "from CUDA-graph replays timed with CUDA events, cycling through "
            "copies of the inputs so rows come from HBM (rows_from_hbm); "
            "bound: owner + row ids of every lane, the distinct rows the "
            "shard's own lanes read, the output, at 3.35 TB/s; library: "
            "torch.amin of the sums of the rows the plain version gathers "
            "(every lane, gathered beforehand; float32 only)", "rows": rows,
            "ok": True}


def phase_times(torch, state: dict, shapes: dict) -> dict:
    from repro_torch.kernels.label_join import kernel, ref

    rows = [time_shape(torch, kernel, ref, name, *args)
            for name, args in shapes.items()]
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
# every other head dim the tensor-core kernel takes (192: Nemotron-4-340B)
# and at ragged S != T, then the LM paths' shapes (Qwen3-4B, OLMoE-1B-7B,
# InternVL2-26B's prefills, Zamba2-1.2B's shared block)
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
                (2, 4096, 4096, 32, 32, 128, True, "bfloat16")]
# (B, S, H, KV, hd): q, k, v as the head-split views of one fused (B, S,
# H + 2 KV, hd) projection, strided in the sequence and head axes
FLASH_STRIDED = [(2, 1000, 32, 8, 128)]
# float32: both sides compute in f32 on unit-normal inputs; only the
# order of the sums and the online rescaling differ (the JAX package's
# own test allows 2e-4)
FLASH_F32_ATOL = 2e-5
# bf16: the tensor-core kernel rounds each p to bf16 before P.V (relative
# error <= 2^-9, bf16's unit roundoff) while l sums the unrounded p, so
# its f32 result is off by at most 2^-9 * sum_j p_j |v_j| / l. The bound
# allows twice that, plus the f32 bound above for the order of sums, plus
# one bf16 ulp (at the larger magnitude) for the output's one rounding:
#   |got - want| <= ulp + 2^-8 * attention(q, k, |v|) + FLASH_F32_ATOL
FLASH_P_ROUNDING = 2.0 ** -8


def bf16_bound_ratio(got, q, k, v, causal: bool) -> float:
    """Largest |got - want| over the bound above, elementwise; want and
    attention(q, k, |v|) from the plain version in f32 on the same bf16
    inputs."""
    import torch

    from repro_torch.kernels.flash_attention import ref
    qf, kf, vf = q.float(), k.float(), v.float()
    want = ref.attention_ref(qf, kf, vf, causal=causal)
    mass = ref.attention_ref(qf, kf, vf.abs(), causal=causal)
    g = got.float()
    mag = torch.maximum(g.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bound = ulp + FLASH_P_ROUNDING * mass + FLASH_F32_ATOL
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
            row["bound_ratio"] = bf16_bound_ratio(got, q, k, v, causal)
            check(row["bound_ratio"] <= 1.0,
                  f"flash {shape}: beyond the bf16 bound (ratio "
                  f"{row['bound_ratio']}, max abs {err})")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        rows.append(row)
        del q, k, v, got, want
    return {"phase": "kernels_vs_plain_flash", "rows": rows,
            "tolerance": f"float32: <= {FLASH_F32_ATOL} absolute; bf16: "
            "<= 1 bf16 ulp of the larger of the two + 2^-8 * attention(q, "
            f"k, |v|) + {FLASH_F32_ATOL}, elementwise (bound_ratio: the "
            "largest |got - want| over that bound)",
            "ok": True}


# -- phase 7: the dense-LM serving path at Qwen3-4B's full width -------------

LM_ARCH = "qwen3_4b"
LM_PREFILL = (2, 4096)                  # batch, tokens per sequence
LM_TIGHT = (4, 2, 256)                  # layers, batch, tokens (float32)
# f32 throughout (TF32 off): flash and dense attention, and decode over
# the cache against the full forward, differ only in the order of sums
# and the online rescaling, ~1e-6 relative per operation
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


def lm_tight_check(torch, dev) -> dict:
    """Full width, 4 layers, float32: flash prefill against dense, and
    decode_step fed the same tokens one at a time against the forward
    pass (flash) at every position."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.lm import (decode_step, forward, init_cache,
                                       init_params, lm_head_weight)
    from repro_torch.train.train_step import make_prefill_step
    layers, b, s = LM_TIGHT
    cfg = replace(get_config(LM_ARCH), num_layers=layers,
                  compute_dtype="float32")
    flash = replace(cfg, attention_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        device=dev)
    got = make_prefill_step(flash)(params, {"tokens": tok})
    want = make_prefill_step(cfg)(params, {"tokens": tok})
    prefill_rel = rel_diff(got, want)
    check(prefill_rel <= LM_TIGHT_REL,
          f"f32 flash prefill vs dense: {prefill_rel} > {LM_TIGHT_REL}")
    full = forward(params, flash, {"tokens": tok}) \
        @ lm_head_weight(params, flash)
    cache = init_cache(cfg, b, s, dev)
    rels = torch.empty(s, dtype=torch.float64, device=dev)
    for i in range(s):
        logits, cache = decode_step(params, cfg, cache, tok[:, i:i + 1], i)
        d = (logits[:, 0] - full[:, i]).double()
        rels[i] = d.abs().max() / full[:, i].double().abs().max()
    decode_rel = float(rels.max())
    check(decode_rel <= LM_TIGHT_REL,
          f"f32 decode vs forward: {decode_rel} > {LM_TIGHT_REL}")
    return {"layers": layers, "batch": b, "tokens": s,
            "prefill_flash_vs_dense_rel": prefill_rel,
            "decode_vs_forward_rel_max": decode_rel,
            "tolerance_rel": LM_TIGHT_REL}


def phase_lm(torch, dev, launches: dict) -> dict:
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.lm import (cast_params, decode_step, init_cache,
                                       init_params)
    from repro_torch.train.train_step import make_prefill_step

    tight = lm_tight_check(torch, dev)
    torch.cuda.empty_cache()

    cfg = get_config(LM_ARCH)
    flash = replace(cfg, attention_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    params = cast_params(init_params(cfg, gen, dev), cfg)   # f32 freed
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    w_gb = weight_gb(params)
    b, s = LM_PREFILL
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=dev)}
    prefill = make_prefill_step(flash)

    # the main path: one flash prefill, read its launches, then decode
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa)
    logits, first = timed(torch, lambda: prefill(params, batch), 1)
    launches["flash_attention"] = fa.LAUNCHES["flash_attention"]
    check(launches["flash_attention"] == cfg.num_layers,
          f"flash prefill launched {launches['flash_attention']} times, "
          f"not {cfg.num_layers}")
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cache = init_cache(cfg, b, 8, dev)
    before = fa.LAUNCHES["flash_attention"]
    step_logits, _ = decode_step(params, cfg, cache,
                                 batch["tokens"][:, :1], 0)
    sync(torch, dev)
    check(fa.LAUNCHES["flash_attention"] == before,
          "decode_step launched the flash kernel")
    check(bool(torch.isfinite(step_logits).all()), "decode logits")

    server = serve_requests(torch, cfg, params, dev, seed=13)
    decode_profile = profile_decode(torch, params, cfg, dev)

    # timed prefills: flash (each +36 launches), then the dense yardstick
    before = fa.LAUNCHES["flash_attention"]
    _, flash_s = timed(torch, lambda: prefill(params, batch), 2)
    check(fa.LAUNCHES["flash_attention"] - before == 2 * cfg.num_layers,
          "a timed flash prefill did not launch once per layer")
    dense_prefill = make_prefill_step(cfg)
    dense_logits, dense_s = timed(
        torch, lambda: dense_prefill(params, batch), 3)
    bf16_rel = rel_diff(logits, dense_logits)
    check(bool(torch.isfinite(dense_logits).all()), "dense prefill logits")
    check(bf16_rel <= LM_BF16_REL,
          f"bf16 flash prefill vs dense: {bf16_rel} > {LM_BF16_REL}")
    del params, cache
    return {"phase": "lm_qwen3_4b", "arch": LM_ARCH,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads],
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "weights_gb_bf16": w_gb,
            "init_s": init_s, "tight_f32": tight,
            "prefill": {"batch": b, "tokens": b * s,
                        "flash_first_s": first[0], "flash_s": flash_s,
                        "flash_tokens_per_s": b * s / min(flash_s),
                        "dense_s": dense_s[1:],
                        "dense_tokens_per_s": b * s / min(dense_s[1:]),
                        "flash_vs_dense_rel_bf16": bf16_rel,
                        "tolerance_rel_bf16": LM_BF16_REL,
                        "peak_memory_gb_flash": peak_gb,
                        "flash_launches": launches["flash_attention"],
                        "timer": "host clock between synchronisations"},
            "server": server, "decode_profile": decode_profile,
            "decode_launches_flash": 0, "ok": True}


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


def profile_decode(torch, params, cfg, dev, steps: int = 3) -> dict:
    """Where a decode step's time goes: ``steps`` steps at the server's
    batch under ``torch.profiler`` — CUDA kernels launched per step, the
    device time they take, and the host time per step (profiler on, so
    the host time is inflated)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.lm import decode_step, init_cache
    b = LM_SERVER["batch"]
    cache = init_cache(cfg, b, LM_SERVER["max_len"], dev)
    tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    decode_step(params, cfg, cache, tok, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            decode_step(params, cfg, cache, tok, i + 1)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    # a record_function range (the MoE stages) also shows on the device
    # timeline as a span around its kernels: not a kernel of its own
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.key not in MOE_STAGES]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"steps": steps, "kernels_per_step":
            sum(e.count for e in kernels) / steps,
            "device_ms_per_step": device_us / 1e3 / steps,
            "host_ms_per_step_profiled": host_s * 1e3 / steps,
            "device_idle_share": 1 - device_us / 1e6 / host_s,
            "top_kernels_ms_per_step": {
                e.key[:60]: e.self_device_time_total / 1e3 / steps
                for e in top}}


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
                      r"((?:Li\d+E)+)E", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2))
            name = f"{m.group(1)}<{', '.join(args)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.setdefault(name, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


# (row name, (B, S, H, KV, hd)): the prefill shapes of the LM paths,
# causal, bf16; the first is the kernels line's
FLASH_TIMED = [("flash_b2_s4096", (2, 4096, 32, 8, 128)),
               ("flash_olmoe_b2_s4096", (2, 4096, 16, 16, 128)),
               ("flash_internvl2_b1_s2048", (1, 2048, 48, 8, 128)),
               ("flash_zamba2_b2_s4096", (2, 4096, 32, 32, 128))]


def phase_flash_times(torch, dev, logs: dict) -> dict:
    """The flash kernel at the LM paths' prefill shapes, its plain
    version and the library yardstick (SDPA; timed here only, never
    called by the port), with inputs read from HBM; the registers and
    spills of both flash kernels from this run's build log."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ops, ref

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    rows = []
    for i, (name, (b, s, h, kv, hd)) in enumerate(FLASH_TIMED):
        q, k, v = flash_inputs(torch, dev, b, s, s, h, kv, hd, "bfloat16",
                               99 + i)
        nbytes = ops.hbm_bytes_per_call(q.shape, k.shape, 2)
        flops = 2 * b * h * s * s * hd      # causal: half of 4·B·H·S·T·hd
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_BF16_TENSOR_FLOPS_PER_S * 1e3
        in_bytes = sum(x.numel() * x.element_size() for x in (q, k, v))
        cold, from_hbm = cold_inputs((q, k, v), in_bytes)
        before = dict(kernel.LAUNCHES)
        kernel_ms = device_ms(torch, kernel.flash_attention, cold, 4, 3)
        kernel.LAUNCHES.update(before)  # timing launches are not the path's
        plain_ms = device_ms(torch, ref.attention_ref, cold, 2, 2)
        library_ms = device_ms(torch, sdpa, cold, 4, 3)
        copies = len(cold)
        del cold, q, k, v
        bound_ms = max(bytes_ms, ops_ms)
        rows.append({"shape": name, "kernel": "flash_attention",
                     "dims": [b, s, s, h, kv, hd], "dtype": "bfloat16",
                     "causal": True, "bytes": nbytes, "flops": flops,
                     "copies": copies, "inputs_from_hbm": from_hbm,
                     "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bytes_ms": bytes_ms,
                     "ops_ms": ops_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations",
                     "share_of_bound": bound_ms / kernel_ms,
                     "kernel_tflops": flops / kernel_ms / 1e9})
    registers = {}
    for src in kernel.SOURCES:
        if src in logs:
            registers.update(ptxas_usage(logs[src]))
    return {"phase": "flash_times", "registers": registers or "not built "
            "in this run", "timer": "device ms per launch from "
            "CUDA-graph replays timed with CUDA events, cycling through "
            "copies of the inputs", "bound": "max(q, k, v, out bytes at "
            "3.35 TB/s, 2·B·H·S·T·hd at the 989 TFLOP/s bf16 dense "
            "tensor-core peak)", "library": "torch.nn.functional."
            "scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
            "on (B, H, S, hd) views", "rows": rows, "ok": True}


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
           "tiled_squaring": squaring_row,
           "dijkstra_spot_pairs": INGEST_DIJKSTRA,
           "timer": "host clock between synchronisations; kernel rows: "
           "CUDA-graph replays (as phases times and builder_times)",
           "ok": True}
    pending = {"workers": workers, "card_table": center.border_labels.table}
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

LM_TRAIN = dict(batch=1, tokens=512, steps=5, peak_lr=1e-3)
LM_TRAIN_LOOP = dict(layers=2, steps=8, every=4, fault=6, resume_to=10)
LM_TRAIN_TIGHT = dict(layers=2, batch=1, tokens=256)
# float32 compute on both sides (TF32 off): the loss and the gradient
# norm differ only in the order of sums; a param after one Adam step is
# held by its L2 norm (Adam divides each gradient by its own magnitude,
# so elements whose gradient is near eps amplify that order)
LM_TRAIN_REL = 1e-4


def _rel2(torch, a, b) -> float:
    a, b = a.double(), b.double().to(a.device)
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def lm_train_tight(torch, dev) -> dict:
    """One float32 train step at full width and 2 layers on the card and
    on the host through the port, from the same params and batch."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params
    from repro_torch.train.data import DataConfig, synthetic_batch, to_device
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    t = LM_TRAIN_TIGHT
    cfg = replace(get_config(LM_ARCH), num_layers=t["layers"],
                  compute_dtype="float32")
    host = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    card = _copy_tree(host, dev)
    batch = synthetic_batch(cfg, DataConfig(t["tokens"], t["batch"], seed=2),
                            0)
    step = make_train_step(cfg, OptimizerConfig(warmup_steps=1))
    t0 = time.perf_counter()
    pc, _, mc = step(card, init_opt_state(card), to_device(batch, dev))
    sync(torch, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ph, _, mh = step(host, init_opt_state(host), to_device(batch, "cpu"))
    host_s = time.perf_counter() - t0
    rels = {k: rel_diff(mc[k].cpu(), mh[k]) for k in ("loss", "grad_norm")}
    leaves = {}
    for path, a, b in _paired_leaves(pc, ph):
        leaves[path] = _rel2(torch, a.cpu(), b)
    worst = max(list(rels.values()) + list(leaves.values()))
    check(worst <= LM_TRAIN_REL, f"f32 train step on the card vs the host: "
          f"{worst} > {LM_TRAIN_REL} ({rels}, {leaves})")
    return {"layers": t["layers"], "batch": t["batch"],
            "tokens": t["tokens"], "loss": float(mc["loss"]),
            "loss_rel": rels["loss"], "grad_norm_rel": rels["grad_norm"],
            "param_rel2_max": max(leaves.values()),
            "param_rel2": leaves, "tolerance_rel": LM_TRAIN_REL,
            "card_step_s": card_s, "host_step_s": host_s,
            "measure": "loss, grad_norm: max |a-b| / max |b|; params after "
            "the step: ||a-b||_2 / ||b||_2"}


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


def train_full_depth(torch, dev, arch: str, tr: dict, seed: int) -> dict:
    """``tr["steps"]`` train steps at full depth and width (float32
    params, bf16 compute, per-layer remat, dense attention) on one batch
    drawn from ``seed``: the first loss is near ln V and the loss falls;
    step, forward + backward and AdamW times, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params
    from repro_torch.train import train_step as tts
    from repro_torch.train.data import DataConfig, synthetic_batch, to_device
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    cfg = get_config(arch)
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
    n_params = sum(t.numel() for t in _leaves(params))
    del params, opt, batch
    torch.cuda.empty_cache()
    ln_v = float(np.log(cfg.vocab_size))
    check(all(np.isfinite(losses)), f"{arch} train losses: {losses}")
    check(abs(losses[0] - ln_v) <= 1.0,
          f"{arch}: first loss {losses[0]} is not near ln(V) = {ln_v}")
    check(losses[-1] < losses[0], f"{arch}: the loss did not fall: {losses}")
    warm = float(np.median(step_s[1:]))
    return {"layers": cfg.num_layers, "params_in_tree": n_params,
            "init_s": init_s, "state_gb": state_gb, "batch": tr["batch"],
            "tokens": tr["tokens"], "peak_lr": tr["peak_lr"],
            "losses": losses, "ln_vocab": ln_v, "step_s": step_s,
            "ms_per_step": 1e3 * warm, "fwd_bwd_ms": fwd_bwd_ms,
            "optimizer_ms": opt_ms,
            "tokens_per_s": tr["batch"] * tr["tokens"] / warm,
            "max_memory_allocated_gb": peak_gb,
            "timer": "step_s: host clock between synchronisations (the "
            "first step pays cuBLAS set-up; ms_per_step and tokens_per_s "
            "take the median of the others); fwd_bwd_ms / optimizer_ms: "
            "CUDA events around the step and around adamw_update"}


def phase_lm_train(torch, dev) -> dict:
    from repro_torch.configs import get_config

    tight = lm_train_tight(torch, dev)
    torch.cuda.empty_cache()
    loop = lm_train_loop(torch, dev)
    torch.cuda.empty_cache()

    cfg = get_config(LM_ARCH)
    train = train_full_depth(torch, dev, LM_ARCH, LM_TRAIN, seed=6)
    return {"phase": "lm_train_qwen3_4b", "arch": LM_ARCH,
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
    prefill; HuBERT-XLarge at full depth: forward over 1 x 4096 frames,
    non-causal, dense attention (the bf16 flash kernel takes no hd 80:
    its refusal is checked)."""
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
    torch.cuda.reset_peak_memory_stats()
    hidden, audio_s = timed(torch, lambda: forward(params, audio, frames), 3)
    audio_peak = torch.cuda.max_memory_allocated() / 1e9
    check(tuple(hidden.shape) == (ab, af, audio.d_model)
          and bool(torch.isfinite(hidden).all()), "HuBERT hidden states")
    # the bf16 flash kernel takes no hd 80: a flash forward must raise
    # ValueError before any launch (ROADMAP: later kernel work)
    before = dict(fa.LAUNCHES)
    refusal = None
    try:
        forward(params, replace(audio, attention_impl="flash"),
                {"frames": frames["frames"][:, :64]})
    except ValueError as e:
        refusal = str(e)
    check(refusal is not None and "head dim 80" in refusal
          and fa.LAUNCHES == before,
          f"the bf16 flash kernel did not refuse HuBERT's head dim 80: "
          f"{refusal}")
    audio_params = sum(t.numel() for t in _leaves(params))
    del params, hidden, frames
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
                       "batch": ab, "frames": af, "forward_s": audio_s,
                       "frames_per_s": ab * af / min(audio_s[1:]),
                       "peak_memory_gb": audio_peak,
                       "flash_refusal": refusal},
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
SSM_TRAIN = dict(batch=1, tokens=512, steps=3, peak_lr=1e-3)
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
    before it the f32 card-vs-host check at 2 layers; after it 3 train
    steps at full depth."""
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
    train = train_full_depth(torch, dev, MAMBA_ARCH, SSM_TRAIN, seed=55)
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
            "decode_profile": decode_profile, "train_full_depth": train,
            "ok": True}


def phase_lm_zamba2(torch, dev, launches: dict) -> dict:
    """Zamba2-1.2B at its published config, full depth and width, bf16
    weights: a flash prefill of 2 x 4096 tokens (its launches read: one
    a shared application, 6), the dense prefill as the yardstick,
    BatchedDecoder at batch 4 and a decode profile; before it the f32
    card-vs-host check at 6 layers (one shared application); after it
    3 train steps at full depth."""
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
    train = train_full_depth(torch, dev, ZAMBA_ARCH, SSM_TRAIN, seed=59)
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
            "decode_launches_flash": 0, "train_full_depth": train,
            "ok": True}


# each kernel at the shape its path's main run gives it (phase 3 for the
# distance kernels, phase 4b's build above the fused closure's cap for
# the tiled min-plus kernel, phase 7's prefill for flash attention, one
# district of n = 102 400 for Floyd–Warshall), and the TPU kernel it
# replaces (the tiled, fused-closure and k-major kernels all replace
# minplus_pallas)
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
    "lm_zamba2_1_2b": "flash_attention_zamba2"}}


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
        torch, {**sharded_shapes, **center_sharded_shapes,
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
    emit(builder_times)
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
    torch.cuda.empty_cache()
    emit(phase_flash_kernels(torch, dev, errs))
    emit(phase_lm(torch, dev, launches))
    torch.cuda.empty_cache()
    flash_times = phase_flash_times(torch, dev, logs)
    emit(flash_times)
    torch.cuda.empty_cache()
    emit(phase_lm_train(torch, dev))
    torch.cuda.empty_cache()
    emit(phase_lm_olmoe(torch, dev, launches))
    emit(phase_lm_deepseek(torch, dev))
    emit(phase_lm_frontends(torch, dev, launches))
    emit(phase_lm_mamba2(torch, dev))
    emit(phase_lm_zamba2(torch, dev, launches))
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
