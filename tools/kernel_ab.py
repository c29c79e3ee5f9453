#!/usr/bin/env python3
"""Time the port's kernels against another checkout's on one card.

    python3 tools/kernel_ab.py --parent DIR [--kernels K,...] [--out FILE]

DIR is a checkout of another commit of this repository (for example the
parent, unpacked with ``git archive``). Both trees' kernel sources are
built with the port's build flags and loaded side by side; each kernel
is then timed on the same inputs, in turns (other, this, this, other),
with CUDA-graph replays between CUDA events (``chip_smoke.device_ms``),
cycling through copies of the inputs so that they come from HBM where
they fit twice in the L2. ``--kernels`` picks among (default: all):

* ``minplus``: the tiled min-plus product at the squarings of stage B
  above the fused closure's cap (q = 239, 448) and at q = 1024, 90 %
  +inf, each result held bit for bit against the other tree's (-0.0
  read as +0.0);
* ``flash``: flash attention, bf16, at FLASH_SHAPES: Qwen3-4B's
  prefill (2 x 4096, causal), and the ``prefill_32k`` paths at their
  own batch (Qwen3-4B's GQA and OLMoE-1B-7B's MHA, causal, hd 128;
  HuBERT-XLarge's MHA at hd 80, non-causal, also at batch 1), held
  within the bf16 bound of ``chip_smoke.half_bound_ratio`` of the plain
  version (at 32 768 tokens on the last sequence's row slices,
  ``chip_smoke.flash_slices_check``);
* ``sharded_join``: the sharded serving join of one batch over E = 8
  logical shards, B replicated and row-sharded, float32 and uint16, at
  n = 4096 (4096 lanes, blocks of 512 rows at W = 256, q = 93) and at
  the center's size (65 536 rule-3 lanes over n = 102 400's q = 96):
  the other tree's per-shard path (``repro_label_join_sharded``: E
  launches and the ``torch.minimum`` fold, after the ragged assembly
  and its fold for a row-sharded B) against this tree's one launch
  (``kernel.multi_shard_gather_join``), held bit for bit.

Prints one JSON object (also written to FILE) with the card's name and
power limit. Needs a CUDA device and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MINPLUS = "src/repro_torch/kernels/minplus/csrc/minplus.cu"
FLASH = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bf16.cu"
JOIN = "src/repro_torch/kernels/label_join/csrc/label_join.cu"
SOURCES = {"minplus": MINPLUS, "flash": FLASH, "sharded_join": JOIN}
SQUARINGS = (239, 448, 1024)
# B, S (= T), H, KV, hd, causal
FLASH_SHAPES = ((2, 4096, 32, 8, 128, True), (8, 32768, 32, 8, 128, True),
                (8, 32768, 16, 16, 128, True), (8, 32768, 16, 16, 80, False),
                (1, 32768, 16, 16, 80, False))
# (name, lanes, block rows, W, n, q, share of rule-3 lanes): the sharded
# engine's E = 8 layout at n = 4096 (2 districts of kmax 256 a shard)
# and the center's rule-3 batch over n = 102 400 (one +inf block row)
JOIN_SHAPES = (("n4096", 4096, 512, 256, 4096, 93, 2 / 3),
               ("center", 65536, 1, 96, 102400, 96, 1.0))
JOIN_SHARDS = 8


def load(build, source: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.library_path(source)))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    if hasattr(lib, "repro_minplus"):
        lib.repro_minplus.argtypes = [p, p, p, i64, i64, i64, i64, p]
        lib.repro_minplus.restype = ctypes.c_int
    if hasattr(lib, "repro_label_join_sharded"):
        lib.repro_label_join_sharded.argtypes = [
            ctypes.c_int, p, i64, i64, p, i64, i64, p, i64, p, p, i64,
            ctypes.c_int, ctypes.c_float, p, p]
        lib.repro_label_join_sharded.restype = ctypes.c_int
    if hasattr(lib, "repro_flash_attention_bf16"):
        fn = lib.repro_flash_attention_bf16
        fn.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, p,
                       ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def minplus_call(torch, lib):
    def call(a, b):
        out = torch.empty((a.shape[0], b.shape[1]), device=a.device)
        err = lib.repro_minplus(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                1, a.shape[0], a.shape[1], b.shape[1],
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"repro_minplus: CUDA error {err}")
        return out
    return call


def flash_call(torch, lib, causal: bool):
    def call(q, k, v):
        b, s, h, hd = q.shape
        out = torch.empty_like(q)
        strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3])
        err = lib.repro_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            k.shape[1], h, k.shape[2], hd, strides,
            math.log2(math.e) / math.sqrt(hd), int(causal),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"repro_flash_attention_bf16: error {err}")
        return out
    return call


def parent_sharded_call(torch, lib, e: int, rows_pd, quant, ops, mesh):
    """The per-shard path of a tree whose C entry is
    ``repro_label_join_sharded``: one launch a shard over the batch and
    the fold, after the ragged assembly for a row-sharded B."""
    code, sentinel, scale = (0, 0, 1.0) if quant is None else (
        1, quant[0], quant[1])

    def one(block, border, owner, d, rs, rt):
        out = torch.empty(rs.shape[0], device=rs.device)
        err = lib.repro_label_join_sharded(
            code, block.data_ptr(), block.shape[0], block.shape[1],
            border.data_ptr(), border.shape[0], border.shape[1],
            owner.data_ptr(), d, rs.data_ptr(), rt.data_ptr(), rs.shape[0],
            sentinel, scale, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"repro_label_join_sharded: CUDA error {err}")
        return out

    def call(*x):
        blocks, borders, (owner, rs, rt) = x[:e], list(x[e:2 * e]), x[2 * e:]
        if rows_pd is not None:
            cross_base = blocks[0].shape[0]
            border = ops.assemble_border_rows(borders, rs, rt, cross_base,
                                              mesh=mesh, quant=quant)
            rs, rt = ops.assembled_row_ids(rs, rt, cross_base)
            borders = [border] * e
        return mesh.pmin([one(blocks[d], borders[d], owner, d, rs, rt)
                          for d in range(e)])
    return call


def join_inputs(torch, dev, gen, shape, row_sharded: bool, codes: bool):
    """One batch of the sharded join at ``shape`` (JOIN_SHAPES), from a
    seed: blocks, border sources (E copies of B, or its row slices), and
    (owner, rs, rt) with rule-1/2 lanes in their owner's block."""
    _, lanes, rows, w, n, q, cross = shape
    e = JOIN_SHARDS

    def table(r, c):
        x = torch.rand((r, c), generator=gen, device=dev) * 1000.0
        x[torch.rand((r, c), generator=gen, device=dev) < 0.3] = math.inf
        if not codes:
            return x
        c16 = torch.where(torch.isinf(x), 65535, x.round()).to(torch.int32)
        return c16.to(torch.int16)          # uint16 codes as int16 bits

    blocks = [table(rows, w) for _ in range(e)]
    rpd = -(-n // e)
    b = table(rpd * e, q)
    borders = ([b[d * rpd:(d + 1) * rpd].clone() for d in range(e)]
               if row_sharded else [b[:n].clone() for _ in range(e)])
    owner = torch.randint(0, e, (lanes,), generator=gen, device=dev)
    is_cross = torch.rand(lanes, generator=gen, device=dev) < cross
    ids = [torch.where(is_cross,
                       rows + torch.randint(0, n, (lanes,), generator=gen,
                                            device=dev),
                       torch.randint(0, rows, (lanes,), generator=gen,
                                     device=dev)) for _ in range(2)]
    return blocks, borders, [owner, *ids]


def sharded_join_rows(torch, cs, dev, other_lib) -> list:
    from repro_torch.edge import default_edge_mesh
    from repro_torch.kernels.label_join import kernel, ops
    gen = torch.Generator(device=dev).manual_seed(25)
    mesh = default_edge_mesh(JOIN_SHARDS, device=dev)
    rows = []
    for shape in JOIN_SHAPES:
        for row_sharded in (False, True):
            for codes in (False, True):
                blocks, borders, ids = join_inputs(torch, dev, gen, shape,
                                                   row_sharded, codes)
                e = len(blocks)
                rows_pd = borders[0].shape[0] if row_sharded else None
                quant = (0xFFFF, 1.0) if codes else None

                def this(*x, rows_pd=rows_pd, quant=quant):
                    return kernel.multi_shard_gather_join(
                        list(x[:e]), list(x[e:2 * e]), *x[2 * e:],
                        rows_per_border_shard=rows_pd, quant=quant)

                calls = {"this": this,
                         "other": parent_sharded_call(torch, other_lib, e,
                                                      rows_pd, quant, ops,
                                                      mesh)}
                args = (*blocks, *borders, *ids)
                same = torch.equal(calls["this"](*args),
                                   calls["other"](*args))
                touched = sum(x.numel() * x.element_size() for x in args)
                inputs, from_hbm = cs.cold_inputs(args, min(
                    touched, 2 * shape[1] * shape[3] * (2 if codes else 4)))
                ms = in_turns(torch, cs, calls, inputs, 20, 20)
                del inputs
                rows.append({
                    "kernel": "label_join_sharded", "shape": shape[0],
                    "shards": e, "lanes": shape[1], "w": shape[3],
                    "q": shape[5], "row_sharded": row_sharded,
                    "dtype": "uint16" if codes else "float32",
                    "other": "E launches + fold (+ assembly)",
                    "this": "one launch", "bitwise_equal": same,
                    "inputs_from_hbm": from_hbm, "ms": ms})
                if not same:
                    raise SystemExit(f"kernel_ab: the sharded join at "
                                     f"{rows[-1]} differs")
    return rows


def plus_zero_bits(torch, x):
    bits = x.view(torch.int32)
    return torch.where(bits == -2 ** 31, torch.zeros_like(bits), bits)


def in_turns(torch, cs, calls: dict, inputs: list, n: int, r: int) -> dict:
    """other, this, this, other: each side's two times."""
    out = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        out[side].append(cs.device_ms(torch, calls[side], inputs, n, r))
    return out


def flash_row(torch, cs, dev, libs, shape) -> dict:
    b, s, h, kv, hd, causal = shape
    qkv = cs.flash_inputs(torch, dev, b, s, s, h, kv, hd, "bfloat16", 7)
    calls = {side: flash_call(torch, libs[(side, "flash")], causal)
             for side in ("this", "other")}

    def ratio(got):
        if s <= 4096:
            return cs.half_bound_ratio(got, *qkv, causal)
        return cs.flash_slices_check(torch, got[-1:], *(
            x[-1:] for x in qkv), causal)["bound_ratio"]

    ratios = {side: ratio(calls[side](*qkv)) for side in calls}
    inputs, from_hbm = cs.cold_inputs(qkv, sum(
        x.numel() * x.element_size() for x in qkv))
    ms = in_turns(torch, cs, calls, inputs, 4, 3)
    if max(ratios.values()) > 1.0:
        raise SystemExit(f"kernel_ab: flash beyond its bound: {ratios}")
    return {"kernel": "flash_attention_bf16", "shape": [b, s, h, kv, hd],
            "causal": causal, "bound_ratio": ratios,
            "inputs_from_hbm": from_hbm, "ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="checkout of the other commit")
    ap.add_argument("--kernels", default=",".join(SOURCES),
                    help="comma-separated, from " + ", ".join(SOURCES))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    picked = args.kernels.split(",")
    if not picked or any(k not in SOURCES for k in picked):
        ap.error(f"--kernels takes names from {', '.join(SOURCES)}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build

    srcs = {(side, name): root / SOURCES[name]
            for side, root in (("this", ROOT), ("other", args.parent))
            for name in picked}
    build.build(list(srcs.values()))
    libs = {key: load(build, src) for key, src in srcs.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    rows = []
    for q in SQUARINGS if "minplus" in picked else ():
        d = cs.rand_dist(torch, gen, (q, q), 0.9)
        d.fill_diagonal_(0.0)
        calls = {side: minplus_call(torch, libs[(side, "minplus")])
                 for side in ("this", "other")}
        same = torch.equal(plus_zero_bits(torch, calls["this"](d, d)),
                           plus_zero_bits(torch, calls["other"](d, d)))
        inputs, from_hbm = cs.cold_inputs((d, d), 2 * d.numel() * 4)
        ms = in_turns(torch, cs, calls, inputs, 20, 20)
        rows.append({"kernel": "minplus_tiled", "shape": [q, q, q],
                     "inf_share": 0.9, "bitwise_equal": same,
                     "inputs_from_hbm": from_hbm, "ms": ms})
        if not same:
            raise SystemExit(f"kernel_ab: minplus at q = {q} differs")
    for shape in FLASH_SHAPES if "flash" in picked else ():
        rows.append(flash_row(torch, cs, dev, libs, shape))
        torch.cuda.empty_cache()
    if "sharded_join" in picked:
        rows += sharded_join_rows(torch, cs, dev,
                                  libs[("other", "sharded_join")])
    result = {"tool": "kernel_ab", "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "parent": str(args.parent),
              "timer": "device ms per call, CUDA-graph replays between "
              "CUDA events, in turns other, this, this, other",
              "rows": rows}
    print(json.dumps(result), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
