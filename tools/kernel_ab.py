#!/usr/bin/env python3
"""Time the port's kernels against another checkout's on one card.

    python3 tools/kernel_ab.py --parent DIR [--out FILE]

DIR is a checkout of another commit of this repository (for example the
parent, unpacked with ``git archive``). Both trees' ``minplus.cu`` and
``flash_attention_bf16.cu`` are built with the port's build flags and
loaded side by side; each kernel is then timed on the same inputs, in
turns (other, this, this, other), with CUDA-graph replays between CUDA
events (``chip_smoke.device_ms``), cycling through copies of the inputs
so that they come from HBM where they fit twice in the L2:

* the tiled min-plus product at the squarings of stage B above the fused
  closure's cap (q = 239, 448) and at q = 1024, 90 % +inf, each result
  held bit for bit against the other tree's (-0.0 read as +0.0);
* flash attention at Qwen3-4B's prefill shape, bf16, causal, held within
  the bf16 bound of ``chip_smoke.half_bound_ratio`` of the plain version.

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
SQUARINGS = (239, 448, 1024)
FLASH_SHAPE = (2, 4096, 32, 8, 128)     # B, S (= T), H, KV, hd; causal


def load(build, source: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.library_path(source)))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    if hasattr(lib, "repro_minplus"):
        lib.repro_minplus.argtypes = [p, p, p, i64, i64, i64, i64, p]
        lib.repro_minplus.restype = ctypes.c_int
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


def flash_call(torch, lib):
    def call(q, k, v):
        b, s, h, hd = q.shape
        out = torch.empty_like(q)
        strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3])
        err = lib.repro_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            k.shape[1], h, k.shape[2], hd, strides,
            math.log2(math.e) / math.sqrt(hd), 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"repro_flash_attention_bf16: error {err}")
        return out
    return call


def plus_zero_bits(torch, x):
    bits = x.view(torch.int32)
    return torch.where(bits == -2 ** 31, torch.zeros_like(bits), bits)


def in_turns(torch, cs, calls: dict, inputs: list, n: int, r: int) -> dict:
    """other, this, this, other: each side's two times."""
    out = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        out[side].append(cs.device_ms(torch, calls[side], inputs, n, r))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="checkout of the other commit")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build

    srcs = {(side, name): root / rel
            for side, root in (("this", ROOT), ("other", args.parent))
            for name, rel in (("minplus", MINPLUS), ("flash", FLASH))}
    build.build(list(srcs.values()))
    libs = {key: load(build, src) for key, src in srcs.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    rows = []
    for q in SQUARINGS:
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
    b, s, h, kv, hd = FLASH_SHAPE
    qkv = cs.flash_inputs(torch, dev, b, s, s, h, kv, hd, "bfloat16", 7)
    calls = {side: flash_call(torch, libs[(side, "flash")])
             for side in ("this", "other")}
    ratios = {side: cs.half_bound_ratio(calls[side](*qkv), *qkv, True)
              for side in calls}
    inputs, from_hbm = cs.cold_inputs(qkv, sum(
        x.numel() * x.element_size() for x in qkv))
    ms = in_turns(torch, cs, calls, inputs, 4, 3)
    rows.append({"kernel": "flash_attention_bf16", "shape": list(FLASH_SHAPE),
                 "causal": True, "bound_ratio": ratios,
                 "inputs_from_hbm": from_hbm, "ms": ms})
    if max(ratios.values()) > 1.0:
        raise SystemExit(f"kernel_ab: flash beyond its bound: {ratios}")
    result = {"tool": "kernel_ab", "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "parent": str(args.parent),
              "timer": "device ms per launch, CUDA-graph replays between "
              "CUDA events, in turns other, this, this, other",
              "rows": rows}
    print(json.dumps(result), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
