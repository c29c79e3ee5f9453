#!/usr/bin/env python3
"""Time design variants of the sharded join's whole-batch kernel on one card.

    python3 tools/sharded_join_variants.py [--out FILE]

Builds ``tools/sharded_join_variants.cu`` (the lane of
``multi_shard_join_kernel`` with a 32-bit slice division, optionally
with packed 16-byte id records and a shard table staged in shared
memory) and times it against the port's kernel on float32 inputs of
``tools/kernel_ab.py``'s shapes (E = 8 at n = 4096 and at the center's
size, B replicated and row-sharded), each result held bit for bit
against the port's. Beside them, for the row-sharded shapes: the
port's kernel with one shared B for every shard (no slice lookup) and,
at the center's size, the replicated join over B (no owner) — the
floors the entry lookups stand between. Device ms per call from
CUDA-graph replays between CUDA events (``chip_smoke.device_ms``) over
copies of the inputs read from HBM, each variant timed twice in turns
(forward, then backward order). Prints one JSON object with the card's
name and power limit. Needs a CUDA device and ``nvcc``; imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tools" / "sharded_join_variants.cu"
# variant name → flags of repro_sharded_join_variant (bit 0 packed ids,
# bit 1 shared-memory table)
VARIANTS = {"div32": 0, "div32_packed": 1, "smem_div32": 2,
            "smem_div32_packed": 3}


def variant_call(torch, lib, kernel, flags: int, e: int, rows_pd):
    def call(*x):
        blocks, borders = list(x[:e]), list(x[e:2 * e])
        owner, rs, rt, rec = x[2 * e:2 * e + 4]
        out = torch.empty(owner.shape[0], device=owner.device)
        err = lib.repro_sharded_join_variant(
            flags, e, *kernel._shard_table(blocks, borders),
            blocks[0].shape[1], borders[0].shape[1], rows_pd or 0,
            owner.data_ptr(), rs.data_ptr(), rt.data_ptr(), rec.data_ptr(),
            owner.shape[0], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"repro_sharded_join_variant: error {err}")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sharded_join_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke as cs
    import kernel_ab as ab
    from repro_torch.kernels import build
    from repro_torch.kernels.label_join import kernel

    build.build([SOURCE, kernel.SOURCE])
    lib = ctypes.CDLL(str(build.library_path(SOURCE)))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    pp, p64 = ctypes.POINTER(p), ctypes.POINTER(i64)
    lib.repro_sharded_join_variant.argtypes = [
        ctypes.c_int, ctypes.c_int, pp, p64, pp, p64, i64, i64, i64, p, p, p,
        p, i64, p, p]
    lib.repro_sharded_join_variant.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    rows = []
    for shape in ab.JOIN_SHAPES:
        for row_sharded in (True, False):
            blocks, borders, ids = ab.join_inputs(torch, dev, gen, shape,
                                                  row_sharded, False)
            e = len(blocks)
            rows_pd = borders[0].shape[0] if row_sharded else None
            rec = torch.stack([x.int() for x in ids]
                              + [torch.zeros_like(ids[0]).int()],
                              1).contiguous()
            extra = ()

            def port(*x, rows_pd=rows_pd):
                return kernel.multi_shard_gather_join(
                    list(x[:e]), list(x[e:2 * e]), *x[2 * e:2 * e + 3],
                    rows_per_border_shard=rows_pd)

            calls = {"port": port}
            calls.update({name: variant_call(torch, lib, kernel, flags, e,
                                              rows_pd)
                          for name, flags in VARIANTS.items()})
            if row_sharded:
                whole = torch.cat(borders)
                base = blocks[0].shape[0]
                extra = (ids[1] - base, ids[2] - base)

                def shared(*x, whole=whole):
                    return kernel.multi_shard_gather_join(
                        list(x[:e]), [whole] * e, *x[2 * e:2 * e + 3])

                calls["port_one_shared_b"] = shared
                if shape[0] == "center":
                    def replicated(*x, whole=whole):
                        return kernel.gather_join(whole, x[-2], whole, x[-1])

                    calls["replicated_join"] = replicated
            inputs = (*blocks, *borders, *ids, rec, *extra)
            want = port(*inputs)
            for name, fn in calls.items():
                if name != "replicated_join" and not torch.equal(
                        fn(*inputs), want):
                    raise SystemExit(f"sharded_join_variants: {name} "
                                     f"differs at {shape[0]}")
            touched = min(sum(x.numel() * x.element_size() for x in inputs),
                          2 * shape[1] * shape[3] * 4)
            copies, from_hbm = cs.cold_inputs(inputs, touched)
            ms = {name: [] for name in calls}
            for turn in (list(calls), list(calls)[::-1]):
                for name in turn:
                    ms[name].append(cs.device_ms(torch, calls[name], copies,
                                                 20, 20))
            del copies
            rows.append({"shape": shape[0], "shards": e, "lanes": shape[1],
                         "row_sharded": row_sharded,
                         "inputs_from_hbm": from_hbm, "ms": ms})
            print(json.dumps(rows[-1]), flush=True)
    result = {"tool": "sharded_join_variants",
              "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "timer": "device ms per call, CUDA-graph replays between CUDA "
              "events, two turns (forward, backward order)", "rows": rows}
    print(json.dumps(result), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
