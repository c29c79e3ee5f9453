#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s shape cells, flash rows and join rows
alone on one card.

    python3 tools/shape_cells.py [--cells NAME,...] [--flash NAME,...]
                                 [--join]

``--cells`` runs those cells of ``chip_smoke.SHAPE_CELLS`` (default: none)
through ``chip_smoke.phase_shapes``, with their host halves in
``chip_smoke.start_host_checks``' workers (started here, so a cell may
wait for its host half longer than in the whole script); ``--flash``
times those rows of ``chip_smoke.FLASH_LONG`` through
``chip_smoke.phase_flash_times``; ``--join`` runs
``chip_smoke.half_join_rows`` on seeded tables of the engine's and rule
3's shapes (4096 x 256 of 8192 rows, 65 536 x 96 of 102 400 rows). Each
result is printed as one JSON line, as the whole script prints it.
Needs a CUDA device and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="")
    ap.add_argument("--flash", default="")
    ap.add_argument("--join", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("shape_cells: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.label_join import kernel, ref
    from repro_torch.launch import mesh as hw
    cs.PEAK_BYTES_PER_S, cs.PEAK_F32_OPS_PER_S, \
        cs.PEAK_BF16_TENSOR_FLOPS_PER_S = (hw.HBM_BW, hw.PEAK_FLOPS_F32,
                                           hw.PEAK_FLOPS_BF16)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cells = [c for c in args.cells.split(",") if c]
    flash = [f for f in args.flash.split(",") if f]
    unknown = [c for c in cells if c not in cs.SHAPE_CELLS] + [
        f for f in flash if f not in {r[0] for r in cs.FLASH_LONG}]
    if unknown:
        ap.error(f"unknown cells or flash rows: {unknown}")
    logs = build.build([kernel.SOURCE, *fa.SOURCES])
    dev = torch.device("cuda")
    errs = {"flash_attention": 0.0}
    for name in list(cs.SHAPE_CELLS):
        if name not in cells:
            del cs.SHAPE_CELLS[name]
    cs.TRAIN_TIGHT_HOST = ()
    pending = cs.start_host_checks() if cells else {}
    if args.join:
        rng = np.random.default_rng(0)
        shapes = {}
        for key, (n, w, q) in {"engine_f32": (8192, 256, 4096),
                               "rule3_f32_q65536": (102400, 96,
                                                    65536)}.items():
            table = torch.from_numpy(rng.uniform(0.5, 50, (n, w)).astype(
                np.float32)).to(dev)
            shapes[key] = (table, rng.integers(0, n, q),
                           rng.integers(0, n, q), None)
        for row in cs.half_join_rows(torch, kernel, ref, shapes):
            print(json.dumps({k: v for k, v in row.items()
                              if k != "lanes_ms"}), flush=True)
    if flash:
        cs.FLASH_TIMED = []
        cs.FLASH_LONG = [r for r in cs.FLASH_LONG if r[0] in flash]
        for row in cs.phase_flash_times(torch, dev, logs, errs)["rows"]:
            print(json.dumps(row), flush=True)
    if cells:
        cs.phase_shapes(torch, dev, {}, pending, errs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
