"""Serving launcher CLI — batched autoregressive decode demo.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
        --tokens 32 --batch 4

Runs on the CUDA card; ``--device cpu`` runs on the host (with
``--smoke`` for a config small enough for it). Weights are random,
drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs.base import get_config, get_smoke_config
from ..device import resolve_device
from ..models.lm import init_cache, init_params
from ..train.train_step import make_serve_step


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.supports_decode():
        raise SystemExit(f"{cfg.name} is encoder-only — no decode step")
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    cache = init_cache(cfg, args.batch, args.max_len, dev)
    step = make_serve_step(cfg)

    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for i in range(args.tokens):
        logits, cache = step(params, cache, tok, i)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    tok.cpu()
    dt = time.perf_counter() - t0
    print(f"{cfg.name}: generated {args.tokens} tokens x batch "
          f"{args.batch} in {dt*1e3:.0f} ms "
          f"({args.tokens*args.batch/dt:,.1f} tok/s) on {dev}")


if __name__ == "__main__":
    main()
