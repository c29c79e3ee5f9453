"""Training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b --smoke
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
        --steps 100 --seq 512 --batch 1 --ckpt build/ckpt

The port of the JAX package's ``launch/train.py``, with its flags and
``--device`` (default: the CUDA card; ``--device cpu`` runs on the host,
with ``--smoke`` for a config small enough for it). ``--smoke`` runs the
reduced config; otherwise the full config (random weights from seed 0).
The loop is the fault-tolerant one: periodic async checkpoints,
restore-and-replay on failure, straggler logging.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs.base import get_config, get_smoke_config
from ..device import resolve_device
from ..models.lm import init_params
from ..train.data import DataConfig
from ..train.loop import LoopConfig, run_training
from ..train.optimizer import OptimizerConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    print(f"{cfg.name}: {cfg.param_count():,} params, on {dev}")
    oc = OptimizerConfig(peak_lr=args.lr, warmup_steps=max(5, args.steps // 10),
                         total_steps=args.steps)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch)
    lc = LoopConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                    checkpoint_dir=args.ckpt)
    st = run_training(
        cfg, oc, dcfg, lc,
        lambda: init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev),
        n_micro=args.micro, device=dev)
    ran = (f"; loss {st.losses[0]:.3f} -> {st.losses[-1]:.3f}"
           if st.losses else " (nothing left to run)")
    print(f"finished at step {st.step}{ran}")


if __name__ == "__main__":
    main()
