"""Fault-tolerant training loop.

The port of the JAX package's ``train/loop.py``. Responsibilities beyond
calling train_step:
  * periodic async checkpoints (params + optimizer + step), resumable;
  * failure handling: a step that raises (injected in tests; a flaky host
    in production) triggers restore-from-last-checkpoint and replay —
    the deterministic data pipeline makes the replay exact;
  * straggler mitigation: steps exceeding ``deadline_s`` are recorded —
    metrics mark the event rather than stalling the job;
  * loss/throughput logging.

The step runs eagerly (the reference jits it) on ``device``; a step's
time is read once its loss is on the host (which waits for the stream,
the optimizer's updates included). ``adamw_update`` updates the state
in place, so a failure inside a step can leave it half updated; the
restore from the last checkpoint replaces all of it.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..distributed.checkpoint import (AsyncCheckpointer, latest_step,
                                      restore_checkpoint)
from .data import DataConfig, synthetic_batch, to_device
from .optimizer import OptimizerConfig, init_opt_state
from .train_step import make_train_step


@dataclass
class LoopConfig:
    total_steps: int = 50
    checkpoint_every: int = 20
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    deadline_s: float = 120.0
    max_restarts: int = 3
    log_every: int = 10


@dataclass
class LoopState:
    params: Any
    opt_state: Any
    step: int = 0
    losses: list = field(default_factory=list)
    straggler_events: int = 0
    restarts: int = 0


def run_training(cfg: ArchConfig, opt_cfg: OptimizerConfig,
                 dcfg: DataConfig, loop_cfg: LoopConfig,
                 init_params_fn: Callable[[], Any],
                 fault_hook: Callable[[int], None] | None = None,
                 n_micro: int = 1,
                 log: Callable[[str], None] = print,
                 device: torch.device | str | None = None) -> LoopState:
    """Train from the last checkpoint under ``loop_cfg.checkpoint_dir``
    (else from ``init_params_fn()``, whose params must be on ``device``;
    None: the card) up to ``loop_cfg.total_steps``; returns the final
    state (``losses`` holds the loss of every step this call ran)."""
    device = resolve_device(device)
    ckpt = AsyncCheckpointer(loop_cfg.checkpoint_dir)
    train_step = make_train_step(cfg, opt_cfg, n_micro=n_micro)

    def restored(step: int, restarts: int = 0) -> LoopState:
        tree = restore_checkpoint(loop_cfg.checkpoint_dir, step,
                                  device=device)
        return LoopState(tree["params"], tree["opt"], step=int(step),
                         restarts=restarts)

    start = latest_step(loop_cfg.checkpoint_dir)
    if start is not None:
        st = restored(start)
        log(f"resumed from checkpoint step {start}")
    else:
        params = init_params_fn()
        st = LoopState(params, init_opt_state(params))

    while st.step < loop_cfg.total_steps:
        step = st.step
        batch = to_device(synthetic_batch(cfg, dcfg, step), device)
        t0 = time.perf_counter()
        try:
            if fault_hook is not None:
                fault_hook(step)
            params, opt_state, metrics = train_step(st.params, st.opt_state,
                                                    batch)
            loss = float(metrics["loss"])
        except Exception as e:    # noqa: BLE001 — injected/hardware fault
            st.restarts += 1
            if st.restarts > loop_cfg.max_restarts:
                raise
            log(f"step {step} failed ({type(e).__name__}: {e}); "
                f"restoring last checkpoint")
            ckpt.wait()
            last = latest_step(loop_cfg.checkpoint_dir)
            if last is None:
                params = init_params_fn()
                st = LoopState(params, init_opt_state(params),
                               restarts=st.restarts)
            else:
                st = restored(last, st.restarts)
            continue
        dt = time.perf_counter() - t0
        if dt > loop_cfg.deadline_s:
            st.straggler_events += 1
            log(f"step {step}: straggler ({dt:.1f}s > "
                f"{loop_cfg.deadline_s}s deadline)")
        st.params, st.opt_state = params, opt_state
        st.losses.append(loss)
        st.step = step + 1
        if st.step % loop_cfg.log_every == 0:
            tok = dcfg.global_batch * dcfg.seq_len / dt
            log(f"step {st.step}: loss={st.losses[-1]:.4f} "
                f"({dt*1e3:.0f} ms, {tok:,.0f} tok/s)")
        if st.step % loop_cfg.checkpoint_every == 0:
            ckpt.save(st.step, {"params": st.params, "opt": st.opt_state})
    ckpt.wait()
    return st
