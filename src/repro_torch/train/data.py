"""Deterministic synthetic data pipeline.

Batches are a pure function of (seed, step) so a restarted/elastically
rescaled job consumes the identical stream with no data-loader state to
checkpoint — the fault-tolerance contract the training loop relies on.
A background prefetch thread hides generation latency (straggler
mitigation on the input side).

A copy of the JAX package's ``train/data.py`` (the same numpy batches,
byte for byte, for every frontend), plus ``to_device``, which puts a
batch's arrays on a torch device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0


def synthetic_batch(cfg: ArchConfig, dcfg: DataConfig, step: int) -> dict:
    """Markov-ish token stream: cheap, deterministic, non-degenerate."""
    rng = np.random.default_rng(
        np.random.SeedSequence([dcfg.seed, step]))
    b, s = dcfg.global_batch, dcfg.seq_len
    if cfg.frontend == "frame":
        frames = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, size=(b, s))
        return {"frames": frames, "labels": labels.astype(np.int32)}
    base = rng.integers(0, cfg.vocab_size, size=(b, s))
    drift = np.cumsum(rng.integers(0, 3, size=(b, s)), axis=1)
    tokens = ((base + drift) % cfg.vocab_size).astype(np.int32)
    out = {"tokens": tokens[:, :s],
           "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}
    if cfg.frontend == "patch":
        out["patches"] = rng.normal(
            size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def to_device(batch: dict, device: torch.device | str) -> dict:
    """The batch's numpy arrays as tensors on ``device`` (the same dtypes
    and values)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class PrefetchingLoader:
    """Iterator yielding (step, batch) with a lookahead thread."""

    def __init__(self, cfg: ArchConfig, dcfg: DataConfig,
                 start_step: int = 0, lookahead: int = 2):
        self.cfg, self.dcfg = cfg, dcfg
        self.step = start_step
        self.q: queue.Queue = queue.Queue(maxsize=lookahead)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            batch = synthetic_batch(self.cfg, self.dcfg, s)
            self.q.put((s, batch))
            s += 1

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
