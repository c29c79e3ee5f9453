"""Batched decode scheduler.

Packs queued requests into fixed-shape decode batches (groups of
``batch_size`` with a shared position counter — slots advance in
lockstep; the batch refills when a group drains). Host-side
orchestration around ``decode_step``: prompts are left-padded and fed
one position at a time, then tokens are chosen greedily (argmax). The
port of the JAX package's ``serve/batcher.py``; the step runs eagerly
on ``device`` instead of under ``jit``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models.lm import decode_step, init_cache


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    submitted_s: float = field(default_factory=time.perf_counter)
    tokens: list[int] = field(default_factory=list)
    finished_s: float | None = None

    @property
    def latency_s(self) -> float:
        return (self.finished_s or time.perf_counter()) - self.submitted_s


class BatchedDecoder:
    """``params`` must already live on ``device`` (``None``: the card)."""

    def __init__(self, cfg: ArchConfig, params, batch_size: int = 4,
                 max_len: int = 128,
                 device: torch.device | str | None = None):
        if not cfg.supports_decode():
            raise ValueError(f"{cfg.name} is encoder-only")
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.device = resolve_device(device)
        self._step = lambda c, t, pos: decode_step(params, cfg, c, t, pos)
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _feed(self, cache, toks: np.ndarray, pos: int) -> np.ndarray:
        logits, _ = self._step(cache, torch.from_numpy(toks).to(
            self.device), pos)
        return logits[:, -1].argmax(dim=-1).cpu().numpy()

    def _run_group(self, group: list[Request]) -> None:
        b = self.batch_size
        cache = init_cache(self.cfg, b, self.max_len, self.device)
        plen = max(len(r.prompt) for r in group)
        prompts = np.zeros((b, plen), dtype=np.int32)
        for i, r in enumerate(group):
            prompts[i, plen - len(r.prompt):] = r.prompt  # left-pad
        pos = 0
        last = None
        for j in range(plen):                      # prompt feed
            last = self._feed(cache, prompts[:, j:j + 1], pos)
            pos += 1
        budget = max(r.max_new_tokens for r in group)
        budget = min(budget, self.max_len - plen - 1)
        for _ in range(budget):
            for i, r in enumerate(group):
                if len(r.tokens) < r.max_new_tokens:
                    r.tokens.append(int(last[i]))
            if all(len(r.tokens) >= r.max_new_tokens for r in group):
                break
            last = self._feed(cache, np.asarray(last, dtype=np.int32)
                              .reshape(b, 1), pos)
            pos += 1
        now = time.perf_counter()
        for r in group:
            r.finished_s = now
            if r.rid >= 0:          # padding never reaches ``completed``
                self.completed.append(r)

    def run(self) -> list[Request]:
        """Drain the queue in fixed-size groups."""
        while self.queue:
            group = [self.queue.popleft()
                     for _ in range(min(self.batch_size, len(self.queue)))]
            while len(group) < self.batch_size:   # pad with dummies
                group.append(Request(rid=-1, prompt=[0], max_new_tokens=1))
            self._run_group(group)
        return self.completed
