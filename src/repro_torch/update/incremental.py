"""The stateful builder behind ``ComputingCenter(builder="torch")``.

Counterpart of the JAX package's ``update/incremental.py``: one full
pipeline run (``core.torch_builder``) caches every stage's output as a
``BuildState``, the cache the delta-scoped repairs warm-start from. Only
``build_full`` is ported; ``apply_delta`` and ``apply_structural`` raise
until ROADMAP Queue 1 item 6 (updates) lands.
"""
from __future__ import annotations

import math

import torch

from ..core.graph import Graph
from ..core.labels import BorderLabels
from ..core.partition import Partition
from ..core.torch_builder import BuildState, build_border_labels_stages
from ..device import resolve_device

_NOT_PORTED = ("delta-scoped repair is not ported yet (ROADMAP Queue 1 "
               "item 6, updates); rebuild in full with build_full")


class IncrementalBuilder:
    """Stateful builder: each full pipeline run on ``device`` caches every
    stage's output in ``state``; ``timings`` holds the last run's seconds
    per step and its stage-A sweep count."""

    def __init__(self, *, prune: bool = True,
                 device: torch.device | str | None = None):
        self.prune = prune
        self.device = resolve_device(device)
        self.state: BuildState | None = None
        self.timings: dict = {}
        # squaring count after which the closure hit its bitwise
        # fixpoint (the warm-start hint of the next epoch's stage B)
        self._closure_depth = 0

    def build_full(self, g: Graph, part: Partition) -> BorderLabels:
        labels, self.state = build_border_labels_stages(
            g, part, prune=self.prune, device=self.device,
            timings=self.timings)
        self._closure_depth = self._max_closure_steps()
        return labels

    def _max_closure_steps(self) -> int:
        q = 0 if self.state is None else len(self.state.packed.border_ids)
        return max(1, math.ceil(math.log2(max(2, q))))

    def apply_delta(self, g_new: Graph, part: Partition, delta=None):
        raise NotImplementedError(_NOT_PORTED)

    def apply_structural(self, g_new: Graph, part: Partition, delta=None):
        raise NotImplementedError(_NOT_PORTED)
