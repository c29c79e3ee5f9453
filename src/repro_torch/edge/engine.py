"""Steady-state batched serving engine: one kernel launch per batch.

The engine answers a whole batch with a single fused gather→join over
ONE combined label table resident on the device: the batch is
transformed once on the host (pure NumPy routing → row ids), then one
launch of the ``label_join`` kernel reads the two rows of every query
straight from the table and reduces them.

Layout: the m district tables L_i⁺ — each densified to the hub-aligned
``(k_i, k_i)`` form (slot j ≡ local vertex j, the same §5.1 layout
BorderLabels uses) — are stacked on top of the border table B, all
inf-padded to a common hub width W = max(kmax, q):

    row of vertex v for a rule-1/2 query = d(v)·kmax + local(v)
    row of vertex v for a rule-3  query = m·kmax + v

Because a 2-hop join over inf-padded rows ignores the padding lanes, one
join answers every routing rule at once; the engine never branches on
rule. The result is already consolidated — the row-id transform IS the
scatter.

The engine is a snapshot of one index version: the router rebuilds it
whenever the center pushes new shortcuts, and falls back to the bucketed
Theorem-3 path while any district's L_i⁺ is stale. The district-sharded
engines of the JAX package come with the sharded-layouts slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.local_index import LocalIndex
from ..core.quantize import QuantSpec
from ..device import resolve_device
from ..kernels.label_join import ops as lj
from .sharded_oracle import pack_tables, prepare_queries


class BatchedQueryEngine:
    """Vectorized §4.2 serving over a fixed index version.

    ``quant`` stores the combined table as ``core.quantize`` codes
    (half the resident bytes; bit-for-bit answers for a lossless
    spec). ``device`` holds the table (None = the CUDA device)."""

    def __init__(self, btable: np.ndarray, locals_: list[LocalIndex],
                 assignment: np.ndarray, quant: QuantSpec | None = None,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        # single-shard blocked packing == the combined replicated layout:
        # district rows d·kmax + local(v), then B at rows m·kmax + v
        self.data = pack_tables(btable, locals_, assignment, num_devices=1,
                                combined=True, quant=quant)
        self.quant = quant
        self._table = lj.upload(self.data.combined_table, self.device)
        self.data.release_host_tables()     # device copy is authoritative

    @property
    def table(self) -> torch.Tensor:
        """The combined device table (uint16 codes as int16 bits)."""
        return self._table

    def size_bytes(self) -> int:
        return int(self._table.numel() * self._table.element_size())

    def row_ids(self, ss: np.ndarray, ts: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
        """Host-side batch transform: §4.2 routing collapsed into combined-
        table row ids, one vectorized NumPy pass (the one-shard case of
        the mesh routing pass — every query is 'owned' by device 0)."""
        q = prepare_queries(self.data, ss, ts)
        return q["rs"], q["rt"]

    def query(self, ss: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Answer a batch; returns host float32 (so a caller's clock
        around it includes the device time)."""
        ss = np.asarray(ss, dtype=np.int64)
        ts = np.asarray(ts, dtype=np.int64)
        if len(ss) == 0:
            return np.zeros(0, dtype=np.float32)
        rs, rt = self.row_ids(ss, ts)
        if self.quant is None:
            return lj.join_gathered(self._table, rs, rt)
        sent, scale = self.quant.key()
        return lj.join_quantized_gathered(self._table, rs, rt,
                                          sentinel=sent, scale=scale)

    # QueryPlane conformance: the engine snapshot is the steady-state
    # execution plane of serve.service.DistanceService
    execute = query
