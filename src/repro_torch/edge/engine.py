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
Theorem-3 path while any district's L_i⁺ is stale. Two layouts trade
memory for the MIN seam — replicated (``BatchedQueryEngine``) and
district-sharded over the logical shards of an ``EdgeMesh``
(``ShardedBatchedEngine``, with B replicated or row-sharded).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.local_index import LocalIndex
from ..core.quantize import QuantSpec
from ..device import resolve_device
from ..kernels.label_join import ops as lj
from .sharded_oracle import (EdgeMesh, default_edge_mesh,
                             make_sharded_query_fn, pack_tables, place_tables,
                             prepare_queries, upload_queries)


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


class ShardedBatchedEngine:
    """Mesh-sharded §4.2 serving: the combined table split over the
    logical shards of an ``EdgeMesh`` instead of replicated.

    Same contract as ``BatchedQueryEngine.query`` (bit-for-bit identical
    answers) but each shard holds only its blocked slice of the district
    tables — ``ceil(m/E)`` districts — plus either the whole border table
    B at its natural width q (default) or, with ``shard_border=True``,
    only a ``ceil(n/E)`` row-slice of it. The host routing pass emits
    (owner, row) coordinates; a batch is one sharded-kernel launch a
    shard and the mesh's MIN seam (the B-sharded mode assembles the
    touched B rows with a ragged gather and the seam first). ``device``
    places the default mesh (None = the CUDA card) when no ``mesh`` is
    given. See ``edge.sharded_oracle``.
    """

    def __init__(self, btable: np.ndarray, locals_: list[LocalIndex],
                 assignment: np.ndarray, mesh: EdgeMesh | None = None,
                 axis: str = "edge",
                 device: torch.device | str | None = None,
                 shard_border: bool = False,
                 quant: QuantSpec | None = None,
                 placement: np.ndarray | None = None):
        if mesh is None:
            mesh = default_edge_mesh(axis=axis, device=device)
        elif device is not None:
            raise ValueError("pass a mesh or a device, not both: the "
                             "mesh's shards name their devices")
        self.mesh = mesh
        self.axis = axis
        self.num_devices = mesh.shape[axis]
        self.shard_border = shard_border
        self.quant = quant
        # placement = explicit district → shard table (the online
        # repartitioner's routing table); None = blocked default. The
        # pack pass copies each district's CACHED dense table into its
        # slot, so a migration re-densifies nothing.
        self.data = pack_tables(btable, locals_, assignment,
                                self.num_devices,
                                shard_border=shard_border, quant=quant,
                                placement=placement)
        self._fn = make_sharded_query_fn(
            mesh, axis, shard_border=shard_border,
            quant=quant.key() if quant is not None else None)
        self._blocks, self._btables = place_tables(self.data, mesh)
        # the full combined table must not stay resident on the host —
        # per-shard footprint ~1/E is the point of sharding
        self.data.release_host_tables()

    @property
    def blocks(self) -> list[torch.Tensor]:
        """Shard d's district block, on ``mesh.devices[d]``."""
        return self._blocks

    @property
    def btables(self) -> list[torch.Tensor]:
        """Shard d's copy (replicated) or row-slice (row-sharded) of B."""
        return self._btables

    def district_table_bytes_per_device(self) -> int:
        return self.data.district_bytes_per_device()

    def border_table_bytes_per_device(self) -> int:
        """Resident bytes of B on each shard: ``n·q`` entries
        replicated, ``ceil(n/E)·q`` row-sharded, times the storage
        itemsize (4 float32, 2 quantized)."""
        return self.data.border_bytes_per_device()

    def size_bytes(self) -> int:
        """Per-shard resident bytes (district block + B share)."""
        return self.data.bytes_per_device()

    def row_ids(self, ss: np.ndarray, ts: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host routing pass → (owner shard, per-shard s row, t row)."""
        q = prepare_queries(self.data, ss, ts)
        return q["owner"], q["rs"], q["rt"]

    def query(self, ss: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Answer a batch; returns host float32."""
        ss = np.asarray(ss, dtype=np.int64)
        ts = np.asarray(ts, dtype=np.int64)
        if len(ss) == 0:
            return np.zeros(0, dtype=np.float32)
        owner, rs, rt = upload_queries(prepare_queries(self.data, ss, ts),
                                       self.mesh)
        return self._fn(self._blocks, self._btables, owner, rs,
                        rt).cpu().numpy()

    # QueryPlane conformance (see BatchedQueryEngine)
    execute = query
