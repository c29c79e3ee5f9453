"""Districts → shards: the edge deployment mapped onto an ``EdgeMesh``.

The port of ``repro.edge.sharded_oracle``. Every logical shard of an
edge mesh plays the role of a group of edge servers: it owns a *blocked*
slice of the combined hub-aligned district tables — ``dpd = ceil(m / E)``
districts per shard, every district densified to the same ``(kmax, W)``
layout — plus the border-label table B, replicated at its natural width
q or row-sharded (``ceil(n/E)`` rows a shard). The replicated engine
(``edge.engine``) is the one-shard case with ``combined=True``:
districts and B in one buffer.

``EdgeMesh`` is the port's form of the reference's 1-D ``edge`` mesh: E
logical shards, each with a torch device (on one card all of them), and
the MIN-reduce seam that stands in for ``jax.lax.pmin`` over the axis.
On one process the seam is an elementwise ``torch.minimum`` fold over
the shards' partials, written as one method so that a process group's
``all_reduce(op=MIN)`` can take its place.

A query batch is preprocessed on the host into (owner, row)
coordinates:

  rule 1/2 — owner = the device holding district d, row = the query
             endpoint's slot in that device's table block
             (``slot(d)·kmax + local``);
  rule 3   — owner = the device holding the *source* district, row =
             the vertex's row in B (offset past the district block).

then one dispatch answers the whole mixed-rule batch: each shard runs
the sharded gather-join kernel over [its district block; B], masking
lanes it does not own to +inf, and the MIN seam assembles the answer
vector (``make_sharded_query_fn``). This is the §4.2 routing with a
MIN-reduce instead of RPCs.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.labels import BorderLabels
from ..core.local_index import LocalIndex
from ..core.partition import Partition
from ..core.quantize import QuantSpec
from ..device import resolve_device
from ..kernels.label_join import ops as lj

INF = np.float32(np.inf)


@dataclass
class ShardedOracleData:
    """Host-packed blocked layout. ``district_table`` rows are grouped by
    district (``kmax`` rows each) so slicing the leading axis into E equal
    chunks hands device d exactly districts ``d·dpd .. d·dpd+dpd-1``.
    ``btable`` is stored at its NATURAL width q (not the combined W)
    except in the ``combined=True`` single-buffer layout; with
    ``border_sharded`` its rows are padded to ``ceil(n/E)·E`` so the
    leading axis shards evenly over the mesh too."""
    district_table: np.ndarray | None  # (m_pad·kmax, W) — shardable
    btable: np.ndarray | None   # (n_pad, q) — center table B
    local_pos: np.ndarray       # (n,) int64: global id → local slot
    assignment: np.ndarray      # (n,) int64: global id → district
    kmax: int
    num_devices: int
    num_districts: int
    # layout scalars snapshotted at pack time so the big host arrays can
    # be released once the tables are device-resident (routing and the
    # bytes accounting never touch the arrays again)
    districts_per_device: int = field(init=False)
    width: int = field(init=False)
    border_width: int = field(init=False)
    border_rows_per_device: int = field(init=False)
    num_vertices: int = field(init=False)
    itemsize: int = field(init=False)
    # single-allocation [districts; B] buffer (combined=True packing);
    # district_table/btable are views into it — the replicated engine
    # ships this to the device without a second host copy
    combined_table: np.ndarray | None = None
    # True ⇒ btable is a row-sharded (n_pad, q) layout: device d owns
    # rows d·rpd .. d·rpd+rpd-1 (rpd = ceil(n/E))
    border_sharded: bool = False
    # set ⇒ tables hold quantized integer codes (core.quantize); the
    # device joins are handed quant.key() and answers stay float32
    quant: QuantSpec | None = None
    # district → (device, in-device slot) routing table.  None = the
    # blocked default (district i on device i // dpd at slot i % dpd);
    # a migration-produced placement packs each device's resident
    # districts into slots 0..count-1 instead.  Routing-only state: it
    # survives release_host_tables.
    device_of: np.ndarray | None = None    # (m,) int64
    slot_of: np.ndarray | None = None      # (m,) int64

    def __post_init__(self):
        self.districts_per_device = (self.district_table.shape[0]
                                     // self.kmax // self.num_devices)
        self.width = self.district_table.shape[1]
        self.border_width = self.btable.shape[1]
        self.border_rows_per_device = (
            self.btable.shape[0] // self.num_devices
            if self.border_sharded else self.btable.shape[0])
        self.num_vertices = len(self.local_pos)
        self.itemsize = int(self.district_table.dtype.itemsize)
        if self.device_of is None:
            ids = np.arange(self.num_districts, dtype=np.int64)
            self.device_of = ids // self.districts_per_device
            self.slot_of = ids % self.districts_per_device

    @property
    def cross_base(self) -> int:
        """Per-device row offset of B inside [district block; B]."""
        return self.districts_per_device * self.kmax

    def release_host_tables(self) -> None:
        """Drop the packed host copies (an engine calls this after
        the upload — keeping them would hold the FULL combined table
        in host RAM per engine instance, which is exactly the footprint
        sharding exists to avoid)."""
        self.district_table = None
        self.btable = None
        self.combined_table = None

    def district_bytes_per_device(self) -> int:
        return (self.districts_per_device * self.kmax * self.width
                * self.itemsize)

    def border_bytes_per_device(self) -> int:
        """Resident bytes of B per device: all ``n·q`` entries when
        replicated (natural width), a ``ceil(n/E)·q`` row-slice when
        sharded — times the storage itemsize (4 for float32, 2
        quantized)."""
        return (self.border_rows_per_device * self.border_width
                * self.itemsize)

    def bytes_per_device(self) -> int:
        """Resident bytes per device: district block + this device's
        share of B (see the memory model in docs/ARCHITECTURE.md)."""
        return (self.district_bytes_per_device()
                + self.border_bytes_per_device())


def pack_tables(btable: np.ndarray, locals_: list[LocalIndex],
                assignment: np.ndarray, num_devices: int, *,
                combined: bool = False,
                shard_border: bool = False,
                quant: QuantSpec | None = None,
                placement: np.ndarray | None = None) -> ShardedOracleData:
    """Blocked packing of the combined hub-aligned table: districts padded
    to ``m_pad = dpd·E`` so the leading axis shards evenly, every district
    table densified to (kmax, W) with the same inf padding the replicated
    engine uses (padding lanes never win a min-plus join).

    B is kept at its natural width q: the device join pads the few
    *gathered* rows per batch to W instead of storing ``n·(W−q)`` dead
    lanes. ``shard_border=True`` additionally row-pads B to
    ``n_pad = rpd·E`` so it shards evenly over the mesh (device d owns
    rows ``d·rpd .. d·rpd+rpd-1``).

    ``combined=True`` lays districts and B out in ONE allocation (the
    replicated engine's device layout, B padded to W there) so no second
    host copy is needed to stack them; ``district_table``/``btable``
    become views.

    ``quant`` switches the storage dtype: tables hold ``core.quantize``
    codes (2 bytes/entry) and every padding element is the dtype's
    sentinel — the quantized image of +inf, so padding lanes still
    never win the join.

    ``placement`` is an explicit district → device table (the
    repartitioner's ``EdgePlacement.host_of`` with one host per device);
    each device's resident districts are packed into its slots
    ``0..count-1`` and the block height becomes the *maximum* per-device
    district count.  ``None`` keeps the blocked default — bitwise
    identical to the same call before placements existed."""
    assert not (combined and shard_border), \
        "combined packing keeps B inside the single replicated buffer"
    n = len(assignment)
    m = len(locals_)
    if placement is None:
        dpd = -(-m // num_devices)
        device_of = slot_of = None          # blocked default, derived
        ids = np.arange(m, dtype=np.int64)
        base_dev, base_slot = ids // dpd, ids % dpd
    else:
        device_of = np.asarray(placement, dtype=np.int64)
        if device_of.shape != (m,):
            raise ValueError(f"placement must map all {m} districts")
        if len(device_of) and (device_of.min() < 0
                               or device_of.max() >= num_devices):
            raise ValueError("placement host ids must lie in "
                             f"[0, {num_devices})")
        counts = np.bincount(device_of, minlength=num_devices)
        dpd = max(1, int(counts.max()))
        slot_of = np.zeros(m, dtype=np.int64)
        for dev in range(num_devices):
            resident = np.nonzero(device_of == dev)[0]
            slot_of[resident] = np.arange(len(resident))
        base_dev, base_slot = device_of, slot_of
    m_pad = dpd * num_devices
    kmax = max(len(li.vertices) for li in locals_)
    q = btable.shape[1]
    width = max(kmax, q, 1)
    rows = m_pad * kmax
    if quant is None:
        dtype, fill = np.dtype(np.float32), INF
        enc = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    else:
        dtype, fill = quant.dtype, quant.dtype.type(quant.sentinel)
        enc = quant.quantize
    if combined:
        buf = np.full((rows + n, width), fill, dtype=dtype)
        table, bt = buf[:rows], buf[rows:]
        bt[:, :q] = enc(btable)
    else:
        buf = None
        table = np.full((rows, width), fill, dtype=dtype)
        if shard_border:
            n_pad = -(-n // num_devices) * num_devices
            bt = np.empty((n_pad, q), dtype=dtype)
            bt[:n] = enc(btable)
            bt[n:] = fill
        elif quant is None:
            # zero-copy when the caller's B is already f32-contiguous:
            # pack never mutates it and the engines upload + release
            bt = np.ascontiguousarray(btable, dtype=np.float32)
        else:
            bt = enc(btable)
    local_pos = np.zeros(n, dtype=np.int64)
    for i, li in enumerate(locals_):
        k = len(li.vertices)
        base = (base_dev[i] * dpd + base_slot[i]) * kmax
        table[base:base + k, :k] = enc(li.dense_table())
        local_pos[li.vertices] = np.arange(k, dtype=np.int64)
    return ShardedOracleData(table, bt, local_pos,
                             assignment.astype(np.int64), kmax,
                             num_devices, m, combined_table=buf,
                             border_sharded=shard_border, quant=quant,
                             device_of=device_of, slot_of=slot_of)


def prepare_queries(data: ShardedOracleData, ss: np.ndarray,
                    ts: np.ndarray) -> dict[str, np.ndarray]:
    """Host-side client/edge-server routing pass: one vectorized NumPy
    sweep emits each query's owning device and the two per-device row ids
    its gather-join reads (§4.2 rules collapsed into coordinates)."""
    ss = np.asarray(ss, dtype=np.int64)
    ts = np.asarray(ts, dtype=np.int64)
    ds = data.assignment[ss]
    cross = ds != data.assignment[ts]
    # routing reads the packed placement table (blocked default:
    # device i // dpd, slot i % dpd — identical coordinates to the
    # historical arithmetic)
    slot_base = data.slot_of[ds] * data.kmax
    rs = np.where(cross, data.cross_base + ss, slot_base + data.local_pos[ss])
    rt = np.where(cross, data.cross_base + ts, slot_base + data.local_pos[ts])
    return {"owner": data.device_of[ds], "rs": rs, "rt": rt}


def pack_for_mesh(part: Partition, bl: BorderLabels,
                  locals_: list[LocalIndex], num_devices: int, *,
                  shard_border: bool = False,
                  quant: QuantSpec | None = None) -> ShardedOracleData:
    """Paper-facing wrapper: pack a built index for an E-shard edge mesh."""
    return pack_tables(bl.table.astype(np.float32), locals_,
                       part.assignment, num_devices,
                       shard_border=shard_border, quant=quant)


@dataclass(frozen=True, eq=False)
class EdgeMesh:
    """E logical edge shards, shard d on ``devices[d]``, and the MIN seam
    over them (the reference's 1-D ``Mesh`` with one named axis)."""
    devices: tuple[torch.device, ...]
    axis: str = "edge"

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def pmin(self, partials: list[torch.Tensor]) -> torch.Tensor:
        """Elementwise minimum of the shards' partials, one each, on the
        first shard's device — the ``pmin`` over the axis. In one
        process it is a ``torch.minimum`` fold; across processes each
        rank would hold one partial and this is ``all_reduce(op=MIN)``."""
        if len(partials) != self.size:
            raise ValueError(f"pmin takes one partial a shard ({self.size})"
                             f", got {len(partials)}")
        dev = self.devices[0]
        return functools.reduce(torch.minimum,
                                (x.to(dev) for x in partials))


@functools.lru_cache(maxsize=None)
def _mesh_cache(num_devices: int, axis: str,
                device: torch.device) -> EdgeMesh:
    return EdgeMesh((device,) * num_devices, axis)


def default_edge_mesh(num_devices: int | None = None, axis: str = "edge",
                      device: torch.device | str | None = None) -> EdgeMesh:
    """1-D edge mesh of ``num_devices`` logical shards, all on ``device``
    (None = the CUDA card). ``num_devices=None`` counts the CUDA devices
    (1 on a one-card machine), 1 on the CPU. Cached: the same arguments
    give the same mesh object, so caches keyed on it stay warm."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if num_devices is None:
        num_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    if num_devices < 1:
        raise ValueError(f"an edge mesh needs >= 1 shard, got {num_devices}")
    return _mesh_cache(int(num_devices), axis, dev)


def place_tables(data: ShardedOracleData, mesh: EdgeMesh
                 ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Shard d's district block and share of B, each uploaded once to
    ``mesh.devices[d]``: rows ``d·dpd·kmax ..`` of the district table,
    and all of B (replicated) or its ``d``-th row-slice (row-sharded).
    On one card the device holds E times one shard."""
    e = data.num_devices
    if mesh.size != e:
        raise ValueError(f"tables packed for {e} shards, mesh has "
                         f"{mesh.size}")
    rows = data.districts_per_device * data.kmax
    rpd = data.border_rows_per_device
    blocks, btables = [], []
    for d, dev in enumerate(mesh.devices):
        blocks.append(lj.upload(data.district_table[d * rows:(d + 1) * rows],
                                dev))
        bt = data.btable[d * rpd:(d + 1) * rpd] if data.border_sharded \
            else data.btable
        btables.append(lj.upload(bt, dev))
    return blocks, btables


def make_sharded_query_fn(mesh: EdgeMesh, axis: str = "edge",
                          shard_border: bool = False,
                          quant: tuple[int, float] | None = None):
    """``fn(blocks, btables, owner, rs, rt)`` bound to ``mesh``: each
    shard's sharded gather-join over [block; B] + the MIN seam. With
    ``shard_border`` the btables are the row-sharded B and the touched
    rows are assembled by ragged gather + the seam first. ``quant`` is a
    ``QuantSpec.key()`` pair when the tables hold quantized codes.
    (PyTorch compiles nothing here, so unlike the reference's jitted
    programs there is nothing to cache.)"""
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    join = lj.join_sharded_border_gathered if shard_border \
        else lj.join_sharded_gathered
    return functools.partial(join, mesh=mesh, quant=quant)


def upload_queries(queries: dict[str, np.ndarray], mesh: EdgeMesh
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The prepared (owner, rs, rt) as int64 tensors on the mesh's first
    device (one copy; on one card every shard reads it)."""
    dev = mesh.devices[0]
    return tuple(torch.from_numpy(np.ascontiguousarray(
        queries[k], dtype=np.int64)).to(dev) for k in ("owner", "rs", "rt"))


def sharded_query(data: ShardedOracleData, mesh: EdgeMesh,
                  queries: dict[str, np.ndarray],
                  axis: str = "edge") -> np.ndarray:
    """One-shot deployment entry point (tests / notebooks): place the
    packed tables on the mesh and answer one prepared batch. Serving hot
    paths should hold a ``ShardedBatchedEngine`` instead, which keeps the
    tables device-resident across batches."""
    if len(queries["rs"]) == 0:
        return np.zeros(0, dtype=np.float32)
    fn = make_sharded_query_fn(
        mesh, axis, shard_border=data.border_sharded,
        quant=data.quant.key() if data.quant is not None else None)
    blocks, btables = place_tables(data, mesh)
    return fn(blocks, btables, *upload_queries(queries, mesh)).cpu().numpy()
