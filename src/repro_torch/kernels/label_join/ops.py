"""Public entry points of the query joins.

Mirrors the JAX package's ``kernels/label_join/ops.py`` for the serving
path of the port (anchors refer to PAPER.md / the source paper):

* ``join`` / ``join_gathered`` — Definition 1's 2-hop join λ(s,t,·) over
  dense hub-aligned rows; serves §4.2 rule 3 (cross-district via the
  border table B) and rules 1/2 over the densified district tables.
* ``join_sparse`` / ``join_sparse_gathered`` — the same join over padded
  sparse labels L_i; the §4.2 rule-1/2 path during rebuild windows.
  Plain torch ops (the reference computes it in XLA, outside any Pallas
  kernel).
* ``join_with_bound`` / ``bound_gathered`` — the fused λ + Local Bound
  (Definition 5) pass that certifies Theorem 3.
* ``join_sharded_gathered`` — the mesh-sharded §4.2 dispatch: district
  blocks sharded over the logical shards of an ``EdgeMesh``, the border
  table replicated at its natural width q. Where every shard lies on
  one device (``default_edge_mesh``), one launch of the sharded kernel
  serves the batch and writes the answers in lane order; across devices
  one launch a shard, then the mesh's MIN seam over the partials.
* ``join_sharded_border_gathered`` — the fully-sharded variant: B itself
  is row-sharded. On one device the kernel reads each touched B row in
  place in its owning slice; across devices the touched rows are
  assembled first by a ragged gather (plain torch, as the reference's
  XLA) and the MIN seam, then joined like the replicated case.
* ``join_partial_gathered`` — one edge server's scatter-gather partial:
  the dense join over rows the server assembled on its device (district
  block rows, own and peer border rows), float32 answers left there.
* ``join_quantized`` / ``join_quantized_gathered`` — the same joins over
  uint16/int16 ``core.quantize`` codes: the min runs in raw code units
  with one final ``· scale``, so a lossless spec serves bit-for-bit the
  float32 answers at half the bytes.

Every dense join goes through ``kernel.gather_join``: the CUDA kernel
for tensors on the card, its plain version for tensors on the CPU. The
``*_gathered`` entry points take a device-resident table (a torch
tensor; ``upload`` puts a host table on a device), row ids from the
host, and return host numpy. Unlike the reference they do not pad the batch to a multiple of
256: PyTorch does not retrace per shape, and padding lanes were sliced
off anyway. ``join_gathered`` and ``join_quantized_gathered`` range-check
both id arrays before either is uploaded, and mark their four steps as
profiler spans (``repro_torch.spans``): ``label_join.ids_check``,
``label_join.ids_upload``, ``label_join.launch`` and
``label_join.readback``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...spans import span
from .kernel import (MAX_SHARDS, gather_join, multi_shard_gather_join,
                     sharded_gather_join)
from .ref import INF_I32, join_sparse_ref, pad_value, storage16

__all__ = ["INF_I32", "join", "join_with_bound", "join_quantized",
           "join_sparse", "join_gathered", "join_quantized_gathered",
           "join_sparse_gathered", "bound_gathered", "upload",
           "join_partial_gathered",
           "join_sharded_gathered", "join_sharded_border_gathered",
           "assemble_border_rows"]


def upload(table: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """Copy a host label table to ``device`` as one contiguous tensor.
    uint16 codes travel as int16 bits (the kernels and plain versions
    read them back as unsigned from the uint16 sentinel)."""
    arr = np.ascontiguousarray(table)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    return torch.from_numpy(arr).to(device)


def _table(table) -> torch.Tensor:
    if not isinstance(table, torch.Tensor):
        raise TypeError("expected a torch.Tensor table (ops.upload puts a "
                        f"host table on a device), got {type(table).__name__}")
    return table


def _checked(ids: np.ndarray, rows: int) -> np.ndarray:
    """Host row ids as contiguous int64; every id must index one of
    ``rows`` rows."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if len(ids) and (ids.min() < 0 or ids.max() >= rows):
        raise IndexError(f"row id out of range [0, {rows})")
    return ids


def _ids(ids: np.ndarray, rows: int, device: torch.device) -> torch.Tensor:
    """Host row ids → int64 tensor on ``device``, range-checked."""
    return torch.from_numpy(_checked(ids, rows)).to(device)


def _serve_gathered(table: torch.Tensor, ss: np.ndarray, ts: np.ndarray,
                    quant: tuple[int, float] | None = None) -> np.ndarray:
    """One serving join of rows ``table[ss]`` / ``table[ts]``: both id
    arrays checked, then both uploaded, the kernel launched, the answers
    copied back; each step a profiler span (``repro_torch.spans``)."""
    with span("label_join.ids_check"):
        ss = _checked(ss, table.shape[0])
        ts = _checked(ts, table.shape[0])
    with span("label_join.ids_upload"):
        rs = torch.from_numpy(ss).to(table.device)
        rt = torch.from_numpy(ts).to(table.device)
    with span("label_join.launch"):
        out = gather_join(table, rs, table, rt, quant=quant)
    with span("label_join.readback"):
        return out.cpu().numpy()


def _identity(q: int, device: torch.device) -> torch.Tensor:
    return torch.arange(q, dtype=torch.int64, device=device)


def join(s_rows: torch.Tensor, t_rows: torch.Tensor) -> torch.Tensor:
    """Batched dense 2-hop join λ(s,t,B) over gathered label rows."""
    ids = _identity(s_rows.shape[0], s_rows.device)
    return gather_join(s_rows, ids, t_rows, ids)


def join_with_bound(s_rows: torch.Tensor, t_rows: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (λ, LB) — the Theorem-3 serving path during rebuilds."""
    ids = _identity(s_rows.shape[0], s_rows.device)
    return gather_join(s_rows, ids, t_rows, ids, with_lb=True)


def join_quantized(s_codes: torch.Tensor, t_codes: torch.Tensor, *,
                   sentinel: int, scale: float) -> torch.Tensor:
    """Dense 2-hop join over quantized label rows, float32 out."""
    ids = _identity(s_codes.shape[0], s_codes.device)
    return gather_join(s_codes, ids, t_codes, ids,
                       quant=(sentinel, scale))


def join_sparse(hs, ds, ht, dt) -> torch.Tensor:
    """Padded sparse-label join (local indexes), plain torch ops on the
    tensors' device."""
    return join_sparse_ref(hs, ds, ht, dt)


def join_gathered(table, ss: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Serving join over rows ``table[ss]`` / ``table[ts]`` of one
    device-resident float32 table, in one fused kernel launch."""
    table = _table(table)
    qn = len(ss)
    if qn == 0 or table.shape[1] == 0:
        return np.full(qn, np.inf, dtype=np.float32)
    return _serve_gathered(table, ss, ts)


def join_quantized_gathered(table, ss: np.ndarray, ts: np.ndarray, *,
                            sentinel: int, scale: float) -> np.ndarray:
    """Quantized twin of ``join_gathered``: the table holds 16-bit
    codes."""
    table = _table(table)
    qn = len(ss)
    if qn == 0 or table.shape[1] == 0:
        return np.full(qn, np.inf, dtype=np.float32)
    return _serve_gathered(table, ss, ts, quant=(sentinel, scale))


def join_partial_gathered(s_rows: torch.Tensor,
                          t_rows: torch.Tensor) -> torch.Tensor:
    """One edge server's scatter-gather partial: the dense 2-hop join
    over float32 label rows the caller already assembled on one device
    (district block rows for the server's local lanes, own and peer
    border rows, +inf-padded to the block's width, for its cross lanes),
    in one launch of the join kernel. A lane's answer depends only on
    its own two rows, so it is bit for bit the lane's value in the
    sharded engine. Returns the float32 ``(Q,)`` answers on the rows'
    device; +inf for zero-width rows."""
    s_rows, t_rows = _table(s_rows), _table(t_rows)
    if s_rows.shape[0] == 0 or s_rows.shape[1] == 0:
        return torch.full((s_rows.shape[0],), float("inf"),
                          dtype=torch.float32, device=s_rows.device)
    return join(s_rows, t_rows)


def join_sparse_gathered(hubs, dists, ss: np.ndarray,
                         ts: np.ndarray) -> np.ndarray:
    """Rule-1/2 join over a district's padded sparse labels (local-id
    queries); the labels may live on any device."""
    hubs, dists = _table(hubs), _table(dists)
    qn = len(ss)
    if qn == 0:
        return np.zeros(0, dtype=np.float32)
    rs = _ids(ss, hubs.shape[0], hubs.device)
    rt = _ids(ts, hubs.shape[0], hubs.device)
    out = join_sparse(hubs[rs], dists[rs], hubs[rt], dists[rt])
    return out.cpu().numpy().astype(np.float32)


def bound_gathered(border_dist, ss: np.ndarray,
                   ts: np.ndarray) -> np.ndarray:
    """Theorem-3 serving certificate: LB[i] = min_b bd[ss[i]] + min_b'
    bd[ts[i]] from the fused join-with-bound kernel (its λ output, the
    via-one-border upper bound, is discarded here)."""
    border_dist = _table(border_dist)
    qn = len(ss)
    if qn == 0 or border_dist.shape[1] == 0:
        return np.full(qn, np.inf, dtype=np.float32)
    rs = _ids(ss, border_dist.shape[0], border_dist.device)
    rt = _ids(ts, border_dist.shape[0], border_dist.device)
    _, lb = gather_join(border_dist, rs, border_dist, rt, with_lb=True)
    return lb.cpu().numpy()


def _one_call(mesh) -> bool:
    """Whether one launch can serve a batch on ``mesh``: every shard on
    one device (a kernel cannot read another card's tables) and no more
    shards than the kernel's table holds."""
    return len(set(mesh.devices)) == 1 and mesh.size <= MAX_SHARDS


def join_sharded_gathered(blocks: list[torch.Tensor],
                          btables: list[torch.Tensor], owner: torch.Tensor,
                          rs: torch.Tensor, rt: torch.Tensor, *, mesh,
                          quant: tuple[int, float] | None = None
                          ) -> torch.Tensor:
    """Mesh-sharded serving join, B replicated. ``blocks[d]`` is shard
    d's slice of the district tables (width W) and ``btables[d]`` its
    copy of the border table at its natural width q ≤ W, both on
    ``mesh.devices[d]``; ``owner``/``rs``/``rt`` are the host routing
    pass's coordinates (row ids ≥ ``blocks[d].shape[0]`` read B). With
    every shard on one device, one launch of the sharded kernel joins
    each lane on its owner's tables and writes the answer vector in lane
    order (the reference's ``pmin`` over the axis: one shard owns each
    lane). Across devices each shard joins the lanes it owns — one
    launch a shard — and the mesh's MIN seam (``mesh.pmin``) assembles
    the answers.

    With ``quant=(sentinel, scale)`` the tables hold ``core.quantize``
    codes; the answers are float32 either way."""
    if _one_call(mesh):
        dev = blocks[0].device
        return multi_shard_gather_join(blocks, btables, owner.to(dev),
                                       rs.to(dev), rt.to(dev), quant=quant)
    partials = []
    for d, (block, btable) in enumerate(zip(blocks, btables)):
        dev = block.device
        partials.append(sharded_gather_join(
            block, btable, owner.to(dev), d, rs.to(dev), rt.to(dev),
            quant=quant))
    return mesh.pmin(partials)


def _unsigned_order(codes: torch.Tensor,
                    quant: tuple[int, float] | None) -> torch.Tensor:
    """uint16 codes are stored as int16 bits, which a signed minimum
    orders 0x8000–0xFFFF below 0: flipping the sign bit maps unsigned
    order onto signed order (and flips back)."""
    if quant is None or quant[0] != 0xFFFF:
        return codes
    return torch.bitwise_xor(codes, -0x8000)


def assemble_border_rows(bshards: list[torch.Tensor], rs: torch.Tensor,
                         rt: torch.Tensor, cross_base: int, *, mesh,
                         quant: tuple[int, float] | None = None
                         ) -> torch.Tensor:
    """The row-sharded B's touched rows, assembled: each shard gathers
    the rows it owns of row ids ``rs`` then ``rt`` (ids ≥ ``cross_base``
    mean row ``id - cross_base`` of B; the other lanes get the min
    identity: +inf, or the sentinel for codes), and ONE (2·batch, q) MIN
    seam over the shards leaves every touched row — s rows first, then
    t rows. Plain torch, as the reference's ragged gather is XLA; for
    uint16 codes the seam compares unsigned (``_unsigned_order``)."""
    rows_pd = bshards[0].shape[0]   # = ceil(n/E) ≥ 1 whenever n ≥ 1
    both_rows = torch.cat([rs, rt])
    parts = []
    for d, bshard in enumerate(bshards):
        bshard = storage16(bshard)
        rows = both_rows.to(bshard.device)
        local = rows < cross_base
        gid = torch.where(local, 0, rows - cross_base)
        own = (~local) & (gid // rows_pd == d)
        vals = bshard[torch.where(own, gid % rows_pd, 0)]
        parts.append(_unsigned_order(
            torch.where(own[:, None], vals, pad_value(quant, bshard)),
            quant))
    return _unsigned_order(mesh.pmin(parts), quant)


def assembled_row_ids(rs: torch.Tensor, rt: torch.Tensor, cross_base: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row ids that point query i's border rows at the assembled buffer
    of ``assemble_border_rows``: row i (s side) and row Q + i (t side),
    offset past the block as every border id is; block ids stay."""
    lanes = torch.arange(rs.shape[0], dtype=torch.int64, device=rs.device)
    return (torch.where(rs < cross_base, rs, cross_base + lanes),
            torch.where(rt < cross_base, rt, cross_base + rs.shape[0] + lanes))


def join_sharded_border_gathered(blocks: list[torch.Tensor],
                                 bshards: list[torch.Tensor],
                                 owner: torch.Tensor, rs: torch.Tensor,
                                 rt: torch.Tensor, *, mesh,
                                 quant: tuple[int, float] | None = None
                                 ) -> torch.Tensor:
    """Fully-sharded serving join: like ``join_sharded_gathered`` but
    the border table is ROW-SHARDED too — ``bshards[d]`` is shard d's
    ``ceil(n/E)`` row-slice of B at natural width q. Row ids keep the
    replicated convention (≥ ``blocks[d].shape[0]`` means "row v of B").
    With every shard on one device, one launch of the sharded kernel
    reads row v in place, row ``v % ceil(n/E)`` of slice
    ``v // ceil(n/E)`` — the row the reference's ragged gather and
    ``pmin`` assemble — and writes the answers in lane order. Across
    devices the touched B rows are assembled first
    (``assemble_border_rows``: ragged gather + the MIN seam) and the ids
    pointed at them (``assembled_row_ids``); then one sharded-kernel
    launch a shard joins its lanes against them, and the seam assembles
    the answers."""
    if _one_call(mesh):
        dev = blocks[0].device
        return multi_shard_gather_join(
            blocks, bshards, owner.to(dev), rs.to(dev), rt.to(dev),
            rows_per_border_shard=bshards[0].shape[0], quant=quant)
    cross_base = blocks[0].shape[0]
    assembled = assemble_border_rows(bshards, rs, rt, cross_base,
                                     mesh=mesh, quant=quant)
    rs, rt = assembled_row_ids(rs, rt, cross_base)
    partials = []
    for d, block in enumerate(blocks):
        dev = block.device
        partials.append(sharded_gather_join(
            block, assembled.to(dev), owner.to(dev), d, rs.to(dev),
            rt.to(dev), quant=quant))
    return mesh.pmin(partials)
