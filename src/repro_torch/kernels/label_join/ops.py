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
off anyway.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernel import gather_join
from .ref import INF_I32, join_sparse_ref

__all__ = ["INF_I32", "join", "join_with_bound", "join_quantized",
           "join_sparse", "join_gathered", "join_quantized_gathered",
           "join_sparse_gathered", "bound_gathered", "upload"]


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


def _ids(ids: np.ndarray, rows: int, device: torch.device) -> torch.Tensor:
    """Host row ids → int64 tensor on ``device``; every id must index
    one of ``rows`` rows."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if len(ids) and (ids.min() < 0 or ids.max() >= rows):
        raise IndexError(f"row id out of range [0, {rows})")
    return torch.from_numpy(ids).to(device)


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
    rs = _ids(ss, table.shape[0], table.device)
    rt = _ids(ts, table.shape[0], table.device)
    return gather_join(table, rs, table, rt).cpu().numpy()


def join_quantized_gathered(table, ss: np.ndarray, ts: np.ndarray, *,
                            sentinel: int, scale: float) -> np.ndarray:
    """Quantized twin of ``join_gathered``: the table holds 16-bit
    codes."""
    table = _table(table)
    qn = len(ss)
    if qn == 0 or table.shape[1] == 0:
        return np.full(qn, np.inf, dtype=np.float32)
    rs = _ids(ss, table.shape[0], table.device)
    rt = _ids(ts, table.shape[0], table.device)
    return gather_join(table, rs, table, rt,
                       quant=(sentinel, scale)).cpu().numpy()


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
