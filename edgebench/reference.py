"""The plain reference: shortest-path distances over the benchmark's own
network and weights, in plain PyTorch (frozen).

It imports nothing of the program and takes nothing the program made: it
reads the ``RoadNetwork`` (and the weights) that ``network`` and
``workload`` drew from the seed, and works every distance out again by
Bellman–Ford over the arcs, many sources at a time, on whatever device it
is given. Weights are small integers, so float32 sums are exact and every
answer of an exact system equals the reference bit for bit.

``cross_join`` answers cross-district queries from the distances of the
border vertices alone: every path between two districts passes through a
vertex with an arc that leaves its district, so ``d(s, t) = min_b
d(b, s) + d(b, t)`` over those vertices. That lets one Bellman–Ford from
the q border vertices check any number of cross-district answers.
"""
from __future__ import annotations

import numpy as np
import torch

from .network import RoadNetwork


def ell(net: RoadNetwork, weights: np.ndarray | None,
        device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbour table ``(n, maxdeg)`` and its weights; short rows are
    padded with the vertex itself at +inf."""
    n = net.num_vertices
    w = net.weights if weights is None else np.asarray(weights, np.float32)
    deg = np.diff(net.indptr).astype(np.int64)
    width = max(1, int(deg.max()))
    nbr = np.repeat(np.arange(n, dtype=np.int64)[:, None], width, axis=1)
    wt = np.full((n, width), np.inf, dtype=np.float32)
    src = net.arc_sources().astype(np.int64)
    slot = np.arange(net.num_arcs, dtype=np.int64) \
        - net.indptr[src].astype(np.int64)
    nbr[src, slot] = net.indices
    wt[src, slot] = w
    return (torch.from_numpy(nbr).to(device),
            torch.from_numpy(wt).to(device))


def distances_from(net: RoadNetwork, sources: np.ndarray,
                   weights: np.ndarray | None = None,
                   device: torch.device | str = "cpu",
                   table: tuple | None = None,
                   dtype: torch.dtype = torch.float32,
                   check_every: int = 8) -> torch.Tensor:
    """``(n, len(sources))`` distances in ``dtype``, column j from
    ``sources[j]``, on ``device``. Relaxes every arc until a pass changes
    nothing."""
    device = torch.device(device)
    nbr, wt = table if table is not None else ell(net, weights, device)
    wt = wt.to(dtype)
    n = net.num_vertices
    src = torch.as_tensor(np.asarray(sources, dtype=np.int64),
                          device=device)
    d = torch.full((n, len(src)), float("inf"), dtype=dtype,
                   device=device)
    d[src, torch.arange(len(src), device=device)] = 0.0
    step = 0
    while True:
        before = d.clone() if step % check_every == 0 else None
        for k in range(nbr.shape[1]):
            torch.minimum(d, d.index_select(0, nbr[:, k]) + wt[:, k, None],
                          out=d)
        step += 1
        if before is not None and torch.equal(before, d):
            return d


def border_distances(net: RoadNetwork, device: torch.device | str = "cpu",
                     weights: np.ndarray | None = None) -> torch.Tensor:
    """``(n, q)`` distances from every border vertex."""
    return distances_from(net, net.border_vertices(), weights=weights,
                          device=device)


def cross_join(border_dist: torch.Tensor, ss: np.ndarray, ts: np.ndarray,
               block: int = 1 << 14, dtype: torch.dtype = torch.float32
               ) -> np.ndarray:
    """Cross-district distances ``min_b d(b, s) + d(b, t)``; ``dtype``
    is the precision of the rows and the sums (float32 is exact here)."""
    dev = border_dist.device
    rows = border_dist.to(dtype)
    out = np.empty(len(ss), dtype=np.float32)
    for lo in range(0, len(ss), block):
        s = torch.from_numpy(np.asarray(ss[lo:lo + block], np.int64)).to(dev)
        t = torch.from_numpy(np.asarray(ts[lo:lo + block], np.int64)).to(dev)
        out[lo:lo + block] = (rows[s] + rows[t]).amin(dim=1).float() \
            .cpu().numpy()
    return out


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """The numbers judged: answers that differ from the reference, and
    the widest gap between an answer and its reference distance."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    diff = got != want
    with np.errstate(invalid="ignore"):
        gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    gap = np.where(diff, np.nan_to_num(gap, nan=np.inf, posinf=np.inf), 0.0)
    return {"checked": int(len(got)), "wrong": int(diff.sum()),
            "max_gap": float(gap.max()) if len(gap) else 0.0}
