"""The staged Border-Labeling builder on a torch device — the port's
counterpart of the JAX package's ``core/jax_builder.py``.

The hierarchical pipeline of ``border_labeling.py`` on dense, padded
tensors:

  stage A  every district's border-to-vertex distances at once:
           districts padded to (m, kmax) vertices / (m, bmax) borders,
           solved by fused Bellman-Ford sweeps over all districts
           (``kernels/sssp_relax`` → the ``relax`` kernel), stopping at
           the first sweep that returns its input bit for bit;
  stage B  border-overlay closure by min-plus squaring (on the card
           one launch of the fused closure kernel up to q = 160, the
           tiled ``minplus`` kernel's squarings above);
  stage C  one batched min-plus product over the districts, stage A's
           (m, bmax, kmax) distances read k-major (the
           ``minplus_kmajor`` kernel, no transpose copy) → the full
           B' table, scattered into (n, q) by an order-free ``amin``;
  stage D  rank-ordered vectorized prune (a loop over hub slots in
           plain torch ops) — +inf doubles as the "not kept" mask.

Every entry point takes ``device`` (``None`` means the CUDA card). On
the card stages A–C run the hand-written CUDA kernels; on the CPU their
plain versions. Every stage output is bit for bit the reference's: the
products are exact and order-free (min of single float32 adds).

Padding convention: +inf edge weights / distances are absorbing, so
padded vertices and borders never affect real entries.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.minplus import ops as mp
from ..kernels.sssp_relax.ops import multi_source
from .graph import Graph
from .labels import BorderLabels
from .ordering import degree_order, rank_of
from .partition import Partition, borders_of

INF = np.float32(np.inf)


@dataclass
class PackedDistricts:
    """Dense, padded per-district arrays (host-side packing)."""
    adj: np.ndarray            # (m, kmax, kmax) f32 intra-district adjacency
    vertex_ids: np.ndarray     # (m, kmax) int32 global id, -1 pad
    border_pos: np.ndarray     # (m, bmax) int64 local border pos, -1 pad
    border_ids: np.ndarray     # (q,) int32 all borders, ascending
    border_slot: np.ndarray    # (m, bmax) int64 slot in border_ids, -1 pad
    kmax: int
    bmax: int

    @property
    def num_districts(self) -> int:
        return int(self.adj.shape[0])


def pack_districts(g: Graph, part: Partition) -> PackedDistricts:
    blists = borders_of(g, part)
    border_ids = np.sort(np.concatenate(
        blists or [np.zeros(0, dtype=np.int32)])).astype(np.int32)
    slot = -np.ones(g.num_vertices, dtype=np.int64)
    slot[border_ids] = np.arange(len(border_ids))
    dlists = part.districts()
    m = part.num_districts
    kmax = max(1, max((len(d) for d in dlists), default=1))
    bmax = max(1, max((len(b) for b in blists), default=1))
    adj = np.full((m, kmax, kmax), INF, dtype=np.float32)
    vertex_ids = -np.ones((m, kmax), dtype=np.int32)
    border_pos = -np.ones((m, bmax), dtype=np.int64)
    border_slot = -np.ones((m, bmax), dtype=np.int64)
    for i, vertices in enumerate(dlists):
        k = len(vertices)
        if k == 0:
            continue
        vertex_ids[i, :k] = vertices
        adj[i, :k, :k] = g.dense_adjacency(vertices)
        pos = -np.ones(g.num_vertices, dtype=np.int64)
        pos[vertices] = np.arange(k)
        b = blists[i]
        border_pos[i, :len(b)] = pos[b]
        border_slot[i, :len(b)] = slot[b]
    return PackedDistricts(adj, vertex_ids, border_pos, border_ids,
                           border_slot, kmax, bmax)


# ---------------------------------------------------------------------------
# stages (tensors on one device)
# ---------------------------------------------------------------------------

def stage_a_intra_distances(adj: torch.Tensor, border_pos: torch.Tensor,
                            iters: int) -> tuple[torch.Tensor, int]:
    """(m, bmax, kmax) distances from each district's borders, and the
    number of sweeps that ran (at most ``iters``; the result equals that
    of all ``iters``). Padded border rows start at +inf everywhere and
    stay +inf."""
    m, bmax = border_pos.shape
    kmax = adj.shape[1]
    init = torch.full((m, bmax, kmax), float("inf"), dtype=torch.float32,
                      device=adj.device)
    zi, ri = torch.nonzero(border_pos >= 0, as_tuple=True)
    init[zi, ri, border_pos[zi, ri]] = 0.0
    return multi_source(adj, init, iters)


def stage_b_overlay_closure(overlay: torch.Tensor) -> torch.Tensor:
    return mp.closure(overlay)


def stage_c_full_table(intra: torch.Tensor, border_slot: torch.Tensor,
                       closure_rows: torch.Tensor, vertex_ids: torch.Tensor,
                       n: int) -> torch.Tensor:
    """B'(v, b) = min_{b'∈B_j} d_{D_j}(b', v) + closure[b', b], scattered
    back into the (n, q) table."""
    q = closure_rows.shape[0]
    valid = border_slot >= 0
    crows = torch.where(valid[..., None],
                        closure_rows[border_slot.clamp(min=0)],
                        float("inf"))                     # (m, bmax, q)
    tables = mp.minplus_kmajor(intra, crows)              # (m, kmax, q)
    flat_ids = vertex_ids.reshape(-1).long()
    keep = flat_ids >= 0
    rows = flat_ids[keep][:, None].expand(-1, q)
    out = torch.full((n, q), float("inf"), dtype=torch.float32,
                     device=intra.device)
    return out.scatter_reduce_(0, rows, tables.reshape(-1, q)[keep], "amin")


def stage_d_prune(table: torch.Tensor, border_rows: torch.Tensor,
                  order: torch.Tensor) -> torch.Tensor:
    """Rank-ordered prune. ``border_rows[j]`` = vertex row of hub j;
    ``order`` = hub slots from highest to lowest priority."""
    out = torch.full_like(table, float("inf"))
    rows = border_rows.long().tolist()
    for j in order.long().tolist():
        r = rows[j]
        lam = torch.amin(out + out[r][None, :], dim=1)    # (n,)
        col = table[:, j]
        keep = col < lam
        keep[r] = torch.isfinite(col[r])
        out[:, j] = torch.where(keep, col, float("inf"))
    return out


@dataclass
class BuildState:
    """Every intermediate of one full pipeline run, host-side — the same
    fields as the JAX package's ``BuildState``; ``weights`` is the CSR
    weight snapshot the state was built from. ``table_device`` is the
    final table as the build left it on its device (the tensor the
    center serves rule 3 from); it is not part of the host state."""
    packed: PackedDistricts
    intra: np.ndarray        # (m, bmax, kmax) stage-A output
    overlay: np.ndarray      # (q, q) stage-B input
    closure: np.ndarray      # (q, q) stage-B output
    unpruned: np.ndarray     # (n, q) stage-C output
    table: np.ndarray        # (n, q) final (stage-D output when pruned)
    prune_order: np.ndarray | None  # (q,) int32 hub order, None if unpruned
    weights: np.ndarray      # (2m,) CSR weights the state corresponds to
    table_device: torch.Tensor | None = field(default=None, repr=False,
                                              compare=False)

    def labels(self) -> BorderLabels:
        return BorderLabels(self.packed.border_ids, self.table)


def hub_prune_order(g: Graph, border_ids: np.ndarray) -> np.ndarray:
    """Stage-D hub-slot order (depends on topology only, never weights)."""
    push = degree_order(g, subset=border_ids)
    rank = rank_of(push, g.num_vertices)
    return np.argsort(rank[border_ids], kind="stable").astype(np.int32)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def build_border_labels_stages(g: Graph, part: Partition, *,
                               prune: bool = True,
                               device: torch.device | str | None = None,
                               timings: dict | None = None
                               ) -> tuple[BorderLabels, BuildState]:
    """Full pipeline run that also returns every stage's host-side
    output. ``timings``, when given, receives host-clock seconds per
    step (``pack_s``, ``upload_s``, ``stage_a_sweeps_s``, ``overlay_s``,
    ``stage_b_s``, ``stage_c_s``, ``stage_d_s``; each device stage ends
    with its copy to the host, so each is synchronised) and
    ``stage_a_sweeps``. Stage A's host packing and upload are
    ``pack_s`` + ``upload_s`` (packing serves every stage, but it is
    the dense adjacency of stage A), reported as ``stage_a_pack_s``;
    ``stage_a_s`` = ``stage_a_pack_s`` + ``stage_a_sweeps_s``, as in
    ``IncrementalBuilder.timings``."""
    dev = resolve_device(device)
    t = {} if timings is None else timings
    t.clear()
    t0 = time.perf_counter()

    def lap(key: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        t[key] = now - t0
        t0 = now

    packed = pack_districts(g, part)
    lap("pack_s")
    n = g.num_vertices
    q = len(packed.border_ids)
    if q == 0:
        empty = np.full((n, 0), INF, dtype=np.float32)
        state = BuildState(packed, np.zeros((packed.num_districts,
                                             packed.bmax, packed.kmax),
                                            dtype=np.float32),
                           np.zeros((0, 0), dtype=np.float32),
                           np.zeros((0, 0), dtype=np.float32),
                           empty, empty, None, g.weights,
                           torch.from_numpy(empty).to(dev))
        return BorderLabels(packed.border_ids, empty), state

    adj = torch.from_numpy(packed.adj).to(dev)
    border_pos = torch.from_numpy(packed.border_pos).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    lap("upload_s")
    intra_t, t["stage_a_sweeps"] = stage_a_intra_distances(
        adj, border_pos, iters=packed.kmax)
    del adj                             # the largest tensor of the build
    intra = _host(intra_t)
    lap("stage_a_sweeps_s")
    t["stage_a_pack_s"] = t["pack_s"] + t["upload_s"]
    t["stage_a_s"] = t["stage_a_pack_s"] + t["stage_a_sweeps_s"]
    overlay = _overlay_from_intra(g, part, packed, intra)
    lap("overlay_s")
    clo_t = stage_b_overlay_closure(torch.from_numpy(overlay).to(dev))
    clo = _host(clo_t)
    lap("stage_b_s")
    unpruned_t = stage_c_full_table(
        intra_t, torch.from_numpy(packed.border_slot).to(dev), clo_t,
        torch.from_numpy(packed.vertex_ids).to(dev), n)
    unpruned = _host(unpruned_t)
    lap("stage_c_s")
    order = None
    table_t, table = unpruned_t, unpruned
    if prune:
        order = hub_prune_order(g, packed.border_ids)
        table_t = stage_d_prune(unpruned_t,
                                torch.from_numpy(packed.border_ids),
                                torch.from_numpy(order))
        table = _host(table_t)
    lap("stage_d_s")
    state = BuildState(packed, intra, overlay, clo, unpruned, table, order,
                       g.weights, table_t)
    return BorderLabels(packed.border_ids, table), state


def build_border_labels_torch(g: Graph, part: Partition, *,
                              prune: bool = True,
                              device: torch.device | str | None = None
                              ) -> BorderLabels:
    """Host wrapper: pack → run the stages on ``device`` → BorderLabels."""
    labels, _ = build_border_labels_stages(g, part, prune=prune,
                                           device=device)
    return labels


def _overlay_from_intra(g: Graph, part: Partition, packed: PackedDistricts,
                        intra: np.ndarray) -> np.ndarray:
    """(q,q) overlay weights: intra-district border blocks + cross edges."""
    q = len(packed.border_ids)
    w = np.full((q, q), INF, dtype=np.float32)
    np.fill_diagonal(w, 0.0)
    for i in range(packed.num_districts):
        bslots = packed.border_slot[i]
        bpos = packed.border_pos[i]
        valid = bslots >= 0
        bs = bslots[valid]
        bp = bpos[valid]
        if len(bs) == 0:
            continue
        block = intra[i][valid][:, bp]      # (b, b)
        w[np.ix_(bs, bs)] = np.minimum(w[np.ix_(bs, bs)], block)
    nvert = g.num_vertices
    slot = -np.ones(nvert, dtype=np.int64)
    slot[packed.border_ids] = np.arange(q)
    src = g.arc_sources()
    cross = part.assignment[src] != part.assignment[g.indices]
    np.minimum.at(w, (slot[src[cross]], slot[g.indices[cross]]),
                  g.weights[cross])
    return w
