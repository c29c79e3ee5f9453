"""Edge server (§4.2): owns one district, builds its own plain local index
L_i from the district subgraph, and upgrades it to L_i⁺ once the computing
center pushes the Border Auxiliary Shortcuts for the current version.

While its L_i⁺ is stale (center still rebuilding), the server answers
same-district queries through the Local Bound certificate (Theorem 3);
uncertified queries are resolved per the service's rebuild mode.

The indexes are built on the host; their serving layouts live on the
server's ``device``. The scatter-gather border-row store (the center's
push of the district's own B rows, the peer exchange, one previous
generation for the fault ladder) holds host rows, as the JAX package's
does; the scatter plane keeps each server's device copy
(``edge.scatter_gather``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.graph import Graph
from ..core.local_index import LocalIndex
from ..core.partition import Partition, borders_of
from ..core.pll import pll_subgraph
from ..core.query import local_bound
from ..core.shortcuts import shortcut_edges
from ..kernels.label_join import ops as lj


@dataclass
class EdgeServer:
    district_id: int
    plain: LocalIndex                 # L_i  (self-built, always available)
    augmented: LocalIndex | None = None   # L_i⁺ (needs center shortcuts)
    augmented_version: int = -1
    last_build_seconds: float = 0.0
    # read-only L_i⁺ preview per index version (certify_or_wait queries
    # answer from the post-push index without installing it)
    _peek: tuple[int, LocalIndex] | None = field(default=None, repr=False)
    # scatter-gather border-row store: district → (vertices, B rows at
    # natural width q), valid for border_rows_version only.  The server's
    # own slice is pushed by the center; peer slices arrive through
    # exchange_border_rows.
    border_rows_version: int = -1
    _border_rows: dict[int, tuple[np.ndarray, np.ndarray]] = \
        field(default_factory=dict, repr=False)
    # one previous generation of border rows, kept for graceful
    # degradation: when a peer exchange fails AND the center is
    # unreachable, the scatter plane serves these flagged "stale"
    _stale_rows: dict[int, tuple[np.ndarray, np.ndarray]] | None = \
        field(default=None, repr=False)
    _stale_rows_version: int = -2

    @property
    def device(self) -> torch.device:
        return self.plain.device

    @classmethod
    def bootstrap(cls, g: Graph, part: Partition, district_id: int,
                  device: torch.device | str | None = None) -> "EdgeServer":
        t0 = time.perf_counter()
        plain = _build_plain(g, part, district_id, device)
        server = cls(district_id, plain)
        server.last_build_seconds = time.perf_counter() - t0
        return server

    def refresh_local(self, g: Graph, part: Partition) -> float:
        """Rebuild L_i from freshly collected district traffic."""
        t0 = time.perf_counter()
        self.plain = _build_plain(g, part, self.district_id, self.device)
        self.augmented = None          # shortcuts are stale now
        self._peek = None              # previews were built on the old L_i
        self.last_build_seconds = time.perf_counter() - t0
        return self.last_build_seconds

    def _build_augmented(self, g: Graph,
                         shortcut_matrix: np.ndarray) -> LocalIndex:
        """L_i⁺ from the current plain L_i + the center's shortcuts."""
        extra = shortcut_edges(self.plain.border_locals, shortcut_matrix)
        labels, verts = pll_subgraph(g, self.plain.vertices,
                                     extra_edges=extra)
        return LocalIndex(self.district_id, verts,
                          self.plain.border_locals, labels, augmented=True,
                          device=self.device)

    def install_shortcuts(self, g: Graph, part: Partition,
                          shortcut_matrix: np.ndarray, version: int
                          ) -> float:
        """Fold the center's shortcuts into L_i⁺ (Theorem 2 activation).
        If a ``certify_or_wait`` query already built this version's
        preview (``peek_augmented``), the push just promotes it —
        the expensive pll_subgraph run is not repeated."""
        t0 = time.perf_counter()
        if self._peek is not None and self._peek[0] == version:
            self.augmented = self._peek[1]
        else:
            self.augmented = self._build_augmented(g, shortcut_matrix)
        self._peek = None               # promoted (or superseded)
        self.augmented_version = version
        dt = time.perf_counter() - t0
        self.last_build_seconds = dt
        return dt

    def peek_augmented(self, g: Graph, part: Partition,
                       shortcut_matrix: np.ndarray,
                       version: int) -> LocalIndex:
        """The L_i⁺ that ``install_shortcuts`` WOULD produce for
        ``version``, without installing it: the serving state (and hence
        the rebuild window) is untouched.  This is how ``certify_or_wait``
        answers the uncertified residue — the query 'waits for the push'
        and reads the post-push index.  Cached per version."""
        if self._peek is None or self._peek[0] != version:
            self._peek = (version, self._build_augmented(g, shortcut_matrix))
        return self._peek[1]

    # -- scatter-gather border-row exchange ---------------------------------

    def install_border_rows(self, vertices: np.ndarray, rows: np.ndarray,
                            version: int) -> None:
        """Center push of this district's own B rows for ``version``;
        drops every stale slice (own and peer) from older versions from
        the ACTIVE store, retaining exactly one previous generation for
        the fault-degradation ladder (``stale_border_rows_of``)."""
        if version != self.border_rows_version:
            if self._border_rows:
                self._stale_rows = self._border_rows
                self._stale_rows_version = self.border_rows_version
            self._border_rows = {}
            self.border_rows_version = version
        self._border_rows[self.district_id] = (vertices, rows)

    def has_border_rows(self, district_id: int, version: int) -> bool:
        return (self.border_rows_version == version
                and district_id in self._border_rows)

    def border_rows_of(self, district_id: int
                       ) -> tuple[np.ndarray, np.ndarray]:
        """``(vertices, rows)`` held for ``district_id`` (own or
        previously exchanged)."""
        return self._border_rows[district_id]

    def stale_border_rows_of(self, district_id: int
                             ) -> tuple[np.ndarray, np.ndarray] | None:
        """The previous-generation B rows held for ``district_id``, or
        None.  The last rung before "unavailable" in the degradation
        ladder: answers joined from these are flagged ``stale``."""
        if self._stale_rows is None:
            return None
        return self._stale_rows.get(int(district_id))

    def exchange_border_rows(self, peer: "EdgeServer") -> int:
        """Peer-to-peer pull of ``peer``'s own B rows — the §4.2 rule-3
        decomposition ``d(s,t) = min_b B[s,b] + B[t,b]`` needs only the
        target vertex's B row, so once this exchange has run the source
        server answers the cross-district pair entirely edge-side (one
        ``peer_edge_ms`` hop instead of two WAN hops through the center).
        Returns the number of rows transferred; 0 when the peer slice
        for the current version is already cached."""
        if peer.border_rows_version != self.border_rows_version:
            raise ValueError(
                f"border-row version mismatch: server {self.district_id} "
                f"at {self.border_rows_version}, peer {peer.district_id} "
                f"at {peer.border_rows_version}")
        if peer.district_id in self._border_rows:
            return 0
        vertices, rows = peer._border_rows[peer.district_id]
        self._border_rows[peer.district_id] = (vertices, rows)
        return len(vertices)

    # -- query paths --------------------------------------------------------

    def answer_exact(self, s: int, t: int) -> float | None:
        """Rule-1 answer via L_i⁺; None if shortcuts not installed yet."""
        if self.augmented is None:
            return None
        idx = self.augmented
        sl = int(idx.local_of(np.array([s]))[0])
        tl = int(idx.local_of(np.array([t]))[0])
        return float(idx.query_local(sl, tl))

    def answer_certified(self, s: int, t: int) -> tuple[float, bool]:
        """Theorem-3 path via plain L_i + Local Bound."""
        idx = self.plain
        sl = int(idx.local_of(np.array([s]))[0])
        tl = int(idx.local_of(np.array([t]))[0])
        lam = idx.query_local(sl, tl)
        lb = local_bound(idx, sl, tl)
        return float(lam), bool(lam <= lb)

    # -- batched query paths (the vectorized serving engine) ----------------

    def answer_exact_batch(self, ss: np.ndarray,
                           ts: np.ndarray) -> np.ndarray | None:
        """Rule-1/2 bucket via L_i⁺ and the dense label_join kernel;
        None if shortcuts not installed yet."""
        if self.augmented is None:
            return None
        idx = self.augmented
        return idx.query_local_many(idx.local_of(ss), idx.local_of(ts))

    def answer_certified_batch(self, ss: np.ndarray, ts: np.ndarray
                               ) -> tuple[np.ndarray, np.ndarray]:
        """Theorem-3 bucket on plain L_i: λ via the sparse label join, LB
        via the fused join-with-bound kernel. Returns (λ, certified)."""
        idx = self.plain
        sl, tl = idx.local_of(ss), idx.local_of(ts)
        hubs, dists = idx.sparse_device()
        lam = lj.join_sparse_gathered(hubs, dists, sl, tl)
        lb = idx.local_bound_many(sl, tl)
        return lam, lam <= lb


def _build_plain(g: Graph, part: Partition, district_id: int,
                 device: torch.device | str | None) -> LocalIndex:
    vertices = np.nonzero(part.assignment == np.int32(district_id))[0] \
        .astype(np.int32)
    b = borders_of(g, part)[district_id]
    pos = {int(v): i for i, v in enumerate(vertices)}
    border_locals = np.array([pos[int(x)] for x in b], dtype=np.int64)
    labels, verts = pll_subgraph(g, vertices)
    return LocalIndex(district_id, verts, border_locals, labels,
                      augmented=False, device=device)
