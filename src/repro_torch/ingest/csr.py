"""Streaming CSR construction: chunked arc accumulation → int32 CSR.

``core.graph.from_edges`` wants the whole edge list in float32 at once;
at continent scale (DIMACS USA: 24M vertices, 58M arcs) that transient
alone is GBs.  ``CSRBuilder`` instead accepts arcs in bounded chunks
(the shape the chunked DIMACS reader and the synthetic-continent
generator emit), optionally quantizing weights to uint16 **as they
arrive** (townscout's ``graph_to_csr`` discipline: integer travel-time
seconds, clip below the sentinel), so the arc store holds 10 bytes per
arc instead of 16.  ``finalize`` runs one vectorized canonical-key
dedup (parallel arcs collapse to the **min** weight — the shortest-path
semantics), materializes both directions of every undirected edge, and
emits ``CSRArrays``: int32 ``indptr``/``indices`` plus weights in the
accumulation dtype.

``CSRArrays.to_graph()`` adapts to the existing stack: a ``core.Graph``
with float32 weights (exact for lossless specs — integer seconds
round-trip bit-for-bit, see ``core.quantize``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.graph import Graph
from ..core.quantize import QuantSpec

INF = np.float32(np.inf)


@dataclass(frozen=True)
class CSRArrays:
    """The ingest pipeline's product: an undirected CSR in narrow
    dtypes.  ``indptr`` int32 (n+1,), ``indices`` int32 (2m,),
    ``weights`` in the accumulation dtype (float32, or the quantized
    integer dtype with ``quant`` set)."""

    indptr: np.ndarray
    indices: np.ndarray
    weights: np.ndarray
    quant: QuantSpec | None = None

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        """Undirected edge count."""
        return int(self.indices.shape[0] // 2)

    def nbytes(self) -> int:
        return int(self.indptr.nbytes + self.indices.nbytes
                   + self.weights.nbytes)

    def weights_f32(self) -> np.ndarray:
        """Weights dequantized to float32 (identity when unquantized)."""
        if self.quant is None:
            return np.asarray(self.weights, dtype=np.float32)
        return self.quant.dequantize(self.weights)

    def to_graph(self) -> Graph:
        """Adapt to ``core.Graph`` (float32 weights; the int32 indptr /
        indices carry over — every consumer indexes with them
        unchanged)."""
        return Graph(self.indptr, self.indices, self.weights_f32())


class CSRBuilder:
    """Chunked arc accumulator for one fixed vertex range [0, n).

    ``add_arcs`` validates and stores a chunk (quantizing weights on
    arrival when a ``QuantSpec`` is attached); ``finalize`` dedups and
    emits ``CSRArrays``.  Arcs are treated as undirected edges: both
    (u, v, w) and (v, u, w') collapse onto the canonical u < v key with
    the min weight, and both CSR directions are materialized — exactly
    the ``core.graph.from_edges`` contract, streamed.
    """

    def __init__(self, num_vertices: int,
                 quant: QuantSpec | None = None):
        if num_vertices <= 0:
            raise ValueError(f"num_vertices must be positive, "
                             f"got {num_vertices}")
        self.num_vertices = int(num_vertices)
        self.quant = quant
        self._us: list[np.ndarray] = []
        self._vs: list[np.ndarray] = []
        self._ws: list[np.ndarray] = []
        self.arcs_added = 0

    def add_arcs(self, u: np.ndarray, v: np.ndarray,
                 w: np.ndarray) -> None:
        """Append one chunk of 0-based arcs; self-loops are dropped
        (they never shorten a path), ids outside [0, n) raise."""
        u = np.asarray(u, dtype=np.int32)
        v = np.asarray(v, dtype=np.int32)
        if len(u) != len(v) or len(u) != len(w):
            raise ValueError("arc chunk arrays must have equal length")
        if len(u) == 0:
            return
        lo = min(int(u.min()), int(v.min()))
        hi = max(int(u.max()), int(v.max()))
        if lo < 0 or hi >= self.num_vertices:
            raise ValueError(
                f"arc endpoint {lo if lo < 0 else hi} outside "
                f"[0, {self.num_vertices}) — ids must be 0-based and "
                "dense")
        w = (self.quant.quantize(w) if self.quant is not None
             else np.asarray(w, dtype=np.float32))
        keep = u != v
        if not keep.all():
            u, v, w = u[keep], v[keep], w[keep]
        self._us.append(u)
        self._vs.append(v)
        self._ws.append(w)
        self.arcs_added += len(u)

    def arc_store_nbytes(self) -> int:
        """Current bytes held by the accumulated arc chunks (the number
        the quantized accumulation shrinks)."""
        return sum(a.nbytes for chunks in (self._us, self._vs, self._ws)
                   for a in chunks)

    def finalize(self) -> CSRArrays:
        """Dedup-min over the canonical undirected key and build the
        int32 CSR.  The builder's chunk store is released."""
        n = self.num_vertices
        if self.arcs_added and not self._us:
            raise RuntimeError("finalize() already called — the chunk "
                               "store is released on the first call")
        if self.arcs_added == 0:
            return CSRArrays(np.zeros(n + 1, dtype=np.int32),
                             np.zeros(0, dtype=np.int32),
                             np.zeros(0, dtype=self._weight_dtype()),
                             quant=self.quant)
        u = np.concatenate(self._us)
        v = np.concatenate(self._vs)
        w = np.concatenate(self._ws)
        self._us, self._vs, self._ws = [], [], []
        lo = np.minimum(u, v).astype(np.int64)
        hi = np.maximum(u, v).astype(np.int64)
        key = lo * n + hi
        order = np.argsort(key, kind="stable")
        key, lo, hi, w = key[order], lo[order], hi[order], w[order]
        first = np.ones(len(key), dtype=bool)
        first[1:] = key[1:] != key[:-1]
        group = np.cumsum(first) - 1
        # min-reduce parallel arcs; integer codes order like distances
        # (quantize is monotone), so the min commutes with quantization
        wmin = np.full(int(group[-1]) + 1, _max_of(w.dtype), dtype=w.dtype)
        np.minimum.at(wmin, group, w)
        eu = lo[first].astype(np.int32)
        ev = hi[first].astype(np.int32)
        src = np.concatenate([eu, ev])
        dst = np.concatenate([ev, eu])
        ww = np.concatenate([wmin, wmin])
        order = np.argsort(src, kind="stable")
        src, dst, ww = src[order], dst[order], ww[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        if indptr[-1] > np.iinfo(np.int32).max:
            raise ValueError("arc count overflows int32 CSR")
        return CSRArrays(indptr.astype(np.int32), dst, ww,
                         quant=self.quant)

    def _weight_dtype(self):
        return (self.quant.dtype if self.quant is not None
                else np.dtype(np.float32))


def _max_of(dtype) -> float | int:
    dt = np.dtype(dtype)
    return np.inf if dt.kind == "f" else np.iinfo(dt).max
