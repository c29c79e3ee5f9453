"""Chunked DIMACS challenge-9 ``.gr`` reader.

The 9th DIMACS Implementation Challenge distributes road networks as
``.gr`` files: ``c`` comment lines, one ``p sp <n> <m>`` problem line,
and ``a <u> <v> <w>`` arc lines with **1-based** vertex ids.  Real
extracts are messy — comments interleave with arcs, tools re-emit the
problem line, and duplicate arcs (both directions of an undirected
edge, or parallel arcs with different weights) are the norm — so the
reader:

* tolerates ``c`` and ``p`` lines anywhere (a repeated ``p`` line must
  agree with the first; a contradicting one is an error);
* validates every arc id: ``0`` raises a "0-based ids" error (the
  classic off-by-one when a file was re-exported from a 0-based tool),
  ``> n`` raises out-of-range — both with the line number;
* streams arcs in bounded chunks so continent-sized files never
  materialize as Python lists; the consuming ``CSRBuilder`` collapses
  duplicate arcs to the min weight.

``load_gr_csr`` feeds the stream straight into ``CSRBuilder``;
``load_gr_graph`` is the one-call convenience returning ``core.Graph``
(what ``core.graph.load_dimacs_gr`` delegates to).

A copy of ``repro.ingest.dimacs`` over the port's ``core.graph``,
``core.quantize`` and ``ingest.csr``: the same arcs, CSR arrays, error
messages and line numbers.
"""
from __future__ import annotations

import gzip
from typing import IO, Iterator

import numpy as np

from ..core.graph import Graph
from ..core.quantize import QuantSpec
from .csr import CSRArrays, CSRBuilder

DEFAULT_CHUNK_ARCS = 1 << 18


class DimacsFormatError(ValueError):
    """Malformed ``.gr`` content, with the offending line number."""


def _open(path) -> IO[str]:
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, "rt", encoding="ascii", errors="replace")
    return open(p, "rt", encoding="ascii", errors="replace")


def iter_gr(path, chunk_arcs: int = DEFAULT_CHUNK_ARCS
            ) -> Iterator[tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield ``(num_vertices, u, v, w)`` chunks of **0-based** arcs.

    ``num_vertices`` repeats in every chunk (it is known once the first
    ``p`` line is seen, which must precede the first arc).  ``u``/``v``
    are int64 0-based endpoints, ``w`` float64 weights; chunks hold at
    most ``chunk_arcs`` arcs.
    """
    if chunk_arcs <= 0:
        raise ValueError(f"chunk_arcs must be positive, got {chunk_arcs}")
    n = None
    declared_m = None
    us: list[int] = []
    vs: list[int] = []
    ws: list[float] = []
    seen = 0
    with _open(path) as fh:
        for lineno, raw in enumerate(fh, start=1):
            line = raw.strip()
            if not line or line.startswith("c"):
                continue
            if line.startswith("p"):
                parts = line.split()
                if len(parts) != 4 or parts[1] != "sp":
                    raise DimacsFormatError(
                        f"line {lineno}: malformed problem line "
                        f"{line!r} (want 'p sp <n> <m>')")
                try:
                    pn, pm = int(parts[2]), int(parts[3])
                except ValueError:
                    raise DimacsFormatError(
                        f"line {lineno}: non-integer sizes in "
                        f"problem line {line!r}") from None
                if pn <= 0:
                    raise DimacsFormatError(
                        f"line {lineno}: vertex count must be "
                        f"positive, got {pn}")
                if n is None:
                    n, declared_m = pn, pm
                elif (pn, pm) != (n, declared_m):
                    raise DimacsFormatError(
                        f"line {lineno}: repeated problem line "
                        f"disagrees with 'p sp {n} {declared_m}'")
                continue
            if line.startswith("a"):
                if n is None:
                    raise DimacsFormatError(
                        f"line {lineno}: arc before the 'p sp' "
                        "problem line")
                parts = line.split()
                if len(parts) != 4:
                    raise DimacsFormatError(
                        f"line {lineno}: malformed arc line {line!r} "
                        "(want 'a <u> <v> <w>')")
                try:
                    u, v = int(parts[1]), int(parts[2])
                    w = float(parts[3])
                except ValueError:
                    raise DimacsFormatError(
                        f"line {lineno}: non-numeric arc fields in "
                        f"{line!r}") from None
                for x in (u, v):
                    if x == 0:
                        raise DimacsFormatError(
                            f"line {lineno}: vertex id 0 — DIMACS .gr "
                            "ids are 1-based; this file looks 0-based")
                    if x < 0 or x > n:
                        raise DimacsFormatError(
                            f"line {lineno}: vertex id {x} out of "
                            f"range [1, {n}]")
                us.append(u - 1)
                vs.append(v - 1)
                ws.append(w)
                seen += 1
                if len(us) >= chunk_arcs:
                    yield (n, np.asarray(us, dtype=np.int64),
                           np.asarray(vs, dtype=np.int64),
                           np.asarray(ws, dtype=np.float64))
                    us, vs, ws = [], [], []
                continue
            raise DimacsFormatError(
                f"line {lineno}: unrecognized line {line!r}")
    if n is None:
        raise DimacsFormatError("no 'p sp' problem line found")
    if us or seen == 0:
        yield (n, np.asarray(us, dtype=np.int64),
               np.asarray(vs, dtype=np.int64),
               np.asarray(ws, dtype=np.float64))


def load_gr_csr(path, quant: QuantSpec | None = None,
                chunk_arcs: int = DEFAULT_CHUNK_ARCS) -> CSRArrays:
    """Stream a ``.gr`` file into a ``CSRBuilder`` (optionally
    quantizing weights on arrival) and return the finalized CSR."""
    builder = None
    for n, u, v, w in iter_gr(path, chunk_arcs=chunk_arcs):
        if builder is None:
            builder = CSRBuilder(n, quant=quant)
        builder.add_arcs(u, v, w)
    assert builder is not None  # iter_gr raises on empty input
    return builder.finalize()


def load_gr_graph(path, chunk_arcs: int = DEFAULT_CHUNK_ARCS) -> Graph:
    """One-call loader: ``.gr`` file → float32 ``core.Graph``."""
    return load_gr_csr(path, chunk_arcs=chunk_arcs).to_graph()
