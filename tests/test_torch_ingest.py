"""The port's DIMACS ingest against the JAX package's, bit for bit.

``iter_gr``, ``load_gr_csr``, ``load_gr_graph`` and
``core.load_dimacs_gr`` read the same generated ``.gr`` text (plain and
gzip, ``c``/``p`` lines anywhere, duplicate and parallel arcs, small
chunks) into the same chunks, CSR arrays and graphs; every malformed
file raises ``DimacsFormatError`` with the reference's message, line
number included. The dataset registry is the same field for field, and
``fetch`` pins and verifies as the reference's does, without a network:
the upstream URL is a ``file://`` path or ``urlopen`` is replaced. Last,
a synthetic continent written as ``.gr`` and read back by each package
gives the same ``DistanceOracle`` answers (the port's on
``device="cpu"``).
"""
import dataclasses
import gzip
import io

import numpy as np
import pytest

import repro.core as rcore
import repro.ingest as ring
import repro.ingest.datasets as rds
import repro.ingest.dimacs as rdimacs
import repro_torch.core as tcore
import repro_torch.ingest as ting
import repro_torch.ingest.datasets as tds
import repro_torch.ingest.dimacs as tdimacs

GOOD = """c USA-road-d style file
p sp 4 5
a 1 2 3
c interleaved comment
a 2 1 3
a 2 3 7
a 3 4 2
a 4 3 2
"""

# comment and repeated problem lines between arcs, parallel arcs with
# other weights, a self-loop, blank lines, real-valued weights
MESSY = """c header
p sp 7 13

a 1 2 4
c middle
a 2 1 9
p sp 7 13
a 2 3 1.5
a 3 4 2
a 4 5 2
a 5 5 3
a 5 6 8
a 6 7 1
a 7 6 0.5
a 1 7 30
c between
a 3 2 1.25
a 4 6 5
a 4 6 4
c trailer
"""


def _write(tmp_path, text, name="t.gr"):
    p = tmp_path / name
    if name.endswith(".gz"):
        with gzip.open(p, "wt") as f:
            f.write(text)
    else:
        p.write_text(text)
    return str(p)


def _assert_chunks_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _assert_csr_equal(got, want):
    assert got.num_vertices == want.num_vertices
    for name in ("indptr", "indices", "weights"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


_assert_graph_equal = _assert_csr_equal


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("text", [GOOD, MESSY], ids=["good", "messy"])
@pytest.mark.parametrize("chunk", [3, 1 << 18])
def test_reader_matches_the_reference(tmp_path, text, gz, chunk):
    path = _write(tmp_path, text, "t.gr.gz" if gz else "t.gr")
    _assert_chunks_equal(ting.iter_gr(path, chunk_arcs=chunk),
                         ring.iter_gr(path, chunk_arcs=chunk))
    _assert_csr_equal(ting.load_gr_csr(path, chunk_arcs=chunk),
                      ring.load_gr_csr(path, chunk_arcs=chunk))
    _assert_graph_equal(ting.load_gr_graph(path, chunk_arcs=chunk),
                        ring.load_gr_graph(path, chunk_arcs=chunk))
    _assert_graph_equal(tcore.load_dimacs_gr(path),
                        rcore.load_dimacs_gr(path))
    assert tdimacs.DEFAULT_CHUNK_ARCS == rdimacs.DEFAULT_CHUNK_ARCS


def test_chunks_hold_at_most_chunk_arcs(tmp_path):
    path = _write(tmp_path, MESSY)
    sizes = [len(u) for _, u, _, _ in ting.iter_gr(path, chunk_arcs=3)]
    assert sizes == [3, 3, 3, 3, 1]
    assert sum(sizes) == 13


def test_quantized_csr_matches_the_reference(tmp_path):
    path = _write(tmp_path, GOOD)
    got = ting.load_gr_csr(path, quant=tcore.QuantSpec(
        scale=1.0, dtype=np.uint16, lossless=True), chunk_arcs=2)
    want = ring.load_gr_csr(path, quant=rcore.QuantSpec(
        scale=1.0, dtype=np.uint16, lossless=True), chunk_arcs=2)
    _assert_csr_equal(got, want)
    assert got.weights.dtype == np.uint16


def test_header_only_file_yields_one_empty_chunk(tmp_path):
    path = _write(tmp_path, "c nothing\np sp 3 0\n")
    _assert_chunks_equal(ting.iter_gr(path), ring.iter_gr(path))
    _assert_csr_equal(ting.load_gr_csr(path), ring.load_gr_csr(path))


# every malformed case of the reference's ``test_gr_errors`` first, then
# the reader's other refusals
MALFORMED = [
    "a 1 2 3\n",
    "p sp 2 1\na 0 1 3\n",
    "p sp 2 1\na 1 5 3\n",
    "p sp 2 1\na 1 2 3\np sp 9 9\n",
    "p sp 2\n",
    "p max 2 1\n",
    "p sp two 1\n",
    "p sp 0 0\n",
    "p sp 2 1\na 1 2\n",
    "p sp 2 1\na 1 x 3\n",
    "p sp 2 1\na 1 2 3 4\n",
    "p sp 2 1\na -1 2 3\n",
    "p sp 2 1\ne 1 2 3\n",
    "c only comments\n",
    "",
]


def _error(pkg, path):
    with pytest.raises(pkg.DimacsFormatError) as info:
        pkg.load_gr_graph(path)
    return str(info.value)


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_files_raise_the_references_message(tmp_path, text):
    path = _write(tmp_path, text)
    got, want = _error(ting, path), _error(ring, path)
    assert got == want
    assert issubclass(ting.DimacsFormatError, ValueError)


def test_error_names_the_line(tmp_path):
    msg = _error(ting, _write(tmp_path, "p sp 2 1\na 1 2 3\np sp 9 9\n"))
    assert msg.startswith("line 3:")
    msg = _error(ting, _write(tmp_path, "p sp 2 1\na 0 1 3\n"))
    assert "1-based" in msg


def test_chunk_size_must_be_positive(tmp_path):
    path = _write(tmp_path, GOOD)
    for pkg in (ting, ring):
        with pytest.raises(ValueError, match="positive"):
            list(pkg.iter_gr(path, chunk_arcs=0))


# -- the dataset registry -----------------------------------------------------

def test_registry_equals_the_references(monkeypatch, tmp_path):
    assert list(tds.DATASETS) == list(rds.DATASETS)
    for name, spec in tds.DATASETS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            rds.DATASETS[name])
        assert spec.filename == rds.DATASETS[name].filename
    assert tds.DATASETS["USA-road-d.NY"].num_vertices == 264_346
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    for name in tds.DATASETS:
        p = tds.dataset_path(name)
        assert p == rds.dataset_path(name)
        assert str(p).startswith(str(tmp_path)) and not p.exists()
    monkeypatch.delenv("REPRO_DATA_DIR")
    assert tds.cache_dir() == rds.cache_dir()


def test_sha256_of_equals_the_references(tmp_path):
    path = _write(tmp_path, MESSY * 50)
    assert tds.sha256_of(path) == rds.sha256_of(path)
    assert tds.sha256_of(path, chunk=7) == rds.sha256_of(path)


def test_fetch_pins_on_first_use_and_refuses_new_bytes(monkeypatch,
                                                        tmp_path):
    """A ``file://`` upstream: the first fetch pins a ``.sha256``
    sidecar, a cache hit re-verifies, a changed upstream raises and the
    pinned file stays."""
    src = tmp_path / "upstream.gr.gz"
    with gzip.open(src, "wt") as f:
        f.write(GOOD)
    spec = tds.DatasetSpec("tiny", f"file://{src}", 4, 5)
    monkeypatch.setitem(tds.DATASETS, "tiny", spec)
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path / "cache"))
    dest = tds.fetch("tiny")
    side = dest.with_suffix(dest.suffix + ".sha256")
    assert side.read_text().strip() == tds.sha256_of(dest)
    assert tds.fetch("tiny") == dest
    with gzip.open(src, "wt") as f:
        f.write(GOOD + "c tampered\n")
    with pytest.raises(ValueError, match="sha256"):
        tds.fetch("tiny", force=True)
    assert tds.sha256_of(dest) == side.read_text().strip()
    assert not dest.with_suffix(dest.suffix + ".part").exists()
    _assert_graph_equal(tcore.load_dimacs_gr(str(dest)),
                        rcore.load_dimacs_gr(str(dest)))


def test_fetch_detects_a_corrupted_cache_and_a_pinned_digest(monkeypatch,
                                                             tmp_path):
    """``urlopen`` replaced by a stream of local bytes: a
    cache that rots raises, and a spec pinned in code refuses other
    bytes, in both packages alike."""
    urls = []

    def fake_urlopen(url):
        urls.append(url)
        return io.BytesIO(GOOD.encode())

    monkeypatch.setattr(tds.urllib.request, "urlopen", fake_urlopen)
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path / "cache"))
    spec = tds.DatasetSpec("tiny2", f"file://{tmp_path}/u.gr", 4, 5)
    monkeypatch.setitem(tds.DATASETS, "tiny2", spec)
    dest = tds.fetch("tiny2")
    assert urls == [spec.url]
    dest.write_text("garbage")
    with pytest.raises(ValueError, match="sha256"):
        tds.fetch("tiny2")
    pinned = tds.DatasetSpec("tiny3", f"file://{tmp_path}/v.gr", 4, 5,
                             sha256="0" * 64)
    monkeypatch.setitem(tds.DATASETS, "tiny3", pinned)
    with pytest.raises(ValueError, match="expected " + "0" * 64):
        tds.fetch("tiny3")
    assert not tds.dataset_path("tiny3").exists()


# -- round trip: continent → .gr → loader → oracle -----------------------------

def _write_continent(csr, path):
    us = np.repeat(np.arange(csr.num_vertices), np.diff(csr.indptr))
    with gzip.open(path, "wt") as f:
        f.write(f"c synthetic continent\np sp {csr.num_vertices} {len(us)}\n")
        np.savetxt(f, np.column_stack(
            [us + 1, csr.indices + 1, csr.weights.astype(np.int64)]),
            fmt="a %d %d %d")


def test_continent_round_trip_answers_match_the_reference(tmp_path):
    csr, part = ting.synthetic_continent(grid=(2, 3), district=(6, 5),
                                         border_links=2, seed=4)
    rcsr, rpart = ring.synthetic_continent(grid=(2, 3), district=(6, 5),
                                           border_links=2, seed=4)
    np.testing.assert_array_equal(part.assignment, rpart.assignment)
    path = str(tmp_path / "continent.gr.gz")
    _write_continent(csr, path)
    got_csr = ting.load_gr_csr(path, chunk_arcs=97)
    _assert_csr_equal(got_csr, csr)
    g, rg = got_csr.to_graph(), rcore.load_dimacs_gr(path)
    _assert_graph_equal(g, rg)
    oracle = tcore.DistanceOracle.build(g, part, builder="hierarchical",
                                        device="cpu")
    roracle = rcore.DistanceOracle.build(rg, rpart, builder="hierarchical")
    np.testing.assert_array_equal(oracle.border_labels.table,
                                  roracle.border_labels.table)
    rng = np.random.default_rng(0)
    ss = rng.integers(0, g.num_vertices, 300)
    ts = rng.integers(0, g.num_vertices, 300)
    got = oracle.query_many(ss, ts)
    np.testing.assert_array_equal(got, roracle.query_many(ss, ts))
    for i in range(5):
        assert got[i] == np.float32(
            tcore.dijkstra(g, int(ss[i]))[ts[i]])
