"""The port's CUDA kernels and serving path on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips
with a reason where no CUDA device exists. Run them on a machine with
the card (no JAX needed there; ``--noconftest`` keeps the JAX package's
shared fixtures out):

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

The distance kernels (the joins at every vector width, the tiled,
fused-closure and k-major min-plus products, relax) must equal their
plain versions bit for bit (same IEEE float32 operations;
Floyd–Warshall on integral weights, within rtol 1e-5 on real ones),
B built on the card by the staged builder
must equal the host reference's, repairs of B on the card must equal
the same repairs on the CPU, and a deployment on the card must answer
exactly as the same deployment on the CPU. The flash-attention
kernel, whose sums run in another order, must agree with its plain
version within the tolerances stated at its tests, and the LM path
through it with the dense path.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import bfs_grow_partition, grid_road_network
from repro_torch.edge import EdgeSystem
from repro_torch.ingest import synthetic_continent
from repro_torch.kernels.label_join import kernel, ops, ref
from repro_torch.serve import CERTIFY_OR_WAIT, STALE_OK, ServingPolicy

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand_dist(rng, shape):
    x = rng.uniform(0.5, 50.0, size=shape).astype(np.float32)
    x[rng.random(shape) < 0.3] = np.inf
    return x


@pytest.mark.parametrize("q,w", [(1, 1), (5, 7), (100, 257), (512, 512),
                                 (3, 1024), (4096, 96), (7, 0)])
def test_kernel_matches_plain_version(cuda, q, w):
    rng = np.random.default_rng(q + w)
    s, t = _rand_dist(rng, (q + 4, w)), _rand_dist(rng, (q + 9, w))
    S, T = torch.from_numpy(s).to(cuda), torch.from_numpy(t).to(cuda)
    rs = torch.from_numpy(rng.integers(0, q + 4, q)).to(cuda)
    rt = torch.from_numpy(rng.integers(0, q + 9, q)).to(cuda)
    before = dict(kernel.LAUNCHES)
    got = kernel.gather_join(S, rs, T, rt)
    lam, lb = kernel.gather_join(S, rs, T, rt, with_lb=True)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["label_join"] == before["label_join"] + 1
    assert kernel.LAUNCHES["label_join_lb"] == before["label_join_lb"] + 1
    assert torch.equal(got, ref.gather_join_ref(S, rs, T, rt))
    want_lam, want_lb = ref.gather_join_ref(S, rs, T, rt, with_lb=True)
    assert torch.equal(lam, want_lam) and torch.equal(lb, want_lb)
    for dtype in (np.uint16, np.int16):
        sentinel = int(np.iinfo(dtype).max)
        c = rng.integers(0, sentinel + 1, (q + 9, w)).astype(dtype)
        C = ops.upload(c, cuda)
        got = kernel.gather_join(C, rs, C, rt, quant=(sentinel, 0.25))
        torch.cuda.synchronize()
        assert torch.equal(got, ref.gather_join_ref(
            C, rs, C, rt, quant=(sentinel, 0.25)))


def _table_at(cuda, dtype, rows, w, offset):
    """A contiguous (rows, w) table on the card, ``offset`` elements
    past a 256-byte-aligned allocation."""
    flat = torch.zeros(rows * w + offset, dtype=dtype, device=cuda)
    return flat[offset:].view(rows, w)


# the join at every vector width: widths 1, 93, 96, 133, 256 give pitches
# of 4 to 1024 bytes; offset 1 starts a table 4 (or 2) bytes off its
# 16-byte alignment; batches from 1 to 65 536 queries
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("w", [1, 93, 96, 133, 256])
@pytest.mark.parametrize("q", [1, 45, 4096, 65536])
def test_kernel_matches_plain_version_at_every_vector_width(cuda, q, w,
                                                            offset):
    rng = np.random.default_rng(q + w + offset)
    rows = 300
    s = _table_at(cuda, torch.float32, rows, w, offset)
    t = _table_at(cuda, torch.float32, rows + 5, w, offset)
    s.copy_(torch.from_numpy(_rand_dist(rng, (rows, w))))
    t.copy_(torch.from_numpy(_rand_dist(rng, (rows + 5, w))))
    rs = torch.from_numpy(rng.integers(0, rows, q)).to(cuda)
    rt = torch.from_numpy(rng.integers(0, rows + 5, q)).to(cuda)
    vec, group = kernel.join_layout(s, t, q)
    assert vec == (4 if offset or (w * 4) % 8 else 16 if w % 4 == 0 else 8)
    before = dict(kernel.LAUNCHES)
    got = kernel.gather_join(s, rs, t, rt)
    lam, lb = kernel.gather_join(s, rs, t, rt, with_lb=True)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["label_join"] == before["label_join"] + 1
    assert kernel.LAUNCHES["label_join_lb"] == before["label_join_lb"] + 1
    assert torch.equal(got, ref.gather_join_ref(s, rs, t, rt))
    want_lam, want_lb = ref.gather_join_ref(s, rs, t, rt, with_lb=True)
    assert torch.equal(lam, want_lam) and torch.equal(lb, want_lb)
    for npdt in (np.uint16, np.int16):
        sentinel = int(np.iinfo(npdt).max)
        codes = rng.integers(0, sentinel + 1, (rows + 5, w)).astype(npdt)
        c = _table_at(cuda, torch.int16, rows + 5, w, offset)
        c.copy_(torch.from_numpy(codes.view(np.int16)))
        cvec, _ = kernel.join_layout(c, c, q)
        assert cvec == max(v for v in (16, 8, 4, 2)
                           if (2 * w) % v == 0 and (2 * offset) % v == 0)
        got = kernel.gather_join(c, rs, c, rt, quant=(sentinel, 0.25))
        torch.cuda.synchronize()
        assert torch.equal(got, ref.gather_join_ref(
            c, rs, c, rt, quant=(sentinel, 0.25)))


# (storage, width, offset in elements, vector bytes, lanes per query) at
# a large batch, as the C entry picks them: a 16-byte pitch and base take
# 16-byte loads, an offset or a pitch of 8 or 4 bytes narrower ones,
# odd-width codes 2-byte ones; the lanes are the fewest that load a row
# in at most 4 vectors each (kUnroll)
LAYOUTS = [("float32", 96, 0, 16, 8), ("float32", 256, 0, 16, 16),
           ("float32", 96, 1, 4, 32), ("float32", 96, 2, 8, 16),
           ("float32", 6, 0, 8, 1), ("float32", 1, 0, 4, 1),
           ("float32", 133, 0, 4, 32), ("float32", 0, 0, 16, 1),
           ("float32", 1024, 0, 16, 32), ("uint16", 96, 0, 16, 4),
           ("uint16", 93, 0, 2, 32), ("uint16", 256, 0, 16, 8),
           ("int16", 96, 4, 8, 8), ("int16", 96, 1, 2, 32)]


@pytest.mark.parametrize("storage,w,offset,vec,group", LAYOUTS)
def test_join_layout_picks_the_widest_aligned_vector(cuda, storage, w, offset,
                                                     vec, group):
    dtype = torch.float32 if storage == "float32" else torch.int16
    table = _table_at(cuda, dtype, 5, w, offset)
    aligned = _table_at(cuda, dtype, 7, w, 0)
    big = 1 << 20                       # queries: the batch asks no lanes
    assert kernel.join_layout(table, table, big, sms=132) == (vec, group)
    # the narrower alignment of either table decides
    assert kernel.join_layout(aligned, table, big, sms=132)[0] == vec
    assert kernel.join_layout(table, aligned, big, sms=132)[0] == vec
    pitch = w * table.element_size()
    assert pitch % vec == 0 and table.data_ptr() % vec == 0
    assert -(-pitch // vec) <= group * 4 or group == 32
    # a lanes override keeps the vector width
    assert kernel.join_layout(table, table, big, lanes=2, sms=132) == (vec, 2)


# (queries, width, lanes) on 132 SMs: a small batch takes more lanes a
# query, up to 4x what its rows need, so that its blocks of 256 threads
# cover more SMs (the rebuild window's 167 queries of 6 borders, the
# engine's 4096 queries), then more while a lane would load over 32 bytes
# of a row and twice its threads fit in 256 x 132 (4223 and 4224 queries
# of 256: each side of that bound); a large one only what its rows need
BATCH_LAYOUTS = [(167, 6, 4), (1, 96, 32), (4096, 96, 16), (4096, 256, 32),
                 (4223, 256, 32), (4224, 256, 16), (65536, 96, 8),
                 (65536, 6, 1), (33792, 6, 1), (33791, 6, 2), (1, 1024, 32)]


@pytest.mark.parametrize("q,w,group", BATCH_LAYOUTS)
def test_join_layout_spreads_small_batches_over_the_sms(cuda, q, w, group):
    table = _table_at(cuda, torch.float32, 3, w, 0)
    _, lanes = kernel.join_layout(table, table, q, sms=132)
    assert lanes == group
    _, rows_need = kernel.join_layout(table, table, 1 << 30, sms=132)
    assert rows_need <= lanes <= max(rows_need, min(4 * rows_need, 32))


# -- the serving joins' row ids, staged through the pinned buffer -----------

def _serving_tables(cuda, rng, rows, w):
    """A float32 table and a uint16 code table, on the card and on the
    host (where the joins run their plain versions)."""
    table = _rand_dist(rng, (rows, w))
    codes = rng.integers(0, 0xFFFF + 1, (rows, w)).astype(np.uint16)
    return ((ops.upload(table, cuda), ops.upload(codes, cuda)),
            (ops.upload(table, "cpu"), ops.upload(codes, "cpu")))


def _serve_both(tables, ss, ts):
    """``join_gathered`` and ``join_quantized_gathered`` over one pair of
    tables."""
    table, codes = tables
    return (ops.join_gathered(table, ss, ts),
            ops.join_quantized_gathered(codes, ss, ts, sentinel=0xFFFF,
                                        scale=0.25))


@pytest.mark.parametrize("q", [1, 255, 32768, 262144])
def test_serving_joins_stage_ids_as_the_host_answers(cuda, q):
    rng = np.random.default_rng(q)
    card, host = _serving_tables(cuda, rng, 5000, 96)
    ss, ts = rng.integers(0, 5000, q), rng.integers(0, 5000, q)
    want = _serve_both(host, ss, ts)
    _serve_both(card, ss, ts)                    # the buffer fits q now
    staged = dict(ops.STAGING)
    for _ in range(3):
        for got, w in zip(_serve_both(card, ss, ts), want):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, w)
    assert ops.STAGING == {"pinned": staged["pinned"] + 6,
                           "grown": staged["grown"]}


def test_bad_row_ids_raise_on_the_card_before_any_launch(cuda):
    rng = np.random.default_rng(4)
    card, host = _serving_tables(cuda, rng, 50, 12)
    ss, ts = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    bad = ts.copy()
    bad[-1] = 50
    launches, staged = dict(kernel.LAUNCHES), dict(ops.STAGING)
    with pytest.raises(IndexError):
        ops.join_gathered(card[0], ss, bad)
    with pytest.raises(IndexError):
        ops.join_quantized_gathered(card[1], ss, bad, sentinel=0xFFFF,
                                    scale=0.25)
    with pytest.raises(ValueError, match="one length"):
        ops.join_gathered(card[0], ss, ts[:1])   # would broadcast in a copy
    assert kernel.LAUNCHES == launches and ops.STAGING == staged
    for got, w in zip(_serve_both(card, ss, ts), _serve_both(host, ss, ts)):
        np.testing.assert_array_equal(got, w)


def test_a_call_that_fails_after_its_upload_leaves_the_buffer_sound(
        cuda, monkeypatch):
    """A launch that raises leaves its upload in flight with no readback;
    the next call waits for it before it writes the buffer again."""
    rng = np.random.default_rng(5)
    card, host = _serving_tables(cuda, rng, 4000, 64)
    ss, ts = rng.integers(0, 4000, 65536), rng.integers(0, 4000, 65536)

    def fail(*args, **kwargs):
        raise RuntimeError("launch refused")

    with monkeypatch.context() as m:
        m.setattr(ops, "gather_join", fail)
        with pytest.raises(RuntimeError, match="launch refused"):
            ops.join_gathered(card[0], ts, ss)
    for got, w in zip(_serve_both(card, ss, ts), _serve_both(host, ss, ts)):
        np.testing.assert_array_equal(got, w)


def test_two_threads_serve_their_own_batches(cuda):
    rng = np.random.default_rng(6)
    card, host = _serving_tables(cuda, rng, 3000, 32)
    batches = [(rng.integers(0, 3000, n), rng.integers(0, 3000, n))
               for n in (1000, 5000)]
    wants = [ops.join_gathered(host[0], *b) for b in batches]
    staged = ops.STAGING["pinned"]
    wrong = []

    def serve(i):
        for _ in range(200):
            if not np.array_equal(ops.join_gathered(card[0], *batches[i]),
                                  wants[i]):
                wrong.append(i)

    threads = [threading.Thread(target=serve, args=(i,)) for i in (0, 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrong == []
    assert ops.STAGING["pinned"] == staged + 400


def test_card_serves_as_the_host_does(cuda):
    csr, part = synthetic_continent((2, 2), (8, 8), seed=3)
    g = csr.to_graph()
    on_card = EdgeSystem.deploy(g, part, device=cuda)
    on_host = EdgeSystem.deploy(g, part, device="cpu")
    rng = np.random.default_rng(1)
    ss = rng.integers(0, g.num_vertices, 500)
    ts = rng.integers(0, g.num_vertices, 500)
    for dtype in ("float32", "uint16"):
        pol = ServingPolicy(label_dtype=dtype)
        a = on_card.service(pol).submit(ss, ts)
        b = on_host.service(pol).submit(ss, ts)
        np.testing.assert_array_equal(a.distances, b.distances)
    assert on_card.current_engine().table.is_cuda


def test_card_rebuild_window_matches_host(cuda):
    g = grid_road_network(10, 10, seed=5)
    part = bfs_grow_partition(g, 4)
    systems = [EdgeSystem.deploy(g, part, device=d) for d in (cuda, "cpu")]
    w2 = np.asarray(g.weights) * np.float32(1.25)
    rng = np.random.default_rng(2)
    ss = rng.integers(0, g.num_vertices, 300)
    ts = rng.integers(0, g.num_vertices, 300)
    out = []
    for system in systems:
        g2 = system.graph.with_weights(w2)
        system.graph = g2
        for srv in system.servers:
            srv.refresh_local(g2, part)
        system.center.rebuild(w2)
        out.append([system.service(ServingPolicy(rebuild=m)).submit(ss, ts)
                    for m in (STALE_OK, CERTIFY_OR_WAIT)])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.distances, b.distances)
        np.testing.assert_array_equal(a.exactness_codes, b.exactness_codes)


def _sharded_inputs(cuda, rng, storage, nq, w, bw, offset, assembled,
                    shards=4):
    """A (rows, w) district block ``offset`` elements off its alignment,
    a border table of width bw (the (2Q, bw) assembled rows, or 300
    rows of B), owners over ``shards`` shards and mixed row ids: both
    rows from the block, both from B, one of each."""
    rows = 40
    if storage == "float32":
        blk, bord = _rand_dist(rng, (rows, w)), _rand_dist(
            rng, (2 * nq if assembled else 300, bw))
        quant, dtype = None, torch.float32
    else:
        npdt = np.uint16 if storage == "uint16" else np.int16
        sentinel = int(np.iinfo(npdt).max)
        blk = rng.integers(0, sentinel + 1, (rows, w)).astype(npdt)
        bord = rng.integers(0, sentinel + 1,
                            (2 * nq if assembled else 300, bw)).astype(npdt)
        blk[rng.random(blk.shape) < 0.3] = sentinel
        bord[rng.random(bord.shape) < 0.3] = sentinel
        blk, bord = blk.view(np.int16), bord.view(np.int16)
        quant, dtype = (sentinel, 0.25), torch.int16
    block = _table_at(cuda, dtype, rows, w, offset)
    block.copy_(torch.from_numpy(blk))
    border = torch.from_numpy(bord).to(cuda)
    kind = rng.integers(0, 3, nq)
    rs = np.where(kind == 1, rows + rng.integers(0, 300, nq),
                  rng.integers(0, rows, nq))
    rt = np.where(kind >= 1, rows + rng.integers(0, 300, nq),
                  rng.integers(0, rows, nq))
    if assembled:       # row-sharded B: ids point at rows i and Q + i
        lanes = np.arange(nq)
        rs = np.where(kind == 1, rows + lanes, rs)
        rt = np.where(kind >= 1, rows + nq + lanes, rt)
    owner = rng.integers(0, shards, nq)
    ids = [torch.from_numpy(x.astype(np.int64)).to(cuda)
           for x in (owner, rs, rt)]
    return block, border, ids, quant


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("w,bw", [(256, 93), (96, 96), (96, 7), (33, 0)])
@pytest.mark.parametrize("storage", ["float32", "uint16", "int16"])
@pytest.mark.parametrize("assembled", [False, True])
def test_sharded_kernel_matches_plain_version(cuda, assembled, storage, w,
                                              bw, offset):
    rng = np.random.default_rng(w + bw + offset)
    for nq in (1, 45, 4096):
        block, border, (owner, rs, rt), quant = _sharded_inputs(
            cuda, rng, storage, nq, w, bw, offset, assembled)
        for shard in range(4):
            before = kernel.LAUNCHES["label_join_sharded"]
            got = kernel.sharded_gather_join(block, border, owner, shard, rs,
                                             rt, quant=quant)
            torch.cuda.synchronize()
            assert kernel.LAUNCHES["label_join_sharded"] == before + 1
            want = ref.sharded_gather_join_ref(block, border, owner, shard,
                                               rs, rt, quant=quant)
            assert torch.equal(got, want), (nq, shard)
            assert torch.isinf(got[owner != shard]).all()


@pytest.mark.parametrize("storage,w,bw,offset,vec", [
    ("float32", 256, 96, 0, 16), ("float32", 256, 93, 0, 4),
    ("float32", 96, 96, 1, 4), ("int16", 256, 96, 0, 16),
    ("int16", 256, 93, 0, 2), ("int16", 96, 92, 0, 8),
    ("int16", 96, 96, 1, 2), ("int16", 96, 0, 0, 16)])
def test_sharded_layout_fits_both_sources(cuda, storage, w, bw, offset, vec):
    """The vector width divides both pitches and both base addresses:
    B's q = 93 (odd) and an offset block narrow it."""
    dtype = torch.float32 if storage == "float32" else torch.int16
    block = _table_at(cuda, dtype, 8, w, offset)
    border = torch.zeros((8, bw), dtype=dtype, device=cuda)
    assert kernel.sharded_join_layout(block, border, 4096)[0] == vec


# the sharded kernel's three arithmetics: (storage, dequant_first)
MULTI_MODES = [("float32", False), ("uint16", False), ("uint16", True),
               ("int16", False), ("int16", True)]
# (item bytes, W, bw) → the widest vector both pitches allow: 16, 8, 4,
# and 2 (16-bit codes only)
MULTI_WIDTHS = {4: [(256, 96, 16), (96, 94, 8), (96, 93, 4)],
                2: [(256, 96, 16), (96, 92, 8), (96, 94, 4), (96, 93, 2)]}
MULTI_SHARDS = (1, 3, 8, 16, 64)
MULTI_BORDER_ROWS = 300


def _codes(rng, shape, storage):
    npdt = np.uint16 if storage == "uint16" else np.int16
    sentinel = int(np.iinfo(npdt).max)
    x = rng.integers(0, sentinel + 1, shape).astype(npdt)
    x[rng.random(shape) < 0.3] = sentinel
    return x.view(np.int16)


def _multi_inputs(cuda, rng, storage, dequant, e, nq, w, bw, offset,
                  row_sharded):
    """E shards on the card: blocks of 20 + 3d rows (shard 0's table
    ``offset`` elements off its alignment), each shard's own border
    source (replicated: a copy with other values; every fifth shard a
    server without a view, one min-identity row, whose lanes read only
    its block) or B's row slices; lanes of every shard but shard 1
    (owning none where E > 2) and a few outside the table."""
    quant = None
    if storage != "float32":
        sentinel = 0xFFFF if storage == "uint16" else 0x7FFF
        quant = (sentinel, 0.0731)      # lossy: (a + b)s != as + bs
    dtype = torch.float32 if quant is None else torch.int16
    make = (lambda shape: _rand_dist(rng, shape)) if quant is None \
        else (lambda shape: _codes(rng, shape, storage))
    rows = [20 + 3 * d for d in range(e)]
    blocks = []
    for d in range(e):
        blk = _table_at(cuda, dtype, rows[d], w, offset if d == 0 else 0)
        blk.copy_(torch.from_numpy(make((rows[d], w))))
        blocks.append(blk)
    n = MULTI_BORDER_ROWS
    rpd = -(-n // e)
    if row_sharded:
        whole = make((rpd * e, bw))
        borders = [torch.from_numpy(whole[d * rpd:(d + 1) * rpd]).to(cuda)
                   for d in range(e)]
    else:
        fill = float("inf") if quant is None else \
            int(np.array(quant[0], np.uint16).view(np.int16))
        borders = [torch.full((1, bw), fill, dtype=dtype, device=cuda)
                   if d % 5 == 2 else torch.from_numpy(make((n, bw))).to(cuda)
                   for d in range(e)]
    owner = rng.integers(0, e, nq)
    if e > 2:
        owner[owner == 1] = 0
    owner[::29] = -1
    owner[1::31] = e
    own_rows = np.array(rows + [1, 1])[owner]
    viewless = (owner % 5 == 2) & (owner < e) & (not row_sharded)
    kind = rng.integers(0, 3, nq)
    kind[viewless] = 0
    rs = np.where(kind == 1, own_rows + rng.integers(0, n, nq),
                  rng.integers(0, 20, nq))
    rt = np.where(kind >= 1, own_rows + rng.integers(0, n, nq),
                  rng.integers(0, 20, nq))
    ids = [torch.from_numpy(x.astype(np.int64)).to(cuda)
           for x in (owner, rs, rt)]
    kw = dict(rows_per_border_shard=rpd if row_sharded else None,
              quant=quant, dequant_first=dequant)
    return blocks, borders, ids, kw


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("row_sharded", [False, True])
@pytest.mark.parametrize("storage,dequant,w,bw,vec", [
    (st, dq, w, bw, vec) for st, dq in MULTI_MODES
    for w, bw, vec in MULTI_WIDTHS[4 if st == "float32" else 2]])
def test_multi_shard_kernel_matches_plain_version(cuda, storage, dequant, w,
                                                  bw, vec, row_sharded,
                                                  offset):
    """The whole-batch sharded join against its plain version, bit for
    bit: each arithmetic, B replicated (servers without views among
    them) and row-sharded, widths that force each vector width, shard
    0's table off its alignment, E = 1 to 64 with empty shards, one
    launch a call."""
    if offset:
        vec = 4 if storage == "float32" else 2
    rng = np.random.default_rng(w + bw + 7 * offset + 3 * row_sharded)
    for e in MULTI_SHARDS:
        for nq in (45, 4096):
            blocks, borders, (owner, rs, rt), kw = _multi_inputs(
                cuda, rng, storage, dequant, e, nq, w, bw, offset,
                row_sharded)
            assert kernel.multi_shard_join_layout(blocks, borders,
                                                  nq)[0] == vec
            before = kernel.LAUNCHES["label_join_sharded"]
            got = kernel.multi_shard_gather_join(blocks, borders, owner, rs,
                                                 rt, **kw)
            torch.cuda.synchronize()
            assert kernel.LAUNCHES["label_join_sharded"] == before + 1
            want = ref.multi_shard_gather_join_ref(blocks, borders, owner,
                                                   rs, rt, **kw)
            assert torch.equal(got, want), (e, nq)
            outside = (owner < 0) | (owner >= e)
            assert torch.isinf(got[outside]).all()
            assert torch.isfinite(got[~outside]).any()


@pytest.mark.parametrize("storage,dequant", MULTI_MODES)
@pytest.mark.parametrize("row_sharded", [False, True])
def test_multi_shard_kernel_ids_outside_their_source_give_inf(
        cuda, storage, dequant, row_sharded):
    """A row id past its source, or a negative one, is +inf and loads
    no row; every other lane is the plain version's."""
    rng = np.random.default_rng(11)
    e, nq = 8, 4096
    blocks, borders, (owner, rs, rt), kw = _multi_inputs(
        cuda, rng, storage, dequant, e, nq, 96, 93, 0, row_sharded)
    bad = torch.zeros(nq, dtype=torch.bool, device=cuda)
    bad[5::13] = True
    far = 20 + 3 * e + MULTI_BORDER_ROWS + 10 ** 6
    rs_bad = torch.where(bad, torch.full_like(rs, far), rs)
    rt_bad = rt.clone()
    rt_bad[7::41] = -3
    bad[7::41] = True
    got = kernel.multi_shard_gather_join(blocks, borders, owner, rs_bad,
                                         rt_bad, **kw)
    want = ref.multi_shard_gather_join_ref(
        blocks, borders, torch.where(bad, -1, owner), rs, rt, **kw)
    torch.cuda.synchronize()
    assert torch.isinf(got[bad]).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("what", [
    "too_many_shards", "widths_differ", "border_wider", "devices",
    "contiguity", "bfloat16", "dequant_without_codes", "slice_rows",
    "no_shards"])
def test_multi_shard_kernel_refuses_what_it_does_not_take(cuda, what):
    f32 = dict(dtype=torch.float32, device=cuda)
    blocks = [torch.zeros((4, 8), **f32) for _ in range(3)]
    borders = [torch.zeros((5, 6), **f32) for _ in range(3)]
    ids = torch.zeros(7, dtype=torch.int64, device=cuda)
    kw = {}
    if what == "too_many_shards":
        blocks = [blocks[0]] * (kernel.MAX_SHARDS + 1)
        borders = [borders[0]] * (kernel.MAX_SHARDS + 1)
    elif what == "widths_differ":
        blocks[1] = torch.zeros((4, 9), **f32)
    elif what == "border_wider":
        borders = [torch.zeros((5, 9), **f32) for _ in range(3)]
    elif what == "devices":
        borders[2] = borders[2].cpu()
    elif what == "contiguity":
        blocks[1] = torch.zeros((8, 4), **f32).t()
    elif what == "bfloat16":
        blocks = [b.bfloat16() for b in blocks]
        borders = [b.bfloat16() for b in borders]
    elif what == "dequant_without_codes":
        kw = dict(dequant_first=True)
    elif what == "slice_rows":
        borders[1] = torch.zeros((4, 6), **f32)
        kw = dict(rows_per_border_shard=5)
    else:
        blocks, borders = [], []
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError):
        kernel.multi_shard_gather_join(blocks, borders, ids, ids, ids, **kw)
    assert kernel.LAUNCHES == before


def test_card_serves_sharded_as_the_host_does(cuda):
    from repro_torch.edge import ShardedBatchedEngine, default_edge_mesh
    csr, part = synthetic_continent((2, 2), (8, 8), seed=3)
    g = csr.to_graph()
    on_card = EdgeSystem.deploy(g, part, device=cuda)
    on_host = EdgeSystem.deploy(g, part, device="cpu")
    rng = np.random.default_rng(1)
    ss = rng.integers(0, g.num_vertices, 500)
    ts = rng.integers(0, g.num_vertices, 500)
    want = on_host.service(ServingPolicy(label_dtype="float32")).submit(
        ss, ts).distances
    for shards in (1, 3):
        on_card.mesh = default_edge_mesh(shards, device=cuda)
        for border in (False, True):
            for dtype in ("float32", "uint16"):
                svc = on_card.service(ServingPolicy(
                    engine="sharded", shard_border=border, label_dtype=dtype))
                svc.submit(ss, ts)
                before = dict(kernel.LAUNCHES)
                np.testing.assert_array_equal(svc.submit(ss, ts).distances,
                                              want)
                assert kernel.LAUNCHES["label_join_sharded"] == \
                    before["label_join_sharded"] + 1
                assert kernel.LAUNCHES["label_join"] == before["label_join"]
                eng = svc.plan(ss, ts).plane
                assert isinstance(eng, ShardedBatchedEngine)
                assert all(b.is_cuda for b in eng.blocks + eng.btables)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_precision_tables_raise_on_the_card(cuda, dtype):
    """The kernel joins bfloat16 and float16 tables of one type; tables
    of two 16-bit float types (which the plain version mixes on the CPU)
    raise on the card, and say so, before any launch."""
    other = torch.float16 if dtype == torch.bfloat16 else torch.bfloat16
    s_table = torch.zeros((4, 6), dtype=dtype, device=cuda)
    t_table = torch.zeros((4, 6), dtype=other, device=cuda)
    ids = torch.zeros(2, dtype=torch.int64, device=cuda)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match="one dtype"):
        kernel.gather_join(s_table, ids, t_table, ids)
    assert kernel.LAUNCHES == before


# (Q, W) of chip_smoke.py's JOIN_SHAPES: widths 0 to 1024 (every vector
# width of 16-bit rows: 16, 8, 4 and 2 bytes), batches 1 to 65 536
HALF_JOIN_SHAPES = [(1, 1), (5, 7), (64, 128), (100, 257), (512, 512),
                    (3, 1024), (257, 33), (9, 0), (4096, 96), (65536, 96),
                    (4096, 256), (45, 6), (64, 12), (4096, 93), (1, 133),
                    (45, 96), (65536, 93)]


@pytest.mark.parametrize("with_lb", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("q,w", HALF_JOIN_SHAPES)
def test_half_precision_kernel_matches_plain_version(cuda, q, w, dtype,
                                                     with_lb):
    """bfloat16 and float16 rows: widened to float32, joined there, each
    result rounded once to the rows' type — bit for bit with the plain
    version (as the JAX package's join_pallas / join_lb_pallas), tables
    aligned and one element off their alignment."""
    rng = np.random.default_rng(q * 7 + w)
    for offset in (0, 1):
        s, t = _rand_dist(rng, (q + 5, w)), _rand_dist(rng, (q + 8, w))
        S = _table_at(cuda, dtype, q + 5, w, offset)
        T = _table_at(cuda, dtype, q + 8, w, offset)
        S.copy_(torch.from_numpy(s))
        T.copy_(torch.from_numpy(t))
        rs = torch.from_numpy(rng.integers(0, q + 5, q)).to(cuda)
        rt = torch.from_numpy(rng.integers(0, q + 8, q)).to(cuda)
        key = "label_join_lb" if with_lb else "label_join"
        before = kernel.LAUNCHES[key]
        got = kernel.gather_join(S, rs, T, rt, with_lb=with_lb)
        torch.cuda.synchronize()
        assert kernel.LAUNCHES[key] == before + 1
        want = ref.gather_join_ref(S.cpu(), rs.cpu(), T.cpu(), rt.cpu(),
                                   with_lb=with_lb)
        for g, x in zip(*((got, want) if with_lb else ((got,), (want,)))):
            assert g.dtype == dtype and g.shape == (q,)
            assert torch.equal(g.cpu().view(torch.int16),
                               x.view(torch.int16))


def _plus_zero_bits(x):
    """int32 patterns with -0.0 read as +0.0 (the DPX kernels' rule)."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits == -2 ** 31, torch.zeros_like(bits), bits)


# (batch or None, m, k, n): unaligned shapes, stage B's squarings above
# the fused closure's cap (q = 239, and 448 of the NY-scale build) and a
# large one, stage C's, and shapes ragged around the tiled kernel's 64-
# and 128-wide tiles and its 32-deep k parts; each dense (30 % +inf) and
# sparse (90 % +inf), with a row of A and a column of B all +inf and a
# -0.0 entry in each operand
@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("batch,m,k,n", [
    (None, 1, 1, 1), (None, 93, 93, 93), (None, 130, 70, 33),
    (16, 256, 8, 93), (3, 37, 0, 5), (None, 239, 239, 239),
    (None, 448, 448, 448), (None, 1024, 1024, 1024), (3, 65, 33, 129),
    (1, 1, 0, 5), (2, 130, 257, 64)])
def test_minplus_kernel_matches_plain_version(cuda, batch, m, k, n, kind):
    from repro_torch.kernels.minplus import kernel as mp, ref as mp_ref
    rng = np.random.default_rng(m + k + n)
    lead = () if batch is None else (batch,)
    a, b = _rand_dist(rng, (*lead, m, k)), _rand_dist(rng, (*lead, k, n))
    if kind == "sparse":
        a[rng.random(a.shape) < 0.9] = np.inf
        b[rng.random(b.shape) < 0.9] = np.inf
    a[..., m // 2, :] = np.inf
    b[..., n // 2] = np.inf
    if k:
        a.reshape(-1)[0] = b.reshape(-1)[-1] = -0.0
    a = torch.from_numpy(a).to(cuda)
    b = torch.from_numpy(b).to(cuda)
    layout = mp.minplus_layout(a, b)
    assert 1 <= layout["split"] <= 8 and layout["tile"] in (64, 128)
    before = mp.LAUNCHES["minplus"]
    got = mp.minplus(a, b)
    torch.cuda.synchronize()
    assert mp.LAUNCHES["minplus"] == before + 1
    assert torch.equal(_plus_zero_bits(got),
                       _plus_zero_bits(mp_ref.minplus_ref(a, b)))
    assert int((got.view(torch.int32) == -2 ** 31).sum()) == 0


@pytest.mark.parametrize("batch,s,v", [(None, 1, 1), (None, 8, 33),
                                       (4, 8, 256), (2, 13, 300),
                                       (16, 8, 129)])
def test_relax_kernel_matches_plain_version(cuda, batch, s, v):
    from repro_torch.kernels.minplus import kernel as mp, ref as mp_ref
    rng = np.random.default_rng(s * v)
    lead = () if batch is None else (batch,)
    d = torch.from_numpy(_rand_dist(rng, (*lead, s, v))).to(cuda)
    a = _rand_dist(rng, (*lead, v, v))
    a[rng.random(a.shape) < 0.9] = np.inf
    a = torch.from_numpy(a).to(cuda)
    keep = d.clone()
    before = mp.LAUNCHES["relax"]
    got = mp.relax(d, a)
    torch.cuda.synchronize()
    assert mp.LAUNCHES["relax"] == before + 1
    assert torch.equal(got, mp_ref.relax_ref(d, a))
    assert torch.equal(d, keep)                 # out of place


# the fused closure on each side of its cap (q <= 160: one launch; above:
# the tiled kernel's squarings), dense and 90 %-inf, at the fixed
# schedule and with early exits
@pytest.mark.parametrize("check", ["fixed", "from_0", "from_2"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("q", [1, 7, 93, 96, 128, 160, 161, 239])
def test_closure_kernel_matches_plain_version(cuda, q, kind, check):
    from repro_torch.kernels.minplus import kernel as mp, ops as mp_ops
    from repro_torch.kernels.minplus import ref as mp_ref
    rng = np.random.default_rng(q)
    w = _rand_dist(rng, (q, q))
    if kind == "sparse":
        w[rng.random(w.shape) < 0.9] = np.inf
    np.fill_diagonal(w, 0.0)
    d0 = torch.from_numpy(w).to(cuda)
    steps = mp_ops.closure_steps(q)
    check_from = {"fixed": steps, "from_0": 0, "from_2": 2}[check]
    before = dict(mp.LAUNCHES)
    got, depth = mp_ops.closure_squarings(d0, steps, check_from)
    depth = int(depth)
    fused = q <= mp.CLOSURE_MAX_Q
    assert mp.LAUNCHES["minplus_closure"] == before["minplus_closure"] \
        + int(fused)
    assert mp.LAUNCHES["minplus"] == before["minplus"] \
        + (0 if fused else min(steps, depth + 1))
    want, want_depth = mp_ref.closure_ref(d0, steps, check_from)
    assert depth == want_depth
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("check_from", [0, 3])
def test_closure_kernel_stops_at_a_warm_fixpoint(cuda, check_from):
    """From a converged closure (integral weights: every path sum exact)
    the first checked squaring returns its input."""
    from repro_torch.kernels.minplus import kernel as mp, ops as mp_ops
    rng = np.random.default_rng(5)
    w = np.ceil(_rand_dist(rng, (96, 96)))
    w[rng.random(w.shape) < 0.9] = np.inf
    np.fill_diagonal(w, 0.0)
    d0 = mp_ops.closure(torch.from_numpy(w).to(cuda))
    got, depth = mp.closure(d0, mp_ops.closure_steps(96), check_from)
    assert int(depth) == check_from
    assert torch.equal(got, d0)


# k-major products (batch or None, m, k, n): stage C at both sizes, n % 4
# != 0 (scalar stores), several column tiles, k = 0, 1, 32, and k = 33
# (the tiled kernel on a transposed copy)
@pytest.mark.parametrize("batch,m,k,n", [
    (16, 256, 8, 93), (16, 6400, 8, 96), (1, 6400, 8, 96), (None, 5, 1, 3),
    (3, 300, 32, 97), (2, 130, 8, 2048), (4, 129, 8, 1030), (3, 37, 0, 5),
    (2, 100, 33, 64)])
def test_minplus_kmajor_kernel_matches_plain_version(cuda, batch, m, k, n):
    from repro_torch.kernels.minplus import kernel as mp, ref as mp_ref
    rng = np.random.default_rng(m + k + n)
    lead = () if batch is None else (batch,)
    a_t = torch.from_numpy(_rand_dist(rng, (*lead, k, m))).to(cuda)
    b = torch.from_numpy(_rand_dist(rng, (*lead, k, n))).to(cuda)
    before = dict(mp.LAUNCHES)
    got = mp.minplus_kmajor(a_t, b)
    torch.cuda.synchronize()
    deep = k > mp.KMAJOR_MAX_K
    assert mp.LAUNCHES["minplus_kmajor"] == before["minplus_kmajor"] \
        + int(not deep)
    assert mp.LAUNCHES["minplus"] == before["minplus"] + int(deep)
    want = mp_ref.minplus_kmajor_ref(a_t, b)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _banded_card(rng, shape, band, cuda):
    a = _rand_dist(rng, shape)
    i, j = np.indices(shape[-2:])
    a[..., np.abs(i - j) > band] = np.inf
    return torch.from_numpy(a).to(cuda)


# the stage-A sweep shapes of the build and the repairs: all districts of
# n = 4096, one and two districts of n = 102 400 (split k ranges, banded
# occupancy), and ragged ones
@pytest.mark.parametrize("kind", ["banded", "random"])
@pytest.mark.parametrize("batch,s,v", [(16, 8, 256), (1, 8, 6400),
                                       (2, 8, 6400), (2, 13, 300),
                                       (3, 5, 129), (None, 8, 33)])
def test_relax_kernel_with_occupancy_matches_plain_version(cuda, kind,
                                                           batch, s, v):
    """The k-split relax kernel with and without the occupancy map
    against the plain version with and without it, bit for bit."""
    from repro_torch.kernels.minplus import kernel as mp, ref as mp_ref
    rng = np.random.default_rng(s + v)
    lead = () if batch is None else (batch,)
    d = torch.from_numpy(_rand_dist(rng, (*lead, s, v))).to(cuda)
    if kind == "banded":
        a = _banded_card(rng, (*lead, v, v), 80, cuda)
    else:
        a = _rand_dist(rng, (*lead, v, v))
        a[rng.random(a.shape) < 0.99] = np.inf
        a = torch.from_numpy(a).to(cuda)
    occ = mp.relax_occupancy(a)
    before = mp.LAUNCHES["relax"]
    got = mp.relax(d, a, occ)
    dense = mp.relax(d, a)
    torch.cuda.synchronize()
    assert mp.LAUNCHES["relax"] == before + 2
    want = mp_ref.relax_ref(d, a)
    assert torch.equal(got, want) and torch.equal(dense, want)
    assert torch.equal(mp_ref.relax_ref(d, a, occ), want)
    if kind == "banded" and v > 1000:
        assert float(occ.float().mean()) < 0.1


def test_card_builder_equals_the_host_reference(cuda):
    from repro_torch.core import build_border_labels_reference
    from repro_torch.edge import ComputingCenter
    from repro_torch.kernels.minplus import kernel as mp
    csr, part = synthetic_continent((2, 2), (8, 8), seed=3)
    g = csr.to_graph()
    before = dict(mp.LAUNCHES)
    center = ComputingCenter(g, part, builder="torch", device=cuda)
    center.rebuild()
    # stage B: one fused closure launch (q <= CLOSURE_MAX_Q); stage C:
    # the k-major product
    assert mp.LAUNCHES["minplus_closure"] == before["minplus_closure"] + 1
    assert mp.LAUNCHES["minplus_kmajor"] > before["minplus_kmajor"]
    assert mp.LAUNCHES["minplus"] == before["minplus"]
    assert mp.LAUNCHES["relax"] > before["relax"]
    want = build_border_labels_reference(g, part)
    np.testing.assert_array_equal(center.border_labels.table, want.table)
    assert center.border_table_device().is_cuda
    system = EdgeSystem.deploy(g, part, builder="torch", device=cuda)
    host = EdgeSystem.deploy(g, part, device="cpu")
    rng = np.random.default_rng(4)
    ss = rng.integers(0, g.num_vertices, 500)
    ts = rng.integers(0, g.num_vertices, 500)
    np.testing.assert_array_equal(system.service().submit(ss, ts).distances,
                                  host.service().submit(ss, ts).distances)


# flash attention: (B, S, T, H, KV, hd, causal, dtype) — the JAX
# package's test cases in float32, its bf16 case, then Qwen3-4B's head
# layout at ragged lengths, then OLMoE's and InternVL2's, StarCoder2's
# and Nemotron's
FLASH_CASES = [(1, 16, 16, 4, 4, 32, True, torch.float32),
               (2, 32, 32, 4, 2, 32, True, torch.float32),
               (1, 64, 64, 8, 2, 16, False, torch.float32),
               (2, 24, 24, 6, 2, 32, True, torch.float32),
               (1, 128, 128, 4, 1, 64, True, torch.float32),
               (1, 32, 32, 4, 4, 32, True, torch.bfloat16),
               (1, 200, 200, 32, 8, 128, True, torch.bfloat16),
               (2, 77, 77, 32, 8, 128, False, torch.bfloat16),
               (1, 100, 130, 32, 8, 128, True, torch.float32),
               (1, 200, 200, 8, 2, 192, True, torch.bfloat16),
               (1, 100, 130, 32, 8, 128, True, torch.bfloat16),
               (2, 130, 100, 8, 8, 64, False, torch.bfloat16),
               (1, 50, 50, 4, 4, 16, True, torch.bfloat16),
               # OLMoE-1B-7B (MHA 16/16) and InternVL2-26B (GQA 48/8)
               (2, 300, 300, 16, 16, 128, True, torch.bfloat16),
               (1, 260, 260, 48, 8, 128, True, torch.bfloat16),
               (1, 100, 100, 48, 8, 128, True, torch.float32)] + [
    # StarCoder2-7B's group of 9 (36/4) and Nemotron-4-340B's heads
    # (96/8, hd 192), S != T for Nemotron
    (1, 200, t, h, kv, hd, causal, torch.bfloat16)
    for t, h, kv, hd in ((200, 36, 4, 128), (130, 96, 8, 192))
    for causal in (True, False)] + [
    # head dims beside the instances' widths (48 in the 64 instance, 80
    # HuBERT-XLarge's own, 96 in the 128 one, 192) in every dtype the
    # card takes, causal and not, MHA 16/16 and GQA 48/8, S != T
    (1, 200, 130, h, kv, hd, causal, dtype)
    for hd in (48, 80, 96, 192)
    for dtype in (torch.bfloat16, torch.float16, torch.float32)
    for causal in (True, False)
    for h, kv in ((16, 16), (48, 8))]


def _half_bound_ratio(got, q, k, v, causal: bool) -> float:
    """Largest |got - want| over its bound, elementwise, where want is
    the plain version in f32 on the same 16-bit inputs and the bound is

        ulp(max(|got|, |want|)) + 2u * attention(q, k, |v|) + 2e-5,

    ulp and u of the input type (u = 2^-9 in bf16, 2^-12 in f16: the
    same form in both). The tensor-core kernel rounds each p to the input
    type before P.V (relative error <= u) while l sums the unrounded p,
    so its f32 result is off by at most u * sum_j p_j |v_j| / l; the
    bound allows twice that, plus the f32 order-of-sums bound (2e-5) and
    one ulp for the output's one rounding."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    mantissa = 7 if q.dtype == torch.bfloat16 else 10
    want = fa_ref.attention_ref(q.float(), k.float(), v.float(),
                                causal=causal)
    mass = fa_ref.attention_ref(q.float(), k.float(), v.float().abs(),
                                causal=causal)
    g = got.float()
    mag = torch.maximum(g.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mantissa)
    bound = ulp + 2.0 ** -(mantissa + 1) * mass + 2e-5
    return float(((g - want).abs() / bound).max())


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain_version(cuda, b, s, t, h, kv, hd,
                                            causal, dtype):
    """float32: within 2e-5 of the plain version (both f32; only the
    order of the sums and the online rescaling differ). bf16 and f16:
    within the bound of ``_half_bound_ratio`` (P rounded to the input
    type before P.V)."""
    from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
    gen = torch.Generator(device=cuda).manual_seed(s * 31 + hd)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, t, kv, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, t, kv, hd), generator=gen, device=cuda).to(dtype)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        want = fa_ref.attention_ref(q, k, v, causal=causal)
        assert float((got - want).abs().max()) <= 2e-5
    else:
        assert _half_bound_ratio(got, q, k, v, causal) <= 1.0


def test_flash_kernel_reads_strided_inputs(cuda):
    """q, k, v as the head-split views of fused projections (strided in
    the sequence and head axes, contiguous in hd)."""
    from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn((2, 50, 48, 64), generator=gen, device=cuda)
    q, k, v = qkv[:, :, :32], qkv[:, :, 32:40], qkv[:, :, 40:]
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert float((got - fa_ref.attention_ref(q, k, v)).abs().max()) <= 2e-5


def test_flash_bf16_kernel_reads_strided_inputs(cuda):
    """The bf16 tensor-core kernel through TMA on the head-split views of
    a fused projection at Qwen3-4B's head layout (strides in the sequence
    and head axes are multiples of 16 bytes, as TMA needs)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((2, 150, 48, 128), generator=gen,
                      device=cuda).bfloat16()
    q, k, v = qkv[:, :, :32], qkv[:, :, 32:40], qkv[:, :, 40:]
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert _half_bound_ratio(got, q, k, v, True) <= 1.0


@pytest.mark.parametrize("what", ["base", "seq_stride"])
def test_flash_bf16_kernel_rejects_misaligned_inputs(cuda, what):
    """TMA needs a 16-byte-aligned base and strides in multiples of 16
    bytes: anything else raises ValueError, with no launch and no copy."""
    from repro_torch.kernels.flash_attention import kernel as fa
    if what == "base":                  # starts 2 bytes past alignment
        q = torch.zeros(8 * 4 * 64 + 1, dtype=torch.bfloat16,
                        device=cuda)[1:].view(1, 8, 4, 64)
    else:                               # rows 4 * 64 + 4 elements apart
        q = torch.zeros((1, 8, 4 * 64 + 4), dtype=torch.bfloat16,
                        device=cuda)[..., :256].view(1, 8, 4, 64)
    kv = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=cuda)
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv)
    assert fa.LAUNCHES == before


# what the card still refuses: a head dim above 192 (no instance), a
# bf16 / f16 head dim that is not a multiple of 8 (TMA's 16-byte strides),
# float64 (no kernel), H not a multiple of KV, and more than 65 535 (b, h)
# pairs in the tensor-core kernel (its grid's y)
@pytest.mark.parametrize("what", ["head_dim_256", "head_dim_bf16_36",
                                  "head_dim_f16_20", "float64", "groups",
                                  "bf16_batch_heads"])
def test_flash_kernel_rejects_unsupported_inputs_on_cuda(cuda, what):
    from repro_torch.kernels.flash_attention import kernel as fa
    shapes = {"head_dim_256": ((1, 8, 4, 256), (1, 8, 2, 256),
                               torch.float32),
              "head_dim_bf16_36": ((1, 8, 4, 36), (1, 8, 2, 36),
                                   torch.bfloat16),
              "head_dim_f16_20": ((1, 8, 4, 20), (1, 8, 2, 20),
                                  torch.float16),
              "float64": ((1, 8, 4, 32), (1, 8, 2, 32), torch.float64),
              "groups": ((1, 8, 3, 32), (1, 8, 2, 32), torch.float32),
              "bf16_batch_heads": ((16385, 1, 4, 8), (16385, 1, 4, 8),
                                   torch.bfloat16)}
    qs, kvs, dtype = shapes[what]
    q = torch.zeros(qs, dtype=dtype, device=cuda)
    kv = torch.zeros(kvs, dtype=dtype, device=cuda)
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv)
    assert fa.LAUNCHES == before


def test_lm_prefill_launches_flash_once_per_layer_and_decode_never(cuda):
    """A 2-layer smoke model on the card: flash prefill agrees with the
    dense prefill, launches the kernel once per layer; decode_step
    launches it never and agrees with the forward pass."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import lm
    from repro_torch.train.train_step import make_prefill_step
    cfg = get_smoke_config("qwen3_4b").reduced(num_layers=2,
                                               compute_dtype="float32")
    flash = dataclasses.replace(cfg, attention_impl="flash")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = lm.init_params(cfg, gen, cuda)
    tok = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                        device=cuda)
    before = fa.LAUNCHES["flash_attention"]
    got = make_prefill_step(flash)(params, {"tokens": tok})
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + cfg.num_layers
    want = make_prefill_step(cfg)(params, {"tokens": tok})
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    full = lm.forward(params, flash, {"tokens": tok}) \
        @ lm.lm_head_weight(params, flash)
    cache = lm.init_cache(cfg, 2, 40, cuda)
    before = fa.LAUNCHES["flash_attention"]
    for i in range(40):
        logits, cache = lm.decode_step(params, cfg, cache, tok[:, i:i + 1],
                                       i)
        assert float((logits[:, 0] - full[:, i]).abs().max()
                     / full[:, i].abs().max()) <= 1e-4
    assert fa.LAUNCHES["flash_attention"] == before


# Floyd–Warshall: bit for bit on integral weights (every path sum is
# exact, whatever the blocked order), rtol 1e-5 on real ones (the JAX
# package's tolerance for its blocked kernel against the rank-1 loop)
@pytest.mark.parametrize("integral", [True, False])
@pytest.mark.parametrize("n", [1, 33, 64, 100, 128, 130, 257, 300])
def test_floyd_warshall_kernel_matches_plain_version(cuda, n, integral):
    from repro_torch.kernels.sssp_relax import kernel as fw, ref as fw_ref
    rng = np.random.default_rng(n)
    adj = _rand_dist(rng, (n, n))
    if integral:
        adj = np.ceil(adj)
    adj[rng.random((n, n)) < 0.8] = np.inf
    adj = torch.from_numpy(np.minimum(adj, adj.T)).to(cuda)
    keep = adj.clone()
    before = fw.LAUNCHES["floyd_warshall"]
    got = fw.floyd_warshall(adj)
    torch.cuda.synchronize()
    assert fw.LAUNCHES["floyd_warshall"] == before + fw.launches_per_call(n)
    assert torch.equal(adj, keep)               # out of place
    want = fw_ref.floyd_warshall_ref(adj)
    if integral:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [130, 640])
def test_floyd_warshall_phases_match_plain_version(cuda, n):
    """The phase entry, pivot by pivot: bit for bit with the plain
    version on integral weights, with a -0.0 weight among them."""
    from repro_torch.kernels.sssp_relax import kernel as fw, ref as fw_ref
    rng = np.random.default_rng(n)
    adj = np.ceil(_rand_dist(rng, (n, n)))
    adj[rng.random((n, n)) < 0.9] = np.inf
    adj[0, 1] = adj[1, 0] = -0.0
    adj = torch.from_numpy(np.minimum(adj, adj.T)).to(cuda)
    d = fw.working_copy(adj)
    assert not bool(torch.signbit(d).any())
    big = d.shape[0]
    ct = torch.empty((fw.TILE, big), device=cuda)
    fn = fw.phase_entry()
    stream = torch.cuda.current_stream().cuda_stream
    for kb in range(big // fw.TILE):
        for phase in (1, 2, 3):
            assert fn(d.data_ptr(), ct.data_ptr(), big, kb, phase,
                      stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(d[:n, :n], fw_ref.floyd_warshall_ref(adj))


def test_floyd_warshall_bf16_and_district_rows_on_card(cuda):
    """bf16 through the entry point, and each district's APSP border
    rows against stage A of the card's staged build, bit for bit."""
    from repro_torch.core import torch_builder
    from repro_torch.kernels.sssp_relax import ops as fw_ops, ref as fw_ref
    rng = np.random.default_rng(3)
    small = rng.integers(1, 5, (70, 70)).astype(np.float32)
    small[rng.random(small.shape) < 0.7] = np.inf
    small = torch.from_numpy(np.minimum(small, small.T)).to(cuda)
    got = fw_ops.floyd_warshall(small.bfloat16())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), fw_ref.floyd_warshall_ref(small))
    csr, part = synthetic_continent((2, 2), (12, 12), seed=3)
    _, state = torch_builder.build_border_labels_stages(
        csr.to_graph(), part, device=cuda)
    packed = state.packed
    for i in range(packed.num_districts):
        k = int((packed.vertex_ids[i] >= 0).sum())
        apsp = fw_ops.floyd_warshall(
            torch.from_numpy(packed.adj[i, :k, :k]).to(cuda)).cpu().numpy()
        pos = packed.border_pos[i][packed.border_pos[i] >= 0]
        np.testing.assert_array_equal(apsp[pos],
                                      state.intra[i, :len(pos), :k])


def test_repairs_on_card_equal_repairs_on_host(cuda):
    """apply_delta and apply_structural on the card against the same
    repairs on the CPU: every BuildState field and report field equal,
    and the card's device table the repaired one."""
    from repro_torch.ingest import closure_storm
    from repro_torch.kernels.minplus import kernel as mp
    from repro_torch.update import IncrementalBuilder, scenario_weights
    csr, part = synthetic_continent((2, 2), (12, 12), seed=3)
    g = csr.to_graph()
    builders = [IncrementalBuilder(device=d) for d in (cuda, "cpu")]
    for b in builders:
        b.build_full(g, part)
    epochs = []
    cur = g
    for name in ("incident", "regional", "jitter"):
        cur = cur.with_weights(scenario_weights(
            name, cur, part, np.random.default_rng(len(name)), 0.02))
        epochs.append(("delta", cur))
    # side streets first (the scoped rung), then highways (border churn)
    for bias, seed in ((1.0, 1), (0.0, 2)):
        for g_new, _ in closure_storm(cur, part, num_epochs=2,
                                      intensity=0.02, intra_bias=bias,
                                      seed=seed):
            epochs.append(("structural", g_new))
        cur = g_new
    for kind, g_new in epochs:
        before = dict(mp.LAUNCHES)
        reps = [getattr(b, f"apply_{kind}")(g_new, part)[1]
                for b in builders]
        card, host = builders
        if reps[0]["incremental"] and len(reps[0]["dirty_districts"]):
            assert mp.LAUNCHES["relax"] > before["relax"]
        for k in reps[1]:
            if k != "seconds":
                np.testing.assert_array_equal(np.asarray(reps[0][k]),
                                              np.asarray(reps[1][k]))
        for f in ("intra", "overlay", "closure", "unpruned", "table"):
            np.testing.assert_array_equal(getattr(card.state, f),
                                          getattr(host.state, f))
        assert card.state.table_device.is_cuda
        np.testing.assert_array_equal(card.state.table_device.cpu().numpy(),
                                      card.state.table)


def _scatter_pair(cuda):
    """One deployed index on the CPU and its copy on the card."""
    from repro_torch.convert import index_to_numpy, system_from_numpy
    csr, part = synthetic_continent((2, 2), (8, 8), seed=3)
    g = csr.to_graph()
    on_host = EdgeSystem.deploy(g, part, device="cpu")
    return g, on_host, system_from_numpy(index_to_numpy(on_host),
                                         device=cuda)


def _scatter_spec(system, storage):
    from repro_torch.core import QuantSpec, fit_label_spec
    btable = system.center.border_labels.table
    locals_ = [srv.augmented for srv in system.servers]
    if storage == "float32":
        return None
    if storage == "uint16":
        return fit_label_spec(btable, locals_, dtype=np.uint16)
    vmax = float(btable[np.isfinite(btable)].max())
    return QuantSpec(vmax / 30000.0, np.int16, lossless=False)


@pytest.mark.parametrize("storage", ["float32", "uint16", "int16_lossy"])
def test_card_scatter_plane_equals_host_and_runs_no_plain_join(
        cuda, monkeypatch, storage):
    """The scatter plane on the card answers as the same plane on the
    CPU (float32, uint16 and a lossy int16 spec), with one sharded-kernel
    launch a batch and no plain join."""
    from repro_torch.edge import ScatterGatherPlane
    g, on_host, on_card = _scatter_pair(cuda)
    rng = np.random.default_rng(4)
    ss = rng.integers(0, g.num_vertices, 700)
    ts = rng.integers(0, g.num_vertices, 700)
    host_plane = ScatterGatherPlane.from_system(
        on_host, quant=_scatter_spec(on_host, storage))
    want = host_plane.execute(ss, ts)

    def no_plain(*a, **k):
        raise AssertionError("a plain join ran for the card's plane")

    monkeypatch.setattr(kernel, "gather_join_ref", no_plain)
    monkeypatch.setattr(kernel, "sharded_gather_join_ref", no_plain)
    monkeypatch.setattr(kernel, "multi_shard_gather_join_ref", no_plain)
    plane = ScatterGatherPlane.from_system(
        on_card, quant=_scatter_spec(on_card, storage))
    before = dict(kernel.LAUNCHES)
    got = plane.execute(ss, ts)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    assert {k: kernel.LAUNCHES[k] - before[k] for k in before} == {
        **{k: 0 for k in before}, "label_join_sharded": 1}
    assert all(b.is_cuda for b in plane._blocks)
    assert all(v.is_cuda for v in plane._bviews if v is not None)
    assert plane.size_bytes() == host_plane.size_bytes()
    assert plane.exchange_stats == host_plane.exchange_stats


def test_card_faulted_replay_equals_host(cuda):
    from repro_torch.edge import FaultPlan, ScatterGatherPlane
    g, on_host, on_card = _scatter_pair(cuda)
    rng = np.random.default_rng(6)
    ss = rng.integers(0, g.num_vertices, 500)
    ts = rng.integers(0, g.num_vertices, 500)
    plan = FaultPlan(seed=23, peer_drop_rate=0.3, peer_timeout_rate=0.4,
                     peer_slow_rate=0.2, server_outage_rate=0.2,
                     max_retries=2)
    runs = []
    for system in (on_host, on_card, on_card):
        for srv in system.servers:
            own = srv._border_rows.get(srv.district_id)
            srv._border_rows = {} if own is None else {srv.district_id: own}
        plane = ScatterGatherPlane.from_system(system, faults=plan)
        out = plane.execute(ss, ts)
        runs.append((out.tobytes(), plane.exactness_codes.tobytes(),
                     tuple(plane.degraded), dict(plane.exchange_stats),
                     tuple(plane.faults.events)))
    assert runs[1] == runs[0] and runs[2] == runs[0]


# -- training and ingest (slice 10) -------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_4b", "starcoder2_7b",
                                  "nemotron_4_340b"])
def test_card_train_step_equals_the_cpu_step(cuda, arch):
    """One float32 train step of a 2-layer smoke model (SwiGLU, GELU and
    squared-ReLU MLPs) on the card and
    on the CPU from the same params (TF32 off): the loss within rel 1e-5,
    every updated param within rel 1e-4 of its L2 norm (Adam divides by
    each gradient's own magnitude, so near-zero gradients amplify the
    kernels' other summation order), and the state stays on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.train.data import DataConfig, synthetic_batch, to_device
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_smoke_config(arch).reduced(num_layers=2,
                                         compute_dtype="float32",
                                         ce_chunk=16)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        host = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = tree_map(lambda t: t.to(cuda), host)
        batch = synthetic_batch(cfg, DataConfig(32, 4, seed=1), 0)
        step = make_train_step(cfg, OptimizerConfig(warmup_steps=1))
        ph, _, mh = step(host, init_opt_state(host), to_device(batch, "cpu"))
        pc, sc, mc = step(card, init_opt_state(card), to_device(batch, cuda))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(float(mc["loss"]) - float(mh["loss"])) \
        <= 1e-5 * abs(float(mh["loss"]))
    for a, b in zip(tree_leaves(pc), tree_leaves(ph)):
        assert a.is_cuda
        a, b = a.cpu().double(), b.double()
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-4
    assert all(t.is_cuda for t in tree_leaves(sc["m"]))


def test_card_loss_falls_in_bf16(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.train.data import DataConfig, synthetic_batch, to_device
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = get_smoke_config("qwen3_4b").reduced(num_layers=2)
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            cuda)
    opt = init_opt_state(params)
    batch = to_device(synthetic_batch(cfg, DataConfig(32, 4, seed=1), 0),
                      cuda)
    step = make_train_step(cfg, OptimizerConfig(peak_lr=5e-3,
                                                warmup_steps=2))
    losses = []
    for _ in range(10):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_card_builds_a_center_from_a_gr_file(cuda, tmp_path):
    """A synthetic continent written as a gzip ``.gr`` file, streamed
    back through ``load_gr_csr`` and deployed on the card: the CSR equals
    the generator's, B the host hierarchical builder's, and the rule-3
    answers Dijkstra's."""
    import gzip
    from repro_torch.core import build_border_labels_hierarchical, dijkstra
    from repro_torch.edge import ComputingCenter
    from repro_torch.ingest import load_gr_csr
    from repro_torch.kernels.minplus import kernel as mp_kernel
    csr, part = synthetic_continent(grid=(3, 3), district=(12, 12),
                                    border_links=2, seed=5)
    us = np.repeat(np.arange(csr.num_vertices), np.diff(csr.indptr))
    path = tmp_path / "c.gr.gz"
    with gzip.open(path, "wt") as f:
        f.write(f"p sp {csr.num_vertices} {len(us)}\n")
        np.savetxt(f, np.column_stack([us + 1, csr.indices + 1,
                                       csr.weights.astype(np.int64)]),
                   fmt="a %d %d %d")
    got = load_gr_csr(str(path), chunk_arcs=1000)
    for name in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(got, name), getattr(csr, name))
    g = got.to_graph()
    before = dict(mp_kernel.LAUNCHES)
    center = ComputingCenter(g, part, builder="torch", device=cuda)
    center.rebuild()
    assert mp_kernel.LAUNCHES["relax"] > before["relax"]
    np.testing.assert_array_equal(center.border_labels.table,
                                  build_border_labels_hierarchical(
                                      g, part).table)
    rng = np.random.default_rng(2)
    ss = rng.integers(0, g.num_vertices, 400)
    ts = rng.integers(0, g.num_vertices, 400)
    cross = part.assignment[ss] != part.assignment[ts]
    ss, ts = ss[cross], ts[cross]
    ans = center.answer_cross_many(ss, ts)
    for i in range(8):
        assert ans[i] == np.float32(dijkstra(g, int(ss[i]))[ts[i]])


# -- MoE and MLA (slice 11) ------------------------------------------------------

def _moe_case(dev, cf, skew, seed=0, e=16, k=4):
    """A MoE layer at smoke width (E 16, top-4) in float32 on ``dev``
    (router skewed to expert 0 by ``skew``), and its input."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    cfg = get_smoke_config("olmoe_1b_7b").reduced(
        num_experts=e, experts_per_token=k, moe_capacity_factor=cf,
        compute_dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    p = moe.moe_init(gen, cfg, torch.float32, torch.device("cpu"))
    p["router"][:, 0] += skew / cfg.d_model ** 0.5
    x = torch.randn((4, 64, cfg.d_model), generator=gen) + (0.5 if skew
                                                            else 0.0)
    return cfg, {k_: v.to(dev) for k_, v in p.items()}, x.to(dev)


def _topk_gap(cfg, p, x) -> float:
    """The smallest gap between a token's k-th and (k+1)-th router
    logit (the softmax keeps their order): routing can differ between
    two devices only where the devices' float32 logits differ by more
    than that."""
    tokens = x.reshape(-1, cfg.d_model).cpu()
    logits = tokens @ p["router"].cpu()
    top = torch.topk(logits, cfg.experts_per_token + 1, dim=-1).values
    return float((top[:, -2] - top[:, -1]).min())


@pytest.mark.parametrize("cf,skew", [(16.0, 0.0), (1.25, 0.0), (1.25, 4.0)])
def test_moe_apply_on_card_equals_the_cpu(cuda, cf, skew):
    """float32 (TF32 off): the same routing as integers (ids, sort,
    kept slots; drops happen under the skew) and the output within
    1e-5. The test first checks that every top-k boundary gap of the
    logits exceeds 1e-5, above the devices' float32 differences (at
    most ≈ 1e-6 on these logits of order 1: 128-term sums at 2^-24
    relative a term), so that routing must agree."""
    from repro_torch.models import moe
    cfg, pc, xc = _moe_case(cuda, cf, skew)
    ph = {k: v.cpu() for k, v in pc.items()}
    xh = xc.cpu()
    assert _topk_gap(cfg, ph, xh) > 1e-5
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = moe.moe_apply(pc, cfg, xc)
        gates, ids = moe.route(pc["router"], xc.reshape(-1, cfg.d_model),
                               cfg.experts_per_token)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = moe.moe_apply(ph, cfg, xh)
    wg, wi = moe.route(ph["router"], xh.reshape(-1, cfg.d_model),
                       cfg.experts_per_token)
    assert torch.equal(ids.cpu(), wi)
    assert float((gates.cpu() - wg).abs().max()) <= 1e-6
    t = xh.shape[0] * xh.shape[1]
    cap = moe.capacity(cf, t, cfg.experts_per_token, cfg.num_experts)
    plan = moe.dispatch_plan(ids, cfg.num_experts, cap)
    for a, b in zip(plan, moe.dispatch_plan(wi, cfg.num_experts, cap)):
        assert torch.equal(a.cpu(), b)
    dropped = bool((~plan[1]).any())
    if skew:
        assert dropped
    if cf == cfg.num_experts:
        assert not dropped
    assert float((got.cpu() - want).abs().max()) <= 1e-5


def test_moe_apply_twice_on_card_gives_the_same_bits(cuda):
    """The combine sums each token's contributions in one fixed order,
    so two runs (capacity drops included, bf16) are equal bit for bit."""
    from repro_torch.models import moe
    cfg, p, x = _moe_case(cuda, 1.25, 4.0, seed=1, e=64, k=8)
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    x = x.to(torch.bfloat16).repeat(1, 8, 1)
    a = moe.moe_apply(p, cfg, x)
    b = moe.moe_apply(p, cfg, x)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("skew", [0.0, 4.0])
def test_moe_ep_path_on_card_equals_the_cpu(cuda, monkeypatch, skew):
    """``moe_apply``'s expert-parallel path on a (2, 4) mesh of logical
    shards (16 experts, 4 a model shard, capacity from a data shard's
    tokens), float32, TF32 off: every shard's routing plan (ids, sort,
    kept slots; drops under the skew) equal as integers to the CPU's,
    the output within 1e-5."""
    from repro_torch.distributed.act_sharding import (ActivationSharding,
                                                      activation_sharding)
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import moe
    cfg, pc, xc = _moe_case(cuda, 1.25, skew)
    ph = {k: v.cpu() for k, v in pc.items()}
    xh = xc.cpu()
    assert _topk_gap(cfg, ph, xh) > 1e-5
    plans = []
    real = moe.dispatch_plan

    def recorded(ids, e, cap):
        out = real(ids, e, cap)
        plans.append((e, cap, [ids, *out]))
        return out

    monkeypatch.setattr(moe, "dispatch_plan", recorded)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    ctx = ActivationSharding(AbstractMesh((2, 4), ("data", "model")), "data")
    with activation_sharding(ctx):
        got = moe.moe_apply(pc, cfg, xc)
        torch.cuda.synchronize()
        want = moe.moe_apply(ph, cfg, xh)
    assert len(plans) == 16
    dropped = 0
    for (e, cap, a), (e_h, cap_h, b) in zip(plans[:8], plans[8:]):
        assert (e, cap) == (e_h, cap_h)
        for u, v in zip(a, b):
            assert torch.equal(u.cpu(), v)
        ids, order, keep, _ = b
        flat = ids.reshape(-1)
        local = ((flat >= 0) & (flat < e))[order]
        dropped += int((local & ~keep).sum())
    if skew:
        assert dropped > 0
    assert float((got.cpu() - want).abs().max()) <= 1e-5


def test_mla_decode_on_card_equals_the_cpu(cuda):
    """DeepSeek-V2's smoke widths, float32, six decode steps from a cache
    of random values: each output and the written slots within 1e-4 of
    the CPU's, every other slot unchanged bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention
    cfg = get_smoke_config("deepseek_v2_236b")
    gen = torch.Generator().manual_seed(2)
    ph = attention.mla_init(gen, cfg, torch.float32, torch.device("cpu"))
    pc = {k: v.to(cuda) for k, v in ph.items()}
    b, t = 3, 16
    ch = {"latent": torch.randn((b, t, cfg.kv_lora_rank), generator=gen),
          "k_rope": torch.randn((b, t, 1, cfg.qk_rope_head_dim),
                                generator=gen)}
    cc = {k: v.to(cuda) for k, v in ch.items()}
    start = {k: v.clone() for k, v in ch.items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        positions = [0, 1, 2, 7, 3, 15]
        for pos in positions:
            x = torch.randn((b, 1, cfg.d_model), generator=gen)
            yh, _ = attention.mla_decode(ph, cfg, x, ch, pos)
            yc, _ = attention.mla_decode(pc, cfg, x.to(cuda), cc, pos)
            assert float((yc.cpu() - yh).abs().max()) <= 1e-4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for k in ("latent", "k_rope"):
        got = cc[k].cpu()
        assert float((got[:, positions] - ch[k][:, positions]).abs()
                     .max()) <= 1e-4
        rest = [j for j in range(t) if j not in positions]
        assert torch.equal(got[:, rest], start[k][:, rest])


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b",
                                  "internvl2_26b", "starcoder2_7b",
                                  "deepseek_67b", "nemotron_4_340b"])
def test_family_prefill_and_decode_on_card(cuda, arch):
    """The smoke configs on the card in float32: the flash prefill (GQA
    layers launch the kernel once each; MLA attends densely) agrees with
    the dense prefill and decode never launches flash; decode agrees
    with the forward pass at every position."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import lm
    from repro_torch.train.train_step import make_prefill_step
    cfg = get_smoke_config(arch).reduced(compute_dtype="float32")
    flash = dataclasses.replace(cfg, attention_impl="flash")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = lm.init_params(cfg, gen, cuda)
    tok = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                        device=cuda)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = fa.LAUNCHES["flash_attention"]
        got = make_prefill_step(flash)(params, {"tokens": tok})
        torch.cuda.synchronize()
        launched = fa.LAUNCHES["flash_attention"] - before
        want = make_prefill_step(cfg)(params, {"tokens": tok})
        full = lm.forward(params, cfg, {"tokens": tok}) \
            @ lm.lm_head_weight(params, cfg)
        cache = lm.init_cache(cfg, 2, 24, cuda)
        before = fa.LAUNCHES["flash_attention"]
        for i in range(24):
            logits, cache = lm.decode_step(params, cfg, cache,
                                           tok[:, i:i + 1], i)
            assert float((logits[:, 0] - full[:, i]).abs().max()
                         / full[:, i].abs().max()) <= 1e-4
        assert fa.LAUNCHES["flash_attention"] == before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert launched == (0 if cfg.use_mla else cfg.num_layers)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


@pytest.fixture
def no_tf32():
    """float32 matmuls in float32 (not TF32) while the test runs."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("t,chunk", [(256, 64), (200, 64)])
def test_ssd_chunked_on_card_equals_the_cpu(cuda, no_tf32, t, chunk):
    """Four chunks of 64, and 200 tokens (one chunk of 200): float32 on
    both sides, only the order of sums differs (relative 1e-5)."""
    from repro_torch.models.mamba2 import ssd_chunked
    rng = np.random.default_rng(t)
    b, h, p, n = 2, 8, 16, 32
    host = [torch.from_numpy(a) for a in (
        rng.normal(size=(b, t, h, p)).astype(np.float32),
        rng.uniform(0.01, 0.2, size=(b, t, h)).astype(np.float32),
        -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
        rng.normal(size=(b, t, h, n)).astype(np.float32),
        rng.normal(size=(b, t, h, n)).astype(np.float32))]
    y, s = ssd_chunked(*(a.to(cuda) for a in host), chunk)
    y_want, s_want = ssd_chunked(*host, chunk)
    for got, want in ((y, y_want), (s, s_want)):
        assert got.is_cuda
        assert float((got.cpu() - want).abs().max()
                     / want.abs().max()) <= 1e-5


def test_mamba2_forward_and_decode_on_card_equal_the_cpu(cuda, no_tf32):
    """A 2-layer Mamba2 smoke model in float32: the forward on the card
    against the host (two SSD chunks), and decode_step on the card
    against its forward at every position."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    cfg = get_smoke_config("mamba2_1_3b").reduced(compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    host = lm.init_params(cfg, gen, "cpu")
    params = tree_map(lambda t: t.to(cuda), host)
    tok = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    got = lm.forward(params, cfg, {"tokens": tok.to(cuda)})
    want = lm.forward(host, cfg, {"tokens": tok})
    assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-4
    full = got @ lm.lm_head_weight(params, cfg)
    cache = lm.init_cache(cfg, 2, 32, cuda)
    for i in range(32):
        logits, cache = lm.decode_step(params, cfg, cache,
                                       tok[:, i:i + 1].to(cuda), i)
        assert float((logits[:, 0] - full[:, i]).abs().max()
                     / full[:, i].abs().max()) <= 1e-4


def test_zamba2_flash_prefill_on_card_matches_dense(cuda, no_tf32):
    """Zamba2's smoke config at 4 layers in float32: the flash prefill
    launches the kernel once per shared application (2) and agrees
    with the dense prefill; decode launches it never and agrees with
    the forward pass."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import lm
    from repro_torch.train.train_step import make_prefill_step
    cfg = get_smoke_config("zamba2_1_2b").reduced(num_layers=4,
                                                  compute_dtype="float32")
    flash = dataclasses.replace(cfg, attention_impl="flash")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = lm.init_params(cfg, gen, cuda)
    tok = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                        device=cuda)
    before = fa.LAUNCHES["flash_attention"]
    got = make_prefill_step(flash)(params, {"tokens": tok})
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 2
    want = make_prefill_step(cfg)(params, {"tokens": tok})
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    full = lm.forward(params, cfg, {"tokens": tok}) \
        @ lm.lm_head_weight(params, cfg)
    cache = lm.init_cache(cfg, 2, 32, cuda)
    before = fa.LAUNCHES["flash_attention"]
    for i in range(32):
        logits, cache = lm.decode_step(params, cfg, cache, tok[:, i:i + 1],
                                       i)
        assert float((logits[:, 0] - full[:, i]).abs().max()
                     / full[:, i].abs().max()) <= 1e-4
    assert fa.LAUNCHES["flash_attention"] == before


# -- the long-context shapes (slice 17) ----------------------------------------

@pytest.mark.parametrize("b,h,kv,hd,causal,s", [
    pytest.param(*case, 32768, id="-".join(map(str, case))) for case in (
        (1, 32, 8, 128, True), (8, 32, 8, 128, True), (1, 32, 32, 128, True),
        (4, 32, 32, 128, True), (1, 16, 16, 128, True),
        (8, 16, 16, 128, True), (1, 16, 16, 80, False),
        (8, 16, 16, 80, False), (1, 96, 8, 192, True))] + [
    (1, 48, 8, 128, True, 33024), (2, 48, 8, 128, True, 33024),
    (1, 36, 4, 128, True, 32768), (4, 36, 4, 128, True, 32768),
    (1, 64, 8, 128, True, 32768), (2, 64, 8, 128, True, 32768)])
def test_flash_kernel_at_32768_tokens_matches_plain_rows(cuda, b, h, kv, hd,
                                                         causal, s):
    """bf16 flash at prefill_32k's length (Qwen3-4B's GQA 32 / 8,
    Zamba2-1.2B's shared MHA 32 / 32 and OLMoE-1B-7B's MHA 16 / 16, hd
    128, causal; HuBERT-XLarge's 16 / 16 at hd 80 in its own instance,
    non-causal; Nemotron-4-340B's GQA 96 / 8 at hd 192 in the 192
    instance, causal; InternVL2-26B's 48 / 8 over its 256 patches and
    32 768 tokens, 33 024 positions, not a power of two;
    StarCoder2-7B's 36 / 4, a group of 9; DeepSeek-67B's 64 / 8), at
    batch 1 and at the batch each prefill_32k path runs (8, 4, 2): one
    launch of the kernel, its last sequence held against the plain
    version on 512 query rows at the start, the middle and the end (all
    keys, the mask at the rows' absolute positions:
    ``attention_rows_ref``) within the bf16 bound of
    ``_half_bound_ratio`` — the dense plain version would hold up to 412
    GB of scores a sequence."""
    from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
    r = 512
    gen = torch.Generator(device=cuda).manual_seed(b + h + kv + hd)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, s, kv, hd), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, s, kv, hd), generator=gen, device=cuda).bfloat16()
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    got, q, k, v = got[-1:], q[-1:], k[-1:], v[-1:]
    for r0 in (0, (s - r) // 2, s - r):
        rows = slice(r0, r0 + r)
        qf, kf, vf = q[:, rows].float(), k.float(), v.float()
        want = fa_ref.attention_rows_ref(qf, kf, vf, r0, causal=causal)
        mass = fa_ref.attention_rows_ref(qf, kf, vf.abs(), r0,
                                         causal=causal)
        g = got[:, rows].float()
        mag = torch.maximum(g.abs(), want.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        bound = ulp + 2.0 ** -8 * mass + 2e-5
        assert float(((g - want).abs() / bound).max()) <= 1.0, r0


def test_flash_f32_kernel_at_32768_tokens_matches_plain_rows(cuda, no_tf32):
    """The float32 flash kernel (``flash_fwd<192>``, CUDA cores) at the
    shape of Nemotron-4-340B's float32 prefill_32k check, (1, 32768, 96,
    8, 192) causal: one launch, held against the plain version on 512
    query rows at the start, the middle and the end within the float32
    flash tolerance, 2e-5 absolute (the sums run in another order)."""
    from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
    s, r = 32768, 512
    gen = torch.Generator(device=cuda).manual_seed(192)
    q, k, v = (torch.randn((1, s, n, 192), generator=gen, device=cuda)
               for n in (96, 8, 8))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    for r0 in (0, (s - r) // 2, s - r):
        want = fa_ref.attention_rows_ref(q[:, r0:r0 + r], k, v, r0,
                                         causal=True)
        err = float((got[:, r0:r0 + r] - want).abs().max())
        assert err <= 2e-5, (r0, err)


def test_flash_kernel_batch_of_mha_sequences_keeps_its_rate(cuda):
    """HuBERT-XLarge's flash at 32 768 frames (MHA 16 / 16, hd 80,
    non-causal): a launch over a batch of 8 takes under 1.5 times 8
    launches of one sequence. The blocks on the card at once must share
    a head's K and V through the L2 (the grid walks the query tiles on
    x); with the (b, h) pairs on x each streamed its own K and V from HBM
    and the batch took twice as long a sequence."""
    from repro_torch.kernels.flash_attention import kernel as fa
    s, h, hd = 32768, 16, 80
    gen = torch.Generator(device=cuda).manual_seed(5)

    def ms(b):
        q, k, v = (torch.randn((b, s, h, hd), generator=gen, device=cuda)
                   .bfloat16() for _ in range(3))
        fa.flash_attention(q, k, v, causal=False)
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fa.flash_attention(q, k, v, causal=False)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[1]

    one, eight = ms(1), ms(8)
    assert eight < 1.5 * 8 * one, (one, eight)


def test_decode_step_over_a_32768_row_cache_matches_the_f32_path(cuda,
                                                                 no_tf32):
    """Qwen3-4B at full width, 1 layer: one ``decode_step`` at pos 32 767
    over a 32 768-row cache of seeded draws. In float32 the card's step
    equals the host's (logits and the written slot within rel 1e-4); in
    bf16 (weights, cache and compute) the logits are within rel 5e-2 of
    the float32 step's and the slot is written at pos only."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    t, pos = 32768, 32767
    cfg = dataclasses.replace(get_config("qwen3_4b"), num_layers=1,
                              compute_dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(7)
    params = lm.init_params(cfg, gen, cuda)
    cache = lm.init_cache(cfg, 1, t, cuda)
    for leaf in (cache["layers"]["k"], cache["layers"]["v"]):
        leaf.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen,
                        device=cuda)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    cache16 = {"layers": {k: v.bfloat16()
                          for k, v in cache["layers"].items()}}
    host = {k: v.cpu() for k, v in cache["layers"].items()}
    got, _ = lm.decode_step(params, cfg, cache, tok, pos)
    want, _ = lm.decode_step(tree_map(lambda a: a.cpu(), params), cfg,
                             {"layers": host}, tok.cpu(), pos)

    def rel(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float((a - b).abs().max() / b.abs().max())

    assert rel(got, want) <= 1e-4
    for name in ("k", "v"):
        assert rel(cache["layers"][name][:, :, pos], host[name][:, :, pos]) \
            <= 1e-4
    untouched = cache16["layers"]["k"][:, :, :pos].clone()
    got16, _ = lm.decode_step(params, bf16, cache16, tok, pos)
    torch.cuda.synchronize()
    assert got16.dtype == torch.float32 and bool(torch.isfinite(got16).all())
    assert rel(got16, got) <= 5e-2
    assert torch.equal(cache16["layers"]["k"][:, :, :pos], untouched)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_mla_row_blocks_on_card_equal_the_whole_path(cuda, no_tf32, dtype,
                                                     tol, causal):
    """DeepSeek-V2's MLA at its published width (128 heads, r 512), one
    layer over 2 x 2048 tokens, whose (B, 128, S, S) float32 scores (4.3
    GB) the card holds whole: with the score budget set to 200 query rows
    it runs in blocks (the last one short), and the blocked output agrees
    with the whole path's within ``tol`` of its largest value (the
    tolerances of ``tests/test_torch_mla.py``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    cfg = dataclasses.replace(get_config("deepseek_v2_236b"), num_layers=1)
    td = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(11)
    p = attention.mla_init(gen, cfg, td, cuda)
    b, s = 2, 2048
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=cuda).to(td)
    pos = torch.arange(s, device=cuda)[None].expand(b, s)
    whole = attention.mla_apply(p, cfg, x, pos, causal=causal)
    budget = attention.SCORE_BLOCK_BYTES
    try:
        attention.SCORE_BLOCK_BYTES = 4 * b * cfg.num_heads * s * 200
        assert attention.score_block_rows(b, cfg.num_heads, s) == 200
        got = attention.mla_apply(p, cfg, x, pos, causal=causal)
    finally:
        attention.SCORE_BLOCK_BYTES = budget
    torch.cuda.synchronize()
    assert got.dtype == td and bool(torch.isfinite(got).all())
    err = float((got.float() - whole.float()).abs().max()
                / whole.float().abs().max())
    assert err <= tol, err
