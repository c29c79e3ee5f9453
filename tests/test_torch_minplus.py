"""The port's min-plus products against the JAX package, bit for bit.

The same numpy-seeded inputs (with +inf entries, on unaligned shapes)
go through the JAX package's Pallas kernels ``minplus_pallas`` and
``relax_pallas`` (interpret mode, bm = bn = bk = 32, as its own tests
run them on the CPU), its jnp references and ops, and through the
port's plain PyTorch versions and ops on the CPU. Tolerance: none for
float32 — every term is one IEEE float32 add and min is exact and
order-free, so any tiling or chunking gives the same bits. bf16 inputs
are widened to float32 and the result rounded back once, on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minplus import ops as rops
from repro.kernels.minplus.kernel import minplus_pallas, relax_pallas
from repro.kernels.minplus.ref import minplus_ref as rminplus_ref
from repro.kernels.minplus.ref import relax_ref as rrelax_ref
from repro.kernels.sssp_relax.ops import multi_source as rmulti_source
from repro.kernels.sssp_relax.ref import multi_source_ref as rmulti_source_ref
from repro_torch.kernels.minplus import kernel, ops, ref
from repro_torch.kernels.sssp_relax.ops import multi_source
from repro_torch.kernels.sssp_relax.ref import multi_source_ref

jax.config.update("jax_enable_x64", False)

MINPLUS_SHAPES = [(8, 8, 8), (16, 32, 8), (130, 70, 33), (1, 128, 1),
                  (37, 1, 53), (64, 0, 5), (93, 93, 93), (256, 8, 93),
                  (161, 161, 161), (239, 239, 239)]
RELAX_SHAPES = [(4, 16), (8, 33), (33, 130), (1, 1)]
BLOCKS = dict(bm=32, bn=32, bk=32, interpret=True)


def _rand_dist(rng, shape, inf_frac=0.3):
    x = rng.uniform(0.5, 50.0, size=shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("m,k,n", MINPLUS_SHAPES)
def test_minplus_f32_equals_pallas_and_ref(m, k, n):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a, b = _rand_dist(rng, (m, k)), _rand_dist(rng, (k, n))
    got = _np(ops.minplus(torch.from_numpy(a), torch.from_numpy(b)))
    want = _np(rminplus_ref(jnp.asarray(a), jnp.asarray(b))) if k \
        else np.full((m, n), np.inf, np.float32)
    np.testing.assert_array_equal(got, want)
    if k:
        np.testing.assert_array_equal(
            got, _np(minplus_pallas(jnp.asarray(a), jnp.asarray(b),
                                    **BLOCKS)))


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (130, 70, 33), (37, 1, 53)])
def test_minplus_bf16_rounds_once_like_pallas(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = _rand_dist(rng, (m, k)), _rand_dist(rng, (k, n))
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    ja = jnp.asarray(a).astype(jnp.bfloat16)
    jb = jnp.asarray(b).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_np(ta), _np(ja))     # same inputs
    got = ops.minplus(ta, tb)
    assert got.dtype == torch.bfloat16
    pallas = minplus_pallas(ja, jb, **BLOCKS)
    assert pallas.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(got), _np(pallas))
    widened = rminplus_ref(ja.astype(jnp.float32), jb.astype(jnp.float32))
    np.testing.assert_array_equal(_np(got),
                                  _np(widened.astype(jnp.bfloat16)))


def _plus_zero_bits(x: np.ndarray) -> np.ndarray:
    """int32 patterns with -0.0 read as +0.0: the card's DPX kernels
    return +0.0 where a plain version may return -0.0."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return np.where(bits == np.int32(-2 ** 31), np.int32(0), bits)


# (batch, m, k, n): ragged around the card kernel's 64- and 128-wide
# tiles and its 32-deep k parts, an empty contraction included
BATCHED_SHAPES = [(5, 40, 8, 19), (3, 65, 33, 129), (1, 1, 0, 5),
                  (2, 130, 257, 64)]


@pytest.mark.parametrize("batch,m,k,n", BATCHED_SHAPES)
def test_minplus_batched_equals_each_district(batch, m, k, n):
    """Each district against the JAX package's reference and Pallas
    kernel, with a row of A and a column of B all +inf and a -0.0 entry
    in each operand."""
    rng = np.random.default_rng(m + k + n)
    a, b = _rand_dist(rng, (batch, m, k)), _rand_dist(rng, (batch, k, n))
    a[:, m // 2] = np.inf
    b[:, :, n // 2] = np.inf
    if k:
        a[0, 0, 0] = b[-1, 0, 0] = -0.0
    got = ops.minplus(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (batch, m, n)
    for z in range(batch):
        if not k:
            np.testing.assert_array_equal(got[z], np.inf)
            continue
        ja, jb = jnp.asarray(a[z]), jnp.asarray(b[z])
        for want in (rminplus_ref(ja, jb), minplus_pallas(ja, jb, **BLOCKS)):
            np.testing.assert_array_equal(_plus_zero_bits(got[z]),
                                          _plus_zero_bits(_np(want)))


@pytest.mark.parametrize("s,v", RELAX_SHAPES)
def test_relax_equals_pallas_and_ref(s, v):
    rng = np.random.default_rng(s * 100 + v)
    d = _rand_dist(rng, (s, v))
    a = _rand_dist(rng, (v, v), inf_frac=0.6)
    got = _np(ops.relax(torch.from_numpy(d), torch.from_numpy(a)))
    np.testing.assert_array_equal(
        got, _np(rrelax_ref(jnp.asarray(d), jnp.asarray(a))))
    np.testing.assert_array_equal(
        got, _np(relax_pallas(jnp.asarray(d), jnp.asarray(a), **BLOCKS)))


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(_np(x)).view(np.int32)


def _banded(rng, shape, band):
    """A grid-like adjacency: finite only within ``band`` of the
    diagonal, as a grid district's is (its vertices in row order)."""
    a = np.ceil(rng.uniform(0.5, 9.0, size=shape)).astype(np.float32)
    i, j = np.indices(shape[-2:])
    a[..., np.abs(i - j) > band] = np.inf
    return a


# (kind, batch, S, V, band): ragged V (not a multiple of the 32 x 128
# tiles) and S not a multiple of 8
RELAX_MAP_CASES = [("banded", 2, 13, 300, 20), ("banded", 1, 8, 257, 40),
                   ("banded", 3, 5, 161, 3), ("random", 3, 5, 129, None),
                   ("random", 2, 9, 70, None), ("random", 1, 1, 1, None)]


@pytest.mark.parametrize("kind,b,s,v,band", RELAX_MAP_CASES)
def test_relax_with_the_occupancy_map_equals_without_and_pallas(kind, b, s,
                                                                v, band):
    """The plain relax honouring the occupancy map gives the bits of the
    plain relax without it and of the JAX package's relax_pallas: a tile
    the map marks empty holds only +inf, whose terms change no min."""
    rng = np.random.default_rng(b * 1000 + s * 10 + v)
    d = _rand_dist(rng, (b, s, v))
    a = _banded(rng, (b, v, v), band) if kind == "banded" \
        else _rand_dist(rng, (b, v, v), inf_frac=0.97)
    td, ta = torch.from_numpy(d), torch.from_numpy(a)
    occ = kernel.relax_occupancy(ta)
    strips, ktiles = -(-v // ref.STRIP), -(-v // ref.KTILE)
    assert occ.dtype == torch.uint8 and occ.shape == (b, strips, ktiles)
    assert occ.is_contiguous()                  # as the kernel takes it
    pad = np.full((b, ktiles * ref.KTILE, strips * ref.STRIP), np.inf,
                  np.float32)
    pad[:, :v, :v] = a
    want_occ = np.isfinite(pad.reshape(b, ktiles, ref.KTILE, strips,
                                       ref.STRIP)).any(axis=(2, 4))
    np.testing.assert_array_equal(occ.numpy(),
                                  want_occ.transpose(0, 2, 1))
    if kind == "banded" and v > 200:
        assert occ.float().mean() < 0.7         # the map skips tiles
    plain = ref.relax_ref(td, ta)
    mapped = ref.relax_ref(td, ta, occ)
    entry = kernel.relax(td, ta, occ)
    for got in (mapped, entry):
        np.testing.assert_array_equal(_bits(got), _bits(plain))
    for z in range(b):
        pallas = relax_pallas(jnp.asarray(d[z]), jnp.asarray(a[z]),
                              **BLOCKS)
        np.testing.assert_array_equal(_bits(mapped[z]), _bits(pallas))
    # the plain version reads the map: marked all empty, no term is left
    assert torch.equal(ref.relax_ref(td, ta, torch.zeros_like(occ)), td)


def test_int32_pattern_minimum_is_the_float_minimum():
    """What the kernels' atomicMin and DPX minimum rely on: for
    non-negative floats and +inf, the minimum of the int32 bit patterns
    is the pattern of the float minimum (0, subnormals, normals up to
    the largest float, +inf, and sums of them)."""
    f32 = np.finfo(np.float32)
    special = np.array([0.0, 1e-45, 1e-40, f32.tiny, 1e-30, 0.5, 1.0, 3.0,
                        4096.0, 1e30, f32.max, np.inf], np.float32)
    rng = np.random.default_rng(8)
    sums = (rng.uniform(0, 1e3, 500).astype(np.float32)
            + rng.uniform(0, 1e3, 500).astype(np.float32))
    vals = np.concatenate([special, special + special[::-1], sums])
    x = torch.from_numpy(np.repeat(vals, len(vals)))
    y = torch.from_numpy(np.tile(vals, len(vals)))
    assert bool((x >= 0).all()) and not bool(torch.isnan(x).any())
    by_pattern = torch.minimum(x.view(torch.int32), y.view(torch.int32))
    np.testing.assert_array_equal(by_pattern.numpy(),
                                  torch.minimum(x, y).view(torch.int32)
                                  .numpy())
    # -0.0 has the smallest pattern and the smallest value (0)
    neg0 = torch.tensor([-0.0]).view(torch.int32)
    assert int(neg0) == torch.iinfo(torch.int32).min
    assert float(torch.tensor([-0.0])) == float(torch.minimum(x, y).min())


def test_relax_batched_is_out_of_place():
    rng = np.random.default_rng(4)
    d = _rand_dist(rng, (3, 8, 45))
    a = _rand_dist(rng, (3, 45, 45), inf_frac=0.8)
    td = torch.from_numpy(d.copy())
    got = ops.relax(td, torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(td.numpy(), d)       # D not written
    for z in range(3):
        np.testing.assert_array_equal(
            got[z], _np(rrelax_ref(jnp.asarray(d[z]), jnp.asarray(a[z]))))


def test_plain_versions_give_the_same_bits_in_any_chunk(monkeypatch):
    rng = np.random.default_rng(5)
    a, b = _rand_dist(rng, (2, 30, 41)), _rand_dist(rng, (2, 41, 17))
    d, adj = _rand_dist(rng, (2, 6, 41)), _rand_dist(rng, (2, 41, 41))
    whole = (ref.minplus_ref(torch.from_numpy(a), torch.from_numpy(b)),
             ref.relax_ref(torch.from_numpy(d), torch.from_numpy(adj)))
    for budget in (1, 7 * 2 * 30 * 17, 1 << 30):
        monkeypatch.setattr(ref, "_TEMP_ELEMENTS", budget)
        assert torch.equal(ref.minplus_ref(torch.from_numpy(a),
                                           torch.from_numpy(b)), whole[0])
        assert torch.equal(ref.relax_ref(torch.from_numpy(d),
                                         torch.from_numpy(adj)), whole[1])


@pytest.mark.parametrize("q,inf_frac", [(1, 0.0), (40, 0.7), (93, 0.9)])
def test_closure_equals_reference(q, inf_frac):
    rng = np.random.default_rng(q)
    w = _rand_dist(rng, (q, q), inf_frac=inf_frac)
    got = ops.closure(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, _np(rops.closure(jnp.asarray(w))))


def test_closure_equals_reference_through_pallas():
    rng = np.random.default_rng(11)
    w = _rand_dist(rng, (37, 37), inf_frac=0.8)
    got = ops.closure(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(
        got, _np(rops.closure(jnp.asarray(w), use_pallas=True)))


def _grid_sources(seed=3):
    from repro_torch.core import grid_road_network
    g = grid_road_network(6, 6, seed=seed)
    adj = g.dense_adjacency()
    init = np.full((3, g.num_vertices), np.inf, np.float32)
    init[[0, 1, 2], [0, 5, 17]] = 0.0
    return g, adj, init


def test_bellman_ford_equals_reference_and_dijkstra():
    from repro_torch.core import dijkstra
    g, adj, init = _grid_sources()
    n = g.num_vertices
    got = ops.bellman_ford(torch.from_numpy(init), torch.from_numpy(adj),
                           iters=n).numpy()
    np.testing.assert_array_equal(got, _np(rops.bellman_ford(
        jnp.asarray(init), jnp.asarray(adj), iters=n)))
    for row, src in zip(got, [0, 5, 17]):
        np.testing.assert_array_equal(row, dijkstra(g, src))


@pytest.mark.parametrize("iters", [1, 3, 36])
def test_multi_source_early_exit_equals_all_sweeps(iters):
    _, adj, init = _grid_sources(seed=9)
    tadj, tinit = torch.from_numpy(adj), torch.from_numpy(init)
    got, sweeps = multi_source(tadj, tinit, iters)
    full = multi_source_ref(tadj, tinit, iters)
    assert torch.equal(got, full)
    np.testing.assert_array_equal(got.numpy(), _np(rmulti_source(
        jnp.asarray(adj), jnp.asarray(init), iters=iters)))
    np.testing.assert_array_equal(got.numpy(), _np(rmulti_source(
        jnp.asarray(adj), jnp.asarray(init), iters=iters, use_pallas=True)))
    assert 1 <= sweeps <= iters
    if iters == 36:                     # converges well before n sweeps
        assert sweeps < iters


@pytest.mark.parametrize("mapped", [True, False],
                         ids=["mapped", "below_the_size_gate"])
def test_multi_source_with_the_map_matches_jax_sweep_for_sweep(
        monkeypatch, mapped):
    """multi_source passes the adjacency's occupancy map to every sweep
    (none where the adjacency is below OCCUPANCY_MIN_BYTES) and gives the
    JAX package's distances (multi_source_ref over all n sweeps) after
    as many sweeps as its relax_ref needs to return its input, on a grid
    whose adjacency leaves tiles empty."""
    from repro_torch.core import grid_road_network
    from repro_torch.kernels.sssp_relax import ops as sssp_ops
    if mapped:
        monkeypatch.setattr(sssp_ops, "OCCUPANCY_MIN_BYTES", 0)
    g = grid_road_network(12, 12, seed=4)
    n = g.num_vertices
    adj = g.dense_adjacency()
    init = np.full((5, n), np.inf, np.float32)
    init[range(5), [0, 11, 70, 133, 143]] = 0.0
    tadj = torch.from_numpy(adj)
    occ = kernel.relax_occupancy(tadj)
    assert 0 < int(occ.sum()) < occ.numel()
    seen = []
    real = kernel.relax

    def relax(d, a, occupancy=None):
        seen.append(occupancy)
        return real(d, a, occupancy)

    monkeypatch.setattr(kernel, "relax", relax)
    got, sweeps = multi_source(tadj, torch.from_numpy(init), n)
    assert len(seen) == sweeps
    if mapped:
        assert all(o is not None and torch.equal(o, occ) for o in seen)
    else:
        assert adj.nbytes < sssp_ops.OCCUPANCY_MIN_BYTES
        assert all(o is None for o in seen)
    want = np.asarray(rmulti_source_ref(jnp.asarray(adj), jnp.asarray(init),
                                        iters=n))
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    d, k = jnp.asarray(init), 0
    while True:
        k += 1
        nxt = rrelax_ref(d, jnp.asarray(adj))
        if np.array_equal(np.asarray(nxt), np.asarray(d)):
            break
        d = nxt
    assert sweeps == k


def test_multi_source_batched_stops_when_every_district_converged():
    rng = np.random.default_rng(2)
    adj = _rand_dist(rng, (4, 30, 30), inf_frac=0.85)
    init = np.full((4, 3, 30), np.inf, np.float32)
    init[:, [0, 1, 2], [0, 7, 29]] = 0.0
    got, sweeps = multi_source(torch.from_numpy(adj),
                               torch.from_numpy(init), 30)
    for z in range(4):
        np.testing.assert_array_equal(got[z].numpy(), _np(rmulti_source(
            jnp.asarray(adj[z]), jnp.asarray(init[z]), iters=30)))
    assert sweeps < 30


def test_wrappers_reject_what_the_kernels_do_not_take():
    f32 = torch.zeros((4, 5))
    with pytest.raises(ValueError, match="float32"):
        kernel.minplus(f32.double(), torch.zeros((5, 3)).double())
    with pytest.raises(ValueError, match="inner sizes"):
        kernel.minplus(f32, torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="batch size"):
        kernel.minplus(torch.zeros((2, 4, 5)), torch.zeros((3, 5, 3)))
    with pytest.raises(ValueError, match="adjacency"):
        kernel.relax(f32, torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.relax(torch.zeros((2, 3), device="meta"),
                     torch.zeros((3, 3), device="meta"))
    occ = kernel.relax_occupancy(torch.zeros((4, 4)))
    for bad in (occ.bool(), occ[..., :0], occ[None]):
        with pytest.raises(ValueError, match="occupancy"):
            kernel.relax(torch.zeros((2, 4)), torch.zeros((4, 4)), bad)


def test_cpu_calls_are_not_launches():
    before = dict(kernel.LAUNCHES)
    ops.minplus(torch.zeros((3, 4)), torch.zeros((4, 2)))
    ops.relax(torch.zeros((2, 4)), torch.zeros((4, 4)))
    multi_source(torch.zeros((4, 4)), torch.zeros((2, 4)), 3)
    assert kernel.LAUNCHES == before


# -- the fused closure and the k-major product (their plain versions) --------

CLOSURE_QS = [1, 40, 93, 128, 129, 161, 200, 239]


def _closure_input(q, kind, seed):
    """A dense overlay or a 90 %-inf one, the diagonal set to 0 as the
    closure's init does."""
    rng = np.random.default_rng(seed)
    w = _rand_dist(rng, (q, q), inf_frac=0.0 if kind == "dense" else 0.9)
    np.fill_diagonal(w, 0.0)
    return w


def _jax_loop(d0, steps, check_from):
    """The warm closure's loop rule on the JAX package's reference
    product: up to ``steps`` squarings, from ``check_from`` on stop at
    the first that returns its input; (D, that squaring or steps)."""
    d = jnp.asarray(d0)
    for s in range(steps):
        nd = rminplus_ref(d, d)
        if s >= check_from and np.array_equal(np.asarray(nd), np.asarray(d)):
            return np.asarray(d), s
        d = nd
    return np.asarray(d), steps


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("q", CLOSURE_QS)
def test_fused_closure_plain_version_equals_the_jax_closure(q, kind):
    """The fused closure's plain version (kernel.closure on the CPU) at
    the fixed schedule (check_from = steps) and ops.closure, against the
    JAX package's closure with its XLA reference and with the Pallas
    kernel in interpret mode: bit for bit (min of single float32 adds).
    q = 129 and 200 lie above the card kernel's cap, where the card runs
    the tiled kernel's squarings instead."""
    w = _closure_input(q, kind, q + len(kind))
    steps = ops.closure_steps(q)
    got, depth = kernel.closure(torch.from_numpy(w), steps, steps)
    assert int(depth) == steps
    want = _np(rops.closure(jnp.asarray(w)))
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    np.testing.assert_array_equal(
        _bits(ops.closure(torch.from_numpy(w))), want.view(np.int32))
    np.testing.assert_array_equal(
        want, _np(rops.closure(jnp.asarray(w), use_pallas=True)))


# (q, kind, check_from): a cold start, checks from the start, from the
# middle, and never (check_from past the schedule)
DEPTH_CASES = [(40, "sparse", 0), (40, "sparse", 2), (93, "sparse", 1),
               (93, "dense", 0), (128, "sparse", 4), (129, "sparse", 3),
               (60, "sparse", 9)]


@pytest.mark.parametrize("q,kind,check_from", DEPTH_CASES)
def test_closure_depth_follows_the_loop_rule(q, kind, check_from):
    """kernel.closure and ops.closure_squarings return the D and the
    depth of the warm closure's loop (update/incremental.py's rule) on
    the JAX package's reference product."""
    d0 = _closure_input(q, kind, 7 * q + check_from)
    steps = ops.closure_steps(q)
    want, want_depth = _jax_loop(d0, steps, check_from)
    for fn in (kernel.closure, ops.closure_squarings):
        got, depth = fn(torch.from_numpy(d0), steps, check_from)
        assert int(depth) == want_depth
        np.testing.assert_array_equal(_bits(got), want.view(np.int32))


@pytest.mark.parametrize("check_from", [0, 1, 3, 6])
def test_closure_warm_start_stops_at_check_from(check_from):
    """A warm start from a fixpoint (the previous epoch's closure): the
    first checked squaring returns its input, so the depth is check_from
    itself and D comes back unchanged. Integral weights, as a road
    graph's: every path sum is exact, so the closure is a fixpoint (with
    real weights another association can round a sum lower)."""
    d0 = np.array(rops.closure(jnp.asarray(
        np.ceil(_closure_input(93, "sparse", 5)))))
    steps = ops.closure_steps(93)
    want, want_depth = _jax_loop(d0, steps, check_from)
    assert want_depth == check_from
    got, depth = ops.closure_squarings(torch.from_numpy(d0), steps,
                                       check_from)
    assert int(depth) == check_from
    np.testing.assert_array_equal(_bits(got), d0.view(np.int32))
    np.testing.assert_array_equal(want, d0)


def test_closure_squarings_round_other_dtypes_every_squaring():
    """bf16 runs the loop of ops.minplus (widened, rounded back at every
    squaring, as the JAX package's minplus_pallas does), not the fused
    float32 closure."""
    w = _closure_input(37, "sparse", 2)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    got = ops.closure(tw)
    assert got.dtype == torch.bfloat16
    want = rops.closure(jnp.asarray(w).astype(jnp.bfloat16), use_pallas=True)
    np.testing.assert_array_equal(_np(got), _np(want))


KMAJOR_SHAPES = [(16, 8, 93), (3, 1, 5), (4, 32, 97), (6400 // 50, 8, 96),
                 (9, 0, 4), (5, 33, 8)]


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("m,k,n", KMAJOR_SHAPES)
def test_minplus_kmajor_equals_jax_minplus(m, k, n, batch):
    """The k-major product (A given as a_t = A^T) against the JAX
    package's reference and Pallas minplus on A, bit for bit; k = 0 is
    the empty contraction (+inf), k = 33 the depth the card hands to the
    tiled kernel."""
    rng = np.random.default_rng(m * 100 + k * 10 + n)
    lead = () if batch is None else (batch,)
    a = _rand_dist(rng, (*lead, m, k))
    b = _rand_dist(rng, (*lead, k, n))
    a_t = torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, -1, -2)))
    got = ops.minplus_kmajor(a_t, torch.from_numpy(b))
    assert got.shape == (*lead, m, n)
    for z in range(batch or 1):
        az = a[z] if batch else a
        bz = b[z] if batch else b
        gz = got[z] if batch else got
        want = _np(rminplus_ref(jnp.asarray(az), jnp.asarray(bz))) if k \
            else np.full((m, n), np.inf, np.float32)
        np.testing.assert_array_equal(_bits(gz), want.view(np.int32))
        if k:
            np.testing.assert_array_equal(
                want, _np(minplus_pallas(jnp.asarray(az), jnp.asarray(bz),
                                         **BLOCKS)))


def test_builder_runs_one_closure_and_a_kmajor_stage_c(monkeypatch):
    """The staged builder calls the fused closure once (stage B) and the
    k-major product on stage A's own tensor (stage C: no transpose, no
    copy); the warm closure of a repair calls it once too."""
    from repro_torch.core import bfs_grow_partition, grid_road_network
    from repro_torch.core import torch_builder
    from repro_torch.update import IncrementalBuilder
    calls = []
    real = {name: getattr(kernel, name)
            for name in ("closure", "minplus_kmajor", "minplus")}

    def spy(name):
        def call(*args):
            calls.append((name, args))
            return real[name](*args)
        return call

    for name in real:
        monkeypatch.setattr(kernel, name, spy(name))
    seen_intra = []
    real_stage_c = torch_builder.stage_c_full_table

    def stage_c(intra, *rest):
        seen_intra.append(intra)
        return real_stage_c(intra, *rest)

    monkeypatch.setattr(torch_builder, "stage_c_full_table", stage_c)
    g = grid_road_network(8, 8, seed=2)
    part = bfs_grow_partition(g, 4)
    inc = IncrementalBuilder(device="cpu")
    inc.build_full(g, part)
    names = [c[0] for c in calls]
    assert names.count("closure") == 1 and "minplus" not in names
    (a_t, _), = [c[1] for c in calls if c[0] == "minplus_kmajor"]
    assert a_t is seen_intra[0]
    q = len(inc.state.packed.border_ids)
    steps = ops.closure_steps(q)
    (_, c_steps, c_from), = [c[1] for c in calls if c[0] == "closure"]
    assert (c_steps, c_from) == (steps, steps)
    calls.clear()
    w2 = np.asarray(g.weights) * np.float32(1.5)
    inc.apply_delta(g.with_weights(w2), part)
    names = [c[0] for c in calls]
    assert names.count("closure") == 1 and "minplus" not in names


def test_closure_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="square"):
        kernel.closure(torch.zeros((3, 4)), 2, 2)
    with pytest.raises(ValueError, match="square"):
        kernel.closure(torch.zeros((3, 3), dtype=torch.float64), 2, 2)
    with pytest.raises(ValueError, match="steps"):
        kernel.closure(torch.zeros((3, 3)), kernel.CLOSURE_MAX_STEPS + 1, 0)
    with pytest.raises(ValueError, match="depths differ"):
        kernel.minplus_kmajor(torch.zeros((4, 5)), torch.zeros((3, 2)))
    before = dict(kernel.LAUNCHES)
    ops.closure_squarings(torch.zeros((5, 5)), 3, 0)
    ops.minplus_kmajor(torch.zeros((2, 4)), torch.zeros((2, 3)))
    assert kernel.LAUNCHES == before    # plain versions: no launch
