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
from repro_torch.kernels.minplus import kernel, ops, ref
from repro_torch.kernels.sssp_relax.ops import multi_source
from repro_torch.kernels.sssp_relax.ref import multi_source_ref

jax.config.update("jax_enable_x64", False)

MINPLUS_SHAPES = [(8, 8, 8), (16, 32, 8), (130, 70, 33), (1, 128, 1),
                  (37, 1, 53), (64, 0, 5), (93, 93, 93), (256, 8, 93)]
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


def test_minplus_batched_equals_each_district():
    rng = np.random.default_rng(3)
    a, b = _rand_dist(rng, (5, 40, 8)), _rand_dist(rng, (5, 8, 19))
    got = ops.minplus(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for z in range(5):
        np.testing.assert_array_equal(
            got[z], _np(rminplus_ref(jnp.asarray(a[z]), jnp.asarray(b[z]))))


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


def test_cpu_calls_are_not_launches():
    before = dict(kernel.LAUNCHES)
    ops.minplus(torch.zeros((3, 4)), torch.zeros((4, 2)))
    ops.relax(torch.zeros((2, 4)), torch.zeros((4, 4)))
    multi_source(torch.zeros((4, 4)), torch.zeros((2, 4)), 3)
    assert kernel.LAUNCHES == before
