"""The port's Floyd–Warshall APSP against the JAX package.

The same seeded adjacencies (made with numpy) go through the JAX
package's ``floyd_warshall_ref`` and ``floyd_warshall_pallas`` (Pallas
in interpret mode, as its own tests run it on the CPU) and through the
port's ``floyd_warshall_ref`` and ``ops.floyd_warshall`` on the CPU,
where the wrapper runs the plain version.

* The two plain versions run the same rank-1 loop with the same IEEE
  float32 operations in the same order: bit for bit.
* The port's entry point against the blocked Pallas kernel: bit for bit
  on integral weights (every path sum is exact), within rtol 1e-5 — the
  JAX package's own tolerance (``tests/test_kernels.py``) — on real ones,
  where the blocked order associates the sums differently.
* Rows against host Dijkstra, and the rows at a district's border
  positions against stage A of both packages' staged builders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rcore
import repro.ingest as ringest
import repro_torch.core as tcore
import repro_torch.ingest as tingest
from repro.core.jax_builder import build_border_labels_stages as rstages
from repro.kernels.sssp_relax.kernel import floyd_warshall_pallas
from repro.kernels.sssp_relax.ref import floyd_warshall_ref as jax_fw_ref
from repro_torch.core import torch_builder
from repro_torch.kernels.sssp_relax import kernel, ops, ref

# the JAX package's FW_SIZES (tests/test_kernels.py), plus 1
FW_SIZES = [1, 8, 32, 33, 64, 100, 130]


def _adjacency(n: int, integral: bool, seed: int) -> np.ndarray:
    """Seeded undirected adjacency: 80 % +inf, weights in [0.5, 50)
    (rounded up to integers when ``integral``), diagonal left as drawn."""
    rng = np.random.default_rng(seed)
    adj = rng.uniform(0.5, 50.0, (n, n)).astype(np.float32)
    if integral:
        adj = np.ceil(adj)
    adj[rng.random((n, n)) < 0.8] = np.inf
    return np.minimum(adj, adj.T)


@pytest.mark.parametrize("integral", [False, True])
@pytest.mark.parametrize("n", FW_SIZES)
def test_plain_version_bitwise_equals_the_jax_reference(n, integral):
    adj = _adjacency(n, integral, seed=n)
    got = ref.floyd_warshall_ref(torch.from_numpy(adj)).numpy()
    want = np.asarray(jax_fw_ref(jnp.asarray(adj)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("integral", [False, True])
@pytest.mark.parametrize("n", FW_SIZES)
def test_entry_point_equals_the_pallas_kernel(n, integral):
    adj = _adjacency(n, integral, seed=100 + n)
    got = ops.floyd_warshall(torch.from_numpy(adj))
    assert got.dtype == torch.float32 and got.shape == (n, n)
    want = np.asarray(floyd_warshall_pallas(jnp.asarray(adj), bk=32,
                                            interpret=True))
    if integral:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert (np.diag(got.numpy()) == 0).all()


def test_bf16_round_trip_equals_the_pallas_kernel():
    """bf16 in, float32 inside, bf16 out — as ``floyd_warshall_pallas``
    casts. Small integral weights keep every distance exact in bf16."""
    rng = np.random.default_rng(7)
    n = 33
    adj = rng.integers(1, 5, (n, n)).astype(np.float32)
    adj[rng.random((n, n)) < 0.7] = np.inf
    adj = np.minimum(adj, adj.T)
    got = ops.floyd_warshall(torch.from_numpy(adj).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = floyd_warshall_pallas(jnp.asarray(adj, dtype=jnp.bfloat16),
                                 bk=32, interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, dtype=np.float32))


def test_rows_equal_dijkstra():
    g = tcore.grid_road_network(6, 5, seed=4)
    got = ops.floyd_warshall(torch.from_numpy(g.dense_adjacency())).numpy()
    rg = rcore.grid_road_network(6, 5, seed=4)
    want = np.asarray(floyd_warshall_pallas(
        jnp.asarray(rg.dense_adjacency()), bk=16, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for src in (0, 7, 29):
        np.testing.assert_allclose(got[src], tcore.dijkstra(g, src),
                                   rtol=1e-5)


def test_border_rows_equal_stage_a_of_both_builders():
    """Per district of a synthetic continent (integral weights): the APSP
    rows at the border positions are stage A's border-to-vertex rows,
    bit for bit, in the port's staged builder and in the JAX package's."""
    csr, part = tingest.synthetic_continent((2, 2), (8, 8), seed=3)
    g = csr.to_graph()
    _, tstate = torch_builder.build_border_labels_stages(g, part,
                                                         device="cpu")
    rcsr, rpart = ringest.synthetic_continent((2, 2), (8, 8), seed=3)
    _, rstate = rstages(rcsr.to_graph(), rpart)
    packed = tstate.packed
    for i in range(packed.num_districts):
        k = int((packed.vertex_ids[i] >= 0).sum())
        apsp = ops.floyd_warshall(
            torch.from_numpy(packed.adj[i, :k, :k])).numpy()
        pos = packed.border_pos[i][packed.border_pos[i] >= 0]
        rows = apsp[pos]
        np.testing.assert_array_equal(rows, tstate.intra[i, :len(pos), :k])
        np.testing.assert_array_equal(rows, rstate.intra[i, :len(pos), :k])


@pytest.mark.parametrize("n", [1, 128, 130])
def test_working_copy_pads_with_inf_and_has_no_negative_zero(n):
    """The kernel's input: min(adj, diag 0) + 0.0 padded with +inf to a
    multiple of the tile, so its int32-pattern minimum never sees -0.0
    and the pad vertices reach nothing."""
    adj = torch.from_numpy(_adjacency(n, True, seed=n))
    adj[0, 0] = -0.0
    if n > 1:
        adj[0, 1] = adj[1, 0] = -0.0
    d = kernel.working_copy(adj)
    big = -(-n // kernel.TILE) * kernel.TILE
    assert d.shape == (big, big) and d.is_contiguous()
    assert not bool(torch.signbit(d).any())
    assert torch.equal(d[:n, :n], ref.with_zero_diagonal(adj))
    assert bool(torch.isinf(d[n:]).all()) and bool(torch.isinf(d[:, n:]).all())
    assert kernel.launches_per_call(n) == (1 if big == kernel.TILE
                                           else 3 * big // kernel.TILE)


def test_cpu_runs_the_plain_version_and_launches_nothing():
    before = dict(kernel.LAUNCHES)
    adj = torch.from_numpy(_adjacency(40, True, seed=1))
    assert torch.equal(kernel.floyd_warshall(adj),
                       ref.floyd_warshall_ref(adj))
    assert kernel.LAUNCHES == before
    assert kernel.floyd_warshall(torch.zeros((0, 0))).shape == (0, 0)


@pytest.mark.parametrize("bad", ["rectangular", "batched", "float64",
                                 "meta"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = {"rectangular": torch.zeros((3, 4)),
         "batched": torch.zeros((2, 3, 3)),
         "float64": torch.zeros((3, 3), dtype=torch.float64),
         "meta": torch.zeros((3, 3), device="meta")}[bad]
    with pytest.raises(ValueError):
        kernel.floyd_warshall(x)
