"""The port's CUDA kernels and serving path on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips
with a reason where no CUDA device exists. Run them on a machine with
the card (no JAX needed there; ``--noconftest`` keeps the JAX package's
shared fixtures out):

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Every kernel must equal its plain version bit for bit (same IEEE
float32 operations), B built on the card by the staged builder must
equal the host reference's, and a deployment on the card must answer
exactly as the same deployment on the CPU.
"""
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


@pytest.mark.parametrize("batch,m,k,n", [(None, 1, 1, 1), (None, 93, 93, 93),
                                         (None, 130, 70, 33),
                                         (16, 256, 8, 93), (3, 37, 0, 5)])
def test_minplus_kernel_matches_plain_version(cuda, batch, m, k, n):
    from repro_torch.kernels.minplus import kernel as mp, ref as mp_ref
    rng = np.random.default_rng(m + k + n)
    lead = () if batch is None else (batch,)
    a = torch.from_numpy(_rand_dist(rng, (*lead, m, k))).to(cuda)
    b = torch.from_numpy(_rand_dist(rng, (*lead, k, n))).to(cuda)
    before = mp.LAUNCHES["minplus"]
    got = mp.minplus(a, b)
    torch.cuda.synchronize()
    assert mp.LAUNCHES["minplus"] == before + 1
    assert torch.equal(got, mp_ref.minplus_ref(a, b))


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


def test_card_builder_equals_the_host_reference(cuda):
    from repro_torch.core import build_border_labels_reference
    from repro_torch.edge import ComputingCenter
    from repro_torch.kernels.minplus import kernel as mp
    csr, part = synthetic_continent((2, 2), (8, 8), seed=3)
    g = csr.to_graph()
    before = dict(mp.LAUNCHES)
    center = ComputingCenter(g, part, builder="torch", device=cuda)
    center.rebuild()
    assert mp.LAUNCHES["minplus"] > before["minplus"]
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
