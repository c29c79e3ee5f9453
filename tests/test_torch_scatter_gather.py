"""The port's scatter-gather read path against the JAX package's.

The reference deploys a grid with integral weights (so that the fitted
uint16 spec is lossless); ``repro_torch.convert`` carries its index to
the port on ``device="cpu"``, where each server's partial runs the
plain versions of the sharded and dense join kernels. Then, bit for bit:

* the plane's answers against the reference's plane (its XLA join, and
  its Pallas join in interpret mode), the port's replicated and sharded
  engines and the scalar loop, on 1 and 8 servers, with float32 storage,
  the lossless uint16 spec and a lossy explicit int16 spec (where the
  engines join in code units and the planes dequantize first, so only
  the two planes are held equal);
* the plane's state: exchange stats, co-hosted rows under a placement,
  bytes, the servers' border-row stores, and the coordinator holding no
  B;
* ``join_partial_gathered`` and the device dequantize against the
  reference's on the same rows and codes;
* the request plane: ``ServingPolicy(engine="scatter_gather")``, the
  plane cache, a rebuild window and a traffic update.
"""
import numpy as np
import pytest
import torch

import repro.core as rcore
import repro.edge as redge
import repro.serve as rserve
import repro.topo as rtopo
from repro.kernels.label_join import ops as rops
import repro_torch.core as tcore
import repro_torch.edge as tedge
import repro_torch.serve as tserve
import repro_torch.topo as ttopo
from repro_torch.convert import index_to_numpy, system_from_numpy
from repro_torch.edge.scatter_gather import dequantize
from repro_torch.kernels.label_join import ops as tops

STORAGES = ("float32", "uint16", "int16_lossy")
SCATTER = dict(engine="scatter_gather")


def _integral_grid(rows, seed, districts, part_seed):
    g = rcore.grid_road_network(rows, rows, seed=seed)
    g = g.with_weights(np.ceil(g.weights * 4.0))
    return g, rcore.bfs_grow_partition(g, districts, seed=part_seed)


def _deploy_pair(rows=10, seed=5, districts=8, part_seed=1):
    """The reference's deployed system and the port's copy of its index
    (on the CPU)."""
    g, part = _integral_grid(rows, seed, districts, part_seed)
    rsys = redge.EdgeSystem.deploy(g, part)
    return g, rsys, system_from_numpy(index_to_numpy(rsys), device="cpu")


def _batch(g, seed, size=512):
    rng = np.random.default_rng(seed)
    ss = rng.integers(0, g.num_vertices, size=size)
    ts = rng.integers(0, g.num_vertices, size=size)
    ss[::17] = ts[::17]                               # s == t lanes
    return ss.astype(np.int64), ts.astype(np.int64)


def _scrub(system):
    """Back to the post-deploy state of the servers' border-row stores:
    each keeps only its own pushed slice."""
    for srv in system.servers:
        own = srv._border_rows.get(srv.district_id)
        srv._border_rows = {} if own is None else {srv.district_id: own}
        srv._stale_rows = None
        srv._stale_rows_version = -2


def _spec(pkg, system, storage):
    btable = system.center.border_labels.table
    locals_ = [srv.augmented for srv in system.servers]
    if storage == "float32":
        return None
    if storage == "uint16":
        spec = pkg.fit_label_spec(btable, locals_, dtype=np.uint16)
        assert spec.lossless
        return spec
    vmax = max(float(btable[np.isfinite(btable)].max(initial=0.0)),
               *(float(li.dense_table()[np.isfinite(li.dense_table())].max())
                 for li in locals_))
    spec = pkg.QuantSpec(vmax / 30000.0, np.int16, lossless=False)
    assert not spec.is_lossless_for(np.concatenate(
        [btable.ravel(), *(li.dense_table().ravel() for li in locals_)]))
    return spec


@pytest.fixture(scope="module", params=[8, 1], ids=["8-servers",
                                                     "1-server"])
def pair(request):
    return _deploy_pair(districts=request.param)


@pytest.fixture(scope="module")
def pair8():
    return _deploy_pair()


@pytest.mark.parametrize("storage", STORAGES)
def test_plane_answers_match_reference_engines_and_loop(pair, storage):
    g, rsys, tsys = pair
    ss, ts = _batch(g, 7)
    _scrub(rsys)
    _scrub(tsys)
    rspec, tspec = _spec(rcore, rsys, storage), _spec(tcore, tsys, storage)
    rplane = redge.ScatterGatherPlane.from_system(rsys, quant=rspec)
    tplane = tedge.ScatterGatherPlane.from_system(tsys, quant=tspec)
    got = tplane.execute(ss, ts)
    assert got.dtype == np.float32
    want = rplane.execute(ss, ts)
    np.testing.assert_array_equal(got, want)
    if storage == "float32" and len(tsys.servers) > 1:
        pallas = redge.ScatterGatherPlane.from_system(rsys, use_pallas=True)
        np.testing.assert_array_equal(got, pallas.execute(ss, ts))
    assert tplane.exchange_stats == rplane.exchange_stats
    assert tplane.size_bytes() == rplane.size_bytes()
    assert sum(tplane.server_bytes()) == tplane.size_bytes()
    if storage == "int16_lossy":
        # the engines join in code units: only the planes agree here
        assert np.isfinite(got[np.isfinite(want)]).all()
        return
    args = (tsys.center.border_labels.table,
            [srv.augmented for srv in tsys.servers],
            tsys.partition.assignment)
    rep = tedge.BatchedQueryEngine(*args, quant=tspec, device="cpu")
    np.testing.assert_array_equal(got, rep.query(ss, ts))
    m = len(tsys.servers)
    shd = tedge.ShardedBatchedEngine(
        *args, mesh=tedge.default_edge_mesh(m, device="cpu"), quant=tspec)
    np.testing.assert_array_equal(got, shd.query(ss, ts))
    np.testing.assert_array_equal(got, tsys.query_loop(ss, ts))


@pytest.mark.parametrize("storage", STORAGES)
def test_service_selects_the_plane(pair8, storage):
    g, rsys, tsys = pair8
    ss, ts = _batch(g, 11, size=384)
    dtype = {"float32": "float32", "uint16": "uint16",
             "int16_lossy": "int16"}[storage]
    rsvc = rsys.service(rserve.ServingPolicy(**SCATTER, label_dtype=dtype))
    tsvc = tsys.service(tserve.ServingPolicy(**SCATTER, label_dtype=dtype))
    plan = tsvc.plan(ss, ts)
    assert isinstance(plan.plane, tedge.ScatterGatherPlane)
    assert isinstance(plan.plane, tserve.QueryPlane)
    got = tsvc.submit(ss, ts)
    np.testing.assert_array_equal(got.distances,
                                  rsvc.submit(ss, ts).distances)
    assert got.exact.all()
    assert all(r is None for r in got.degraded_reason)
    assert got[0].degraded_reason is None
    assert tsvc.stats == rsvc.stats


def test_plane_cache_keys(pair8):
    g, rsys, tsys = pair8
    p = tsys._current_scatter_plane()
    assert p is tsys._current_scatter_plane()
    q = tsys._current_scatter_plane(label_dtype="uint16")
    assert q is not p and q.quant is not None
    # a disabled plan is the same cache entry as no plan
    assert tsys._current_scatter_plane(faults=tedge.NO_FAULTS,
                                       label_dtype="uint16") is q
    plan = tedge.FaultPlan(seed=5, peer_drop_rate=0.5)
    faulted = tsys._current_scatter_plane(faults=plan)
    assert faulted.faults is not None and faulted.faults.plan == plan
    assert tsys._current_scatter_plane(faults=plan) is faulted
    tsys.placement = ttopo.EdgePlacement.blocked(len(tsys.servers), 4)
    try:
        placed = tsys._current_scatter_plane()
        assert placed is not faulted and placed.placement is tsys.placement
    finally:
        tsys.placement = None


def test_exchange_stats_co_hosted_and_persistence(pair8):
    """Under one placement both packages count the same peer exchanges
    and the same co-hosted (loopback) rows; a rebuilt plane of the same
    version finds the rows already on the servers."""
    g, rsys, tsys = pair8
    ss, ts = _batch(g, 13)
    for system, topo in ((rsys, rtopo), (tsys, ttopo)):
        _scrub(system)
        system.placement = topo.EdgePlacement(
            np.array([0, 0, 1, 1, 2, 2, 3, 3]), 4)
    try:
        rplane = redge.ScatterGatherPlane.from_system(rsys)
        tplane = tedge.ScatterGatherPlane.from_system(tsys)
        np.testing.assert_array_equal(tplane.execute(ss, ts),
                                      rplane.execute(ss, ts))
        first = dict(tplane.exchange_stats)
        assert first == rplane.exchange_stats
        assert first["co_hosted_rows"] > 0 and first["exchanges"] > 0
        tplane.execute(ss, ts)
        assert tplane.exchange_stats == first          # held-set replay
        again = tedge.ScatterGatherPlane.from_system(tsys)
        again.execute(ss, ts)
        assert again.exchange_stats["rows_exchanged"] == 0
        for r, t in zip(rsys.servers, tsys.servers):
            assert sorted(r._border_rows) == sorted(t._border_rows)
            for j in r._border_rows:
                for a, b in zip(r.border_rows_of(j), t.border_rows_of(j)):
                    np.testing.assert_array_equal(a, b)
    finally:
        rsys.placement = tsys.placement = None


def test_coordinator_holds_no_border_table(pair8, monkeypatch):
    """The center is off the clean read path: the packed B is dropped at
    build time, no call reaches the center, and the servers' views are
    allocated lazily — each holding exactly the rows it was sent."""
    g, rsys, tsys = pair8
    _scrub(tsys)
    for d in range(len(tsys.servers)):
        for a, b in zip(tsys.center.border_rows_for(d),
                        rsys.center.border_rows_for(d)):
            np.testing.assert_array_equal(a, b)
    plane = tedge.ScatterGatherPlane.from_system(tsys)
    assert plane.data.btable is None and plane.data.district_table is None
    assert all(v is None for v in plane._bviews)
    base = plane.size_bytes()

    def no_center(*a, **k):
        raise AssertionError("the clean path reached the center")

    monkeypatch.setattr(tsys.center, "answer_cross_many", no_center)
    monkeypatch.setattr(tsys.center, "border_table_device", no_center)
    ss, ts = _batch(g, 17)
    plane.execute(ss, ts)
    assert plane.size_bytes() > base
    table = tsys.center.border_labels.table
    for d, view in enumerate(plane._bviews):
        if view is None:
            continue
        held = np.zeros(len(table), dtype=bool)
        for j in plane._held[d]:
            held[tsys.center.border_rows_for(j)[0]] = True
        np.testing.assert_array_equal(view.numpy()[held], table[held])
        assert torch.isinf(view[torch.from_numpy(~held)]).all()


def test_exchange_border_rows_contract(pair8):
    g, rsys, tsys = pair8
    tsys._current_scatter_plane()         # the center pushed own slices
    a, b = tsys.servers[0], tsys.servers[1]
    a._border_rows.pop(b.district_id, None)
    n_b = int((tsys.partition.assignment == np.int32(b.district_id)).sum())
    assert a.exchange_border_rows(b) == n_b
    assert a.exchange_border_rows(b) == 0
    verts, rows = a.border_rows_of(b.district_id)
    np.testing.assert_array_equal(rows,
                                  tsys.center.border_labels.table[verts])
    old = b.border_rows_version
    b.border_rows_version = old + 999
    try:
        with pytest.raises(ValueError, match="version mismatch"):
            a.exchange_border_rows(b)
    finally:
        b.border_rows_version = old


def test_empty_and_single_lane_batches(pair8):
    g, rsys, tsys = pair8
    plane = tsys._current_scatter_plane()
    assert plane.execute(np.zeros(0, np.int64),
                         np.zeros(0, np.int64)).shape == (0,)
    np.testing.assert_array_equal(plane.execute(np.array([3]),
                                                np.array([3])),
                                  np.zeros(1, dtype=np.float32))


def test_window_and_traffic_update_swap_the_plane():
    """Both packages through a rebuild window and a traffic update in
    lockstep: the plane is None mid-window (the bucketed plane serves),
    resumes after, and swaps with the version; answers stay equal."""
    g, rsys, tsys = _deploy_pair(rows=8, seed=4, districts=4, part_seed=5)
    ss, ts = _batch(g, 19, size=256)
    rsvc = rsys.service(rserve.ServingPolicy(**SCATTER))
    tsvc = tsys.service(tserve.ServingPolicy(**SCATTER))
    p0 = tsys._current_scatter_plane()
    np.testing.assert_array_equal(tsvc.submit(ss, ts).distances,
                                  rsvc.submit(ss, ts).distances)
    w2 = rcore.perturb_weights(g, np.random.default_rng(23), lo=0.9, hi=1.2)
    w2 = np.ceil(w2)
    rserve.open_rebuild_window(rsys, w2)
    tserve.open_rebuild_window(tsys, w2)
    assert tsys._current_scatter_plane() is None
    plan = tsvc.plan(ss, ts)
    assert isinstance(plan.plane, tserve.BucketedPlane)
    np.testing.assert_array_equal(plan.execute().distances,
                                  rsvc.plan(ss, ts).execute().distances)
    rserve.close_rebuild_window(rsys)
    tserve.close_rebuild_window(tsys)
    p1 = tsys._current_scatter_plane()
    assert p1 is not p0 and p1.version == tsys.center.version > p0.version
    got = tsvc.submit(ss, ts).distances
    np.testing.assert_array_equal(got, rsvc.submit(ss, ts).distances)
    np.testing.assert_array_equal(got, tsys.query_loop(ss, ts))
    for srv in tsys.servers:
        assert srv.border_rows_version == tsys.center.version
        assert srv.stale_border_rows_of(srv.district_id) is not None


@pytest.mark.parametrize("shape", [(0, 5), (3, 0), (7, 13), (300, 93)])
def test_join_partial_gathered_matches_reference(shape):
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    s = rng.uniform(0, 50, size=shape).astype(np.float32)
    t = rng.uniform(0, 50, size=shape).astype(np.float32)
    s[rng.random(shape) < 0.3] = np.inf
    t[rng.random(shape) < 0.3] = np.inf
    got = tops.join_partial_gathered(torch.from_numpy(s),
                                     torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    for use_pallas in (False, True):
        np.testing.assert_array_equal(
            got.numpy(), rops.join_partial_gathered(s, t,
                                                    use_pallas=use_pallas))


@pytest.mark.parametrize("dtype,lossless", [(np.uint16, True),
                                            (np.uint16, False),
                                            (np.int16, False)])
def test_dequantize_matches_quantspec(dtype, lossless):
    rng = np.random.default_rng(3)
    values = rng.uniform(0, 900, size=(64, 40)).astype(np.float32)
    if lossless:
        values = np.rint(values)
    values[rng.random(values.shape) < 0.2] = np.inf
    spec = tcore.QuantSpec.fit(values, dtype=dtype) if lossless \
        else tcore.QuantSpec(float(np.float32(0.0731)), dtype,
                             lossless=False)
    rspec = rcore.QuantSpec(spec.scale, dtype, lossless=spec.lossless)
    codes = spec.quantize(values)
    got = dequantize(tops.upload(codes, "cpu"), spec)
    np.testing.assert_array_equal(got.numpy(), rspec.dequantize(codes))
