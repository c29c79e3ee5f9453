"""The port's serving path against the JAX package, bit for bit.

Two small deployments — a 10×10 grid road network in 4 BFS-grown
districts (float weights) and a 2×2 synthetic continent of 8×8 districts
(integer weights) — are deployed by both packages, and the JAX
package's index is also carried into the port with ``convert``. Held
equal without tolerance: graphs and partitions, B and every district's
labels, the packed engine tables and row ids, and through
``DistanceService`` the distances, rules, exactness codes, fallback and
wait flags and counters — steady state in float32, uint16, int16 and
auto storage, typed requests with client districts, and a rebuild
window under all three modes. Everything runs on ``device="cpu"``,
where the port's joins run their plain PyTorch versions.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest

import repro.core as rcore
import repro.edge as redge
import repro.ingest as ringest
import repro.serve as rserve
import repro_torch.core as tcore
import repro_torch.edge as tedge
import repro_torch.ingest as tingest
import repro_torch.serve as tserve
from repro.edge.sharded_oracle import pack_tables as rpack
from repro.edge.sharded_oracle import prepare_queries as rprepare
from repro_torch import convert
from repro_torch.edge.sharded_oracle import pack_tables as tpack
from repro_torch.edge.sharded_oracle import prepare_queries as tprepare
from repro_torch.update import IncrementalBuilder

CASES = ["grid", "continent"]
DTYPES = ["float32", "uint16", "int16", "auto"]


def _inputs(pkg_core, pkg_ingest, case):
    if case == "grid":
        g = pkg_core.grid_road_network(10, 10, seed=5)
        return g, pkg_core.bfs_grow_partition(g, 4)
    csr, part = pkg_ingest.synthetic_continent((2, 2), (8, 8), seed=3)
    return csr.to_graph(), part


def _deploy_both(case):
    rg, rpart = _inputs(rcore, ringest, case)
    tg, tpart = _inputs(tcore, tingest, case)
    return (rg, rpart, redge.EdgeSystem.deploy(rg, rpart),
            tg, tpart, tedge.EdgeSystem.deploy(tg, tpart, device="cpu"))


@pytest.fixture(scope="module", params=CASES)
def deployed(request):
    """Read-only deployments per case: (case, reference graph/partition/
    system, port graph/partition/system, port system loaded from the
    reference's index). Tests that mutate deploy their own."""
    rg, rpart, rsys, tg, tpart, tsys = _deploy_both(request.param)
    conv = convert.system_from_numpy(convert.index_to_numpy(rsys), "cpu")
    return request.param, (rg, rpart, rsys), (tg, tpart, tsys), conv


def _batch(part, seed, size=300):
    """Mixed-rule batch: random pairs, same-district pairs, s == t lanes,
    and client districts that turn some rule-1 lanes into rule 2."""
    rng = np.random.default_rng(seed)
    n = len(part.assignment)
    ss, ts = rng.integers(0, n, size), rng.integers(0, n, size)
    members = part.districts()
    for i in range(0, size, 2):
        d = members[int(part.assignment[ss[i]])]
        ts[i] = d[rng.integers(len(d))]
    ss[::17] = ts[::17]
    client = part.assignment[ss].astype(np.int32)
    flip = rng.random(size) < 0.25
    client[flip] = rng.integers(0, part.num_districts, int(flip.sum()))
    return ss.astype(np.int64), ts.astype(np.int64), client


def _assert_batches_equal(got, want):
    np.testing.assert_array_equal(got.distances, want.distances)
    np.testing.assert_array_equal(got.rules, want.rules)
    np.testing.assert_array_equal(got.exactness_codes, want.exactness_codes)
    np.testing.assert_array_equal(got.fallback, want.fallback)
    np.testing.assert_array_equal(got.waited, want.waited)
    np.testing.assert_array_equal(got.exact, want.exact)
    assert got.counters() == want.counters()


# -- the index: generators, deploy, convert ---------------------------------

@pytest.mark.parametrize("case", CASES)
def test_graph_and_partition_generators_match(case):
    rg, rpart = _inputs(rcore, ringest, case)
    tg, tpart = _inputs(tcore, tingest, case)
    for a, b in ((rg.indptr, tg.indptr), (rg.indices, tg.indices),
                 (rg.weights, tg.weights),
                 (rpart.assignment, tpart.assignment)):
        np.testing.assert_array_equal(a, b)
    assert rpart.num_districts == tpart.num_districts


def test_own_deploy_builds_the_reference_index(deployed):
    _, (_, _, rsys), (_, _, tsys), _ = deployed
    np.testing.assert_array_equal(tsys.center.border_labels.table,
                                  rsys.center.border_labels.table)
    np.testing.assert_array_equal(tsys.center.border_labels.border_ids,
                                  rsys.center.border_labels.border_ids)
    assert tsys.center.version == rsys.center.version
    for rs_, ts_ in zip(rsys.servers, tsys.servers):
        for r, t in ((rs_.plain, ts_.plain),
                     (rs_.augmented, ts_.augmented)):
            np.testing.assert_array_equal(t.labels.hubs, r.labels.hubs)
            np.testing.assert_array_equal(t.labels.dists, r.labels.dists)
            np.testing.assert_array_equal(t.border_dist, r.border_dist)
            np.testing.assert_array_equal(t.dense_table(), r.dense_table())
            np.testing.assert_array_equal(
                t.dense_table_device().numpy(), r.dense_table())
        assert ts_.augmented_version == rs_.augmented_version


def test_convert_carries_the_index_across(deployed):
    _, (_, _, rsys), (_, _, tsys), conv = deployed
    want = convert.index_to_numpy(rsys)
    for system in (tsys, conv):
        got = convert.index_to_numpy(system)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_hierarchical_border_labels_match(case):
    rg, rpart = _inputs(rcore, ringest, case)
    tg, tpart = _inputs(tcore, tingest, case)
    want = rcore.build_border_labels_hierarchical(rg, rpart)
    got = tcore.build_border_labels_hierarchical(tg, tpart)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.border_ids, want.border_ids)


# (n, q, share of +inf entries): one hub, a dense table, a sparse one and
# one where most labels survive the prune
PRUNE_CASES = [(9, 1, 0.0), (300, 40, 0.0), (500, 64, 0.6), (2000, 96, 0.2)]


@pytest.mark.parametrize("n,q,inf_share", PRUNE_CASES)
def test_prune_table_matches(n, q, inf_share):
    """The port's hub-major prune against the reference's, bit for bit,
    on seeded tables (integer distances, so that ties occur)."""
    from repro.core.border_labeling import prune_table as rprune
    from repro_torch.core.border_labeling import prune_table as tprune
    rng = np.random.default_rng(n + q)
    border_ids = np.sort(rng.choice(n, q, replace=False)).astype(np.int32)
    table = rng.integers(1, 40, (n, q)).astype(np.float32)
    table[rng.random((n, q)) < inf_share] = np.inf
    table[border_ids, np.arange(q)] = 0.0
    rank = rng.permutation(n)
    want = rprune(table, border_ids, rank)
    got = tprune(table, border_ids, rank)
    assert got.dtype == want.dtype and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)


# -- host table layout -------------------------------------------------------

LAYOUTS = {
    "combined_f32": dict(num_devices=1, combined=True),
    "combined_u16": dict(num_devices=1, combined=True, quant="uint16"),
    "combined_i16": dict(num_devices=1, combined=True, quant="int16"),
    "blocked_3": dict(num_devices=3),
    "border_sharded_2": dict(num_devices=2, shard_border=True),
    "placement": dict(num_devices=2, placement=[1, 0, 1, 0]),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pack_tables_and_row_ids_match(deployed, layout):
    _, (_, rpart, rsys), _, conv = deployed
    kw = dict(LAYOUTS[layout])
    dtype = kw.pop("quant", None)
    if "placement" in kw:
        kw["placement"] = np.array(kw["placement"])
    btable = rsys.center.border_labels.table
    rlocals = [s.augmented for s in rsys.servers]
    tlocals = [s.augmented for s in conv.servers]
    rq = None if dtype is None else rcore.fit_label_spec(
        btable, rlocals, dtype=np.dtype(dtype))
    tq = None if dtype is None else tcore.fit_label_spec(
        btable, tlocals, dtype=np.dtype(dtype))
    if dtype is not None:
        assert (tq.scale, tq.dtype, tq.lossless) == \
            (rq.scale, rq.dtype, rq.lossless)
    want = rpack(btable, rlocals, rpart.assignment, quant=rq, **kw)
    got = tpack(btable, tlocals, rpart.assignment, quant=tq, **kw)
    for name in ("district_table", "btable", "combined_table",
                 "local_pos", "assignment", "device_of", "slot_of"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.bytes_per_device() == want.bytes_per_device()
    ss, ts, _ = _batch(rpart, 5)
    rq_, tq_ = rprepare(want, ss, ts), tprepare(got, ss, ts)
    for k in ("owner", "rs", "rt"):
        np.testing.assert_array_equal(tq_[k], rq_[k])


def test_engine_holds_the_reference_table(deployed):
    _, (_, _, rsys), _, conv = deployed
    for dtype in ("float32", "uint16"):
        want = rsys._current_engine(prefer_sharded=False, label_dtype=dtype)
        got = conv._current_engine(label_dtype=dtype)
        assert isinstance(got, tedge.BatchedQueryEngine)
        assert got.size_bytes() == want.size_bytes()
        assert got.data.combined_table is None     # host copy released
        np.testing.assert_array_equal(
            got.table.numpy().view(np.asarray(want._table).dtype),
            np.asarray(want._table))


# -- steady-state serving ----------------------------------------------------

@pytest.mark.parametrize("which", ["own", "converted"])
@pytest.mark.parametrize("label_dtype", DTYPES)
def test_submit_matches_reference(deployed, label_dtype, which):
    _, (_, rpart, rsys), (_, _, tsys), conv = deployed
    system = tsys if which == "own" else conv
    ss, ts, client = _batch(rpart, 11)
    rsvc = rsys.service(rserve.ServingPolicy(engine="replicated",
                                             label_dtype=label_dtype))
    tsvc = system.service(tserve.ServingPolicy(label_dtype=label_dtype))
    for cd in (None, client):
        _assert_batches_equal(tsvc.submit(ss, ts, client_districts=cd),
                              rsvc.submit(ss, ts, client_districts=cd))
    assert isinstance(tsvc.plan(ss, ts).plane, tedge.BatchedQueryEngine)
    assert tsvc.stats == rsvc.stats
    np.testing.assert_array_equal(tsvc.district_load, rsvc.district_load)


def test_kernels_off_and_scalar_paths_match_reference(deployed):
    """The reference's kernels-off host path against the port's bucketed
    plane (the port has no kernels-off switch: on ``device="cpu"`` its
    joins run their plain versions), then the scalar paths."""
    _, (_, rpart, rsys), _, conv = deployed
    ss, ts, client = _batch(rpart, 12, size=120)
    rsvc = rsys.service(rserve.ServingPolicy(use_kernels=False))
    assert isinstance(rsvc.plan(ss, ts).plane, rserve.BucketedPlane)
    with pytest.raises(TypeError):
        tserve.ServingPolicy(use_kernels=False)
    tsvc = conv.service()
    plan = dataclasses.replace(tsvc.plan(ss, ts, client),
                               plane=tserve.BucketedPlane(tsvc))
    _assert_batches_equal(plan.execute(),
                          rsvc.submit(ss, ts, client_districts=client))
    np.testing.assert_array_equal(conv.query_loop(ss, ts),
                                  rsys.query_loop(ss, ts))
    for s, t, c in zip(ss[:20], ts[:20], client[:20]):
        a = conv.service().query(int(s), int(t), int(c))
        b = rsys.service().query(int(s), int(t), int(c))
        assert (a.distance, int(a.rule), a.exactness, a.index_version,
                a.waited) == (b.distance, int(b.rule), b.exactness,
                              b.index_version, b.waited)
    same = np.nonzero(rpart.assignment[ss] == rpart.assignment[ts])[0]
    tcert, rcert = conv.service().certifier(), rsys.service().certifier()
    assert [tcert(ss[i], ts[i]) for i in same] == \
        [rcert(ss[i], ts[i]) for i in same]


def test_engines_are_cached_once_per_version_and_dtype(deployed):
    """Services share the router's engines, one per storage dtype, and
    keep none alive once the index version moves."""
    _, (_, rpart, rsys), _, _ = deployed
    system = convert.system_from_numpy(convert.index_to_numpy(rsys), "cpu")
    ss, ts, _ = _batch(rpart, 17, size=50)
    svc32 = system.service(tserve.ServingPolicy(label_dtype="float32"))
    svc16 = system.service(tserve.ServingPolicy(label_dtype="uint16"))
    e32, e16 = svc32.plan(ss, ts).plane, svc16.plan(ss, ts).plane
    assert e32.quant is None and e16.quant is not None
    assert svc32.plan(ss, ts).plane is e32
    assert system._current_engine(label_dtype="float32") is e32
    assert system._current_engine(label_dtype="uint16") is e16
    assert sorted(system._engines) == ["float32", "uint16"]
    stale = weakref.ref(e32)
    del e32, e16
    system.apply_traffic_update(system.graph.weights)
    fresh = svc32.plan(ss, ts).plane
    gc.collect()
    assert stale() is None
    assert list(system._engines) == ["float32"]
    np.testing.assert_array_equal(
        svc32.submit(ss, ts).distances,
        rsys.service(rserve.ServingPolicy(engine="replicated")).submit(
            ss, ts).distances)
    assert fresh is system._current_engine(label_dtype="float32")


def test_bucketed_plane_matches_engine(deployed):
    _, (_, rpart, _), _, conv = deployed
    ss, ts, _ = _batch(rpart, 13)
    svc = conv.service()
    np.testing.assert_array_equal(tserve.BucketedPlane(svc).execute(ss, ts),
                                  svc.plan(ss, ts).plane.execute(ss, ts))


def test_typed_requests_match_reference(deployed):
    _, (_, rpart, rsys), _, conv = deployed
    ss, ts, client = _batch(rpart, 14, size=60)
    rreq = [rserve.QueryRequest(int(s), int(t), int(c) if i % 3 else None)
            for i, (s, t, c) in enumerate(zip(ss, ts, client))]
    treq = [tserve.QueryRequest(r.s, r.t, r.client_district) for r in rreq]
    got = conv.service().submit_requests(treq)
    want = rsys.service().submit_requests(rreq)
    assert [(r.distance, int(r.rule), r.exactness, r.index_version,
             r.waited, r.exact) for r in got] == \
        [(r.distance, int(r.rule), r.exactness, r.index_version,
          r.waited, r.exact) for r in want]
    assert {int(r.rule) for r in got} == {1, 2, 3}
    assert conv.service().submit_requests([]) == []


def test_padding_mask_keeps_counters_equal(deployed):
    _, (_, rpart, rsys), _, conv = deployed
    ss, ts, _ = _batch(rpart, 15, size=40)
    real = np.arange(40) < 29
    got = conv.service().submit(ss, ts, real=real)
    want = rsys.service().submit(ss, ts, real=real)
    assert got.counters() == want.counters()
    assert sum(got.counters()[k] for k in ("rule1", "rule2", "rule3")) == 29
    np.testing.assert_array_equal(got.district_counts(4),
                                  want.district_counts(4))


# -- rebuild window: all three modes -----------------------------------------

def _open_window(system, w2):
    g2 = system.graph.with_weights(w2)
    system.graph = g2
    for srv in system.servers:
        srv.refresh_local(g2, system.partition)
    system.center.rebuild(w2)


@pytest.mark.parametrize("case", CASES)
def test_rebuild_window_modes_match_reference(case):
    rg, rpart, rsys, _, _, tsys = _deploy_both(case)
    w2 = rcore.perturb_weights(rg, np.random.default_rng(12), lo=0.7,
                               hi=1.4)
    if case == "continent":              # keep integer-second weights
        w2 = np.maximum(1.0, np.rint(w2)).astype(np.float32)
    _open_window(rsys, w2)
    _open_window(tsys, w2)
    np.testing.assert_array_equal(tsys.center.border_labels.table,
                                  rsys.center.border_labels.table)
    assert tsys.current_engine() is None
    ss, ts, client = _batch(rpart, 16, size=200)
    modes = (tserve.STALE_OK, tserve.CERTIFY_OR_WAIT, tserve.INSTALL_NOW)
    got, want = {}, {}
    for mode in modes:
        tsvc = tsys.service(tserve.ServingPolicy(rebuild=mode))
        rsvc = rsys.service(rserve.ServingPolicy(rebuild=mode))
        got[mode] = tsvc.submit(ss, ts, client_districts=client)
        want[mode] = rsvc.submit(ss, ts, client_districts=client)
        _assert_batches_equal(got[mode], want[mode])
        assert tsvc.stats == rsvc.stats
        if mode != tserve.INSTALL_NOW:
            assert tsys.current_engine() is None    # no side effect
    stale = got[tserve.STALE_OK]
    cert = stale.exactness_codes == 1
    assert cert.any() and (~stale.exact).any()
    for mode in modes:
        np.testing.assert_array_equal(got[mode].distances[cert],
                                      stale.distances[cert])
    np.testing.assert_array_equal(got[tserve.CERTIFY_OR_WAIT].distances,
                                  got[tserve.INSTALL_NOW].distances)
    # close the window on every server still stale, then steady state
    for system in (rsys, tsys):
        for srv in system.servers:
            if srv.augmented_version != system.center.version:
                srv.install_shortcuts(system.graph, system.partition,
                                      system.center.shortcuts_for(
                                          srv.district_id),
                                      system.center.version)
    after = {}
    for dtype in ("float32", "uint16"):
        after[dtype] = tsys.service(tserve.ServingPolicy(
            label_dtype=dtype)).submit(ss, ts, client_districts=client)
        _assert_batches_equal(after[dtype], rsys.service(
            rserve.ServingPolicy(engine="replicated",
                                 label_dtype=dtype)).submit(
            ss, ts, client_districts=client))
    np.testing.assert_array_equal(after["float32"].distances,
                                  got[tserve.INSTALL_NOW].distances)


@pytest.mark.parametrize("case", CASES)
def test_apply_traffic_update_matches_reference(case):
    rg, rpart, rsys, _, _, tsys = _deploy_both(case)
    w2 = rcore.perturb_weights(rg, np.random.default_rng(21))
    rrep = rsys.apply_traffic_update(w2)
    trep = tsys.apply_traffic_update(w2)
    assert set(trep) == set(rrep)
    assert tsys.center.version == rsys.center.version
    np.testing.assert_array_equal(tsys.center.border_labels.table,
                                  rsys.center.border_labels.table)
    ss, ts, client = _batch(rpart, 22)
    _assert_batches_equal(
        tsys.service().submit(ss, ts, client_districts=client),
        rsys.service(rserve.ServingPolicy(engine="replicated")).submit(
            ss, ts, client_districts=client))


# -- the sharded placements serve (tests/test_torch_sharded.py holds them) ---

def test_sharded_placements_serve(deployed):
    _, (_, rpart, rsys), _, conv = deployed
    ss, ts, client = _batch(rpart, 31)
    want = rsys.service(rserve.ServingPolicy(engine="sharded")).submit(
        ss, ts, client_districts=client)
    svc = conv.service(tserve.ServingPolicy(engine="sharded"))
    _assert_batches_equal(svc.submit(ss, ts, client_districts=client), want)
    assert isinstance(svc.plan(ss, ts).plane, tedge.ShardedBatchedEngine)
    conv.prefer_sharded = True
    try:
        _assert_batches_equal(
            conv.service().submit(ss, ts, client_districts=client), want)
        assert isinstance(conv.current_engine(), tedge.ShardedBatchedEngine)
    finally:
        conv.prefer_sharded = None
    assert isinstance(conv.current_engine(), tedge.BatchedQueryEngine)


# -- what this slice leaves out raises ---------------------------------------

def test_unported_placements_and_paths_raise(deployed):
    _, (rg, rpart, _), (tg, tpart, _), conv = deployed
    # the scatter-gather placement is ported (tests/test_torch_scatter_
    # gather.py); an unknown migration discipline is refused
    assert tserve.ServingPolicy(engine="scatter_gather").engine \
        == "scatter_gather"
    with pytest.raises(ValueError, match="migration"):
        tserve.ServingPolicy(engine="scatter_gather", migration="teleport")
    with pytest.raises(ValueError, match="engine"):
        tserve.ServingPolicy(engine="hybrid")
    with pytest.raises(ValueError, match="rebuild"):
        tserve.ServingPolicy(rebuild="yolo")
    with pytest.raises(ValueError, match="label_dtype"):
        tserve.ServingPolicy(label_dtype="uint8")
    with pytest.raises(ValueError, match="'torch'"):
        tedge.ComputingCenter(rg, rpart, builder="jax", device="cpu")
    with pytest.raises(ValueError, match="builder"):
        tedge.ComputingCenter(rg, rpart, builder="xla", device="cpu")
    # the delta-scoped updates are ported (tests/test_torch_update.py):
    # an unchanged weight array is a no-op that keeps every server clean,
    # and a builder with no cache takes the full rung
    rep = conv.apply_traffic_update(rg.weights, incremental=True)
    assert rep["incremental"] and conv.center.version == 1
    assert rep["clean_districts"] == list(range(rpart.num_districts))
    for repair in ("apply_delta", "apply_structural"):
        _, rep = getattr(IncrementalBuilder(device="cpu"), repair)(tg, tpart)
        assert not rep["incremental"] and rep["repruned_rows"] == "full"
        assert rep["changed_rows"].all()
