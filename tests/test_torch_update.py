"""The port's traffic updates against the JAX package.

The same graphs, partitions and seeded deltas go through the JAX
package's ``repro.update`` (``IncrementalBuilder(use_pallas=False)``,
and once with its Pallas kernels in interpret mode) and the port's
``repro_torch.update`` on ``device="cpu"``, where the repair's stages
run the kernels' plain versions. Held equal without tolerance: the
classified deltas, the scenario weights, every field of the repaired
``BuildState`` and every report field (``incremental``,
``changed_rows``, ``dirty_districts``, ``affected_districts``,
``closure_reused``, ``repruned_rows``), and the repaired table against
the port's own full build on the new weights (the stages are exact:
min of single float32 adds, order-free). Through ``ComputingCenter``
and ``EdgeSystem`` the delta-scoped update cycle stays exact against
Dijkstra, keeps clean districts serving, and keeps the rebuild window
exact while an update is mid-flight.
"""
import numpy as np
import pytest

import repro.core as rcore
import repro.edge as redge
import repro.update as rupdate
import repro_torch.core as tcore
import repro_torch.edge as tedge
import repro_torch.update as tupdate
from repro_torch.update.incremental import IncrementalBuilder

SCENARIO_NAMES = sorted(tupdate.SCENARIOS)
STATE_FIELDS = ("intra", "overlay", "closure", "unpruned", "table",
                "prune_order", "weights")


def _grid(core):
    g = core.grid_road_network(10, 10, seed=11)
    return g, core.bfs_grow_partition(g, 5, seed=0)


@pytest.fixture(scope="module")
def grids():
    return _grid(rcore), _grid(tcore)


def _pendant_two_block_graph(core):
    """Two 3×3 grid blocks joined by one cross edge, plus a pendant
    vertex (18) off an interior corner of block 0: changing the pendant
    edge moves no border-to-border distance, so the repair takes every
    warm path (closure reuse + row-scoped re-prune)."""
    us, vs = [], []
    for b in range(2):
        o = 9 * b
        for r in range(3):
            for c in range(3):
                if c + 1 < 3:
                    us.append(o + 3 * r + c); vs.append(o + 3 * r + c + 1)
                if r + 1 < 3:
                    us.append(o + 3 * r + c); vs.append(o + 3 * (r + 1) + c)
    us.append(8); vs.append(9)        # cross edge: borders are 8 and 9
    us.append(0); vs.append(18)       # pendant off vertex 0 (interior)
    w = 1.0 + np.arange(len(us), dtype=np.float32) % 5
    g = core.from_edges(19, np.array(us), np.array(vs), w)
    assignment = np.array([0] * 9 + [1] * 9 + [0], dtype=np.int32)
    return g, core.Partition(assignment, 2)


def _arc_mask(g, u, v):
    src = g.arc_sources()
    return ((src == u) & (g.indices == v)) | ((src == v) & (g.indices == u))


def _assert_same_delta(got, want):
    for f in ("dirty_arcs", "num_dirty_edges", "num_edges",
              "dirty_districts", "cross_dirty", "num_districts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.is_empty == want.is_empty
    assert got.summary() == want.summary()


def _assert_same_repair(tb, rb, trep, rrep):
    """Port builder ``tb`` and report ``trep`` against the JAX
    package's ``rb`` / ``rrep``, field by field."""
    assert set(trep) == set(rrep)
    for k in rrep:
        if k != "seconds":
            np.testing.assert_array_equal(np.asarray(trep[k]),
                                          np.asarray(rrep[k]), err_msg=k)
    for f in STATE_FIELDS:
        w = getattr(rb.state, f)
        if w is None:
            assert getattr(tb.state, f) is None, f
        else:
            np.testing.assert_array_equal(getattr(tb.state, f), w,
                                          err_msg=f)
    np.testing.assert_array_equal(tb.state.packed.border_ids,
                                  rb.state.packed.border_ids)
    # the device table is the repaired one, never the previous epoch's
    np.testing.assert_array_equal(tb.state.table_device.numpy(),
                                  tb.state.table)


def _assert_equals_full_build(labels, g, part, prune=True):
    full = IncrementalBuilder(prune=prune, device="cpu").build_full(g, part)
    np.testing.assert_array_equal(labels.table, full.table)
    np.testing.assert_array_equal(labels.border_ids, full.border_ids)


# ---------------------------------------------------------------------------
# delta classification, scenarios, sparse updates
# ---------------------------------------------------------------------------

def test_classify_delta_equals_jax(grids):
    (rg, rpart), (tg, tpart) = grids
    src = tg.arc_sources()
    intra = tpart.assignment[src] == tpart.assignment[tg.indices]
    cases = [tg.weights.copy()]
    for mask, factor in ((intra, 2.0), (~intra, 3.0)):
        arc = int(np.nonzero(mask)[0][0])
        w = tg.weights.copy()
        w[_arc_mask(tg, int(src[arc]), int(tg.indices[arc]))] *= \
            np.float32(factor)
        cases.append(w)
    cases.append(tcore.perturb_weights(tg, np.random.default_rng(2),
                                       frac=0.2))
    for w in cases:
        _assert_same_delta(tupdate.classify_delta(tg, tpart, w),
                           rupdate.classify_delta(rg, rpart, w))
    with pytest.raises(ValueError):
        tupdate.classify_delta(tg, tpart, tg.weights[:-2])


@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_scenario_weights_equal_jax(grids, name):
    (rg, rpart), (tg, tpart) = grids
    for seed, intensity in ((17, 0.05), (3, 0.2)):
        got = tupdate.scenario_weights(name, tg, tpart,
                                       np.random.default_rng(seed),
                                       intensity)
        want = rupdate.scenario_weights(name, rg, rpart,
                                        np.random.default_rng(seed),
                                        intensity)
        np.testing.assert_array_equal(got, want)
        tg.with_weights(got)                 # symmetric


def test_scenarios_terminate_on_disconnected_graphs():
    g = tcore.from_edges(6, np.array([0, 1, 2, 3, 4, 5]),
                         np.array([1, 2, 0, 4, 5, 3]),
                         np.ones(6, dtype=np.float32))
    part = tcore.Partition(np.array([0, 0, 0, 1, 1, 1], dtype=np.int32), 2)
    for name in ("incident", "rush_hour"):
        w2 = tupdate.scenario_weights(name, g, part,
                                      np.random.default_rng(0), 1.0)
        g.with_weights(w2)


def test_weights_from_arc_updates_equal_jax(grids):
    (rg, _), (tg, _) = grids
    for u, v, w in (([0], [1], [9.5]), ([0, 0], [1, 1], [4.0, 6.0]),
                    ([22, 0], [23, 1], [2.0, 3.0])):
        np.testing.assert_array_equal(
            tupdate.weights_from_arc_updates(tg, u, v, w),
            rupdate.weights_from_arc_updates(rg, u, v, w))
    with pytest.raises(ValueError, match="structural delta"):
        tupdate.weights_from_arc_updates(tg, [0], [55], [1.0])
    with pytest.raises(ValueError, match="not a valid"):
        tupdate.weights_from_arc_updates(tg, [0], [0], [1.0])


# ---------------------------------------------------------------------------
# IncrementalBuilder.apply_delta against the JAX package's
# ---------------------------------------------------------------------------

def _builders(rg, rpart, tg, tpart, prune=True, use_pallas=False):
    rb = rupdate.IncrementalBuilder(prune=prune, use_pallas=use_pallas)
    tb = IncrementalBuilder(prune=prune, device="cpu")
    rb.build_full(rg, rpart)
    tb.build_full(tg, tpart)
    return rb, tb


@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_apply_delta_equals_jax_and_full_build(grids, name):
    (rg, rpart), (tg, tpart) = grids
    rb, tb = _builders(rg, rpart, tg, tpart)
    rng = np.random.default_rng(3)
    rcur, tcur = rg, tg
    for intensity in (0.01, 0.08):
        w2 = tupdate.scenario_weights(name, tcur, tpart, rng, intensity)
        rg2, tg2 = rcur.with_weights(w2), tcur.with_weights(w2)
        rl, rrep = rb.apply_delta(rg2, rpart,
                                  rupdate.classify_delta(rcur, rpart, w2))
        tl, trep = tb.apply_delta(tg2, tpart,
                                  tupdate.classify_delta(tcur, tpart, w2))
        _assert_same_repair(tb, rb, trep, rrep)
        np.testing.assert_array_equal(tl.table, rl.table)
        _assert_equals_full_build(tl, tg2, tpart)
        rcur, tcur = rg2, tg2


def test_apply_delta_random_deltas_equal_jax(grids):
    """Random symmetric deltas of any size and direction, in sequence,
    classified by the builder itself (no delta passed)."""
    (rg, rpart), (tg, tpart) = grids
    rb, tb = _builders(rg, rpart, tg, tpart)
    rcur, tcur = rg, tg
    for seed in range(1, 7):
        rng = np.random.default_rng(seed)
        frac = float(rng.uniform(0.002, 0.9))
        lo, hi = sorted(rng.uniform(0.5, 2.0, size=2))
        w2 = tcore.perturb_weights(tcur, rng, lo=lo, hi=max(hi, lo + 1e-3),
                                   frac=frac)
        rg2, tg2 = rcur.with_weights(w2), tcur.with_weights(w2)
        rl, rrep = rb.apply_delta(rg2, rpart)
        tl, trep = tb.apply_delta(tg2, tpart)
        _assert_same_repair(tb, rb, trep, rrep)
        _assert_equals_full_build(tl, tg2, tpart)
        rcur, tcur = rg2, tg2


def test_apply_delta_equals_jax_through_pallas(grids):
    (rg, rpart), (tg, tpart) = grids
    rb, tb = _builders(rg, rpart, tg, tpart, use_pallas=True)
    w2 = tupdate.scenario_weights("incident", tg, tpart,
                                  np.random.default_rng(5), 0.02)
    _, rrep = rb.apply_delta(rg.with_weights(w2), rpart)
    _, trep = tb.apply_delta(tg.with_weights(w2), tpart)
    assert trep["incremental"]
    _assert_same_repair(tb, rb, trep, rrep)


def test_apply_delta_unpruned_variant(grids):
    (rg, rpart), (tg, tpart) = grids
    rb, tb = _builders(rg, rpart, tg, tpart, prune=False)
    w2 = tupdate.scenario_weights("incident", tg, tpart,
                                  np.random.default_rng(5), 0.02)
    rl, rrep = rb.apply_delta(rg.with_weights(w2), rpart)
    tl, trep = tb.apply_delta(tg.with_weights(w2), tpart)
    _assert_same_repair(tb, rb, trep, rrep)
    _assert_equals_full_build(tl, tg.with_weights(w2), tpart, prune=False)


def test_apply_delta_single_district_empty_border():
    rg = rcore.grid_road_network(5, 5, seed=2)
    tg = tcore.grid_road_network(5, 5, seed=2)
    rpart = rcore.bfs_grow_partition(rg, 1, seed=0)
    tpart = tcore.bfs_grow_partition(tg, 1, seed=0)
    rb, tb = _builders(rg, rpart, tg, tpart)
    assert tb.state.labels().num_borders == 0
    w2 = tcore.perturb_weights(tg, np.random.default_rng(0))
    rl, rrep = rb.apply_delta(rg.with_weights(w2), rpart)
    tl, trep = tb.apply_delta(tg.with_weights(w2), tpart)
    assert trep["incremental"] and tl.num_borders == 0
    _assert_same_repair(tb, rb, trep, rrep)


def test_apply_delta_scoped_prune_and_closure_reuse():
    (rg, rpart), (tg, tpart) = (_pendant_two_block_graph(rcore),
                                _pendant_two_block_graph(tcore))
    rb, tb = _builders(rg, rpart, tg, tpart)
    w2 = tg.weights.copy()
    w2[(tg.arc_sources() == 18) | (tg.indices == np.int32(18))] *= \
        np.float32(4.0)
    rl, rrep = rb.apply_delta(rg.with_weights(w2), rpart)
    tl, trep = tb.apply_delta(tg.with_weights(w2), tpart)
    assert trep["incremental"] and trep["closure_reused"]
    assert trep["repruned_rows"] == 1
    assert trep["changed_rows"].sum() == 1 and trep["changed_rows"][18]
    _assert_same_repair(tb, rb, trep, rrep)
    _assert_equals_full_build(tl, tg.with_weights(w2), tpart)


def test_apply_delta_noop_and_timings(grids):
    (_, _), (tg, tpart) = grids
    tb = IncrementalBuilder(device="cpu")
    tb.build_full(tg, tpart)
    table_dev = tb.state.table_device
    labels, rep = tb.apply_delta(tg.with_weights(tg.weights.copy()), tpart)
    assert rep["incremental"] and not rep["changed_rows"].any()
    assert tb.state.table_device is table_dev
    assert tb.timings["stage_a_sweeps"] == 0
    w2 = tupdate.scenario_weights("incident", tg, tpart,
                                  np.random.default_rng(5), 0.02)
    _, rep = tb.apply_delta(tg.with_weights(w2), tpart)
    assert rep["incremental"]
    assert set(tb.timings) == {"classify_s", "stage_a_pack_s",
                               "stage_a_sweeps_s", "stage_a_s",
                               "stage_a_sweeps", "overlay_s", "stage_b_s",
                               "stage_c_s", "stage_d_s"}
    assert tb.timings["stage_a_s"] == tb.timings["stage_a_pack_s"] \
        + tb.timings["stage_a_sweeps_s"]
    assert tb.timings["stage_a_pack_s"] > 0 < tb.timings["stage_a_sweeps_s"]
    assert 1 <= tb.timings["stage_a_sweeps"] < tb.state.packed.kmax


# ---------------------------------------------------------------------------
# ComputingCenter: scoped shortcut invalidation
# ---------------------------------------------------------------------------

def _centers(rg, rpart, tg, tpart, builder):
    rc = redge.ComputingCenter(rg, rpart,
                               builder="jax" if builder == "torch"
                               else builder)
    tc = tedge.ComputingCenter(tg, tpart, builder=builder, device="cpu")
    rc.rebuild()
    tc.rebuild()
    return rc, tc


def _assert_same_center_report(trep, rrep):
    assert set(trep) == set(rrep)
    for k in ("seconds", "delta"):
        trep, rrep = dict(trep), dict(rrep)
        trep.pop(k), rrep.pop(k)
    for k in rrep:
        np.testing.assert_array_equal(np.asarray(trep[k]),
                                      np.asarray(rrep[k]), err_msg=k)


@pytest.mark.parametrize("builder", ["torch", "reference"])
def test_center_apply_delta_scoped_invalidation_equals_jax(builder):
    (rg, rpart), (tg, tpart) = (_pendant_two_block_graph(rcore),
                                _pendant_two_block_graph(tcore))
    rc, tc = _centers(rg, rpart, tg, tpart, builder)
    for i in range(tpart.num_districts):
        tc.shortcuts_for(i)
        rc.shortcuts_for(i)
    cached = dict(tc._shortcut_cache)
    w2 = tg.weights.copy()
    w2[(tg.arc_sources() == 18) | (tg.indices == np.int32(18))] *= \
        np.float32(4.0)
    _assert_same_center_report(tc.apply_delta(w2), rc.apply_delta(w2))
    if builder == "torch":
        # no border row moved: every cached shortcut matrix survives
        assert all(tc._shortcut_cache[i] is cached[i]
                   for i in range(tpart.num_districts))
    w3 = tc.graph.weights.copy()
    w3[_arc_mask(tg, 8, 9)] *= np.float32(2.0)
    trep, rrep = tc.apply_delta(w3), rc.apply_delta(w3)
    _assert_same_center_report(trep, rrep)
    assert trep["stale_districts"]
    assert tc.version == rc.version == 3
    np.testing.assert_array_equal(tc.border_labels.table,
                                  rc.border_labels.table)
    # B's device copy is the repaired table of the new version
    assert tc.border_table_device() is \
        tc.incremental_builder().state.table_device
    np.testing.assert_array_equal(tc.border_table_device().numpy(),
                                  tc.border_labels.table)
    for i in range(tpart.num_districts):
        np.testing.assert_array_equal(tc.shortcuts_for(i),
                                      rc.shortcuts_for(i))


def test_center_apply_delta_noop_keeps_version(grids):
    (_, _), (tg, tpart) = grids
    tc = tedge.ComputingCenter(tg, tpart, builder="torch", device="cpu")
    tc.rebuild()
    rep = tc.apply_delta(tg.weights.copy())
    assert rep["noop"] and tc.version == 1


def test_center_apply_delta_rejects_asymmetric_update(grids):
    (_, _), (tg, tpart) = grids
    tc = tedge.ComputingCenter(tg, tpart, builder="torch", device="cpu")
    tc.rebuild()
    w2 = tg.weights.copy()
    w2[0] += np.float32(5.0)
    with pytest.raises(ValueError):
        tc.apply_delta(w2)


# ---------------------------------------------------------------------------
# EdgeSystem: the delta-scoped update cycle
# ---------------------------------------------------------------------------

def _dijkstra_many(g, ss, ts):
    return np.array([tcore.dijkstra(g, int(s))[int(t)]
                     for s, t in zip(ss, ts)], dtype=np.float32)


def test_edge_system_incremental_update_equals_jax_and_dijkstra(grids):
    (rg, rpart), (tg, tpart) = grids
    rsys = redge.EdgeSystem.deploy(rg, rpart, builder="jax")
    tsys = tedge.EdgeSystem.deploy(tg, tpart, builder="torch", device="cpu")
    rng = np.random.default_rng(7)
    for name in ("incident", "rush_hour"):
        w2 = tupdate.scenario_weights(name, tsys.graph, tpart, rng, 0.03)
        rrep = rsys.apply_traffic_update(w2, incremental=True)
        trep = tsys.apply_traffic_update(w2, incremental=True)
        assert trep["incremental"]
        for k in ("incremental", "dirty_districts",
                  "stale_shortcut_districts", "clean_districts"):
            assert trep[k] == rrep[k], k
        assert set(trep["local_refresh_s"]) == set(rrep["local_refresh_s"])
        ss = rng.integers(0, tg.num_vertices, 60)
        ts = rng.integers(0, tg.num_vertices, 60)
        got = tsys.service().submit(ss, ts).distances
        np.testing.assert_array_equal(
            got, rsys.service().submit(ss, ts).distances)
        np.testing.assert_allclose(got, _dijkstra_many(tsys.graph, ss, ts),
                                   rtol=1e-5)
    noop = tsys.apply_traffic_update(tsys.graph.weights.copy(),
                                     incremental=True)
    assert noop["clean_districts"] == list(range(tpart.num_districts))


def test_edge_system_clean_districts_keep_serving():
    g, part = _pendant_two_block_graph(tcore)
    system = tedge.EdgeSystem.deploy(g, part, builder="torch", device="cpu")
    before = [srv.augmented for srv in system.servers]
    w2 = g.weights.copy()
    w2[(g.arc_sources() == 18) | (g.indices == np.int32(18))] *= \
        np.float32(4.0)
    timings = system.apply_traffic_update(w2, incremental=True)
    assert timings["dirty_districts"] == [0]
    assert timings["clean_districts"] == [1]
    assert system.servers[1].augmented is before[1]
    assert system.servers[1].augmented_version == system.center.version
    engine = system.current_engine()
    assert engine is not None
    assert system._engines_version[0] == system.center.version
    rng = np.random.default_rng(1)
    ss = rng.integers(0, g.num_vertices, 64)
    ts = rng.integers(0, g.num_vertices, 64)
    np.testing.assert_allclose(system.service().submit(ss, ts).distances,
                               _dijkstra_many(system.graph, ss, ts),
                               rtol=1e-5)


def test_rebuild_window_parity_while_update_midflight(grids):
    """Dirty districts refreshed their plain L_i and the center repaired
    B, but no shortcuts are installed yet: every answer is exact on the
    new weights (certificate or wait-for-push), never stale."""
    (_, _), (tg, tpart) = grids
    system = tedge.EdgeSystem.deploy(tg, tpart, builder="torch",
                                     device="cpu")
    rng = np.random.default_rng(9)
    w2 = tupdate.scenario_weights("regional", tg, tpart, rng, 0.2)
    rep = system.center.apply_delta(w2)
    g2 = system.center.graph
    system.graph = g2
    for i in rep["delta"].dirty_districts:
        system.servers[int(i)].refresh_local(g2, tpart)
    for i in rep["stale_districts"]:
        system.servers[i].augmented = None      # shortcut push pending
    assert system.current_engine() is None
    svc = system.service()
    for _ in range(25):
        s, t = (int(x) for x in rng.integers(0, g2.num_vertices, size=2))
        res = svc.query(s, t)
        assert res.distance == pytest.approx(
            float(tcore.dijkstra(g2, s)[t]), rel=1e-5), (s, t)
        assert res.exact
    assert svc.stats["lb_fallback_attempts"] > 0
    ss = rng.integers(0, g2.num_vertices, 48)
    ts = rng.integers(0, g2.num_vertices, 48)
    res = svc.submit(ss, ts)
    np.testing.assert_allclose(res.distances, _dijkstra_many(g2, ss, ts),
                               rtol=1e-5)
    assert res.exact.all()
    assert system.current_engine() is not None
