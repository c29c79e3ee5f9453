"""The port's topology updates (road closures and openings) against the
JAX package.

The same graphs, partitions and seeded storms go through the JAX
package's ``repro.topo`` / ``repro.ingest.closure_storm`` /
``IncrementalBuilder.apply_structural`` and the port's copies on
``device="cpu"``. Held equal without tolerance: the classified
structural deltas, the graph editors' results and errors, the storms'
graphs, every field of the repaired ``BuildState`` and every report
field, each epoch, over scoped (side-street) storms, storms with border
churn (the full-rebuild rung) and openings with reweights; and the
repaired table against the port's own full build on the new graph.
``EdgeSystem.apply_topology_update`` stays exact against Dijkstra and
equal to the JAX package's system.
"""
import numpy as np
import pytest

import repro.core as rcore
import repro.edge as redge
import repro.ingest as ringest
import repro.topo as rtopo
import repro.update as rupdate
import repro_torch.core as tcore
import repro_torch.edge as tedge
import repro_torch.ingest as tingest
import repro_torch.topo as ttopo
import repro_torch.update as tupdate
from repro_torch.core.partition import border_mask
from repro_torch.update.incremental import IncrementalBuilder

# hand-verified on this (10×10, 5-district) case in the JAX package's
# tests/test_topology_dynamic.py
INTRA_EDGE = (0, 1)        # intra edge, both endpoints interior
STABLE_CROSS = (22, 23)    # cross edge, both endpoints keep >= 2 cross arcs
PROMOTE_PAIR = (0, 4)      # interior vertices of different districts
BORDER_PAIR = (2, 13)      # border vertices of different districts
STATE_FIELDS = ("intra", "overlay", "closure", "unpruned", "table",
                "prune_order", "weights")


def _grid(core, dims=(10, 10), m=5, seed=11):
    g = core.grid_road_network(*dims, seed=seed)
    return g, core.bfs_grow_partition(g, m, seed=0)


@pytest.fixture(scope="module")
def grids():
    return _grid(rcore), _grid(tcore)


def _assert_same_structural(got, want):
    for f in ("added", "removed", "num_reweighted", "dirty_districts",
              "cross_dirty", "border_changed", "num_edges_old",
              "num_edges_new", "num_districts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.summary() == want.summary()


def _assert_same_graph(got, want):
    for f in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def _demoting_edge(g, part):
    a = part.assignment
    eu, ev, _ = g.edge_list()
    cross = a[eu] != a[ev]
    cc = np.zeros(g.num_vertices, dtype=np.int64)
    np.add.at(cc, eu[cross], 1)
    np.add.at(cc, ev[cross], 1)
    k = int(np.nonzero(cross & ((cc[eu] == 1) | (cc[ev] == 1)))[0][0])
    return int(eu[k]), int(ev[k])


# ---------------------------------------------------------------------------
# classification and graph editors
# ---------------------------------------------------------------------------

def _edits(pkg_topo, g, part):
    """Graphs for every classification case, built by one package."""
    u, v = _demoting_edge(g, part)
    return {"intra_close": pkg_topo.close_edges(g, [INTRA_EDGE[0]],
                                                [INTRA_EDGE[1]]),
            "cross_close": pkg_topo.close_edges(g, [STABLE_CROSS[0]],
                                                [STABLE_CROSS[1]]),
            "promote": pkg_topo.open_edges(g, [PROMOTE_PAIR[0]],
                                           [PROMOTE_PAIR[1]], [2.5]),
            "demote": pkg_topo.close_edges(g, [u], [v]),
            "border_pair": pkg_topo.open_edges(g, [BORDER_PAIR[0]],
                                               [BORDER_PAIR[1]], [2.5])}


def test_classify_structural_and_editors_equal_jax(grids):
    (rg, rpart), (tg, tpart) = grids
    tedits, redits = _edits(ttopo, tg, tpart), _edits(rtopo, rg, rpart)
    for case, tnew in tedits.items():
        _assert_same_graph(tnew, redits[case])
        _assert_same_structural(
            ttopo.classify_structural(tg, tpart, tnew),
            rtopo.classify_structural(rg, rpart, redits[case]))
    flags = {c: ttopo.classify_structural(tg, tpart, x).border_changed
             for c, x in tedits.items()}
    assert flags == {"intra_close": False, "cross_close": False,
                     "promote": True, "demote": True, "border_pair": False}


@pytest.mark.parametrize("call,args,match", [
    ("close_edges", ([0], [55]), "no such edge"),
    ("close_edges", ([0, 1], [1, 0]), "more than once"),
    ("open_edges", ([0], [1], [1.0]), "already exists"),
    ("open_edges", ([0], [55], [0.0]), "finite positive"),
    ("close_edges", ([3], [3]), "self-loop"),
    ("open_edges", ([0], [100], [1.0]), "out of range")])
def test_editor_errors_equal_jax(grids, call, args, match):
    (rg, _), (tg, _) = grids
    messages = []
    for pkg, g in ((ttopo, tg), (rtopo, rg)):
        with pytest.raises(ValueError, match=match) as err:
            getattr(pkg, call)(g, *args)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_classify_rejects_vertex_growth(grids):
    (_, _), (tg, tpart) = grids
    with pytest.raises(ValueError, match="vertex set fixed"):
        ttopo.classify_structural(tg, tpart,
                                  tcore.grid_road_network(11, 10, seed=11))


def test_close_then_reopen_roundtrips(grids):
    (_, _), (tg, tpart) = grids
    eu, ev, ew = tg.edge_list()
    sel = [3, 40, 77]
    g2 = ttopo.close_edges(tg, eu[sel], ev[sel])
    assert g2.num_edges == tg.num_edges - len(sel)
    g3 = ttopo.open_edges(g2, eu[sel], ev[sel], ew[sel])
    assert ttopo.classify_structural(tg, tpart, g3).is_empty


@pytest.mark.parametrize("kw", [dict(seed=17),
                                dict(seed=2, intensity=0.05, intra_bias=1.0),
                                dict(seed=3, intensity=0.05, intra_bias=0.6,
                                     sites=2, reopen_frac=0.3)])
def test_closure_storm_equals_jax(grids, kw):
    (rg, rpart), (tg, tpart) = grids
    kw = {"num_epochs": 4, "intensity": 0.03, **kw}
    pairs = zip(tingest.closure_storm(tg, tpart, **kw),
                ringest.closure_storm(rg, rpart, **kw))
    bm0 = border_mask(tg, tpart)
    for (tnew, tinfo), (rnew, rinfo) in pairs:
        _assert_same_graph(tnew, rnew)
        assert tinfo.keys() == rinfo.keys()
        for k in tinfo:
            np.testing.assert_array_equal(np.asarray(tinfo[k]),
                                          np.asarray(rinfo[k]), err_msg=k)
        assert np.diff(tnew.indptr).min() >= 1          # degree guard
        if kw.get("intra_bias") == 1.0:
            np.testing.assert_array_equal(border_mask(tnew, tpart), bm0)


def test_closure_storm_validation(grids):
    (_, _), (tg, tpart) = grids
    for kw in ({"intra_bias": 1.5}, {"reopen_frac": -0.1},
               {"sites": 0}, {"sites": tpart.num_districts + 1}):
        with pytest.raises(ValueError):
            next(iter(tingest.closure_storm(tg, tpart, **kw)))


# ---------------------------------------------------------------------------
# IncrementalBuilder.apply_structural against the JAX package's
# ---------------------------------------------------------------------------

def _assert_same_repair(tb, rb, trep, rrep):
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
    np.testing.assert_array_equal(tb.state.table_device.numpy(),
                                  tb.state.table)


def _storm_parity(rg, rpart, tg, tpart, **storm):
    """Closure-storm epochs through both packages' ``apply_structural``,
    held equal each epoch and against a full build. Returns per-epoch
    ``(incremental, border_changed)``."""
    rb = rupdate.IncrementalBuilder()
    tb = IncrementalBuilder(device="cpu")
    rb.build_full(rg, rpart)
    tb.build_full(tg, tpart)
    flags = []
    tprev, rprev = tg, rg
    for (tnew, _), (rnew, _) in zip(
            tingest.closure_storm(tg, tpart, **storm),
            ringest.closure_storm(rg, rpart, **storm)):
        tdelta = ttopo.classify_structural(tprev, tpart, tnew)
        rdelta = rtopo.classify_structural(rprev, rpart, rnew)
        tl, trep = tb.apply_structural(tnew, tpart, tdelta)
        rl, rrep = rb.apply_structural(rnew, rpart, rdelta)
        _assert_same_repair(tb, rb, trep, rrep)
        full = IncrementalBuilder(device="cpu").build_full(tnew, tpart)
        np.testing.assert_array_equal(tl.table, full.table)
        flags.append((trep["incremental"], tdelta.border_changed))
        tprev, rprev = tnew, rnew
    return flags


@pytest.mark.parametrize("storm", [
    dict(intra_bias=1.0, seed=17, num_epochs=4, intensity=0.03),
    dict(intra_bias=0.6, seed=3, num_epochs=4, intensity=0.05)],
    ids=["scoped", "border_churn"])
def test_apply_structural_storm_equals_jax(grids, storm):
    (rg, rpart), (tg, tpart) = grids
    flags = _storm_parity(rg, rpart, tg, tpart, **storm)
    if storm["intra_bias"] == 1.0:
        # side-street storms never move the border sets; the scoped
        # repair engages
        assert not any(bc for _, bc in flags)
        assert any(inc for inc, _ in flags)
    else:
        assert any(bc for _, bc in flags), "no border churn"


@pytest.mark.parametrize("pairs,promotes", [
    ([PROMOTE_PAIR, BORDER_PAIR], True), ([BORDER_PAIR], False)],
    ids=["promoting", "between_borders"])
def test_apply_structural_openings_and_reweights_equal_jax(grids, pairs,
                                                           promotes):
    """New edges plus a weight move on a survivor, in one delta: an
    opening that promotes two interior vertices takes the full rung, one
    between existing borders the scoped path."""
    (rg, rpart), (tg, tpart) = grids
    rb = rupdate.IncrementalBuilder()
    tb = IncrementalBuilder(device="cpu")
    rb.build_full(rg, rpart)
    tb.build_full(tg, tpart)
    news = []
    for topo, upd, g in ((ttopo, tupdate, tg), (rtopo, rupdate, rg)):
        g2 = topo.open_edges(g, [u for u, _ in pairs], [v for _, v in pairs],
                             [2.5 + i for i in range(len(pairs))])
        news.append(g2.with_weights(upd.weights_from_arc_updates(
            g2, [INTRA_EDGE[0]], [INTRA_EDGE[1]], [7.0])))
    tl, trep = tb.apply_structural(news[0], tpart)
    rl, rrep = rb.apply_structural(news[1], rpart)
    assert trep["border_changed"] is promotes
    assert trep["incremental"] is not promotes
    _assert_same_repair(tb, rb, trep, rrep)
    full = IncrementalBuilder(device="cpu").build_full(news[0], tpart)
    np.testing.assert_array_equal(tl.table, full.table)


def test_apply_structural_same_topology_fresh_identity(grids):
    (_, _), (tg, tpart) = grids
    tb = IncrementalBuilder(device="cpu")
    ref = tb.build_full(tg, tpart)
    eu, ev, ew = tg.edge_list()
    g_same = tcore.from_edges(tg.num_vertices, eu, ev, ew)
    assert g_same.indptr is not tg.indptr
    labels, rep = tb.apply_structural(g_same, tpart)
    assert rep["incremental"] and not rep["changed_rows"].any()
    assert not rep["border_changed"]
    np.testing.assert_array_equal(labels.table, ref.table)
    # a weight delta under the new identity goes the weight path
    w2 = tupdate.weights_from_arc_updates(g_same, [INTRA_EDGE[0]],
                                          [INTRA_EDGE[1]], [7.0])
    labels, rep = tb.apply_structural(g_same.with_weights(w2), tpart)
    assert rep["incremental"] and rep["border_changed"] is False
    full = IncrementalBuilder(device="cpu").build_full(
        g_same.with_weights(w2), tpart)
    np.testing.assert_array_equal(labels.table, full.table)


# ---------------------------------------------------------------------------
# EdgeSystem.apply_topology_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("incremental", [True, False])
def test_system_exact_through_closure_storm(incremental):
    rg, rpart = _grid(rcore, (8, 8), 4, seed=7)
    tg, tpart = _grid(tcore, (8, 8), 4, seed=7)
    rsys = redge.EdgeSystem.deploy(rg, rpart, builder="jax")
    tsys = tedge.EdgeSystem.deploy(tg, tpart, builder="torch", device="cpu")
    rng = np.random.default_rng(0)
    storm = dict(num_epochs=2, intensity=0.03, intra_bias=0.8, seed=5)
    for (tnew, _), (rnew, _) in zip(
            tingest.closure_storm(tg, tpart, **storm),
            ringest.closure_storm(rg, rpart, **storm)):
        trep = tsys.apply_topology_update(tnew, incremental=incremental)
        rrep = rsys.apply_topology_update(rnew, incremental=incremental)
        for k in ("incremental", "border_changed", "dirty_districts",
                  "stale_shortcut_districts", "clean_districts"):
            assert trep.get(k) == rrep.get(k), k
        np.testing.assert_array_equal(tsys.center.border_labels.table,
                                      rsys.center.border_labels.table)
        ss = rng.integers(0, tg.num_vertices, 40)
        ts = rng.integers(0, tg.num_vertices, 40)
        got = tsys.service().submit(ss, ts).distances
        np.testing.assert_array_equal(
            got, rsys.service().submit(ss, ts).distances)
        exact = np.array([tcore.dijkstra(tnew, int(s))[int(t)]
                          for s, t in zip(ss, ts)], dtype=np.float32)
        np.testing.assert_allclose(got, exact, rtol=1e-5)


def test_system_topology_noop_keeps_serving(grids):
    (_, _), (tg, tpart) = grids
    tsys = tedge.EdgeSystem.deploy(tg, tpart, builder="torch", device="cpu")
    eu, ev, ew = tg.edge_list()
    rep = tsys.apply_topology_update(
        tcore.from_edges(tg.num_vertices, eu, ev, ew))
    assert rep["clean_districts"] == list(range(tpart.num_districts))
    assert not rep["border_changed"] and tsys.center.version == 1
    assert tsys.current_engine() is not None
