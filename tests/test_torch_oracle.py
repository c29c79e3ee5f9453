"""The port's oracle API against the JAX package's, bit for bit.

``DistanceOracle.build`` under both builders on the inputs of the JAX
package's own oracle tests (an 8×8 grid, seed 11, 4 districts; a 6×6
grid, seed 13, 3 districts for ``rebuild``): B, every local index's
arrays and the ``query_many`` answers equal the reference's, and
``BuildStats`` has the same fields and ``as_row()`` keys (times are not
compared). ``build_all_local_indexes``, ``cross_district_query``,
``same_district_query`` and ``query_batch`` are held against theirs the
same way. Everything runs on ``device="cpu"``, where the port's joins
run their plain PyTorch versions; the reference's ``query_batch`` runs
its host path and its kernel path (Pallas in interpret mode).
"""
import dataclasses

import numpy as np
import pytest

import repro.core as rcore
import repro_torch.core as tcore

BUILDERS = ["reference", "hierarchical"]


def _grid(pkg, rows, seed, districts):
    g = pkg.grid_road_network(rows, rows, seed=seed)
    return g, pkg.bfs_grow_partition(g, districts, seed=0)


def _queries(g, seed, size=200):
    """Random pairs plus same-district pairs and s == t lanes."""
    rng = np.random.default_rng(seed)
    ss = rng.integers(0, g.num_vertices, size=size)
    ts = rng.integers(0, g.num_vertices, size=size)
    ts[::3] = np.clip(ss[::3] + 1, 0, g.num_vertices - 1)
    ss[::11] = ts[::11]
    return ss, ts


def _assert_local_indexes_equal(got, want):
    assert len(got) == len(want)
    for t, r in zip(got, want):
        assert t.district_id == r.district_id
        assert t.augmented == r.augmented
        for name in ("vertices", "border_locals", "border_dist"):
            np.testing.assert_array_equal(getattr(t, name), getattr(r, name),
                                          err_msg=name)
        np.testing.assert_array_equal(t.labels.hubs, r.labels.hubs)
        np.testing.assert_array_equal(t.labels.dists, r.labels.dists)
        assert t.size_bytes() == r.size_bytes()


@pytest.fixture(scope="module", params=BUILDERS)
def oracles(request):
    rg, rpart = _grid(rcore, 8, 11, 4)
    tg, tpart = _grid(tcore, 8, 11, 4)
    return (request.param,
            rcore.DistanceOracle.build(rg, rpart, builder=request.param),
            tcore.DistanceOracle.build(tg, tpart, builder=request.param,
                                       device="cpu"))


def test_oracle_builds_the_reference_index(oracles):
    _, r, t = oracles
    np.testing.assert_array_equal(t.partition.assignment,
                                  r.partition.assignment)
    np.testing.assert_array_equal(t.border_labels.table,
                                  r.border_labels.table)
    np.testing.assert_array_equal(t.border_labels.border_ids,
                                  r.border_labels.border_ids)
    _assert_local_indexes_equal(t.local_indexes, r.local_indexes)
    assert all(li.augmented for li in t.local_indexes)


def test_oracle_query_many_and_query_match(oracles):
    _, r, t = oracles
    ss, ts = _queries(r.graph, 8)
    want = r.query_many(ss, ts)
    got = t.query_many(ss, ts)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for s, tt in zip(ss[:10], ts[:10]):
        assert t.query(int(s), int(tt)) == r.query(int(s), int(tt))
    # B's device copy is uploaded once and kept
    assert t.border_table_device() is t.border_table_device()
    assert t.border_table_device().device.type == "cpu"


def test_build_stats_fields_and_row_keys(oracles):
    _, r, t = oracles
    names = [f.name for f in dataclasses.fields(tcore.BuildStats)]
    assert names == [f.name for f in dataclasses.fields(rcore.BuildStats)]
    assert t.stats.as_row().keys() == r.stats.as_row().keys()
    # sizes and counts are the index's; the two times are not compared
    for name in ("bl_bytes", "local_bytes", "num_borders"):
        assert getattr(t.stats, name) == getattr(r.stats, name)
    assert t.stats.bl_seconds > 0 and t.stats.districts_seconds > 0
    assert t.stats.num_borders > 0


def test_oracle_rebuild_matches_reference():
    rg, rpart = _grid(rcore, 6, 13, 3)
    tg, tpart = _grid(tcore, 6, 13, 3)
    r = rcore.DistanceOracle.build(rg, rpart)
    t = tcore.DistanceOracle.build(tg, tpart, device="cpu")
    w2 = rg.weights * 3.0
    r2, t2 = r.rebuild(w2), t.rebuild(w2)
    assert t2.device == t.device
    np.testing.assert_array_equal(t2.graph.weights, r2.graph.weights)
    np.testing.assert_array_equal(t2.border_labels.table,
                                  r2.border_labels.table)
    _assert_local_indexes_equal(t2.local_indexes, r2.local_indexes)
    ss, ts = _queries(rg, 9, size=60)
    np.testing.assert_array_equal(t2.query_many(ss, ts),
                                  r2.query_many(ss, ts))
    assert not np.array_equal(t2.query_many(ss, ts), t.query_many(ss, ts))


def test_oracle_takes_only_the_reference_builders():
    tg, tpart = _grid(tcore, 4, 0, 2)
    for builder in ("torch", "jax"):
        with pytest.raises(ValueError, match="unknown builder"):
            tcore.DistanceOracle.build(tg, tpart, builder=builder,
                                       device="cpu")


@pytest.mark.parametrize("with_bl", [False, True])
def test_build_all_local_indexes_matches(with_bl):
    rg, rpart = _grid(rcore, 8, 11, 4)
    tg, tpart = _grid(tcore, 8, 11, 4)
    rbl = rcore.build_border_labels_reference(rg, rpart) if with_bl else None
    tbl = tcore.build_border_labels_reference(tg, tpart) if with_bl else None
    got = tcore.build_all_local_indexes(tg, tpart, bl=tbl, device="cpu")
    want = rcore.build_all_local_indexes(rg, rpart, bl=rbl)
    _assert_local_indexes_equal(got, want)
    assert all(li.device.type == "cpu" for li in got)


def test_cross_and_same_district_query_match(oracles):
    _, r, t = oracles
    ss, ts = _queries(r.graph, 12, size=80)
    a = r.partition.assignment
    for s, tt in zip(ss, ts):
        s, tt = int(s), int(tt)
        assert tcore.cross_district_query(t.border_labels, s, tt) == \
            rcore.cross_district_query(r.border_labels, s, tt)
        if a[s] == a[tt]:
            d = int(a[s])
            assert tcore.same_district_query(t.local_indexes[d], s, tt) == \
                rcore.same_district_query(r.local_indexes[d], s, tt)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_query_batch_matches(oracles, use_kernels):
    _, r, t = oracles
    ss, ts = _queries(r.graph, 13, size=300)
    want = rcore.query_batch(r.border_labels, r.local_indexes,
                             r.partition.assignment, ss, ts,
                             use_kernels=use_kernels)
    got = tcore.query_batch(t.border_labels, t.local_indexes,
                            t.partition.assignment, ss, ts)
    np.testing.assert_array_equal(got, want)
    # B already on the device gives the same answers
    np.testing.assert_array_equal(
        tcore.query_batch(t.border_labels, t.local_indexes,
                          t.partition.assignment, ss, ts,
                          btable=t.border_table_device()), want)
    empty = np.array([], dtype=np.int64)
    out = tcore.query_batch(t.border_labels, t.local_indexes,
                            t.partition.assignment, empty, empty)
    assert out.shape == (0,) and out.dtype == np.float32


def test_oracle_answers_dijkstra(oracles):
    _, r, t = oracles
    ss, ts = _queries(r.graph, 14, size=40)
    got = t.query_many(ss, ts)
    for s, tt, d in zip(ss, ts, got):
        ref = float(tcore.dijkstra(t.graph, int(s))[int(tt)])
        assert d == pytest.approx(ref, rel=1e-5), (s, tt)
