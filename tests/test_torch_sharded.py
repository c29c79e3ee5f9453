"""The port's sharded serving layouts against the JAX package's.

A 10×10 grid in 8 districts (the JAX package's mesh case) is deployed
by both packages, and B and every district's tables are held equal
before any answer is compared. Then, bit for bit and on ``device="cpu"``
(where the sharded kernel runs its plain version):

* the sharded ops (``sharded_query`` over ``pack_for_mesh``) and
  ``ShardedBatchedEngine`` — B replicated and row-sharded, float32,
  the fitted uint16 spec and uint16 codes ≥ 0x8000 (the MIN seam must
  compare them unsigned), a placement, an empty batch, one district with no
  borders — against the reference's on its one in-process device, and
  the port's 8-shard mesh against the same answers;
* the per-shard bytes against the reference's packing formulas;
* the router's auto-pick, its ``shard_border`` override and
  ``ServingPolicy(engine="sharded")``;
* ``EdgePlacement`` / ``RebalancePlanner`` plans move for move against
  ``repro.topo.rebalance``, and ``EdgeSystem.migrate`` keeping the
  answers while it swaps the engine.

One subprocess runs the reference on 8 virtual host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as the JAX
package's own mesh tests do) against the port's 8-shard mesh.
"""
import gc
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest

import repro.core as rcore
import repro.edge as redge
import repro.edge.router as rrouter
import repro.serve as rserve
import repro.topo as rtopo
import repro_torch.core as tcore
import repro_torch.edge as tedge
import repro_torch.edge.router as trouter
import repro_torch.serve as tserve
import repro_torch.topo as ttopo

# layouts: (shard_border, storage) with storage float32, the fitted
# uint16 spec, or uint16 codes spanning 0..65000 (half of them ≥ 0x8000)
LAYOUTS = [(sb, st) for sb in (False, True)
           for st in ("float32", "uint16", "uint16_high")]


def _ids(layout):
    sb, st = layout
    return f"{'row' if sb else 'rep'}-{st}"


def _grid(pkg, rows=10, seed=5, districts=8, part_seed=1):
    g = pkg.grid_road_network(rows, rows, seed=seed)
    return g, pkg.bfs_grow_partition(g, districts, seed=part_seed)


def _deploy_both(**kw):
    rg, rpart = _grid(rcore, **kw)
    tg, tpart = _grid(tcore, **kw)
    rsys = redge.EdgeSystem.deploy(rg, rpart)
    tsys = tedge.EdgeSystem.deploy(tg, tpart, device="cpu")
    _assert_index_equal(rsys, tsys)
    return rg, rpart, rsys, tsys


def _assert_index_equal(rsys, tsys):
    np.testing.assert_array_equal(tsys.center.border_labels.table,
                                  rsys.center.border_labels.table)
    for r, t in zip(rsys.servers, tsys.servers):
        np.testing.assert_array_equal(t.augmented.dense_table(),
                                      r.augmented.dense_table())
        np.testing.assert_array_equal(t.augmented.vertices,
                                      r.augmented.vertices)


def _batch(g, system, seed, size=600):
    """Mixed rule-1/2/3 batch with s == t lanes and border endpoints."""
    rng = np.random.default_rng(seed)
    ss = rng.integers(0, g.num_vertices, size=size)
    ts = rng.integers(0, g.num_vertices, size=size)
    part = system.partition
    members = part.districts()
    for i in range(0, size, 3):
        d = members[int(part.assignment[ss[i]])]
        ts[i] = d[rng.integers(len(d))]
    borders = system.center.border_labels.border_ids.astype(np.int64)
    k = min(len(borders), len(ss[1::23]))
    ss[1::23][:k] = borders[:k]
    ss[::17] = ts[::17]
    return ss.astype(np.int64), ts.astype(np.int64)


def _spec(pkg, system, storage):
    """The storage spec of a layout for ``pkg`` (None for float32)."""
    btable = system.center.border_labels.table
    locals_ = [srv.augmented for srv in system.servers]
    if storage == "float32":
        return None
    if storage == "uint16":
        return pkg.fit_label_spec(btable, locals_, dtype=np.uint16)
    vmax = max(float(btable[np.isfinite(btable)].max()),
               *(float(li.dense_table()[np.isfinite(li.dense_table())].max())
                 for li in locals_))
    return pkg.QuantSpec(vmax / 65000.0, np.uint16, lossless=False)


def _args(system):
    return (system.center.border_labels.table,
            [srv.augmented for srv in system.servers],
            system.partition.assignment)


def _port_engine(tsys, num_shards, layout, placement=None):
    sb, st = layout
    return tedge.ShardedBatchedEngine(
        *_args(tsys), mesh=tedge.default_edge_mesh(num_shards, device="cpu"),
        shard_border=sb, quant=_spec(tcore, tsys, st), placement=placement)


def _ref_engine(rsys, layout, placement=None):
    sb, st = layout
    return redge.ShardedBatchedEngine(*_args(rsys), shard_border=sb,
                                      quant=_spec(rcore, rsys, st),
                                      placement=placement)


@pytest.fixture(scope="module")
def deployed():
    return _deploy_both()


def test_high_codes_reach_the_upper_half(deployed):
    _, _, rsys, tsys = deployed
    spec = _spec(tcore, tsys, "uint16_high")
    codes = spec.quantize(tsys.center.border_labels.table)
    finite = codes[codes != spec.sentinel]
    assert finite.max() >= 0x8000 and finite.min() < 0x8000
    assert spec.key() == _spec(rcore, rsys, "uint16_high").key()


# -- the engines and the ops, in process -------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_sharded_engine_matches_reference(deployed, layout):
    rg, _, rsys, tsys = deployed
    ss, ts = _batch(rg, rsys, 3)
    want = _ref_engine(rsys, layout).query(ss, ts)
    replicated = tedge.BatchedQueryEngine(
        *_args(tsys), quant=_spec(tcore, tsys, layout[1]), device="cpu")
    np.testing.assert_array_equal(replicated.query(ss, ts), want)
    for num_shards in (1, 3, 8):
        eng = _port_engine(tsys, num_shards, layout)
        assert eng.num_devices == num_shards
        assert eng.data.district_table is None      # host copy released
        got = eng.query(ss, ts)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(eng.execute(ss, ts), want)
    if layout[1] == "float32":
        np.testing.assert_array_equal(want, rsys.query_loop(ss, ts))


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_sharded_query_ops_match_reference(deployed, layout):
    rg, rpart, rsys, tsys = deployed
    sb, st = layout
    ss, ts = _batch(rg, rsys, 4, size=200)
    rdata = redge.pack_for_mesh(rpart, rsys.center.border_labels,
                                _args(rsys)[1], 1, shard_border=sb,
                                quant=_spec(rcore, rsys, st))
    want = redge.sharded_query(rdata, redge.default_edge_mesh(1),
                               redge.prepare_queries(rdata, ss, ts))
    for num_shards in (1, 8):
        tdata = tedge.pack_for_mesh(tsys.partition, tsys.center.border_labels,
                                    _args(tsys)[1], num_shards,
                                    shard_border=sb,
                                    quant=_spec(tcore, tsys, st))
        mesh = tedge.default_edge_mesh(num_shards, device="cpu")
        got = tedge.sharded_query(tdata, mesh,
                                  tedge.prepare_queries(tdata, ss, ts))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_sharded_ops_match_reference_ops_on_eight_shards(deployed, layout,
                                                         use_pallas):
    """The reference's own ``join_sharded_gathered`` /
    ``join_sharded_border_gathered`` on 8 shards in process — mapped over
    the shards with ``jax.vmap(axis_name="edge")``, which gives them
    their axis index and ``pmin`` — with its XLA join and its Pallas
    join (interpret mode), against the port's ops on an 8-shard mesh."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.label_join import ops as rlj
    from repro_torch.edge.sharded_oracle import place_tables, upload_queries
    from repro_torch.kernels.label_join import ops as tlj
    rg, rpart, rsys, tsys = deployed
    sb, st = layout
    ss, ts = _batch(rg, rsys, 5, size=150)
    rspec, tspec = _spec(rcore, rsys, st), _spec(tcore, tsys, st)
    rdata = redge.pack_for_mesh(rpart, rsys.center.border_labels,
                                _args(rsys)[1], 8, shard_border=sb,
                                quant=rspec)
    q = redge.prepare_queries(rdata, ss, ts)
    blocks = jnp.asarray(rdata.district_table.reshape(8, -1, rdata.width))
    btable = jnp.asarray(rdata.btable.reshape(8, -1, rdata.border_width)
                         if sb else rdata.btable)
    rop = rlj.join_sharded_border_gathered if sb \
        else rlj.join_sharded_gathered
    owner, rs, rt = (jnp.asarray(q[k]) for k in ("owner", "rs", "rt"))
    out = jax.vmap(
        lambda b, bt: rop(b, bt, owner, rs, rt, axis="edge",
                          use_pallas=use_pallas,
                          quant=None if rspec is None else rspec.key()),
        in_axes=(0, 0 if sb else None), axis_name="edge")(blocks, btable)
    want = np.asarray(out)
    assert (want == want[0]).all()                # every shard after pmin
    tdata = tedge.pack_for_mesh(tsys.partition, tsys.center.border_labels,
                                _args(tsys)[1], 8, shard_border=sb,
                                quant=tspec)
    mesh = tedge.default_edge_mesh(8, device="cpu")
    tblocks, tbtables = place_tables(tdata, mesh)
    top = tlj.join_sharded_border_gathered if sb \
        else tlj.join_sharded_gathered
    got = top(tblocks, tbtables,
              *upload_queries(tedge.prepare_queries(tdata, ss, ts), mesh),
              mesh=mesh, quant=None if tspec is None else tspec.key())
    np.testing.assert_array_equal(got.numpy(), want[0])


@pytest.mark.parametrize("num_shards", [1, 2, 8])
@pytest.mark.parametrize("shard_border", [False, True])
def test_per_shard_bytes_match_reference(deployed, num_shards, shard_border):
    _, _, rsys, tsys = deployed
    for st in ("float32", "uint16"):
        want = redge.pack_tables(*_args(rsys), num_shards,
                                 shard_border=shard_border,
                                 quant=_spec(rcore, rsys, st))
        eng = _port_engine(tsys, num_shards, (shard_border, st))
        assert eng.district_table_bytes_per_device() == \
            want.district_bytes_per_device()
        assert eng.border_table_bytes_per_device() == \
            want.border_bytes_per_device()
        assert eng.size_bytes() == want.bytes_per_device()
        # each shard's tensors hold exactly its share
        item = 4 if st == "float32" else 2
        n, q = tsys.center.border_labels.table.shape
        rows = -(-n // num_shards) if shard_border else n
        assert eng.border_table_bytes_per_device() == rows * q * item
        for block, bt in zip(eng.blocks, eng.btables):
            assert block.numel() * block.element_size() == \
                eng.district_table_bytes_per_device()
            assert bt.numel() * bt.element_size() == \
                eng.border_table_bytes_per_device()


@pytest.mark.parametrize("layout", [(False, "float32"), (True, "uint16_high")],
                         ids=_ids)
def test_placement_matches_reference(deployed, layout):
    rg, _, rsys, tsys = deployed
    ss, ts = _batch(rg, rsys, 6)
    placement = np.array([3, 0, 0, 2, 1, 3, 0, 1])
    want_pack = redge.pack_tables(*_args(rsys), 4, shard_border=layout[0],
                                  quant=_spec(rcore, rsys, layout[1]),
                                  placement=placement)
    eng = _port_engine(tsys, 4, layout, placement=placement)
    np.testing.assert_array_equal(eng.data.device_of, want_pack.device_of)
    np.testing.assert_array_equal(eng.data.slot_of, want_pack.slot_of)
    owner, rs, rt = eng.row_ids(ss, ts)
    want_q = redge.prepare_queries(want_pack, ss, ts)
    for got_k, k in ((owner, "owner"), (rs, "rs"), (rt, "rt")):
        np.testing.assert_array_equal(got_k, want_q[k])
    np.testing.assert_array_equal(eng.query(ss, ts),
                                  _ref_engine(rsys, layout).query(ss, ts))


def test_empty_batch_all_layouts(deployed):
    _, _, _, tsys = deployed
    empty = np.array([], dtype=np.int64)
    for layout in LAYOUTS:
        for num_shards in (1, 8):
            out = _port_engine(tsys, num_shards, layout).query(empty, empty)
            assert out.shape == (0,) and out.dtype == np.float32
    data = tedge.pack_for_mesh(tsys.partition, tsys.center.border_labels,
                               _args(tsys)[1], 2)
    out = tedge.sharded_query(data, tedge.default_edge_mesh(2, device="cpu"),
                              tedge.prepare_queries(data, empty, empty))
    assert out.shape == (0,) and out.dtype == np.float32


def test_single_district_no_borders():
    """q == 0: one district, no border vertices, every query rule 1 —
    the B shard is a (n_pad, 0) table and must stay inert."""
    rg, _, rsys, tsys = _deploy_both(rows=5, seed=2, districts=1,
                                     part_seed=0)
    assert tsys.center.border_labels.num_borders == 0
    rng = np.random.default_rng(4)
    ss = rng.integers(0, rg.num_vertices, size=128)
    ts = rng.integers(0, rg.num_vertices, size=128)
    loop = rsys.query_loop(ss, ts)
    for layout in ((False, "float32"), (True, "float32"), (True, "uint16")):
        want = _ref_engine(rsys, layout).query(ss, ts)
        if layout[1] == "float32":
            np.testing.assert_array_equal(want, loop)
        for num_shards in (1, 8):
            eng = _port_engine(tsys, num_shards, layout)
            np.testing.assert_array_equal(eng.query(ss, ts), want)
            assert eng.border_table_bytes_per_device() == 0


# -- the mesh and its MIN seam ------------------------------------------------

def test_default_edge_mesh_is_cached_and_counts_shards():
    mesh = tedge.default_edge_mesh(device="cpu")
    assert mesh.size == 1 and mesh.shape == {"edge": 1}
    assert mesh is tedge.default_edge_mesh(device="cpu")
    m8 = tedge.default_edge_mesh(8, device="cpu")
    assert m8 is tedge.default_edge_mesh(8, "edge", "cpu")
    assert m8.size == 8 and all(d.type == "cpu" for d in m8.devices)
    assert tedge.default_edge_mesh(8, axis="x", device="cpu").axis == "x"
    with pytest.raises(ValueError, match="shard"):
        tedge.default_edge_mesh(0, device="cpu")


def test_min_seam_folds_one_partial_a_shard():
    import torch
    mesh = tedge.default_edge_mesh(3, device="cpu")
    parts = [torch.tensor([1.0, float("inf"), 5.0]),
             torch.tensor([float("inf"), 2.0, 4.0]),
             torch.tensor([3.0, float("inf"), float("inf")])]
    assert mesh.pmin(parts).tolist() == [1.0, 2.0, 4.0]
    with pytest.raises(ValueError, match="one partial a shard"):
        mesh.pmin(parts[:2])


# -- the router and the request plane -----------------------------------------

def test_router_auto_pick_and_shard_border_override(deployed):
    rg, _, rsys, tsys = deployed
    assert trouter.SHARD_BORDER_AUTO_BYTES == rrouter.SHARD_BORDER_AUTO_BYTES
    ss, ts = _batch(rg, rsys, 9, size=300)
    loop = rsys.query_loop(ss, ts)
    try:
        # one shard: auto picks the replicated engine, as one device does
        assert isinstance(tsys._current_engine(), tedge.BatchedQueryEngine)
        tsys.mesh = tedge.default_edge_mesh(8, device="cpu")
        np.testing.assert_array_equal(tsys.service().submit(ss, ts).distances,
                                      loop)
        eng = tsys._current_engine()
        # auto heuristic: a toy B is far below SHARD_BORDER_AUTO_BYTES,
        # so the 8-shard mesh gets the replicated-B sharded engine
        assert isinstance(eng, tedge.ShardedBatchedEngine)
        assert not eng.shard_border and eng.num_devices == 8
        tsys.shard_border = True
        np.testing.assert_array_equal(tsys.service().submit(ss, ts).distances,
                                      loop)
        eng = tsys._current_engine()
        assert isinstance(eng, tedge.ShardedBatchedEngine) and eng.shard_border
        tsys.prefer_sharded = False
        assert isinstance(tsys._current_engine(), tedge.BatchedQueryEngine)
        # ServingPolicy placement overrides beat the system attributes
        svc = tsys.service(tserve.ServingPolicy(engine="sharded",
                                                shard_border=False))
        np.testing.assert_array_equal(svc.submit(ss, ts).distances, loop)
        eng = svc.plan(ss, ts).plane
        assert isinstance(eng, tedge.ShardedBatchedEngine)
        assert not eng.shard_border
        svc = tsys.service(tserve.ServingPolicy(engine="replicated"))
        assert isinstance(svc.plan(ss, ts).plane, tedge.BatchedQueryEngine)
    finally:
        tsys.mesh = tsys.prefer_sharded = tsys.shard_border = None


@pytest.mark.parametrize("switch", ["shards", "shard_border", "dtype"])
def test_one_sharded_engine_stays_resident(deployed, switch):
    """Building a sharded engine drops the earlier sharded one, as the
    reference keeps a single snapshot; the replicated engine stays."""
    rg, _, rsys, tsys = deployed
    ss, ts = _batch(rg, rsys, 12, size=200)
    loop = rsys.query_loop(ss, ts)
    try:
        rep = tsys._current_engine(prefer_sharded=False)
        tsys.mesh = tedge.default_edge_mesh(4, device="cpu")
        first = tsys._current_engine(prefer_sharded=True, shard_border=False,
                                     label_dtype="float32")
        stale = weakref.ref(first)
        if switch == "shards":
            tsys.mesh = tedge.default_edge_mesh(8, device="cpu")
        second = tsys._current_engine(
            prefer_sharded=True, shard_border=switch == "shard_border",
            label_dtype="uint16" if switch == "dtype" else "float32")
        assert isinstance(second, tedge.ShardedBatchedEngine)
        sharded_keys = [k for k in tsys._engines if isinstance(k, tuple)]
        assert len(sharded_keys) == 1
        assert tsys._engines[sharded_keys[0]] is second
        assert all(e is not first for e in tsys._engines.values())
        del first
        gc.collect()
        assert stale() is None
        assert tsys._current_engine(prefer_sharded=False) is rep
        np.testing.assert_array_equal(
            tsys.service(tserve.ServingPolicy(engine="sharded")).submit(
                ss, ts).distances, loop)
    finally:
        tsys.mesh = None


@pytest.mark.parametrize("shard_border", [None, False, True])
@pytest.mark.parametrize("label_dtype", ["float32", "uint16"])
def test_sharded_policy_serves_like_the_reference(deployed, shard_border,
                                                  label_dtype):
    rg, rpart, rsys, tsys = deployed
    ss, ts = _batch(rg, rsys, 10, size=300)
    client = rpart.assignment[ss].astype(np.int32)
    client[::5] = (client[::5] + 1) % rpart.num_districts
    want = rsys.service(rserve.ServingPolicy(
        engine="sharded", shard_border=shard_border,
        label_dtype=label_dtype)).submit(ss, ts, client_districts=client)
    for num_shards in (1, 8):
        tsys.mesh = tedge.default_edge_mesh(num_shards, device="cpu")
        try:
            svc = tsys.service(tserve.ServingPolicy(
                engine="sharded", shard_border=shard_border,
                label_dtype=label_dtype))
            got = svc.submit(ss, ts, client_districts=client)
            plane = svc.plan(ss, ts).plane
            assert isinstance(plane, tedge.ShardedBatchedEngine)
            assert plane.num_devices == num_shards
            assert plane.shard_border == bool(shard_border)
        finally:
            tsys.mesh = None
        np.testing.assert_array_equal(got.distances, want.distances)
        np.testing.assert_array_equal(got.rules, want.rules)
        assert got.counters() == want.counters()
        assert svc.stats == want.counters()


def test_scatter_gather_still_raises_naming_item_8():
    # item 8 is ported (tests/test_torch_scatter_gather.py): the
    # placement builds, and what it still refuses is named
    assert tserve.ServingPolicy(engine="scatter_gather").faults is None
    with pytest.raises(ValueError, match="migration"):
        tserve.ServingPolicy(engine="scatter_gather", migration="swap")
    assert tserve.ServingPolicy(engine="sharded").shard_border is None


# -- placements, the planner and migration ------------------------------------

def _plan_rows(plan):
    return ([(m.district, m.src_host, m.dst_host, m.load, m.bytes)
             for m in plan.moves], plan.placement.host_of.tolist(),
            plan.placement.version, plan.host_load_before.tolist(),
            plan.host_load_after.tolist(), plan.host_bytes_after.tolist(),
            plan.summary())


def test_edge_placement_matches_reference():
    for pkg in (rtopo, ttopo):
        assert pkg.EdgePlacement.blocked(8, 4).host_of.tolist() == \
            [0, 0, 1, 1, 2, 2, 3, 3]
    r, t = rtopo.EdgePlacement.blocked(8, 4), ttopo.EdgePlacement.blocked(8, 4)
    np.testing.assert_array_equal(t.districts_of(1), r.districts_of(1))
    r2, t2 = r.move(2, 3), t.move(2, 3)
    np.testing.assert_array_equal(t2.host_of, r2.host_of)
    assert t2.key() == r2.key() and t.key() == r.key()
    np.testing.assert_array_equal(t.host_totals(np.arange(8.0)),
                                  r.host_totals(np.arange(8.0)))
    with pytest.raises(ValueError, match="host_of entries"):
        ttopo.EdgePlacement(np.array([0, 4], dtype=np.int32), num_hosts=4)


# (max_moves, byte_budget, bytes, loads observed in turn): the inputs of
# the JAX package's planner tests, and a hot host with several movers
PLANNER_CASES = {
    "balanced_then_skewed": (2, None, None,
                             [np.ones(8), [40.0, 30, 0, 0, 0, 0, 0, 0]]),
    "byte_budget": (2, 250, [100, 100, 100, 100], [[50.0, 40.0, 1.0, 1.0]]),
    "tight_budget": (2, 150, [100, 100, 100, 100], [[50.0, 40.0, 1.0, 1.0]]),
    "zero_load": (4, None, None, [[10.0, 0.0, 0.0, 0.0]]),
    "hot_host": (3, None, None, [[9.0, 7, 5, 1, 1, 1, 1, 1, 2, 2, 1, 1]]),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_rebalance_planner_plans_move_for_move(case):
    max_moves, budget, bts, loads = PLANNER_CASES[case]
    m = len(loads[-1])
    hosts = 4 if m >= 8 else 2
    planners = [pkg.RebalancePlanner(pkg.EdgePlacement.blocked(m, hosts),
                                     max_moves=max_moves, byte_budget=budget)
                for pkg in (rtopo, ttopo)]
    for planner in planners:
        if bts is not None:
            planner.observe_bytes(np.array(bts, dtype=np.int64))
    for load in loads:
        r, t = (p_.observe_load(np.asarray(load, dtype=np.float64))
                for p_ in planners)
        rplan, tplan = planners[0].plan(), planners[1].plan()
        assert (rplan is None) == (tplan is None)
        assert planners[1].imbalance() == planners[0].imbalance()
        if rplan is not None:
            assert _plan_rows(tplan) == _plan_rows(rplan)
            for p_, plan in zip(planners, (rplan, tplan)):
                p_.commit(plan)
            again = (planners[0].plan(), planners[1].plan())
            assert (again[0] is None) == (again[1] is None)
            if again[0] is not None:
                assert _plan_rows(again[1]) == _plan_rows(again[0])


def test_migrate_keeps_answers_and_swaps_the_engine():
    rg, rpart, rsys, tsys = _deploy_both(seed=11, districts=5, part_seed=0)
    m = rpart.num_districts
    ss, ts = _batch(rg, rsys, 3, size=200)
    before = rsys.query_loop(ss, ts)
    np.testing.assert_array_equal(
        ttopo.district_bytes_of(tsys), rtopo.district_bytes_of(rsys))
    tsys.mesh = tedge.default_edge_mesh(2, device="cpu")
    svc = tsys.service(tserve.ServingPolicy(engine="sharded"))
    np.testing.assert_array_equal(svc.submit(ss, ts).distances, before)
    old = svc.plan(ss, ts).plane
    planners = [pkg.RebalancePlanner.for_system(system, num_hosts=2,
                                                max_moves=1)
                for pkg, system in ((rtopo, rsys), (ttopo, tsys))]
    np.testing.assert_array_equal(planners[1].district_bytes,
                                  planners[0].district_bytes)
    hot = np.isin(rpart.assignment[ss],
                  planners[0].placement.districts_of(0))
    svc.submit(ss[hot], ts[hot])
    load = svc.district_load
    np.testing.assert_array_equal(load, np.bincount(
        rpart.assignment[np.concatenate([ss, ss[hot]])], minlength=m))
    for planner in planners:
        planner.observe_load(load)
    rplan, tplan = planners[0].plan(), planners[1].plan()
    assert tplan is not None and _plan_rows(tplan) == _plan_rows(rplan)
    assert tsys.migrate(tplan) == rsys.migrate(rplan)
    assert tsys.placement is tplan.placement
    new = svc.plan(ss, ts).plane
    assert new is not old                           # the key moved
    np.testing.assert_array_equal(new.data.device_of,
                                  tplan.placement.host_of)
    np.testing.assert_array_equal(svc.submit(ss, ts).distances, before)
    np.testing.assert_array_equal(old.query(ss, ts), before)  # in flight
    np.testing.assert_array_equal(tsys.query_loop(ss, ts), before)
    # a placement of another host count keeps the blocked layout
    other = ttopo.EdgePlacement.blocked(m, 3)
    rep = tsys.migrate(other)
    assert rep["moved_districts"] == [] and rep["num_hosts"] == 3
    blocked = svc.plan(ss, ts).plane
    assert blocked is not new
    np.testing.assert_array_equal(blocked.data.device_of,
                                  np.arange(m) // -(-m // 2))
    np.testing.assert_array_equal(svc.submit(ss, ts).distances, before)
    with pytest.raises(ValueError, match="placement covers"):
        tsys.migrate(ttopo.EdgePlacement.blocked(m + 1, 2))


# -- eight devices: the reference's real pmin ---------------------------------

def _eight_device_case() -> None:
    """The reference on 8 (virtual) devices against the port's 8-shard
    mesh: every layout, a placement, an empty batch, the ops, the bytes
    and the router's auto-pick, bit for bit."""
    import jax
    assert len(jax.devices()) == 8
    rg, rpart, rsys, tsys = _deploy_both()
    ss, ts = _batch(rg, rsys, 3)
    empty = np.array([], dtype=np.int64)
    placement = np.array([7, 0, 0, 2, 1, 3, 6, 5])
    for layout in LAYOUTS:
        for pl in (None, placement):
            ref = _ref_engine(rsys, layout, placement=pl)
            got = _port_engine(tsys, 8, layout, placement=pl)
            assert ref.num_devices == 8
            np.testing.assert_array_equal(got.query(ss, ts),
                                          ref.query(ss, ts))
            assert got.size_bytes() == ref.size_bytes()
            assert got.district_table_bytes_per_device() == \
                ref.district_table_bytes_per_device()
            assert got.border_table_bytes_per_device() == \
                ref.border_table_bytes_per_device()
            assert got.query(empty, empty).shape == (0,)
        sb, st = layout
        rdata = redge.pack_for_mesh(rpart, rsys.center.border_labels,
                                    _args(rsys)[1], 8, shard_border=sb,
                                    quant=_spec(rcore, rsys, st))
        tdata = tedge.pack_for_mesh(tsys.partition, tsys.center.border_labels,
                                    _args(tsys)[1], 8, shard_border=sb,
                                    quant=_spec(tcore, tsys, st))
        np.testing.assert_array_equal(
            tedge.sharded_query(tdata, tedge.default_edge_mesh(8,
                                                               device="cpu"),
                                tedge.prepare_queries(tdata, ss, ts)),
            redge.sharded_query(rdata, redge.default_edge_mesh(8),
                                redge.prepare_queries(rdata, ss, ts)))
    # auto-pick: 8 devices / 8 shards → the sharded engine on both sides
    tsys.mesh = tedge.default_edge_mesh(8, device="cpu")
    want = rsys.service().submit(ss, ts).distances
    np.testing.assert_array_equal(tsys.service().submit(ss, ts).distances,
                                  want)
    assert type(rsys._current_engine()).__name__ == \
        type(tsys._current_engine()).__name__ == "ShardedBatchedEngine"
    print("OK8")


def test_eight_devices_match_the_reference():
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src"), root]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    out = subprocess.run(
        [sys.executable, "-c",
         "import tests.test_torch_sharded as m; m._eight_device_case()"],
        env=env, capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK8" in out.stdout
