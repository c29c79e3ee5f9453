"""The port's traffic shapes, topology, §5 simulator, distance batcher
and open-loop load harness against the JAX package's.

Each of these is host NumPy in both packages: the same seeds must give
the same arrays and the same reports. The simulator's rows and
latencies are held equal under fixed and measured-style
(``VariableUpdateSchedule.from_timings``) schedules, forwarded and
scatter, per query and micro-batched, under faults and under a
placement with a migration; the load harness's ``LoadReport`` is held
equal under ``service_ms_override`` (the deterministic service model)
with the real services of both packages answering every batch — open
and closed loop, a bounded queue, the scatter plane with faults, and a
rebuild window. ``run_update_epochs`` times builds on the wall clock,
so only its structure is checked here; no test compares latencies
built from wall-clock seconds.
"""
from collections import namedtuple

import numpy as np
import pytest

import repro.core as rcore
import repro.edge as redge
import repro.serve as rserve
import repro_torch.core as tcore
import repro_torch.edge as tedge
import repro_torch.serve as tserve
from repro_torch.convert import index_to_numpy, system_from_numpy

DET = (0.2, 0.001)      # (overhead_ms, per_query_ms) virtual service model
PKGS = {"ref": (redge, rserve), "port": (tedge, tserve)}


def _pair(rows=12, seed=11, districts=4):
    g = rcore.grid_road_network(rows, rows, seed=seed)
    part = rcore.grid_partition(g, rows, rows, 2, districts // 2)
    rsys = redge.EdgeSystem.deploy(g, part)
    return g, rsys, system_from_numpy(index_to_numpy(rsys), device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair()


# -- traffic shapes and topology ---------------------------------------------

def test_traffic_shapes_match_reference():
    assert tedge.TRAFFIC_SHAPES == redge.TRAFFIC_SHAPES
    frac = np.linspace(0.0, 1.0, 333)
    for shape in tedge.TRAFFIC_SHAPES:
        np.testing.assert_array_equal(tedge.rate_profile(shape, frac),
                                      redge.rate_profile(shape, frac))
        for num in (0, 1, 3000):
            np.testing.assert_array_equal(
                tedge.arrival_times(num, 5_000.0, shape=shape, seed=1),
                redge.arrival_times(num, 5_000.0, shape=shape, seed=1))
    with pytest.raises(ValueError, match="shape must be one of"):
        tedge.rate_profile("bursty", frac)
    for clients, qps in ((1, 1.0), (10_000, 0.5), (1_000_000, 0.01)):
        assert tedge.poisson_count(clients, qps, 1_000.0, seed=3) == \
            redge.poisson_count(clients, qps, 1_000.0, seed=3)


def test_topology_matches_reference():
    for lat in ({}, dict(client_edge_ms=3.0, edge_center_ms=41.0,
                         peer_edge_ms=2.5)):
        r = redge.Topology(5, redge.LatencyModel(**lat))
        t = tedge.Topology(5, tedge.LatencyModel(**lat))
        assert t.latency.__dict__ == r.latency.__dict__
        for name in ("edge_rtt_ms", "forward_rtt_ms", "center_rtt_ms",
                     "peer_rtt_ms", "centralized_rtt_ms"):
            assert getattr(t, name)() == getattr(r, name)()
    cross = np.array([True, False, True])
    for scatter in (False, True):
        np.testing.assert_array_equal(
            tserve.request_rtt_ms(tedge.Topology(4), cross, scatter),
            rserve.request_rtt_ms(redge.Topology(4), cross, scatter))


# -- the §5 simulator ----------------------------------------------------------

def _schedule(pkg, kind):
    if kind == "fixed":
        return pkg.UpdateSchedule(epoch_ms=5_000.0,
                                  rebuild_ms_centralized=4_000.0,
                                  rebuild_ms_edge_bl=300.0,
                                  rebuild_ms_edge_local=40.0)
    starts = (1.0 + np.arange(5)) * 4_000.0
    return pkg.VariableUpdateSchedule.from_timings(
        starts, [3.1, 2.7, 3.9, 0.4, 2.2], [0.03, 0.05, 0.02, 0.01, 0.04],
        [0.25, 0.4, 0.31, 0.05, 0.2])


# (name, ServingPolicy keywords, simulate_edge keywords)
SIM_CASES = [
    ("forwarded", {}, {}),
    ("forwarded_batched", {}, {"batch": (32, 2.0)}),
    ("stale_ok", {"rebuild": "stale_ok"}, {}),
    ("scatter", {"engine": "scatter_gather"}, {}),
    ("scatter_batched_stale_ok", {"engine": "scatter_gather",
                                  "rebuild": "stale_ok"},
     {"batch": (64, 5.0)}),
    ("scatter_faults", {"engine": "scatter_gather"},
     {"faults": dict(seed=7, peer_drop_rate=0.3, peer_timeout_rate=0.2,
                     peer_slow_rate=0.2, server_outage_rate=0.2)}),
    ("scatter_faults_center_down_batched", {"engine": "scatter_gather"},
     {"faults": dict(seed=2, outage_districts=(1, 2), center_down=True,
                     peer_drop_rate=0.2), "batch": (16, 3.0)}),
    ("forwarded_center_down", {}, {"faults": dict(seed=1,
                                                  center_down=True,
                                                  outage_districts=(0,))}),
    ("placement_handoff", {"migration": "handoff"},
     {"placement": True, "migrations": True}),
    ("placement_dual_batched", {"engine": "scatter_gather"},
     {"placement": True, "migrations": True, "batch": (32, 2.0)}),
]


def _simulate(pkg, spkg, g, part, certified, kind, pol_kw, sim_kw):
    trace = pkg.make_trace(g, 1500, 30_000.0, seed=9)
    topo = pkg.Topology(part.num_districts, pkg.LatencyModel())
    sched = _schedule(pkg, kind)
    central = pkg.simulate_centralized(trace, topo, sched)
    kw = {}
    if "batch" in sim_kw:
        kw["batch"] = pkg.BatchPolicy(*sim_kw["batch"])
    if "faults" in sim_kw:
        kw["faults"] = pkg.FaultPlan(**sim_kw["faults"])
    if sim_kw.get("placement"):
        kw["placement"] = np.array([0, 0, 1, 1], dtype=np.int32)
    if sim_kw.get("migrations"):
        Move = namedtuple("Move", "district src_host dst_host")
        plan = namedtuple("Plan", "moves")([Move(1, 0, 1)])
        kw["migrations"] = (pkg.migrations_from_plan(plan, 9_000.0, 800.0)
                            + [pkg.MigrationEvent(20_000.0, 3, 1, 0,
                                                  500.0)])
    edge = pkg.simulate_edge(trace, topo, sched, part.assignment,
                             certified, part.num_districts,
                             policy=spkg.ServingPolicy(**pol_kw), **kw)
    return central, edge


@pytest.mark.parametrize("kind", ["fixed", "variable"])
@pytest.mark.parametrize("name,pol_kw,sim_kw", SIM_CASES,
                         ids=[c[0] for c in SIM_CASES])
def test_simulator_matches_reference(pair, kind, name, pol_kw, sim_kw):
    g, rsys, tsys = pair
    part = rsys.partition
    got = _simulate(tedge, tserve, g, part, tsys.service().certifier(),
                    kind, pol_kw, sim_kw)
    want = _simulate(redge, rserve, g, part, rsys.service().certifier(),
                     kind, pol_kw, sim_kw)
    for t, r in zip(got, want):
        assert t.row(name) == r.row(name)
        np.testing.assert_array_equal(t.latencies_ms, r.latencies_ms)
        for mask in ("migration_window_mask", "nonexact_mask"):
            a, b = getattr(t, mask), getattr(r, mask)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_simulator_edge_cases_match_reference():
    empty_t = tedge.SimResult.from_latencies(np.zeros(0))
    empty_r = redge.SimResult.from_latencies(np.zeros(0))
    assert empty_t.row("x") == empty_r.row("x")
    with pytest.raises(ValueError, match="explicit placement"):
        tedge.simulate_edge([], tedge.Topology(2),
                            tedge.UpdateSchedule(1.0, 0.0, 0.0, 0.0),
                            np.zeros(4, np.int32), lambda s, t: True, 2,
                            migrations=[tedge.MigrationEvent(1.0, 0, 0, 1)])
    g = rcore.grid_road_network(6, 6, seed=3)
    for shape in tedge.TRAFFIC_SHAPES:
        got = tedge.make_trace(g, 400, 10_000.0, seed=4, shape=shape)
        want = redge.make_trace(g, 400, 10_000.0, seed=4, shape=shape)
        assert [(e.t_ms, e.s, e.t) for e in got] == \
            [(e.t_ms, e.s, e.t) for e in want]


def test_run_update_epochs_structure():
    """Measured epochs on the port's system (the staged builder on the
    CPU): one report an epoch with the three timing fields, a schedule
    whose windows are the epoch starts plus those seconds, and a system
    that still answers exactly. Times are not compared."""
    g = tcore.grid_road_network(6, 6, seed=3)
    part = tcore.bfs_grow_partition(g, 4, seed=0)
    system = tedge.EdgeSystem.deploy(g, part, builder="torch", device="cpu")
    sched, reports = tedge.run_update_epochs(system, "incident", 2,
                                             4_000.0, seed=3,
                                             intensity=0.05)
    assert len(reports) == 2
    starts = (1.0 + np.arange(2)) * 4_000.0
    np.testing.assert_array_equal(sched.epoch_starts, starts)
    for k, rep in enumerate(reports):
        assert rep["epoch_ms"] == starts[k]
        for key in ("full_rebuild_s", "local_parallel_s", "global_ready_s"):
            assert rep[key] >= 0.0
    np.testing.assert_allclose(
        sched.centralized_ready,
        starts + 1e3 * np.array([r["full_rebuild_s"] for r in reports]))
    np.testing.assert_allclose(
        sched.global_ready,
        starts + 1e3 * np.array([r["global_ready_s"] for r in reports]))
    assert system.current_engine() is not None
    rng = np.random.default_rng(5)
    ss = rng.integers(0, g.num_vertices, 64)
    ts = rng.integers(0, g.num_vertices, 64)
    want = np.array([tcore.dijkstra(system.graph, int(s))[int(t)]
                     for s, t in zip(ss, ts)], dtype=np.float32)
    np.testing.assert_allclose(system.service().submit(ss, ts).distances,
                               want, rtol=1e-6)


# -- the distance batcher ------------------------------------------------------

@pytest.mark.parametrize("engine", ["replicated", "scatter_gather"])
def test_distance_batcher_matches_reference(pair, engine):
    """Same answers, same counters, padding never leaks, the same shed
    count under a bounded queue."""
    g, rsys, tsys = pair
    rng = np.random.default_rng(2)
    pairs = list(zip(rng.integers(0, g.num_vertices, 300).tolist(),
                     rng.integers(0, g.num_vertices, 300).tolist()))
    out = {}
    for name, system in (("ref", rsys), ("port", tsys)):
        edge, serve = PKGS[name]
        svc = system.service(serve.ServingPolicy(
            engine=engine, batch=edge.BatchPolicy(batch_size=64)))
        b = svc.batcher()
        assert b.batch_size == 64
        bounded = serve.DistanceBatcher(svc, batch_size=64, max_queue=250)
        assert bounded.submit_pairs(pairs) == 250
        assert b.submit_pairs(pairs, rid_base=10) == 300
        done = b.run()
        assert all(r.rid >= 0 for r in done) and len(done) == 300
        out[name] = ([(r.rid, r.s, r.t, r.distance) for r in done],
                     dict(svc.stats), bounded.shed_count)
    assert out["port"] == out["ref"]
    assert out["port"][1]["rule1"] + out["port"][1]["rule3"] == 300


def test_distance_batcher_plug_ins(pair):
    g, rsys, tsys = pair
    ss = np.array([0, 5, 17], np.int64)
    ts = np.array([3, 99, 17], np.int64)
    want = tsys.query_loop(ss, ts)
    plane = tsys._current_scatter_plane()
    for engine in (plane, plane.execute, tsys, tsys.service()):
        b = tserve.DistanceBatcher(engine, batch_size=2)
        b.submit_pairs(zip(ss.tolist(), ts.tolist()))
        got = np.array([r.distance for r in b.run()], np.float32)
        np.testing.assert_array_equal(got, want)
        assert b.latency_stats()["count"] == 3
    for pkg in (tserve, rserve):
        with pytest.raises(TypeError, match="QueryPlane protocol"):
            pkg.DistanceBatcher(object())
        with pytest.raises(ValueError, match="batch_size"):
            pkg.DistanceBatcher(plane.execute, batch_size=0)


# -- the open-loop load harness --------------------------------------------------

# (name, ServingPolicy keywords, generator keywords, run arguments)
LOAD_CASES = [
    ("open", {}, {}, (10_000, 0.5, 1_000.0)),
    ("bounded_queue", {}, {"max_queue": 256,
                           "service_ms_override": (5.0, 0.05)},
     (40_000, 0.5, 1_000.0)),
    ("flash_crowd_capped", {}, {"service_ms_override": (1.0, 0.02)},
     (30_000, 0.5, 1_000.0, "flash_crowd", 2_000)),
    ("million_clients", {}, {"batch_size": 1024},
     (1_000_000, 0.005, 1_000.0)),
    ("closed_loop", {}, {"closed_loop": 16, "batch_size": 64},
     (2_000, 0.5, 1_000.0)),
    ("scatter", {"engine": "scatter_gather"}, {}, (10_000, 0.5, 1_000.0)),
    ("scatter_link_loss", {"engine": "scatter_gather",
                           "faults": dict(seed=7, peer_drop_rate=0.4)},
     {}, (6_000, 0.5, 1_000.0)),
    ("scatter_storm", {"engine": "scatter_gather",
                       "faults": "storm"}, {}, (6_000, 0.5, 1_000.0)),
    ("scatter_closed_loop", {"engine": "scatter_gather"},
     {"closed_loop": 32, "batch_size": 64}, (2_000, 1.0, 1_000.0)),
]


def _load_run(name, system, pol_kw, gen_kw, args):
    edge, serve = PKGS[name]
    pol_kw = dict(pol_kw)
    if pol_kw.get("faults") == "storm":
        pol_kw["faults"] = edge.district_outage_storm(
            system.partition.num_districts, 0.5, seed=2, center_down=True)
    elif "faults" in pol_kw:
        pol_kw["faults"] = edge.FaultPlan(**pol_kw["faults"])
    svc = system.service(serve.ServingPolicy(**pol_kw))
    gen_kw = {"batch_size": 128, "service_ms_override": DET, "seed": 5,
              **gen_kw}
    gen = serve.OpenLoopLoadGen(svc, **gen_kw)
    before = dict(svc.stats)
    gen.warmup()
    assert dict(svc.stats) == before
    rep = gen.run(*args[:3], **dict(zip(("shape", "max_arrivals"),
                                        args[3:])))
    return rep, dict(svc.stats)


@pytest.mark.parametrize("name,pol_kw,gen_kw,args", LOAD_CASES,
                         ids=[c[0] for c in LOAD_CASES])
def test_load_report_matches_reference(pair, name, pol_kw, gen_kw, args):
    g, rsys, tsys = pair
    got, got_stats = _load_run("port", tsys, pol_kw, gen_kw, args)
    want, want_stats = _load_run("ref", rsys, pol_kw, gen_kw, args)
    assert got.row() == want.row()
    np.testing.assert_array_equal(got.latencies_ms, want.latencies_ms)
    np.testing.assert_array_equal(got.district_load, want.district_load)
    assert got_stats == want_stats
    assert got.engine_calls > 0


def test_load_reports_through_a_rebuild_window():
    """Both packages open the same rebuild window: ``stale_ok`` and
    ``certify_or_wait`` reports (stale and certified fractions) are
    equal, as is a run whose window opens mid-run."""
    g, rsys, tsys = _pair(rows=10, seed=2)
    w2 = rcore.perturb_weights(g, np.random.default_rng(1), lo=0.7,
                               hi=1.5)
    rows = {}
    for name, system in (("ref", rsys), ("port", tsys)):
        edge, serve = PKGS[name]
        serve.open_rebuild_window(system, w2)
        assert all(srv.augmented is None for srv in system.servers)
        reps = []
        for mode in ("stale_ok", "certify_or_wait"):
            svc = system.service(serve.ServingPolicy(rebuild=mode))
            reps.append(serve.OpenLoopLoadGen(
                svc, batch_size=128, service_ms_override=DET,
                seed=5).run(4_000, 0.5, 1_000.0).row())
        serve.close_rebuild_window(system)
        assert all(srv.augmented_version == system.center.version
                   for srv in system.servers)
        svc = system.service(serve.ServingPolicy(rebuild="stale_ok"))
        reps.append(serve.OpenLoopLoadGen(
            svc, batch_size=128, service_ms_override=DET, seed=7).run(
                4_000, 0.5, 1_000.0, update_at_frac=0.5,
                scenario="incident", intensity=0.02).row())
        serve.close_rebuild_window(system)
        rows[name] = reps
    assert rows["port"] == rows["ref"]
    stale_ok, wait, mid = rows["port"]
    assert stale_ok["stale_frac"] + stale_ok["certified_frac"] > 0.0
    assert wait["stale_frac"] == 0.0
    assert 0.0 < mid["stale_frac"] + mid["certified_frac"] < 0.75
