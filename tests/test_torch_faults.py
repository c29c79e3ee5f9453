"""The port's fault injection and degradation ladder against the JAX
package's.

``edge/faults.py`` is a copy: every draw of both packages'
``FaultInjector`` is ``np.random.default_rng((seed, epoch, kind,
*key))``, so the same plan must replay the same bytes in either. Held
equal here: plan validation and ``enabled``, the injectors' draws,
retry charges, events and stats, the scenario builders and the load
harness's vectorized network model; then the scatter plane's faulted
path under several plans — distances (bytes), exactness codes,
``degraded_reason`` strings, exchange stats and the injector's event
log against the reference's plane on the same index (carried across
with ``repro_torch.convert``), a replay byte for byte, no unflagged
wrong answer, and the request plane's ``ResultBatch.degraded_reason``.
"""
import numpy as np
import pytest

import repro.core as rcore
import repro.edge as redge
import repro.serve as rserve
from repro.edge import faults as rfaults
import repro_torch.edge as tedge
import repro_torch.serve as tserve
from repro_torch.convert import index_to_numpy, system_from_numpy
from repro_torch.edge import faults as tfaults

# (name, plan keywords): a dead link everywhere, the same with the center
# dark, a pinned outage, a mixed-rate plan, a flapping plan, and the
# center's own outage rate
PLANS = [
    ("drop", dict(seed=3, peer_drop_rate=1.0)),
    ("drop_center_down", dict(seed=3, peer_drop_rate=1.0, center_down=True)),
    ("outage", dict(seed=1, outage_districts=(0,))),
    ("mixed", dict(seed=23, peer_drop_rate=0.3, peer_timeout_rate=0.4,
                   peer_slow_rate=0.2, server_outage_rate=0.2,
                   max_retries=2)),
    ("flap_center_down", dict(seed=31, peer_drop_rate=0.5,
                              peer_timeout_rate=0.3, flap_period=1,
                              center_down=True)),
    ("timeouts", dict(seed=9, peer_timeout_rate=0.5, max_retries=4,
                      center_outage_rate=0.5)),
]


@pytest.fixture(scope="module")
def pair():
    g = rcore.grid_road_network(8, 8, seed=11)
    part = rcore.bfs_grow_partition(g, 4, seed=0)
    rsys = redge.EdgeSystem.deploy(g, part)
    tsys = system_from_numpy(index_to_numpy(rsys), device="cpu")
    rng = np.random.default_rng(0)
    ss = rng.integers(0, g.num_vertices, size=256)
    ts = rng.integers(0, g.num_vertices, size=256)
    ss[::19] = ts[::19]
    return g, part, rsys, tsys, ss, ts, rsys.query_loop(ss, ts)


def _scrub(system):
    """Back to the cold post-deploy state of the border-row stores."""
    for srv in system.servers:
        own = srv._border_rows.get(srv.district_id)
        srv._border_rows = {} if own is None else {srv.district_id: own}
        srv._stale_rows = None
        srv._stale_rows_version = -2


def _flagged_or_equal(out, ref, codes, reasons):
    """No silent wrong answer: a lane that differs from the clean
    answer is flagged stale and carries a reason."""
    mism = out != ref
    assert (codes[mism] == np.uint8(2)).all()
    assert all(reasons[i] is not None for i in np.nonzero(mism)[0])


def _faulted_run(pkg, system, plan_kw, ss, ts):
    _scrub(system)
    plane = pkg.ScatterGatherPlane.from_system(
        system, faults=pkg.FaultPlan(**plan_kw))
    out = plane.execute(ss, ts)
    return (out.tobytes(), plane.exactness_codes.tobytes(),
            tuple(plane.degraded), dict(plane.exchange_stats),
            tuple(plane.faults.events), dict(plane.faults.stats))


def test_plan_validation_and_enabled_match_reference():
    for kw in ({"peer_drop_rate": 1.5}, {"server_outage_rate": -0.1},
               {"max_retries": -1},
               {"peer_slow_rate": 0.1, "slow_factor": 0.5},
               {"flap_period": -2}, {"backoff_ms": -1.0}):
        with pytest.raises(ValueError) as want:
            rfaults.FaultPlan(**kw)
        with pytest.raises(ValueError) as got:
            tfaults.FaultPlan(**kw)
        assert str(got.value) == str(want.value)
    for _, kw in PLANS + [("none", {})]:
        assert tfaults.FaultPlan(**kw).enabled == \
            rfaults.FaultPlan(**kw).enabled
    assert not tfaults.NO_FAULTS.enabled
    assert tfaults.FaultPlan(outage_districts=[np.int64(3), 1]) \
        .outage_districts == (3, 1)


@pytest.mark.parametrize("name,kw", PLANS, ids=[p[0] for p in PLANS])
def test_injector_draws_match_reference(name, kw):
    r = rfaults.FaultInjector(rfaults.FaultPlan(**kw))
    t = tfaults.FaultInjector(tfaults.FaultPlan(**kw))
    for _ in range(6):
        assert t.tick() == r.tick()
        assert [t.server_down(d) for d in range(6)] == \
            [r.server_down(d) for d in range(6)]
        assert t.center_down() == r.center_down()
        for src in range(4):
            for dst in range(4):
                if src != dst:
                    assert t.link_trial(src, dst) == r.link_trial(src, dst)
                    assert t.peer_attempt(src, dst, 3) == \
                        r.peer_attempt(src, dst, 3)
    assert t.events == r.events
    assert t.stats == r.stats


def test_scenario_builders_and_network_model_match_reference():
    for rates in ([0.0, 0.05, 0.5], [1.0]):
        assert [p.__dict__ for p in tfaults.link_loss_sweep(
            rates, seed=7, max_retries=1)] == \
            [p.__dict__ for p in rfaults.link_loss_sweep(
                rates, seed=7, max_retries=1)]
    for m, frac, seed in ((8, 0.25, 2), (4, 1.0, 0), (16, 0.5, 5),
                          (1, 0.5, 1)):
        assert tfaults.district_outage_storm(m, frac, seed=seed).__dict__ \
            == rfaults.district_outage_storm(m, frac, seed=seed).__dict__
    rng = np.random.default_rng(4)
    src = rng.integers(0, 8, size=5000)
    dst = rng.integers(0, 8, size=5000)
    cross = src != dst
    for _, kw in PLANS:
        rt = rfaults.loadgen_network_model(
            rfaults.FaultPlan(**kw), redge.Topology(8), src, dst, cross)
        tt = tfaults.loadgen_network_model(
            tfaults.FaultPlan(**kw), tedge.Topology(8), src, dst, cross)
        np.testing.assert_array_equal(tt[0], rt[0])
        np.testing.assert_array_equal(tt[1], rt[1])
        assert tt[2] == rt[2]


def test_disabled_plan_is_the_clean_path(pair):
    g, part, rsys, tsys, ss, ts, ref = pair
    plane = tedge.ScatterGatherPlane.from_system(tsys,
                                                 faults=tedge.NO_FAULTS)
    assert plane.faults is None
    np.testing.assert_array_equal(plane.execute(ss, ts), ref)
    assert plane.exactness_codes is None and plane.degraded is None
    pol = tserve.ServingPolicy(engine="scatter_gather",
                               faults=tedge.FaultPlan())
    assert pol.faults is None
    batch = tsys.service(pol).submit(ss, ts)
    np.testing.assert_array_equal(batch.distances, ref)
    assert all(r is None for r in batch.degraded_reason)


@pytest.mark.parametrize("name,kw", PLANS, ids=[p[0] for p in PLANS])
def test_faulted_plane_matches_reference_and_replays(pair, name, kw):
    """Distances, codes, reasons, exchange stats, events and injector
    stats equal the reference's plane under the same plan; two runs of
    the port are byte for byte; and no answer is wrong unflagged."""
    g, part, rsys, tsys, ss, ts, ref = pair
    want = _faulted_run(redge, rsys, kw, ss, ts)
    got = _faulted_run(tedge, tsys, kw, ss, ts)
    assert got == want
    assert _faulted_run(tedge, tsys, kw, ss, ts) == got
    out = np.frombuffer(got[0], dtype=np.float32)
    codes = np.frombuffer(got[1], dtype=np.uint8)
    _flagged_or_equal(out, ref, codes, got[2])
    assert any(r is not None for r in got[2])


@pytest.mark.parametrize("storage", ["float32", "uint16"])
def test_stale_border_rows_match_reference(storage):
    """Blackout after a traffic update: the servers still hold the
    previous generation's rows — served, flagged stale, equal to the
    reference's ladder (quantized views too)."""
    g = rcore.grid_road_network(8, 8, seed=11)
    g = g.with_weights(np.ceil(g.weights * 4.0))
    part = rcore.bfs_grow_partition(g, 4, seed=0)
    rsys = redge.EdgeSystem.deploy(g, part)
    tsys = system_from_numpy(index_to_numpy(rsys), device="cpu")
    rng = np.random.default_rng(1)
    ss = rng.integers(0, g.num_vertices, size=256)
    ts = rng.integers(0, g.num_vertices, size=256)
    w2 = np.ceil(rcore.perturb_weights(g, rng, lo=0.7, hi=1.4))
    plan = dict(seed=3, peer_drop_rate=1.0, center_down=True)
    runs = []
    for pkg, system in ((redge, rsys), (tedge, tsys)):
        pkg.ScatterGatherPlane.from_system(system).execute(ss, ts)
        system.apply_traffic_update(w2)
        quant = None if storage == "float32" else system._resolve_quant(
            "uint16")
        plane = pkg.ScatterGatherPlane.from_system(
            system, faults=pkg.FaultPlan(**plan), quant=quant)
        out = plane.execute(ss, ts)
        runs.append((out.tobytes(), plane.exactness_codes.tobytes(),
                     tuple(plane.degraded), dict(plane.exchange_stats)))
    assert runs[1] == runs[0]
    stale = [r == "peer_link_down:stale_border_rows" for r in runs[1][2]]
    assert any(stale)
    _flagged_or_equal(np.frombuffer(runs[1][0], np.float32),
                      tsys.query_loop(ss, ts),
                      np.frombuffer(runs[1][1], np.uint8), runs[1][2])


def test_service_carries_degraded_reason(pair):
    g, part, rsys, tsys, ss, ts, ref = pair
    batches = []
    for pkg, spkg, system in ((redge, rserve, rsys), (tedge, tserve, tsys)):
        _scrub(system)
        svc = system.service(spkg.ServingPolicy(
            engine="scatter_gather",
            faults=pkg.FaultPlan(seed=3, peer_drop_rate=1.0,
                                 center_down=True)))
        batches.append((svc.submit(ss, ts), svc))
    (rb, rsvc), (tb, tsvc) = batches
    np.testing.assert_array_equal(tb.distances, rb.distances)
    np.testing.assert_array_equal(tb.exactness_codes, rb.exactness_codes)
    assert list(tb.degraded_reason) == list(rb.degraded_reason)
    bad = int(np.nonzero(tb.distances != ref)[0][0])
    assert tb[bad].exactness == "stale" and not tb[bad].exact
    assert tb[bad].degraded_reason == "peer_drop:unavailable"
    for i in (bad, 0, len(ss) - 1):
        t, r = tb[i], rb[i]
        assert (t.distance, int(t.rule), t.exactness, t.waited,
                t.degraded_reason) == (r.distance, int(r.rule), r.exactness,
                                       r.waited, r.degraded_reason)
    good = int(np.nonzero(tb.distances == ref)[0][0])
    assert tb[good].degraded_reason is None
    assert tsvc.stats == rsvc.stats
