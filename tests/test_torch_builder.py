"""The port's staged Border-Labeling builder against the JAX package.

The same graphs and partitions — grid road networks with integral
weights (as ``tests/test_update.py`` pins the reference builders on),
a random geometric network with float weights, a small synthetic
continent, and a single district with no borders — go through the JAX
package's ``build_border_labels_stages`` (XLA, and once its Pallas
kernels in interpret mode) and the port's on ``device="cpu"``, where
stages A–C run the kernels' plain versions. Every ``BuildState`` field
is held equal without tolerance: the stages are exact (min of single
float32 adds, order-free), so the bits agree whatever the tiling, the
chunking or the early exit of stage A. Through ``ComputingCenter`` and
``EdgeSystem`` the port's ``builder="torch"`` serves exactly what the
JAX package's ``builder="jax"`` (and on integral weights
``"reference"``) serves.
"""
import numpy as np
import pytest
import torch

import repro.core as rcore
import repro.edge as redge
import repro.ingest as ringest
import repro.serve as rserve
import repro_torch.core as tcore
import repro_torch.edge as tedge
import repro_torch.ingest as tingest
import repro_torch.serve as tserve
from repro.core.jax_builder import build_border_labels_stages as rstages
from repro_torch import convert
from repro_torch.core import torch_builder
from repro_torch.kernels.minplus import kernel as mp_kernel

CASES = ["grid6", "grid8", "geometric", "continent", "one_district"]
INTEGRAL = ["grid6", "grid8", "continent"]
PACKED = ("adj", "vertex_ids", "border_pos", "border_ids", "border_slot",
          "kmax", "bmax")
STAGES = ("intra", "overlay", "closure", "unpruned", "table", "prune_order",
          "weights")


def _inputs(core, ingest, case):
    if case in ("grid6", "grid8"):
        dims, m, seed = ((6, 6), 3, 0) if case == "grid6" else ((8, 8), 4, 21)
        g = core.grid_road_network(*dims, seed=seed)
        g = g.with_weights(np.ceil(g.weights))
        return g, core.bfs_grow_partition(g, m, seed=0)
    if case == "geometric":
        g = core.random_geometric_network(60, seed=2)
        return g, core.bfs_grow_partition(g, 3, seed=0)
    if case == "one_district":
        g = core.grid_road_network(4, 4, seed=1)
        return g, core.Partition(np.zeros(g.num_vertices, np.int32), 1)
    csr, part = ingest.synthetic_continent((2, 2), (8, 8), seed=3)
    return csr.to_graph(), part


def _both(case):
    return _inputs(rcore, ringest, case), _inputs(tcore, tingest, case)


def _assert_states_equal(got, want):
    for f in PACKED:
        np.testing.assert_array_equal(getattr(got.packed, f),
                                      getattr(want.packed, f), err_msg=f)
    for f in STAGES:
        w = getattr(want, f)
        if w is None:
            assert getattr(got, f) is None, f
        else:
            np.testing.assert_array_equal(getattr(got, f), w, err_msg=f)


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_every_stage_equals_the_jax_builder(case, prune):
    (rg, rpart), (tg, tpart) = _both(case)
    rlabels, rstate = rstages(rg, rpart, prune=prune, use_pallas=False)
    tlabels, tstate = torch_builder.build_border_labels_stages(
        tg, tpart, prune=prune, device="cpu")
    _assert_states_equal(tstate, rstate)
    np.testing.assert_array_equal(tlabels.table, rlabels.table)
    np.testing.assert_array_equal(tlabels.border_ids, rlabels.border_ids)
    np.testing.assert_array_equal(tstate.table_device.numpy(),
                                  rstate.table)


def test_every_stage_equals_the_jax_builder_through_pallas():
    (rg, rpart), (tg, tpart) = _both("grid6")
    _, rstate = rstages(rg, rpart, prune=True, use_pallas=True)
    _, tstate = torch_builder.build_border_labels_stages(tg, tpart,
                                                         device="cpu")
    _assert_states_equal(tstate, rstate)


@pytest.mark.parametrize("case", INTEGRAL)
def test_torch_builder_equals_the_reference_builders(case):
    _, (tg, tpart) = _both(case)
    got = tcore.build_border_labels_torch(tg, tpart, device="cpu")
    for want in (tcore.build_border_labels_reference(tg, tpart),
                 tcore.build_border_labels_hierarchical(tg, tpart)):
        np.testing.assert_array_equal(got.table, want.table)


def test_timings_and_sweeps_are_reported():
    _, (tg, tpart) = _both("grid8")
    timings = {"stale": 1.0}
    _, state = torch_builder.build_border_labels_stages(
        tg, tpart, device="cpu", timings=timings)
    assert set(timings) == {"pack_s", "upload_s", "stage_a_pack_s",
                            "stage_a_sweeps_s", "stage_a_s",
                            "stage_a_sweeps", "overlay_s", "stage_b_s",
                            "stage_c_s", "stage_d_s"}
    assert timings["stage_a_pack_s"] == timings["pack_s"] \
        + timings["upload_s"]
    assert timings["stage_a_s"] == timings["stage_a_pack_s"] \
        + timings["stage_a_sweeps_s"]
    assert 1 <= timings["stage_a_sweeps"] < state.packed.kmax


@pytest.mark.parametrize("case", INTEGRAL)
def test_center_torch_builder_equals_jax_and_reference(case):
    (rg, rpart), (tg, tpart) = _both(case)
    port = tedge.ComputingCenter(tg, tpart, builder="torch", device="cpu")
    port.rebuild()
    centers = []
    for builder in ("jax", "reference"):
        c = redge.ComputingCenter(rg, rpart, builder=builder)
        c.rebuild()
        centers.append(c)
    for c in centers:
        np.testing.assert_array_equal(port.border_labels.table,
                                      c.border_labels.table)
        for i in range(tpart.num_districts):
            np.testing.assert_array_equal(port.shortcuts_for(i),
                                          c.shortcuts_for(i))
    assert port.version == 1
    # B's device copy is the builder's own tensor, not a re-upload
    assert port.border_table_device() is \
        port.incremental_builder().state.table_device


def _batch(part, seed, size=300):
    rng = np.random.default_rng(seed)
    n = len(part.assignment)
    ss, ts = rng.integers(0, n, size), rng.integers(0, n, size)
    members = part.districts()
    for i in range(0, size, 2):
        d = members[int(part.assignment[ss[i]])]
        ts[i] = d[rng.integers(len(d))]
    ss[::17] = ts[::17]
    client = part.assignment[ss].astype(np.int32)
    return ss.astype(np.int64), ts.astype(np.int64), client


def _assert_served_alike(tsys, rsys, part, seed):
    ss, ts, client = _batch(part, seed)
    for dtype in ("float32", "uint16"):
        got = tsys.service(tserve.ServingPolicy(label_dtype=dtype)).submit(
            ss, ts, client_districts=client)
        want = rsys.service(rserve.ServingPolicy(label_dtype=dtype)).submit(
            ss, ts, client_districts=client)
        np.testing.assert_array_equal(got.distances, want.distances)
        np.testing.assert_array_equal(got.rules, want.rules)
        np.testing.assert_array_equal(got.exactness_codes,
                                      want.exactness_codes)


@pytest.mark.parametrize("case", ["grid8", "continent"])
def test_deploy_and_full_update_serve_as_the_jax_builder(case):
    (rg, rpart), (tg, tpart) = _both(case)
    rsys = redge.EdgeSystem.deploy(rg, rpart, builder="jax")
    tsys = tedge.EdgeSystem.deploy(tg, tpart, builder="torch", device="cpu")
    np.testing.assert_array_equal(tsys.center.border_labels.table,
                                  rsys.center.border_labels.table)
    _assert_served_alike(tsys, rsys, tpart, seed=1)
    rng = np.random.default_rng(7)
    w2 = np.maximum(1.0, np.rint(tcore.perturb_weights(tg, rng))) \
        .astype(np.float32)
    rsys.apply_traffic_update(w2, incremental=False)
    report = tsys.apply_traffic_update(w2, incremental=False)
    assert not report["incremental"] and tsys.center.version == 2
    np.testing.assert_array_equal(tsys.center.border_labels.table,
                                  rsys.center.border_labels.table)
    _assert_served_alike(tsys, rsys, tpart, seed=2)


def test_build_state_carried_across_equals_own_build():
    (rg, rpart), (tg, tpart) = _both("continent")
    _, rstate = rstages(rg, rpart)
    _, tstate = torch_builder.build_border_labels_stages(tg, tpart,
                                                         device="cpu")
    carried = convert.build_state_from_numpy(
        convert.build_state_to_numpy(rstate))
    assert isinstance(carried, torch_builder.BuildState)
    assert carried.table_device is None
    _assert_states_equal(carried, tstate)
    np.testing.assert_array_equal(carried.labels().table,
                                  tstate.labels().table)
    own = convert.build_state_to_numpy(tstate)
    assert own.keys() == convert.build_state_to_numpy(rstate).keys()


def test_build_state_carried_across_without_prune_order():
    _, (tg, tpart) = _both("grid6")
    _, state = torch_builder.build_border_labels_stages(
        tg, tpart, prune=False, device="cpu")
    arrays = convert.build_state_to_numpy(state)
    assert "prune_order" not in arrays
    _assert_states_equal(convert.build_state_from_numpy(arrays), state)


def test_cpu_build_launches_no_kernel():
    _, (tg, tpart) = _both("grid6")
    before = dict(mp_kernel.LAUNCHES)
    torch_builder.build_border_labels_torch(tg, tpart, device="cpu")
    assert mp_kernel.LAUNCHES == before


def test_builder_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts "
                    "without one")
    _, (tg, tpart) = _both("grid6")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.build_border_labels_torch(tg, tpart)
