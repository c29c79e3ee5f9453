"""The benchmark's harness on the CPU at tiny sizes: it finds every
configuration, mix and metric by name, its frozen generator still equals
the program's, a tiny run of each cell is correct against the plain
reference, the trace is read on the profiler's clock, a run loads nothing
of JAX or the JAX package, a new cell and a new deployment kind, driver
or judge take new files and manifest entries only, and an unknown one
fails before the network is drawn."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from edgebench import harness, network, reference, roofline, workload
from edgebench.devtrace import DeviceTrace, Tracer

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def tiny(workload_name: str, grid=(2, 2), district=(6, 6)):
    """The cell's configuration and mix, cut to a CPU test's size."""
    _, cfg, mix = harness.resolve(MANIFEST, workload_name)
    cfg = dict(cfg, network=dict(cfg["network"], grid=list(grid),
                                 district=list(district)))
    return cfg, dict(mix, batch=64)


def run_tiny(workload_name: str, seed: int = 2**31 + 11, **kw) -> dict:
    cfg, mix = tiny(workload_name, **kw.pop("size", {}))
    return harness.run_cell(MANIFEST, workload_name, seed, 0.3, False,
                            torch.device("cpu"), time.perf_counter_ns(),
                            config=cfg, traffic=mix, **kw)


def test_every_name_resolves_to_a_file():
    for cell in CELLS:
        entry, cfg, mix = harness.resolve(MANIFEST, cell)
        assert cfg["name"] == entry["config"]
        assert mix["driver"] in harness.DRIVERS
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            assert callable(harness.load_reader(m["name"]))
            for w in m.get("workloads", []):
                assert w in CELLS
    for c in MANIFEST["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] \
            == c["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in harness.metric_entries(MANIFEST, cell,
                                                         False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metric_entries(MANIFEST, cell, True)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_network_is_the_programs_continent(seed):
    from repro_torch.ingest import synthetic_continent
    csr, part = synthetic_continent((3, 2), (5, 4), border_links=2,
                                    seed=seed)
    net = network.continent((3, 2), (5, 4), border_links=2, seed=seed)
    assert np.array_equal(net.indptr, csr.indptr)
    assert np.array_equal(net.indices, csr.indices)
    assert np.array_equal(net.weights, csr.weights)
    assert np.array_equal(net.assignment, part.assignment)
    assert net.num_districts == part.num_districts


@pytest.mark.parametrize("seed", [4, 2**31 + 5])
def test_cross_pairs_draw_what_they_say(seed):
    net = network.continent((3, 2), (6, 5), border_links=2, seed=1)
    rng = np.random.default_rng(seed)
    ss, ts = workload.cross_pairs(net, rng, 60000)
    ds, dt = net.assignment[ss], net.assignment[ts]
    assert (ds != dt).all()
    # district pairs uniform over the 6 * 5 ordered pairs, vertices
    # uniform over all 180
    pairs = np.bincount(ds * 6 + dt, minlength=36).reshape(6, 6)
    assert (np.diag(pairs) == 0).all()
    off = pairs[~np.eye(6, dtype=bool)]
    assert off.min() > 0.85 * off.mean() and off.max() < 1.15 * off.mean()
    hits = np.bincount(ss, minlength=180)
    assert hits.min() > 0.75 * hits.mean()
    again = workload.cross_pairs(net, np.random.default_rng(seed), 60000)
    assert np.array_equal(again[0], ss) and np.array_equal(again[1], ts)


@pytest.mark.parametrize("links", [1, 3])
def test_reference_equals_dijkstra(links):
    from repro_torch.core import Graph, dijkstra
    net = network.continent((2, 2), (5, 5), border_links=links, seed=9)
    g = Graph(net.indptr, net.indices, net.weights)
    ss, ts = workload.cross_pairs(net, np.random.default_rng(0), 300)
    want = np.array([dijkstra(g, int(s))[int(t)] for s, t in zip(ss, ts)],
                    dtype=np.float32)
    border = reference.border_distances(net)
    assert np.array_equal(reference.cross_join(border, ss, ts, block=7),
                          want)
    rows = reference.distances_from(net, ss[:5])
    assert np.array_equal(rows[ts[:5], np.arange(5)].numpy(), want[:5])


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 2**32 + 7])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_answers_equal_the_reference(cell, seed):
    out = run_tiny(cell, seed=seed)
    assert out["correct"], out["compared"]
    assert out["checked"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    names = {m["name"] for m in harness.metric_entries(MANIFEST, cell,
                                                       False)}
    assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert m["value"] > 0


def test_trace_reads_the_window_and_phases_from_the_profiler():
    tracer = Tracer(True)
    tracer.start()
    for _ in range(3):
        with tracer.phase("program: answer_cross_many"):
            torch.ones(64).sum()
    time.sleep(0.05)
    tracer.stop()
    t = tracer.trace
    assert 0.05 <= t.window_s < 5
    assert [p[0] for p in t.phases] == ["program: answer_cross_many"] * 3
    lo, hi = t.window_ns
    assert all(lo <= s <= e <= hi for _, s, e in t.phases)
    # no card here: no device events, the window all idle, and no phase
    # covers its end
    assert t.busy_s == 0.0 and t.events == []
    assert t.idle_by_phase()[0][0] == "harness"
    off = Tracer(False)
    off.start()
    with off.phase("x"):
        pass
    off.stop()
    assert off.trace is None and off.ready_ns is not None


def test_a_split_metric_name_falls_back_to_its_reader():
    assert harness.load_reader("device_idle_pct.update") is not None
    assert harness.load_reader("device_idle_pct").__module__ \
        != harness.load_reader("queries_per_s").__module__


def test_trace_arithmetic():
    assert roofline.busy_seconds([(0, 10), (5, 20), (30, 40), (35, 36)]) \
        == 30e-9
    assert roofline.busy_seconds([]) == 0.0
    t = DeviceTrace([("Memcpy HtoD", 10, 20), ("gather_join_kernel", 20,
                                               50),
                     ("Memcpy DtoH", 80, 90)], (0, 100),
                    [("harness: admit", 0, 10),
                     ("program: submit", 50, 100)])
    assert t.window_s == 100e-9 and t.busy_s == 50e-9
    assert t.seconds(lambda n: n.startswith("Memcpy")) == 20e-9
    assert dict((k, v) for k, v in t.idle_by_phase()) == {
        "harness: admit": 10e-9, "program: submit": 40e-9}
    assert t.top_ops(1) == [["gather_join_kernel", 30e-9]]
    assert roofline.idle_pct(t.busy_s, t.window_s) == pytest.approx(50.0)
    assert roofline.join_bytes(10, 4, 3) == 10 * 16 + 3 * 20


def _child(code: str, cwd: Path, extra_path: Path = ROOT):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(extra_path), str(ROOT / "src")]))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    code = f"""
import sys, time, torch
from edgebench import harness
sys.path.insert(0, {str(ROOT / 'edgebench')!r})
import test_edgebench_harness as t
for cell in t.CELLS:
    assert t.run_tiny(cell)["correct"]
top = sorted({{m.split('.')[0] for m in sys.modules}})
print(",".join(top))
"""
    res = _child(code, tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    top = set(res.stdout.strip().splitlines()[-1].split(","))
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = subprocess.run(
        [sys.executable, str(ROOT / "edgebench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2
    assert res.stdout == ""


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_takes_only_new_files_and_a_manifest_entry(tmp_path):
    shutil.copytree(ROOT / "edgebench", tmp_path / "edgebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "edgebench")
    bench = tmp_path / "edgebench"
    (bench / "traffic" / "cross_small.json").write_text(json.dumps(
        {"driver": "closed", "entry": "center", "pairs": "cross",
         "batch": 96, "pool": 2}))
    (bench / "configs" / "tiny_center.json").write_text(json.dumps(
        {"name": "tiny_center", "deployment": "center", "builder": "torch",
         "network": {"grid": [2, 3], "district": [5, 5],
                     "border_links": 2, "weight_high": 15, "seed": 3}}))
    (bench / "metrics" / "batches_run.py").write_text(
        "def read(rec):\n    return rec.measured.batches\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_center", "source": "a test",
                           "file": "edgebench/configs/tiny_center.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "tiny.cross_small",
                             "config": "tiny_center",
                             "traffic": "cross_small", "chips": 1,
                             "why": "a test"})
    man["per_layer"].append({"name": "batches_run", "unit": "batches",
                             "better": "higher", "source": "host_clock",
                             "layer": "a test", "moves": "queries_per_s",
                             "workloads": ["tiny.cross_small"]})
    qps = next(m for m in man["end_to_end"] if m["name"] == "queries_per_s")
    qps["workloads"].append("tiny.cross_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = """
import time, torch
from edgebench import harness
man = harness.load_manifest()
for trace in (False, True):
    out = harness.run_cell(man, "tiny.cross_small", 5, 0.2, trace,
                           torch.device("cpu"), time.perf_counter_ns())
    assert out["correct"], out
    print(sorted(out["metrics"]))
"""
    res = _child(code, tmp_path, extra_path=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0] == str(["queries_per_s", "setup_s"])
    assert lines[1] == str(["batches_run"])
    after = _digest(tmp_path / "edgebench")
    assert {k: v for k, v in after.items() if k in before} == before


ORACLE_DEPLOYMENT = '''
from dataclasses import dataclass

from ..deploy import Deployment


@dataclass
class OracleDeployment(Deployment):
    oracle: object = None

    def close(self):
        self.oracle = None
        super().close()


def deploy(config, net, device):
    from repro_torch.core import Graph, Partition
    from repro_torch.core.oracle import DistanceOracle
    g = Graph(net.indptr, net.indices, net.weights)
    part = Partition(net.assignment, net.num_districts)
    return OracleDeployment(device, oracle=DistanceOracle.build(
        g, part, builder=config["builder"], device=device))
'''

SAME_DRIVER = '''
import time

import numpy as np

from . import Measured


def drive(dep, net, traffic, seconds, rng, tracer):
    order, start = net.district_members()
    batch = int(traffic["batch"])
    d = rng.integers(0, net.num_districts, batch)
    size = start[d + 1] - start[d]
    ss, ts = (order[start[d] + (rng.random(batch) * size).astype(np.int64)]
              for _ in range(2))
    dep.oracle.query_many(ss, ts)
    dep.sync()
    kept = []
    tracer.start()
    t0 = time.perf_counter_ns()
    while not kept or time.perf_counter_ns() - t0 < seconds * 1e9:
        with tracer.phase("program: query_many"):
            kept.append(dep.oracle.query_many(ss, ts))
    t1 = time.perf_counter_ns()
    tracer.stop()
    n = len(kept)
    return Measured(window_s=(t1 - t0) / 1e9, attempted=n * batch,
                    queries=n * batch, batches=n,
                    checks=[(np.tile(ss, n), np.tile(ts, n),
                             np.concatenate(kept))])
'''

SAME_JUDGE = '''
import numpy as np
import torch

from .. import reference


def judge(net, checks, device, control):
    checked = wrong = 0
    gap = 0.0
    for ss, ts, got in checks:
        src, col = np.unique(ss, return_inverse=True)
        rows = reference.distances_from(net, src, device=device)
        want = rows[torch.as_tensor(ts), torch.as_tensor(col)].cpu().numpy()
        res = reference.compare(got, want)
        checked += res["checked"]
        wrong += res["wrong"]
        gap = max(gap, res["max_gap"])
    return {"checked": checked, "wrong_answers": wrong, "max_gap": gap}
'''


def test_a_new_deployment_takes_only_new_files_and_a_manifest_entry(
        tmp_path):
    """A deployment kind, a driver and a judge the tree does not have,
    with a configuration, a mix and a metric, as new files only."""
    shutil.copytree(ROOT / "edgebench", tmp_path / "edgebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "edgebench")
    bench = tmp_path / "edgebench"
    (bench / "deployments" / "oracle.py").write_text(ORACLE_DEPLOYMENT)
    (bench / "drivers" / "same_loop.py").write_text(SAME_DRIVER)
    (bench / "judges" / "same.py").write_text(SAME_JUDGE)
    (bench / "traffic" / "same_small.json").write_text(json.dumps(
        {"driver": "same_loop", "pairs": "same", "batch": 80}))
    (bench / "configs" / "tiny_oracle.json").write_text(json.dumps(
        {"name": "tiny_oracle", "deployment": "oracle",
         "builder": "reference",
         "network": {"grid": [2, 2], "district": [5, 4],
                     "border_links": 2, "weight_high": 15, "seed": 4}}))
    (bench / "metrics" / "oracle_batches.py").write_text(
        "def read(rec):\n    return rec.measured.batches\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_oracle", "source": "a test",
                           "file": "edgebench/configs/tiny_oracle.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "tiny.same_small",
                             "config": "tiny_oracle",
                             "traffic": "same_small", "chips": 1,
                             "why": "a test"})
    man["per_layer"].append({"name": "oracle_batches", "unit": "batches",
                             "better": "higher", "source": "host_clock",
                             "layer": "a test", "moves": "queries_per_s",
                             "workloads": ["tiny.same_small"]})
    qps = next(m for m in man["end_to_end"] if m["name"] == "queries_per_s")
    qps["workloads"].append("tiny.same_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = """
import time, numpy as np, torch
from edgebench import harness
from repro_torch.core.oracle import DistanceOracle
man = harness.load_manifest()
def run(trace):
    return harness.run_cell(man, "tiny.same_small", 2**31 + 13, 0.2,
                            trace, torch.device("cpu"),
                            time.perf_counter_ns())
for trace in (False, True):
    out = run(trace)
    assert out["correct"], out
    assert out["checked"] >= 80, out
    print(sorted(out["metrics"]))
query_many = DistanceOracle.query_many
def altered(self, ss, ts):
    out = np.array(query_many(self, ss, ts))
    out[0] += 1
    return out
DistanceOracle.query_many = altered
out = run(False)
print(out["correct"], out["compared"]["wrong_answers"]["value"],
      out["compared"]["max_gap"]["value"])
"""
    res = _child(code, tmp_path, extra_path=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0] == str(["queries_per_s", "setup_s"])
    assert lines[1] == str(["oracle_batches"])
    correct, wrong, gap = lines[2].split()
    assert correct == "False" and int(wrong) >= 1 and float(gap) == 1.0
    after = _digest(tmp_path / "edgebench")
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("key,directory", [
    ("deployment", "deployments"), ("driver", "drivers"),
    ("pairs", "judges")])
def test_an_unknown_deployment_driver_or_pairs_fails_before_the_network(
        monkeypatch, key, directory):
    drawn = []
    monkeypatch.setattr(network, "continent",
                        lambda *a, **k: drawn.append(1))
    cfg, mix = tiny(CELLS[0])
    if key == "deployment":
        cfg[key] = "nowhere"
    else:
        mix[key] = "nowhere"
    with pytest.raises(LookupError) as err:
        harness.run_cell(MANIFEST, CELLS[0], 1, 0.1, False,
                         torch.device("cpu"), time.perf_counter_ns(),
                         config=cfg, traffic=mix)
    assert str(harness.BENCH / directory) in str(err.value)
    assert "nowhere.py" in str(err.value)
    assert drawn == []


def test_every_deployment_and_judge_resolves_to_a_file():
    from edgebench.deploy import DEPLOYMENTS
    for c in MANIFEST["configs"]:
        kind = harness.load_config(MANIFEST, c["name"])["deployment"]
        assert kind in DEPLOYMENTS
        assert (DEPLOYMENTS.directory / f"{kind}.py").is_file()
    for cell in CELLS:
        _, _, mix = harness.resolve(MANIFEST, cell)
        assert mix["pairs"] in harness.JUDGES
        assert (harness.JUDGES.directory / f"{mix['pairs']}.py").is_file()
        assert (harness.DRIVERS.directory / f"{mix['driver']}.py").is_file()
