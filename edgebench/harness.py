"""Run one cell of ``BENCHMARK.json`` once and print its result line.

The cell names a configuration (its file is named in the manifest), a
traffic mix (``traffic/<mix>.json``) and, through the manifest's metric
entries, the metrics it reports (``metrics/<metric>.py``, each a
``read(record)`` that returns a number, or None where it finds nothing to
read). The configuration's ``deployment`` names the file that sets it up
in the program (``deployments/<kind>.py``), the mix's ``driver`` the file
that drives it (``drivers/<driver>.py``) and its ``pairs`` the file that
judges the answers (``judges/<pairs>.py``). The flow:

1. the three files are found (an unknown name fails here); the road
   network is drawn from its configuration's own ``seed`` (a deployment
   has one road map), the traffic from ``--seed``;
2. the configuration is set up in the program (``deploy``) and the mix's
   driver warms up every shape it uses: ``setup_s`` ends there;
3. the driver measures for ``--seconds`` (with ``--trace 1`` under the
   profiler, the host phases annotated in the same trace);
4. the device's peak memory is read and the program's state freed;
5. the judge works the answers out again with the plain reference;
6. one JSON line is printed, the numbers judged last, and beside their
   limits on standard error too.

``control`` puts the reference computed in bfloat16 in the program's
place (the lower precision a later change could be tempted by); it must
come out not correct. The benchmark's own runs never set it.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import network
from .deploy import DEPLOYMENTS
from .devtrace import DeviceTrace, Tracer
from .drivers import DRIVERS, Measured
from .judges import JUDGES

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# every limit: the answers are exact (integer weights, float32 sums)
LIMITS = {"wrong_answers": 0, "max_gap": 0.0, "unanswered": 0}
CONTROLS = ("bf16",)


@dataclass
class Record:
    """What a metric reader reads."""
    config: dict
    traffic: dict
    setup_s: float
    measured: Measured
    trace: DeviceTrace | None
    device_kind: str


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    entry = {c["name"]: c for c in manifest["configs"]}[name]
    return json.loads((root / entry["file"]).read_text())


def load_traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def resolve(manifest: dict, workload: str, root: Path = ROOT
            ) -> tuple[dict, dict, dict]:
    """The cell's manifest entry, its configuration and its mix."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    return (cell, load_config(manifest, cell["config"], root),
            load_traffic(cell["traffic"]))


def metric_entries(manifest: dict, workload: str, trace: bool) -> list:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind]
            if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    """``metrics/<name>.py``; for a split name such as ``a.b`` without a
    file of its own, the reader of ``a``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"edgebench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(pairs: str, net: network.RoadNetwork, measured: Measured,
          device: torch.device, control: str | None) -> dict:
    """The verdict of ``judges/<pairs>.py`` on every kept answer, and the
    queries the driver left unanswered."""
    return dict(JUDGES[pairs](net, measured.checks, device, control),
                unanswered=measured.failed)


def run_cell(manifest: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, start_ns: int,
             control: str | None = None, config: dict | None = None,
             traffic: dict | None = None) -> dict:
    """One run of one cell; ``config`` / ``traffic`` replace the files'
    (tests run tiny ones on the CPU)."""
    _, cfg_file, mix_file = resolve(manifest, workload)
    config = dict(cfg_file if config is None else config)
    traffic = dict(mix_file if traffic is None else traffic)
    steps = {"imports_s": (time.perf_counter_ns() - start_ns) / 1e9}
    # each part by its file: an unknown name fails before the network
    deploy = DEPLOYMENTS[config["deployment"]]
    drive = DRIVERS[traffic["driver"]]
    JUDGES[traffic["pairs"]]
    t = time.perf_counter_ns()
    net = network.continent(**config["network"])
    rng = np.random.default_rng([seed, 1])
    steps["network_s"] = (time.perf_counter_ns() - t) / 1e9
    t = time.perf_counter_ns()
    dep = deploy(config, net, device)
    steps["deploy_s"] = (time.perf_counter_ns() - t) / 1e9
    tracer = Tracer(trace and device.type == "cuda")
    t = time.perf_counter_ns()
    measured = drive(dep, net, traffic, seconds, rng, tracer)
    steps["warmup_s"] = (tracer.ready_ns - t) / 1e9
    setup_s = (tracer.ready_ns - start_ns) / 1e9
    dev_trace = tracer.trace
    if device.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(device))
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    dep.close()
    del dep
    gc.collect()
    t = time.perf_counter_ns()
    verdict = judge(traffic["pairs"], net, measured, device, control)
    steps["reference_s"] = (time.perf_counter_ns() - t) / 1e9
    steps["window_s"] = measured.window_s
    print("edgebench: " + json.dumps(steps), file=sys.stderr)
    rec = Record(config, traffic, setup_s, measured, dev_trace, kind)
    metrics = {}
    for entry in metric_entries(manifest, workload, trace):
        value = load_reader(entry["name"])(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(
        verdict["checked"] > 0
        and all(verdict[k] <= lim for k, lim in LIMITS.items())),
        "attempted": measured.attempted, "failed": measured.failed,
        "metrics": metrics, "device": dev}
    if dev_trace is not None:
        dev["busy_s"] = dev_trace.busy_s
        dev["window_s"] = dev_trace.window_s
        out["breakdown"] = {"device_ops": dev_trace.top_ops(),
                            "idle_gaps": dev_trace.idle_by_phase()}
    out["checked"] = verdict["checked"]
    out["compared"] = {k: {"value": verdict[k], "limit": lim}
                       for k, lim in LIMITS.items()}
    return out


def main(argv: list[str], start_ns: int) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=CONTROLS, default=None,
                    help="judge the reference in this lower precision "
                    "instead of the program (must come out not correct)")
    args = ap.parse_args(argv)
    manifest = load_manifest()
    cell, _, _ = resolve(manifest, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"edgebench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(manifest, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), start_ns,
                   control=args.control)
    found = forbidden_modules()
    if found:
        print(f"edgebench: the run loaded {found}, which the port must "
              "not import", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
