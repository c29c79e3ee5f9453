"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 edgebench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

The last line of standard output is the run's JSON result; the numbers
judged are also the last lines of standard error, each beside its limit.
Exits 2 without a result where the machine lacks the CUDA devices the
cell asks for.
"""
import time

START_NS = time.perf_counter_ns()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``edgebench``) and its ``src`` (for the
# program), never this directory: its module names would shadow others
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "build" / "edgebench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

from edgebench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], START_NS))
