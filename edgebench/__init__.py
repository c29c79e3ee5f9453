"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything the
yardstick needs lives here and is frozen: the road-network generator
(``network``), the traffic generator (``workload``), the plain reference
(``reference``), the profiler reading and roofline arithmetic
(``devtrace``, ``roofline``). Configurations (``configs/<name>.json``),
traffic mixes (``traffic/<mix>.json``) and metric readers
(``metrics/<metric>.py``) are files of their own, found by name.
"""
