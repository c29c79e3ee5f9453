"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything the
yardstick needs lives here and is frozen: the road-network generator
(``network``), the traffic generator (``workload``), the plain reference
(``reference``), the profiler reading and roofline arithmetic
(``devtrace``, ``roofline``). Configurations (``configs/<name>.json``),
traffic mixes (``traffic/<mix>.json``), metric readers
(``metrics/<metric>.py``), deployment kinds (``deployments/<kind>.py``,
named by a configuration's ``deployment``), drivers
(``drivers/<driver>.py``, named by a mix's ``driver``) and judges
(``judges/<pairs>.py``, named by a mix's ``pairs``) are files of their
own, found by name (``byfile``), so a new cell is new files and manifest
entries only.
"""
