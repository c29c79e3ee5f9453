"""Set a configuration up in the program, through its public entry points.

The only module of the benchmark that imports ``repro_torch``. A
configuration's ``deployment`` key picks how. ``center``: the network
written as a gzip DIMACS ``.gr`` file into the run's ``TMPDIR``, read back
by ``ingest.load_gr_csr``, and B built by
``edge.ComputingCenter(builder=...)`` on the card.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch

from .network import RoadNetwork, write_gr


@dataclass
class Deployment:
    device: torch.device
    center: object = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Drop the program's state and its device memory."""
        self.center = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def deploy(config: dict, net: RoadNetwork, device: torch.device
           ) -> Deployment:
    kind = config["deployment"]
    if kind != "center":
        raise ValueError(f"unknown deployment {kind!r}")
    from repro_torch.core import Partition
    from repro_torch.edge import ComputingCenter
    from repro_torch.ingest import load_gr_csr
    part = Partition(net.assignment, net.num_districts)
    fd, name = tempfile.mkstemp(suffix=".gr.gz", prefix="edgebench-")
    os.close(fd)
    path = Path(name)
    try:
        write_gr(net, path, f"edgebench {config['name']}")
        g = load_gr_csr(str(path)).to_graph()
    finally:
        path.unlink(missing_ok=True)
    center = ComputingCenter(g, part, builder=config["builder"],
                             device=device)
    center.rebuild()
    return Deployment(device, center=center)
