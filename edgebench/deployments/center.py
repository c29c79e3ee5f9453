"""``center``: the computing center alone. The network written as a gzip
DIMACS ``.gr`` file into the run's ``TMPDIR``, read back by
``ingest.load_gr_csr``, and B built by ``edge.ComputingCenter(builder=...)``
on the card; the entry point is the deployment's ``center``."""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch

from ..deploy import Deployment
from ..network import RoadNetwork, write_gr


@dataclass
class CenterDeployment(Deployment):
    center: object = None

    def close(self) -> None:
        self.center = None
        super().close()


def deploy(config: dict, net: RoadNetwork, device: torch.device
           ) -> CenterDeployment:
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
    return CenterDeployment(device, center=center)
