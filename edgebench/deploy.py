"""Set a configuration up in the program, through its public entry points.

A configuration's ``deployment`` key names a file,
``deployments/<kind>.py``, whose ``deploy(config, net, device)`` sets the
program up and returns a ``Deployment`` that holds its entry points.
Those files are the only modules of the benchmark that import
``repro_torch``; ``DEPLOYMENTS`` maps each kind to its ``deploy``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .byfile import ByFile


@dataclass
class Deployment:
    """The program set up on ``device``. A kind subclasses it in its own
    file, adds its entry points as fields and drops them in ``close``."""
    device: torch.device

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Drop the program's state and its device memory."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


# below ``Deployment``: the kinds' files import it
DEPLOYMENTS = ByFile(f"{__package__}.deployments", "deploy")
