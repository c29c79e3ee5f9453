"""The ways a traffic mix drives the program, one file each, named by the
mix's ``driver`` key: ``<driver>.py`` defines ``drive(dep, net, traffic,
seconds, rng, tracer) -> Measured``.

A driver warms up every shape its mix uses, measures for ``seconds``
(the batch in flight when the time is up completes, and its time counts),
and returns what it measured and the answers to check. It reaches the
program only through the ``deploy.Deployment``'s entry points.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..byfile import ByFile


# the window's batches whose answers are all kept for the check: the
# first four, then every power of two
def _keep_whole(i: int) -> bool:
    return i < 4 or (i & (i - 1)) == 0


# lanes kept from every other batch, for the check
SAMPLE_LANES = 64


@dataclass
class Measured:
    """What a driver measured in its window, and what it answered."""
    window_s: float
    attempted: int
    failed: int = 0
    queries: int = 0
    batches: int = 0
    join_least_bytes: int = 0
    # the answers to check: (ss, ts, answers)
    checks: list[tuple] = field(default_factory=list)


# below what the drivers' files import from here
DRIVERS = ByFile(__name__, "drive")
