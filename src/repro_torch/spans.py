"""Named spans of the serving path in ``torch.profiler`` traces.

``span(name)`` marks a stretch of host work as a ``record_function``
range, in the profiler's own trace and on its clock, so that the card's
kernels and copies line up with the host work that issued or waited on
them. The spans exist for profiler traces only: the benchmark's traced
runs (``edgebench/``) read them, and so does anyone who profiles the
serving path. With no profiler recording, ``span`` returns one shared
no-op context manager after one read of the profiler's enabled flag;
an unconditional ``record_function`` would cost microseconds a call.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.profiler import record_function

_OFF = nullcontext()
_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records; otherwise the shared no-op."""
    if not _enabled():
        return _OFF
    return record_function(name)
