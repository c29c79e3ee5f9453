"""What the traced run reads from the device and the host.

``Tracer`` records the measured window with ``torch.profiler``: the card's
activity (kernels, copies, fills) and, as ``record_function`` annotations
in the same trace and on the same clock, the window itself and the spans
of what the harness's host thread was doing (``phase``), so that each
stretch in which the card was idle can be named by the host work it waited
on. With tracing off, ``phase`` is a no-op and nothing is recorded.
"""
from __future__ import annotations

import time
from collections import Counter
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np

from . import roofline

WINDOW = "edgebench: window"


@dataclass
class DeviceTrace:
    """The card's activity inside one window: ``events`` holds
    ``(name, start_ns, end_ns)`` on the profiler's clock, clipped to the
    window; ``phases`` the host spans on the same clock."""
    events: list[tuple[str, int, int]]
    window_ns: tuple[int, int]
    phases: list[tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return roofline.busy_seconds([(s, e) for _, s, e in self.events])

    def seconds(self, match) -> float:
        """Device seconds of the events whose name ``match`` accepts."""
        return sum(e - s for name, s, e in self.events if match(name)) / 1e9

    def top_ops(self, k: int = 10) -> list[list]:
        total: Counter = Counter()
        for name, s, e in self.events:
            total[name[:120]] += e - s
        return [[name, ns / 1e9] for name, ns in total.most_common(k)]

    def idle_by_phase(self, k: int = 10) -> list[list]:
        """Idle seconds of the card inside the window, summed by the
        host phase that covered each idle stretch's midpoint."""
        lo, hi = self.window_ns
        ev = np.array([(s, e) for _, s, e in self.events], dtype=np.int64) \
            .reshape(-1, 2)
        ev = ev[np.argsort(ev[:, 0], kind="stable")]
        gaps = []
        cur = lo
        for s, e in ev:
            if s > cur:
                gaps.append((cur, min(s, hi)))
            cur = max(cur, e)
            if cur >= hi:
                break
        if cur < hi:
            gaps.append((cur, hi))
        ph = sorted(self.phases, key=lambda p: p[1])
        starts = np.array([p[1] for p in ph], dtype=np.int64)
        total: Counter = Counter()
        for a, b in gaps:
            if b <= a:
                continue
            mid = (a + b) // 2
            i = int(np.searchsorted(starts, mid, side="right")) - 1
            name = ph[i][0] if i >= 0 and ph[i][2] >= mid else "harness"
            total[name] += b - a
        return [[name, ns / 1e9] for name, ns in total.most_common(k)]


def read_profile(events) -> DeviceTrace:
    """The window, the host phases and the device events of a profiler's
    raw events (``kineto_results.events()``)."""
    from torch.autograd import DeviceType
    device, phases, window = [], [], None
    for e in events:
        span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(span)
        elif e.is_user_annotation():
            if span[0] == WINDOW:
                window = span[1:]
            else:
                phases.append(span)
    if window is None:
        raise RuntimeError("the profiler recorded no window annotation")
    lo, hi = window
    device = [(name, max(s, lo), min(e, hi)) for name, s, e in device
              if e > lo and s < hi]
    return DeviceTrace(device, window, phases)


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.ready_ns: int | None = None
        self.trace: DeviceTrace | None = None
        self._prof = None
        self._window = None

    def phase(self, name: str):
        if not self.enabled:
            return nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def start(self) -> None:
        """Start recording (the measured window starts right after);
        set-up ends here."""
        self.ready_ns = time.perf_counter_ns()
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        """End the window and read the trace."""
        if not self.enabled:
            return
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.trace = read_profile(self._prof.profiler.kineto_results
                                  .events())
