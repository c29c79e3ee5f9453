"""Traffic-shape generators shared by the §5 discrete-event simulator
and the open-loop load harness (``serve.loadgen``). A copy of the JAX
package's ``repro.edge.traffic`` (NumPy only), kept in the port so
that it imports nothing of that package.

A shape is a relative arrival-rate profile λ(t)/λ̄ over the horizon
(mean ≈ 1, so the total offered load is the shape-independent knob):

* ``uniform`` — homogeneous Poisson: conditioned on the arrival count,
  times are iid uniform over the horizon (the classic order-statistics
  property), which is exactly what ``make_trace`` always generated.
* ``diurnal`` — a day compressed into the horizon: a sinusoid with a
  night trough at the ends and a midday peak (``diurnal_amp``).
* ``flash_crowd`` — uniform baseline plus a burst window in which the
  rate is multiplied ``flash_mult``× (a flash crowd / incident spike:
  ``flash_start_frac`` .. ``flash_start_frac + flash_frac`` of the
  horizon).

``arrival_times`` samples a *given number* of arrivals from the shape
via inverse-CDF on the cumulative rate; ``poisson_count`` draws the
open-loop arrival count for N clients at a per-client rate, so the two
together generate a nonhomogeneous Poisson arrival process conditioned
on its own count.
"""
from __future__ import annotations

import numpy as np

TRAFFIC_SHAPES = ("uniform", "diurnal", "flash_crowd")

DIURNAL_AMP = 0.75
FLASH_MULT = 8.0
FLASH_START_FRAC = 0.45
FLASH_FRAC = 0.10


def rate_profile(shape: str, frac: np.ndarray, *,
                 diurnal_amp: float = DIURNAL_AMP,
                 flash_mult: float = FLASH_MULT,
                 flash_start_frac: float = FLASH_START_FRAC,
                 flash_frac: float = FLASH_FRAC) -> np.ndarray:
    """Relative arrival rate λ(t)/λ̄ at horizon fractions ``frac`` ∈
    [0, 1]; every shape integrates to ≈ 1 over the horizon."""
    frac = np.asarray(frac, dtype=np.float64)
    if shape == "uniform":
        return np.ones_like(frac)
    if shape == "diurnal":
        # trough at frac 0 and 1 (night), peak at 0.5 (midday)
        return 1.0 + diurnal_amp * np.sin(2.0 * np.pi * frac - np.pi / 2)
    if shape == "flash_crowd":
        in_burst = ((frac >= flash_start_frac)
                    & (frac < flash_start_frac + flash_frac))
        base = np.ones_like(frac)
        rate = np.where(in_burst, flash_mult, base)
        return rate / (1.0 + (flash_mult - 1.0) * flash_frac)
    raise ValueError(f"shape must be one of {TRAFFIC_SHAPES}, got "
                     f"{shape!r}")


def arrival_times(num: int, horizon_ms: float, shape: str = "uniform",
                  rng: np.random.Generator | None = None, seed: int = 0,
                  grid: int = 2048, **shape_kw) -> np.ndarray:
    """``num`` sorted arrival times (ms) over ``[0, horizon_ms)`` drawn
    from the shape's rate profile (inverse-CDF of the cumulative rate on
    a ``grid``-point lattice — exact for ``uniform``, a dense piecewise-
    linear approximation otherwise)."""
    if rng is None:
        rng = np.random.default_rng(seed)
    if num <= 0:
        return np.empty(0, dtype=np.float64)
    u = rng.uniform(0.0, 1.0, size=num)
    if shape == "uniform":
        return np.sort(u) * horizon_ms
    frac = np.linspace(0.0, 1.0, grid)
    rate = rate_profile(shape, frac, **shape_kw)
    cdf = np.concatenate([[0.0], np.cumsum((rate[1:] + rate[:-1]) * 0.5)])
    cdf /= cdf[-1]
    return np.sort(np.interp(u, cdf, frac)) * horizon_ms


def poisson_count(num_clients: int, per_client_qps: float,
                  horizon_ms: float,
                  rng: np.random.Generator | None = None,
                  seed: int = 0) -> int:
    """Open-loop arrival count: Poisson with mean
    ``num_clients * per_client_qps * horizon``, independent of the
    service (clients do not wait for answers before re-issuing)."""
    if rng is None:
        rng = np.random.default_rng(seed)
    mean = float(num_clients) * float(per_client_qps) * horizon_ms / 1e3
    return int(rng.poisson(mean))
