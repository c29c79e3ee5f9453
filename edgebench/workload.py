"""The benchmark's traffic, made from the seed (frozen).

One general generator reads a traffic mix's parameters (a JSON file under
``traffic/``) and draws its queries. ``cross_pairs``: (s, t) in different
districts, the district pair uniform, each vertex uniform in its
district.
"""
from __future__ import annotations

import numpy as np

from .network import RoadNetwork


def cross_pairs(net: RoadNetwork, rng: np.random.Generator, size: int
                ) -> tuple[np.ndarray, np.ndarray]:
    m = net.num_districts
    if m < 2:
        raise ValueError("cross-district pairs need two districts")
    order, start = net.district_members()
    ds = rng.integers(0, m, size)
    dt = rng.integers(0, m - 1, size)
    dt = dt + (dt >= ds)
    return _member(order, start, ds, rng), _member(order, start, dt, rng)


def _member(order: np.ndarray, start: np.ndarray, districts: np.ndarray,
            rng: np.random.Generator) -> np.ndarray:
    """One uniform vertex of each given district."""
    d = np.asarray(districts, dtype=np.int64)
    size = start[d + 1] - start[d]
    return order[start[d] + (rng.random(len(d)) * size).astype(np.int64)]
