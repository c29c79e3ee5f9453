"""Quantized label storage: uint16/int16 distance tables with an
explicit +inf sentinel.

Label-based distance oracles live or die on bytes-per-vertex (HCL,
arXiv 2311.11063): at continent scale the (n, q) border table and the
blocked district tables dominate the per-device footprint, and road
travel times are integer seconds (townscout's ``graph_to_csr`` clips /
ceils to uint16 seconds), so float32 wastes half the bits.  A
``QuantSpec`` maps finite distances ``d`` to integer codes
``round(d / scale)`` and +inf to a reserved **sentinel** (the dtype's
maximum value); the serving joins load the narrow codes, widen to
int32/float32 for the accumulate, and treat the sentinel as +inf
(``kernels/label_join/ops.py``).

Exactness: for integer-second weights every label distance is an
integer, so with ``scale == 1.0`` and ``max(d) < sentinel`` the
round-trip ``dequantize(quantize(d)) == d`` holds bit-for-bit (all
values are < 2^16 ≪ 2^24, exactly representable in float32) — the
quantized engines then serve answers bit-identical to the float32
engines (pinned in ``tests/test_quantize.py`` across every layout).
``QuantSpec.fit`` picks that lossless spec whenever the data admits it
and falls back to the smallest lossy scale otherwise; the documented
predicate ``is_lossless_for`` states exactly when the round-trip is
exact, so callers can refuse a lossy spec.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

INF = np.float32(np.inf)

# dtype registry for the ServingPolicy(label_dtype=...) knob
LABEL_DTYPES: dict[str, np.dtype] = {
    "float32": np.dtype(np.float32),
    "uint16": np.dtype(np.uint16),
    "int16": np.dtype(np.int16),
}


def dtype_name(dtype) -> str:
    """Canonical knob name of a storage dtype ('float32' | 'uint16' |
    'int16')."""
    dt = np.dtype(dtype)
    for name, cand in LABEL_DTYPES.items():
        if cand == dt:
            return name
    raise ValueError(f"unsupported label dtype {dt} "
                     f"(one of {tuple(LABEL_DTYPES)})")


def sentinel_of(dtype) -> int:
    """The +inf sentinel: the dtype's maximum value, reserved — finite
    codes live in [0, sentinel)."""
    return int(np.iinfo(np.dtype(dtype)).max)


@dataclass(frozen=True)
class QuantSpec:
    """How distances are stored in a narrow integer dtype.

    ``quantize`` maps finite ``d`` to ``round(d / scale)`` clipped to
    ``[0, sentinel - 1]`` and non-finite ``d`` to ``sentinel``;
    ``dequantize`` maps codes back to ``code * scale`` float32 with the
    sentinel becoming +inf.  ``lossless`` records whether the spec was
    fit to data it round-trips exactly (see ``is_lossless_for``).
    """

    scale: float = 1.0
    dtype: np.dtype = np.dtype(np.uint16)
    lossless: bool = True

    def __post_init__(self):
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        if self.dtype not in (np.dtype(np.uint16), np.dtype(np.int16)):
            raise ValueError("QuantSpec dtype must be uint16 or int16, "
                             f"got {self.dtype}")
        if not (np.isfinite(self.scale) and self.scale > 0):
            raise ValueError(f"scale must be finite and > 0, "
                             f"got {self.scale}")

    @property
    def sentinel(self) -> int:
        return sentinel_of(self.dtype)

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @classmethod
    def fit(cls, values: np.ndarray, dtype=np.uint16) -> "QuantSpec":
        """Smallest-scale spec covering ``values``: ``scale = 1`` when
        the data is integral and fits below the sentinel (the lossless
        integer-seconds case), else the minimal scale that spans the
        finite range (lossy — ``lossless`` is False so callers can
        refuse)."""
        dt = np.dtype(dtype)
        sent = sentinel_of(dt)
        v = np.asarray(values, dtype=np.float32)
        finite = v[np.isfinite(v)]
        if finite.size == 0:
            return cls(1.0, dt, lossless=True)
        vmax = float(finite.max())
        vmin = float(finite.min())
        if vmin < 0:
            raise ValueError("distances must be non-negative, "
                             f"got min {vmin}")
        spec = cls(1.0, dt, lossless=True)
        if vmax < sent and spec.is_lossless_for(finite):
            return spec
        scale = vmax / (sent - 1) if vmax > 0 else 1.0
        return cls(scale, dt, lossless=False)

    def quantize(self, values: np.ndarray) -> np.ndarray:
        """float32 distances -> integer codes (+inf/NaN -> sentinel)."""
        v = np.asarray(values, dtype=np.float32)
        finite = np.isfinite(v)
        codes = np.full(v.shape, self.sentinel, dtype=self.dtype)
        scaled = np.rint(v[finite] / np.float32(self.scale))
        codes[finite] = np.clip(scaled, 0, self.sentinel - 1) \
            .astype(self.dtype)
        return codes

    def dequantize(self, codes: np.ndarray) -> np.ndarray:
        """Integer codes -> float32 distances (sentinel -> +inf)."""
        c = np.asarray(codes)
        out = c.astype(np.float32) * np.float32(self.scale)
        out[c == self.dtype.type(self.sentinel)] = INF
        return out

    def is_lossless_for(self, values: np.ndarray) -> bool:
        """The documented round-trip predicate: True iff
        ``dequantize(quantize(values))`` reproduces ``values``
        bit-for-bit (finite entries land on exact multiples of
        ``scale`` below the sentinel; +inf maps through the sentinel
        and back).  This is the condition under which the quantized
        engines are bit-identical to float32 serving."""
        v = np.asarray(values, dtype=np.float32)
        return bool(np.array_equal(self.dequantize(self.quantize(v)), v,
                                   equal_nan=False))

    def key(self) -> tuple[int, float]:
        """(sentinel, scale) — the static pair the jitted device joins
        are specialized on (``kernels/label_join/ops.py``)."""
        return (self.sentinel, float(self.scale))


def fit_label_spec(btable: np.ndarray, locals_=None,
                   dtype=np.uint16) -> QuantSpec:
    """Fit one spec across a serving snapshot: the border table B plus
    every district's dense hub-aligned table must share a scale (they
    are packed into one combined-width layout).  Returns a lossless
    spec when every table round-trips, else the minimal lossy spec over
    the global finite max."""
    spec = QuantSpec.fit(btable, dtype=dtype)
    tables = [btable]
    if locals_:
        tables += [li.dense_table() for li in locals_]
    vmax = 0.0
    lossless = True
    for t in tables:
        finite = t[np.isfinite(t)]
        if finite.size:
            vmax = max(vmax, float(finite.max()))
        lossless = lossless and spec.is_lossless_for(t)
    if lossless and vmax < spec.sentinel:
        return spec
    sent = sentinel_of(dtype)
    scale = vmax / (sent - 1) if vmax > 0 else 1.0
    return QuantSpec(scale, np.dtype(dtype), lossless=False)
