"""The min-plus (tropical) products on the card.

The wrappers of ``csrc/minplus.cu``, whose kernels replace the JAX
package's Pallas kernels ``minplus_pallas`` and ``relax_pallas``
(``src/repro/kernels/minplus/kernel.py``). They take an optional
leading batch (district) axis:

* ``minplus(a, b)``: C = A ⊗ B, a (..., m, k), b (..., k, n);
* ``minplus_kmajor(a_t, b)``: the same product with A given k-major,
  a_t (..., k, m) — stage C's operand as stage A leaves it, so no
  transpose is copied. k ≤ ``KMAJOR_MAX_K`` runs the k-major kernel;
  a deeper k runs ``minplus`` on the transposed copy;
* ``closure(d, steps, check_from)``: up to ``steps`` squarings
  D ← D ⊗ D of one (q, q) matrix in one launch (q ≤ ``CLOSURE_MAX_Q``),
  stopping from squaring ``check_from`` on at the first that returns its
  input; returns D and that squaring's index (``ref.squarings``'s rule);
* ``relax(d, a, occupancy=None)``: D' = min(D, D ⊗ A), d (..., s, v),
  a (..., v, v), one fused Bellman-Ford sweep, written out of place.
  ``occupancy = relax_occupancy(a)`` marks which tiles of A (``KTILE``
  k rows × ``STRIP`` columns) hold a finite entry; the kernel (and the
  plain version) never reads a tile it marks empty, which changes no
  bit: an empty tile's terms are all +inf. Computed once per matrix and
  passed to every sweep over it.

Inputs are float32 distances: non-negative or +inf, never NaN or −inf
(the ops layer widens other dtypes). On a CUDA tensor the wrapper
launches the kernel (building it on first use) or raises; on a CPU
tensor it runs the plain version of ``ref.py``. There is no other path.
``LAUNCHES`` counts kernel launches per kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build
from .ref import (KTILE, STRIP, closure_ref, minplus_kmajor_ref, minplus_ref,
                  relax_occupancy, relax_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "minplus.cu"
# a measuring kernel, not a port of a TPU kernel: the card's sustained
# (min, +) term rate in registers, the ceiling of the operations bound
PEAK_SOURCE = SOURCE.with_name("minplus_peak.cu")

# kernel launches since the last reset, per kernel (plain-version calls
# on the CPU are not launches)
LAUNCHES = {"minplus": 0, "minplus_closure": 0, "minplus_kmajor": 0,
            "relax": 0}

_MAX_BATCH = 65535                      # gridDim.z
# the fused closure holds two (q, q) matrices in each block's shared
# memory (kClosureMaxQ in csrc/minplus.cu, whose entry refuses a larger
# q), at most 32 squarings (kClosureMaxSteps)
CLOSURE_MAX_Q = 160
CLOSURE_MAX_STEPS = 32
# the k-major kernel keeps k x 4 B values in registers
KMAJOR_MAX_K = 32


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.repro_minplus.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.repro_minplus.argtypes = [p, p, p, i64, i64, i64, i64, p]
        lib.repro_minplus.restype = ctypes.c_int
        lib.repro_relax.argtypes = [p, p, p, p, i64, i64, i64, p]
        lib.repro_relax.restype = ctypes.c_int
        lib.repro_minplus_kmajor.argtypes = [p, p, p, i64, i64, i64, i64, p]
        lib.repro_minplus_kmajor.restype = ctypes.c_int
        i32 = ctypes.c_int
        lib.repro_minplus_closure.argtypes = [p, p, i32, i32, i32, p, p]
        lib.repro_minplus_closure.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    if x.device != y.device:
        raise ValueError(f"{name}: operands must share a device")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"{name}: operands must be float32 (ops.{name} "
                         "widens other dtypes)")
    if x.dim() not in (2, 3) or y.dim() != x.dim() \
            or x.shape[:-2] != y.shape[:-2]:
        raise ValueError(f"{name}: operands must be 2-D, or 3-D with one "
                         f"batch size, got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")


def _launch(name: str, fn, out: torch.Tensor, *args) -> None:
    dev = out.device
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _cuda_operands(name: str, *xs: torch.Tensor) -> None:
    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for i, x in enumerate(xs):
        if not x.is_contiguous():
            raise ValueError(f"{name}: operand {i} must be contiguous")
    batch = xs[0].shape[0] if xs[0].dim() == 3 else 1
    if batch > _MAX_BATCH:
        raise ValueError(f"{name}: batch {batch} exceeds {_MAX_BATCH}")


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[..., i, j] = min_k A[..., i, k] + B[..., k, j], float32."""
    _check("minplus", a, b)
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"minplus: inner sizes differ, {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.device.type == "cpu":
        return minplus_ref(a, b)
    _cuda_operands("minplus", a, b)
    fn = _lib().repro_minplus
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    out = torch.empty((*a.shape[:-1], n), dtype=torch.float32,
                      device=a.device)
    if out.numel():
        batch = a.shape[0] if a.dim() == 3 else 1
        _launch("minplus", fn, out, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), batch, m, k, n)
    return out


def minplus_kmajor(a_t: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[..., i, j] = min_k A_t[..., k, i] + B[..., k, j], float32: the
    product of ``a_t.transpose(-1, -2)`` and ``b``, reading A k-major."""
    _check("minplus_kmajor", a_t, b)
    if a_t.shape[-2] != b.shape[-2]:
        raise ValueError(f"minplus_kmajor: depths differ, {tuple(a_t.shape)} "
                         f"and {tuple(b.shape)}")
    if a_t.device.type == "cpu":
        return minplus_kmajor_ref(a_t, b)
    _cuda_operands("minplus_kmajor", a_t, b)
    k, m = a_t.shape[-2], a_t.shape[-1]
    if k > KMAJOR_MAX_K:
        return minplus(a_t.transpose(-1, -2).contiguous(), b)
    fn = _lib().repro_minplus_kmajor
    n = b.shape[-1]
    out = torch.empty((*a_t.shape[:-2], m, n), dtype=torch.float32,
                      device=a_t.device)
    if out.numel():
        batch = a_t.shape[0] if a_t.dim() == 3 else 1
        _launch("minplus_kmajor", fn, out, a_t.data_ptr(), b.data_ptr(),
                out.data_ptr(), batch, m, k, n)
    return out


def closure(d: torch.Tensor, steps: int, check_from: int
            ) -> tuple[torch.Tensor, torch.Tensor | int]:
    """Up to ``steps`` squarings D ← D ⊗ D of a (q, q) float32 ``d``,
    stopping from squaring ``check_from`` on at the first that returns
    its input. Returns the result (a new tensor) and the index of that
    squaring, else ``steps`` (``ref.squarings``): on the card a 0-d
    int32 tensor, which ``int()`` reads with one host copy; on the CPU
    an int. One kernel launch for q ≤ ``CLOSURE_MAX_Q``."""
    if d.dtype != torch.float32 or d.dim() != 2 \
            or d.shape[0] != d.shape[1] or d.shape[0] == 0:
        raise ValueError("closure: d must be one non-empty square float32 "
                         f"matrix, got {d.dtype} {tuple(d.shape)}")
    if not 0 <= steps <= CLOSURE_MAX_STEPS or check_from < 0:
        raise ValueError(f"closure: steps must be in [0, {CLOSURE_MAX_STEPS}]"
                         f" and check_from >= 0, got {steps}, {check_from}")
    if d.device.type == "cpu":
        return closure_ref(d, steps, check_from)
    _cuda_operands("closure", d)
    q = d.shape[0]
    if q > CLOSURE_MAX_Q:
        raise ValueError(f"closure: q = {q} exceeds {CLOSURE_MAX_Q} (the "
                         "kernel's cap); ops.closure_squarings runs minplus "
                         "there")
    fn = _lib().repro_minplus_closure
    out = torch.empty_like(d)
    depth = torch.empty((), dtype=torch.int32, device=d.device)
    _launch("minplus_closure", fn, out, d.data_ptr(), out.data_ptr(), q,
            steps, min(check_from, steps), depth.data_ptr())
    return out, depth


def relax(d: torch.Tensor, a: torch.Tensor,
          occupancy: torch.Tensor | None = None) -> torch.Tensor:
    """D' = min(D, D ⊗ A), float32, in a new tensor; ``occupancy`` is
    ``relax_occupancy(a)`` or None (every tile read)."""
    _check("relax", d, a)
    v = d.shape[-1]
    if a.shape[-2:] != (v, v):
        raise ValueError(f"relax: adjacency must be ({v}, {v}), got "
                         f"{tuple(a.shape)}")
    if occupancy is not None:
        want = (*a.shape[:-2], -(-v // STRIP), -(-v // KTILE))
        if occupancy.dtype != torch.uint8 \
                or tuple(occupancy.shape) != want \
                or occupancy.device != a.device:
            raise ValueError(f"relax: occupancy must be uint8 {want} on "
                             f"{a.device} (relax_occupancy(a)), got "
                             f"{occupancy.dtype} {tuple(occupancy.shape)}")
    if d.device.type == "cpu":
        return relax_ref(d, a, occupancy)
    _cuda_operands("relax", d, a,
                   *(() if occupancy is None else (occupancy,)))
    fn = _lib().repro_relax
    out = torch.empty(d.shape, dtype=torch.float32, device=d.device)
    if out.numel():
        batch = d.shape[0] if d.dim() == 3 else 1
        _launch("relax", fn, out, d.data_ptr(), a.data_ptr(),
                0 if occupancy is None else occupancy.data_ptr(),
                out.data_ptr(), batch, d.shape[-2], v)
    return out
