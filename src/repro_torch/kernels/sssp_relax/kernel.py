"""The blocked Floyd–Warshall APSP on the card.

``floyd_warshall`` wraps ``csrc/floyd_warshall.cu``, which replaces the
JAX package's Pallas kernel ``floyd_warshall_pallas``
(``src/repro/kernels/sssp_relax/kernel.py``): exact all-pairs shortest
distances of one dense (n, n) float32 adjacency (non-negative weights,
+inf for a missing edge), diagonal 0. The wrapper makes the working copy
``min(adj, diag 0)`` and one ``ctypes`` call closes it in place with
3·⌈n/64⌉ launches on the current stream (phase 1, 2 and 3 per pivot
block; one when n <= 64); ragged n is masked in the kernel, so nothing
is padded.

On a CUDA tensor the wrapper launches the kernel (building it on first
use) or raises; on a CPU tensor it runs the plain version of ``ref.py``.
There is no other path. ``LAUNCHES["floyd_warshall"]`` counts the CUDA
launches of the calls that launched (``launches_per_call(n)`` each), the
unit of the other kernels' counters.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build
from .ref import floyd_warshall_ref, with_zero_diagonal

SOURCE = Path(__file__).resolve().parent / "csrc" / "floyd_warshall.cu"
# the kernel's tile edge (kTile in the source)
TILE = 64

# CUDA launches since the last reset (plain-version calls on the CPU are
# not launches)
LAUNCHES = {"floyd_warshall": 0}


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.repro_floyd_warshall.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.repro_floyd_warshall.argtypes = [p, i64, p]
        lib.repro_floyd_warshall.restype = ctypes.c_int
    return lib


def launches_per_call(n: int) -> int:
    """CUDA launches that one call makes for an (n, n) matrix."""
    nb = -(-n // TILE)
    return 1 if nb <= 1 else 3 * nb


def floyd_warshall(adj: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest distances of ``adj`` (n, n) float32, in a new
    tensor: D[i, j] = min over paths, D[i, i] = 0."""
    if adj.dim() != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"floyd_warshall: adjacency must be square, got "
                         f"{tuple(adj.shape)}")
    if adj.dtype != torch.float32:
        raise ValueError("floyd_warshall: adjacency must be float32 "
                         "(ops.floyd_warshall widens other dtypes)")
    if adj.device.type == "cpu":
        return floyd_warshall_ref(adj)
    if adj.device.type != "cuda":
        raise ValueError(f"floyd_warshall: unsupported device {adj.device}")
    n = adj.shape[0]
    if n == 0:
        return adj.clone()
    fn = _lib().repro_floyd_warshall
    d = with_zero_diagonal(adj).contiguous()
    with torch.cuda.device(d.device):
        err = fn(d.data_ptr(), n,
                 torch.cuda.current_stream(d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"floyd_warshall kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["floyd_warshall"] += launches_per_call(n)
    return d
