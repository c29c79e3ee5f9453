"""The blocked Floyd–Warshall APSP on the card.

``floyd_warshall`` wraps ``csrc/floyd_warshall.cu``, which replaces the
JAX package's Pallas kernel ``floyd_warshall_pallas``
(``src/repro/kernels/sssp_relax/kernel.py``): exact all-pairs shortest
distances of one dense (n, n) float32 adjacency (non-negative weights,
+inf for a missing edge), diagonal 0. The wrapper makes the working copy
``min(adj, diag 0) + 0.0`` (the + 0.0 turns a -0.0 weight into +0.0, so
the kernel's int32-pattern minimum sees none), padded with +inf to a
multiple of ``TILE`` (an absorbing pad, as the TPU wrapper's), and a
(``TILE``, n) scratch panel; one ``ctypes`` call closes the copy in
place with 3·⌈n/TILE⌉ launches on the current stream (phase 1, 2 and 3
per pivot block; one when n <= TILE).

On a CUDA tensor the wrapper launches the kernel (building it on first
use) or raises; on a CPU tensor it runs the plain version of ``ref.py``.
There is no other path. ``LAUNCHES["floyd_warshall"]`` counts the CUDA
launches of the calls that launched (``launches_per_call(n)`` each), the
unit of the other kernels' counters. ``phase_entry`` is the C entry that
launches one phase of one pivot block, for timing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build
from .ref import floyd_warshall_ref, with_zero_diagonal

SOURCE = Path(__file__).resolve().parent / "csrc" / "floyd_warshall.cu"
# the kernel's pivot block and tile edge (kTile in the source)
TILE = 128

# CUDA launches since the last reset (plain-version calls on the CPU are
# not launches)
LAUNCHES = {"floyd_warshall": 0}


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.repro_floyd_warshall.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.repro_floyd_warshall.argtypes = [p, p, i64, p]
        lib.repro_floyd_warshall.restype = i32
        lib.repro_floyd_warshall_phase.argtypes = [p, p, i64, i64, i32, p]
        lib.repro_floyd_warshall_phase.restype = i32
    return lib


def phase_entry():
    """``repro_floyd_warshall_phase(d, ct, n, kb, phase, stream)``: one
    phase (1, 2, 3) of pivot block ``kb`` on a padded working copy ``d``
    (n a multiple of ``TILE``) and scratch ``ct`` (``TILE``, n).
    Launches are not counted: it is for timing the phases apart."""
    return _lib().repro_floyd_warshall_phase


def working_copy(adj: torch.Tensor) -> torch.Tensor:
    """The kernel's input for ``adj`` (n, n) on its device: ``min(adj,
    diag 0) + 0.0``, padded with +inf to (N, N), N the next multiple of
    ``TILE``."""
    n = adj.shape[0]
    big = -(-n // TILE) * TILE
    d = with_zero_diagonal(adj).add_(0.0)
    if big == n:
        return d
    out = torch.full((big, big), float("inf"), dtype=torch.float32,
                     device=adj.device)
    out[:n, :n] = d
    return out


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
    d = working_copy(adj)
    big = d.shape[0]
    ct = torch.empty((TILE, big), dtype=torch.float32, device=d.device)
    with torch.cuda.device(d.device):
        err = fn(d.data_ptr(), ct.data_ptr(), big,
                 torch.cuda.current_stream(d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"floyd_warshall kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["floyd_warshall"] += launches_per_call(n)
    return d if big == n else d[:n, :n].contiguous()
