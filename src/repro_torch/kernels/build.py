"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled on first use with ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library lands in ``build/repro_torch_kernels/`` at the root of the
checkout, named after a digest of the source and the flags, so an edit
rebuilds and an unchanged source is reused. ``build`` starts one
``nvcc`` per source, all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# no fast-math and no fused multiply-add: the kernels promise the same
# IEEE float operations as their plain versions, bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# source path → loaded library (the digest is computed once per source)
_LOADED: dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}-{digest[:12]}.so"


def build(sources: list[Path]) -> dict[Path, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns each built source's compiler log (``-Xptxas -v`` prints
    registers and spills); raises with the log when one fails."""
    nvcc = None
    procs = {}
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            continue
        if nvcc is None:
            nvcc = nvcc_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    failed = []
    for src, (lib, tmp, proc) in procs.items():
        logs[src] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{logs[src]}")
        else:
            os.replace(tmp, lib)        # atomic: readers never see a part
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed."""
    if source not in _LOADED:
        build([source])
        _LOADED[source] = ctypes.CDLL(str(library_path(source)))
    return _LOADED[source]
