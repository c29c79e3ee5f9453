"""The fused gather + 2-hop label join on the card.

``gather_join`` is the one wrapper of ``csrc/label_join.cu``: for query
i it joins row ``rs[i]`` of ``s_table`` with row ``rt[i]`` of
``t_table`` — out[i] = min_j s + t, and with ``with_lb`` also the Local
Bound min_j s + min_j t — without materializing the gathered rows.
It replaces the JAX package's Pallas kernels ``join_pallas`` and
``join_lb_pallas`` (``src/repro/kernels/label_join/kernel.py``) together
with the XLA gathers in front of them.

``sharded_gather_join`` is the wrapper of the same file's sharded
kernel: one logical edge shard's half of the sharded serving join, over
its district block and a border table of another width, lanes of other
shards masked to +inf. It replaces ``join_pallas`` as the JAX package
runs it under ``shard_map`` (``src/repro/kernels/label_join/ops.py``,
``join_sharded_gathered`` and ``join_sharded_border_gathered``).

On a CUDA tensor a wrapper launches its kernel (building it on first
use) or raises; on a CPU tensor it runs the plain version of ``ref.py``.
There is no other path. The C entry picks the kernel's vector width
and lanes per query from the row pitch, the tables' base alignment and
the batch; ``join_layout`` reports its pick. The kernel takes float32
tables and 16-bit codes; the plain version also takes bfloat16 and
float16 tables, as the JAX package's ``join`` / ``join_with_bound``
do. ``LAUNCHES`` counts kernel launches per kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build
from .ref import (FLOAT_DTYPES, gather_join_ref, sharded_gather_join_ref,
                  storage16)

SOURCE = Path(__file__).resolve().parent / "csrc" / "label_join.cu"

# kernel launches since the last reset, per kernel (plain-version calls
# on the CPU are not launches)
LAUNCHES = {"label_join": 0, "label_join_lb": 0,
            "label_join_sharded": 0}

_DTYPE_FLOAT32, _DTYPE_UINT16, _DTYPE_INT16 = 0, 1, 2
_SENTINELS = {0xFFFF: _DTYPE_UINT16, 0x7FFF: _DTYPE_INT16}
_CODE_DTYPES = tuple(d for d in (torch.int16, getattr(torch, "uint16", None))
                     if d is not None)


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.repro_label_join
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [i32, i32, i32, p, p, i64, p, p, i64,
                       i64, i64, i32, ctypes.c_float, p, p, p]
        fn.restype = ctypes.c_int
        lib.repro_label_join_layout.argtypes = [i32, p, p, i64, i64, i32,
                                                i32, p]
        lib.repro_label_join_layout.restype = ctypes.c_int
        lib.repro_label_join_sharded.argtypes = [
            i32, p, i64, i64, p, i64, i64, p, i64, p, p, i64, i32,
            ctypes.c_float, p, p]
        lib.repro_label_join_sharded.restype = ctypes.c_int
        lib.repro_label_join_sharded_layout.argtypes = [
            i32, p, p, i64, i64, i64, p]
        lib.repro_label_join_sharded_layout.restype = ctypes.c_int
    return lib


def join_layout(s_table: torch.Tensor, t_table: torch.Tensor, q: int,
                lanes: int = 0, sms: int = 0) -> tuple[int, int]:
    """The (vector bytes, lanes a query) the kernel takes for ``q``
    queries over two contiguous CUDA tables of one width, as its C entry
    picks them: ``lanes`` if nonzero, on ``sms`` SMs (0: the tables'
    card's)."""
    code = _DTYPE_FLOAT32 if s_table.dtype == torch.float32 \
        else _DTYPE_INT16
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(s_table.device):
        err = _lib().repro_label_join_layout(
            code, s_table.data_ptr(), t_table.data_ptr(), s_table.shape[1],
            q, lanes, sms, out)
    if err != 0:
        raise ValueError(f"join_layout: no layout for {lanes} lanes "
                         f"(CUDA error {err})")
    return out[0], out[1]


def sharded_join_layout(block: torch.Tensor, border: torch.Tensor,
                        q: int) -> tuple[int, int]:
    """The (vector bytes, lanes a query) the sharded kernel takes for
    ``q`` queries over a CUDA district block and border table on their
    card, as its C entry picks them."""
    code = _DTYPE_FLOAT32 if block.dtype == torch.float32 else _DTYPE_INT16
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(block.device):
        err = _lib().repro_label_join_sharded_layout(
            code, block.data_ptr(), border.data_ptr(), block.shape[1],
            border.shape[1], q, out)
    if err != 0:
        raise ValueError(f"sharded_join_layout: no layout (CUDA error "
                         f"{err})")
    return out[0], out[1]


def _check_codes(tables, quant) -> None:
    if any(t.dtype not in _CODE_DTYPES for t in tables):
        raise ValueError("gather_join: code tables must hold 16-bit "
                         "integer codes")
    if quant[0] not in _SENTINELS:
        raise ValueError(f"gather_join: sentinel {quant[0]} is neither "
                         "the uint16 nor the int16 maximum")


def _check(s_table, rs, t_table, rt, quant, with_lb) -> None:
    dev = s_table.device
    if any(x.device != dev for x in (rs, t_table, rt)):
        raise ValueError("gather_join: tables and row ids must share a "
                         "device")
    if s_table.dim() != 2 or t_table.dim() != 2 \
            or s_table.shape[1] != t_table.shape[1]:
        raise ValueError("gather_join: tables must be 2-D with one width, "
                         f"got {tuple(s_table.shape)} and "
                         f"{tuple(t_table.shape)}")
    if rs.dim() != 1 or rs.shape != rt.shape \
            or rs.dtype != torch.int64 or rt.dtype != torch.int64:
        raise ValueError("gather_join: row ids must be two int64 vectors "
                         "of one length")
    if quant is None:
        if dev.type == "cpu":
            if s_table.dtype not in FLOAT_DTYPES \
                    or t_table.dtype not in FLOAT_DTYPES:
                raise ValueError("gather_join: float tables must be "
                                 "float32, bfloat16 or float16")
        elif s_table.dtype != torch.float32 \
                or t_table.dtype != torch.float32:
            raise ValueError("gather_join: float tables must be float32 on "
                             "the card; the plain version takes bfloat16 "
                             "and float16 on the CPU")
    else:
        _check_codes((s_table, t_table), quant)
        if with_lb:
            raise ValueError("gather_join: the Local Bound is computed on "
                             "float32 tables only")


def gather_join(s_table: torch.Tensor, rs: torch.Tensor,
                t_table: torch.Tensor, rt: torch.Tensor, *,
                quant: tuple[int, float] | None = None,
                with_lb: bool = False):
    """Fused gather + join. ``quant = (sentinel, scale)`` marks 16-bit
    code tables (uint16 when the sentinel is 65535, int16 when 32767;
    uint16 codes may be stored as int16 bits). Returns float32 ``out``
    of shape ``(Q,)`` (in ``s_table``'s dtype for bfloat16 or float16
    tables), or ``(out, lb)`` with ``with_lb``. Row ids must
    index their tables (the ops layer checks ids from the host)."""
    _check(s_table, rs, t_table, rt, quant, with_lb)
    dev = s_table.device
    if dev.type == "cpu":
        return gather_join_ref(s_table, rs, t_table, rt, quant=quant,
                               with_lb=with_lb)
    if dev.type != "cuda":
        raise ValueError(f"gather_join: unsupported device {dev}")
    for name, x in (("s_table", s_table), ("t_table", t_table),
                    ("rs", rs), ("rt", rt)):
        if not x.is_contiguous():
            raise ValueError(f"gather_join: {name} must be contiguous")
    q, w = rs.shape[0], s_table.shape[1]
    fn = _lib().repro_label_join if q else None
    out = torch.empty(q, dtype=torch.float32, device=dev)
    lb = torch.empty(q, dtype=torch.float32, device=dev) if with_lb else None
    if q:
        if quant is None:
            code, sentinel, scale = _DTYPE_FLOAT32, 0, 1.0
        else:
            sentinel, scale = quant
            code = _SENTINELS[sentinel]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(code, int(with_lb), 0,
                     storage16(s_table).data_ptr(), rs.data_ptr(),
                     s_table.shape[0],
                     storage16(t_table).data_ptr(), rt.data_ptr(),
                     t_table.shape[0], q, w, int(sentinel), float(scale),
                     out.data_ptr(), 0 if lb is None else lb.data_ptr(),
                     stream)
        if err != 0:
            raise RuntimeError(f"label_join kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES["label_join_lb" if with_lb else "label_join"] += 1
    return (out, lb) if with_lb else out


def _check_sharded(block, border, owner, rs, rt, quant) -> None:
    dev = block.device
    if any(x.device != dev for x in (border, owner, rs, rt)):
        raise ValueError("sharded_gather_join: tables and ids must share a "
                         "device")
    if block.dim() != 2 or border.dim() != 2 \
            or border.shape[1] > block.shape[1]:
        raise ValueError("sharded_gather_join: a 2-D block and a 2-D "
                         "border table no wider than it, got "
                         f"{tuple(block.shape)} and {tuple(border.shape)}")
    if any(x.dim() != 1 or x.shape != rs.shape or x.dtype != torch.int64
           for x in (owner, rs, rt)):
        raise ValueError("sharded_gather_join: owner and row ids must be "
                         "three int64 vectors of one length")
    if quant is None:
        if block.dtype != torch.float32 or border.dtype != torch.float32:
            raise ValueError("sharded_gather_join: float tables must be "
                             "float32")
    else:
        _check_codes((block, border), quant)


def sharded_gather_join(block: torch.Tensor, border: torch.Tensor,
                        owner: torch.Tensor, shard: int, rs: torch.Tensor,
                        rt: torch.Tensor, *,
                        quant: tuple[int, float] | None = None
                        ) -> torch.Tensor:
    """Shard ``shard``'s half of the sharded serving join: query i, if
    ``owner[i] == shard``, joins its two rows — row id r below
    ``block.shape[0]`` reads ``block[r]``, any other the border table
    (row ``r - block.shape[0]``) — and every other query is +inf. ``quant = (sentinel, scale)`` marks 16-bit code
    tables. Float32 ``(Q,)`` out."""
    _check_sharded(block, border, owner, rs, rt, quant)
    dev = block.device
    if dev.type == "cpu":
        return sharded_gather_join_ref(block, border, owner, shard, rs, rt,
                                       quant=quant)
    if dev.type != "cuda":
        raise ValueError(f"sharded_gather_join: unsupported device {dev}")
    for name, x in (("block", block), ("border", border), ("owner", owner),
                    ("rs", rs), ("rt", rt)):
        if not x.is_contiguous():
            raise ValueError(f"sharded_gather_join: {name} must be "
                             "contiguous")
    q = rs.shape[0]
    fn = _lib().repro_label_join_sharded if q else None
    out = torch.empty(q, dtype=torch.float32, device=dev)
    if q:
        if quant is None:
            code, sentinel, scale = _DTYPE_FLOAT32, 0, 1.0
        else:
            sentinel, scale = quant
            code = _SENTINELS[sentinel]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(code, storage16(block).data_ptr(), block.shape[0],
                     block.shape[1], storage16(border).data_ptr(),
                     border.shape[0], border.shape[1], owner.data_ptr(),
                     int(shard), rs.data_ptr(), rt.data_ptr(), q,
                     int(sentinel), float(scale),
                     out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"label_join_sharded kernel launch failed: "
                               f"CUDA error {err}")
        LAUNCHES["label_join_sharded"] += 1
    return out
