"""The fused gather + 2-hop label join on the card.

``gather_join`` is the one wrapper of ``csrc/label_join.cu``: for query
i it joins row ``rs[i]`` of ``s_table`` with row ``rt[i]`` of
``t_table`` — out[i] = min_j s + t, and with ``with_lb`` also the Local
Bound min_j s + min_j t — without materializing the gathered rows.
It replaces the JAX package's Pallas kernels ``join_pallas`` and
``join_lb_pallas`` (``src/repro/kernels/label_join/kernel.py``) together
with the XLA gathers in front of them.

``multi_shard_gather_join`` is the wrapper of the same file's sharded
kernel: the sharded serving join of a whole batch in one launch, over
every logical edge shard (or scatter-gather server) on the card — each
shard's district block and border source of another width, B
replicated or row-sharded (read in place), float32 rows or 16-bit codes
joined then scaled or dequantized first. It replaces ``join_pallas`` as
the JAX package runs it under ``shard_map``
(``src/repro/kernels/label_join/ops.py``, ``join_sharded_gathered`` and
``join_sharded_border_gathered``), the ``pmin`` over the shards
included. ``sharded_gather_join`` is its one-entry call: one shard's
half, lanes of other shards +inf.

On a CUDA tensor a wrapper launches its kernel (building it on first
use) or raises; on a CPU tensor it runs the plain version of ``ref.py``.
There is no other path. The C entry picks the kernel's vector width
and lanes per query from the row pitch, the tables' base alignment and
the batch; ``join_layout`` and ``multi_shard_join_layout`` report its
pick. ``gather_join`` takes float32, bfloat16 and float16 tables (the
16-bit rows widened to float32 and each result rounded once to their
type, as the JAX package's ``join_pallas`` / ``join_lb_pallas`` do) and
16-bit codes; the sharded kernel takes float32 tables and codes.
``LAUNCHES`` counts kernel launches per kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build
from .ref import (FLOAT_DTYPES, gather_join_ref,
                  multi_shard_gather_join_ref, sharded_gather_join_ref,
                  storage16)

SOURCE = Path(__file__).resolve().parent / "csrc" / "label_join.cu"

# kernel launches since the last reset, per kernel (plain-version calls
# on the CPU are not launches)
LAUNCHES = {"label_join": 0, "label_join_lb": 0,
            "label_join_sharded": 0}

_DTYPE_FLOAT32, _DTYPE_UINT16, _DTYPE_INT16 = 0, 1, 2
# float tables of the C entry: float32, then the 16-bit float types
_FLOAT_CODES = {torch.float32: _DTYPE_FLOAT32, torch.bfloat16: 3,
                torch.float16: 4}
# the sharded kernel's arithmetic: float32 rows, codes joined then
# scaled, codes dequantized before the add
_MODE_FLOAT, _MODE_JOIN_THEN_SCALE, _MODE_DEQUANT_FIRST = 0, 1, 2
# entries of the sharded kernel's shard table (its C entry's limit)
MAX_SHARDS = 64
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
        pp, p64 = ctypes.POINTER(p), ctypes.POINTER(i64)
        lib.repro_label_join_multi.argtypes = [
            i32, i32, i32, pp, p64, pp, p64, i64, i64, i64, i64, p, p, p,
            i64, i32, ctypes.c_float, p, p]
        lib.repro_label_join_multi.restype = ctypes.c_int
        lib.repro_label_join_multi_layout.argtypes = [
            i32, i32, pp, pp, i64, i64, i64, p]
        lib.repro_label_join_multi_layout.restype = ctypes.c_int
    return lib


def join_layout(s_table: torch.Tensor, t_table: torch.Tensor, q: int,
                lanes: int = 0, sms: int = 0) -> tuple[int, int]:
    """The (vector bytes, lanes a query) the kernel takes for ``q``
    queries over two contiguous CUDA tables of one width, as its C entry
    picks them: ``lanes`` if nonzero, on ``sms`` SMs (0: the tables'
    card's)."""
    code = _DTYPE_FLOAT32 if s_table.dtype == torch.float32 \
        else _DTYPE_INT16       # the layout depends on the item size only
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(s_table.device):
        err = _lib().repro_label_join_layout(
            code, s_table.data_ptr(), t_table.data_ptr(), s_table.shape[1],
            q, lanes, sms, out)
    if err != 0:
        raise ValueError(f"join_layout: no layout for {lanes} lanes "
                         f"(CUDA error {err})")
    return out[0], out[1]


def _shard_table(blocks, borders):
    """The C entry's table arguments: each entry's two base addresses and
    row counts (uint16 codes as their int16 bits)."""
    e = len(blocks)
    ptr, rows = ctypes.c_void_p * e, ctypes.c_int64 * e
    return (ptr(*(storage16(b).data_ptr() for b in blocks)),
            rows(*(b.shape[0] for b in blocks)),
            ptr(*(storage16(b).data_ptr() for b in borders)),
            rows(*(b.shape[0] for b in borders)))


def multi_shard_join_layout(blocks: list[torch.Tensor],
                            borders: list[torch.Tensor],
                            q: int) -> tuple[int, int]:
    """The (vector bytes, lanes a query) the sharded kernel takes for
    ``q`` queries over these CUDA blocks and border sources on their
    card, as its C entry picks them: once for the batch, over both
    widths and every base address."""
    code = _DTYPE_FLOAT32 if blocks[0].dtype == torch.float32 \
        else _DTYPE_INT16
    b_ptr, _, r_ptr, _ = _shard_table(blocks, borders)
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(blocks[0].device):
        err = _lib().repro_label_join_multi_layout(
            code, len(blocks), b_ptr, r_ptr, blocks[0].shape[1],
            borders[0].shape[1], q, out)
    if err != 0:
        raise ValueError(f"multi_shard_join_layout: no layout (CUDA error "
                         f"{err})")
    return out[0], out[1]


def sharded_join_layout(block: torch.Tensor, border: torch.Tensor,
                        q: int) -> tuple[int, int]:
    """The layout of ``sharded_gather_join``: its one entry's."""
    return multi_shard_join_layout([block], [border], q)


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
        if s_table.dtype not in FLOAT_DTYPES \
                or t_table.dtype not in FLOAT_DTYPES:
            raise ValueError("gather_join: float tables must be float32, "
                             "bfloat16 or float16")
        if dev.type != "cpu" and s_table.dtype != t_table.dtype:
            raise ValueError("gather_join: on the card both float tables "
                             "must be of one dtype, got "
                             f"{s_table.dtype} and {t_table.dtype}; the "
                             "plain version mixes them on the CPU")
    else:
        _check_codes((s_table, t_table), quant)
        if with_lb:
            raise ValueError("gather_join: the Local Bound is computed on "
                             "float tables only")


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
    out_dtype = torch.float32 if quant is not None else s_table.dtype
    out = torch.empty(q, dtype=out_dtype, device=dev)
    lb = torch.empty(q, dtype=out_dtype, device=dev) if with_lb else None
    if q:
        if quant is None:
            code, sentinel, scale = _FLOAT_CODES[s_table.dtype], 0, 1.0
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


def _check_multi(blocks, borders, owner, rs, rt, rows_pd, quant,
                 dequant_first, what) -> None:
    if not blocks or len(blocks) != len(borders):
        raise ValueError(f"{what}: one border source a block, at least one "
                         f"shard; got {len(blocks)} and {len(borders)}")
    if len(blocks) > MAX_SHARDS:
        raise ValueError(f"{what}: at most {MAX_SHARDS} shards a call, got "
                         f"{len(blocks)}")
    dev = blocks[0].device
    if any(x.device != dev for x in (*blocks, *borders, owner, rs, rt)):
        raise ValueError(f"{what}: tables and ids must share a device")
    if any(x.dim() != 2 for x in (*blocks, *borders)):
        raise ValueError(f"{what}: blocks and border sources must be 2-D")
    w, bw = blocks[0].shape[1], borders[0].shape[1]
    if any(b.shape[1] != w for b in blocks) \
            or any(b.shape[1] != bw for b in borders) or bw > w:
        raise ValueError(f"{what}: the blocks must share a width W and the "
                         "border sources a width no wider than it, got "
                         f"{sorted({tuple(b.shape) for b in blocks})} and "
                         f"{sorted({tuple(b.shape) for b in borders})}")
    if rows_pd is not None and (rows_pd < 1 or any(
            b.shape[0] != rows_pd for b in borders)):
        raise ValueError(f"{what}: each border slice of a row-sharded B "
                         f"must hold rows_per_border_shard = {rows_pd} rows")
    if any(x.dim() != 1 or x.shape != rs.shape or x.dtype != torch.int64
           for x in (owner, rs, rt)):
        raise ValueError(f"{what}: owner and row ids must be three int64 "
                         "vectors of one length")
    tables = (*blocks, *borders)
    if quant is None:
        if dequant_first:
            raise ValueError(f"{what}: dequant_first needs code tables "
                             "(quant)")
        if any(x.dtype != torch.float32 for x in tables):
            raise ValueError(f"{what}: float tables must be float32")
    else:
        _check_codes(tables, quant)


def _launch_multi(blocks, borders, owner, rs, rt, *, rows_pd, owner_base,
                  quant, dequant_first, what) -> torch.Tensor:
    """One launch of the sharded kernel over the table of ``blocks`` /
    ``borders`` (CUDA tensors, checked); float32 ``(Q,)`` out."""
    dev = blocks[0].device
    for name, group in (("blocks", blocks), ("borders", borders),
                        ("ids", (owner, rs, rt))):
        if not all(x.is_contiguous() for x in group):
            raise ValueError(f"{what}: {name} must be contiguous")
    q = rs.shape[0]
    fn = _lib().repro_label_join_multi if q else None
    out = torch.empty(q, dtype=torch.float32, device=dev)
    if not q:
        return out
    if quant is None:
        code, mode, sentinel, scale = _DTYPE_FLOAT32, _MODE_FLOAT, 0, 1.0
    else:
        sentinel, scale = quant
        code = _SENTINELS[sentinel]
        mode = _MODE_DEQUANT_FIRST if dequant_first \
            else _MODE_JOIN_THEN_SCALE
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(code, mode, len(blocks), *_shard_table(blocks, borders),
                 blocks[0].shape[1], borders[0].shape[1], rows_pd or 0,
                 int(owner_base), owner.data_ptr(), rs.data_ptr(),
                 rt.data_ptr(), q, int(sentinel), float(scale),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"label_join_sharded kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["label_join_sharded"] += 1
    return out


def multi_shard_gather_join(blocks: list[torch.Tensor],
                            borders: list[torch.Tensor], owner: torch.Tensor,
                            rs: torch.Tensor, rt: torch.Tensor, *,
                            rows_per_border_shard: int | None = None,
                            quant: tuple[int, float] | None = None,
                            dequant_first: bool = False) -> torch.Tensor:
    """The sharded serving join of a whole batch, one launch over every
    shard: lane i, owned by shard ``d = owner[i]`` (another value: +inf),
    joins its two rows — a row id r below ``blocks[d].shape[0]`` reads
    ``blocks[d][r]``, any other border row ``v = r - blocks[d].shape[0]``,
    which is ``borders[d][v]`` (B replicated, or a server's view) or,
    with ``rows_per_border_shard = rpd`` (row-sharded B),
    ``borders[v // rpd][v % rpd]``. Border rows are narrower than the
    blocks; their missing lanes are the min identity. ``quant =
    (sentinel, scale)`` marks 16-bit code tables, joined in code units
    and scaled once, or with ``dequant_first`` dequantized element by
    element (``code * scale``, the sentinel +inf) before the add.
    Every tensor on one device; at most ``MAX_SHARDS`` shards. Float32
    ``(Q,)`` out, in lane order."""
    what = "multi_shard_gather_join"
    _check_multi(blocks, borders, owner, rs, rt, rows_per_border_shard,
                 quant, dequant_first, what)
    dev = blocks[0].device
    if dev.type == "cpu":
        return multi_shard_gather_join_ref(
            blocks, borders, owner, rs, rt,
            rows_per_border_shard=rows_per_border_shard, quant=quant,
            dequant_first=dequant_first)
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return _launch_multi(blocks, borders, owner, rs, rt,
                         rows_pd=rows_per_border_shard, owner_base=0,
                         quant=quant, dequant_first=dequant_first, what=what)


def sharded_gather_join(block: torch.Tensor, border: torch.Tensor,
                        owner: torch.Tensor, shard: int, rs: torch.Tensor,
                        rt: torch.Tensor, *,
                        quant: tuple[int, float] | None = None
                        ) -> torch.Tensor:
    """Shard ``shard``'s half of the sharded serving join, the sharded
    kernel's one-entry call: query i, if ``owner[i] == shard``, joins its
    two rows — row id r below ``block.shape[0]`` reads ``block[r]``, any
    other the border table (row ``r - block.shape[0]``) — and every
    other query is +inf. ``quant = (sentinel, scale)`` marks 16-bit code
    tables. Float32 ``(Q,)`` out."""
    what = "sharded_gather_join"
    _check_multi([block], [border], owner, rs, rt, None, quant, False, what)
    dev = block.device
    if dev.type == "cpu":
        return sharded_gather_join_ref(block, border, owner, shard, rs, rt,
                                       quant=quant)
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return _launch_multi([block], [border], owner, rs, rt, rows_pd=None,
                         owner_base=shard, quant=quant, dequant_first=False,
                         what=what)
