"""Plain PyTorch versions of the label-join kernels.

They mirror the JAX package's ``kernels/label_join/ref.py`` and the
int32 quantized accumulate of its ``ops.join_quantized``. The CPU runs
them (``kernel.gather_join`` takes them for tensors on the CPU), and the
card's checks hold the CUDA kernel against them on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

# int32 stand-in for +inf in the quantized accumulate: no finite code sum
# (≤ 2·65534) reaches it, and INF_I32 + INF_I32 < 2^31 never wraps
INF_I32 = 1 << 29

_UINT16 = getattr(torch, "uint16", None)

# float tables the plain version joins; bfloat16 and float16 rows are
# widened to float32 and the results cast back, as the JAX package's
# ``join_pallas`` / ``join_lb_pallas`` do
FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _inf(q: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((q,), float("inf"), dtype=torch.float32,
                      device=like.device)


def join_ref(s_rows: torch.Tensor, t_rows: torch.Tensor) -> torch.Tensor:
    """Dense hub-aligned 2-hop join: out[i] = min_j s[i,j] + t[i,j];
    +inf for zero-width rows."""
    if s_rows.shape[1] == 0:
        return _inf(s_rows.shape[0], s_rows)
    return torch.amin(s_rows + t_rows, dim=1)


def local_bound_ref(s_border: torch.Tensor,
                    t_border: torch.Tensor) -> torch.Tensor:
    """Definition 5: LB[i] = min_b s[i,b] + min_b' t[i,b']."""
    if s_border.shape[1] == 0:
        return _inf(s_border.shape[0], s_border)
    return torch.amin(s_border, dim=1) + torch.amin(t_border, dim=1)


def join_sparse_ref(hs, ds, ht, dt) -> torch.Tensor:
    """Padded sparse join: hubs (Q,L) int32 (-1 pad), dists (Q,L) f32.
    out[i] = min over (a,b) with hs[i,a]==ht[i,b]>=0 of ds[i,a]+dt[i,b]."""
    eq = (hs[:, :, None] == ht[:, None, :]) & (hs[:, :, None] >= 0)
    tot = ds[:, :, None] + dt[:, None, :]
    inf = torch.tensor(float("inf"), dtype=tot.dtype, device=tot.device)
    return torch.amin(torch.where(eq, tot, inf), dim=(1, 2))


def storage16(codes: torch.Tensor) -> torch.Tensor:
    """16-bit code storage as int16 bits: uint16 tensors are viewed as
    int16, since unsigned types take no indexing on every device."""
    if _UINT16 is not None and codes.dtype == _UINT16:
        return codes.view(torch.int16)
    return codes


def codes_i32(codes: torch.Tensor, sentinel: int) -> torch.Tensor:
    """16-bit codes (int16 bits; uint16 when ``sentinel`` is 65535) →
    int32 with the sentinel mapped to INF_I32."""
    c = storage16(codes).to(torch.int32)
    if sentinel == 0xFFFF:
        c = c & 0xFFFF
    return torch.where(c == sentinel, INF_I32, c)


def join_quantized_ref(s_codes: torch.Tensor, t_codes: torch.Tensor, *,
                       sentinel: int, scale: float) -> torch.Tensor:
    """Quantized join in raw code units: int32 accumulate, sums at or
    above INF_I32 are +inf, then one float32 multiply by ``scale``."""
    if s_codes.shape[1] == 0:
        return _inf(s_codes.shape[0], s_codes)
    m = torch.amin(codes_i32(s_codes, sentinel)
                   + codes_i32(t_codes, sentinel), dim=1)
    # a float32 tensor times a Python scalar multiplies in float32 with
    # the scalar rounded to float32 first — one IEEE float32 multiply
    scale32 = float(np.float32(scale))
    return torch.where(m >= INF_I32, float("inf"),
                       m.to(torch.float32) * scale32)


def gather_join_ref(s_table: torch.Tensor, rs: torch.Tensor,
                    t_table: torch.Tensor, rt: torch.Tensor, *,
                    quant: tuple[int, float] | None = None,
                    with_lb: bool = False):
    """Plain version of the fused gather-join kernel: gather rows
    ``s_table[rs]`` / ``t_table[rt]`` and join them. ``quant`` =
    ``(sentinel, scale)`` for code tables. Returns ``out`` or, with
    ``with_lb``, ``(out, lb)``."""
    if quant is not None:
        sentinel, scale = quant
        return join_quantized_ref(storage16(s_table)[rs],
                                  storage16(t_table)[rt],
                                  sentinel=sentinel, scale=scale)
    s, t = s_table[rs].float(), t_table[rt].float()
    out = (join_ref(s, t), local_bound_ref(s, t)) if with_lb \
        else join_ref(s, t)
    if s_table.dtype == torch.float32:
        return out
    # one rounding of each float32 result, as the reference's kernels
    return tuple(x.to(s_table.dtype) for x in out) if with_lb \
        else out.to(s_table.dtype)


def dequantize_ref(codes: torch.Tensor,
                   quant: tuple[int, float]) -> torch.Tensor:
    """``QuantSpec.dequantize`` on tensors: 16-bit codes (uint16 stored as
    int16 bits when the sentinel is 65535) → float32 ``code · scale``
    (one float32 multiply), the sentinel → +inf."""
    sentinel, scale = quant
    c = storage16(codes).to(torch.int32)
    if sentinel == 0xFFFF:
        c = c & 0xFFFF
    # a float32 tensor times a Python float multiplies in float32 with
    # the scalar rounded to float32 first, as ``np.float32(scale)``
    out = c.to(torch.float32) * float(np.float32(scale))
    return torch.where(c == sentinel, float("inf"), out)


def pad_value(quant: tuple[int, float] | None, like: torch.Tensor
              ) -> torch.Tensor:
    """The min identity of a table's storage as a 0-d tensor: +inf for
    float32 rows, the sentinel (as int16 bits) for 16-bit codes."""
    if quant is None:
        return torch.full((), float("inf"), dtype=like.dtype,
                          device=like.device)
    bits = int(np.array(quant[0], dtype=np.uint16).view(np.int16))
    return torch.full((), bits, dtype=torch.int16, device=like.device)


def sharded_gather_rows(block: torch.Tensor, border: torch.Tensor,
                        rs: torch.Tensor, rt: torch.Tensor, *,
                        quant: tuple[int, float] | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (Q, W) rows a sharded join reads, as the JAX package gathers
    them: ids below ``block.shape[0]`` from the block, the rest from the
    border table (row ``r - block.shape[0]``), the border rows padded to
    the block's width W with the min identity."""
    block, border = storage16(block), storage16(border)
    cross_base = block.shape[0]
    wpad = block.shape[1] - border.shape[1]
    pad = pad_value(quant, block)
    qn = rs.shape[0]

    def gather(rows):
        local = rows < cross_base
        dist = block[torch.where(local, rows, 0)]
        bord = border[torch.where(local, 0, rows - cross_base)]
        if wpad:
            bord = torch.cat([bord, pad.expand(qn, wpad)], dim=1)
        return torch.where(local[:, None], dist, bord)

    return gather(rs), gather(rt)


def sharded_gather_join_ref(block: torch.Tensor, border: torch.Tensor,
                            owner: torch.Tensor, shard: int,
                            rs: torch.Tensor, rt: torch.Tensor, *,
                            quant: tuple[int, float] | None = None
                            ) -> torch.Tensor:
    """Plain version of the sharded gather-join kernel: shard ``shard``'s
    half of the JAX package's ``join_sharded_gathered`` /
    ``join_sharded_border_gathered``, step for step — gather, pad and
    select the rows (``sharded_gather_rows``), join, and mask the lanes
    another shard owns to +inf. Float32 ``(Q,)`` out."""
    s_rows, t_rows = sharded_gather_rows(block, border, rs, rt,
                                         quant=quant)
    if quant is None:
        ans = join_ref(s_rows, t_rows)
    else:
        ans = join_quantized_ref(s_rows, t_rows, sentinel=quant[0],
                                 scale=quant[1])
    return torch.where(owner == shard, ans, float("inf"))


def multi_shard_gather_join_ref(blocks: list[torch.Tensor],
                                borders: list[torch.Tensor],
                                owner: torch.Tensor, rs: torch.Tensor,
                                rt: torch.Tensor, *,
                                rows_per_border_shard: int | None = None,
                                quant: tuple[int, float] | None = None,
                                dequant_first: bool = False
                                ) -> torch.Tensor:
    """Plain version of the sharded kernel's whole-batch call, step for
    step as the JAX package's sharded ops: every shard d gathers, pads
    and selects the rows of the batch (``sharded_gather_rows`` over its
    block and its border source; with a row-sharded B the slices in
    order, so that border row v is row v % rpd of slice v // rpd), joins
    them (in code units then scaled, or, with ``dequant_first``,
    dequantized first as ``dequantize_ref``), masks the lanes it does
    not own to +inf, and the MIN over the shards gives the answers. A
    lane another shard owns reads row 0 here (the reference reads its
    own ids, clamped), which its mask drops. Float32 ``(Q,)`` out."""
    inf = _inf(rs.shape[0], rs)
    out = inf
    if rows_per_border_shard is not None:
        whole = torch.cat([storage16(b) for b in borders])
        borders = [whole] * len(blocks)
    for d, (block, border) in enumerate(zip(blocks, borders)):
        mine = owner == d
        s_rows, t_rows = sharded_gather_rows(
            block, border, torch.where(mine, rs, 0), torch.where(mine, rt, 0),
            quant=quant)
        if quant is None:
            ans = join_ref(s_rows, t_rows)
        elif dequant_first:
            ans = join_ref(dequantize_ref(s_rows, quant),
                           dequantize_ref(t_rows, quant))
        else:
            ans = join_quantized_ref(s_rows, t_rows, sentinel=quant[0],
                                     scale=quant[1])
        out = torch.minimum(out, torch.where(mine, ans, inf))
    return out
