"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060].

The port of the JAX package's ``models/mamba2.py``, name for name.
Prefill and training run the chunked SSD: within a chunk a masked
(Q, Q) product, across chunks a recurrence over the chunk states, here
a Python loop in chunk order (the reference's ``lax.scan``). Decode
keeps an O(1) state a layer: the (H, P, N) SSM state in float32 and a
(w-1)-deep window of each convolution's raw inputs.

Differences, all deliberate: no tensor-parallel pins (the identity
outside a mesh); ``mamba2_decode`` writes the new state and windows into
the cache in place (as ``gqa_decode`` does); ``mamba2_init`` draws
``out_proj`` from its own stream, where the reference reuses ``wb``'s
key (tests carry the reference's weights across with ``convert``).
The softplus (``logaddexp(x, 0)``) and the causal convolution (the
shifted products summed in the input dtype, in tap order) are written
as the reference's are, so that bf16 rounds at the same places.

``mamba2_apply`` runs its stages under ``torch.profiler.record_function``
ranges (``mamba2/in_proj``, ``mamba2/conv``, ``mamba2/ssd``,
``mamba2/out``) so that a profile splits a layer's time by stage.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..configs.base import ArchConfig
from .layers import dense_init, rms_norm


def mamba2_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                device: torch.device, lead: tuple[int, ...] = ()) -> dict:
    d, di, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads
    gn, w = cfg.ssm_groups * cfg.ssm_state, cfg.ssm_conv_width

    def dense(a, b):
        return dense_init(gen, a, b, dtype, device, lead)

    def full(n, value):
        return torch.full((*lead, n), value, dtype=torch.float32,
                          device=device)

    conv_x = torch.randn((*lead, w, di), generator=gen, device=device,
                         dtype=torch.float32).mul_(0.1).to(dtype)
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device=device)).expand(*lead, h)
    return {"wz": dense(d, di), "wx": dense(d, di), "wb": dense(d, gn),
            "wc": dense(d, gn), "wdt": dense(d, h), "conv_x": conv_x,
            "conv_b": torch.full((*lead, w, gn), 0.1, dtype=dtype,
                                 device=device),
            "conv_c": torch.full((*lead, w, gn), 0.1, dtype=dtype,
                                 device=device),
            "conv_bias_x": full(di, 0.0), "conv_bias_b": full(gn, 0.0),
            "conv_bias_c": full(gn, 0.0), "a_log": a_log.contiguous(),
            "dt_bias": full(h, 0.0), "d_skip": full(h, 1.0),
            "gate_norm": full(di, 1.0), "out_proj": dense(di, d)}


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_head: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in float32.

    x: (B,T,H,P)  dt: (B,T,H)  a_head: (H,) negative
    bmat/cmat: (B,T,H,N) (already expanded from groups)
    Returns y: (B,T,H,P) in x's dtype, final_state: (B,H,P,N) float32.
    A chunk that does not divide T falls back to one chunk of T.
    """
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    if t % chunk != 0:
        chunk = t
    c = t // chunk
    f32 = torch.float32
    xc = x.reshape(b, c, chunk, h, p).to(f32)
    dtc = dt.reshape(b, c, chunk, h).to(f32)
    bc = bmat.reshape(b, c, chunk, h, n).to(f32)
    cc = cmat.reshape(b, c, chunk, h, n).to(f32)

    a = dtc * a_head                                    # (B,C,Q,H) <= 0
    cum = torch.cumsum(a, dim=2)

    # intra-chunk (dual/matmul form); mask BEFORE exp: the upper triangle
    # holds positive sums that would overflow to inf (inf*0 = nan in the
    # backward)
    cb = torch.einsum("bcqhn,bcshn->bcqsh", cc, bc)
    qi = torch.arange(chunk, device=x.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    neg_inf = torch.full((), -math.inf, device=x.device)
    ldecay = torch.exp(torch.where(causal, diff, neg_inf))
    w = cb * ldecay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", w, xc)

    # per-chunk terminal states
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,C,Q,H)
    s_chunk = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_end * dtc, bc,
                           xc)

    # inter-chunk recurrence, in chunk order
    chunk_decay = torch.exp(cum[:, :, -1, :])          # (B,C,H)
    s = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    s_prevs = []
    for i in range(c):
        s_prevs.append(s)
        s = chunk_decay[:, i, :, None, None] * s + s_chunk[:, i]
    s_prevs = torch.stack(s_prevs, dim=1)               # (B,C,H,P,N)

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", cc, s_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, t, h, p)
    return y.to(x.dtype), s


def ssd_recurrent_ref(x: torch.Tensor, dt: torch.Tensor,
                      a_head: torch.Tensor, bmat: torch.Tensor,
                      cmat: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step reference recurrence (tests only)."""
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    f32 = torch.float32
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for i in range(t):
        xt, dtt = x[:, i].to(f32), dt[:, i].to(f32)
        bt, ct = bmat[:, i].to(f32), cmat[:, i].to(f32)
        decay = torch.exp(dtt * a_head)                  # (B,H)
        upd = torch.einsum("bh,bhn,bhp->bhpn", dtt, bt, xt)
        state = decay[:, :, None, None] * state + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", ct, state))
    return torch.stack(ys, dim=1).to(x.dtype), state


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------

def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no
    switch to the identity for large x (``F.softplus`` has one)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _conv1d_causal(seq: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. seq: (B,T,ch), weight: (w,ch). The w
    shifted products are summed in seq's dtype in tap order, as the
    reference's ``sum`` does."""
    w, t = weight.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, w - 1, 0))
    out = pad[:, 0:t] * weight[0]
    for i in range(1, w):
        out = out + pad[:, i:i + t] * weight[i]
    return out + bias.to(out.dtype)


def _expand_groups(cfg: ArchConfig, part: torch.Tensor, batch: int,
                   t: int) -> torch.Tensor:
    """(B, T, G·N) -> (B, T, H, N): each group's rows repeated for its
    H/G heads in turn (``jnp.repeat``, not a tile)."""
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return part.reshape(batch, t, g, n).repeat_interleave(h // g, dim=2)


def mamba2_apply(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD block (train / prefill). x: (B, T, D)."""
    b, t, _ = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    with record_function("mamba2/in_proj"):
        z, xp, bp, cp = (x @ p[k] for k in ("wz", "wx", "wb", "wc"))
        dt = _softplus((x @ p["wdt"]).float() + p["dt_bias"])
    with record_function("mamba2/conv"):
        xr = F.silu(_conv1d_causal(xp, p["conv_x"], p["conv_bias_x"]))
        br = F.silu(_conv1d_causal(bp, p["conv_b"], p["conv_bias_b"]))
        cr = F.silu(_conv1d_causal(cp, p["conv_c"], p["conv_bias_c"]))
        xs = xr.reshape(b, t, h, pd)
        bmat = _expand_groups(cfg, br, b, t)
        cmat = _expand_groups(cfg, cr, b, t)
    with record_function("mamba2/ssd"):
        a_head = -torch.exp(p["a_log"])
        y, _ = ssd_chunked(xs, dt, a_head, bmat, cmat, cfg.ssm_chunk)
    with record_function("mamba2/out"):
        y = y + xs * p["d_skip"][:, None].to(xs.dtype)
        y = y.reshape(b, t, cfg.ssm_d_inner)
        y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
        return y @ p["out_proj"]


def mamba2_init_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                      device: torch.device,
                      lead: tuple[int, ...] = ()) -> dict:
    """The SSM state (B, H, P, N) in float32 and each convolution's last
    w-1 raw inputs (B, w-1, ch) in ``dtype``, zeroed."""
    di, gn = cfg.ssm_d_inner, cfg.ssm_groups * cfg.ssm_state
    w = cfg.ssm_conv_width - 1

    def zeros(*shape, dt=dtype):
        return torch.zeros((*lead, batch, *shape), dtype=dt, device=device)

    return {"ssm": zeros(cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                         dt=torch.float32),
            "conv_x": zeros(w, di), "conv_b": zeros(w, gn),
            "conv_c": zeros(w, gn)}


def _conv_step(window: torch.Tensor, new: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """window: (B, w-1, ch) raw inputs; new: (B, 1, ch). Returns the
    convolution's output at the new position (B, 1, ch) in float32, and
    shifts ``new`` into ``window`` in place."""
    full = torch.cat([window, new.to(window.dtype)], dim=1)
    out = torch.einsum("bwc,wc->bc", full.float(), weight.float()) + bias
    window.copy_(full[:, 1:])
    return F.silu(out)[:, None, :]


def mamba2_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict
                  ) -> tuple[torch.Tensor, dict]:
    """One-token step. x: (B, 1, D). Writes the new SSM state and conv
    windows into ``cache`` in place. Returns (y, cache)."""
    b = x.shape[0]
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    z = x @ p["wz"]
    xr = _conv_step(cache["conv_x"], x @ p["wx"], p["conv_x"],
                    p["conv_bias_x"])
    br = _conv_step(cache["conv_b"], x @ p["wb"], p["conv_b"],
                    p["conv_bias_b"])
    cr = _conv_step(cache["conv_c"], x @ p["wc"], p["conv_c"],
                    p["conv_bias_c"])
    xs = xr.reshape(b, h, pd)
    bmat = _expand_groups(cfg, br, b, 1)[:, 0]
    cmat = _expand_groups(cfg, cr, b, 1)[:, 0]
    dt = _softplus((x @ p["wdt"])[:, 0].float() + p["dt_bias"])   # (B,H)
    a_head = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a_head)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dt, bmat, xs)
    state = cache["ssm"]
    state.copy_(decay[:, :, None, None] * state + upd)
    y = torch.einsum("bhn,bhpn->bhp", cmat, state)
    y = y + xs * p["d_skip"][:, None]
    y = y.reshape(b, 1, cfg.ssm_d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], cache
