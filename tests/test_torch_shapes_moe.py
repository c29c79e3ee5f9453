"""The paths the MoE, MLA and audio-encoder configs take at the JAX
package's long input shapes, against the JAX package, on the CPU.

At ``prefill_32k`` DeepSeek-V2's MLA would hold (B, 128, S, S) float32
scores, 550 GB a sequence, and HuBERT-XLarge's host attention 68 GB: the
port runs both in blocks of query rows above a score budget
(``models/attention.py`` ``SCORE_BLOCK_BYTES``,
``kernels/flash_attention/ref.py`` ``SCORE_BLOCK_BYTES``). Here the
budgets are set low so that smoke widths run in blocks:

* ``mla_apply`` in row blocks and whole against the reference's
  ``mla_apply``, causal and not, float32 and bf16; decode never blocks;
* DeepSeek-V2's whole forward with its MLA in row blocks;
* HuBERT-XLarge's non-causal forward through the flash wrapper, whose
  plain version runs in row blocks on the host.

The decode steps over filled caches at 32 768 rows and the train step at
1024 tokens of OLMoE-1B-7B and DeepSeek-V2 are cases of
``tests/test_torch_long_context.py``. Tolerances are those of
``tests/test_torch_mla.py`` (MLA: 1e-5 in float32, 3e-2 in bf16) and
``tests/test_torch_lm.py`` (a forward: 1e-4 in float32).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import attention as rattn
from repro.models import lm as rlm
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention, lm

MLA_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
FORWARD_TOL = 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


def _mla(dtype, seed=0):
    cj = rbase.get_smoke_config("deepseek_v2_236b")
    ct = get_smoke_config("deepseek_v2_236b")
    pj = rattn.mla_init(jax.random.PRNGKey(seed), cj, DTYPES[dtype][1])
    pt = convert.lm_params_from_numpy(jax.tree.map(np.asarray, pj),
                                      device="cpu")
    return cj, ct, pj, pt


@pytest.fixture
def blocks(monkeypatch):
    """(the block sizes of ``mla_attend_rows``' calls, ``set_rows(b, h,
    t, rows)``: sets the budget to ``rows`` query rows at (B, H, T))."""
    calls = []
    real = attention.mla_attend_rows

    def counted(*a, **kw):
        calls.append(a[-1])
        return real(*a, **kw)

    monkeypatch.setattr(attention, "mla_attend_rows", counted)

    def set_rows(b, h, t, rows):
        monkeypatch.setattr(attention, "SCORE_BLOCK_BYTES", 4 * b * h * t
                            * rows)
    return calls, set_rows


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_mla_apply_in_row_blocks_matches_the_reference(blocks, causal, dtype,
                                                       blocked):
    """37 tokens in blocks of 8 query rows (the last block short), or
    whole, against the reference's ``mla_apply`` over the whole
    sequence."""
    calls, set_rows = blocks
    cj, ct, pj, pt = _mla(dtype)
    b, s = 2, 37
    if blocked:
        set_rows(b, ct.num_heads, s, 8)
    x = np.random.default_rng(1).standard_normal(
        (b, s, cj.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = rattn.mla_apply(pj, cj, jnp.asarray(x).astype(DTYPES[dtype][1]),
                           jnp.asarray(pos), causal=causal)
    got = attention.mla_apply(pt, ct, torch.from_numpy(x).to(
        DTYPES[dtype][0]), torch.from_numpy(pos), causal=causal)
    assert calls == ([8] if blocked else [])
    assert got.dtype == DTYPES[dtype][0] and got.shape == (b, s, ct.d_model)
    _close(got, want, MLA_TOL[dtype])


@pytest.mark.parametrize("rows", [1, 5, 36])
def test_mla_row_blocks_equal_the_whole_path(blocks, rows):
    """The blocked path against the port's own unblocked one in float32:
    the same function, the sums in another order."""
    calls, set_rows = blocks
    _, ct, _, pt = _mla("float32", seed=2)
    b, s = 1, 37
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, s, ct.d_model)).astype(np.float32))
    pos = torch.arange(s)[None]
    whole = attention.mla_apply(pt, ct, x, pos)
    set_rows(b, ct.num_heads, s, rows)
    got = attention.mla_apply(pt, ct, x, pos)
    assert calls == [rows]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)


def test_mla_decode_never_blocks(blocks):
    """Decode attends one query row: with the budget below one row it
    takes the whole path, bit for bit as at the default budget."""
    calls, set_rows = blocks
    _, ct, _, pt = _mla("float32", seed=4)
    b, t, pos = 2, 16, 11
    rng = np.random.default_rng(5)
    start = {"latent": rng.standard_normal(
                 (b, t, ct.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.standard_normal(
                 (b, t, 1, ct.qk_rope_head_dim)).astype(np.float32)}
    x = torch.from_numpy(rng.standard_normal(
        (b, 1, ct.d_model)).astype(np.float32))

    def step():
        cache = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
        return attention.mla_decode(pt, ct, x, cache, pos)[0]

    want = step()
    set_rows(b, ct.num_heads, t, 0)
    assert attention.SCORE_BLOCK_BYTES == 0
    assert torch.equal(step(), want) and calls == []


def _forward_pair(arch, seed, **kw):
    kw = {"compute_dtype": "float32", **kw}
    cfg_j = rbase.get_smoke_config(arch).reduced(**kw)
    cfg_t = get_smoke_config(arch).reduced(**kw)
    params = rlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    ours = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    return cfg_j, cfg_t, params, ours


def test_deepseek_forward_with_mla_in_row_blocks_matches_jax(blocks):
    """DeepSeek-V2's smoke model (a dense first layer, then MoE; MLA in
    both) over 2 x 48 tokens with its MLA in blocks of 16 query rows:
    the hidden states of every position, float32."""
    calls, set_rows = blocks
    cfg_j, cfg_t, params, ours = _forward_pair("deepseek_v2_236b", 6)
    b, s = 2, 48
    set_rows(b, cfg_t.num_heads, s, 16)
    tok = np.random.default_rng(7).integers(0, cfg_j.vocab_size,
                                            (b, s)).astype(np.int32)
    want = rlm.forward(params, cfg_j, {"tokens": jnp.asarray(tok)})
    got = lm.forward(ours, cfg_t, {"tokens": torch.from_numpy(tok)})
    assert calls == [16] * cfg_t.num_layers
    _close(got, want, FORWARD_TOL)


def test_hubert_flash_forward_in_row_blocks_matches_jax(monkeypatch):
    """HuBERT-XLarge's smoke model at its head dim 80, non-causal, over
    1 x 96 frames through the flash wrapper, whose host plain version
    runs in blocks of 24 query rows: the hidden states against the JAX
    package's dense forward, float32."""
    calls = []
    real = fa_ref.attention_rows_ref

    def counted(q_rows, k, v, start, *, causal=True):
        calls.append((q_rows.shape[1], start, causal))
        return real(q_rows, k, v, start, causal=causal)

    monkeypatch.setattr(fa_ref, "attention_rows_ref", counted)
    cfg_j, cfg_t, params, ours = _forward_pair("hubert_xlarge", 8,
                                               head_dim=80)
    assert not cfg_t.causal and cfg_t.frontend == "frame"
    b, s = 1, 96
    monkeypatch.setattr(fa_ref, "SCORE_BLOCK_BYTES",
                        4 * b * cfg_t.num_heads * s * 24)
    frames = np.random.default_rng(9).standard_normal(
        (b, s, cfg_j.d_model)).astype(np.float32)
    want = rlm.forward(params, cfg_j, {"frames": jnp.asarray(frames)})
    got = lm.forward(ours, replace(cfg_t, attention_impl="flash"),
                     {"frames": torch.from_numpy(frames)})
    assert calls == [(24, r0, False) for r0 in range(0, s, 24)] \
        * cfg_t.num_layers
    _close(got, want, FORWARD_TOL)
