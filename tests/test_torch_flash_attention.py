"""The port's flash attention against the JAX package's.

The same numpy-seeded inputs go through the JAX package's dense-softmax
oracle ``attention_ref`` and its Pallas kernel ``flash_attention_pallas``
(interpret mode, bq = bk = 16, as its own tests run it on the CPU), and
through the port's plain version and entry point on the CPU. The cases
are those of ``tests/test_flash_attention.py``. Tolerances are the JAX
package's own: 2e-4 in float32 (the same f32 arithmetic; only the order
of the sums and the kernel's online rescaling differ) and 3e-2 in bf16
(inputs and output rounded to bf16 on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as rops
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as rattention_ref
from repro_torch.kernels.flash_attention import kernel, ops, ref

CASES = [
    # (B, S, T, H, KV, hd, causal)
    (1, 16, 16, 4, 4, 32, True),
    (2, 32, 32, 4, 2, 32, True),
    (1, 64, 64, 8, 2, 16, False),
    (2, 24, 24, 6, 2, 32, True),      # S not a block multiple
    (1, 128, 128, 4, 1, 64, True),    # MQA
]


def _qkv(seed, b, s, t, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal", CASES)
def test_ref_matches_jax_ref_and_pallas_f32(b, s, t, h, kv, hd, causal):
    q, k, v = _qkv(s * 7 + h, b, s, t, h, kv, hd)
    got = ref.attention_ref(_t(q), _t(k), _t(v), causal=causal).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = np.asarray(rattention_ref(jq, jk, jv, causal=causal))
    pallas = np.asarray(flash_attention_pallas(jq, jk, jv, causal=causal,
                                               bq=16, bk=16,
                                               interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal", CASES)
def test_entry_point_on_cpu_is_the_plain_version(b, s, t, h, kv, hd,
                                                 causal):
    q, k, v = (_t(x) for x in _qkv(s + hd, b, s, t, h, kv, hd))
    before = dict(kernel.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert kernel.LAUNCHES == before            # no launch on the CPU
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    assert torch.equal(got, ref.attention_ref(q, k, v, causal=causal))


def test_bf16_matches_jax_ref_and_pallas():
    q, k, v = _qkv(0, 1, 32, 32, 4, 4, 32)
    tq, tk, tv = (_t(x, torch.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    for want in (rattention_ref(jq, jk, jv),
                 flash_attention_pallas(jq, jk, jv, bq=16, bk=16,
                                        interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=3e-2, atol=3e-2)


def test_unaligned_qwen_heads_cpu():
    """Qwen3-4B's head layout (32 query heads over 8 KV heads, hd = 128)
    at a ragged length, against the JAX oracle."""
    q, k, v = _qkv(5, 1, 37, 37, 32, 8, 128)
    got = ops.flash_attention(_t(q), _t(k), _t(v)).numpy()
    want = np.asarray(rattention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("q_shape,kv_shape,dtype_bytes", [
    ((2, 4096, 32, 128), (2, 4096, 8, 128), 2),
    ((1, 24, 6, 32), (1, 24, 2, 32), 4)])
def test_hbm_bytes_per_call_matches_jax(q_shape, kv_shape, dtype_bytes):
    assert ops.hbm_bytes_per_call(q_shape, kv_shape, dtype_bytes) \
        == rops.hbm_bytes_per_call(q_shape, kv_shape, dtype_bytes)


@pytest.mark.parametrize("hd", [48, 192])
def test_any_head_dim_on_cpu_matches_jax_ref_and_pallas(hd):
    """The CPU path takes every head dim the JAX package takes: 48 (no
    kernel on the card) and 192 (Nemotron-4-340B's, bf16 kernel only)."""
    q, k, v = _qkv(hd, 1, 40, 40, 4, 2, hd)
    got = ops.flash_attention(_t(q), _t(k), _t(v)).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = np.asarray(rattention_ref(jq, jk, jv))
    pallas = np.asarray(flash_attention_pallas(jq, jk, jv, bq=16, bk=16,
                                               interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)


def test_float16_on_cpu_matches_jax_ref_and_pallas():
    """float16 computes on the CPU and returns float16, as the JAX
    package's entry point does there. Both sides compute in float32 on
    the same float16 inputs and round once to float16, so they may
    differ by one float16 ulp of the output: 2^-9 below magnitude 4."""
    q, k, v = _qkv(16, 1, 8, 8, 4, 2, 16)
    tq, tk, tv = (_t(x, torch.float16) for x in (q, k, v))
    before = dict(kernel.LAUNCHES)
    got = ops.flash_attention(tq, tk, tv)
    assert kernel.LAUNCHES == before
    assert got.dtype == torch.float16 and got.shape == (1, 8, 4, 16)
    assert float(got.float().abs().max()) < 4
    jq, jk, jv = (jnp.asarray(x).astype(jnp.float16) for x in (q, k, v))
    for want in (rattention_ref(jq, jk, jv),
                 flash_attention_pallas(jq, jk, jv, bq=16, bk=16,
                                        interpret=True)):
        assert want.dtype == jnp.float16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=0, atol=2.0 ** -9)


def _bad_inputs():
    f = torch.zeros
    good_q, good_kv = f(1, 8, 4, 32), f(1, 8, 2, 32)
    return {
        "head_dim": (f(1, 8, 4, 0), f(1, 8, 2, 0), f(1, 8, 2, 0)),
        "groups": (f(1, 8, 3, 32), good_kv, good_kv),
        "dtype_mix": (good_q.bfloat16(), good_kv, good_kv),
        "integer": (good_q.int(), good_kv.int(), good_kv.int()),
        "rank": (f(8, 4, 32), good_kv, good_kv),
        "kv_shapes": (good_q, good_kv, f(1, 9, 2, 32)),
        "no_keys": (good_q, f(1, 0, 2, 32), f(1, 0, 2, 32)),
        "strided_head_dim": (f(1, 8, 4, 64)[..., ::2], good_kv, good_kv),
        "meta_device": (good_q.to("meta"), good_kv.to("meta"),
                        good_kv.to("meta")),
    }


@pytest.mark.parametrize("what", sorted(_bad_inputs()))
def test_wrapper_rejects_what_the_kernel_does_not_take(what):
    q, k, v = _bad_inputs()[what]
    with pytest.raises(ValueError):
        kernel.flash_attention(q, k, v)
