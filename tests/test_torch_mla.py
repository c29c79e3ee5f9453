"""The port's MLA (multi-head latent attention) against the JAX package's.

The JAX package's ``mla_init`` draws the weights (DeepSeek-V2's smoke
widths: d 128, 4 heads, r 32, qr 48, dn 16, dr 16, dv 32) and
``convert`` carries them across; inputs come from numpy with a seed, on
``device="cpu"``. ``mla_apply`` is held within 1e-5 in float32 (only
the order of the sums differs) and within 3e-2 in bf16 (both sides
round every product and the two summed score products to bf16 at the
same places, 2^-8 relative each, on outputs of order 1).
``mla_decode`` runs several steps from a cache whose slots start at
random values: the latent and ``k_rope`` written at each ``pos`` within
1e-4 of the reference's, every other slot unchanged bit for bit, and
each step's output within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import attention as rattn
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _setup(dtype="float32", seed=0):
    cj = rbase.get_smoke_config("deepseek_v2_236b")
    ct = get_smoke_config("deepseek_v2_236b")
    assert ct.use_mla and ct.kv_lora_rank == 32
    pj = rattn.mla_init(jax.random.PRNGKey(seed), cj, DTYPES[dtype][1])
    pt = lm_params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


def _x(cfg, b, s, dtype="float32", seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x).astype(DTYPES[dtype][1]),
            torch.from_numpy(x).to(DTYPES[dtype][0]))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


def test_mla_init_has_the_reference_tree():
    cj, ct, pj, _ = _setup()
    got = attention.mla_init(torch.Generator().manual_seed(0), ct,
                             torch.float32, torch.device("cpu"), lead=(2,))
    assert sorted(got) == sorted(pj)
    for k, leaf in pj.items():
        assert tuple(got[k].shape) == (2, *leaf.shape), k
        assert str(got[k].dtype).split(".")[1] == str(leaf.dtype), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_mla_apply_matches_the_reference(dtype, causal):
    cj, ct, pj, pt = _setup(dtype)
    xj, xt = _x(cj, 2, 20, dtype)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    want = rattn.mla_apply(pj, cj, xj, jnp.asarray(pos), causal=causal)
    got = attention.mla_apply(pt, ct, xt, torch.from_numpy(pos),
                              causal=causal)
    assert got.dtype == DTYPES[dtype][0] and got.shape == xt.shape
    _close(got, want, DTYPES[dtype][2])


def test_mla_qkv_matches_the_reference():
    """The latent and rope key that the cache stores, and the queries."""
    cj, ct, pj, pt = _setup()
    xj, xt = _x(cj, 2, 9, seed=2)
    pos = np.broadcast_to(np.arange(3, 12, dtype=np.int32), (2, 9)).copy()
    want = rattn._mla_qkv(pj, cj, xj, jnp.asarray(pos))
    got = attention._mla_qkv(pt, ct, xt, torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-5)


def test_mla_cache_is_latent_plus_rope_key():
    ct = get_smoke_config("deepseek_v2_236b")
    cache = attention.mla_init_cache(ct, 3, 10, torch.bfloat16,
                                     torch.device("cpu"), lead=(2,))
    want = rattn.mla_init_cache(rbase.get_smoke_config("deepseek_v2_236b"),
                                3, 10, jnp.bfloat16)
    for k in ("latent", "k_rope"):
        assert tuple(cache[k].shape) == (2, *want[k].shape)
        assert cache[k].dtype == torch.bfloat16
        assert not bool(cache[k].any())
    per_token = ct.kv_lora_rank + ct.qk_rope_head_dim
    assert cache["latent"][0, 0, 0].numel() \
        + cache["k_rope"][0, 0, 0].numel() == per_token


def test_mla_decode_writes_its_slot_and_leaves_the_rest():
    cj, ct, pj, pt = _setup(seed=3)
    b, t, steps = 2, 12, 6
    rng = np.random.default_rng(4)
    start = {"latent": rng.standard_normal(
                 (b, t, ct.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.standard_normal(
                 (b, t, 1, ct.qk_rope_head_dim)).astype(np.float32)}
    cache_j = {k: jnp.asarray(v) for k, v in start.items()}
    cache_t = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    xs = rng.standard_normal((steps, b, 1, ct.d_model)).astype(np.float32)
    for i, pos in enumerate([0, 1, 2, 5, 3, 11]):
        yj, cache_j = rattn.mla_decode(pj, cj, jnp.asarray(xs[i]), cache_j,
                                       jnp.int32(pos))
        before = {k: v.clone() for k, v in cache_t.items()}
        yt, returned = attention.mla_decode(pt, ct, torch.from_numpy(xs[i]),
                                            cache_t, pos)
        assert returned is cache_t                       # written in place
        _close(yt, yj, 1e-4)
        for k in ("latent", "k_rope"):
            _close(cache_t[k][:, pos], cache_j[k][:, pos], 1e-4)
            others = [j for j in range(t) if j != pos]
            assert torch.equal(cache_t[k][:, others], before[k][:, others])
