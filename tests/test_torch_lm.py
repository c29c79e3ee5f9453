"""The port's dense-LM serving path against the JAX package's.

The JAX package's ``init_params`` draws the weights; ``convert.
lm_params_from_numpy`` carries them across, so both packages compute
with the same values; inputs come from numpy with a seed. Layers,
``forward`` (dense and flash attention), ``decode_step``,
``make_prefill_step`` and ``BatchedDecoder`` are compared on the CPU at
smoke size (2 layers, d_model 128). Tolerance 1e-4 in float32: f32
throughout on both sides, only the order of the sums differs (measured
differences are ~4e-6 on values of order 1). The bf16 case allows 5e-2:
both sides round every matmul output and the weights to bf16 (8 bits
of mantissa, 2^-8 ≈ 4e-3 relative per rounding) at places that can
differ between XLA and PyTorch, compounded over two layers (measured:
0.047 on hidden states up to 3.6, three bf16 ulps there). The float16
flash case allows 1e-2 for the same reason at 2^-11 per rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import attention as rattention
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.serve import BatchedDecoder as RBatchedDecoder
from repro.serve import Request as RRequest
from repro.train.train_step import make_prefill_step as r_make_prefill_step
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models import layers, lm
from repro_torch.serve import BatchedDecoder, Request
from repro_torch.train.train_step import make_prefill_step, make_serve_step

TOL = 1e-4
TOL_BF16 = 5e-2
TOL_F16 = 1e-2


def _cfgs(**kw):
    kw = {"num_layers": 2, "compute_dtype": "float32", **kw}
    return (rbase.get_smoke_config("qwen3_4b").reduced(**kw),
            get_smoke_config("qwen3_4b").reduced(**kw))


def _params(cfg_j, seed=0):
    params = rlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    return params, lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")


def _tokens(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_jax_packages(arch):
    assert ARCH_IDS == rbase.ARCH_IDS
    for ours, theirs in ((get_config(arch), rbase.get_config(arch)),
                         (get_smoke_config(arch),
                          rbase.get_smoke_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_equals_the_jax_packages_at_full_size(arch):
    """The analytic count at the published config, both packages; for
    the dense configs it is also the port's full-size tree (fake
    tensors) with the norms as ``param_count`` counts them: 4·d a layer
    where the tree holds two d-wide norms a layer and one final norm,
    and no qk-norm vectors."""
    from repro_torch.launch.specs import param_specs
    from repro_torch.tree import tree_leaves
    ours, theirs = get_config(arch), rbase.get_config(arch)
    assert ours.param_count() == theirs.param_count()
    if ours.family == "dense":
        d, hd, n = ours.d_model, ours.resolved_head_dim, ours.num_layers
        tree = sum(t.numel() for t in tree_leaves(param_specs(ours)))
        qk = 2 * hd * n if ours.qk_norm else 0
        assert ours.param_count() == tree - d + 2 * d * n - qk


@pytest.mark.parametrize("arch,published", [
    ("starcoder2_7b", (32, 4608, 36, 4, 128, 18432, 49152, "gelu", 1e5,
                       1e-5)),
    ("deepseek_67b", (95, 8192, 64, 8, 128, 22016, 102400, "swiglu", 1e4,
                      1e-6)),
    ("nemotron_4_340b", (96, 18432, 96, 8, 192, 73728, 256000,
                         "squared_relu", 1e4, 1e-5))])
def test_dense_configs_are_the_published_shapes(arch, published):
    cfg = get_config(arch)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.mlp_type,
            cfg.rope_theta, cfg.norm_eps) == published
    assert cfg.family == "dense" and not cfg.tie_embeddings \
        and not cfg.qk_norm


def test_qwen3_4b_is_the_published_shape():
    cfg = get_config("qwen3_4b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (36, 2560, 32, 8, 128, 9728, 151936)
    assert cfg.tie_embeddings and cfg.qk_norm


# -- layers -------------------------------------------------------------------

def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32) * 3
    g = rng.standard_normal(32).astype(np.float32)
    for ours, theirs in ((layers.rms_norm, rlayers.rms_norm),
                         (layers.head_rms_norm, rlayers.head_rms_norm)):
        _close(ours(torch.from_numpy(x), torch.from_numpy(g), 1e-6),
               theirs(jnp.asarray(x), jnp.asarray(g), 1e-6), 1e-5)


@pytest.mark.parametrize("theta", [1e4, 1e5, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
           rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "squared_relu", "gelu"])
def test_mlp_apply_matches_jax(mlp_type):
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s).astype(np.float32) / 8
         for k, s in (("wi", (32, 64)), ("wg", (32, 64)), ("wo", (64, 32)))}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), mlp_type)
    _close(got, rlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), mlp_type))


def test_init_params_has_the_jax_tree():
    cfg_j, cfg_t = _cfgs()
    ours = lm.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    theirs = rlm.init_params(cfg_j, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(flat) == len(jax.tree.leaves(ours))
    for path, leaf in flat:
        t = ours
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[1] == str(leaf.dtype)
    assert sum(t.numel() for t in jax.tree.leaves(ours)) \
        == sum(leaf.size for leaf in jax.tree.leaves(theirs))


def test_bf16_params_cross_unchanged():
    cfg_j, _ = _cfgs(param_dtype="bfloat16")
    params, ours = _params(cfg_j)
    want = np.asarray(params["embed"].astype(jnp.float32))
    assert ours["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ours["embed"].float().numpy(), want)


# (heads, kv heads, head dim): StarCoder2-7B's group of 9 (36 / 4) and
# Nemotron-4-340B's of 12 (96 / 8), cut to one or two KV heads, at the
# smoke width's hd 32 and Nemotron's hd 192
WIDE_GROUPS = [(9, 1, 32), (18, 2, 32), (12, 1, 32), (24, 2, 192)]


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("heads,kv,hd", WIDE_GROUPS)
def test_gqa_apply_and_decode_match_jax_at_wide_groups(heads, kv, hd, impl):
    """``gqa_apply`` (query head h reads KV head h // (H / KV)) and eight
    ``gqa_decode`` steps, outputs and the cache, within TOL in float32;
    the JAX package's flash through its Pallas kernel in interpret
    mode."""
    from repro_torch.models import attention
    over = dict(num_heads=heads, num_kv_heads=kv, head_dim=hd,
                attention_impl=impl, rope_theta=1e5)
    cfg_j, cfg_t = _cfgs(**over)
    p = rattention.gqa_init(jax.random.PRNGKey(7), cfg_j, jnp.float32)
    pt = lm_params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    rng = np.random.default_rng(13)
    b, s, steps = 2, 20, 8
    x = rng.standard_normal((b, s, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    _close(attention.gqa_apply(pt, cfg_t, torch.from_numpy(x),
                               torch.from_numpy(pos)),
           rattention.gqa_apply(p, cfg_j, jnp.asarray(x), jnp.asarray(pos)))
    cache_j = rattention.gqa_init_cache(cfg_j, b, 12, jnp.float32)
    cache_t = attention.gqa_init_cache(cfg_t, b, 12, torch.float32, "cpu")
    for i in range(steps):
        y_j, cache_j = rattention.gqa_decode(p, cfg_j,
                                             jnp.asarray(x[:, i:i + 1]),
                                             cache_j, jnp.int32(i))
        y_t, cache_t = attention.gqa_decode(pt, cfg_t,
                                            torch.from_numpy(x[:, i:i + 1]),
                                            cache_t, i)
        _close(y_t, y_j)
    for name in ("k", "v"):
        _close(cache_t[name], cache_j[name])


# -- forward / prefill --------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_forward_matches_jax(impl):
    cfg_j, cfg_t = _cfgs(attention_impl=impl)
    params, ours = _params(cfg_j)
    tok = _tokens(cfg_j, 2, 32)
    before = dict(fa_kernel.LAUNCHES)
    got = lm.forward(ours, cfg_t, {"tokens": torch.from_numpy(tok)})
    assert fa_kernel.LAUNCHES == before          # the CPU runs no kernel
    _close(got, rlm.forward(params, cfg_j, {"tokens": jnp.asarray(tok)}))


def test_flash_forward_matches_dense_forward():
    cfg_j, cfg_t = _cfgs()
    _, ours = _params(cfg_j)
    tok = torch.from_numpy(_tokens(cfg_j, 2, 48, seed=3))
    dense = lm.forward(ours, cfg_t, {"tokens": tok})
    flash = lm.forward(ours, dataclasses.replace(cfg_t,
                                                 attention_impl="flash"),
                       {"tokens": tok})
    _close(flash, dense.numpy())


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_forward_bf16_matches_jax(impl):
    cfg_j, cfg_t = _cfgs(compute_dtype="bfloat16", attention_impl=impl)
    params, ours = _params(cfg_j)
    tok = _tokens(cfg_j, 2, 24, seed=4)
    got = lm.forward(ours, cfg_t, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.bfloat16
    _close(got, rlm.forward(params, cfg_j, {"tokens": jnp.asarray(tok)})
           .astype(jnp.float32), TOL_BF16)


def test_forward_float16_flash_matches_jax():
    """float16 through the flash path on the CPU, as in the JAX package.
    Both sides round every matmul output and the weights to float16
    (11 bits of mantissa, 2^-11 relative per rounding) at places that
    can differ between XLA and PyTorch, over two layers (measured:
    0.0044 on hidden states up to 3.7, two float16 ulps there)."""
    cfg_j, cfg_t = _cfgs(compute_dtype="float16", attention_impl="flash")
    params, ours = _params(cfg_j)
    tok = _tokens(cfg_j, 2, 24, seed=4)
    got = lm.forward(ours, cfg_t, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float16
    want = rlm.forward(params, cfg_j, {"tokens": jnp.asarray(tok)})
    assert want.dtype == jnp.float16
    _close(got, want.astype(jnp.float32), TOL_F16)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_make_prefill_step_matches_jax(impl):
    cfg_j, cfg_t = _cfgs(attention_impl=impl)
    params, ours = _params(cfg_j, seed=2)
    tok = _tokens(cfg_j, 3, 20, seed=5)
    got = make_prefill_step(cfg_t)(ours, {"tokens": torch.from_numpy(tok)})
    want = r_make_prefill_step(cfg_j)(params, {"tokens": jnp.asarray(tok)})
    assert got.shape == (3, 1, cfg_t.vocab_size)
    assert got.dtype == torch.float32
    _close(got, want)


# -- decode -------------------------------------------------------------------

def test_decode_step_matches_jax_logits_and_caches():
    cfg_j, cfg_t = _cfgs()
    params, ours = _params(cfg_j, seed=3)
    b, max_len, steps = 2, 12, 8
    tok = _tokens(cfg_j, b, steps, seed=6)
    cache_j = rlm.init_cache(cfg_j, b, max_len)
    cache_t = lm.init_cache(cfg_t, b, max_len, "cpu")
    step = make_serve_step(cfg_t)
    for i in range(steps):
        logits_j, cache_j = rlm.decode_step(params, cfg_j, cache_j,
                                            jnp.asarray(tok[:, i:i + 1]),
                                            jnp.int32(i))
        logits_t, returned = step(ours, cache_t, torch.from_numpy(
            tok[:, i:i + 1]), i)
        assert returned is cache_t                 # written in place
        assert logits_t.shape == (b, 1, cfg_t.vocab_size)
        _close(logits_t, logits_j)
        for name in ("k", "v"):
            _close(cache_t["layers"][name], cache_j["layers"][name])


def test_decode_matches_forward_logits():
    """Teacher-forced decode reproduces the flash forward's logits at
    every position (the KV-cache path agrees with prefill)."""
    _, cfg_t = _cfgs(attention_impl="flash")
    cfg_j, _ = _cfgs()
    _, ours = _params(cfg_j, seed=4)
    b, s = 2, 10
    tok = torch.from_numpy(_tokens(cfg_t, b, s, seed=7))
    hidden = lm.forward(ours, cfg_t, {"tokens": tok})
    full = hidden @ lm.lm_head_weight(lm.cast_params(ours, cfg_t), cfg_t)
    cache = lm.init_cache(cfg_t, b, s, "cpu")
    for i in range(s):
        logits, cache = lm.decode_step(ours, cfg_t, cache, tok[:, i:i + 1],
                                       i)
        _close(logits[:, 0], full[:, i].numpy())


def test_batched_decoder_matches_jax():
    """Five requests (two lockstep groups at batch 3, one padded): the
    step logits agree within TOL, so the greedy tokens agree."""
    cfg_j, cfg_t = _cfgs()
    params, ours = _params(cfg_j, seed=5)
    rng = np.random.default_rng(8)
    reqs = [(rid, rng.integers(1, cfg_j.vocab_size, 2 + rid).tolist(),
             3 + rid % 3) for rid in range(5)]
    ref_dec = RBatchedDecoder(cfg_j, params, batch_size=3, max_len=16)
    dec = BatchedDecoder(cfg_t, ours, batch_size=3, max_len=16,
                         device="cpu")
    logs = {"jax": [], "torch": []}

    def recording(step, log):
        def wrapped(*args):
            logits, cache = step(*args)
            log.append(np.asarray(logits.float() if isinstance(
                logits, torch.Tensor) else logits))
            return logits, cache
        return wrapped

    ref_dec._step = recording(ref_dec._step, logs["jax"])
    dec._step = recording(dec._step, logs["torch"])
    for rid, prompt, budget in reqs:
        ref_dec.submit(RRequest(rid=rid, prompt=prompt,
                                max_new_tokens=budget))
        dec.submit(Request(rid=rid, prompt=prompt, max_new_tokens=budget))
    want = {r.rid: r.tokens for r in ref_dec.run()}
    got = {r.rid: r.tokens for r in dec.run()}
    assert len(logs["torch"]) == len(logs["jax"]) > 0
    for a, b in zip(logs["torch"], logs["jax"]):
        _close(a, b)
    assert got == want
    assert all(len(got[rid]) == budget for rid, _, budget in reqs)


# -- the other families: moe, MLA, vlm, audio, ssm, hybrid ------------------

# (name, arch, overrides): the smoke configs, OLMoE also at its published
# capacity factor (the smoke reduction is dropless), a dense config with
# MLA attention, Mamba2 (ssm) and Zamba2 (hybrid: the smoke config's
# shared_attn_every 2, one shared application in 2 layers), and the
# three dense configs of the other MLPs and norms: StarCoder2-7B (GELU,
# θ 1e5), DeepSeek-67B (SwiGLU, norm eps 1e-6) and Nemotron-4-340B
# (squared ReLU)
FAMILIES = [("olmoe", "olmoe_1b_7b", {}),
            ("olmoe_cf125", "olmoe_1b_7b", {"moe_capacity_factor": 1.25}),
            ("deepseek", "deepseek_v2_236b", {}),
            ("internvl2", "internvl2_26b", {}),
            ("hubert", "hubert_xlarge", {}),
            ("dense_mla", "deepseek_v2_236b", {"family": "dense"}),
            ("mamba2", "mamba2_1_3b", {}),
            ("zamba2", "zamba2_1_2b", {}),
            ("starcoder2", "starcoder2_7b", {}),
            ("deepseek_67b", "deepseek_67b", {}),
            ("nemotron", "nemotron_4_340b", {})]
SSM_FAMILIES = [f for f in FAMILIES if f[0] in ("mamba2", "zamba2")]
DENSE_FAMILIES = [f for f in FAMILIES
                  if f[0] in ("starcoder2", "deepseek_67b", "nemotron")]
# HuBERT's smoke config at HuBERT-XLarge's head dim 80: its flash forward
# is the one the card's tensor-core kernel serves in its hd-80 instance
HUBERT_HD80 = ("hubert_hd80", "hubert_xlarge", {"head_dim": 80})
# Nemotron's smoke config at Nemotron-4-340B's head dim 192 (the smoke
# reduction sets 32): the card serves it in the hd-192 instance
NEMOTRON_HD192 = ("nemotron_hd192", "nemotron_4_340b", {"head_dim": 192})


def _family_cfgs(arch, overrides, **kw):
    kw = {"compute_dtype": "float32", **overrides, **kw}
    return (rbase.get_smoke_config(arch).reduced(**kw),
            get_smoke_config(arch).reduced(**kw))


def _family_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.frontend == "patch":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "frame":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("name,arch,overrides", FAMILIES)
def test_family_init_params_and_cache_have_the_jax_trees(name, arch,
                                                         overrides):
    cfg_j, cfg_t = _family_cfgs(arch, overrides)
    ours = lm.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    theirs = rlm.init_params(cfg_j, jax.random.PRNGKey(0))
    assert ("dense_layers" in ours) == (name == "deepseek")
    assert ("shared" in ours) == (name == "zamba2")
    cache = lm.init_cache(cfg_t, 2, 6, "cpu")
    if name == "dense_mla":
        # the reference gives a dense MLA config a GQA cache, which its
        # own mla_decode cannot read; the port gives it the MLA cache
        # (each layer's as the reference's moe family stacks it)
        with pytest.raises(KeyError, match="latent"):
            rlm.decode_step(theirs, cfg_j, rlm.init_cache(cfg_j, 2, 6),
                            jnp.zeros((2, 1), jnp.int32), jnp.int32(0))
        want_cache = {"layers": jax.tree.map(
            lambda a: jnp.stack([a] * cfg_j.num_layers),
            rattention.mla_init_cache(cfg_j, 2, 6, jnp.float32))}
    else:
        want_cache = rlm.init_cache(cfg_j, 2, 6)
    for got, want in ((ours, theirs), (cache, want_cache)):
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat) == len(jax.tree.leaves(got))
        for path, leaf in flat:
            t = got
            for key in path:
                t = t[key.key]
            assert tuple(t.shape) == leaf.shape, path
            assert str(t.dtype).split(".")[1] == str(leaf.dtype), path
    if cfg_t.family == "moe":
        assert ours["layers"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("name,arch,overrides",
                         FAMILIES + [HUBERT_HD80, NEMOTRON_HD192])
def test_family_forward_matches_jax(name, arch, overrides, impl):
    """The hidden states of ``forward`` (patches and frames included)
    within TOL in float32, the JAX package's flash through its Pallas
    kernel in interpret mode; MLA attends densely whatever the impl."""
    cfg_j, cfg_t = _family_cfgs(arch, overrides, attention_impl=impl)
    params, ours = _params(cfg_j)
    bj, bt = _family_batch(cfg_j, 2, 24, seed=11)
    got = lm.forward(ours, cfg_t, bt)
    want = rlm.forward(params, cfg_j, bj)
    assert got.shape == (2, 24 + cfg_t.num_patches, cfg_t.d_model)
    _close(got, want)


@pytest.mark.parametrize("name,arch,overrides",
                         [f for f in FAMILIES
                          if f[0] not in ("hubert", "dense_mla")]
                         + [NEMOTRON_HD192])
def test_family_decode_step_matches_jax(name, arch, overrides):
    """Logits and every cache leaf (GQA or MLA, both layer stacks) over
    eight steps from the same cache; MoE decode is dropless."""
    cfg_j, cfg_t = _family_cfgs(arch, overrides)
    params, ours = _params(cfg_j, seed=3)
    b, max_len, steps = 2, 12, 8
    tok = _tokens(cfg_j, b, steps, seed=6)
    cache_j = rlm.init_cache(cfg_j, b, max_len)
    cache_t = lm.init_cache(cfg_t, b, max_len, "cpu")
    for i in range(steps):
        logits_j, cache_j = rlm.decode_step(params, cfg_j, cache_j,
                                            jnp.asarray(tok[:, i:i + 1]),
                                            jnp.int32(i))
        logits_t, returned = lm.decode_step(ours, cfg_t, cache_t,
                                            torch.from_numpy(
                                                tok[:, i:i + 1]), i)
        assert returned is cache_t
        _close(logits_t, logits_j)
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache_j)[0]:
        t = cache_t
        for key in path:
            t = t[key.key]
        _close(t, leaf)


@pytest.mark.parametrize("name,arch,overrides",
                         [f for f in FAMILIES
                          if f[0] in ("olmoe", "deepseek", "dense_mla",
                                      "mamba2", "zamba2")]
                         + DENSE_FAMILIES)
def test_family_decode_matches_forward_logits(name, arch, overrides):
    """Teacher-forced decode reproduces the forward pass's logits at
    every position (dropless MoE on both paths; the SSM state and conv
    windows against the chunked SSD). For the dense MLA config this is
    the check of decode: the reference's own decode of it raises (see
    the tree test above)."""
    cfg_j, cfg_t = _family_cfgs(arch, overrides)
    _, ours = _params(cfg_j, seed=4)
    b, s = 2, 10
    tok = torch.from_numpy(_tokens(cfg_t, b, s, seed=7))
    hidden = lm.forward(ours, cfg_t, {"tokens": tok})
    full = hidden @ lm.lm_head_weight(lm.cast_params(ours, cfg_t), cfg_t)
    cache = lm.init_cache(cfg_t, b, s, "cpu")
    for i in range(s):
        logits, cache = lm.decode_step(ours, cfg_t, cache, tok[:, i:i + 1],
                                       i)
        _close(logits[:, 0], full[:, i].numpy())


@pytest.mark.parametrize("name,arch,overrides",
                         [f for f in FAMILIES if f[0] in (
                             "internvl2", "dense_mla", "mamba2", "zamba2")]
                         + DENSE_FAMILIES)
def test_family_forward_bf16_matches_jax(name, arch, overrides):
    """The patch frontend, MLA and the SSM families in bf16, within
    TOL_BF16 (the stacked 1-D SSM vectors, ``a_log`` among them, are
    cast to bf16 as the reference's ``cast_params`` casts them; the
    hybrid's unstacked shared norms stay float32). The MoE
    families are held in bf16 layer by layer (``tests/test_torch_moe.py``:
    the same inputs route bit for bit, outputs within one bf16 ulp):
    through a whole model the two packages' bf16 roundings differ in the
    last bit, and a routing near-tie that this flips sends a token to
    another expert, which moves it by O(1)."""
    cfg_j, cfg_t = _family_cfgs(arch, overrides, compute_dtype="bfloat16")
    params, ours = _params(cfg_j)
    bj, bt = _family_batch(cfg_j, 2, 24, seed=12)
    got = lm.forward(ours, cfg_t, bt)
    assert got.dtype == torch.bfloat16
    _close(got, rlm.forward(params, cfg_j, bj).astype(jnp.float32),
           TOL_BF16)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("name,arch,overrides",
                         SSM_FAMILIES + DENSE_FAMILIES)
def test_family_make_prefill_step_matches_jax(name, arch, overrides, impl):
    """32 tokens: two SSD chunks of 16 (the forward tests' 24 tokens
    take the one-chunk fallback); the hybrid's shared block and the
    dense configs' attention through ``impl``."""
    cfg_j, cfg_t = _family_cfgs(arch, overrides, attention_impl=impl)
    params, ours = _params(cfg_j, seed=2)
    assert 32 % cfg_t.ssm_chunk == 0 and 32 > cfg_t.ssm_chunk
    tok = _tokens(cfg_j, 3, 32, seed=5)
    before = dict(fa_kernel.LAUNCHES)
    got = make_prefill_step(cfg_t)(ours, {"tokens": torch.from_numpy(tok)})
    assert fa_kernel.LAUNCHES == before          # the CPU runs no kernel
    want = r_make_prefill_step(cfg_j)(params, {"tokens": jnp.asarray(tok)})
    assert got.shape == (3, 1, cfg_t.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("name,arch,overrides",
                         SSM_FAMILIES + DENSE_FAMILIES)
def test_family_batched_decoder_matches_jax(name, arch, overrides):
    """Five requests at batch 3 (two groups, each from a fresh cache):
    every step's logits within TOL, so the greedy tokens agree."""
    cfg_j, cfg_t = _family_cfgs(arch, overrides)
    params, ours = _params(cfg_j, seed=5)
    rng = np.random.default_rng(9)
    reqs = [(rid, rng.integers(1, cfg_j.vocab_size, 2 + rid).tolist(),
             3 + rid % 3) for rid in range(5)]
    ref_dec = RBatchedDecoder(cfg_j, params, batch_size=3, max_len=16)
    dec = BatchedDecoder(cfg_t, ours, batch_size=3, max_len=16,
                         device="cpu")
    for rid, prompt, budget in reqs:
        ref_dec.submit(RRequest(rid=rid, prompt=prompt,
                                max_new_tokens=budget))
        dec.submit(Request(rid=rid, prompt=prompt, max_new_tokens=budget))
    want = {r.rid: r.tokens for r in ref_dec.run()}
    got = {r.rid: r.tokens for r in dec.run()}
    assert got == want
    assert all(len(got[rid]) == budget for rid, _, budget in reqs)


# -- the roofline probe's stub attention -----------------------------------------

def test_stub_attention_raises():
    """The ``"stub"`` probe (the fused kernel's byte model, used by
    ``launch/roofline.py``) no longer raises: the forward through it
    matches the JAX package's and launches no kernel."""
    cfg_j, cfg_t = _cfgs(attention_impl="stub")
    params, ours = _params(cfg_j)
    tok = _tokens(cfg_j, 2, 16)
    before = dict(fa_kernel.LAUNCHES)
    got = lm.forward(ours, cfg_t, {"tokens": torch.from_numpy(tok)})
    assert fa_kernel.LAUNCHES == before
    _close(got, rlm.forward(params, cfg_j, {"tokens": jnp.asarray(tok)}))


@pytest.mark.parametrize("arch", ["qwen3_4b", "olmoe_1b_7b",
                                  "deepseek_v2_236b", "mamba2_1_3b",
                                  "zamba2_1_2b", "starcoder2_7b",
                                  "nemotron_4_340b"])
def test_serve_cli_runs_on_the_cpu(capsys, arch):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--tokens", "3", "--batch", "2", "--max-len", "8"])
    out = capsys.readouterr().out
    assert "generated 3 tokens x batch 2" in out and "on cpu" in out
