"""The port's long-context paths against the JAX package's, on the CPU.

The card runs the JAX package's four LM input shapes (``SHAPES``:
``prefill_32k``, ``decode_32k``, ``long_500k``, ``train_4k``) at
published widths; here the same paths run at smoke widths on seeded
numpy inputs through both packages:

* one ``decode_step`` at pos = T - 1 and T / 2 over a cache of T = 1024
  rows whose every leaf holds seeded normal draws (as the card's decode
  phases fill theirs), for the dense config and the hybrid: the logits
  and every cache leaf; and at the shapes' own last positions, 32 767
  and 524 287, at the published head dim 128 and RoPE theta, where an
  ulp of a RoPE frequency would show;
* the RoPE frequencies of every config, bit for bit with those the
  reference's traced model uses;
* the flash wrapper's plain version (the CPU path) at S = 2048 and 4096
  against the JAX package's ``attention_ref``, whole and in blocks of
  query rows (``SCORE_BLOCK_BYTES``: how the host fits 32 768 tokens);
* ``attention_rows_ref``, the row-slice plain version the card's flash
  checks at 32 768 tokens use, against the matching rows of the JAX
  package's ``attention_ref``;
* a train step at 1 x 1024 tokens;
* the card phases' cache check itself (``chip_smoke.kv_slots_check``):
  it passes a decode step and catches a write to another slot or a
  slot left unwritten.

Tolerances are those of ``tests/test_torch_lm.py`` and
``tests/test_torch_train.py``: 1e-4 in float32 (the same arithmetic,
sums in another order), 5e-2 in bf16 (both sides round every matmul
output to bf16 at places that can differ between XLA and PyTorch);
attention 2e-5 absolute in float32 (softmax and two products of at most
4096 terms); the train step's params by relative L2 within 1e-4.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.kernels.flash_attention import ref as rref
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.train import data as rdata
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import layers, lm
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ATTN_TOL = 2e-5
CACHE_ROWS = 1024


def _cfgs(arch, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (rbase.get_smoke_config(arch).reduced(**kw),
            get_smoke_config(arch).reduced(**kw))


def _params(cfg_j, seed=0):
    params = rlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    return params, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _cache_leaves(cfg):
    """Leaves of a cache tree: keys and values (or MLA's latent and RoPE
    key) a layer group, the hybrid's SSM states and conv windows too
    (Mamba2's alone: the state and three windows); DeepSeek-V2's dense
    first layers are a group of their own."""
    return 6 if cfg.family == "hybrid" else 4 if cfg.first_k_dense \
        or cfg.family == "ssm" else 2


def _filled_caches(cfg_j, cfg_t, b, t, seed):
    """The JAX package's and the port's caches of ``t`` rows, every leaf
    the same seeded normal draws (rounded once to the leaf's dtype)."""
    rng = np.random.default_rng(seed)
    cache_j = rlm.init_cache(cfg_j, b, t)
    cache_t = lm.init_cache(cfg_t, b, t, "cpu")
    flat, tree = jax.tree_util.tree_flatten_with_path(cache_j)
    leaves = []
    for path, leaf in flat:
        draw = rng.standard_normal(leaf.shape).astype(np.float32)
        leaves.append(jnp.asarray(draw).astype(leaf.dtype))
        port = _leaf(cache_t, path)
        port.copy_(torch.from_numpy(draw).to(port.dtype))
    return jax.tree_util.tree_unflatten(tree, leaves), cache_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["last", "middle"])
@pytest.mark.parametrize("arch", ["qwen3_4b", "zamba2_1_2b", "olmoe_1b_7b",
                                  "deepseek_v2_236b", "mamba2_1_3b"])
def test_decode_step_over_a_filled_cache_matches_jax(arch, where, dtype):
    """One step at pos = T - 1 (every row attended) or T / 2 (the rows
    after it masked) over a cache of 1024 rows of seeded draws: the
    logits and every cache leaf (the written slot, the untouched rows,
    the hybrid's and Mamba2's SSM states and conv windows) as the JAX
    package's; batch 2, as the card's decode_32k steps run at batch > 1
    (Mamba2 at the shape's whole batch of 128)."""
    cfg_j, cfg_t = _cfgs(arch, compute_dtype=dtype)
    params, ours = _params(cfg_j, seed=5)
    b, t = 2, CACHE_ROWS
    pos = t - 1 if where == "last" else t // 2
    cache_j, cache_t = _filled_caches(cfg_j, cfg_t, b, t, seed=7)
    tok = np.random.default_rng(9).integers(
        0, cfg_j.vocab_size, (b, 1)).astype(np.int32)
    logits_j, cache_j = rlm.decode_step(params, cfg_j, cache_j,
                                        jnp.asarray(tok), jnp.int32(pos))
    logits_t, returned = lm.decode_step(ours, cfg_t, cache_t,
                                        torch.from_numpy(tok), pos)
    assert returned is cache_t and logits_t.dtype == torch.float32
    _close(logits_t, logits_j, TOL[dtype])
    flat = jax.tree_util.tree_flatten_with_path(cache_j)[0]
    assert len(flat) == _cache_leaves(cfg_t)
    for path, leaf in flat:
        _close(_leaf(cache_t, path), leaf, TOL[dtype])


# (arch, the shapes' lengths it decodes at): the MoE and MLA configs
# decode at decode_32k only (long_500k needs an SSM or the hybrid)
LAST_POSITION = [("qwen3_4b", 32768), ("qwen3_4b", 524288),
                 ("zamba2_1_2b", 32768), ("zamba2_1_2b", 524288),
                 ("olmoe_1b_7b", 32768), ("deepseek_v2_236b", 32768),
                 ("nemotron_4_340b", 32768), ("internvl2_26b", 32768),
                 ("starcoder2_7b", 32768), ("deepseek_67b", 32768)]
# the smoke configs at the published RoPE head dim (MLA's RoPE part,
# 64, is DeepSeek-V2's qk_rope_head_dim; Nemotron-4-340B's 192, whose
# half is not a power of two; InternVL2-26B's, StarCoder2-7B's and
# DeepSeek-67B's 128 at their thetas 1e6, 1e5 and 1e4) and the depth of
# one attention layer: the dense and MoE configs 1 layer, the hybrid one
# shared application, DeepSeek-V2 its dense first layer and one MoE
# layer
LAST_POSITION_CFG = {
    "qwen3_4b": dict(head_dim=128, num_kv_heads=1, num_layers=1),
    "zamba2_1_2b": dict(head_dim=128, num_kv_heads=1, num_layers=2),
    "olmoe_1b_7b": dict(head_dim=128, num_kv_heads=1, num_layers=1),
    "deepseek_v2_236b": dict(qk_rope_head_dim=64, num_layers=2),
    "nemotron_4_340b": dict(head_dim=192, num_kv_heads=1, num_layers=1),
    "internvl2_26b": dict(head_dim=128, num_kv_heads=1, num_layers=1),
    "starcoder2_7b": dict(head_dim=128, num_kv_heads=1, num_layers=1),
    "deepseek_67b": dict(head_dim=128, num_kv_heads=1, num_layers=1)}


@pytest.mark.parametrize("arch,t", LAST_POSITION)
def test_decode_step_at_the_shapes_last_position_matches_jax(arch, t):
    """One float32 step at pos = T - 1 over a filled cache of T rows, the
    length of decode_32k or long_500k, at smoke width but the published
    RoPE head dim (128; MLA's 64) and theta: at position p an ulp of a
    frequency turns its angle by about p ulps, so the keys written there
    show whether the port's frequencies are the reference's. One
    attention layer (``LAST_POSITION_CFG``), one KV head where the
    config has them, to keep the cache small."""
    cfg_j, cfg_t = _cfgs(arch, **LAST_POSITION_CFG[arch])
    params, ours = _params(cfg_j, seed=5)
    pos = t - 1
    cache_j, cache_t = _filled_caches(cfg_j, cfg_t, 1, t, seed=7)
    tok = np.random.default_rng(9).integers(
        0, cfg_j.vocab_size, (1, 1)).astype(np.int32)
    logits_j, cache_j = rlm.decode_step(params, cfg_j, cache_j,
                                        jnp.asarray(tok), jnp.int32(pos))
    logits_t, _ = lm.decode_step(ours, cfg_t, cache_t, torch.from_numpy(tok),
                                 pos)
    _close(logits_t, logits_j, TOL["float32"])
    flat = jax.tree_util.tree_flatten_with_path(cache_j)[0]
    assert len(flat) == _cache_leaves(cfg_t)
    for path, leaf in flat:
        _close(_leaf(cache_t, path), leaf, TOL["float32"])


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "mamba2_1_3b"])
def test_rope_frequencies_are_the_reference_traced_values(arch):
    """The port's frequencies (float64, rounded once) bit for bit with the
    reference's ``rope_frequencies`` as its model runs it, traced (XLA
    folds the constant), at the config's RoPE head dim and theta."""
    cfg = get_config(arch)
    hd = cfg.qk_rope_head_dim if cfg.use_mla else cfg.resolved_head_dim
    want = jax.jit(rlayers.rope_frequencies, static_argnums=(0, 1))(
        hd, cfg.rope_theta)
    got = layers.rope_frequencies(hd, cfg.rope_theta, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("s,h,kv,causal,hd", [
    pytest.param(2048, 4, 2, True, 32, id="2048-4-2-True"),
    pytest.param(2048, 4, 4, False, 32, id="2048-4-4-False"),
    pytest.param(4096, 2, 1, True, 32, id="4096-2-1-True"),
    pytest.param(2048, 12, 1, True, 192, id="2048-12-1-True-hd192")])
def test_flash_plain_version_at_long_length_matches_jax(monkeypatch, s, h,
                                                        kv, causal, hd,
                                                        blocked):
    """The flash wrapper on CPU tensors (its plain version) against the
    JAX package's dense ``attention_ref``, whole and in blocks of 300
    query rows (the host's path at 32 768 tokens), float32; at hd 32,
    and at Nemotron-4-340B's hd 192 with a group of 12 query heads a KV
    head (its 96 / 8)."""
    if blocked:
        monkeypatch.setattr(fa_ref, "SCORE_BLOCK_BYTES", 4 * h * s * 300)
    rng = np.random.default_rng(s + h)
    q = rng.standard_normal((1, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((1, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((1, s, kv, hd)).astype(np.float32)
    before = dict(fa_kernel.LAUNCHES)
    got = fa_kernel.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    assert fa_kernel.LAUNCHES == before         # the CPU launches nothing
    want = rref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("rows", [1, 512])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("causal", [True, False])
def test_row_slice_plain_version_matches_jax_rows(rows, where, causal):
    """``attention_rows_ref`` on rows r0 .. r0 + R of q, all keys, the
    causal mask at the rows' absolute positions: the same rows of the
    JAX package's ``attention_ref`` over the whole sequence (GQA 8 / 2,
    2048 tokens, float32)."""
    s = 2048
    r0 = {"first": 0, "middle": (s - rows) // 2, "last": s - rows}[where]
    rng = np.random.default_rng(rows + r0)
    q = rng.standard_normal((2, s, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    got = fa_ref.attention_rows_ref(torch.from_numpy(q[:, r0:r0 + rows]),
                                    torch.from_numpy(k), torch.from_numpy(v),
                                    r0, causal=causal)
    want = rref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal)
    assert got.shape == (2, rows, 8, 16)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want)[:, r0:r0 + rows], rtol=0,
                               atol=ATTN_TOL)


def _rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel2(got, want):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", ["qwen3_4b", "zamba2_1_2b", "olmoe_1b_7b",
                                  "mamba2_1_3b", "hubert_xlarge"])
def test_train_step_at_1024_tokens_matches_jax(arch):
    """One float32 train step on one sequence of 1024 tokens: the loss,
    the gradient norm and the learning rate within 1e-4, every param
    after the step within 1e-4 by relative L2 (Adam divides each
    gradient by its own magnitude), the first moments within 1e-4."""
    cfg_j, cfg_t = _cfgs(arch, num_layers=2)
    pj, pt = _params(cfg_j, seed=11)
    sj = ropt.init_opt_state(pj)
    st = convert.opt_state_from_numpy(jax.tree.map(np.asarray, sj),
                                      device="cpu")
    batch = rdata.synthetic_batch(cfg_j, rdata.DataConfig(
        seq_len=1024, global_batch=1, seed=13), 0)
    oc = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    pj, sj, mj = jax.jit(rts.make_train_step(cfg_j, ropt.OptimizerConfig(
        **oc)))(pj, sj, {k: jnp.asarray(v) for k, v in batch.items()})
    pt, st, mt = tts.make_train_step(cfg_t, topt.OptimizerConfig(**oc))(
        pt, st, tdata.to_device(batch, "cpu"))
    for key in ("loss", "grad_norm", "lr"):
        assert _rel(mt[key], mj[key]) <= 1e-4, key
    flat = jax.tree_util.tree_flatten_with_path(pj)[0]
    for path, want in flat:
        assert _rel2(_leaf(pt, path), want) <= 1e-4, path
    for path, want in jax.tree_util.tree_flatten_with_path(sj["m"])[0]:
        assert _rel(_leaf(st["m"], path), want) <= 1e-4, path


@pytest.fixture
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
        yield chip_smoke
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.parametrize("arch", ["qwen3_4b", "zamba2_1_2b",
                                  "deepseek_v2_236b"])
def test_card_cache_check_passes_a_step_and_catches_a_stray_write(
        chip_smoke, arch):
    """The decode phases' check, run here on CPU tensors: after one
    ``decode_step`` over a cache filled by ``fill_cache``, slot pos no
    longer holds its draw and every other slot does (keys and values, or
    MLA's latent and RoPE key); a write to another slot, or slot pos left
    holding its draw, fails it."""
    cfg = get_smoke_config(arch).reduced(compute_dtype="bfloat16")
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, torch.Generator().manual_seed(1), cpu)
    b, t = 2, 64
    pos = t - 1
    tok = torch.randint(0, cfg.vocab_size, (b, 1),
                        generator=torch.Generator().manual_seed(2))

    def filled():
        cache = lm.init_cache(cfg, b, t, cpu)
        chip_smoke.fill_cache(torch, cache, 3, cpu)
        return cache

    def stepped():
        cache = filled()
        lm.decode_step(params, cfg, cache, tok, pos)
        return cache

    layers = 1 if cfg.family == "hybrid" else cfg.num_layers
    out = chip_smoke.kv_slots_check(torch, stepped(), 3, cpu, pos)
    assert out["kv_leaves_checked"] == 2 * layers
    key = "shared" if cfg.family == "hybrid" else "layers"
    k, v = ("latent", "k_rope") if cfg.use_mla else ("k", "v")
    stray = stepped()
    stray[key][v][0][:, 5] += 1.0
    with pytest.raises(chip_smoke.SmokeFailure, match="other than"):
        chip_smoke.kv_slots_check(torch, stray, 3, cpu, pos)
    stale = stepped()
    stale[key][k][0][:, pos] = filled()[key][k][0][:, pos]
    with pytest.raises(chip_smoke.SmokeFailure, match="not written"):
        chip_smoke.kv_slots_check(torch, stale, 3, cpu, pos)
