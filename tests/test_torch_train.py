"""The port's training path against the JAX package's.

The smoke config of Qwen3-4B cut to 2 layers (d_model 128, vocab 512),
``ce_chunk`` 16, sequences of 32 tokens, batch 4. The JAX package's
``init_params`` draws the weights; ``convert`` carries them (and the
optimizer state) across, so both packages start from the same values;
batches come from each package's ``synthetic_batch``, which agree byte
for byte. Everything runs on ``device="cpu"``.

"rel" below is per tensor: max |got - want| / max |want|; for params
after a train step "rel2" is ||got - want||_2 / ||want||_2, because
Adam divides each gradient by its own magnitude (plus eps = 1e-8), so a
1e-6 difference in a gradient element near 1e-8 moves that element's
update by up to the learning rate. Tolerances:
the chunked cross-entropy 1e-5 (float32 on both sides, only the order
of sums differs); ``loss_fn`` 1e-5 and each gradient leaf 1e-4 in
float32 compute, the loss 2e-2 in bf16 compute (both sides round every
matmul and weight to bf16 at places that differ between XLA and
PyTorch); ``lr_at`` and ``adamw_update`` 1e-6 (float32 arithmetic op for
op; ``pow`` and the norm's sum may differ in the last bit); train steps
and the loop's losses 1e-4 (the gradients' tolerance carried through
Adam); a bf16 head's gradient within one bf16 ulp.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.distributed import checkpoint as rckpt
from repro.distributed import compression as rcomp
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.train import data as rdata
from repro.train import loop as rloop
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed import compression as tcomp
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.train import data as tdata
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.tree import tree_leaves, tree_map

SMALL = {"num_layers": 2, "ce_chunk": 16}
DATA = dict(seq_len=32, global_batch=4)


def _cfgs(**kw):
    kw = {**SMALL, **kw}
    return (rbase.get_smoke_config("qwen3_4b").reduced(**kw),
            get_smoke_config("qwen3_4b").reduced(**kw))


def _params(cfg_j, seed=0):
    params = rlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    return params, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


def _batches(cfg_j, seed=1, step=0):
    b = rdata.synthetic_batch(cfg_j, rdata.DataConfig(**DATA, seed=seed),
                              step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            tdata.to_device(b, "cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pairs(want_tree, got_tree, path=()):
    """(path, want, got) for every leaf of the JAX tree, looked up by key
    in the port's tree."""
    if isinstance(want_tree, dict):
        for k, v in want_tree.items():
            yield from _pairs(v, got_tree[k], path + (k,))
    else:
        yield "/".join(path), want_tree, got_tree


def rel2(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _assert_trees_close(got, want, tol, measure=rel):
    for path, w, g in _pairs(want, got):
        assert measure(g, w) <= tol, (path, measure(g, w))


# -- chunked cross-entropy ----------------------------------------------------

def _xent_inputs(b, s, d, v, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    return x, w, labels


@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 16), (12, 5)])
def test_chunked_xent_value_and_grads_match_the_reference(s, chunk):
    """Forward and (dx, dw) against ``jax.value_and_grad`` of the
    reference's ``custom_vjp``; (12, 5) falls back to the whole
    sequence."""
    x, w, labels = _xent_inputs(2, s, 8, 32)
    want, (wdx, wdw) = jax.value_and_grad(
        lambda a, b: rlayers.chunked_softmax_xent(a, b, jnp.asarray(labels),
                                                  chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = tlayers.chunked_softmax_xent(tx, tw, torch.from_numpy(labels),
                                       chunk)
    got.backward()
    assert rel(got, want) <= 1e-5
    assert rel(tx.grad, wdx) <= 1e-5
    assert rel(tw.grad, wdw) <= 1e-5
    assert tx.grad.dtype == torch.float32 and tw.grad.dtype == torch.float32


def test_chunked_xent_bf16_head_gradient_comes_back_in_bf16():
    """The reference rounds dw to the head's dtype (``:197``); so does the
    port: a bf16 head gets a bf16 gradient within one bf16 ulp of the
    reference's."""
    x, w, labels = _xent_inputs(2, 16, 8, 32, seed=3)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, (wdx, wdw) = jax.value_and_grad(
        lambda a, b: rlayers.chunked_softmax_xent(a, b, jnp.asarray(labels),
                                                  4), argnums=(0, 1))(xb, wb)
    assert wdw.dtype == jnp.bfloat16
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    got = tlayers.chunked_softmax_xent(tx, tw, torch.from_numpy(labels), 4)
    got.backward()
    assert tw.grad.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16
    assert rel(got, want) <= 1e-5
    for g, r in ((tw.grad, wdw), (tx.grad, wdx)):
        g, r = _np(g), _np(r)
        ulp = np.abs(r) * 2.0 ** -7
        assert (np.abs(g - r) <= np.maximum(ulp, 1e-30)).all()


def test_onehot_lookup_equals_the_gather_and_the_reference():
    rng = np.random.default_rng(4)
    embed = rng.normal(size=(40, 8)).astype(np.float32)
    tok = rng.integers(0, 40, (3, 12)).astype(np.int32)
    for chunk in (4, 5):
        got = tlayers.onehot_embed_lookup(torch.from_numpy(embed),
                                          torch.from_numpy(tok), chunk,
                                          torch.float32)
        want = rlayers.onehot_embed_lookup(jnp.asarray(embed),
                                           jnp.asarray(tok), chunk,
                                           jnp.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), embed[tok])


# -- loss_fn -------------------------------------------------------------------

def test_loss_and_every_gradient_match_the_reference_in_float32():
    cj, ct = _cfgs(compute_dtype="float32")
    pj, pt = _params(cj)
    bj, bt = _batches(cj)
    want, wgrads = jax.value_and_grad(lambda p: rlm.loss_fn(p, cj, bj))(pj)
    leaves = tree_map(lambda a: a.clone().requires_grad_(), pt)
    got = tlm.loss_fn(leaves, ct, bt)
    got.backward()
    assert rel(got, want) <= 1e-5
    _assert_trees_close(tree_map(lambda a: a.grad, leaves), wgrads, 1e-4)
    # the train step's per-layer leaves give the same gradients
    loss, grads = tts.value_and_grad(pt, ct, bt)
    assert float(loss) == float(got.detach())
    _assert_trees_close(grads, wgrads, 1e-4)


def test_loss_matches_the_reference_in_bf16():
    cj, ct = _cfgs()
    assert ct.compute_dtype == "bfloat16"
    pj, pt = _params(cj)
    bj, bt = _batches(cj)
    want = float(rlm.loss_fn(pj, cj, bj))
    got = float(tlm.loss_fn(pt, ct, bt))
    assert abs(got - want) <= 2e-2 * abs(want)
    _, grads = tts.value_and_grad(pt, ct, bt)
    assert grads["embed"].dtype == torch.float32
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


@pytest.mark.parametrize("form", ["no_remat", "remat_group", "onehot"])
def test_remat_and_onehot_change_no_gradient(form):
    """``remat`` off, the two-level ``remat_group`` and ``onehot_embed``
    give the gradients of the default (per-layer remat, gather)."""
    cj, ct = _cfgs(compute_dtype="float32")
    _, pt = _params(cj)
    _, bt = _batches(cj)
    other = {"no_remat": dict(remat=False),
             "remat_group": dict(remat_group=2),
             "onehot": dict(onehot_embed=True)}[form]
    base_loss, base = tts.value_and_grad(pt, ct, bt)
    loss, grads = tts.value_and_grad(pt, dataclasses.replace(ct, **other),
                                     bt)
    assert rel(loss, base_loss) <= 1e-6
    for _, w, g in _pairs(base, grads):
        assert rel(g, w) <= 1e-5


def test_forward_under_no_grad_is_the_serving_forward():
    cj, ct = _cfgs(compute_dtype="float32")
    pj, pt = _params(cj)
    bj, bt = _batches(cj)
    with torch.no_grad():
        got = tlm.forward(pt, ct, bt)
    assert not got.requires_grad
    assert rel(got, rlm.forward(pj, cj, bj)) <= 1e-4
    np.testing.assert_array_equal(
        got.numpy(), tlm.forward(tlm.split_layers(pt), ct, bt).detach()
        .numpy())


def test_flash_attention_under_autograd_raises_in_both_packages():
    cj, ct = _cfgs(compute_dtype="float32", attention_impl="flash")
    pj, pt = _params(cj)
    bj, bt = _batches(cj)
    with pytest.raises(AssertionError):
        jax.grad(lambda p: rlm.loss_fn(p, cj, bj))(pj)
    with pytest.raises(NotImplementedError, match="no backward"):
        tts.value_and_grad(pt, ct, bt)
    # without autograd the flash path still serves
    with torch.no_grad():
        assert bool(torch.isfinite(tlm.loss_fn(pt, ct, bt)))


# -- the other families: moe, MLA, vlm, audio, ssm, hybrid ------------------

# the smoke configs (OLMoE at its published capacity factor 1.25, so
# that training runs the capacity path), a dense config with MLA, Mamba2
# and Zamba2 (its shared block applied once in 2 layers: one set of
# leaves whose gradient autograd sums over its uses), and the dense
# configs whose MLPs are GELU (StarCoder2-7B), SwiGLU at norm eps 1e-6
# (DeepSeek-67B) and squared ReLU (Nemotron-4-340B)
FAMILIES = [("olmoe_cf125", "olmoe_1b_7b", {"moe_capacity_factor": 1.25}),
            ("deepseek", "deepseek_v2_236b", {}),
            ("internvl2", "internvl2_26b", {}),
            ("hubert", "hubert_xlarge", {}),
            ("dense_mla", "deepseek_v2_236b", {"family": "dense"}),
            ("mamba2", "mamba2_1_3b", {}),
            ("zamba2", "zamba2_1_2b", {}),
            ("starcoder2", "starcoder2_7b", {}),
            ("deepseek_67b", "deepseek_67b", {}),
            ("nemotron", "nemotron_4_340b", {})]


def _family(arch, overrides, **kw):
    kw = {**SMALL, "compute_dtype": "float32", **overrides, **kw}
    cj = rbase.get_smoke_config(arch).reduced(**kw)
    ct = get_smoke_config(arch).reduced(**kw)
    pj, pt = _params(cj)
    bj, bt = _batches(cj)
    return cj, ct, pj, pt, bj, bt


@pytest.mark.parametrize("name,arch,overrides", FAMILIES)
def test_family_loss_and_every_gradient_match_the_reference(name, arch,
                                                            overrides):
    """``loss_fn`` (the patch positions sliced off, the MoE auxiliary
    term on the uncast router) within 1e-5 and every gradient leaf,
    ``dense_layers`` and the hybrid's ``shared`` included, within 1e-4,
    through stacked leaves and through the train step's per-layer
    leaves."""
    cj, ct, pj, pt, bj, bt = _family(arch, overrides)
    want, wgrads = jax.value_and_grad(lambda p: rlm.loss_fn(p, cj, bj))(pj)
    leaves = tree_map(lambda a: a.clone().requires_grad_(), pt)
    got = tlm.loss_fn(leaves, ct, bt)
    got.backward()
    assert rel(got, want) <= 1e-5
    # a leaf the loss never reads (the frame frontend's embedding) gets
    # no .grad from autograd, and zeros from jax.grad
    _assert_trees_close(tree_map(lambda a: torch.zeros_like(a)
                                 if a.grad is None else a.grad, leaves),
                        wgrads, 1e-4)
    loss, grads = tts.value_and_grad(pt, ct, bt)
    assert float(loss) == float(got.detach())
    _assert_trees_close(grads, wgrads, 1e-4)
    assert ("dense_layers" in grads) == (name == "deepseek")
    assert ("shared" in grads) == (name == "zamba2")


@pytest.mark.parametrize("name,arch,overrides", FAMILIES)
def test_family_train_step_matches_the_reference(name, arch, overrides):
    cj, ct, pj, pt, bj, bt = _family(arch, overrides)
    sj, st = _opt(pj)
    oc = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    pj, sj, mj = jax.jit(rts.make_train_step(
        cj, ropt.OptimizerConfig(**oc)))(pj, sj, bj)
    pt, st, mt = tts.make_train_step(ct, topt.OptimizerConfig(**oc))(
        pt, st, bt)
    for key in ("loss", "grad_norm", "lr"):
        assert rel(mt[key], mj[key]) <= 1e-4, key
    _assert_trees_close(pt, pj, 1e-4, rel2)
    _assert_trees_close(st["m"], sj["m"], 1e-4)


def test_moe_aux_term_is_the_reference_router_loss():
    """The MoE loss is the cross-entropy plus MOE_AUX_COEF times the
    first MoE layer's load-balance loss on the final hidden states; the
    router it reads is the float32 one, uncast, in bf16 compute too."""
    cj, ct, pj, pt, bj, bt = _family("olmoe_1b_7b", {},
                                     compute_dtype="bfloat16")
    assert tlm.MOE_AUX_COEF == rlm.MOE_AUX_COEF
    assert pt["layers"]["moe"]["router"].dtype == torch.float32
    x = tlm.forward(pt, ct, bt)
    first = tlm._first_moe_params(pt)
    assert first["router"].data_ptr() == \
        pt["layers"]["moe"]["router"].data_ptr()
    assert first["router"].dtype == torch.float32
    aux = tmoe.aux_load_balance_loss(first, ct, x)
    xent = tlayers.chunked_softmax_xent(
        x, tlm.lm_head_weight(pt, ct).to(torch.bfloat16), bt["labels"],
        ct.ce_chunk)
    assert float(tlm.loss_fn(pt, ct, bt)) == float(
        xent + tlm.MOE_AUX_COEF * aux)
    want = rmoe.aux_load_balance_loss(
        rlm._first_moe_params(pj), cj, rlm.forward(pj, cj, bj))
    assert abs(float(aux) - float(want)) <= 1e-2 * float(want)


@pytest.mark.parametrize("remat", [True, False])
def test_both_layer_stacks_checkpoint_and_alias_their_gradients(
        monkeypatch, remat):
    """DeepSeek-V2's smoke config (one dense layer, then MoE layers):
    with ``remat`` each layer of both stacks runs under one checkpoint
    (none without it), and the train step's per-layer leaves alias the
    params with ``.grad`` a view of one stacked gradient buffer a
    stack; the gradients are the same either way."""
    cj, ct, pj, pt, bj, bt = _family("deepseek_v2_236b", {}, num_layers=3,
                                     remat=remat)
    assert ct.first_k_dense == 1
    calls = []
    real = tlm.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(tlm, "checkpoint", counted)
    grads = tree_map(torch.zeros_like, pt)
    leaves = tts._grad_leaves(pt, grads)
    for stack in ("dense_layers", "layers"):
        assert isinstance(leaves[stack], list)
        for i, layer in enumerate(leaves[stack]):
            for path, want, got in _pairs(tlm._layer(pt[stack], i), layer):
                assert got.data_ptr() == want.data_ptr(), path
                g = grads[stack]
                for key in path.split("/"):
                    g = g[key]
                assert got.grad._base is g, path          # one buffer
                assert got.grad.data_ptr() == g[i].data_ptr(), path
    with torch.enable_grad():
        tlm.loss_fn(leaves, ct, bt).backward()
    assert len(calls) == (ct.num_layers if remat else 0)
    _, wgrads = jax.value_and_grad(lambda p: rlm.loss_fn(p, cj, bj))(pj)
    _assert_trees_close(grads, wgrads, 1e-4)
    assert bool(grads["dense_layers"]["mlp"]["wi"].abs().sum() > 0)


@pytest.mark.parametrize("remat", [True, False])
def test_hybrid_checkpoint_holds_each_shared_application(monkeypatch,
                                                          remat):
    """Zamba2 at 4 layers (shared after layers 1 and 3): with ``remat``
    one checkpoint a layer, and each layer's checkpoint holds the shared
    application after it, so the backward runs the shared block again
    (once more per application); the gradients of the shared leaves are
    summed over both applications, as the reference's."""
    cj, ct, pj, pt, bj, bt = _family("zamba2_1_2b", {}, num_layers=4,
                                     remat=remat)
    assert ct.shared_attn_every == 2
    calls, shared = [], []
    real_ckpt, real_shared = tlm.checkpoint, tlm._shared_block

    def counted(fn, *args, **kw):
        calls.append(fn)
        return real_ckpt(fn, *args, **kw)

    def counted_shared(*args):
        shared.append(torch.is_grad_enabled())
        return real_shared(*args)

    monkeypatch.setattr(tlm, "checkpoint", counted)
    monkeypatch.setattr(tlm, "_shared_block", counted_shared)
    _, grads = tts.value_and_grad(pt, ct, bt)
    assert len(calls) == (4 if remat else 0)
    assert len(shared) == (4 if remat else 2)
    _, wgrads = jax.value_and_grad(lambda p: rlm.loss_fn(p, cj, bj))(pj)
    _assert_trees_close(grads, wgrads, 1e-4)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_moe_and_mla_trees_cross_unchanged(param_dtype):
    """``convert`` carries DeepSeek-V2's tree (a float32 router, stacked
    (L, E, d, f) experts, ``shared``, ``dense_layers``, MLA) both ways,
    bit for bit."""
    cj = rbase.get_smoke_config("deepseek_v2_236b").reduced(
        param_dtype=param_dtype, num_layers=3)
    pj = jax.tree.map(np.asarray, rlm.init_params(cj, jax.random.PRNGKey(2)))
    pt = convert.lm_params_from_numpy(pj, device="cpu")
    moe_p = pt["layers"]["moe"]
    assert moe_p["router"].dtype == torch.float32
    assert tuple(moe_p["wi"].shape) == (2, cj.num_experts, cj.d_model,
                                        cj.moe_d_ff)
    assert "shared" in moe_p and "latent" not in pt["layers"]["attn"]
    assert tuple(pt["dense_layers"]["attn"]["wkv_a"].shape) == (
        1, cj.d_model, cj.kv_lora_rank + cj.qk_rope_head_dim)
    back = convert.lm_params_to_numpy(pt)
    n = 0
    for path, want, got in _pairs(pj, back):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), \
            path
        n += 1
    assert n == len(jax.tree.leaves(pj))


def test_eval_step_equals_loss_fn():
    cj, ct = _cfgs(compute_dtype="float32")
    pj, pt = _params(cj)
    bj, bt = _batches(cj)
    got = tts.make_eval_step(ct)(pt, bt)
    assert not got.requires_grad
    assert float(got) == float(tlm.loss_fn(pt, ct, bt))
    assert rel(got, rts.make_eval_step(cj)(pj, bj)) <= 1e-5


# -- optimizer -----------------------------------------------------------------

def test_lr_schedule_matches_the_reference_at_every_step():
    oc = dict(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10, total_steps=100)
    ro, to = ropt.OptimizerConfig(**oc), topt.OptimizerConfig(**oc)
    assert dataclasses.asdict(ro) == dataclasses.asdict(to)
    for s in range(0, 111):
        want = float(ropt.lr_at(ro, jnp.int32(s)))
        got = float(topt.lr_at(to, torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, (s, got, want)
    assert float(topt.lr_at(to, torch.tensor(0))) == 0.0


@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_adamw_update_matches_the_reference(clip):
    """Three updates from the same params, grads and state (``clip``
    1e-3 makes the clip scale bite)."""
    cj, ct = _cfgs()
    pj, pt = _params(cj)
    oc = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    ro, to = ropt.OptimizerConfig(**oc), topt.OptimizerConfig(**oc)
    sj = ropt.init_opt_state(pj)
    st = convert.opt_state_from_numpy(jax.tree.map(np.asarray, sj),
                                      device="cpu")
    rng = np.random.default_rng(7)
    for i in range(3):
        gj = jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32) * 0.01), pj)
        gt = convert.lm_params_from_numpy(jax.tree.map(np.asarray, gj),
                                          device="cpu")
        pj, sj, mj = ropt.adamw_update(ro, pj, gj, sj)
        pt2, st, mt = topt.adamw_update(to, pt, gt, st)
        assert pt2 is pt                      # updated in place
        assert int(st["step"]) == int(sj["step"]) == i + 1
        assert st["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            assert rel(mt[key], mj[key]) <= 1e-6, key
        _assert_trees_close(pt, pj, 1e-6)
        _assert_trees_close(st["m"], sj["m"], 1e-6)
        _assert_trees_close(st["v"], sj["v"], 1e-6)


def test_global_norm_of_a_large_leaf_matches_the_reference():
    """A leaf of 2^25 elements (StarCoder2-7B's embedding gradient has
    2^27.8) on one thread: within 1e-6 of the exact norm and of the
    reference's ``global_norm``. A float32 BLAS dot over the whole leaf
    was 8e-5 off here, and put the card's f32 train step 7.8e-5 from the
    host's in ``grad_norm`` at StarCoder2-7B's width."""
    rng = np.random.default_rng(12)
    g = (rng.standard_normal(1 << 25) * 1e-3).astype(np.float32)
    exact = float(np.sqrt(np.sum(np.square(g, dtype=np.float64))))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = float(topt.global_norm({"w": torch.from_numpy(g),
                                      "b": torch.ones(3)}))
    finally:
        torch.set_num_threads(threads)
    want = float(ropt.global_norm({"w": jnp.asarray(g),
                                   "b": jnp.ones(3)}))
    exact = float(np.sqrt(exact ** 2 + 3))
    assert abs(got - exact) <= 1e-6 * exact
    assert abs(got - want) <= 1e-6 * want


def test_adamw_decays_every_leaf_of_two_dims_or_more():
    """Decay on the stacked (L, d) norm vectors too, none on the 1-d
    final norm: with zero grads only the decay moves a param."""
    cj, _ = _cfgs()
    _, pt = _params(cj)
    before = tree_map(torch.clone, pt)
    zeros = tree_map(torch.zeros_like, pt)
    to = topt.OptimizerConfig(peak_lr=1e-2, warmup_steps=1)
    topt.adamw_update(to, pt, zeros, topt.init_opt_state(pt))
    assert not torch.equal(pt["layers"]["attn_norm"],
                           before["layers"]["attn_norm"])
    assert torch.equal(pt["final_norm"], before["final_norm"])


# -- train steps -----------------------------------------------------------------

def _opt(pj):
    sj = ropt.init_opt_state(pj)
    return sj, convert.opt_state_from_numpy(jax.tree.map(np.asarray, sj),
                                            device="cpu")


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_the_reference(steps):
    cj, ct = _cfgs(compute_dtype="float32")
    pj, pt = _params(cj)
    sj, st = _opt(pj)
    oc = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    rstep = jax.jit(rts.make_train_step(cj, ropt.OptimizerConfig(**oc)))
    tstep = tts.make_train_step(ct, topt.OptimizerConfig(**oc))
    for i in range(steps):
        bj, bt = _batches(cj, seed=2, step=i)
        pj, sj, mj = rstep(pj, sj, bj)
        pt, st, mt = tstep(pt, st, bt)
        for key in ("loss", "grad_norm", "lr"):
            assert rel(mt[key], mj[key]) <= 1e-4, (i, key)
    _assert_trees_close(pt, pj, 1e-4, rel2)
    _assert_trees_close(st["m"], sj["m"], 1e-4)
    _assert_trees_close(st["v"], sj["v"], 1e-4)
    # the state carries back to the JAX package unchanged
    back = convert.opt_state_to_numpy(st)
    assert back["step"].dtype == np.int32 and back["step"].shape == ()
    np.testing.assert_array_equal(back["m"]["embed"], st["m"]["embed"])


def test_microbatched_grads_match_full():
    """As the reference's own test: ``n_micro=2`` against 1 in float32
    compute, and the port's ``n_micro=2`` against the reference's."""
    cj, ct = _cfgs(compute_dtype="float32")
    pj, _ = _params(cj)
    oc = topt.OptimizerConfig(warmup_steps=1, total_steps=10)
    bj, bt = _batches(cj, seed=2)
    outs = {}
    for n in (1, 2):
        _, pt = _params(cj)
        _, st = _opt(pj)
        outs[n] = tts.make_train_step(ct, oc, n_micro=n)(pt, st, bt)
    (p1, _, m1), (p2, _, m2) = outs[1], outs[2]
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for _, a, b in _pairs(p1, p2):
        a, b = _np(a), _np(b)
        assert np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-12) < 1e-3
    sj, _ = _opt(pj)
    rp, _, rm = jax.jit(rts.make_train_step(
        cj, ropt.OptimizerConfig(warmup_steps=1, total_steps=10),
        n_micro=2))(pj, sj, bj)
    assert rel(m2["loss"], rm["loss"]) <= 1e-4
    _assert_trees_close(p2, rp, 1e-4, rel2)


def test_train_loss_decreases():
    """As the reference's own test: 15 steps overfitting one batch."""
    cj, ct = _cfgs()
    _, pt = _params(cj)
    step = tts.make_train_step(ct, topt.OptimizerConfig(
        peak_lr=5e-3, warmup_steps=2, total_steps=40))
    opt = topt.init_opt_state(pt)
    _, batch = _batches(cj)
    losses = []
    for _ in range(15):
        pt, opt, m = step(pt, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_grad_transform_sees_the_stacked_gradients():
    cj, ct = _cfgs(compute_dtype="float32")
    pj, pt = _params(cj)
    _, st = _opt(pj)
    _, bt = _batches(cj)
    err = tcomp.init_error_feedback(pt)
    seen = {}

    def transform(grads):
        seen["wq"] = tuple(grads["layers"]["attn"]["wq"].shape)
        deq, seen["err"] = tcomp.compress_decompress(grads, err)
        return deq

    _, _, m = tts.make_train_step(ct, topt.OptimizerConfig(),
                                  grad_transform=transform)(pt, st, bt)
    assert seen["wq"] == tuple(pt["layers"]["attn"]["wq"].shape)
    assert bool(torch.isfinite(m["loss"]))


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_4b", "internvl2_26b",
                                  "hubert_xlarge"])
def test_synthetic_batch_is_byte_equal_for_every_frontend(arch):
    cj = rbase.get_smoke_config(arch)
    ct = get_smoke_config(arch)
    assert {"qwen3_4b": "none", "internvl2_26b": "patch",
            "hubert_xlarge": "frame"}[arch] == ct.frontend
    dj, dt = rdata.DataConfig(16, 3, seed=5), tdata.DataConfig(16, 3, seed=5)
    for step in (0, 7):
        want = rdata.synthetic_batch(cj, dj, step)
        got = tdata.synthetic_batch(ct, dt, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
    on = tdata.to_device(got, "cpu")
    for k in got:
        np.testing.assert_array_equal(on[k].numpy(), got[k])


def test_prefetching_loader_yields_the_stream_in_order():
    ct = get_smoke_config("qwen3_4b")
    dcfg = tdata.DataConfig(8, 2, seed=3)
    loader = tdata.PrefetchingLoader(ct, dcfg, start_step=4)
    try:
        for want_step in (4, 5, 6):
            step, batch = next(loader)
            assert step == want_step
            assert batch["tokens"].tobytes() == tdata.synthetic_batch(
                ct, dcfg, step)["tokens"].tobytes()
    finally:
        loader.close()


# -- checkpoints -------------------------------------------------------------

def _mixed_tree_jax():
    rng = np.random.default_rng(9)
    return {"params": {"w": jnp.asarray(rng.normal(size=(6, 3))
                                        .astype(np.float32)),
                       "b": jnp.asarray(rng.normal(size=(2,))
                                        .astype(np.float32)),
                       "h": jnp.asarray(rng.normal(size=(5, 4)))
                       .astype(jnp.bfloat16)},
            "opt": {"step": jnp.int32(7),
                    "m": jnp.asarray(np.arange(12, dtype=np.float32))}}


def _bits(x):
    """Raw bytes of a leaf in either form (torch, numpy, bf16 as V2)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _mixed_tree_jax()
    rckpt.save_checkpoint(str(tmp_path), 3, tree, num_shards=3)
    assert tckpt.latest_step(str(tmp_path)) == 3
    got = tckpt.restore_checkpoint(str(tmp_path), device="cpu")
    for path, want, g in _pairs(tree, got):
        assert isinstance(g, torch.Tensor), path
        assert g.shape == want.shape, path
        assert str(g.dtype).split(".")[-1] == str(want.dtype), path
        assert _bits(g) == np.asarray(want).tobytes(), path


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jtree = _mixed_tree_jax()
    ttree = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jtree),
                                         device="cpu")
    tckpt.save_checkpoint(str(tmp_path), 5, ttree, num_shards=3)
    with open(tmp_path / "step_5" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["entries"]["params::h"]["dtype"] == "bfloat16"
    assert manifest["entries"]["opt::step"]["dtype"] == "int32"
    assert rckpt.latest_step(str(tmp_path)) == 5
    got = rckpt.restore_checkpoint(str(tmp_path))
    for path, want, g in _pairs(jtree, got):
        assert g.shape == want.shape, path
        assert _bits(g) == np.asarray(want).tobytes(), path
    # the reference's own bf16 leaf comes back the same way (V2 patterns)
    rckpt.save_checkpoint(str(tmp_path / "ref"), 5, jtree, num_shards=3)
    own = rckpt.restore_checkpoint(str(tmp_path / "ref"))
    assert own["params"]["h"].dtype == got["params"]["h"].dtype


def test_port_checkpoint_round_trip_of_a_model(tmp_path):
    cj, _ = _cfgs()
    _, pt = _params(cj)
    st = topt.init_opt_state(pt)
    tckpt.save_checkpoint(str(tmp_path), 7, {"params": pt, "opt": st},
                          num_shards=3)
    tree = tckpt.restore_checkpoint(str(tmp_path), device="cpu")
    for _, want, got in _pairs(tree_map(lambda a: a, pt), tree["params"]):
        assert torch.equal(got, want)
    assert tree["opt"]["step"].shape == () and \
        tree["opt"]["step"].dtype == torch.int32


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_detects_corruption(tmp_path, writer):
    tree = _mixed_tree_jax()
    if writer == "port":
        tckpt.save_checkpoint(str(tmp_path), 1, convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, tree), device="cpu"), num_shards=2)
    else:
        rckpt.save_checkpoint(str(tmp_path), 1, tree, num_shards=2)
    victim = os.path.join(str(tmp_path), "step_1", "shard_0.npz")
    with open(victim, "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x01\x02")
    with pytest.raises(IOError):
        tckpt.restore_checkpoint(str(tmp_path), 1, device="cpu")
    with pytest.raises(IOError):
        rckpt.restore_checkpoint(str(tmp_path), 1)


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    t = torch.arange(8, dtype=torch.float32)
    ck = tckpt.AsyncCheckpointer(str(tmp_path), num_shards=2)
    ck.save(2, {"t": t})
    t.add_(100.0)                        # an in-place update right after
    ck.wait()
    got = tckpt.restore_checkpoint(str(tmp_path), device="cpu")["t"]
    np.testing.assert_array_equal(got.numpy(), np.arange(8))


# -- compression ----------------------------------------------------------------

def test_compression_codes_and_scales_match_the_reference():
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(64, 9)) * 0.03).astype(np.float32)
    qj, sj = rcomp.quantize_int8(jnp.asarray(x))
    qt, st = tcomp.quantize_int8(torch.from_numpy(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)
    np.testing.assert_array_equal(tcomp.dequantize_int8(qt, st).numpy(),
                                  np.asarray(rcomp.dequantize_int8(qj, sj)))
    cj, _ = _cfgs()
    pj, pt = _params(cj)
    gj = jax.tree.map(lambda p: p * 0.01, pj)
    gt = tree_map(lambda p: p * 0.01, pt)
    ej, et = rcomp.init_error_feedback(pj), tcomp.init_error_feedback(pt)
    for _ in range(2):
        dj, ej = rcomp.compress_decompress(gj, ej)
        dt, et = tcomp.compress_decompress(gt, et)
        _assert_trees_close(dt, dj, 1e-6)
        _assert_trees_close(et, ej, 1e-5)
    assert tcomp.compressed_bytes(pt) == rcomp.compressed_bytes(pj)


def test_compression_error_feedback_converges():
    """As the reference's own test: the running decompressed sum tracks
    the true gradient sum."""
    g_true = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 128, 128)).astype(np.float32) * 1e-2)
    err = torch.zeros_like(g_true)
    acc = torch.zeros_like(g_true)
    for _ in range(20):
        deq, err = tcomp.compress_decompress(g_true, err)
        acc = acc + deq
    total = 20 * g_true
    assert float(torch.linalg.norm(acc - total)
                 / torch.linalg.norm(total)) < 0.02
    _, pt = _params(_cfgs()[0])
    fp32, int8 = tcomp.compressed_bytes(pt)
    assert int8 < fp32 / 3.5


# -- the loop and the launcher ------------------------------------------------

def test_loop_with_fault_and_resume_matches_the_reference(tmp_path):
    """Fault at step 6 (restore step 4, replay), then a resume to step
    12 from step 8's checkpoint: the losses equal the reference loop's,
    step for step."""
    cj, ct = _cfgs(compute_dtype="float32")
    oc = dict(peak_lr=1e-3, warmup_steps=2, total_steps=12)
    dcfg = dict(**DATA, seed=3)

    def run(pkg, opt, data, cfg, directory, total, init, **kw):
        fails = {"armed": True}

        def fault_hook(step):
            if step == 6 and fails["armed"]:
                fails["armed"] = False
                raise RuntimeError("injected node failure")

        logs = []
        lc = pkg.LoopConfig(total_steps=total, checkpoint_every=4,
                            checkpoint_dir=str(directory), log_every=100)
        st = pkg.run_training(cfg, opt.OptimizerConfig(**oc),
                              data.DataConfig(**dcfg), lc, init,
                              fault_hook=fault_hook, log=logs.append, **kw)
        return st, logs

    pj, _ = _params(cj)
    out = {}
    for name, pkg, opt, data, cfg, init, kw in (
            ("ref", rloop, ropt, rdata, cj, lambda: pj, {}),
            ("port", tloop, topt, tdata, ct,
             lambda: _params(cj)[1], {"device": "cpu"})):
        d = tmp_path / name
        first, logs = run(pkg, opt, data, cfg, d, 8, init, **kw)
        second, logs2 = run(pkg, opt, data, cfg, d, 12, init, **kw)
        out[name] = (first, logs, second, logs2)
    (rf, rlogs, rs, rlogs2), (tf, tlogs, ts, tlogs2) = out["ref"], out["port"]
    assert (tf.step, tf.restarts, ts.step) == (rf.step, rf.restarts, rs.step)
    assert (tf.step, tf.restarts, ts.step) == (8, 1, 12)
    assert any("restoring last checkpoint" in m for m in tlogs)
    assert "resumed from checkpoint step 8" in tlogs2
    # the first run's losses after its restore (steps 4-7), then the
    # resume's (steps 8-11)
    assert len(tf.losses) == len(rf.losses) and len(ts.losses) == len(
        rs.losses)
    for got, want in zip(tf.losses + ts.losses, rf.losses + rs.losses):
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    assert tckpt.latest_step(str(tmp_path / "port")) == 12
    # the port's last checkpoint restores in the reference
    tree = rckpt.restore_checkpoint(str(tmp_path / "port"))
    for path, want, got in _pairs(convert.lm_params_to_numpy(ts.params),
                                  tree["params"]):
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("arch", ["qwen3_4b", "olmoe_1b_7b", "mamba2_1_3b",
                                  "zamba2_1_2b", "starcoder2_7b",
                                  "nemotron_4_340b"])
def test_launcher_runs_on_the_cpu(tmp_path, capsys, arch):
    tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                  "--steps", "3", "--seq", "16", "--batch", "2",
                  "--ckpt", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "finished at step 3; loss" in out
    assert tckpt.latest_step(str(tmp_path)) == 2
    tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                  "--steps", "2", "--seq", "16", "--batch", "2",
                  "--ckpt", str(tmp_path)])
    assert "nothing left to run" in capsys.readouterr().out


def test_lm_params_carry_back_to_the_reference():
    cj, _ = _cfgs()
    pj, pt = _params(cj)
    back = convert.lm_params_to_numpy(pt)
    for path, want, got in _pairs(jax.tree.map(np.asarray, pj), back):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    bf = convert.lm_params_to_numpy({"h": pt["embed"].to(torch.bfloat16)})
    assert bf["h"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        bf["h"].astype(np.float32),
        pt["embed"].to(torch.bfloat16).float().numpy())
