"""The port's Mixture-of-Experts layer against the JAX package's.

The JAX package's ``moe_init`` draws the weights and ``convert`` carries
them across, so both packages compute with the same values; tokens come
from numpy with a seed. Everything runs on ``device="cpu"``.

Routing is compared as integers, bit for bit: the expert ids of the
top-k, the stable sort by expert, each sorted assignment's kept slot and
the set of dropped (token, expert) pairs. The reference computes these
inside ``_moe_apply_global`` without returning them, so the test
evaluates the reference's own lines (``src/repro/models/moe.py``, the
router to the ``write`` index) with ``jnp`` on the same inputs. The
capacity path is exercised at the published ``moe_capacity_factor``
1.25 (the smoke configs are dropless) with a router skewed towards
expert 0, so that it overflows and drops happen.

Tolerances: gates and ``aux_load_balance_loss`` 1e-6 (the same float32
softmax, top-k and sums); ``moe_apply`` and ``_dispatch_ffn`` 1e-5 in
float32 (only the order of the matmuls' sums differs), and in bf16 one
bf16 ulp of the output's scale (2^(⌊log2 max |want|⌋ - 7)): both sides
round the expert products, the gated contributions and the output to
bf16 at the same places, so a difference in a matmul's last bit moves
an output by at most about one rounding at its scale. With shared
experts the output is the sum of two bf16 terms, each rounded apart
before the sum is rounded again, so the bound is two such ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import moe as rmoe
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe
from repro_torch.tree import tree_map

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _cfgs(arch="olmoe_1b_7b", **kw):
    return (rbase.get_smoke_config(arch).reduced(**kw),
            get_smoke_config(arch).reduced(**kw))


def _params(cfg_j, dtype="float32", seed=0, skew=0.0):
    """The reference's MoE params (router float32, experts in ``dtype``)
    in both packages. ``skew`` adds a column of ``skew / sqrt(d)`` to
    the router's expert 0, so tokens with a positive mean lean to it."""
    p = rmoe.moe_init(jax.random.PRNGKey(seed), cfg_j, DTYPES[dtype][1])
    p = jax.tree.map(np.asarray, p)
    if skew:
        p["router"] = p["router"].copy()
        p["router"][:, 0] += skew / np.sqrt(cfg_j.d_model)
    return (jax.tree.map(jnp.asarray, p),
            lm_params_from_numpy(p, device="cpu"))


def _x(cfg, b=2, s=24, seed=1, dtype="float32", shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32) + shift
    return (jnp.asarray(x).astype(DTYPES[dtype][1]),
            torch.from_numpy(x).to(DTYPES[dtype][0]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _reference_routing(router, tokens, e, k, cf):
    """The reference's routing, its lines from the router to the write
    index, in jnp: (gates, ids, order, keep, write, cap)."""
    t = tokens.shape[0]
    probs = jax.nn.softmax(tokens.astype(jnp.float32) @ router, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    cap = min(t * k, max(k, int(cf * t * k / e)))
    flat_expert = expert_ids.reshape(-1)
    order = jnp.argsort(flat_expert)
    sorted_expert = flat_expert[order]
    first = jnp.searchsorted(sorted_expert, sorted_expert, side="left")
    pos = jnp.arange(t * k, dtype=jnp.int32) - first.astype(jnp.int32)
    keep = pos < cap
    slot = sorted_expert * cap + jnp.where(keep, pos, 0)
    write = jnp.where(keep, slot, e * cap)
    return gate_vals, expert_ids, order, keep, write, cap


# -- routing -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf,skew", [(None, 0.0), (1.25, 0.0),
                                     (1.25, 4.0), (1.0, 4.0)])
def test_routing_is_bit_for_bit(dtype, cf, skew):
    """Expert ids, the stable sort, kept slots and the dropped pairs, as
    integers; gates within 1e-6. ``None`` is the smoke config's
    dropless factor; the skewed router makes expert 0 overflow. The
    router is the bf16-rounded one in bf16 compute, as ``forward`` casts
    it."""
    cj, ct = _cfgs(num_experts=8, experts_per_token=2)
    pj, pt = _params(cj, dtype, skew=skew)
    cd_t, cd_j = DTYPES[dtype]
    rj, rt = pj["router"].astype(cd_j), pt["router"].to(cd_t)
    xj, xt = _x(cj, 4, 32, dtype=dtype, shift=0.5 if skew else 0.0)
    tj, tt = xj.reshape(-1, cj.d_model), xt.reshape(-1, ct.d_model)
    cf = ct.moe_capacity_factor if cf is None else cf
    e, k = ct.num_experts, ct.experts_per_token
    gj, ij, oj, kj, wj, cap_j = _reference_routing(rj, tj, e, k, cf)
    gates, ids = moe.route(rt, tt, k)
    cap = moe.capacity(cf, tt.shape[0], k, e)
    order, keep, slot = moe.dispatch_plan(ids, e, cap)
    assert cap == cap_j
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ij))
    np.testing.assert_allclose(gates.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(order.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(wj))
    flat = np.asarray(ij).reshape(-1)[np.asarray(oj)]
    tokens = np.asarray(oj) // k
    want_drops = {(int(a), int(b)) for a, b, kk in
                  zip(tokens, flat, np.asarray(kj)) if not kk}
    got_ids = ids.reshape(-1)[order]
    got_drops = {(int(a), int(b)) for a, b, kk in
                 zip(order // k, got_ids, keep) if not kk}
    assert got_drops == want_drops
    if skew:                                       # expert 0 overflowed
        assert any(ex == 0 for _, ex in got_drops)
    elif cf == ct.moe_capacity_factor:
        assert not got_drops                       # dropless


def test_capacity_matches_the_reference_formula():
    for cf in (1.0, 1.25, 2.0, 64.0):
        for t, k, e in ((1, 8, 64), (8192, 8, 64), (2048, 6, 160),
                        (4, 8, 64), (7, 2, 4)):
            want = min(t * k, max(k, int(cf * t * k / e)))
            assert moe.capacity(cf, t, k, e) == want
    assert moe.capacity(1.25, 8192, 8, 64) == 1280      # OLMoE prefill
    assert moe.capacity(1.25, 2048, 6, 160) == 96       # DeepSeek-V2


# -- the layer -----------------------------------------------------------------

def _tol_close(got, want, dtype, tol=1e-5, ulps=1):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        scale = float(np.abs(want).max())
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert float(np.abs(got - want).max()) <= ulps * ulp, \
            (float(np.abs(got - want).max()), ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,cf,skew", [("olmoe_1b_7b", None, 0.0),
                                          ("olmoe_1b_7b", 1.25, 0.0),
                                          ("olmoe_1b_7b", 1.25, 4.0),
                                          ("deepseek_v2_236b", 1.25, 0.0)])
def test_moe_apply_matches_the_reference(dtype, arch, cf, skew):
    """The whole layer (deepseek: with its two shared experts) in the
    compute dtype, with the router cast to it as ``forward`` does."""
    cj, ct = _cfgs(arch, num_experts=8, experts_per_token=2)
    if cf is not None:
        cj, ct = (c.reduced(moe_capacity_factor=cf) for c in (cj, ct))
    pj, pt = _params(cj, dtype, skew=skew)
    cd_t, cd_j = DTYPES[dtype]
    pj = jax.tree.map(lambda a: a.astype(cd_j), pj)
    pt = tree_map(lambda a: a.to(cd_t), pt)
    assert ("shared" in pt) == (arch == "deepseek_v2_236b")
    xj, xt = _x(cj, dtype=dtype, shift=0.5 if skew else 0.0)
    want = rmoe.moe_apply(pj, cj, xj)
    got = moe.moe_apply(pt, ct, xt)
    assert got.dtype == cd_t and got.shape == xt.shape
    ulps = 2 if "shared" in pt else 1
    _tol_close(got, want, dtype, ulps=ulps)
    _tol_close(moe._moe_apply_global(pt, ct, xt), want, dtype, ulps=ulps)


def test_shared_experts_add_the_shared_mlp():
    """DeepSeek-V2's shared experts: width f · num_shared_experts, added
    on the flat tokens; without them the routed part alone remains."""
    cj, ct = _cfgs("deepseek_v2_236b")
    assert ct.num_shared_experts == 2
    pj, pt = _params(cj)
    assert tuple(pt["shared"]["wi"].shape) == (ct.d_model,
                                               2 * ct.moe_d_ff)
    xj, xt = _x(cj, seed=3)
    routed_j = rmoe.moe_apply({k: v for k, v in pj.items()
                               if k != "shared"}, cj, xj)
    routed_t = moe.moe_apply({k: v for k, v in pt.items()
                              if k != "shared"}, ct, xt)
    _tol_close(routed_t, routed_j, "float32")
    _tol_close(moe.moe_apply(pt, ct, xt) - routed_t,
               rmoe.moe_apply(pj, cj, xj) - routed_j, "float32")


@pytest.mark.parametrize("offset", [0, 3, -2])
def test_dispatch_ffn_drops_non_local_ids(offset):
    """The local-expert form the reference's mesh path calls: ids
    shifted by ``offset`` fall outside [0, e) for some assignments,
    which are dropped; the float32 outputs and the integer plan agree."""
    cj, ct = _cfgs(num_experts=8, experts_per_token=2)
    pj, pt = _params(cj)
    e, k = 5, ct.experts_per_token
    xj, xt = _x(cj, 1, 40, seed=4)
    tj, tt = xj.reshape(-1, cj.d_model), xt.reshape(-1, ct.d_model)
    gates, ids = moe.route(pt["router"], tt, k)
    local = ids - offset
    assert bool(((local < 0) | (local >= e)).any())
    cap = moe.capacity(1.25, tt.shape[0], k, e)
    w = {n: (pj[n][:e], pt[n][:e]) for n in ("wi", "wg", "wo")}
    want = rmoe._dispatch_ffn(tj, w["wi"][0], w["wg"][0], w["wo"][0],
                              jnp.asarray(local.numpy()),
                              jnp.asarray(gates.numpy()), e, k, cap,
                              jnp.float32)
    got = moe._dispatch_ffn(tt, w["wi"][1], w["wg"][1], w["wo"][1], local,
                            gates, e, k, cap, torch.float32)
    assert got.dtype == torch.float32
    _tol_close(got, want, "float32")
    order, keep, slot = moe.dispatch_plan(local, e, cap)
    flat = local.reshape(-1)[order]
    valid = (flat >= 0) & (flat < e)
    assert not bool(keep[~valid].any())
    assert bool((slot[~keep] == e * cap).all())
    # non-local assignments sort after every local one
    assert bool((torch.diff(valid.int()) <= 0).all())


def test_combine_is_deterministic_and_in_expert_order():
    """Two calls give the same bits; the combine equals a float32
    scatter-add of the sorted contributions (the reference's order)."""
    cj, ct = _cfgs(num_experts=8, experts_per_token=2,
                   moe_capacity_factor=1.25)
    _, pt = _params(cj, skew=4.0)
    _, xt = _x(cj, 2, 32, seed=5, shift=0.5)
    a = moe.moe_apply(pt, ct, xt)
    b = moe.moe_apply(pt, ct, xt)
    assert torch.equal(a, b)
    tokens = xt.reshape(-1, ct.d_model)
    e, k = ct.num_experts, ct.experts_per_token
    gates, ids = moe.route(pt["router"], tokens, k)
    cap = moe.capacity(1.25, tokens.shape[0], k, e)
    order, keep, slot = moe.dispatch_plan(ids, e, cap)
    buf = torch.zeros((e * cap + 1, ct.d_model))
    buf[slot] = tokens[order // k]
    out = moe.mlp_apply({n: pt[n] for n in ("wi", "wg", "wo")},
                        buf[:e * cap].reshape(e, cap, -1), "swiglu")
    rows = out.reshape(e * cap, -1)[torch.where(keep, slot, 0)]
    contrib = torch.where(keep[:, None],
                          rows * gates.reshape(-1)[order][:, None], 0.0)
    want = torch.zeros_like(tokens).index_add_(0, order // k, contrib)
    assert torch.equal(a.reshape(-1, ct.d_model), want)


# -- auxiliary loss --------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b"])
def test_aux_load_balance_loss_matches_the_reference(arch):
    cj, ct = _cfgs(arch)
    pj, pt = _params(cj, "bfloat16")
    assert pt["router"].dtype == torch.float32       # f32 whatever dtype
    for seed, dtype in ((6, "float32"), (7, "bfloat16")):
        xj, xt = _x(cj, 3, 16, seed=seed, dtype=dtype)
        want = float(rmoe.aux_load_balance_loss(pj, cj, xj))
        got = float(moe.aux_load_balance_loss(pt, ct, xt))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_moe_init_has_the_reference_tree():
    for arch in ("olmoe_1b_7b", "deepseek_v2_236b"):
        cj, ct = _cfgs(arch)
        want = rmoe.moe_init(jax.random.PRNGKey(0), cj, jnp.bfloat16)
        got = moe.moe_init(torch.Generator().manual_seed(0), ct,
                           torch.bfloat16, torch.device("cpu"), lead=(3,))
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat) == len(jax.tree.leaves(got))
        for path, leaf in flat:
            t = got
            for key in path:
                t = t[key.key]
            assert tuple(t.shape) == (3, *leaf.shape)
            assert str(t.dtype).split(".")[1] == str(leaf.dtype)
