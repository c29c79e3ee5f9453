"""The port's Mamba2 / SSD block against the JAX package's.

Inputs come from numpy with a seed; block weights are the JAX package's
``mamba2_init`` carried across with ``convert.lm_params_from_numpy``.
Tolerances: ``ssd_chunked`` within 1e-5 of the reference's (float32 on
both sides, the same chunked algorithm, only the order of sums
differs) and within 2e-4 of the step-by-step recurrence (the
reference's own bar in ``tests/test_models.py``: the chunked and the
recurrent forms sum in different orders over up to 64 steps); the
block, its decode step and their caches, and the SSD's gradients
(relative to each gradient's largest element: a_head's sums many
terms), within 1e-4 in float32; the
bf16 causal convolution and the softplus bit for bit (or to the last
float32 bit), since they are written to round where the reference's do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import mamba2 as rm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import mamba2 as tm

TOL = 1e-4


def _ssd_inputs(b, t, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(b, t, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, t, h, n)).astype(np.float32),
            rng.normal(size=(b, t, h, n)).astype(np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _cfgs(**kw):
    kw = {"compute_dtype": "float32", **kw}
    return (rbase.get_smoke_config("mamba2_1_3b").reduced(**kw),
            get_smoke_config("mamba2_1_3b").reduced(**kw))


def _block(cfg_j, seed=0):
    p = rm.mamba2_init(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    # non-trivial biases, skip and gate so that every leaf matters
    rng = np.random.default_rng(seed + 100)
    p = {k: np.asarray(v) for k, v in p.items()}
    for k in ("conv_bias_x", "conv_bias_b", "conv_bias_c", "dt_bias"):
        p[k] = rng.normal(size=p[k].shape).astype(np.float32) * 0.3
    for k in ("d_skip", "gate_norm"):
        p[k] = 1.0 + rng.normal(size=p[k].shape).astype(np.float32) * 0.3
    return ({k: jnp.asarray(v) for k, v in p.items()},
            lm_params_from_numpy(p, device="cpu"))


# -- SSD core -----------------------------------------------------------------

@pytest.mark.parametrize("t,chunk", [(64, 8), (64, 16), (64, 64), (60, 16)])
def test_ssd_chunked_matches_the_reference_and_the_recurrence(t, chunk):
    """Chunks 8, 16 and 64, and 60 % 16 != 0 (one chunk of 60)."""
    x, dt, a, bm, cm = _ssd_inputs(2, t, 4, 8, 16)
    ours = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
    theirs = [jnp.asarray(v) for v in (x, dt, a, bm, cm)]
    y, s = tm.ssd_chunked(*ours, chunk)
    y_ref, s_ref = rm.ssd_chunked(*theirs, chunk)
    _close(y, y_ref, 1e-5)
    _close(s, s_ref, 1e-5)
    y_rec, s_rec = rm.ssd_recurrent_ref(*theirs)
    _close(y, y_rec, 2e-4)
    _close(s, s_rec, 2e-4)
    y_ours_rec, s_ours_rec = tm.ssd_recurrent_ref(*ours)
    _close(y_ours_rec, y_rec, 1e-5)
    _close(s_ours_rec, s_rec, 1e-5)


def test_ssd_chunked_backward_is_finite_and_matches_the_reference():
    """The upper triangle's positive cumulative sums are masked before
    the exp: masking after would give inf · 0 = nan in the backward."""
    x, dt, a, bm, cm = _ssd_inputs(1, 32, 2, 4, 8, seed=3)
    dt = dt * 40                      # large decays: exp(+sum) overflows
    ours = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a, bm,
                                                          cm)]
    y, s = tm.ssd_chunked(*ours, 16)
    (y.sum() + s.sum()).backward()

    def f(*args):
        y, s = rm.ssd_chunked(*args, 16)
        return y.sum() + s.sum()
    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    for got, w in zip(ours, want):
        assert bool(torch.isfinite(got.grad).all())
        scale = float(np.abs(np.asarray(w)).max())
        _close(got.grad / scale, np.asarray(w) / scale)


# -- convolution, softplus, groups --------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_causal_matches_the_reference_bit_for_bit(dtype):
    rng = np.random.default_rng(4)
    seq = rng.standard_normal((2, 33, 48)).astype(np.float32)
    w = rng.standard_normal((4, 48)).astype(np.float32) * 0.3
    bias = rng.standard_normal(48).astype(np.float32)
    jd = jnp.dtype(dtype)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = rm._conv1d_causal(*(jnp.asarray(v).astype(jd)
                               for v in (seq, w, bias)))
    got = tm._conv1d_causal(*(torch.from_numpy(v).to(td)
                              for v in (seq, w, bias)))
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_softplus_is_logaddexp_without_a_threshold():
    x = np.concatenate([np.linspace(-60, 60, 2001),
                        [-1e4, 1e4]]).astype(np.float32)
    got = tm._softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    assert got[-1] == 1e4


def test_expand_groups_repeats_each_group_in_turn():
    _, cfg = _cfgs(ssm_groups=2)
    h, n = cfg.ssm_heads, cfg.ssm_state
    part = np.arange(2 * 3 * 2 * n, dtype=np.float32).reshape(2, 3, 2 * n)
    got = tm._expand_groups(cfg, torch.from_numpy(part), 2, 3)
    cfg_j, _ = _cfgs(ssm_groups=2)
    want = rm._expand_groups(cfg_j, jnp.asarray(part), 2, 3)
    assert tuple(got.shape) == (2, 3, h, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # heads 0 .. h/2-1 read group 0
    np.testing.assert_array_equal(got[:, :, h // 2 - 1].numpy(),
                                  part[:, :, :n])


def test_conv_step_matches_the_reference_and_shifts_the_window():
    rng = np.random.default_rng(5)
    win = rng.standard_normal((2, 3, 24)).astype(np.float32)
    new = rng.standard_normal((2, 1, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    want_y, want_win = rm._conv_step(*(jnp.asarray(v)
                                       for v in (win, new, w, bias)))
    window = torch.from_numpy(win.copy())
    got = tm._conv_step(window, *(torch.from_numpy(v)
                                  for v in (new, w, bias)))
    _close(got, want_y, 1e-6)
    np.testing.assert_array_equal(window.numpy(), np.asarray(want_win))


# -- the block ----------------------------------------------------------------

def test_mamba2_init_has_the_reference_tree():
    for groups in (1, 2):
        cfg_j, cfg_t = _cfgs(ssm_groups=groups)
        want = rm.mamba2_init(jax.random.PRNGKey(0), cfg_j, jnp.bfloat16)
        got = tm.mamba2_init(torch.Generator().manual_seed(0), cfg_t,
                             torch.bfloat16, torch.device("cpu"), (3,))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == (3, *v.shape), k
            assert str(got[k].dtype).split(".")[1] == str(v.dtype), k
        np.testing.assert_allclose(got["a_log"][2].numpy(),
                                   np.asarray(want["a_log"]), rtol=2e-7)


@pytest.mark.parametrize("groups,t", [(1, 32), (2, 32), (1, 20)])
def test_mamba2_apply_matches_the_reference(groups, t):
    """Two chunks of 16, and 20 tokens (one chunk of 20); groups 2."""
    cfg_j, cfg_t = _cfgs(ssm_groups=groups)
    pj, pt = _block(cfg_j, seed=groups)
    x = np.random.default_rng(6).standard_normal(
        (2, t, cfg_j.d_model)).astype(np.float32)
    _close(tm.mamba2_apply(pt, cfg_t, torch.from_numpy(x)),
           rm.mamba2_apply(pj, cfg_j, jnp.asarray(x)))


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_decode_matches_the_reference_and_writes_in_place(groups):
    cfg_j, cfg_t = _cfgs(ssm_groups=groups)
    pj, pt = _block(cfg_j, seed=groups)
    xs = np.random.default_rng(7).standard_normal(
        (2, 6, cfg_j.d_model)).astype(np.float32)
    cache_j = rm.mamba2_init_cache(cfg_j, 2, jnp.float32)
    cache_t = tm.mamba2_init_cache(cfg_t, 2, torch.float32,
                                   torch.device("cpu"))
    ptrs = {k: v.data_ptr() for k, v in cache_t.items()}
    for i in range(6):
        yj, cache_j = rm.mamba2_decode(pj, cfg_j, jnp.asarray(xs[:, i:i + 1]),
                                       cache_j)
        yt, returned = tm.mamba2_decode(pt, cfg_t,
                                        torch.from_numpy(xs[:, i:i + 1]),
                                        cache_t)
        assert returned is cache_t
        _close(yt, yj)
    assert {k: v.data_ptr() for k, v in cache_t.items()} == ptrs
    for k in cache_j:
        _close(cache_t[k], cache_j[k])


def test_mamba2_decode_reproduces_apply_at_every_position():
    """Teacher-forced decode against the full-sequence block (the
    reference's 2e-3 bar for decode against forward)."""
    cfg_j, cfg_t = _cfgs(ssm_groups=2)
    _, pt = _block(cfg_j, seed=9)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 24, cfg_t.d_model)).astype(np.float32))
    full = tm.mamba2_apply(pt, cfg_t, x)
    cache = tm.mamba2_init_cache(cfg_t, 2, torch.float32,
                                 torch.device("cpu"))
    steps = [tm.mamba2_decode(pt, cfg_t, x[:, i:i + 1], cache)[0]
             for i in range(24)]
    _close(torch.cat(steps, dim=1), full.numpy(), 2e-3)
