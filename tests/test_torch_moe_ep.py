"""The port's expert-parallel MoE path (``moe_apply`` under an
activation-sharding context) against the JAX package's ``shard_map``
path.

The reference runs on a real (2, 4) mesh of ``Auto`` axes ("data",
"model") over 8 host devices, in one subprocess (the device count is
fixed when JAX starts; 300 s limit); the port runs the same mesh's 8
shards as logical shards in this process. Weights come from the
reference's ``moe_init`` and are carried across by ``convert``; tokens
come from numpy with a seed; float32 throughout.

Routing is compared as integers, bit for bit: for each (data shard,
model shard) the top-k expert ids, the stable sort of the local ids,
the kept flags (drops included) and the buffer slots that the port's
``dispatch_plan`` returns, against the reference's own lines
(``_local_moe`` and ``_dispatch_ffn`` in ``src/repro/models/moe.py``)
evaluated with ``jnp`` on that shard's tokens. The router is skewed
towards expert 0 and the capacity factor is the published 1.25, so that
the capacity, computed from a data shard's token count, drops
assignments. Outputs within 1e-5 (the f32 partial sums of the model
shards meet in another order than the reference's ``psum``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import moe as rmoe
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.act_sharding import (ActivationSharding,
                                                  activation_sharding)
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import moe

ROOT = Path(__file__).resolve().parents[1]
CF = 1.25
MESH = ((2, 4), ("data", "model"))
# olmoe: 4 experts (1 a model shard), top-2; deepseek-v2: 4 experts,
# top-2 and 2 shared experts, added after the sum
ARCHS = ("olmoe_1b_7b", "deepseek_v2_236b")

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import base
from repro.distributed.act_sharding import (ActivationSharding,
                                            activation_sharding)
from repro.models import moe
arrays = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
for arch in sys.argv[3:]:
    cfg = base.get_smoke_config(arch)
    p = {}
    for k, v in arrays.items():
        a, *path = k.split("/")
        if a == arch and path[0] != "x":
            d = p
            for name in path[:-1]:
                d = d.setdefault(name, {})
            d[path[-1]] = jnp.asarray(v)
    with activation_sharding(ActivationSharding(mesh, "data")):
        y = moe.moe_apply(p, cfg, jnp.asarray(arrays[arch + "/x"]), %r)
    out[arch] = np.asarray(y)
np.savez(sys.argv[2], **out)
""" % CF


def _case(arch, seed=0):
    cfg_j = rbase.get_smoke_config(arch)
    p = jax.tree.map(np.asarray,
                     rmoe.moe_init(jax.random.PRNGKey(seed), cfg_j,
                                   jnp.float32))
    p["router"] = p["router"].copy()
    p["router"][:, 0] += 4.0 / np.sqrt(cfg_j.d_model)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, 24, cfg_j.d_model)).astype(np.float32) + 0.5
    return cfg_j, get_smoke_config(arch), p, x


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _reference_plan(router, tokens, e, k, j, e_loc):
    """The reference's lines for model shard ``j`` on one data shard's
    tokens: (ids, order, keep, slot, cap)."""
    tl = tokens.shape[0]
    probs = jax.nn.softmax(tokens @ router, axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    cap = min(tl * k, max(k, int(CF * tl * k / e)))
    flat = (ids - j * e_loc).reshape(-1)
    valid = (flat >= 0) & (flat < e_loc)
    sort_key = jnp.where(valid, flat, e_loc)
    order = jnp.argsort(sort_key)
    sorted_expert = sort_key[order]
    first = jnp.searchsorted(sorted_expert, sorted_expert, side="left")
    pos = jnp.arange(tl * k, dtype=jnp.int32) - first.astype(jnp.int32)
    keep = (sorted_expert < e_loc) & (pos < cap)
    slot = jnp.where(keep, sorted_expert * cap + pos, e_loc * cap)
    return [np.asarray(a) for a in (ids, order, keep, slot)], cap


@pytest.fixture
def plans(monkeypatch):
    """Every ``dispatch_plan`` call's (ids, e, cap, order, keep, slot)."""
    calls = []
    real = moe.dispatch_plan

    def recorded(expert_ids, e, cap):
        out = real(expert_ids, e, cap)
        calls.append((expert_ids, e, cap, *out))
        return out

    monkeypatch.setattr(moe, "dispatch_plan", recorded)
    return calls


def test_ep_path_matches_the_reference_shard_map(tmp_path, plans):
    cases = {arch: _case(arch) for arch in ARCHS}
    arrays = {}
    for arch, (_, _, p, x) in cases.items():
        arrays.update(_flat(p, arch))
        arrays[arch + "/x"] = x
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _REFERENCE,
                          str(tmp_path / "in.npz"), str(tmp_path / "out.npz"),
                          *ARCHS], env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")

    ctx = ActivationSharding(AbstractMesh(*MESH), "data")
    n_data, m_size = MESH[0]
    for arch, (cfg_j, cfg_t, p, x) in cases.items():
        pt = lm_params_from_numpy(p, device="cpu")
        del plans[:]
        with activation_sharding(ctx):
            got = moe.moe_apply(pt, cfg_t, torch.from_numpy(x), CF)
        e, k = cfg_j.num_experts, cfg_j.experts_per_token
        e_loc = e // m_size
        assert len(plans) == n_data * m_size
        dropped = 0
        for i, tokens in enumerate(np.split(x.reshape(-1, x.shape[-1]),
                                            n_data)):
            for j in range(m_size):
                ids, e_got, cap_got, *plan = plans[i * m_size + j]
                (r_ids, *r_plan), cap = _reference_plan(
                    jnp.asarray(p["router"]), jnp.asarray(tokens), e, k, j,
                    e_loc)
                assert (e_got, cap_got) == (e_loc, cap)
                assert np.array_equal(ids.numpy(), r_ids - j * e_loc)
                for a, b in zip(plan, r_plan):
                    assert np.array_equal(a.numpy(), b), (arch, i, j)
                valid = (r_ids - j * e_loc >= 0) & (r_ids - j * e_loc < e_loc)
                dropped += int(valid.sum()) - int(r_plan[1].sum())
        assert dropped > 0, arch
        np.testing.assert_allclose(got.numpy(), want[arch], rtol=0,
                                   atol=1e-5)
        # the global path caps over all tokens, so its drops differ
        glob = moe.moe_apply(pt, cfg_t, torch.from_numpy(x), CF)
        assert not torch.equal(glob, got)


def test_ep_on_one_shard_is_the_global_path_bit_for_bit():
    for arch in ARCHS:
        _, cfg, p, x = _case(arch, seed=3)
        pt = lm_params_from_numpy(p, device="cpu")
        xt = torch.from_numpy(x)
        with activation_sharding(ActivationSharding(
                AbstractMesh((1, 1), ("data", "model")), "data")):
            one = moe.moe_apply(pt, cfg, xt, CF)
        assert torch.equal(one, moe.moe_apply(pt, cfg, xt, CF))


@pytest.mark.parametrize("mesh,batch_axes,model_axis,ep", [
    (((2, 4), ("data", "model")), "data", "model", True),
    (((2, 4), ("data", "model")), None, "model", False),
    (((2, 4), ("data", "model")), "data", None, False),
    (((1, 3), ("data", "model")), "data", "model", False),
    (((2, 2, 2), ("pod", "data", "model")), ("pod", "data"), "model", True),
])
def test_moe_apply_branches_as_the_reference(monkeypatch, mesh, batch_axes,
                                             model_axis, ep):
    _, cfg, p, x = _case("olmoe_1b_7b")
    pt = lm_params_from_numpy(p, device="cpu")
    taken = []
    real = moe._moe_apply_shardmap

    def spy(*args):
        taken.append(args[-1])
        return real(*args)

    monkeypatch.setattr(moe, "_moe_apply_shardmap", spy)
    ctx = ActivationSharding(AbstractMesh(*mesh), batch_axes, model_axis)
    with activation_sharding(ctx):
        out = moe.moe_apply(pt, cfg, torch.from_numpy(x), CF)
    assert taken == ([ctx] if ep else [])
    assert out.shape == x.shape
    moe.moe_apply(pt, cfg, torch.from_numpy(x), CF)    # no context: global
    assert len(taken) == int(ep)


def test_ep_refuses_tokens_that_do_not_split():
    _, cfg, p, x = _case("olmoe_1b_7b")
    pt = lm_params_from_numpy(p, device="cpu")
    with activation_sharding(ActivationSharding(
            AbstractMesh((5, 2), ("data", "model")), "data")):
        with pytest.raises(ValueError, match="5 data shards"):
            moe.moe_apply(pt, cfg, torch.from_numpy(x), CF)
