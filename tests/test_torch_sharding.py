"""The port's sharding rules and activation-sharding context against the
JAX package's.

The reference's rules read a mesh only through its axis names and
sizes, so they run here on ``jax.sharding.AbstractMesh`` (no devices);
the port's run on its own ``AbstractMesh``. Both take their own
package's full-size parameter and cache trees (``jax.eval_shape`` and
fake tensors), for all ten architectures on the 16 x 16 and 2 x 16 x 16
production meshes; every leaf's spec must be equal.

Placements: on torch's ``"fake"`` process-group backend (one process,
256 or 512 ranks), the production mesh becomes a ``DeviceMesh``
(``to_device_mesh``), and each leaf's local shape under ``to_placements``
(DTensor's own ``compute_local_shape_and_global_offset``) must equal
``NamedSharding(AbstractMesh, spec).shard_shape`` and the port's
``local_shape``. A fixture always destroys the process group.

``constrain*``: the spec each reference function pins is captured by
replacing ``jax.lax.with_sharding_constraint`` in this test only; the
port's function, given a replicated ``DTensor`` on a (2, 4) fake mesh,
must redistribute it to that spec's placements with its values
unchanged, and return a plain tensor as it is.
"""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import base as rbase
from repro.distributed import act_sharding as ract
from repro.distributed import sharding as rsh
from repro.launch import specs as rspecs
from repro_torch.configs import base
from repro_torch.distributed import act_sharding as act
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs
from repro_torch.launch.mesh import (AbstractMesh, make_production_mesh,
                                     to_device_mesh)

MESHES = {"16x16": False, "2x16x16": True}


def _jmesh(multi_pod: bool) -> JAbstractMesh:
    m = make_production_mesh(multi_pod=multi_pod)
    return JAbstractMesh(m.axis_sizes, m.axis_names)


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts (spec or shape trees of either
    package)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@functools.cache
def _param_trees(arch: str):
    return (rspecs.param_specs(rbase.get_config(arch)),
            specs.param_specs(base.get_config(arch)))


@functools.cache
def _cache_trees(arch: str, shape_name: str):
    rs, ps = rbase.SHAPES[shape_name], base.SHAPES[shape_name]
    return (rspecs.decode_specs(rbase.get_config(arch), rs)[0],
            specs.decode_specs(base.get_config(arch), ps)[0])


def _same_specs(want_tree, got_tree):
    want, got = _flat(want_tree), _flat(got_tree)
    assert sorted(want) == sorted(got)
    for path in want:
        assert isinstance(got[path], sh.PartitionSpec), path
        assert tuple(want[path]) == tuple(got[path]), path
    return want, got


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_rules_match_the_reference(arch, mesh_name):
    multi_pod = MESHES[mesh_name]
    jm, pm = _jmesh(multi_pod), make_production_mesh(multi_pod=multi_pod)
    rcfg, cfg = rbase.get_config(arch), base.get_config(arch)
    rtree, ptree = _param_trees(arch)
    _same_specs(rsh.param_pspecs(jm, rcfg, rtree),
                sh.param_pspecs(pm, cfg, ptree))
    _same_specs(rsh.serving_param_pspecs(jm, rcfg, rtree),
                sh.serving_param_pspecs(pm, cfg, ptree))
    for name in base.SHAPES:
        _same_specs(rsh.batch_pspecs(jm, rcfg, rbase.SHAPES[name]),
                    sh.batch_pspecs(pm, cfg, base.SHAPES[name]))
        if base.SHAPES[name].is_decode and cfg.supports_decode():
            rcache, pcache = _cache_trees(arch, name)
            batch = base.SHAPES[name].global_batch
            _same_specs(rsh.cache_pspecs(jm, rcfg, batch, rcache),
                        sh.cache_pspecs(pm, cfg, batch, pcache))


@pytest.fixture
def fake_world():
    """``fake_world(n)``: a default process group of n ranks on the fake
    backend (this process is rank 0), destroyed after the test."""
    def init(world_size: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world_size)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_name", MESHES)
def test_placements_give_the_reference_shard_shapes(fake_world, mesh_name):
    multi_pod = MESHES[mesh_name]
    jm, pm = _jmesh(multi_pod), make_production_mesh(multi_pod=multi_pod)
    fake_world(pm.size)
    dm = to_device_mesh(pm, "cpu")
    assert dm.mesh_dim_names == pm.axis_names
    checked = 0
    for arch in base.ARCH_IDS:
        cfg = base.get_config(arch)
        trees = [(sh.param_pspecs(pm, cfg, _param_trees(arch)[1]),
                  _param_trees(arch)[1])]
        for name in ("decode_32k", "long_500k"):
            if base.shape_applicable(cfg, base.SHAPES[name])[0]:
                cache = _cache_trees(arch, name)[1]
                trees.append((sh.cache_pspecs(
                    pm, cfg, base.SHAPES[name].global_batch, cache), cache))
        for spec_tree, shape_tree in trees:
            places, shapes = (_flat(sh.to_placements(pm, spec_tree)),
                              _flat(shape_tree))
            for path, spec in _flat(spec_tree).items():
                shape = tuple(shapes[path].shape)
                local, _ = compute_local_shape_and_global_offset(
                    shape, dm, places[path])
                want = NamedSharding(jm, JP(*spec)).shard_shape(shape)
                assert tuple(local) == tuple(want), (arch, path, spec)
                assert sh.local_shape(pm, spec, shape) == tuple(want)
                checked += 1
    assert checked > 150


def test_placements_transpose_and_repeat_in_mesh_order():
    pm = make_production_mesh()
    assert sh.placements(pm, sh.P("model", "data")) == [Shard(1), Shard(0)]
    assert sh.placements(pm, sh.P(None, "model")) == [Replicate(), Shard(1)]
    mp = make_production_mesh(multi_pod=True)
    assert sh.placements(mp, sh.P(("pod", "data"), None)) == \
        [Shard(0), Shard(0), Replicate()]
    assert sh.placements(mp, sh.P(None, ("data", "model"))) == \
        [Replicate(), Shard(1), Shard(1)]
    assert sh.P(("data",), None) == sh.P("data", None)
    assert sh.to_placements(pm, {"a": {"b": sh.P()}}) == \
        {"a": {"b": [Replicate(), Replicate()]}}


def test_to_device_mesh_needs_a_matching_process_group(fake_world):
    pm = AbstractMesh((2, 4), ("data", "model"))
    with pytest.raises(RuntimeError, match="process group"):
        to_device_mesh(pm, "cpu")
    fake_world(4)
    with pytest.raises(ValueError, match="4 ranks"):
        to_device_mesh(pm, "cpu")


# -- activation sharding ------------------------------------------------------

SMALL = ((2, 4), ("data", "model"))
# (function, its extra argument, input shape): each rule on both sides
# of its divisibility tests on a (2, 4) mesh
CONSTRAINTS = [
    ("constrain_tp", 2, (4, 6, 8)),
    ("constrain_tp", 1, (4, 6, 8)),
    ("constrain_tp", 0, (8, 3)),
    ("constrain_rows", None, (8, 3)),
    ("constrain_rows", None, (5, 3)),
    ("constrain_matrix", None, (8, 12)),
    ("constrain_matrix", None, (6, 12)),
    ("constrain_matrix", None, (8, 6)),
    ("constrain_matrix", None, (8, 6, 2)),
    ("constrain", "hidden", (4, 6, 8)),
    ("constrain", "seq", (4, 8, 6)),
    ("constrain", "seq", (4, 6, 8)),
    ("constrain", "seq", (4, 8)),
]


def _reference_pin(monkeypatch, name, arg, shape, batch_axes, seq_axes):
    """The PartitionSpec the reference's ``name`` pins on ``shape`` (None
    where it pins nothing)."""
    pinned = []

    def capture(x, sharding):
        pinned.append(sharding.spec)
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", capture)
    ctx = ract.ActivationSharding(JAbstractMesh(*SMALL), batch_axes,
                                  seq_axes=seq_axes)
    x = jax.numpy.zeros(shape)
    with ract.activation_sharding(ctx):
        fn = getattr(ract, name)
        out = fn(x) if arg is None else fn(x, arg)
    assert out is x
    assert len(pinned) <= 1
    return pinned[0] if pinned else None


@pytest.mark.parametrize("batch_axes,seq_axes",
                         [("data", None), (("data",), "model")])
def test_constrain_pins_the_reference_spec(monkeypatch, fake_world,
                                           batch_axes, seq_axes):
    pm = AbstractMesh(*SMALL)
    fake_world(pm.size)
    dm = to_device_mesh(pm, "cpu")
    rng = np.random.default_rng(0)
    ctx = act.ActivationSharding(pm, batch_axes, seq_axes=seq_axes)
    for name, arg, shape in CONSTRAINTS:
        want = _reference_pin(monkeypatch, name, arg, shape, batch_axes,
                              seq_axes)
        fn = getattr(act, name)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        xd = DTensor.from_local(x, dm, [Replicate(), Replicate()],
                                run_check=False)
        with act.activation_sharding(ctx):
            plain = fn(x) if arg is None else fn(x, arg)
            got = fn(xd) if arg is None else fn(xd, arg)
        assert plain is x
        what = (name, arg, shape)
        if want is None:
            assert got is xd, what
            continue
        places = sh.placements(pm, sh.P(*want))
        assert list(got.placements) == places, what
        local, offset = compute_local_shape_and_global_offset(shape, dm,
                                                              places)
        idx = tuple(slice(o, o + n) for o, n in zip(offset, local))
        assert torch.equal(got.to_local(), x[idx]), what
    assert act.current() is None


def test_constrain_is_the_identity_without_a_context():
    x = torch.ones(4, 8)
    assert act.current() is None
    for fn in (act.constrain_rows, act.constrain_matrix, act.constrain):
        assert fn(x) is x
    assert act.constrain_tp(x, 1) is x
    with act.activation_sharding(
            act.ActivationSharding(AbstractMesh(*SMALL), None)):
        assert act.constrain(x) is x
    ctx = act.ActivationSharding(AbstractMesh(*SMALL), "data")
    assert ctx.spec_hidden(3) == sh.P("data", None, None)
    assert ctx.spec_seq(3) == sh.P("data", "model", None)
