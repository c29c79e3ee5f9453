"""The whole-batch sharded join against the JAX package's sharded ops.

``kernel.multi_shard_gather_join`` serves a batch over every logical
shard in one call; on the CPU it runs its plain version
(``ref.multi_shard_gather_join_ref``). From seeded random tables, bit for
bit against the reference's ``join_sharded_gathered`` /
``join_sharded_border_gathered`` mapped over E shards with
``jax.vmap(axis_name="edge")`` (its XLA join and its Pallas join in
interpret mode), on E = 1, 3 and 8 shards, B replicated and row-sharded,
float32 rows, uint16 codes (scale 1 and a lossy scale, half of them
≥ 0x8000) and int16 codes:

* the plain multi-shard version;
* the port's ops layer, one wrapper call a batch on a one-device mesh,
  and the per-shard path (one call a shard and the MIN seam) on a mesh
  whose shards name different devices;
* the dequantize-first arithmetic against the reference's scatter-gather
  partial (``QuantSpec.dequantize`` of the gathered codes, +inf padding,
  ``join_partial_gathered``), which differs from the sharded engine's
  join-then-scale under a lossy spec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rcore
from repro.kernels.label_join import ops as rlj
from repro_torch.edge import EdgeMesh, default_edge_mesh
from repro_torch.kernels.label_join import kernel, ops as tlj

# (storage, sentinel, scale): float32 rows, uint16 codes at scale 1 and
# at a lossy scale, int16 codes
STORAGES = [("float32", None, None), ("uint16", 0xFFFF, 1.0),
            ("uint16_lossy", 0xFFFF, 0.0731), ("int16", 0x7FFF, 0.25)]
ROWS, W, N, Q, LANES = 12, 24, 50, 17, 96


def _table(rng, shape, storage):
    """float32 distances, 30 % +inf; or codes, 30 % the sentinel."""
    if storage == "float32":
        x = rng.uniform(0.0, 100.0, shape).astype(np.float32)
        x[rng.random(shape) < 0.3] = np.inf
        return x
    npdt = np.int16 if storage == "int16" else np.uint16
    sentinel = int(np.iinfo(npdt).max)
    x = rng.integers(0, sentinel, shape).astype(npdt)
    x[rng.random(shape) < 0.3] = sentinel
    return x


def _inputs(e, row_sharded, storage, seed):
    """Stacked blocks (E, ROWS, W), B (N, Q) — or padded to rpd·E rows
    and cut into E slices — and (owner, rs, rt) with block and border
    row ids in the replicated convention."""
    rng = np.random.default_rng(seed)
    blocks = _table(rng, (e, ROWS, W), storage)
    rpd = -(-N // e)
    btable = _table(rng, (N, Q), storage)
    if row_sharded:
        pad = np.full((rpd * e - N, Q), np.inf if storage == "float32"
                      else np.iinfo(btable.dtype).max, dtype=btable.dtype)
        btable = np.concatenate([btable, pad]).reshape(e, rpd, Q)
    owner = rng.integers(0, e, LANES)
    cross = rng.random((2, LANES)) < 0.5
    rs, rt = (np.where(c, ROWS + rng.integers(0, N, LANES),
                       rng.integers(0, ROWS, LANES)) for c in cross)
    return blocks, btable, owner, rs, rt


def _port(blocks, btable, row_sharded):
    """The same tables as the port's per-shard tensors (uint16 codes as
    int16 bits)."""
    def up(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16
                                else a)
    e = blocks.shape[0]
    borders = [up(btable[d]) for d in range(e)] if row_sharded \
        else [up(btable)] * e
    return [up(blocks[d]) for d in range(e)], borders


def _reference(blocks, btable, owner, rs, rt, row_sharded, quant,
               use_pallas):
    """The reference's sharded op on E shards in process."""
    rop = rlj.join_sharded_border_gathered if row_sharded \
        else rlj.join_sharded_gathered
    ids = [jnp.asarray(x.astype(np.int32)) for x in (owner, rs, rt)]
    out = jax.vmap(
        lambda b, bt: rop(b, bt, *ids, axis="edge", use_pallas=use_pallas,
                          quant=quant),
        in_axes=(0, 0 if row_sharded else None), axis_name="edge")(
            jnp.asarray(blocks), jnp.asarray(btable))
    out = np.asarray(out)
    assert (out == out[0]).all()                # every shard after pmin
    return out[0]


def _ids(*xs):
    return [torch.from_numpy(x.astype(np.int64)) for x in xs]


@pytest.fixture
def calls(monkeypatch):
    """Counts the sharded kernel's wrapper calls, whichever module
    calls it."""
    seen = {"multi": 0, "one": 0}
    multi, one = kernel.multi_shard_gather_join, kernel.sharded_gather_join

    def count_multi(*a, **k):
        seen["multi"] += 1
        return multi(*a, **k)

    def count_one(*a, **k):
        seen["one"] += 1
        return one(*a, **k)

    for mod in (kernel, tlj):
        monkeypatch.setattr(mod, "multi_shard_gather_join", count_multi)
        monkeypatch.setattr(mod, "sharded_gather_join", count_one)
    return seen


@pytest.mark.parametrize("storage,sentinel,scale", STORAGES,
                         ids=[s[0] for s in STORAGES])
@pytest.mark.parametrize("row_sharded", [False, True], ids=["rep", "row"])
@pytest.mark.parametrize("e", [1, 3, 8])
def test_one_call_matches_reference_sharded_ops(e, row_sharded, storage,
                                                sentinel, scale, calls):
    blocks, btable, owner, rs, rt = _inputs(e, row_sharded, storage, 10 * e)
    quant = None if sentinel is None else (sentinel, scale)
    want = _reference(blocks, btable, owner, rs, rt, row_sharded, quant,
                      use_pallas=True)
    np.testing.assert_array_equal(
        _reference(blocks, btable, owner, rs, rt, row_sharded, quant,
                   use_pallas=False), want)
    tblocks, tborders = _port(blocks, btable, row_sharded)
    ids = _ids(owner, rs, rt)
    rpd = tborders[0].shape[0] if row_sharded else None
    got = kernel.multi_shard_gather_join(tblocks, tborders, *ids,
                                         rows_per_border_shard=rpd,
                                         quant=quant)
    assert got.dtype == torch.float32 and got.shape == (LANES,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the ops layer: one wrapper call a batch on a one-device mesh
    op = tlj.join_sharded_border_gathered if row_sharded \
        else tlj.join_sharded_gathered
    calls.update(multi=0, one=0)
    got = op(tblocks, tborders, *ids,
             mesh=default_edge_mesh(e, device="cpu"), quant=quant)
    np.testing.assert_array_equal(got.numpy(), want)
    assert calls == {"multi": 1, "one": 0}
    # shards that name different devices: one call a shard + the seam
    mesh = EdgeMesh((torch.device("cpu"),) + (torch.device("cpu", 0),)
                    * (e - 1)) if e > 1 else None
    if mesh is not None:
        calls.update(multi=0, one=0)
        got = op(tblocks, tborders, *ids, mesh=mesh, quant=quant)
        np.testing.assert_array_equal(got.numpy(), want)
        assert calls == {"multi": 0, "one": e}


@pytest.mark.parametrize("row_sharded", [False, True], ids=["rep", "row"])
def test_more_shards_than_one_call_takes_run_one_call_a_shard(
        row_sharded, calls, monkeypatch):
    """A one-device mesh of more shards than the kernel's table holds
    takes the per-shard path (one call a shard and the seam)."""
    blocks, btable, owner, rs, rt = _inputs(8, row_sharded, "uint16", 7)
    quant = (0xFFFF, 1.0)
    want = _reference(blocks, btable, owner, rs, rt, row_sharded, quant,
                      use_pallas=False)
    tblocks, tborders = _port(blocks, btable, row_sharded)
    monkeypatch.setattr(tlj, "MAX_SHARDS", 4)
    op = tlj.join_sharded_border_gathered if row_sharded \
        else tlj.join_sharded_gathered
    got = op(tblocks, tborders, *_ids(owner, rs, rt),
             mesh=default_edge_mesh(8, device="cpu"), quant=quant)
    np.testing.assert_array_equal(got.numpy(), want)
    assert calls == {"multi": 0, "one": 8}


def _reference_dequant_first(blocks, btable, owner, rs, rt, row_sharded,
                             spec, use_pallas):
    """The reference's scatter-gather arithmetic on E shards: each shard
    gathers its lanes' codes, ``QuantSpec.dequantize``s them, pads the
    border rows to W with +inf and joins them with
    ``join_partial_gathered``; each lane keeps its owner's answer."""
    e = blocks.shape[0]
    whole = btable.reshape(-1, Q) if row_sharded else btable
    out = np.full(LANES, np.inf, dtype=np.float32)
    for d in range(e):
        sel = np.nonzero(owner == d)[0]
        if not len(sel):
            continue

        def rows(ids):
            got = np.full((len(ids), W), np.inf, dtype=np.float32)
            local = ids < ROWS
            got[local] = spec.dequantize(blocks[d][ids[local]])
            got[~local, :Q] = spec.dequantize(whole[ids[~local] - ROWS])
            return got

        out[sel] = rlj.join_partial_gathered(rows(rs[sel]), rows(rt[sel]),
                                             use_pallas=use_pallas)
    return out


@pytest.mark.parametrize("storage,sentinel,scale", STORAGES[1:],
                         ids=[s[0] for s in STORAGES[1:]])
@pytest.mark.parametrize("row_sharded", [False, True], ids=["rep", "row"])
@pytest.mark.parametrize("e", [1, 3, 8])
def test_dequant_first_matches_reference_scatter_arithmetic(
        e, row_sharded, storage, sentinel, scale):
    blocks, btable, owner, rs, rt = _inputs(e, row_sharded, storage,
                                            10 * e + 1)
    dtype = np.int16 if storage == "int16" else np.uint16
    spec = rcore.QuantSpec(scale, dtype, lossless=False)
    want = _reference_dequant_first(blocks, btable, owner, rs, rt,
                                    row_sharded, spec, use_pallas=True)
    np.testing.assert_array_equal(
        _reference_dequant_first(blocks, btable, owner, rs, rt, row_sharded,
                                 spec, use_pallas=False), want)
    tblocks, tborders = _port(blocks, btable, row_sharded)
    got = kernel.multi_shard_gather_join(
        tblocks, tborders, *_ids(owner, rs, rt),
        rows_per_border_shard=tborders[0].shape[0] if row_sharded else None,
        quant=(sentinel, scale), dequant_first=True)
    np.testing.assert_array_equal(got.numpy(), want)
    if storage == "uint16_lossy":
        # join-then-scale is the sharded engine's arithmetic, not this
        joined = kernel.multi_shard_gather_join(
            tblocks, tborders, *_ids(owner, rs, rt),
            rows_per_border_shard=tborders[0].shape[0] if row_sharded
            else None, quant=(sentinel, scale))
        assert not torch.equal(joined, got)


@pytest.mark.parametrize("what", [
    "too_many_shards", "widths_differ", "border_wider", "dequant_floats",
    "slice_rows", "no_shards", "ids_dtype"])
def test_multi_shard_wrapper_refuses_on_every_device(what):
    """The wrapper's contract holds on the CPU too: the plain version
    takes only what the kernel takes."""
    blocks = [torch.zeros((4, 8)) for _ in range(3)]
    borders = [torch.zeros((5, 6)) for _ in range(3)]
    ids = torch.zeros(7, dtype=torch.int64)
    kw, owner = {}, ids
    if what == "too_many_shards":
        blocks = [blocks[0]] * (kernel.MAX_SHARDS + 1)
        borders = [borders[0]] * (kernel.MAX_SHARDS + 1)
    elif what == "widths_differ":
        blocks[1] = torch.zeros((4, 9))
    elif what == "border_wider":
        borders = [torch.zeros((5, 9)) for _ in range(3)]
    elif what == "dequant_floats":
        kw = dict(dequant_first=True)
    elif what == "slice_rows":
        borders[1] = torch.zeros((4, 6))
        kw = dict(rows_per_border_shard=5)
    elif what == "no_shards":
        blocks, borders = [], []
    else:
        owner = ids.int()
    with pytest.raises(ValueError):
        kernel.multi_shard_gather_join(blocks, borders, owner, ids, ids,
                                       **kw)


def test_empty_batch_and_lanes_outside_the_table():
    blocks, btable, owner, rs, rt = _inputs(3, False, "float32", 5)
    tblocks, tborders = _port(blocks, btable, False)
    empty = torch.zeros(0, dtype=torch.int64)
    assert kernel.multi_shard_gather_join(tblocks, tborders, empty, empty,
                                          empty).shape == (0,)
    owner = owner.copy()
    owner[::4] = -1
    owner[1::4] = 3
    got = kernel.multi_shard_gather_join(tblocks, tborders,
                                         *_ids(owner, rs, rt))
    assert torch.isinf(got[torch.from_numpy((owner < 0) | (owner > 2))]).all()
    np.testing.assert_array_equal(
        got.numpy(), _reference(blocks, btable, owner, rs, rt, False, None,
                                use_pallas=False))
