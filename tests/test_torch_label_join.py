"""The port's label joins against the JAX package, bit for bit.

The same numpy-seeded inputs go through the JAX package's Pallas
kernels (interpret mode, as its own tests run them on the CPU), its
XLA/NumPy references and serving entry points, and through the port's
plain PyTorch versions and ops on ``device="cpu"``. Tolerance: none —
min is exact and order-free, ``s + t`` is one IEEE float32 add, codes
below 2^16 and their sums are exact in float32, and the quantized
``· scale`` is one float32 multiply on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.label_join import ops as rops
from repro.kernels.label_join.kernel import join_lb_pallas, join_pallas
from repro.kernels.label_join.ref import (join_ref as rjoin_ref,
                                          join_sparse_ref as rsparse_ref,
                                          local_bound_ref as rlb_ref)
from repro_torch.kernels import build
from repro_torch.kernels.label_join import kernel, ops, ref

jax.config.update("jax_enable_x64", False)

JOIN_SHAPES = [(1, 1), (5, 7), (64, 128), (100, 257), (512, 512), (3, 1024)]
LB_SHAPES = [(16, 32), (100, 130), (257, 64)]


def _rand_dist(rng, shape, inf_frac=0.3):
    x = rng.uniform(0.5, 50.0, size=shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


def _rand_codes(rng, shape, dtype, inf_frac=0.15):
    sentinel = np.iinfo(dtype).max
    c = rng.integers(0, sentinel, size=shape).astype(dtype)
    c[rng.random(shape) < inf_frac] = sentinel
    return c, int(sentinel)


def _t(x: np.ndarray) -> torch.Tensor:
    return ops.upload(x, "cpu")


@pytest.mark.parametrize("q,h", JOIN_SHAPES)
def test_join_matches_pallas_and_ref(q, h):
    rng = np.random.default_rng(q * 31 + h)
    s, t = _rand_dist(rng, (q, h)), _rand_dist(rng, (q, h))
    pallas = np.asarray(join_pallas(jnp.asarray(s), jnp.asarray(t),
                                    bq=32, bh=64, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(rjoin_ref(jnp.asarray(s), jnp.asarray(t))), pallas)
    np.testing.assert_array_equal(ref.join_ref(_t(s), _t(t)).numpy(),
                                  pallas)
    np.testing.assert_array_equal(ops.join(_t(s), _t(t)).numpy(), pallas)


@pytest.mark.parametrize("q,h", LB_SHAPES)
def test_join_with_bound_matches_pallas_and_ref(q, h):
    rng = np.random.default_rng(q + h)
    s, t = _rand_dist(rng, (q, h)), _rand_dist(rng, (q, h))
    lam, lb = join_lb_pallas(jnp.asarray(s), jnp.asarray(t), bq=32, bh=64,
                             interpret=True)
    np.testing.assert_array_equal(
        np.asarray(rlb_ref(jnp.asarray(s), jnp.asarray(t))), np.asarray(lb))
    got_lam, got_lb = ops.join_with_bound(_t(s), _t(t))
    np.testing.assert_array_equal(got_lam.numpy(), np.asarray(lam))
    np.testing.assert_array_equal(got_lb.numpy(), np.asarray(lb))
    np.testing.assert_array_equal(ref.local_bound_ref(_t(s), _t(t)).numpy(),
                                  np.asarray(lb))


HALF_DTYPES = [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)]


@pytest.mark.parametrize("tdt,jdt", HALF_DTYPES)
@pytest.mark.parametrize("q,h", [(4, 6), (37, 133), (3, 1)])
def test_half_precision_rows_match_the_reference_join(q, h, tdt, jdt):
    """bfloat16 and float16 rows on the CPU, as the JAX package's
    ``join`` / ``join_with_bound`` take them: widened to float32, joined,
    each result rounded once to the rows' dtype. Bit for bit with the
    reference entry points (its Pallas kernels do the same arithmetic).
    Its pure-jnp oracles add in the narrow dtype; they agree here too:
    on these values every float32 sum is exact (exponents within 7 of
    each other), so both round the exact sum once, and rounding is
    monotone, so it commutes with min."""
    rng = np.random.default_rng(q * 5 + h)
    s, t = _rand_dist(rng, (q, h)), _rand_dist(rng, (q, h))
    js, jt = jnp.asarray(s).astype(jdt), jnp.asarray(t).astype(jdt)
    ts_, tt_ = _t(s).to(tdt), _t(t).to(tdt)
    before = dict(kernel.LAUNCHES)
    got = ops.join(ts_, tt_)
    got_lam, got_lb = ops.join_with_bound(ts_, tt_)
    assert kernel.LAUNCHES == before
    assert got.dtype == got_lam.dtype == got_lb.dtype == tdt
    lam, lb = rops.join_with_bound(js, jt)
    for mine, want in ((got, rops.join(js, jt)), (got_lam, lam),
                       (got_lb, lb), (got, rjoin_ref(js, jt)),
                       (got_lb, rlb_ref(js, jt))):
        assert want.dtype == jdt
        np.testing.assert_array_equal(mine.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", [np.uint16, np.int16])
@pytest.mark.parametrize("scale", [1.0, 0.37])
@pytest.mark.parametrize("q,h", [(7, 5), (100, 130), (300, 64)])
def test_join_quantized_matches_both_reference_paths(q, h, scale, dtype):
    rng = np.random.default_rng(q * 7 + h)
    s, sentinel = _rand_codes(rng, (q, h), dtype)
    t, _ = _rand_codes(rng, (q, h), dtype)
    want = np.asarray(rops.join_quantized(
        jnp.asarray(s), jnp.asarray(t), sentinel=sentinel, scale=scale,
        use_pallas=False))
    pallas = np.asarray(rops.join_quantized(
        jnp.asarray(s), jnp.asarray(t), sentinel=sentinel, scale=scale,
        use_pallas=True))
    np.testing.assert_array_equal(pallas, want)
    got = ops.join_quantized(_t(s), _t(t), sentinel=sentinel, scale=scale)
    np.testing.assert_array_equal(got.numpy(), want)
    # uint16 tensors are read through their int16 bits
    if dtype is np.uint16:
        native = torch.from_numpy(s), torch.from_numpy(t)
        np.testing.assert_array_equal(
            ops.join_quantized(*native, sentinel=sentinel,
                               scale=scale).numpy(), want)


def test_join_sparse_matches_reference_and_labels():
    from repro_torch.core import grid_road_network, pll
    g = grid_road_network(5, 5, seed=2)
    labels = pll(g)
    rng = np.random.default_rng(3)
    ss = rng.integers(0, g.num_vertices, size=30)
    ts = rng.integers(0, g.num_vertices, size=30)
    args = (labels.hubs[ss], labels.dists[ss], labels.hubs[ts],
            labels.dists[ts])
    want = np.asarray(rsparse_ref(*map(jnp.asarray, args)))
    got = ops.join_sparse(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, labels.query_many(ss, ts))


# -- gathered serving entry points, empty and zero-width cases included -----

GATHERED = [(0, 16), (1, 1), (37, 5), (300, 64), (40, 0), (0, 0)]


def _gathered_case(qn, w, seed):
    rng = np.random.default_rng(seed)
    rows = 50
    table = _rand_dist(rng, (rows, w))
    ss = rng.integers(0, rows, qn)
    ts = rng.integers(0, rows, qn)
    return rng, table, ss, ts


@pytest.mark.parametrize("qn,w", GATHERED)
def test_join_gathered_matches_reference(qn, w):
    _, table, ss, ts = _gathered_case(qn, w, 1 + qn + w)
    want = rops.join_gathered(table, ss, ts)
    for tab in (_t(table), ops.upload(table, "cpu")):
        got = ops.join_gathered(tab, ss, ts)
        assert got.dtype == np.float32 and got.shape == (qn,)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qn,w", GATHERED)
def test_bound_gathered_matches_reference(qn, w):
    _, table, ss, ts = _gathered_case(qn, w, 2 + qn + w)
    want = rops.bound_gathered(table, ss, ts)
    got = ops.bound_gathered(_t(table), ss, ts)
    assert got.shape == (qn,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint16, np.int16])
@pytest.mark.parametrize("qn,w", GATHERED)
def test_join_quantized_gathered_matches_reference(qn, w, dtype):
    rng = np.random.default_rng(3 + qn + w)
    table, sentinel = _rand_codes(rng, (50, w), dtype)
    ss, ts = rng.integers(0, 50, qn), rng.integers(0, 50, qn)
    want = rops.join_quantized_gathered(table, ss, ts, sentinel=sentinel,
                                        scale=1.0)
    got = ops.join_quantized_gathered(_t(table), ss, ts, sentinel=sentinel,
                                      scale=1.0)
    assert got.shape == (qn,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qn", [0, 1, 45])
def test_join_sparse_gathered_matches_reference(qn):
    from repro_torch.core import grid_road_network, pll
    labels = pll(grid_road_network(4, 6, seed=qn))
    rng = np.random.default_rng(qn)
    ss = rng.integers(0, labels.num_vertices, qn)
    ts = rng.integers(0, labels.num_vertices, qn)
    want = rops.join_sparse_gathered(labels.hubs, labels.dists, ss, ts)
    got = ops.join_sparse_gathered(torch.from_numpy(labels.hubs),
                                   torch.from_numpy(labels.dists), ss, ts)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# -- the fused kernel's plain version and wrapper contract -------------------

@pytest.mark.parametrize("with_lb", [False, True])
def test_gather_join_plain_reads_two_tables(with_lb):
    rng = np.random.default_rng(9)
    s, t = _rand_dist(rng, (30, 40)), _rand_dist(rng, (17, 40))
    rs, rt = rng.integers(0, 30, 64), rng.integers(0, 17, 64)
    got = kernel.gather_join(_t(s), torch.from_numpy(rs), _t(t),
                             torch.from_numpy(rt), with_lb=with_lb)
    want = np.asarray(rjoin_ref(jnp.asarray(s[rs]), jnp.asarray(t[rt])))
    lam = got[0] if with_lb else got
    np.testing.assert_array_equal(lam.numpy(), want)
    if with_lb:
        np.testing.assert_array_equal(
            got[1].numpy(),
            np.asarray(rlb_ref(jnp.asarray(s[rs]), jnp.asarray(t[rt]))))


def test_cpu_calls_run_the_plain_version_and_count_no_launch():
    before = dict(kernel.LAUNCHES)
    rng = np.random.default_rng(4)
    table = _rand_dist(rng, (20, 8))
    ops.join_gathered(_t(table), np.arange(5), np.arange(5))
    ops.bound_gathered(_t(table), np.arange(5), np.arange(5))
    assert kernel.LAUNCHES == before


def test_row_ids_out_of_range_raise():
    table = _t(np.zeros((4, 3), dtype=np.float32))
    with pytest.raises(IndexError):
        ops.join_gathered(table, np.array([0, 4]), np.array([1, 1]))
    with pytest.raises(IndexError):
        ops.bound_gathered(table, np.array([-1]), np.array([1]))
    with pytest.raises(ValueError, match="one length"):
        ops.join_gathered(table, np.array([0, 3]), np.array([1]))


# row ids from the host: out of range in either array, or valid but not
# C-contiguous int64 (cast and copied as ``np.ascontiguousarray`` does)
ID_ROWS = 20
OUT_OF_RANGE = ("minus_one", "rows", "int64_min", "t_only")
RESHAPED = ("int32", "reversed", "strided")


def _id_case(case: str) -> tuple[np.ndarray, np.ndarray]:
    ids = np.random.default_rng(17).integers(0, ID_ROWS, 66)
    ss, ts = ids[:33], ids[33:]
    return {
        "minus_one": (np.r_[ss[:-1], -1], ts),
        "rows": (np.r_[ss[:-1], ID_ROWS], ts),
        "int64_min": (np.r_[np.iinfo(np.int64).min, ss[1:]], ts),
        "t_only": (ss, np.r_[ts[:-1], ID_ROWS]),
        "int32": (ss.astype(np.int32), ts.astype(np.int32)),
        "reversed": (ss[::-1], ts[::-1]),
        "strided": (ids[::2], ids[1::2]),
    }[case]


@pytest.mark.parametrize("case", OUT_OF_RANGE + RESHAPED)
def test_serving_joins_check_and_normalise_row_ids(case, monkeypatch):
    joins = []
    gather_join = ops.gather_join

    def counted(*args, **kwargs):
        joins.append(1)
        return gather_join(*args, **kwargs)

    monkeypatch.setattr(ops, "gather_join", counted)
    rng = np.random.default_rng(18)
    table = _t(_rand_dist(rng, (ID_ROWS, 9)))
    codes, sentinel = _rand_codes(rng, (ID_ROWS, 9), np.uint16)
    codes = _t(codes)
    calls = (lambda a, b: ops.join_gathered(table, a, b),
             lambda a, b: ops.join_quantized_gathered(
                 codes, a, b, sentinel=sentinel, scale=0.5))
    ss, ts = _id_case(case)
    for call in calls:
        if case in OUT_OF_RANGE:         # raised before any join runs
            with pytest.raises(IndexError):
                call(ss, ts)
            assert joins == []
            continue
        assert not (ss.flags.c_contiguous and ss.dtype == np.int64)
        want = call(np.ascontiguousarray(ss, dtype=np.int64),
                    np.ascontiguousarray(ts, dtype=np.int64))
        np.testing.assert_array_equal(call(ss, ts), want)


@pytest.mark.parametrize("case", ["f32_as_codes", "codes_as_f32",
                                  "lb_on_codes", "bad_sentinel",
                                  "widths", "row_dtype"])
def test_gather_join_rejects_what_the_kernel_does_not_take(case):
    f = torch.zeros((4, 3))
    c = torch.zeros((4, 3), dtype=torch.int16)
    ids = torch.zeros(2, dtype=torch.int64)
    args, kw = {
        "f32_as_codes": ((f, ids, f, ids), {"quant": (65535, 1.0)}),
        "codes_as_f32": ((c, ids, c, ids), {}),
        "lb_on_codes": ((c, ids, c, ids), {"quant": (65535, 1.0),
                                           "with_lb": True}),
        "bad_sentinel": ((c, ids, c, ids), {"quant": (255, 1.0)}),
        "widths": ((f, ids, torch.zeros((4, 5)), ids), {}),
        "row_dtype": ((f, ids.int(), f, ids.int()), {}),
    }[case]
    with pytest.raises(ValueError):
        kernel.gather_join(*args, **kw)


# -- what the kernel's code path relies on ---------------------------------------

@pytest.mark.parametrize("dtype,bias", [(np.uint16, 0), (np.int16, 1 << 15)])
def test_code_widening_without_conversion_is_exact(dtype, bias):
    """The kernel widens a 16-bit code c to the float with bit pattern
    2^23 + (c + bias), less 2^23 + bias (``element`` in
    csrc/label_join.cu): float(c) bit for bit, for every code."""
    codes = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(dtype)
    pattern = np.uint32(0x4B000000) | (codes.astype(np.int64)
                                       + bias).astype(np.uint32)
    got = pattern.view(np.float32) - np.float32(2 ** 23 + bias)
    assert np.array_equal(got.view(np.uint32),
                          codes.astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("dtype", [np.uint16, np.int16])
def test_sentinel_is_the_largest_code_of_its_type(dtype):
    """The kernel skips a sum whose larger term is the sentinel, which is
    right only because the wrapper takes each code type's largest value
    as its sentinel and no other."""
    top = int(np.iinfo(dtype).max)
    assert top in kernel._SENTINELS
    assert len(kernel._SENTINELS) == 2
    table = torch.from_numpy(np.array([[top, 3, 5], [7, top, 1]],
                                      dtype=dtype).view(np.int16))
    ids = torch.tensor([0, 1])
    got = kernel.gather_join(table, ids, table, ids.flip(0),
                             quant=(top, 0.5))
    # row 0 + row 1: (top + 7, 3 + top, 5 + 1) -> only 6 counts
    assert torch.equal(got, torch.tensor([3.0, 3.0]))


def test_build_targets_hopper_without_fast_math():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-fmad=false" in flags
    lib = build.library_path(kernel.SOURCE)
    assert lib.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")


# -- tables that start off their buffer's alignment ---------------------------

def _table_at(storage, rows, w, offset):
    """A contiguous (rows, w) table starting ``offset`` elements into a
    64-byte-aligned buffer."""
    dtype = torch.float32 if storage == "float32" else torch.int16
    flat = torch.zeros(rows * w + offset + 64, dtype=dtype)
    skip = (-flat.data_ptr() % 64) // flat.element_size()
    table = flat[skip + offset:skip + offset + rows * w].view(rows, w)
    assert table.is_contiguous()
    assert (table.data_ptr() - offset * table.element_size()) % 64 == 0
    return table


@pytest.mark.parametrize("storage", ["float32", "uint16", "int16"])
@pytest.mark.parametrize("w", [1, 93, 96, 133, 256])
def test_joins_of_offset_tables_match_the_reference(storage, w):
    """A table sliced one element off its buffer's alignment (the kernel
    then loads 4- or 2-byte vectors) joins as the JAX package's gathered
    joins do on the same rows, bit for bit."""
    rng = np.random.default_rng(w + len(storage))
    rows, qn = 40, 64
    ss, ts = rng.integers(0, rows, qn), rng.integers(0, rows, qn)
    table = _table_at("float32" if storage == "float32" else "int16", rows,
                      w, 1)
    if storage == "float32":
        host = _rand_dist(rng, (rows, w))
        table.copy_(torch.from_numpy(host))
        np.testing.assert_array_equal(ops.join_gathered(table, ss, ts),
                                      rops.join_gathered(host, ss, ts))
        np.testing.assert_array_equal(ops.bound_gathered(table, ss, ts),
                                      rops.bound_gathered(host, ss, ts))
        return
    host, sentinel = _rand_codes(rng, (rows, w), np.dtype(storage).type)
    table.copy_(torch.from_numpy(host.view(np.int16)))
    np.testing.assert_array_equal(
        ops.join_quantized_gathered(table, ss, ts, sentinel=sentinel,
                                    scale=0.5),
        rops.join_quantized_gathered(host, ss, ts, sentinel=sentinel,
                                     scale=0.5))
