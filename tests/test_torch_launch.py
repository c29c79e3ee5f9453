"""The port's launch tooling (``launch/specs``, ``launch/dryrun``,
``launch/roofline``, ``launch/mesh``) against the JAX package's.

* specs: every leaf's shape and dtype of ``input_specs`` equals the
  reference's ``jax.eval_shape`` tree, for all ten architectures at
  full size and every applicable shape (the port's leaves are fake
  tensors: no storage);
* the roofline arithmetic: ``model_flops``, ``active_params`` and
  ``flash_attention_cost`` equal the reference's for every arch × shape,
  and ``roofline_terms`` on one fixed probe equals the reference's, to
  the float, once the port's H100 constants are replaced by the
  reference's v5e constants (and the link count by its 4);
* the ``"stub"`` attention probe is bit for bit with the reference's
  ``gqa_apply`` under ``attention_impl="stub"``;
* the probe's L0/L1 extrapolation equals the direct count at another
  depth (the stacks are layer-homogeneous);
* the dry run: ``argument_mb_per_dev`` is the reference's rules' local
  shard bytes of the reference's own input trees (``NamedSharding(
  AbstractMesh, spec).shard_shape``), and what has no torch form
  (``lower_s``, ``compile_s``, the memory analysis, ``collectives``,
  ``collective_bytes``) is absent, not zero; both CLIs run a cell.

Importing the reference's ``launch/roofline.py`` appends a 512-device
flag to ``XLA_FLAGS`` for its own CLI; the ``rroof`` fixture restores
the variable after each test, and those tests compute nothing with JAX.
"""
import json
import os
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding

from repro.configs import base as rbase
from repro.distributed import sharding as rsh
from repro.launch import specs as rspecs
from repro.models import attention as ratt
from repro_torch.configs import base
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import dryrun, mesh, roofline, specs
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import attention as att

V5E = {"PEAK_FLOPS_BF16": 197e12, "HBM_BW": 819e9, "ICI_BW": 50e9}


@pytest.fixture
def rroof(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import roofline as ref
    return ref


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    rcfg, cfg = rbase.get_config(arch), base.get_config(arch)
    for name in base.SHAPES:
        if not base.shape_applicable(cfg, base.SHAPES[name])[0]:
            continue
        want = _flat(rspecs.input_specs(rcfg, rbase.SHAPES[name]))
        got = _flat(specs.input_specs(cfg, base.SHAPES[name]))
        assert sorted(want) == sorted(got), name
        for path, w in want.items():
            g = got[path]
            assert tuple(g.shape) == tuple(w.shape), (name, path)
            assert _dtype_name(g) == _dtype_name(w), (name, path)
            assert g.device == specs.HOST
            assert type(g).__name__ == "FakeTensor", (name, path)


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_roofline_arithmetic_matches_the_reference(rroof, arch):
    assert roofline.active_params(arch) == rroof.active_params(arch)
    for name in base.SHAPES:
        assert roofline.model_flops(arch, name) == \
            rroof.model_flops(arch, name)
        for chips in (1, 256, 512):
            assert roofline.flash_attention_cost(arch, name, chips) == \
                rroof.flash_attention_cost(arch, name, chips)
        assert roofline.model_flops(arch, base.SHAPES[name]) == \
            rroof.model_flops(arch, name)


@pytest.mark.parametrize("coll", [0.0, 3.7e9])
def test_roofline_terms_equal_the_reference_on_v5e_constants(
        rroof, monkeypatch, coll):
    probe = {"arch": "olmoe_1b_7b", "shape": "train_4k", "mesh": "16x16",
             "kind": "train", "hlo_flops": 4.1e14, "hlo_bytes": 2.3e12,
             "collective_bytes_total": coll}
    for k, v in V5E.items():
        monkeypatch.setattr(mesh, k, v)
    assert roofline.roofline_terms(dict(probe), 256, 4.0) == \
        rroof.roofline_terms(dict(probe), 256, 4.0)


def test_roofline_terms_without_a_collective_figure():
    probe = {"arch": "qwen3_4b", "shape": "prefill_32k", "hlo_flops": 1e12,
             "hlo_bytes": 1e12, "collective_bytes_total": None}
    r = roofline.roofline_terms(probe)
    assert r["collective_s"] is None
    assert r["dominant"] == "memory"
    assert r["step_time_bound_s"] == 1e12 / mesh.HBM_BW
    assert r["compute_s"] == 1e12 / 989e12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3_4b", "zamba2_1_2b"])
def test_stub_attention_matches_the_reference_bit_for_bit(arch, dtype):
    over = dict(attention_impl="stub", compute_dtype=dtype)
    cj = rbase.get_smoke_config(arch).reduced(**over)
    ct = base.get_smoke_config(arch).reduced(**over)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    p = ratt.gqa_init(jax.random.PRNGKey(0), cj, jd)
    pt = lm_params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    x = np.random.default_rng(1).standard_normal(
        (2, 16, cj.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    want = ratt.gqa_apply(p, cj, jnp.asarray(x).astype(jd), jnp.asarray(pos))
    got = att.gqa_apply(pt, ct, torch.from_numpy(x).to(td),
                        torch.from_numpy(pos))
    assert got.dtype == td
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


# the probe's extrapolation: (family's smoke config, depth to extrapolate
# to, step kind); on the (1, 2) mesh olmoe runs moe_apply's
# expert-parallel path (4 experts, 2 a shard), the hybrid extrapolates
# in whole shared groups; the three other dense configs at the depths
# the card's phases run them (StarCoder2-7B's training at 8 layers)
EXTRAP = [("qwen3_4b", 5, "train"), ("qwen3_4b", 5, "prefill"),
          ("olmoe_1b_7b", 5, "train"), ("olmoe_1b_7b", 5, "prefill"),
          ("deepseek_v2_236b", 5, "prefill"), ("mamba2_1_3b", 5, "prefill"),
          ("zamba2_1_2b", 18, "prefill"), ("starcoder2_7b", 32, "prefill"),
          ("starcoder2_7b", 8, "train"), ("deepseek_67b", 24, "prefill"),
          ("nemotron_4_340b", 4, "prefill")]


@pytest.mark.parametrize("arch,depth,kind", EXTRAP)
def test_probe_extrapolation_equals_the_direct_count(arch, depth, kind):
    cfg = replace(base.get_smoke_config(arch), num_layers=depth)
    shape = base.ShapeSpec("probe", 32, 4, kind)
    m = AbstractMesh((1, 2), ("data", "model"))
    probe = roofline.probe_shape(cfg, shape, mesh=m)
    # with first_k_dense the probe's fixed part holds the one dense
    # layer and L more MoE layers are extrapolated, as the override gives
    over = roofline._probe_cfg_overrides(cfg, shape, depth)
    direct = dryrun.lower(dryrun.cell_config(cfg, shape, **over), shape, m,
                          n_micro=1)
    assert probe["hlo_flops"] == direct["flops_total"]
    assert probe["hlo_bytes"] == pytest.approx(direct["bytes_accessed"],
                                               rel=1e-12)
    assert probe["collective_bytes_total"] is None
    assert "collective_bytes" not in probe and "probe_compile_s" not in probe


# -- the dry run --------------------------------------------------------------

NOT_PORTED = ("lower_s", "compile_s", "output_mb_per_dev", "temp_mb_per_dev",
              "peak_mb_per_dev", "collectives")
# (arch, shape, multi-pod, layers): the reference's layouts — FSDP
# training, TP-only serving, ZeRO serving past 4 GB a device, SSM caches
# with the sequence over every axis, the frame frontend (an MoE cell on
# the production mesh runs 256 logical expert-parallel shards a layer:
# minutes on fake tensors; its specs are in test_torch_sharding.py)
CELLS = [("qwen3_4b", "train_4k", False, 2),
         ("qwen3_4b", "decode_32k", True, 36),
         ("nemotron_4_340b", "prefill_32k", False, 8),
         ("zamba2_1_2b", "long_500k", False, 12),
         ("hubert_xlarge", "prefill_32k", True, 2)]


def _reference_argument_bytes(arch, shape_name, multi_pod, layers):
    """The reference's inputs, laid out by its own rules on an
    ``AbstractMesh``: each leaf's shard bytes, summed by role."""
    rcfg = replace(rbase.get_config(arch), num_layers=layers)
    shape = rbase.SHAPES[shape_name]
    pm = mesh.make_production_mesh(multi_pod=multi_pod)
    jm = JAbstractMesh(pm.axis_sizes, pm.axis_names)
    sp = rspecs.input_specs(rcfg, shape)
    tp_share_gb = 2e-9 * rcfg.param_count() / jm.shape["model"]
    if shape.kind == "train" or tp_share_gb > 4.0:
        pspecs = rsh.param_pspecs(jm, rcfg, sp["params"])
    else:
        pspecs = rsh.serving_param_pspecs(jm, rcfg, sp["params"])
    lay = {"params": pspecs, "batch": rsh.batch_pspecs(jm, rcfg, shape)}
    if shape.kind == "train":
        lay["opt"] = {"m": pspecs, "v": pspecs, "step": rsh.P()}
    if shape.kind == "decode":
        bspec = lay.pop("batch")["labels"][0]
        lay.update(cache=rsh.cache_pspecs(jm, rcfg, shape.global_batch,
                                          sp["cache"]),
                   tokens=rsh.P(bspec, None), pos=rsh.P())
    out = {}
    for role, tree in lay.items():
        specs_, leaves = _flat(tree), _flat(sp[role])
        out[role] = sum(
            int(np.prod(NamedSharding(jm, specs_[p]).shard_shape(
                leaves[p].shape))) * np.dtype(leaves[p].dtype).itemsize
            for p in leaves)
    return out


@pytest.mark.parametrize("arch,shape_name,multi_pod,layers", CELLS)
def test_argument_bytes_are_the_reference_layouts(arch, shape_name,
                                                  multi_pod, layers):
    got = dryrun.lower_cell(arch, shape_name, multi_pod, n_micro=1,
                            num_layers=layers)
    want = _reference_argument_bytes(arch, shape_name, multi_pod, layers)
    assert {k: round(v * 1e6) for k, v in
            got["argument_mb_by_role"].items()} == want
    assert got["argument_mb_per_dev"] * 1e6 == \
        pytest.approx(sum(want.values()), rel=1e-15)
    assert got["devices"] == (512 if multi_pod else 256)
    assert got["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert got["flops_total"] > 0 and got["bytes_accessed"] > 0
    assert not set(NOT_PORTED) & set(got)


def test_one_device_mesh_holds_every_byte():
    cfg = base.get_smoke_config("olmoe_1b_7b")
    shape = base.ShapeSpec("t", 16, 2, "train")
    one = AbstractMesh((1, 1), ("data", "model"))
    got = dryrun.lower(cfg, shape, one)
    sp = specs.input_specs(cfg, shape)
    want = sum(t.numel() * t.element_size()
               for role in ("params", "opt", "batch")
               for t in _flat(sp[role]).values())
    assert got["argument_mb_per_dev"] * 1e6 == pytest.approx(want,
                                                             rel=1e-15)
    assert got["n_micro"] == 1 and got["devices"] == 1


def test_what_has_no_torch_form_is_absent():
    for name in ("collective_bytes", "COLLECTIVE_RE", "SHAPE_RE",
                 "DTYPE_BYTES"):
        assert not hasattr(dryrun, name), name
    res, flops, nbytes = dryrun.lower_cell(
        "mamba2_1_3b", "decode_32k", False, return_artifacts=True,
        num_layers=2)
    assert not set(NOT_PORTED) & set(res)
    assert res["flops_total"] == flops.get_total_flops() / 256
    assert res["bytes_accessed"] == nbytes.total / 256
    assert dryrun.lower_cell("hubert_xlarge", "decode_32k", False) == {
        "arch": "hubert_xlarge", "shape": "decode_32k",
        "skipped": "encoder-only: no decode step"}


def test_dryrun_and_roofline_clis_run_a_cell(tmp_path, monkeypatch, capsys):
    out = tmp_path / "dry.json"
    argv = ["dryrun", "--arch", "qwen3_4b", "--shape", "decode_32k",
            "--mesh", "pod", "--out", str(out)]
    monkeypatch.setattr(sys, "argv", argv)
    dryrun.main()
    cell = json.loads(out.read_text())["qwen3_4b|decode_32k|sp"]
    assert "error" not in cell and cell["devices"] == 256
    assert "[dryrun] qwen3_4b decode_32k" in capsys.readouterr().out
    dryrun.main()                        # resumes: the cell is done
    assert "[dryrun] qwen3_4b" not in capsys.readouterr().out

    out = tmp_path / "roof.json"
    monkeypatch.setattr(sys, "argv", ["roofline", "--arch", "qwen3_4b",
                                      "--shape", "decode_32k", "--out",
                                      str(out)])
    roofline.main()
    cell = json.loads(out.read_text())["qwen3_4b|decode_32k"]
    assert cell["dominant"] in ("compute", "memory")
    assert cell["collective_s"] is None
    assert cell["model_flops"] == roofline.model_flops("qwen3_4b",
                                                       "decode_32k")
    assert "[roofline] qwen3_4b|decode_32k" in capsys.readouterr().out
    # decode attention is linear already: the optimized probe is the probe
    monkeypatch.setattr(sys, "argv", ["roofline", "--arch", "qwen3_4b",
                                      "--shape", "decode_32k", "--out",
                                      str(tmp_path / "opt.json"),
                                      "--optimized"])
    roofline.main()
    opt = json.loads((tmp_path / "opt.json").read_text())[
        "qwen3_4b|decode_32k"]
    assert opt["optimized"]["hlo_flops"] == cell["hlo_flops"]
    assert "[perf] qwen3_4b|decode_32k" in capsys.readouterr().out


def test_edge_mesh_is_the_edge_layouts():
    from repro_torch.edge import default_edge_mesh
    assert mesh.make_edge_mesh(4, device="cpu") is \
        default_edge_mesh(4, device="cpu")
    pm = mesh.make_production_mesh(multi_pod=True)
    assert (pm.shape, pm.size) == ({"pod": 2, "data": 16, "model": 16}, 512)
    with pytest.raises(ValueError, match="sizes"):
        AbstractMesh((2, 2), ("data",))
