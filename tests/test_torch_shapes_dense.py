"""The card's shape cells of InternVL2-26B, StarCoder2-7B, DeepSeek-67B
and Nemotron-4-340B's decode, and the VLM path they add, on the CPU.

``chip_smoke.py`` runs the JAX package's ``SHAPES`` cells
(``SHAPE_CELLS``) on the card and names the cells one card cannot hold
(``NOT_ON_ONE_CARD``); here:

* the tables: the cells and the cells left out are, together and apart,
  the 31 (arch, shape) pairs of the JAX package's ``ARCH_IDS`` x
  ``SHAPES`` that ``shape_applicable`` lets run, 29 of them cells; each
  new cell runs its config at its shape, with the flash launches a
  prefill expects, and each cell left out gives its bytes;
* ``lm_inputs``, the prefill batch of every shape cell: a VLM's batch
  carries (b, 256, d) float32 patch embeddings beside its tokens, as the
  JAX package's ``launch/specs.py`` ``batch_specs`` gives them, so that
  InternVL2's prefill attends over 256 + 32 768 = 33 024 positions;
* InternVL2's path at smoke width with its 256 patches and 1024 text
  tokens, from numpy-seeded inputs, against the JAX package: the
  forward (dense attention, and flash: the port's plain version against
  the Pallas kernel in interpret mode), the prefill step's logits,
  ``loss_fn`` (which scores the text positions only) and one train
  step (loss, gradient norm, learning rate; every param after the step
  by relative L2, Adam dividing each gradient by its own magnitude);
* ``flash_rows_check``, the prefill cells' float32 check, on CPU
  tensors: it holds the rows of the first attention layer over the
  patches and the text, its last slice ending at the last position.

The decode steps of these configs at pos 32 767 are held against the
JAX package in ``tests/test_torch_long_context.py``. Tolerance 1e-4 in
float32 (the same arithmetic, sums in another order), as there.
"""
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.launch import specs as rspecs
from repro.models import lm as rlm
from repro.train import data as rdata
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.models import lm
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train.train_step import make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TOL = 1e-4
VLM = "internvl2_26b"
# the ten cells of this slice, and the flash launches of each prefill
NEW_CELLS = {
    "shape_prefill_32k_internvl2_26b": 48,
    "shape_prefill_32k_starcoder2_7b": 32,
    "shape_prefill_32k_deepseek_67b": 24,
    "shape_decode_32k_internvl2_26b": None,
    "shape_decode_32k_starcoder2_7b": None,
    "shape_decode_32k_deepseek_67b": None,
    "shape_decode_32k_nemotron_4_340b": None,
    "shape_train_4k_internvl2_26b": None,
    "shape_train_4k_starcoder2_7b": None,
    "shape_train_4k_deepseek_67b": None}
# InternVL2's smoke config (d_model 128, 4 / 2 heads of 32, vocab 512) at
# the published 256 patches, 2 layers, float32
TEXT = 1024


def test_shape_cells_and_the_cells_left_out_are_the_31_applicable_cells():
    want = {(arch, shape) for arch in rbase.ARCH_IDS for shape in rbase.SHAPES
            if rbase.shape_applicable(rbase.get_config(arch),
                                      rbase.SHAPES[shape])[0]}
    assert len(want) == 31
    cells = [(spec["arch"], spec["shape"])
             for spec in chip_smoke.SHAPE_CELLS.values()]
    left_out = set(chip_smoke.NOT_ON_ONE_CARD)
    assert len(cells) == len(set(cells)) == 29
    assert not set(cells) & left_out
    assert set(cells) | left_out == want


@pytest.mark.parametrize("name", sorted(NEW_CELLS))
def test_new_cell_runs_its_config_at_its_shape(name):
    """Named after its shape and config, the shape applies; a prefill's
    float32 check holds row slices and its flash launches are one a
    layer; a decode check runs at batch 1 over the whole cache; a train
    cell and its check run the shape's 4096 tokens; any depth cut stays
    below the published one."""
    spec = chip_smoke.SHAPE_CELLS[name]
    assert name == f"shape_{spec['shape']}_{spec['arch']}"
    full = get_config(spec["arch"])
    assert shape_applicable(full, SHAPES[spec["shape"]])[0]
    assert spec.get("layers", full.num_layers) <= full.num_layers
    assert spec["batch"] <= SHAPES[spec["shape"]].global_batch
    tight = spec["tight"]
    if spec["shape"] == "prefill_32k":
        assert tight["rows"] == "flash" and tight["layers"] == 1
        cfg = replace(full, num_layers=spec.get("layers", full.num_layers))
        assert chip_smoke.attention_applications(cfg) == NEW_CELLS[name]
    elif spec["shape"] == "decode_32k":
        assert tight["batch"] == 1 and 1 <= tight["layers"] <= 2
    else:
        assert spec["train"]["tokens"] == tight["tokens"] \
            == SHAPES["train_4k"].seq_len
        assert spec["train"]["batch"] == spec["batch"] == 1
        assert tight["layers"] == 1 and tight["host_worker"] in \
            chip_smoke.HOST_WORKERS


@pytest.mark.parametrize("arch,shape", sorted(chip_smoke.NOT_ON_ONE_CARD))
def test_cells_left_out_give_their_bytes(arch, shape):
    """The float32 state of the embedding and the head (and of one MoE
    layer's routed experts), 16 B a parameter, as the reason states it
    and beyond what one card holds beside a layer."""
    cfg = get_config(arch)
    reason = chip_smoke.NOT_ON_ONE_CARD[(arch, shape)]
    ends = 2 * cfg.vocab_size * cfg.d_model
    assert f"{16 * ends / 1e9:.1f} GB" in reason or \
        f"{16 * ends / 1e9:.0f} GB" in reason
    state = 16 * ends
    if cfg.num_experts:
        experts = cfg.num_experts * 3 * cfg.d_model * cfg.moe_d_ff
        assert f"{16 * experts / 1e9:.1f} GB" in reason
        state += 16 * experts
    assert state > 75e9


@pytest.mark.parametrize("arch", [VLM, "qwen3_4b", "hubert_xlarge"])
def test_lm_inputs_are_the_jax_batch_specs(arch):
    """The prefill batch of a shape cell at the published config: the
    inputs (name, shape, float dtype) the JAX package's ``batch_specs``
    gives the cell but its labels; InternVL2's patches (b, 256, d) in
    float32, so its prefill attends over 256 + s positions."""
    b, s = 2, 64
    cfg = get_config(arch)
    got = chip_smoke.lm_inputs(torch, cfg, b, s, torch.Generator(), "cpu")
    want = rspecs.batch_specs(rbase.get_config(arch),
                              rbase.ShapeSpec("p", s, b, "prefill"))
    assert set(got) == set(want) - {"labels"}
    for key, spec in want.items():
        if key in got:
            assert tuple(got[key].shape) == spec.shape, key
            if key != "tokens":
                assert str(got[key].dtype) == f"torch.{spec.dtype}", key
    positions = s + (256 if arch == VLM else 0)
    assert chip_smoke.prefill_positions(cfg, s) == positions
    if arch == VLM:
        assert chip_smoke.prefill_positions(cfg, 32768) == 33024


def _vlm_cfgs(**kw):
    kw = {"compute_dtype": "float32", "num_patches": 256, **kw}
    return (rbase.get_smoke_config(VLM).reduced(**kw),
            get_smoke_config(VLM).reduced(**kw))


def _params(cfg_j, seed):
    params = rlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    return params, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


def _vlm_batch(cfg, b, seed, labels=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, TEXT))
             .astype(np.int32),
             "patches": rng.standard_normal((b, cfg.num_patches, cfg.d_model))
             .astype(np.float32)}
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size, (b, TEXT)) \
            .astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


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


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_vlm_forward_and_prefill_with_256_patches_match_jax(impl):
    """Hidden states of every position (256 patches, then 1024 text
    tokens) and the prefill step's last-position logits, float32."""
    cfg_j, cfg_t = _vlm_cfgs(attention_impl=impl)
    params, ours = _params(cfg_j, seed=3)
    bj, bt = _vlm_batch(cfg_j, 1, seed=4)
    got = lm.forward(ours, cfg_t, bt)
    assert got.shape == (1, 256 + TEXT, cfg_t.d_model)
    want = rlm.forward(params, cfg_j, bj)
    assert _rel(got, want) <= TOL
    logits = make_prefill_step(cfg_t)(ours, bt)
    assert logits.shape == (1, 1, cfg_t.vocab_size)
    assert _rel(logits, rts.make_prefill_step(cfg_j)(params, bj)) <= TOL


def test_vlm_loss_scores_the_text_positions_only_and_matches_jax():
    """``loss_fn`` with patches: the JAX package's loss, and the mean
    cross-entropy of the head on the text positions' hidden states
    against the labels (the patch positions have none)."""
    cfg_j, cfg_t = _vlm_cfgs()
    params, ours = _params(cfg_j, seed=5)
    bj, bt = _vlm_batch(cfg_j, 2, seed=6, labels=True)
    got = lm.loss_fn(ours, cfg_t, bt)
    assert _rel(got, rlm.loss_fn(params, cfg_j, bj)) <= TOL
    hidden = lm.forward(ours, cfg_t, bt)[:, cfg_t.num_patches:]
    logits = (hidden @ lm.lm_head_weight(ours, cfg_t)).double()
    text = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg_t.vocab_size), bt["labels"].reshape(-1).long())
    assert _rel(got, text) <= TOL


def test_vlm_train_step_with_256_patches_matches_jax():
    """One float32 train step on 1 x (256 patches + 1024 tokens) from the
    synthetic batch (patches included, byte for byte in both packages):
    the loss, the gradient norm and the learning rate within 1e-4, every
    param after the step within 1e-4 by relative L2, the first moments
    within 1e-4."""
    cfg_j, cfg_t = _vlm_cfgs()
    pj, pt = _params(cfg_j, seed=7)
    sj = ropt.init_opt_state(pj)
    st = convert.opt_state_from_numpy(jax.tree.map(np.asarray, sj),
                                      device="cpu")
    batch = rdata.synthetic_batch(cfg_j, rdata.DataConfig(
        seq_len=TEXT, global_batch=1, seed=8), 0)
    assert batch["patches"].shape == (1, 256, cfg_j.d_model)
    ours = tdata.synthetic_batch(cfg_t, tdata.DataConfig(TEXT, 1, seed=8), 0)
    for key, value in batch.items():
        np.testing.assert_array_equal(ours[key], value)
    oc = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    pj, sj, mj = jax.jit(rts.make_train_step(cfg_j, ropt.OptimizerConfig(
        **oc)))(pj, sj, {k: jnp.asarray(v) for k, v in batch.items()})
    pt, st, mt = tts.make_train_step(cfg_t, topt.OptimizerConfig(**oc))(
        pt, st, tdata.to_device(ours, "cpu"))
    for key in ("loss", "grad_norm", "lr"):
        assert _rel(mt[key], mj[key]) <= TOL, key
    for path, want in jax.tree_util.tree_flatten_with_path(pj)[0]:
        assert _rel2(_leaf(pt, path), want) <= TOL, path
    for path, want in jax.tree_util.tree_flatten_with_path(sj["m"])[0]:
        assert _rel(_leaf(st["m"], path), want) <= TOL, path


def test_flash_rows_check_holds_the_rows_over_patches_and_text(monkeypatch):
    """The prefill cells' float32 check on CPU tensors at smoke width: the
    first attention layer attends over 256 + 1024 positions, its slices
    start at the first, a middle and the last 128 of them, and the rows
    the check's plain version gives equal the first layer's attention as
    the forward computes it."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops
    _, cfg_t = _vlm_cfgs(num_layers=1)
    monkeypatch.setattr(configs, "get_config", lambda arch: cfg_t)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real = ops.flash_attention

    def counted(*args, **kw):
        # the card's wrapper counts its launches; the plain version not
        fa.LAUNCHES["flash_attention"] += 1
        return real(*args, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    monkeypatch.setitem(fa.LAUNCHES, "flash_attention",
                        fa.LAUNCHES["flash_attention"])
    monkeypatch.setattr(chip_smoke, "FLASH_SLICE_ROWS", 128)
    t = dict(rows="flash", layers=1, batch=1, seed=9)
    with ThreadPoolExecutor(max_workers=1) as pool:
        out = chip_smoke.flash_rows_check(torch, torch.device("cpu"), VLM,
                                          TEXT, t, pool)()
    assert out["positions"] == 256 + TEXT and out["flash_launches"] == 1
    assert out["slice_starts"] == [0, 512, 256 + TEXT - 128]
    assert out["rel"] <= TOL
