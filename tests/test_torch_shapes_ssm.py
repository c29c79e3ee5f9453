"""The card's shape cells of the SSM, hybrid and audio-encoder configs,
and the float32 train check they run, on the CPU.

``chip_smoke.py`` runs the JAX package's ``SHAPES`` cells (``SHAPE_CELLS``)
on the card; here:

* the table itself: 19 cells, each a shape that applies to its config
  (``configs/base.py`` ``shape_applicable``), named after both;
* ``attention_applications``, the flash launches a prefill cell expects:
  none for Mamba2 (no layer attends), one a shared application for the
  hybrid, one a layer for the dense configs, none where MLA attends;
* ``lm_train_tight``, the float32 card-vs-host train step, on CPU tensors:
  a leaf beyond the tolerance after the whole step is held stage by stage
  (its gradient, and AdamW fed the card's gradients), so that a leaf whose
  whole step is ill-conditioned passes when both stages agree and fails
  when either does not.

The paths these cells run are held against the JAX package in
``tests/test_torch_long_context.py`` (Mamba2's decode over a filled cache
at batch 2, Nemotron-4-340B's decode at pos 32 767 at hd 192, the train
step at 1024 tokens of Mamba2 and HuBERT-XLarge, the flash plain version
at hd 192 in row blocks). Tolerance: the check's own, 1e-4.
"""
import sys
import time
import types
from pathlib import Path

import pytest
import torch

import repro_torch.configs as configs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.train.data import to_device
from repro_torch.train.optimizer import init_opt_state

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

CELLS = {
    # PR 27
    "shape_prefill_32k_qwen3_4b", "shape_prefill_32k_zamba2_1_2b",
    "shape_decode_32k_qwen3_4b", "shape_long_500k_zamba2_1_2b",
    "shape_long_500k_mamba2_1_3b", "shape_train_4k_qwen3_4b",
    # PR 28
    "shape_prefill_32k_hubert_xlarge", "shape_decode_32k_olmoe_1b_7b",
    "shape_decode_32k_deepseek_v2_236b", "shape_train_4k_olmoe_1b_7b",
    "shape_prefill_32k_olmoe_1b_7b", "shape_prefill_32k_deepseek_v2_236b",
    # PR 29
    "shape_prefill_32k_mamba2_1_3b", "shape_decode_32k_mamba2_1_3b",
    "shape_decode_32k_zamba2_1_2b", "shape_train_4k_mamba2_1_3b",
    "shape_train_4k_zamba2_1_2b", "shape_train_4k_hubert_xlarge",
    "shape_prefill_32k_nemotron_4_340b"}


def test_shape_cells_are_the_19_cells_and_each_shape_applies():
    # the 19 cells of PRs 27-29 stay; tests/test_torch_shapes_dense.py
    # holds the whole table (29 cells) against the JAX package's SHAPES
    assert CELLS <= set(chip_smoke.SHAPE_CELLS)
    for name, spec in chip_smoke.SHAPE_CELLS.items():
        assert name == f"shape_{spec['shape']}_{spec['arch']}"
        ok, reason = shape_applicable(get_config(spec["arch"]),
                                      SHAPES[spec["shape"]])
        assert ok, (name, reason)
        if "train" in spec:
            assert spec["train"]["tokens"] == SHAPES[spec["shape"]].seq_len
            assert spec["train"]["batch"] == spec["batch"]


@pytest.mark.parametrize("arch,launches", [
    ("mamba2_1_3b", 0), ("zamba2_1_2b", 6), ("qwen3_4b", 36),
    ("hubert_xlarge", 48), ("nemotron_4_340b", 96),
    ("deepseek_v2_236b", 0)])
def test_attention_applications_is_the_prefill_flash_launches(arch,
                                                             launches):
    assert chip_smoke.attention_applications(get_config(arch)) == launches


def _host_result(tmp_path, tweak):
    """The host half of the check as the worker saves it, for Mamba2 at
    smoke width, one layer, 64 tokens; ``tweak(params, grads)`` changes
    it in place; the ``pending`` tuple ``lm_train_tight`` waits on."""
    t = dict(layers=1, batch=1, tokens=64, vocab=None)
    _, params, batch, step = chip_smoke.train_tight_inputs(
        torch, "mamba2_1_3b", t)
    with chip_smoke.step_gradients(torch) as grads:
        p, _, m = step(params, init_opt_state(params),
                       to_device(batch, "cpu"))
    tweak(p, grads[0])
    out = tmp_path / "host.pt"
    torch.save({"params": p, "metrics": m, "routing": [],
                "grads": grads[0], "seconds": 0.0, "done_at": time.time()},
               out)
    worker = types.SimpleNamespace(is_alive=lambda: False, exitcode=0)
    return t, (worker, out, 1, time.time())


def _bias(tree):
    return tree["layers"]["mixer"]["conv_bias_x"]


@pytest.mark.parametrize("what", ["stages_agree", "gradient_off",
                                  "card_step_off"])
def test_train_check_holds_a_leaf_beyond_the_tolerance_stage_by_stage(
        monkeypatch, tmp_path, what):
    """conv_bias_x after the step 1e-3 apart, card vs host: the check
    passes where the leaf's gradients agree and AdamW fed the card's
    gradients gives the card's step (the host's step was off; the leaf is
    reported under ``held_by_stage``), and fails where the host's gradient
    is also 1 % off, or where the card's own step is the one off."""
    monkeypatch.setattr(configs, "get_config", get_smoke_config)

    def tweak(p, g):
        if what != "card_step_off":
            _bias(p).mul_(1 + 1e-3)
        if what == "gradient_off":
            _bias(g).mul_(1.01)

    t, pending = _host_result(tmp_path, tweak)
    if what == "card_step_off":
        real = chip_smoke.train_tight_inputs

        def inputs(*args):
            cfg, host, batch, step = real(*args)

            def off(params, opt, b):
                p, o, m = step(params, opt, b)
                _bias(p).mul_(1 + 1e-3)
                return p, o, m
            return cfg, host, batch, off
        monkeypatch.setattr(chip_smoke, "train_tight_inputs", inputs)
    cpu = torch.device("cpu")
    if what == "stages_agree":
        out = chip_smoke.lm_train_tight(torch, cpu, "mamba2_1_3b", t, pending)
        assert out["param_rel2"]["layers/mixer/conv_bias_x"] > 1e-4
        assert set(out["held_by_stage"]) == {"layers/mixer/conv_bias_x"}
        held = out["held_by_stage"]["layers/mixer/conv_bias_x"]
        assert max(held["grad_rel2"], held["step_on_card_grads_rel2"]) \
            <= chip_smoke.LM_TRAIN_REL
    else:
        with pytest.raises(chip_smoke.SmokeFailure, match="card vs the host"):
            chip_smoke.lm_train_tight(torch, cpu, "mamba2_1_3b", t, pending)
