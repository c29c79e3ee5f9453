"""The harness on the card at small sizes (marker ``gpu``; skipped without
a CUDA device). On the chip:

    PYTHONPATH=src python -m pytest -m gpu edgebench/test_edgebench_gpu.py
"""
import time

import pytest
import torch

from edgebench import harness
from edgebench.test_edgebench_harness import CELLS, MANIFEST, tiny

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _run(card, cell, trace=False, control=None, seed=5):
    cfg, mix = tiny(cell, grid=(1, 4), district=(40, 4))
    return harness.run_cell(MANIFEST, cell, seed, 1.0, trace, card,
                            time.perf_counter_ns(), control=control,
                            config=cfg, traffic=mix)


@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_on_the_card(card, cell):
    out = _run(card, cell)
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_traced(card, cell):
    out = _run(card, cell, trace=True)
    assert out["correct"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    names = {m["name"] for m in harness.metric_entries(MANIFEST, cell,
                                                       True)}
    assert set(out["metrics"]) <= names and out["metrics"]
    assert out["breakdown"]["device_ops"]


@pytest.mark.parametrize("seed", [7, 8, 9])
@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_on_the_card(card, cell, seed):
    out = _run(card, cell, control="bf16", seed=seed)
    assert not out["correct"]
