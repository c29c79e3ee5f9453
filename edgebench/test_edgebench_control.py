"""The control of every cell comes out not correct: the plain reference
computed in bfloat16 put in the program's place. On the CPU, on five
seeds, at four districts of 40 × 4 vertices stacked in a column, so that
most distances pass 256, where bfloat16 no longer holds every integer."""
import pytest

from edgebench.test_edgebench_harness import CELLS, run_tiny


@pytest.mark.parametrize("seed", [7, 8, 9, 2**31 + 9, 2**32 + 1])
@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_is_not_correct(cell, seed):
    out = run_tiny(cell, seed=seed, control="bf16",
                   size={"grid": (1, 4), "district": (40, 4)})
    assert not out["correct"]
    assert out["compared"]["wrong_answers"]["value"] > 0
    assert out["compared"]["max_gap"]["value"] > 0
