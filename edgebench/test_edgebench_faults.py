"""A run with the timed path broken underneath comes out not correct, for
each fault the cell can have: half of a batch left unanswered, an answer
altered where the join produces it. (The cell keeps no state that a step
could leave unchanged, and spans no chips, so it has no exchange between
chips to leave out.) On the CPU at a tiny size; the harness's look for a
card is the only part of a run skipped."""
import numpy as np
import pytest

from edgebench.test_edgebench_harness import CELLS, run_tiny


def _break_joins(monkeypatch, fault: str) -> None:
    """Break the answers where the center's label join produces them."""
    from repro_torch.kernels.label_join import ops

    gathered = ops.join_gathered

    def join_gathered(*args, **kwargs):
        out = np.array(gathered(*args, **kwargs))
        if fault == "half_left_out":
            out[1::2] = np.inf          # every other lane unanswered
        else:
            out[0] += 1
        return out

    monkeypatch.setattr(ops, "join_gathered", join_gathered)


@pytest.mark.parametrize("seed", [5, 2**31 + 17])
@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_join_is_not_correct(monkeypatch, cell, fault, seed):
    _break_joins(monkeypatch, fault)
    out = run_tiny(cell, seed=seed)
    assert not out["correct"]
    assert out["compared"]["wrong_answers"]["value"] > 0
