"""``cross``: cross-district pairs, each checked by ``reference.cross_join``
over the distances from every border vertex (every path between two
districts passes one). The ``bf16`` control joins those rows in
bfloat16."""
from __future__ import annotations

import torch

from .. import reference
from ..network import RoadNetwork


def judge(net: RoadNetwork, checks: list, device: torch.device,
          control: str | None) -> dict:
    """Check every kept answer against the reference."""
    checked = wrong = 0
    gap = 0.0
    border = reference.border_distances(net, device) if checks else None
    for ss, ts, got in checks:
        want = reference.cross_join(border, ss, ts)
        if control == "bf16":
            got = reference.cross_join(border, ss, ts, dtype=torch.bfloat16)
        res = reference.compare(got, want)
        checked += res["checked"]
        wrong += res["wrong"]
        gap = max(gap, res["max_gap"])
    return {"checked": checked, "wrong_answers": wrong, "max_gap": gap}
