"""How the kept answers are judged, one file each, named by the mix's
``pairs`` key: ``<pairs>.py`` defines ``judge(net, checks, device,
control)``, which works every answer of ``checks`` (``(ss, ts,
answers)`` triples) out again with the plain reference on ``device``
and returns ``{"checked", "wrong_answers", "max_gap"}``. ``control``
names a lower precision to put in the program's place (``bf16``), or is
None."""
from __future__ import annotations

from ..byfile import ByFile

JUDGES = ByFile(__name__, "judge")
