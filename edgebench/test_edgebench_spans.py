"""The readers of the program's label-join spans: per-batch sums of the
spans inside the window, on hand-built traces and on a profiled chain of
the program's serving join on the CPU."""
import numpy as np
import pytest

from edgebench import harness
from edgebench.devtrace import DeviceTrace, Tracer
from edgebench.drivers import Measured

READERS = {"ids_check_ms_per_batch": "label_join.ids_check",
           "ids_upload_ms_per_batch": "label_join.ids_upload",
           "readback_ms_per_batch": "label_join.readback"}
PHASE = "program: answer_cross_many"


def _record(trace, batches):
    return harness.Record({}, {}, 0.0, Measured(window_s=1.0,
                                                attempted=batches,
                                                batches=batches),
                          trace, "cpu")


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_sums_its_spans_inside_the_window(metric):
    read = harness.load_reader(metric)
    mine, other = READERS[metric], "label_join.launch"
    ms = 1_000_000
    trace = DeviceTrace([], (10 * ms, 100 * ms), [
        (mine, 5 * ms, 9 * ms),              # before the window
        (PHASE, 10 * ms, 30 * ms),
        (mine, 11 * ms, 14 * ms),
        (other, 14 * ms, 16 * ms),
        (mine, 40 * ms, 41 * ms),
        (mine, 99 * ms, 102 * ms)])          # runs past the window
    assert read(_record(trace, 2)) == pytest.approx(2.0)
    assert read(_record(None, 2)) is None
    assert read(_record(trace, 0)) is None
    # a program that records no such span: the metric is left out
    bare = DeviceTrace([], (10 * ms, 100 * ms), [(PHASE, 10 * ms, 30 * ms)])
    assert read(_record(bare, 2)) is None


def test_readers_on_a_profiled_serving_join():
    from repro_torch.kernels.label_join import ops
    rng = np.random.default_rng(9)
    table = ops.upload(rng.uniform(1, 50, (64, 16)).astype(np.float32),
                       "cpu")
    ss, ts = rng.integers(0, 64, 500), rng.integers(0, 64, 500)
    ops.join_gathered(table, ss, ts)
    tracer = Tracer(True)
    tracer.start()
    for _ in range(3):
        with tracer.phase(PHASE):
            ops.join_gathered(table, ss, ts)
    tracer.stop()
    t = tracer.trace
    outer = [p for p in t.phases if p[0] == PHASE]
    assert len(outer) == 3
    for _, lo, hi in outer:
        inside = [p[0] for p in sorted(t.phases, key=lambda p: p[1])
                  if p[0] != PHASE and lo <= p[1] <= p[2] <= hi]
        assert inside == ["label_join.ids_check", "label_join.ids_upload",
                          "label_join.launch", "label_join.readback"]
    rec = _record(t, 3)
    for metric in READERS:
        assert harness.load_reader(metric)(rec) > 0
