"""The serving join's profiler spans (``repro_torch.spans``).

With no profiler recording, ``span`` is one shared no-op. Under
``torch.profiler`` the label join's serving entry points record four
spans that tile the call in the order the work happens: the id range
checks, the id uploads, the launch, the readback. The card test (marker
``gpu``) shows that the card's kernel and copies fall inside the spans
that issued and waited on them, on the profiler's one clock:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_spans.py
"""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.kernels.label_join import ops

STEPS = ["label_join.ids_check", "label_join.ids_upload",
         "label_join.launch", "label_join.readback"]
OUTER = "test: serve"


def _annotations(prof) -> list[tuple[str, int, int]]:
    """The host's ``record_function`` spans, in the order they started."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU and e.is_user_annotation()]
    return sorted(out, key=lambda a: a[1])


def _traced(call, activities=(ProfilerActivity.CPU,)):
    with profile(activities=list(activities)) as prof:
        with record_function(OUTER):
            out = call()
    return out, prof


def _float_call(rng, rows=40, width=12, lanes=50):
    table = ops.upload(rng.uniform(1, 50, (rows, width))
                       .astype(np.float32), "cpu")
    ss, ts = rng.integers(0, rows, lanes), rng.integers(0, rows, lanes)
    return lambda: ops.join_gathered(table, ss, ts)


def _quantized_call(rng, rows=40, width=12, lanes=50):
    sentinel = np.iinfo(np.int16).max
    codes = rng.integers(0, 1000, (rows, width)).astype(np.int16)
    codes[rng.random((rows, width)) < 0.2] = sentinel
    table = ops.upload(codes, "cpu")
    ss, ts = rng.integers(0, rows, lanes), rng.integers(0, rows, lanes)
    return lambda: ops.join_quantized_gathered(
        table, ss, ts, sentinel=int(sentinel), scale=0.5)


def test_span_is_the_shared_no_op_without_a_profiler():
    assert spans.span("a") is spans.span("b")
    with spans.span("a") as entered:
        assert entered is None


def test_the_profilers_flag_turns_on_under_the_profiler():
    assert not torch._C._autograd._profiler_enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch._C._autograd._profiler_enabled()
        assert spans.span("a") is not spans.span("a")
    assert not torch._C._autograd._profiler_enabled()
    assert spans.span("a") is spans.span("b")


@pytest.mark.parametrize("make", [_float_call, _quantized_call],
                         ids=["float32", "quantized"])
def test_serving_join_records_four_spans_in_order(make):
    call = make(np.random.default_rng(5))
    want = call()
    got, prof = _traced(call)
    np.testing.assert_array_equal(got, want)
    found = _annotations(prof)
    (outer,) = [a for a in found if a[0] == OUTER]
    steps = [a for a in found if a[0].startswith("label_join.")]
    assert [a[0] for a in steps] == STEPS
    for _, s, e in steps:
        assert outer[1] <= s <= e <= outer[2]
    for (_, _, e), (_, s, _) in zip(steps, steps[1:]):
        assert e <= s


def test_an_out_of_range_t_id_raises_before_any_upload():
    table = ops.upload(np.zeros((4, 3), dtype=np.float32), "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(IndexError):
            ops.join_gathered(table, np.array([0, 1]), np.array([1, 4]))
    names = [a[0] for a in _annotations(prof)]
    assert names == ["label_join.ids_check"]


@pytest.mark.gpu
def test_card_events_fall_inside_their_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows, width, lanes = 262_144, 448, 262_144
    gen = torch.Generator(device="cuda").manual_seed(3)
    table = torch.rand((rows, width), generator=gen, device="cuda") * 100
    rng = np.random.default_rng(3)
    ss, ts = rng.integers(0, rows, lanes), rng.integers(0, rows, lanes)
    want = ops.join_gathered(table, ss, ts)      # builds the kernel
    torch.cuda.synchronize()
    got, prof = _traced(lambda: ops.join_gathered(table, ss, ts),
                        (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    np.testing.assert_array_equal(got, want)
    step = {a[0]: a for a in _annotations(prof)}
    device = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()]
    (kern,) = [d for d in device if "gather_join_kernel" in d[0]]
    assert step["label_join.launch"][1] <= kern[1] \
        <= kern[2] <= step["label_join.readback"][2]
    htod = [d for d in device if d[0].startswith("Memcpy HtoD")]
    up = step["label_join.ids_upload"]
    assert htod
    for _, s, e in htod:
        assert up[1] <= s <= e <= up[2]
