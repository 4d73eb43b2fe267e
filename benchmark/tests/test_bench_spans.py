"""The span metrics (`spans.py` and its five readers) on a made-up window:
device operations and the port's spans placed by hand, in milliseconds.

Operations busy over [0, 30), [50, 60), [100, 120), [130, 140): idle gaps
[30, 50), [60, 100), [120, 130). Step 0's `outer.step` spans [5, 80] with
`refine` [20, 55]; step 1's spans [90, 140] with `refine` [95, 125] over a
coarse and a fine phase. So [30, 50) is the refinement's (20); [60, 100)
straddles step 0's end, the caller's stretch and step 1's start and
splits into 20 tail, 10 caller, 5 tail, 5 refine; [120, 130) into 5
refine and 5 tail: 30 refine, 30 tail, 10 caller over 2 steps.
"""

from collections import Counter

import pytest

from benchmark import harness, spans as spans_lib, trace as trace_lib
from jrr_tpu_torch.utils.profiling import Span

MS = 1_000_000
BUSY = [(0, 10), (10, 30), (50, 60), (100, 120), (130, 140)]
# (name, start, end, parent, step, device_ms), times in ms.
WINDOW = [
    ("outer.step", 5, 80, None, 3, 70.0),
    ("refine", 20, 55, 0, 3, 30.0),
    ("refine.stage_a", 22, 35, 1, 3, 1.5),
    ("refine.stage_b", 36, 54, 1, 3, 2.0),
    ("outer.step", 90, 140, None, 4, 45.0),
    ("refine", 95, 125, 4, 4, 28.0),
    ("refine.coarse", 96, 110, 5, 4, 13.0),
    ("refine.stage_a", 96, 100, 6, 4, 0.5),
    ("refine.stage_b", 100, 110, 6, 4, 1.0),
    ("refine.fine", 110, 124, 5, 4, 13.0),
    ("refine.stage_a", 110, 110, 9, 4, 0.0),
    ("refine.stage_b", 110, 124, 9, 4, 3.0),
]
# A step of an earlier profiler session: before the window's first operation.
EARLIER = [("outer.step", -60, -40, None, 2, 20.0), ("refine", -55, -45, 12, 2, 10.0),
           ("refine.stage_a", -54, -50, 13, 2, 100.0)]
READERS = ("stage_a_ms_per_step", "stage_b_ms_per_step", "refine_idle_ms_per_step",
           "step_tail_idle_ms_per_step", "caller_idle_ms_per_step")


def _spans(rows, first_index=0):
    return [Span(first_index + i, name, start * MS, end * MS, parent, step, device_ms)
            for i, (name, start, end, parent, step, device_ms) in enumerate(rows)]


def _ctx(steps=2, ops=BUSY):
    ops = [("k", a * MS, (b - a) * MS) for a, b in ops]
    return harness.Context(trace_lib.Trace(ops, Counter(), 0.15, steps), {}, 4, [0, 1][:steps])


@pytest.fixture
def recorded(monkeypatch):
    def use(spans):
        monkeypatch.setattr(spans_lib, "recorded", lambda: spans)

    use(_spans(EARLIER, 12) + _spans(WINDOW))
    return use


def _read(ctx):
    return {name: harness.metric_reader(name)(ctx) for name in READERS}


def test_idle_split_partitions_the_gaps_at_span_edges(recorded):
    ctx = _ctx()
    got = _read(ctx)
    assert got["refine_idle_ms_per_step"] == 15.0
    assert got["step_tail_idle_ms_per_step"] == 15.0
    assert got["caller_idle_ms_per_step"] == 5.0
    total = sum(b - a for a, b in spans_lib.gaps(ctx.trace.ops))
    assert total == 70 * MS == 140 * MS - trace_lib.busy_ns(ctx.trace.ops)
    assert sum(spans_lib.idle_ms_per_step(ctx).values()) * ctx.trace.steps == total / MS


def test_stage_metrics_sum_device_ms_per_step_over_both_phases(recorded):
    got = _read(_ctx())
    assert got["stage_a_ms_per_step"] == (1.5 + 0.5 + 0.0) / 2
    assert got["stage_b_ms_per_step"] == (2.0 + 1.0 + 3.0) / 2


def test_every_reader_returns_none_without_spans(recorded):
    for spans in (None, [], _spans(EARLIER, 12)):
        recorded(spans)
        assert _read(_ctx()) == dict.fromkeys(READERS)
    recorded(_spans(WINDOW))
    assert _read(_ctx(ops=[])) == dict.fromkeys(READERS)
    # Spans without device time (the CPU): no stage time, the idle split stands.
    recorded([s._replace(device_ms=None) for s in _spans(WINDOW)])
    got = _read(_ctx())
    assert got["stage_a_ms_per_step"] is None and got["stage_b_ms_per_step"] is None
    assert got["refine_idle_ms_per_step"] == 15.0


def test_outer_steps_must_match_the_window(recorded):
    with pytest.raises(ValueError, match="2 outer.step spans in a window of 3 steps"):
        _read(_ctx(steps=3))
