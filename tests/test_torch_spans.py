"""The span recorder (`profiling.span`, `profiling.spans`) and the spans of
the outer-step program, held on the CPU:

- with no profiler session open, `span` is one shared no-op: it reads no
  clock, records nothing and makes no CUDA event, and an outer-step call
  records nothing;
- under a CPU `torch.profiler` session, two outer-step calls give two
  trees of the program's phases (`outer.step` over `outer.load`,
  `refine`, `outer.segment`, `outer.evaluate`, `outer.copy_out`; `refine`
  over `refine.stage_a` and `refine.stage_b`, or over `refine.coarse` and
  `refine.fine` under coarse-to-fine; `refine.rebin` under stage B where
  the silhouette rebins), each tree sharing its `step`;
- the profiler's own event of each span's `record_function` range holds
  the span, its edges within 1 ms of the span's by the median (the two
  clocks are one);
- the program's state, metrics and result are the same bit for bit with
  the spans recorded and without;
- the buffer keeps the newest spans and `spans()` does not clear it.
"""

import statistics
from collections import Counter

import pytest
import torch

from jrr_tpu_torch.refine import trainer
from jrr_tpu_torch.utils import profiling
from test_torch_outer_program import _assert_bits, _problem
from test_torch_spin import torch_threads

CALLS = 2
PHASES = ("outer.load", "refine", "outer.segment", "outer.evaluate", "outer.copy_out")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Torch on two threads: Tier-1 runs six test processes at once. The
    process's first `record_function` range spends up to some ms after
    its timestamp setting up; one range is opened first, so the clocks
    are compared on warm ranges."""
    with torch_threads():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with torch.profiler.record_function("warm"):
                pass
        yield


def _calls(case, record: bool):
    """CALLS outer-step calls of one program on the case's batches, each
    from the state before it, with or without a CPU profiler session: the
    outputs, the spans recorded meanwhile and the profiler's events."""
    model, pcfg, state, parts = _problem(case, batches=CALLS)
    program = trainer.compile_outer_step(pcfg)
    before = len(profiling.spans())
    outs, events = [], []
    if record:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for init, data in parts:
                state, m, res = program(state, model, init, data)
                outs.append((state, m, res))
        events = list(prof.profiler.kineto_results.events())
    else:
        for init, data in parts:
            state, m, res = program(state, model, init, data)
            outs.append((state, m, res))
    return outs, profiling.spans()[before:], events


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.index]


def test_span_off_is_a_shared_no_op(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span read a clock or made an event with no profiler open")

    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiling._recorder, "open", refuse)
    assert profiling.span("outer.step") is profiling.span("refine")
    _, recorded, _ = _calls("off", record=False)
    assert recorded == []


@pytest.mark.parametrize("case", ["off", "c2f", "silhouette"])
def test_outer_step_spans(case):
    want, _, _ = _calls(case, record=False)
    got, spans, events = _calls(case, record=True)
    _assert_bits(got, want, "recorded")

    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["outer.step"] * CALLS
    assert len({s.step for s in roots}) == CALLS
    by_index = {s.index: s for s in spans}
    for s in spans:
        root = s
        while root.parent is not None:
            root = by_index[root.parent]
        assert s.step == root.step and s.device_ms is None
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    for root in roots:
        assert _children(spans, root) == list(PHASES)
        tree = [s for s in spans if s.step == root.step]
        (refine,) = [s for s in tree if s.name == "refine"]
        phases = [s for s in tree if s.parent == refine.index]
        if case == "c2f":
            assert [s.name for s in phases] == ["refine.coarse", "refine.fine"]
        else:
            phases = [refine]
        stages = [s for p in phases for s in tree if s.parent == p.index]
        assert [s.name for s in stages] == ["refine.stage_a", "refine.stage_b"] * len(phases)
        rebins = Counter(by_index[s.parent].name for s in tree if s.name == "refine.rebin")
        if case == "off":
            assert not rebins
        else:
            assert set(rebins) == {"refine.stage_b"} and rebins["refine.stage_b"] >= 2

    # The profiler's own event of each span's range, by name and in order:
    # it opens before the span's clock reads and closes after them, so on
    # one clock it holds the span, and its edges lie within 1 ms of the
    # span's (by the median: a collection or a preemption between the two
    # reads can part a few edges by more under a loaded host).
    ranges = {}
    for e in sorted(events, key=lambda e: e.start_ns()):
        ranges.setdefault(e.name(), []).append(e)
    starts, ends = [], []
    for name in {s.name for s in spans}:
        mine = [s for s in spans if s.name == name]
        theirs = ranges.get(name, [])
        assert len(theirs) == len(mine), name
        for s, e in zip(sorted(mine, key=lambda s: s.start_ns), theirs):
            assert e.start_ns() <= s.start_ns <= s.end_ns <= e.end_ns(), name
            starts.append(s.start_ns - e.start_ns())
            ends.append(e.end_ns() - s.end_ns)
    assert statistics.median(starts) < 1_000_000 and statistics.median(ends) < 1_000_000


def test_buffer_keeps_the_newest_and_is_not_cleared(monkeypatch):
    recorder = profiling._SpanRecorder(capacity=3)
    monkeypatch.setattr(profiling, "_recorder", recorder)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for name in "abcde":
            with profiling.span(name):
                pass
    got = profiling.spans()
    assert [(s.index, s.name, s.step) for s in got] == [(2, "c", 2), (3, "d", 3), (4, "e", 4)]
    assert profiling.spans() == got
