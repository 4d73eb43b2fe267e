"""Tracing / profiling hooks (counterpart of jrr_tpu/utils/profiling.py):

- `trace(dir)`: `torch.profiler` (CPU and, with a card, CUDA activity) around
  a block; the Chrome trace lands in dir/trace.json;
- `span(name)`: a named range of the program (the outer step's phases),
  recorded only while a `torch.profiler` session is open (`trace`, or any
  other) and a shared no-op otherwise; `spans()` returns what was
  recorded: host times on the profiler's clock, the enclosing span, the
  call it belongs to and, on the card, the device time between two CUDA
  events on the current stream;
- `capture(fn, *args)`: `fn` run once and captured into a CUDA graph, the
  port's ahead-of-call step (the refinement engine and the outer-step
  program replay their closures so);
- `log_compile_time(fn, *args)`: that step's costs split as jrr_tpu splits
  a jitted callable's: `lower_s` the eager warm-up call, `compile_s` the
  capture and instantiation, `first_run_s` the first replay. The program
  (`trainer.compile_outer_step`) records the same split for each of its
  graphs once, at its capture and first replay (`capture(times=...)`,
  `timed_replay`).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from jrr_tpu_torch import kernels


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# The most spans `spans()` keeps; the oldest go first.
SPAN_CAPACITY = 50_000


class Span(NamedTuple):
    """One recorded span. `index` counts the spans opened in the process;
    `parent` is the index of the span open around it on its thread (None
    for a span opened at the top); `step` numbers the top-level spans, and
    a span inside one shares its number: the call (an outer step) it
    belongs to. `start_ns` and `end_ns` are Unix nanoseconds
    (`time.time_ns`), the clock of the profiler's events; `device_ms` is
    the time between the CUDA events recorded on the current stream at
    its open and close, None on the CPU or where a capture was open."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    step: int
    device_ms: Optional[float]


def _device_event() -> Optional["torch.cuda.Event"]:
    """A timing event recorded on the current stream; None without a card
    in use or while the stream captures (an event in a graph would time
    its replays, not this span)."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class _Record:
    """A span while it is open, and until `spans()` resolves its events."""

    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "step", "events", "device_ms")

    def __init__(self, index, name, parent, step):
        self.index, self.name, self.parent, self.step = index, name, parent, step
        self.end_ns = self.events = self.device_ms = None
        self.start_ns = time.time_ns()


class _SpanRecorder:
    """The spans of the process, in a ring of `capacity`, and each
    thread's stack of open spans."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._lock = threading.Lock()
        self._records = collections.deque(maxlen=capacity)
        self._local = threading.local()
        self._opened = 0
        self._steps = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str) -> _Record:
        stack = self._stack()
        with self._lock:
            index = self._opened
            self._opened += 1
            if stack:
                parent, step = stack[-1].index, stack[-1].step
            else:
                parent, step = None, self._steps
                self._steps += 1
            record = _Record(index, name, parent, step)
            self._records.append(record)
        stack.append(record)
        record.events = _device_event()
        return record

    def close(self, record: _Record) -> None:
        if record.events is not None:
            end = _device_event()
            record.events = None if end is None else (record.events, end)
        record.end_ns = time.time_ns()
        self._stack().pop()

    def spans(self) -> List[Span]:
        """The closed spans, oldest first; reading the device times waits
        for their events."""
        with self._lock:
            records = [r for r in self._records if r.end_ns is not None]
        out = []
        for r in records:
            if r.events is not None:
                start, end = r.events
                end.synchronize()
                r.device_ms, r.events = start.elapsed_time(end), None
            out.append(Span(r.index, r.name, r.start_ns, r.end_ns, r.parent, r.step, r.device_ms))
        return out


class _Span:
    """One open `span`: a `record_function` range and a record."""

    __slots__ = ("name", "range", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.record = _recorder.open(self.name)

    def __exit__(self, *exc) -> None:
        _recorder.close(self.record)
        self.range.__exit__(*exc)


_recorder = _SpanRecorder()
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records the block as span `name` while a
    `torch.profiler` session is open (`trace`, the benchmark's traced
    window), and that session's Chrome trace shows it as a
    `record_function` range; with no session open, a shared no-op that
    reads no clock and records no event."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def spans() -> List[Span]:
    """Every span recorded in the process and closed, oldest first (at
    most `SPAN_CAPACITY`); the buffer is kept."""
    return _recorder.spans()

class CapturedCall:
    """A CUDA graph of one call, with the kernel launches it holds
    (wrapper → count): each replay adds them to the wrappers' counts, as
    if the wrappers had launched."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", launches: Dict):
        self.graph, self.launches = graph, launches

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)


# Per device: the side stream every warm-up and capture runs on, and the
# first graph captured there, whose memory pool every later graph shares.
_side_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_pool_owners: Dict[torch.device, "torch.cuda.CUDAGraph"] = {}


def _side_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The one side stream of `dev`. cuBLAS keeps a workspace per (handle,
    stream) for the life of the process: a new stream per capture would
    add one for every stream of PyTorch's stream pool it came to, and one
    first made inside a capture would be allocated from that graph's pool
    and pin the pool after the graph is gone.
    On one stream the first warm-up makes them, outside any capture."""
    if dev not in _side_streams:
        _side_streams[dev] = torch.cuda.Stream(dev)
    return _side_streams[dev]


def _graph_pool(dev: torch.device):
    """The memory pool of `dev`'s graphs (None before the first capture): a
    graph of `capture` keeps no tensor it allocated past its capture (its
    results go into tensors allocated before it), so what it allocates is
    scratch, and graphs replayed one after another on one stream can share
    it. Each capture reuses the blocks of the graphs before it, where a
    pool per graph would hold its memory until a failed allocation
    released it. The first graph is kept to keep the pool alive."""
    owner = _pool_owners.get(dev)
    return None if owner is None else owner.pool()


def capture(fn, *args, times: Optional[Dict[str, float]] = None,
            device: Optional[torch.device] = None) -> CapturedCall:
    """Call `fn(*args)` once eagerly on the device's side stream
    (`_side_stream`), then capture the same call into a CUDA graph on that
    stream; the device is `device`, else that of the first CUDA tensor
    among `args`, else the current one.

    The eager call is a real call (its effects stay): it initializes what
    capture cannot (cuBLAS workspaces, autograd's state, the kernel
    library). The capture executes nothing, and the wrappers' counts of the
    launches it records are taken off again (`kernels.captured_launches`).
    `fn` must keep no tensor it allocates (the graphs share one pool,
    `_graph_pool`), and the graphs must replay on one stream.
    The capture is `torch.cuda.graph`'s without its synchronize, garbage
    collection and cache release, which the engine's captures in the
    middle of a call do not need (the collector is off during the capture
    instead); it runs in thread-local mode, so the
    product loop's prefetch and writer threads may copy meanwhile. A failed
    capture raises. With `times`, the device is synchronized after each
    phase and `lower_s`, `compile_s` are recorded."""
    tensors = [a for a in args if torch.is_tensor(a)]
    dev = device if device is not None else (
        tensors[0].device if tensors else torch.device("cuda", torch.cuda.current_device()))
    current = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    t0 = time.perf_counter()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn(*args)
    current.wait_stream(side)
    if times is not None:
        torch.cuda.synchronize(dev)
        times["lower_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(current)
    # The garbage collector stays off during the capture: a graph it
    # destroyed there (one held in an unreachable cycle) would invalidate
    # the capture.
    collecting = gc.isenabled()
    gc.disable()
    try:
        with kernels.captured_launches() as launches, torch.cuda.stream(side):
            graph.capture_begin(pool=_graph_pool(dev), capture_error_mode="thread_local")
            try:
                fn(*args)
            finally:
                graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    _pool_owners.setdefault(dev, graph)
    current.wait_stream(side)
    if times is not None:
        torch.cuda.synchronize(dev)
        times["compile_s"] = time.perf_counter() - t0
    return CapturedCall(graph, launches)


def timed_replay(call: CapturedCall, device: torch.device, times: Dict[str, float]) -> None:
    """Replay `call` between two synchronizations of `device`, and record
    its seconds as `times["first_run_s"]`."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    call.replay()
    torch.cuda.synchronize(device)
    times["first_run_s"] = time.perf_counter() - t0


def log_compile_time(fn, *args) -> Dict[str, float]:
    """Split the ahead-of-call costs of `fn(*args)` on CUDA tensors:
    `lower_s` (the eager warm-up call on a side stream), `compile_s`
    (capture and instantiation of its CUDA graph) and `first_run_s` (the
    first replay, synchronized). `fn` runs twice (the warm-up and the
    replay), so a step function advances its state twice. CPU tensors
    raise ValueError: nothing is compiled there."""
    devices = {a.device for a in args if torch.is_tensor(a)}
    if not devices or any(d.type != "cuda" for d in devices):
        raise ValueError(f"log_compile_time needs CUDA tensors, got devices {sorted(map(str, devices))}")
    times: Dict[str, float] = {}
    timed_replay(capture(fn, *args, times=times), next(iter(devices)), times)
    return times
