"""Tracing / profiling hooks (counterpart of jrr_tpu/utils/profiling.py):

- `trace(dir)`: `torch.profiler` (CPU and, with a card, CUDA activity) around
  a block; the Chrome trace lands in dir/trace.json;
- `annotate(name)`: `torch.profiler.record_function`, a named range inside a
  step;
- `StepTimer`: wall-clock rates; each tick synchronizes the card first, so
  the clock reads after the step's device work;
- `capture(fn, *args)`: `fn` run once and captured into a CUDA graph, the
  port's ahead-of-call step (the refinement engine replays its steps so);
- `log_compile_time(fn, *args)`: that step's costs split as jrr_tpu splits
  a jitted callable's: `lower_s` the eager warm-up call, `compile_s` the
  capture and instantiation, `first_run_s` the first replay.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

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


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Throughput with device fencing.

    >>> timer = StepTimer(frames_per_step=256)
    >>> for _ in range(n):
    ...     out = step(...)
    ...     timer.tick()
    >>> timer.rates()  # {'steps_per_sec': ..., 'frames_per_sec': ..., 'seconds_per_step': ...}
    """

    def __init__(self, frames_per_step: int = 1, warmup: int = 1):
        self.frames_per_step = frames_per_step
        self.warmup = warmup
        self._count = 0
        self._t0: Optional[float] = None

    def tick(self) -> None:
        _sync()
        self._count += 1
        if self._count == self.warmup:
            self._t0 = time.perf_counter()

    def rates(self) -> Dict[str, float]:
        timed = self._count - self.warmup
        if self._t0 is None or timed <= 0:
            return {"steps_per_sec": 0.0, "frames_per_sec": 0.0}
        dt = time.perf_counter() - self._t0
        return {
            "steps_per_sec": timed / dt,
            "frames_per_sec": timed * self.frames_per_step / dt,
            "seconds_per_step": dt / timed,
        }


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


def capture(fn, *args, times: Optional[Dict[str, float]] = None) -> CapturedCall:
    """Call `fn(*args)` once eagerly on the device's side stream
    (`_side_stream`), then capture the same call into a CUDA graph on that
    stream; the device is that of the first CUDA tensor among `args`.

    The eager call is a real call (its effects stay): it initializes what
    capture cannot (cuBLAS workspaces, autograd's state, the kernel
    library). The capture executes nothing, and the wrappers' counts of the
    launches it records are taken off again (`kernels.captured_launches`).
    `fn` must keep no tensor it allocates (the graphs share one pool,
    `_graph_pool`), and the graphs must replay on one stream.
    The capture is `torch.cuda.graph`'s without its synchronize, garbage
    collection and cache release, which the engine's captures in the
    middle of a call do not need; it runs in thread-local mode, so the
    product loop's prefetch and writer threads may copy meanwhile. A failed
    capture raises. With `times`, the device is synchronized after each
    phase and `lower_s`, `compile_s` are recorded."""
    tensors = [a for a in args if torch.is_tensor(a)]
    dev = tensors[0].device if tensors else torch.device("cuda", torch.cuda.current_device())
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
    with kernels.captured_launches() as launches, torch.cuda.stream(side):
        graph.capture_begin(pool=_graph_pool(dev), capture_error_mode="thread_local")
        try:
            fn(*args)
        finally:
            graph.capture_end()
    _pool_owners.setdefault(dev, graph)
    current.wait_stream(side)
    if times is not None:
        torch.cuda.synchronize(dev)
        times["compile_s"] = time.perf_counter() - t0
    return CapturedCall(graph, launches)


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
    call = capture(fn, *args, times=times)
    t0 = time.perf_counter()
    call.replay()
    torch.cuda.synchronize(next(iter(devices)))
    times["first_run_s"] = time.perf_counter() - t0
    return times
