"""Tracing / profiling hooks (counterpart of jrr_tpu/utils/profiling.py):

- `trace(dir)`: `torch.profiler` (CPU and, with a card, CUDA activity) around
  a block; the Chrome trace lands in dir/trace.json;
- `annotate(name)`: `torch.profiler.record_function`, a named range inside a
  step;
- `StepTimer`: wall-clock rates; each tick synchronizes the card first, so
  the clock reads after the step's device work.

jrr_tpu's `log_compile_time` has no counterpart: nothing here is compiled
ahead of a call.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


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
