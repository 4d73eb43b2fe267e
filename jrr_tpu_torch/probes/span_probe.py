"""The span recorder (`utils.profiling.span`) on the card:

    python -m jrr_tpu_torch.probes.span_probe

- `clock`: spans each around one `torch.cuda._sleep` kernel and a
  synchronize, under a profiler session with CUDA activity only (as the
  benchmark's traced window records). The kernel's device interval, from
  the profiler's trace, must lie inside its span's host interval; the
  record gives the least margins on either side (kernel start less span
  start, span end less kernel end) and the span's `device_ms` beside the
  kernel's duration.
- `cost`: host µs per span, empty, with a profiler session open (the
  `record_function` range, two clock reads and two CUDA events) and with
  none (the shared no-op), and µs per span to read the device times back
  (`spans()`, after the window).
"""

from __future__ import annotations

import time

import torch

from jrr_tpu_torch import probes
from jrr_tpu_torch.utils import profiling

SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's 1.98 GHz
SLEEPS = 5
EMPTY_SPANS = 20_000


def _session():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def clock() -> dict:
    """Each `_sleep` kernel inside its span, on the profiler's clock."""
    torch.cuda._sleep(1000)  # the kernel's first launch, outside the session
    torch.cuda.synchronize()
    before = len(profiling.spans())
    with _session() as prof:
        for _ in range(SLEEPS):
            with profiling.span("probe.sleep"):
                torch.cuda._sleep(SLEEP_CYCLES)
                torch.cuda.synchronize()
    spans = profiling.spans()[before:]
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    kernels = sorted((e for e in device if "spin_kernel" in e.name()), key=lambda e: e.start_ns())
    if len(kernels) != SLEEPS or len(spans) != SLEEPS:
        raise AssertionError(f"{len(kernels)} sleep kernels and {len(spans)} spans, want "
                             f"{SLEEPS} each; device operations {sorted({e.name() for e in device})}")
    before_ns = [e.start_ns() - s.start_ns for s, e in zip(spans, kernels)]
    after_ns = [s.end_ns - e.end_ns() for s, e in zip(spans, kernels)]
    inside = min(before_ns) >= 0 and min(after_ns) >= 0
    return {"name": "span_clock", "kernel": kernels[0].name(), "inside": inside,
            "start_margin_us": [v / 1e3 for v in before_ns],
            "end_margin_us": [v / 1e3 for v in after_ns],
            "kernel_ms": [e.duration_ns() / 1e6 for e in kernels],
            "span_device_ms": [s.device_ms for s in spans],
            "span_host_ms": [(s.end_ns - s.start_ns) / 1e6 for s in spans]}


def _per_span_us(n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("probe.empty"):
            pass
    return 1e6 * (time.perf_counter() - t0) / n


def cost() -> dict:
    """Host µs per empty span, on and off, and per span read back."""
    off_us = _per_span_us(EMPTY_SPANS)
    with _session():
        on_us = _per_span_us(EMPTY_SPANS)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    profiling.spans()
    read_us = 1e6 * (time.perf_counter() - t0) / EMPTY_SPANS
    return {"name": "span_cost", "spans": EMPTY_SPANS, "on_us": on_us, "off_us": off_us,
            "read_us": read_us}


def measure():
    return [clock(), cost()]


if __name__ == "__main__":
    probes.run(measure)
