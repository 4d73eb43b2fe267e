"""Reading the device trace of the window: `torch.profiler` (CUPTI) over
the window's steps, reduced to the device operations (name, start,
duration), the host's launch calls by name, and the union of the device's
busy intervals.
"""

from __future__ import annotations

import re
import time
from collections import Counter
from typing import List, NamedTuple, Tuple

import torch

# The CUDA runtime and driver calls that launch work on the card (a graph
# replay is one).
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch")
# cuBLAS and CUTLASS products: GEMMs, GEMVs and their split-K reductions.
DENSE = re.compile(r"gemm|gemv|cutlass|xmma|splitKreduce|dot_kernel", re.IGNORECASE)


class Trace(NamedTuple):
    ops: List[Tuple[str, int, int]]  # device operations: (name, start ns, duration ns)
    calls: Counter  # host runtime calls by name
    window_s: float  # host-clock length of the traced window
    steps: int


def record(run_steps) -> Trace:
    """Run `run_steps()` (which returns the steps it ran) under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = run_steps()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ops, calls = [], Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.duration_ns() > 0:
                ops.append((e.name(), e.start_ns(), e.duration_ns()))
        else:
            calls[e.name()] += 1
    ops.sort(key=lambda o: o[1])
    return Trace(ops, calls, window, steps)


def busy_ns(ops) -> int:
    """Length of the union of the operations' intervals."""
    total, end = 0, None
    for _, start, dur in ops:
        stop = start + dur
        if end is None or start > end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def idle_gaps(ops, top: int = 10):
    """The idle gaps between busy intervals, summed by the device operation
    that ended each (what the card waited on the host to launch), longest first."""
    gaps = Counter()
    end = None
    for name, start, dur in ops:
        if end is not None and start > end:
            gaps[f"before {name[:96]}"] += (start - end) / 1e9
        end = start + dur if end is None else max(end, start + dur)
    return [[k, v] for k, v in gaps.most_common(top)]


def device_ops(ops, top: int = 10):
    """Device seconds by operation name, largest first."""
    by_name = Counter()
    for name, _, dur in ops:
        by_name[name[:120]] += dur / 1e9
    return [[k, v] for k, v in by_name.most_common(top)]


def seconds_where(ops, match) -> float:
    return sum(dur for name, _, dur in ops if match(name)) / 1e9
