"""The port's spans over the traced window: device time by phase of the
outer step, and the device's idle time split by what the host was doing.

The port records its spans (`jrr_tpu_torch.utils.profiling.span`: name,
host start and end on the profiler's clock, parent, the outer step they
belong to, device milliseconds between two CUDA events) only while a
profiler session is open, so a run's spans are its traced window's. A
port that records none (no `profiling.spans`, or nothing recorded) gives
None, and so does every metric read here.

The idle split: an idle gap is a stretch between the busy intervals of
the window's device operations, from the first to the last; each of its
nanoseconds goes to the host span open at that instant on the thread
that calls the program: inside a `refine` span (the host launching the
refinement's graphs), inside an `outer.step` but outside `refine` (the
program's copies in, outer segment, evaluations and copies out), or
inside no `outer.step` (the caller's own work between steps). The three
sum to the gaps' total.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

STEP = "outer.step"
REFINE = "refine"


def recorded() -> Optional[list]:
    """Every span the port has recorded, or None where it records none."""
    from jrr_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return (read() or None) if read is not None else None


def window(ctx) -> Optional[list]:
    """The spans of the traced window's outer steps (those whose
    `outer.step` ends after the window's first device operation), or None.
    Their `outer.step` spans must be as many as the window's steps."""
    spans = recorded()
    if not spans or not ctx.trace.ops or ctx.trace.steps == 0:
        return None
    first = ctx.trace.ops[0][1]
    steps = {s.step for s in spans if s.name == STEP and s.end_ns > first}
    if not steps:
        return None
    if len(steps) != ctx.trace.steps:
        raise ValueError(f"{len(steps)} {STEP} spans in a window of {ctx.trace.steps} steps")
    return [s for s in spans if s.step in steps]


def stage_ms_per_step(ctx, name: str) -> Optional[float]:
    """The summed device milliseconds of the window's spans `name`, over
    its steps (None where a span has no device time: on the CPU)."""
    spans = window(ctx)
    if spans is None:
        return None
    times = [s.device_ms for s in spans if s.name == name]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / ctx.trace.steps


def gaps(ops) -> List[Tuple[int, int]]:
    """The idle stretches [start, end) between the union's busy intervals
    of `ops` (name, start ns, duration ns; sorted by start)."""
    out, end = [], None
    for _, start, dur in ops:
        if end is not None and start > end:
            out.append((end, start))
        end = start + dur if end is None else max(end, start + dur)
    return out


def _union(intervals) -> List[Tuple[int, int]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap_ns(stretches, intervals) -> int:
    """Nanoseconds of the sorted, disjoint `stretches` inside the union of
    `intervals`."""
    covered, total, j = _union(intervals), 0, 0
    for a, b in stretches:
        while j < len(covered) and covered[j][1] <= a:
            j += 1
        k = j
        while k < len(covered) and covered[k][0] < b:
            total += min(b, covered[k][1]) - max(a, covered[k][0])
            k += 1
    return total


def idle_ms_per_step(ctx) -> Optional[Dict[str, float]]:
    """The window's idle device time a step (ms), split by the host's span
    at each instant: `refine`, `tail` (in an outer step, outside
    `refine`) and `caller` (in no outer step)."""
    spans = window(ctx)
    if spans is None:
        return None
    idle = gaps(ctx.trace.ops)
    in_step = _overlap_ns(idle, [(s.start_ns, s.end_ns) for s in spans if s.name == STEP])
    in_refine = _overlap_ns(idle, [(s.start_ns, s.end_ns) for s in spans if s.name == REFINE])
    total = sum(b - a for a, b in idle)
    ns = {"refine": in_refine, "tail": in_step - in_refine, "caller": total - in_step}
    return {k: v / 1e6 / ctx.trace.steps for k, v in ns.items()}
