"""Idle device milliseconds per outer step while the host was inside the
outer step but outside the refinement: the program's copies in, outer
segment, evaluations and copies out."""

from benchmark import spans


def read(ctx):
    idle = spans.idle_ms_per_step(ctx)
    return None if idle is None else idle["tail"]
