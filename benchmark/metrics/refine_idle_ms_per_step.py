"""Idle device milliseconds per outer step while the host was inside the
refinement (a `refine` span): the card waiting on the host's replays."""

from benchmark import spans


def read(ctx):
    idle = spans.idle_ms_per_step(ctx)
    return None if idle is None else idle["refine"]
