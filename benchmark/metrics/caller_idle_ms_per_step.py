"""Idle device milliseconds per outer step while no outer step was open:
the closed loop's own host work between steps (`program.Program.step`)."""

from benchmark import spans


def read(ctx):
    idle = spans.idle_ms_per_step(ctx)
    return None if idle is None else idle["caller"]
