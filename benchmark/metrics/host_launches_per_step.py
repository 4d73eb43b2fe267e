"""Host launches per outer step: the CUDA runtime's kernel and graph launch
calls in the traced window (a graph replay counts one), over its steps."""

from benchmark import trace


def read(ctx):
    if ctx.trace.steps == 0:
        return None
    return sum(ctx.trace.calls.get(name, 0) for name in trace.LAUNCH_CALLS) / ctx.trace.steps
