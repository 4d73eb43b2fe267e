"""The traced window's share (%) in which no operation ran on the device:
one less the union of the device operations' intervals over the window."""

from benchmark import trace


def read(ctx):
    if not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_ns(ctx.trace.ops) / 1e9 / ctx.trace.window_s)
