"""Device milliseconds per outer step in stage A: the `refine.stage_a`
spans' device time (the camera-only step graphs' replays), over the
window's steps."""

from benchmark import spans


def read(ctx):
    return spans.stage_ms_per_step(ctx, "refine.stage_a")
