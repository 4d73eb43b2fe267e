"""Device milliseconds per outer step in stage B: the `refine.stage_b`
spans' device time (the five-term step graphs' replays and their rebins),
over the window's steps."""

from benchmark import spans


def read(ctx):
    return spans.stage_ms_per_step(ctx, "refine.stage_b")
