"""The whole outer step's model FLOPs (`roofline.outer_step_flops`, the
silhouette excluded) over the traced window, as a share (%) of the card's
67 TFLOP/s float32 peak; the card's power limit is printed beside it."""

from benchmark import roofline


def read(ctx):
    if ctx.trace.steps == 0 or ctx.trace.window_s <= 0:
        return None
    flops = roofline.outer_step_flops(ctx.config, ctx.batch) * ctx.trace.steps
    return 100.0 * flops / ctx.trace.window_s / roofline.F32_FLOP_PER_S
