"""gn_iters_per_adjust: the GN iterations an adjustment of the window
reported, on average (solver/device_loop's count).  Moves adjust_s."""

import statistics


def read(ctx):
    a = ctx.answers
    return statistics.fmean(x.iterations for x in a) if a else None
