"""capture_s: the device loop's warm-up body and CUDA-graph capture an
adjustment pays (solver/device_loop.loop_counts["capture_s"]), on
average over the window.  Nothing is captured on the CPU.  Moves
adjust_s."""

import statistics


def read(ctx):
    a = ctx.answers
    if not ctx.on_card or not a:
        return None
    return statistics.fmean(x.capture_s for x in a)
