"""cg_iters_per_adjust: the inner PCG's iterations summed over an
adjustment's steps (solver/schur._pcg under device_cg), on average over
the window.  Moves adjust_s."""

import statistics


def read(ctx):
    a = ctx.answers
    return statistics.fmean(sum(x.cg_iterations) for x in a) if a else None
