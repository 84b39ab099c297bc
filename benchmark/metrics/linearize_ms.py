"""linearize_ms: device ms of one linearization (SchurKernel.linearize:
the Jacobians of models/projection, and on the fused path the fold, K1
and the damped Hpp^-1), at the last answer of the window, by CUDA events
after the window.  Moves obs_per_s."""

import timing


def read(ctx):
    if not ctx.on_card or not ctx.answers:
        return None
    return timing.cuda_ms(ctx.prep.linearize_call(ctx.answers[-1].x), reps=10, warmup=2)
