"""schur_matvec_roofline: the least time one reduced-camera-system product
takes at the chip's peaks (counts.matvec, from the problem's counts) over
the device time of SchurFactors.schur_matvec at the last answer of the
window (K2 on the fused path; gathers, products and the segment sums on
the unfused one), in %.  Moves obs_per_s."""

import counts
import timing


def read(ctx):
    if not ctx.on_card or not ctx.answers:
        return None
    ms = timing.cuda_ms(ctx.prep.matvec_call(ctx.answers[-1].x), reps=50)
    least_s, _ = counts.bound_s(*counts.matvec(ctx.sizes), ctx.sizes.dtype)
    return 100.0 * least_s / (ms / 1e3)
