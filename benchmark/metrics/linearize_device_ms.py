"""linearize_device_ms: the device's ms of one linearization as it runs
inside the replays: the median of the replayed ``linearize`` device spans
(stamps around SchurKernel.linearize in solver/schur.schur_step_fn's step)
over the traced run's sub-window (progtrace.py); linearize_ms times the
same call alone, after the window.  Moves obs_per_s."""

import progtrace


def read(ctx):
    r = progtrace.reading(ctx)
    return None if r is None else r["linearize_device_ms"]
