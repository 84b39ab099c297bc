"""step_device_ms: the device's ms of one GN step as it runs inside the
graph's replays: the median of the replayed ``gn.step`` device spans
(stamps around the chunk body under its IF node, solver/device_loop) of
the program's trace over the traced run's sub-window (progtrace.py).
Moves obs_per_s."""

import progtrace


def read(ctx):
    r = progtrace.reading(ctx)
    return None if r is None else r["step_device_ms"]
