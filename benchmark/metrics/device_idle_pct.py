"""device_idle_pct: the share of the traced run's sub-window (progtrace.py)
in which the device ran nothing, in %: 100 (1 - the union of the
profiler's device intervals and the replayed ``gn.step`` device spans,
over the sub-window).  The steps' spans hold the kernels of the graph's IF
bodies, which the profiler does not see.  Moves adjust_s."""

import progtrace


def read(ctx):
    r = progtrace.reading(ctx)
    return None if r is None else r["device_idle_pct"]
