"""adjust_overhead_s: the seconds an adjustment spends outside its replays
(the device loop's set-up, warm-up, capture and teardown): the mean over
the traced run's sub-window (progtrace.py) of each ``adjust`` span less
its ``loop.replays`` span.  Moves adjust_s."""

import progtrace


def read(ctx):
    r = progtrace.reading(ctx)
    return None if r is None else r["adjust_overhead_s"]
