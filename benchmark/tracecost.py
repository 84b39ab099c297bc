"""What the program's trace (the port's utils/observe.trace) costs when it is
on, on the card: one set-up of a cell, then adjustments in turns with the
trace off and on (off, on, on, off, ...), each from the next initial
approximations of the seed, no profiler.

    python3 benchmark/tracecost.py --workload W --seed N [--pairs K]

Prints one JSON line: for each side the replay wall a step
(device_loop.loop_counts' loop_s / steps) and capture_s of every
adjustment (on the traced side with its adjust and loop.replays spans and
its replayed gn.step spans summed), their medians, and the on side's over the off side's; the
stamp kernel's launches during the untraced adjustments (0: nothing
launches with the trace off) and in all; the calibration's round trips
and the timer's steps.  Exits with 2 without a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for _p in (str(HERE), str(HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

import blockgen  # noqa: E402
import harness  # noqa: E402
import timing  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=4, help="off/on pairs of adjustments")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop
    from fish_eye_bundle_adjustment_tpu_torch.utils import observe

    cell = harness.Cell.load(HERE.parent, args.workload)
    st = harness.setup(cell, args.seed, T_START)
    sigmas = cell.traffic["init_sigmas"]
    sides = {False: [], True: []}
    stamps_untraced = 0  # stamp launches during the untraced adjustments
    rounds = []
    order = [i % 4 in (1, 2) for i in range(2 * args.pairs)]
    for i, traced in enumerate(order):
        init = blockgen.initial(st.block, args.seed, i + 1, sigmas)
        before = observe.stamp_launches["stamp"]
        spans = {}
        if traced:
            with observe.trace(st.device) as tr:
                ans = st.prep.adjust(init)
            rounds.append([c.round_trip_ns / 1e3 for cs in tr.calibrations.values() for c in cs])
            (adj,), (rep,) = tr.named(observe.ADJUST), tr.named("loop.replays")
            spans = dict(adjust_s=adj.seconds, replays_s=rep.seconds,
                         steps_s=sum(s.seconds for s in tr.named("gn.step", "replay")))
        else:
            ans = st.prep.adjust(init)
            stamps_untraced += observe.stamp_launches["stamp"] - before
        lc = device_loop.loop_counts
        sides[traced].append(dict(per_step_ms=1e3 * lc["loop_s"] / max(lc["steps"], 1),
                                  capture_s=lc["capture_s"], steps=lc["steps"],
                                  iterations=ans.iterations, **spans))

    def med(side, key):
        return statistics.median(r[key] for r in sides[side])

    out = dict(workload=args.workload, seed=args.seed, card=timing.card(),
               off=sides[False], on=sides[True],
               per_step_ms=dict(off=med(False, "per_step_ms"), on=med(True, "per_step_ms")),
               capture_s=dict(off=med(False, "capture_s"), on=med(True, "capture_s")),
               stamp_launches=dict(untraced=stamps_untraced,
                                   all=observe.stamp_launches["stamp"]),
               calibration_round_trips_us=rounds,
               timer_ticks_ns=sorted(observe.timer_ticks_ns(st.device, 256))[::32])
    out["per_step_ratio"] = out["per_step_ms"]["on"] / out["per_step_ms"]["off"]
    out["capture_ratio"] = out["capture_s"]["on"] / out["capture_s"]["off"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
