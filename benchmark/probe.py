"""The benchmark's checks on the card that its runs do not make: the
readings its limits are set from, and that its window may be trusted.

    python3 benchmark/probe.py readings --workload W --seeds 1,2,3 --seconds S
                                        [--control | --fault unchanged|half|altered]
    python3 benchmark/probe.py repeat --workload W --seed N

``readings``: one set-up, then for each seed a window of S seconds and the
judgement of its sampled answers, one JSON line a seed with every number
compared; with --control the program runs its own path one precision
below the stated one (the traffic mix's ``control`` options), which has
to come out not correct; with --fault, the fault of faults.py planted
underneath, whose readings set the upper ends of the numbers the control
does not fail.  ``repeat``: three adjustments, the first and
the last from the same initial approximations with another between them,
must return the same bits: no adjustment changes what the next one reads.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for _p in (str(HERE), str(HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

import blockgen  # noqa: E402
import faults  # noqa: E402
import harness  # noqa: E402
import run as run_mod  # noqa: E402
import timing  # noqa: E402


def readings(args, cell):
    overrides = cell.traffic["control"] if args.control else None
    seeds = [int(s) for s in args.seeds.split(",")]
    with faults.planted(args.fault):
        st = harness.setup(cell, seeds[0], T_START, "cuda", overrides)
    harness.log(f"# set-up {st.setup_s:.3f} s {st.stages}")
    for seed in seeds:
        with faults.planted(args.fault):
            win = harness.window(st, seed, args.seconds, False)
        e2e = harness.end_to_end(st, win)
        correct, checks = harness.judge(cell, st.block, harness.to_judge(st, win, seed),
                                        win.failed, "cuda", win.unconverged)
        print(json.dumps(dict(workload=cell.name, control=bool(args.control),
                              fault=args.fault, seed=seed,
                              correct=correct, adjustments=len(win.records),
                              iterations=[a.iterations for a in win.answers],
                              stopped_on=[a.stopped_on for a in win.answers],
                              metrics={k: v["value"] for k, v in e2e.items()},
                              checks=checks)), flush=True)


def repeat(args, cell):
    st = harness.setup(cell, args.seed, T_START, "cuda")
    sig = cell.traffic["init_sigmas"]
    first = st.prep.adjust(blockgen.initial(st.block, args.seed, 1, sig))
    other = st.prep.adjust(blockgen.initial(st.block, args.seed, 2, sig))
    again = st.prep.adjust(blockgen.initial(st.block, args.seed, 1, sig))
    same = (torch.equal(first.x, again.x) and torch.equal(first.stats, again.stats)
            and first.cg_iterations == again.cg_iterations)
    print(json.dumps(dict(workload=cell.name, repeat_bitwise=bool(same),
                          differs_from_other=not torch.equal(first.x, other.x),
                          iterations=[first.iterations, other.iterations, again.iterations],
                          max_abs_diff=float((first.x.double() - again.x.double()).abs().max()))),
          flush=True)
    if not same:
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("readings", "repeat"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=faults.NAMES, default=None)
    args = ap.parse_args(argv)
    run_mod._caches()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    harness.log(f"# card: {timing.card()}")
    cell = harness.Cell.load(HERE.parent, args.workload)
    if args.what == "readings":
        readings(args, cell)
        return 0
    return repeat(args, cell)


if __name__ == "__main__":
    sys.exit(main())
