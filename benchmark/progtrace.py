"""The program's own trace (the port's utils/observe.trace) over a short
sub-window that a traced run adds after its measured window, read by the
per-layer metrics step_device_ms, linearize_device_ms,
schur_matvec_device_ms, device_idle_pct and adjust_overhead_s.

The sub-window runs adjustments as the window does, from the next indices
of the run's seed (the --workload and --seed the run was given), in two
passes of adjustments back to back: the first under the program's trace
alone (SUB_SECONDS, at least MIN_ADJUSTMENTS), which gives the spans'
times (the profiler slows the replays' small kernels: 43.7 against 37.4
ms a step of selfcal_1k.f32 on an H100), the second under torch.profiler
too (PROFILED_SECONDS, at least one adjustment: a profiled pass of two
float64 adjustments at 1k ended in a segmentation fault on an H100, where
passes of one did not), which gives the device's idle share.  There the trace opens after the profiler starts and
closes before it stops, so its anchors and calibration stamps fall inside
the profile and the profiler's timeline maps onto the trace's clock.  It
runs once a run, when the first of the readers asks; each reads its
number from it.  Off the card, or where the program has no trace (a program without
observe.trace), there is nothing to read and every reader returns None.

Beside the metrics it logs on standard error, as one JSON line a pass:
each adjustment's phases, its replayed steps summed against its replays
(the idle time inside them) and the stamped steps and matvecs against the
program's counters; and in the profiled pass the profiler's busy share
alone, the kernels it saw against the program's counters, the longest
idle gaps of the device, named "<innermost program span>|<innermost host
operation>", and the stamp clock against the profiler's at the
calibration stamps.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import statistics
import sys
import time
import traceback
import types
from pathlib import Path

import torch

import blockgen
import devtrace
import harness

SUB_SECONDS = 3.0
MIN_ADJUSTMENTS = 2
PROFILED_SECONDS = 1.5
CLOCK_SLACK_NS = 1_000_000  # a calibration batch's stamps in the profile: within 1 ms of its host reads
TOP = 10
ROOT = Path(__file__).resolve().parent.parent

_last: list = [None, None]  # [the Context read, its reading]


def reading(ctx) -> dict | None:
    """The sub-window's metrics for this run's Context, measured on the first
    call; None off the card or where the program has no trace."""
    if not ctx.on_card or not ctx.answers:
        return None
    if _last[0] is not ctx:
        try:
            value = _measure(ctx)
        except Exception:  # the metrics are missing from the line; the run goes on
            harness.log("# program trace failed:\n" + traceback.format_exc(limit=8))
            value = None
        _last[:] = [ctx, value]
    return _last[1]


def _run_args():
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    return args if args.workload and args.seed is not None else None


def _covered(iv, lo, hi) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in iv)


def _innermost(intervals, t):
    inner = [iv for iv in intervals if iv[0] <= t <= iv[1]]
    return max(inner, key=lambda iv: iv[0]) if inner else None


def _measure(ctx) -> dict | None:
    from fish_eye_bundle_adjustment_tpu_torch.utils import observe

    if not hasattr(observe, "trace"):
        harness.log("# program trace: the program has none (no utils/observe.trace)")
        return None
    from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop

    args = _run_args()
    if args is None:
        harness.log("# program trace: no --workload and --seed to draw the sub-window from")
        return None
    sigmas = harness.Cell.load(ROOT, args.workload).traffic["init_sigmas"]
    prep, dev = ctx.prep, ctx.prep.device
    p = prep.problem
    view = types.SimpleNamespace(true_eop=p.eop0, true_points=p.cnt_xyz, iop0=p.iop0,
                                 tie_target_idx=p.tie_target_idx, n_img=p.n_img)
    index = [max(r.index for r in ctx.records)]

    def adjustments(least, seconds):
        """Adjustments back to back, at least `least` and for `seconds`:
        (their loop_counts, the host's ns at the first start and after the
        last, synchronized)."""
        loops = []
        t0 = time.perf_counter_ns()
        while len(loops) < least or time.perf_counter_ns() - t0 < seconds * 1e9:
            index[0] += 1
            device_loop.loop_counts.clear()  # a host-loop adjustment leaves it empty
            prep.adjust(blockgen.initial(view, args.seed, index[0], sigmas))
            loops.append(dict(device_loop.loop_counts))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return loops, t0, time.perf_counter_ns()

    # a fault inside the profiler or the CUDA driver prints where it happened
    faulthandler.enable()
    try:
        return _passes(observe, adjustments, prep, dev)
    finally:
        faulthandler.disable()


def _passes(observe, adjustments, prep, dev) -> dict:
    stamps0 = observe.stamp_launches["stamp"]
    with observe.trace(dev) as tr:
        loops, _, _ = adjustments(MIN_ADJUSTMENTS, SUB_SECONDS)
    out, notes = _spans(tr, loops)
    notes.update(stamp_launches=observe.stamp_launches["stamp"] - stamps0,
                 timer_ticks_ns=_ticks(observe, dev) if dev.type == "cuda" else None)
    harness.log("# program trace: " + json.dumps(notes))

    launches0 = prep.launch_counts()
    prof = devtrace.start()
    try:
        with observe.trace(dev) as tr:
            loops, t0, t1 = adjustments(1, PROFILED_SECONDS)
    finally:
        prof.stop()
    counted = prep.launch_counts()
    counted = {c: sum(counted[g].get(c, 0) - launches0[g].get(c, 0) for g in counted)
               for c in harness.COUNTED_KERNELS}
    idle_pct, notes = _profiled(tr, prof.events(), t0, t1, loops, dev, counted)
    harness.log("# program trace, profiled: " + json.dumps(notes))
    return dict(out, device_idle_pct=idle_pct)


def _ticks(observe, dev) -> dict:
    ticks = sorted(observe.timer_ticks_ns(dev, 256))
    return dict(min=ticks[0], median=statistics.median(ticks), max=ticks[-1])


def _matvecs_from_launches(loop: dict):
    """The CG matvecs the replays ran, from the kernels the graph's tally
    counted: K2 less the rhs and back-substitution a step (fused), or K4
    less its 6 a step, two a matvec (unfused)."""
    ran, steps = loop.get("replayed", {}), loop.get("steps", 0)
    if ran.get("fused_schur_apply"):
        return ran["fused_schur_apply"] - 2 * steps
    if ran.get("chunk_prefix"):
        return (ran["chunk_prefix"] - 6 * steps) / 2
    return None


def _per_adjustment(tr, loops: list) -> list:
    """Each adjustment's phases, replayed steps and matvecs against what the
    program counted."""
    steps = tr.named("gn.step", "replay")
    per = []
    for a, loop in zip(tr.named("adjust"), loops):
        kids = {s.name: s for s in tr.children(a)}
        rep = kids.get("loop.replays")
        step_s = sum(s.seconds for s in steps if s.adjustment == a.id)
        overhead = a.seconds - (rep.seconds if rep else 0.0)
        n_rep = sum(1 for s in tr.spans if s.phase == "replay" and s.adjustment == a.id)
        per.append(dict(
            adjust_s=a.seconds, overhead_s=overhead,
            phases_s={k: v.seconds for k, v in kids.items()},
            steps_s=step_s, idle_in_replays_s=(rep.seconds - step_s) if rep else None,
            coverage=(step_s + overhead) / a.seconds,
            gn_steps=sum(1 for s in steps if s.adjustment == a.id), steps=loop.get("steps"),
            matvecs=sum(1 for s in tr.named("schur_matvec", "replay") if s.adjustment == a.id),
            matvecs_from_launches=_matvecs_from_launches(loop),
            stamps_replayed=loop.get("replayed", {}).get("stamp"), replay_records=2 * n_rep))
    return per


def _spans(tr, loops: list) -> tuple:
    """(step_device_ms, linearize_device_ms, schur_matvec_device_ms,
    adjust_overhead_s; what they are checked against) from a trace."""
    def median_ms(name):
        xs = [s.seconds * 1e3 for s in tr.named(name, "replay")]
        return statistics.median(xs) if xs else None

    per = _per_adjustment(tr, loops)
    out = dict(step_device_ms=median_ms("gn.step"), linearize_device_ms=median_ms("linearize"),
               schur_matvec_device_ms=median_ms("schur_matvec"),
               adjust_overhead_s=statistics.fmean(p["overhead_s"] for p in per) if per else None)
    return out, dict(metrics=out, adjustments=per, overflow=tr.overflow, unpaired=tr.unpaired)


def _clock_agreement(tr, dev, stamp_starts: list) -> dict | None:
    """The stamp clock against the profiler's at the calibration stamps
    (eager, so the profiler can see them): each calibration's stamps
    paired in order with the profiler's stamp kernels within CLOCK_SLACK_NS
    of its host reads, where the profiler saw as many; the gaps in us."""
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    diffs, unseen = [], 0
    for cal in tr.calibrations.get(index, []):
        lo = cal.samples[0][1] - CLOCK_SLACK_NS
        hi = cal.samples[-1][2] + CLOCK_SLACK_NS
        seen = [k for k in stamp_starts if lo <= k <= hi]
        if len(seen) != len(cal.samples):
            unseen += len(cal.samples)
            continue
        diffs += [abs(k - tr.to_host_ns(index, g)) / 1e3 for k, (g, _, _) in zip(seen, cal.samples)]
    if not diffs:
        return dict(n=0, unseen=unseen)
    diffs.sort()
    return dict(n=len(diffs), unseen=unseen, median_us=statistics.median(diffs),
                max_us=diffs[-1],
                quartiles_us=statistics.quantiles(diffs, n=4) if len(diffs) > 1 else diffs,
                round_trips_us=[c.round_trip_ns / 1e3 for c in tr.calibrations[index]])


def _profiled(tr, events, t0: int, t1: int, loops: list, dev, counted: dict) -> tuple:
    """(device_idle_pct; what it is checked against, the idle gaps and the
    clocks' agreement) from a trace and the profiler's events over [t0, t1]
    on the host's clock; `counted` the program's launch counters' moves."""
    to_host = tr.profiler_clock(events)
    dev_iv, host_ops = [], []
    span_names = {s.name for s in tr.spans} | {"observe.anchor"}
    for e in events:
        r = e.time_range
        # the program's spans are record_function ranges, which the profiler
        # also draws on the device's timeline: annotations, not device work
        if r.end <= r.start or e.name in span_names or getattr(e, "is_user_annotation", False):
            continue
        iv = (to_host(r.start), to_host(r.end), e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_iv.append(iv)
        else:
            host_ops.append(iv)
    steps = tr.named("gn.step", "replay")
    prof_busy = devtrace._merge(dev_iv)
    busy = devtrace._merge(dev_iv + [(s.start_ns, s.end_ns, s.name) for s in steps])
    window = t1 - t0
    idle_pct = 100.0 * (1.0 - _covered(busy, t0, t1) / window)
    prof_idle_pct = 100.0 * (1.0 - _covered(prof_busy, t0, t1) / window)

    host_spans = [(s.start_ns, s.end_ns, s.name) for s in tr.spans if s.phase == "host"]
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if t0 <= a[1] and b[0] <= t1]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        sp, op = _innermost(host_spans, mid), _innermost(host_ops, mid)
        named.append([f"{sp[2] if sp else 'no span'}|"
                      f"{devtrace.short(op[2]) if op else 'no operation'}", (b - a) / 1e9])

    clock = _clock_agreement(tr, dev, sorted(s for s, _, name in dev_iv if "stamp_kernel" in name))
    seen = {c: dict(counted=n, traced=sum(1 for *_, name in dev_iv
                                          if harness.COUNTED_KERNELS[c] in name))
            for c, n in counted.items() if n}
    by_name: dict = {}
    for start, end, name in dev_iv:
        key = devtrace.short(name, 64)
        by_name[key] = by_name.get(key, 0.0) + (end - start) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    notes = dict(device_idle_pct=idle_pct, profiler_only_idle_pct=prof_idle_pct,
                 window_s=window / 1e9, device_events=len(dev_iv), device_ops=top, kernels=seen,
                 idle_gaps=named, clock=clock, adjustments=_per_adjustment(tr, loops),
                 overflow=tr.overflow, unpaired=tr.unpaired)
    return idle_pct, notes
