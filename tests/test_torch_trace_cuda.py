"""The port's tracing on the card (marked gpu; skipped without one): device
stamps (ops/csrc/stamp.cu) captured into the device loop's CUDA graph.

This file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_trace_cuda.py

Whether there is a card is decided inside each test.

- Under capture the stamps run where their IF bodies run: the replayed
  spans of each name equal what the graph's tally counted the replays
  running (the steps; the CG matvecs, from the K2 or K4 launches less the
  step's own), and the stamp kernel's replayed launches equal the replayed
  records; none is lost to a full ring.
- With tracing off no stamp launches, and every other counter moves as
  with tracing on.
- The calibration stamps, which the profiler sees (they are eager), land
  where the profiler puts them, on the host's clock.
- The timer's resolution, and record_stages' names on the card.
"""

import contextlib
import statistics

import numpy as np
import pytest
import torch

from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop, schur
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
from fish_eye_bundle_adjustment_tpu_torch.utils import observe

pytestmark = pytest.mark.gpu

CASES = {"fused_f32": dict(dtype=np.float32, cg_maxiter=40),
         "unfused_f64": dict(explicit_s=False)}
PHASES = ["loop.setup", "loop.warmup", "loop.capture", "loop.replays", "loop.teardown"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamp kernel has no CPU mode")
    return torch.device("cuda")


def _solve(case, traced, stages=False):
    blk = make_block(n_img=12, n_pts=150, seed=13, settings_overrides={"iteration_cap": 6})
    before = device_loop.snapshot_counters()
    with contextlib.ExitStack() as stack:
        log = stack.enter_context(observe.record_stages("cuda")) if stages else None
        tr = stack.enter_context(observe.trace()) if traced else None
        res = schur.solve_schur(blk.problem, schur.SchurOptions(**CASES[case]),
                                compute_covariance=False, device="cuda")
    return res, tr, device_loop.counter_moves(before), dict(device_loop.loop_counts), log


@pytest.mark.parametrize("case", CASES)
def test_replayed_stamps_are_what_the_replays_ran(case):
    _card()
    res, tr, moves, lc, _ = _solve(case, True)
    assert tr.overflow == 0 and tr.unpaired == 0
    (adj,) = tr.named(observe.ADJUST)
    assert [s.name for s in tr.children(adj)] == PHASES
    steps = lc["steps"]
    rep = {name: tr.named(name, "replay")
           for name in ("gn.step", "linearize", "pcg.block", "schur_matvec")}
    assert len(rep["gn.step"]) == len(rep["linearize"]) == steps > 0
    n_mv = len(rep["schur_matvec"])
    assert n_mv == schur._CG_UNROLL * len(rep["pcg.block"]) > 0
    ran = lc["replayed"]
    if "dtype" in CASES[case]:
        assert n_mv == ran["fused_schur_apply"] - 2 * steps
    else:
        assert 2 * n_mv == ran["chunk_prefix"] - 6 * steps
    n_replayed = sum(1 for s in tr.spans if s.phase == "replay")
    assert ran["stamp"] == 2 * n_replayed
    # the warm-up body ran once, eagerly, inside loop.warmup
    (warm,) = tr.named("loop.warmup")
    assert [s.parent for s in tr.named("gn.step", "eager")] == [warm.id]
    (cap,) = tr.named("loop.capture")
    assert abs(lc["capture_s"] - (warm.seconds + cap.seconds)) < 2e-3
    # the replayed steps on the host's clock: inside loop.replays, within the
    # clock's calibration, one after another
    (replays,) = tr.named("loop.replays")
    cals = tr.calibrations[torch.cuda.current_device()]
    slack = 100_000 + max(c.round_trip_ns for c in cals)
    steps_sp = rep["gn.step"]
    assert all(replays.start_ns - slack <= s.start_ns <= s.end_ns <= replays.end_ns + slack
               for s in steps_sp)
    assert all(a.end_ns <= b.start_ns for a, b in zip(steps_sp, steps_sp[1:]))


@pytest.mark.parametrize("case", CASES)
def test_tracing_off_launches_no_stamp(case):
    _card()
    off = _solve(case, False)
    on = _solve(case, True)
    assert off[2]["stamp"] == {"stamp": 0} and on[2]["stamp"]["stamp"] > 0
    for key in off[2]:
        if key != "stamp":
            assert off[2][key] == on[2][key], key
    assert off[0].cg_iterations == on[0].cg_iterations


def test_calibration_stamps_land_where_the_profiler_puts_them():
    """The stamp kernels of the trace's calibrations (eager, so the profiler
    sees them) against the times their own %globaltimer reads map to: to
    within 20 us at the median and 100 us at the worst."""
    dev = _card()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with observe.trace() as tr:
            x = torch.ones(1 << 20, device=dev)
            for _ in range(20):
                x = x * 1.0001
            torch.cuda.synchronize()
    events = prof.events()
    to_host = tr.profiler_clock(events)
    kernels = sorted(to_host(e.time_range.start) for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "stamp_kernel" in e.name)
    index = torch.cuda.current_device()
    cals = tr.calibrations[index]
    mapped = [tr.to_host_ns(index, g) for c in cals for g, _, _ in c.samples]
    assert len(kernels) == len(mapped) > 0
    diffs = [abs(k - m) / 1e3 for k, m in zip(kernels, sorted(mapped))]
    print(f"stamp vs profiler (us): median {statistics.median(diffs):.3f} "
          f"max {max(diffs):.3f} n {len(diffs)}; round trips (us) "
          f"{[c.round_trip_ns / 1e3 for c in cals]}")
    assert statistics.median(diffs) < 20 and max(diffs) < 100


def test_timer_resolution():
    dev = _card()
    ticks = observe.timer_ticks_ns(dev, 256)
    print(f"%globaltimer steps (ns): min {min(ticks)} median {statistics.median(ticks)} "
          f"max {max(ticks)}")
    assert min(ticks) > 0 and statistics.median(ticks) <= 1000


@pytest.mark.parametrize("traced", [False, True])
def test_record_stages_on_the_card(traced):
    _card()
    *_, log = _solve("fused_f32", traced, stages=True)
    assert [s.name for s in log] == ["layout", "obs", "warm-up", "capture", "loop", "finalize"]
