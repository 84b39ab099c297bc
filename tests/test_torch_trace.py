"""The port's tracing (utils/observe.py: trace, span, device_span) on the CPU,
on a small block through solve_schur's drive: the fused float32 path and
the unfused float64 one, each solved with tracing off and on.

On the CPU the device loop runs its chunk body eagerly and a device span's
stamps read the host's clock, so the tree of spans can be checked here:
one ``adjust`` span a drive call holding the loop's phases; ``gn.step``
spans (one a step the loop ran) holding ``linearize`` and the CG's
``pcg.block`` spans, which hold one ``schur_matvec`` span a matvec the CG
ran, masked iterations included.  With tracing off nothing is recorded,
the counters move as they always did and the answer is the same bits.
The card's test (stamps captured into the graph's IF bodies, the clock
against the profiler's) is tests/test_torch_trace_cuda.py.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop, schur
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
from fish_eye_bundle_adjustment_tpu_torch.utils import observe

from _torch_blocks import one_torch_thread  # noqa: F401 (autouse)

CASES = {"fused_f32": dict(dtype=np.float32, cg_maxiter=40),
         "unfused_f64": dict(explicit_s=False)}
LOOP_PHASES = ["loop.setup", "loop.replays", "loop.teardown"]  # no capture on the CPU


@dataclasses.dataclass
class Run:
    result: object
    trace: object  # observe.Trace, or None with tracing off
    stages: list
    moves: dict  # the launch and CG counters' moves (device_loop.counter_moves)
    loop: dict  # device_loop.loop_counts after the solve


@pytest.fixture(scope="module")
def runs():
    blk = make_block(n_img=12, n_pts=150, seed=13, settings_overrides={"iteration_cap": 5})
    out = {}
    for case, kw in CASES.items():
        for traced in (False, True):
            before = device_loop.snapshot_counters()
            with contextlib.ExitStack() as stack:
                stages = stack.enter_context(observe.record_stages("cpu"))
                tr = stack.enter_context(observe.trace("cpu")) if traced else None
                res = schur.solve_schur(blk.problem, schur.SchurOptions(**kw),
                                        compute_covariance=False, device="cpu")
            out[case, traced] = Run(res, tr, stages, device_loop.counter_moves(before),
                                    dict(device_loop.loop_counts))
    return out


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


@pytest.mark.parametrize("case", CASES)
def test_spans_nest(runs, case):
    """adjust holds the loop's phases in order; every gn.step lies in
    loop.replays and holds its linearize and CG blocks; every CG block holds
    its matvecs; every span carries the adjustment's id."""
    tr = runs[case, True].trace
    (adj,) = tr.named(observe.ADJUST)
    assert adj.parent is None and adj.adjustment == adj.id
    assert [s.name for s in tr.children(adj)] == LOOP_PHASES
    assert all(s.adjustment == adj.id and _inside(s, adj) for s in tr.spans)
    by_id = {s.id: s for s in tr.spans}
    (replays,) = tr.named("loop.replays")
    parents = {"gn.step": "loop.replays", "linearize": "gn.step", "pcg.block": "gn.step",
               "schur_matvec": "pcg.block"}
    for name, parent in parents.items():
        spans = tr.named(name)
        assert spans and all(s.phase == "eager" for s in spans)
        for s in spans:
            assert by_id[s.parent].name == parent and _inside(s, by_id[s.parent])
    assert all(s.parent == replays.id for s in tr.named("gn.step"))
    assert tr.overflow == tr.unpaired == 0


@pytest.mark.parametrize("case", CASES)
def test_gn_step_spans_are_the_steps_the_loop_ran(runs, case):
    run = runs[case, True]
    tr = run.trace
    warmup = {s.id for s in tr.named("loop.warmup")}
    steps = [s for s in tr.named("gn.step") if s.parent not in warmup]
    assert len(steps) == run.loop["steps"] == len(run.result.cg_iterations) > 0
    assert len(tr.named("linearize")) == len(steps)


@pytest.mark.parametrize("case", CASES)
def test_matvec_spans_are_every_matvec_the_cg_ran(runs, case):
    """One schur_matvec a CG iteration run, masked ones included: _CG_UNROLL
    a CG block, and schur.cg_matvecs of each step's CG count."""
    run = runs[case, True]
    tr = run.trace
    maxiter = schur.SchurOptions(**CASES[case]).cg_maxiter
    n_mv = len(tr.named("schur_matvec"))
    assert n_mv == schur._CG_UNROLL * len(tr.named("pcg.block"))
    assert n_mv == sum(schur.cg_matvecs(i, maxiter) for i in run.result.cg_iterations)
    assert n_mv == run.moves["cg"]["matvecs"]


@pytest.mark.parametrize("case", CASES)
def test_tracing_off_records_nothing_and_changes_nothing(runs, case):
    """Off: no span, no stamp; the counters move as with tracing on (the
    stamps are counted only where they launch a kernel, on a card), as the
    K2/K4 rule has them, and the answer is the same bits."""
    off, on = runs[case, False], runs[case, True]
    assert off.trace is None and observe._trace is None
    assert observe.span("adjust") is observe._NULL
    assert observe.device_span("gn.step", off.result.x) is observe._NULL
    assert off.moves == on.moves
    assert off.moves["stamp"] == {"stamp": 0}
    steps, mv = off.loop["steps"], off.moves["cg"]["matvecs"]
    if CASES[case].get("dtype") == np.float32:
        assert off.moves["fusedmv_plain"]["fused_schur_apply"] == 2 * steps + mv
    else:
        assert off.moves["prefix_plain"]["chunk_prefix"] == 6 * steps + 2 * mv
    assert np.array_equal(np.asarray(off.result.x), np.asarray(on.result.x))
    assert off.result.cg_iterations == on.result.cg_iterations


@pytest.mark.parametrize("traced", [False, True])
def test_record_stages_names_are_unchanged(runs, traced):
    """record_stages reads the spans' ends where a mark sat: the same
    stages in the same order, traced or not."""
    for case in CASES:
        stages = runs[case, traced].stages
        assert [s.name for s in stages] == ["layout", "obs", "loop", "finalize"]
        assert all(s.seconds >= 0 for s in stages)


def test_a_span_outside_a_trace_marks_only_its_stage():
    with observe.record_stages("cpu") as stages:
        with observe.span("loop.warmup", stage="warm-up") as sp:
            pass
        assert sp is not observe._NULL and sp.id is None
        assert observe.span("loop.warmup") is observe._NULL
    assert [s.name for s in stages] == ["warm-up"]
    assert observe.span("loop.warmup", stage="warm-up") is observe._NULL


def test_one_trace_at_a_time():
    with observe.trace("cpu"):
        with pytest.raises(RuntimeError):
            with observe.trace("cpu"):
                pass
    assert observe._trace is None


def _records(tr, events, replay=False, host=None):
    """(tag, ns) records of ("name", end) events, 10 ns apart."""
    return [(observe._tag(tr._site(name), end, replay, host), 10 * i)
            for i, (name, end) in enumerate(events)]


def test_device_records_pair_into_nested_spans():
    """A begin opens a span inside the open one, an end closes the
    innermost; a replay's top-level spans go in the given replay span, an
    eager one's in the host span it was issued in; an end that matches
    nothing and a begin never closed count as unpaired."""
    tr = observe.Trace()
    adj = tr._begin(observe.ADJUST, None)
    warm = tr._begin("loop.warmup", adj)
    reps = tr._begin("loop.replays", adj)
    tr._pair(_records(tr, [("gn.step", 0), ("linearize", 0), ("linearize", 1), ("gn.step", 1)],
                      host=warm), lambda t: t + 5, None)
    tr._pair(_records(tr, [("gn.step", 0), ("pcg.block", 0), ("schur_matvec", 0),
                           ("schur_matvec", 1), ("pcg.block", 1), ("gn.step", 1),
                           ("linearize", 1), ("gn.step", 0)], replay=True, host=7), lambda t: t,
             reps)
    by = {(s.name, s.phase): s for s in tr.spans}
    assert len(tr.spans) == 5 and tr.unpaired == 2
    assert by["gn.step", "eager"].parent == warm
    assert by["linearize", "eager"].parent == by["gn.step", "eager"].id
    assert (by["linearize", "eager"].start_ns, by["linearize", "eager"].end_ns) == (15, 25)
    assert by["gn.step", "replay"].parent == reps
    assert by["pcg.block", "replay"].parent == by["gn.step", "replay"].id
    assert by["schur_matvec", "replay"].parent == by["pcg.block", "replay"].id
    assert all(s.adjustment == adj and s.phase != "host" for s in tr.spans)


def test_device_clock_maps_between_calibrations():
    """The offset of each calibration's tightest round trip, linear between
    calibrations and the nearest one's outside them."""
    tr = observe.Trace()
    tr.calibrations[0] = [
        observe.Calibration([(1000, 5000, 5100), (1200, 5150, 5900)], 5050 - 1000, 100),
        observe.Calibration([(3000, 7100, 7300)], 7200 - 3000, 200),
    ]
    assert tr.to_host_ns(0, 1000) == 5050
    assert tr.to_host_ns(0, 2000) == 2000 + 4125
    assert tr.to_host_ns(0, 500) == 500 + 4050
    assert tr.to_host_ns(0, 4000) == 4000 + 4200
