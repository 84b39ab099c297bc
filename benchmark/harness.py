"""One run of one cell: set-up, the measured window, the traced layers and
the judgement of the window's answers.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the names in
BENCHMARK.json:

- ``configs/<config>.json``: the block (blockgen.from_config's sizes and
  settings), its source and what was cut;
- ``traffic/<traffic>.json``: the adjustments' mix: the solver options,
  threshold and cap, the initial approximations' sigmas, and the control
  (the program's own path one precision below the stated one);
- ``cells/<workload>.json``: how many of the window's answers the
  reference judges, and the limit of each number compared, with the
  readings each limit was set from;
- ``metrics/<metric>.py``: a reader ``read(ctx)`` of one per-layer metric,
  returning its value or None where it finds nothing to read.

The window runs adjustments back to back (a closed loop of one client):
each from fresh initial approximations drawn from the run's seed and the
adjustment's index, each one call of the port's ``drive`` over the block
prepared in set-up; it ends at the first adjustment boundary after the
window's seconds.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

import blockgen
import counts
import devtrace
import refba

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fish_eye_bundle_adjustment_tpu")
# the port's kernels whose launches the program counts, by the names the
# device trace gives them
COUNTED_KERNELS = {"fused_schur_apply": "schur_group_kernel",
                   "fused_hpp_pass": "hpp_group_kernel",
                   "chunk_prefix": "chunk_prefix_kernel"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with its files."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    cell: dict
    end_to_end: list
    per_layer: list

    @staticmethod
    def load(root: Path, workload: str) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        entries = [w for w in bench["workloads"] if w["name"] == workload]
        if not entries:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        w = entries[0]
        here = lambda sub, name: load_json(HERE / sub / f"{name}.json")
        e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
        pl = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
        return Cell(workload, w, here("configs", w["config"]), here("traffic", w["traffic"]),
                    here("cells", workload), e2e, pl)


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sizes_of(prep) -> counts.Sizes:
    """The problem's counts, from the block as the port was given it."""
    k = prep.kernel
    return counts.Sizes(n_obs=prep.n_obs, n_img=k.n_img, n_cam=k.n_cam, n_tie=k.n_tie,
                        ne=k.ne, ni=k.ni, dtype=np.dtype(prep.opts.dtype).name)


@dataclasses.dataclass
class Record:
    """One adjustment of the window."""

    index: int
    wall_s: float
    answer: object = None  # port.Answer, None where it raised
    error: str = ""


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    prep: object  # port.Prepared, still holding the block's device state
    records: list
    window_s: float
    stages: dict
    sizes: counts.Sizes
    on_card: bool

    @property
    def answers(self):
        return [r.answer for r in self.records if r.answer is not None]


def load_reader(name: str):
    """metrics/<name>.py's read function."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sample(seed: int, n: int, k: int) -> list:
    """k of the window's n answers, drawn from the seed, always with the
    last (the one the card ran after the longest time warm)."""
    if n == 0:
        return []
    rng = np.random.default_rng([int(seed) % 2**64, (int(seed) // 2**64) % 2**64, 2**32])
    picked = set(rng.choice(n, size=min(k, n), replace=False).tolist())
    picked.discard(n - 1)
    return sorted(picked)[: max(k - 1, 0)] + [n - 1]


@dataclasses.dataclass
class Setup:
    """A cell's block prepared through the port and warmed up."""

    cell: Cell
    block: object  # blockgen.Block
    prep: object  # port.Prepared
    stages: dict
    setup_s: float
    device: torch.device

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"


def setup(cell: Cell, seed: int, t_start: float, device="cuda",
          overrides: dict | None = None) -> Setup:
    """Build the kernels, make the block, prepare it through the port and
    run one untimed adjustment (index 0 of the seed), so that every shape
    the window uses is built and warm.  `overrides` replace solver options
    (a control's runs)."""
    import port

    dev = torch.device(device)
    stages = {"start_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    if dev.type == "cuda":
        port.build_kernels()
    stages["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    block = blockgen.from_config(cell.config)
    stages["block_s"] = time.perf_counter() - t
    prep = port.Prepared(block, cell.traffic, dev, overrides=overrides)
    stages["prepare_s"] = prep.prepare_s
    log(f"# {cell.name}: n_obs {prep.n_obs} u {prep.u} fused {prep.fused} band {prep.band}")
    t = time.perf_counter()
    prep.adjust(blockgen.initial(block, seed, 0, cell.traffic["init_sigmas"]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stages["warmup_s"] = time.perf_counter() - t
    return Setup(cell, block, prep, stages, time.perf_counter() - t_start, dev)


@dataclasses.dataclass
class Window:
    """What the measured window ran."""

    records: list
    window_s: float
    memory_peak: int
    prof: object  # the profiler, on a traced run
    launches: dict  # the port's launch counters' moves over the traced part
    traced_s: float | None  # the traced part's seconds, from the window's start

    @property
    def answers(self):
        return [r.answer for r in self.records if r.answer is not None]

    @property
    def failed(self) -> int:
        return sum(1 for r in self.records if r.answer is None)

    @property
    def unconverged(self) -> float:
        """The share of the window's adjustments that did not meet the
        convergence contract (threshold or plateau): stopped on the
        cap, or raised."""
        n = len(self.records)
        return sum(1 for r in self.records
                   if r.answer is None or not r.answer.converged) / max(n, 1)


def window(st: Setup, seed: int, seconds: float, trace: bool) -> Window:
    """Adjustments back to back from fresh initial approximations (indices
    1, 2, ... of the seed) until the first adjustment boundary after
    `seconds`; the first devtrace.TRACE_SECONDS of them (to an adjustment
    boundary) under the profiler when `trace`."""
    prep, dev = st.prep, st.device
    sigmas = st.cell.traffic["init_sigmas"]
    records = []
    before = prep.launch_counts()
    prof = devtrace.start() if trace else None
    traced_s = None
    t_w = time.perf_counter()
    index = 0
    while True:
        index += 1
        init = blockgen.initial(st.block, seed, index, sigmas)
        t = time.perf_counter()
        try:
            rec = Record(index, 0.0, answer=prep.adjust(init))
        except Exception:  # an adjustment that raised is a failed one
            rec = Record(index, 0.0, error=traceback.format_exc(limit=4))
            log(f"# adjustment {index} raised:\n{rec.error}")
        rec.wall_s = time.perf_counter() - t
        records.append(rec)
        if prof is not None and traced_s is None and \
                time.perf_counter() - t_w >= devtrace.TRACE_SECONDS:
            if st.on_card:
                torch.cuda.synchronize(dev)
            traced_s = time.perf_counter() - t_w
            traced = dict(adjustments=len(records), launches=prep.launch_counts())
            prof.stop()
        if time.perf_counter() - t_w >= seconds:
            break
    if st.on_card:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t_w
    if prof is not None and traced_s is None:  # a window shorter than the trace
        traced_s = window_s
        traced = dict(adjustments=len(records), launches=prep.launch_counts())
        prof.stop()
    moves = {}
    if prof is not None:
        after = traced["launches"]
        moves = {c: sum(after[g].get(c, 0) - before[g].get(c, 0) for g in after)
                 for c in COUNTED_KERNELS}
    peak = torch.cuda.max_memory_allocated(dev) if st.on_card else 0
    win = Window(records, window_s, int(peak), prof, moves, traced_s)
    walls = sorted(r.wall_s for r in records)
    log(f"# window {window_s:.3f} s, {len(records)} adjustments, {win.failed} raised; "
        f"adjustment wall median {statistics.median(walls):.4f} s worst {walls[-1]:.4f} s; "
        f"walls {[round(r.wall_s, 4) for r in records]}; captures "
        f"{[round(a.capture_s, 4) for a in win.answers]}; loops "
        f"{[round(a.loop_s, 4) for a in win.answers]}; iterations "
        f"{[a.iterations for a in win.answers]}; stopped on "
        f"{[a.stopped_on for a in win.answers]}")
    return win


def end_to_end(st: Setup, win: Window) -> dict:
    """The cell's end-to-end metrics: observations times GN iterations a
    second over the window, the window's seconds an adjustment, set-up."""
    iters = sum(a.iterations for a in win.answers)
    values = dict(obs_per_s=st.prep.n_obs * iters / win.window_s,
                  adjust_s=win.window_s / max(len(win.records), 1), setup_s=st.setup_s)
    return {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
            for m in st.cell.end_to_end}


def layers(st: Setup, win: Window) -> tuple:
    """(the cell's per-layer metrics, the trace's numbers or None, the
    breakdown or None) of a traced window."""
    reduced = None
    if win.prof is not None and st.on_card:
        reduced = devtrace.reduce(win.prof, win.traced_s, tuple(COUNTED_KERNELS.values()))
        coverage = {c: dict(counted=m, traced=reduced["launches"][COUNTED_KERNELS[c]])
                    for c, m in win.launches.items() if m}
        log(f"# trace: busy {reduced['busy_s']:.6f} of {win.traced_s:.6f} s, "
            f"{reduced['device_events']} device events; the port's launches counted vs "
            f"traced {coverage}")
    ctx = Context(st.prep, win.records, win.window_s, st.stages, sizes_of(st.prep), st.on_card)
    metrics = {}
    for m in st.cell.per_layer:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    # the breakdown is given whole even where the trace lost launches inside
    # the graph's IF bodies (the coverage logged above says how many)
    return metrics, reduced, None if reduced is None else reduced["breakdown"]


def to_judge(st: Setup, win: Window, seed: int) -> list:
    """The sampled answers as the reference reads them: (iterations,
    (eop, iop, target tables), reported sigma0^2), on the host."""
    answers = win.answers
    picked = sample(seed, len(answers), int(st.cell.cell["judge_sample"]))
    return [(answers[i].iterations, st.prep.tables(answers[i].x), st.prep.sigma02(answers[i]))
            for i in picked]


def judge(cell: Cell, block, judged_in: list, failed: int, device,
          unconverged: float) -> tuple:
    """(correct, checks): the worst of each number the reference reads over
    the judged answers, and the window's share of unconverged
    adjustments, each against its limit; and no adjustment raised."""
    t = time.perf_counter()
    ref = refba.Problem(block, device)
    worst = {}
    for iters, (eop, iop, pts), s02 in judged_in:
        j = refba.judge(ref, eop, iop, pts, s02)
        log(f"# judged an answer of {iters} iterations: " + ", ".join(
            f"{k} {v:.6g}" for k, v in j.items()))
        for k in refba.NUMBERS:
            v = j[k] if math.isfinite(j[k]) else math.inf
            worst[k] = max(worst.get(k, -math.inf), v)
    log(f"# reference {time.perf_counter() - t:.3f} s for {len(judged_in)} answers")
    checks = {}
    correct = bool(judged_in) and failed == 0
    worst["unconverged"] = unconverged
    for k, limit in cell.cell["limits"].items():
        v = worst.get(k, math.inf)
        checks[k] = dict(value=v if math.isfinite(v) else None, limit=limit)
        correct = correct and limit is not None and v <= limit
    checks["raised"] = dict(value=failed, limit=0)
    return correct, checks


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", overrides: dict | None = None) -> dict:
    """One run of `cell`; returns the result line's object (checks last)."""
    st = setup(cell, seed, t_start, device, overrides)
    log(f"# set-up {st.setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in st.stages.items()))
    win = window(st, seed, seconds, trace)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {', '.join(bad)}")
    dev_out = dict(platform="gpu" if st.on_card else "cpu",
                   kind=torch.cuda.get_device_name(st.device) if st.on_card else "cpu",
                   count=1, memory_peak_bytes=win.memory_peak)
    breakdown = None
    if trace:
        metrics, reduced, breakdown = layers(st, win)
        if reduced is not None:
            dev_out.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    else:
        metrics = end_to_end(st, win)
    # the reference runs once the program's device state is freed
    judged_in = to_judge(st, win, seed)
    attempted, failed, unconverged = len(win.records), win.failed, win.unconverged
    block = st.block
    del st, win
    gc.collect()
    if device != "cpu" and torch.cuda.is_available():
        torch.cuda.empty_cache()
    correct, checks = judge(cell, block, judged_in, failed, device, unconverged)
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    out = dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics,
               device=dev_out)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
