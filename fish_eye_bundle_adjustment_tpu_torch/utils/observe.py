"""Observability: iteration records, divergence detection, timing.

The reference's observability is `disp` lines + tic/toc (SURVEY.md §5.1,
§5.5); here solvers emit structured per-iteration records to an optional
callback and detect divergence instead of looping to the cap.  A copy of
fish_eye_bundle_adjustment_tpu/utils/observe.py, with ``profile_trace`` a
torch.profiler trace in place of the JAX profiler's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import time
from pathlib import Path
from typing import Callable, List, Optional

logger = logging.getLogger("fish_eye_bundle_adjustment_tpu_torch")


@dataclasses.dataclass
class IterationRecord:
    iteration: int
    delta_l1: float
    elapsed_s: float
    cg_tol: Optional[float] = None
    # adaptive-LM trail (solver/schur.py run_gn_loop): False for a rejected
    # trial step (x unchanged, lambda raised); `damping` is lambda AFTER
    # this step's update
    accepted: bool = True
    damping: Optional[float] = None

    def __str__(self):
        extra = f" cg_tol={self.cg_tol:.2e}" if self.cg_tol is not None else ""
        if self.damping:
            extra += f" lm={self.damping:.2e}"
        if not self.accepted:
            extra += " REJECTED"
        return (
            f"iter {self.iteration}: sum|delta|={self.delta_l1:.6g} "
            f"t={self.elapsed_s:.3f}s{extra}"
        )


class SolverDivergence(RuntimeError):
    """Raised when the Gauss-Newton iteration produces non-finite or
    exploding corrections (the reference would silently loop to its
    iteration cap — main.m:490-493)."""

    def __init__(self, iteration: int, delta_l1: float, history: List[float]):
        self.iteration = iteration
        self.delta_l1 = delta_l1
        self.history = history
        super().__init__(
            f"adjustment diverged at iteration {iteration}: "
            f"sum|delta|={delta_l1:.6g} (history: {['%.3g' % d for d in history[-5:]]})"
        )


def check_divergence(iteration: int, delta_l1: float, history: List[float],
                     explode_factor: float = 1e6) -> None:
    """NaN/Inf or a 1e6x blow-up over the best-seen correction is divergence."""
    if not math.isfinite(delta_l1):
        raise SolverDivergence(iteration, delta_l1, history)
    finite = [d for d in history[:-1] if math.isfinite(d)]
    if finite and delta_l1 > explode_factor * min(finite):
        raise SolverDivergence(iteration, delta_l1, history)


ProgressFn = Callable[[IterationRecord], None]


def log_progress(rec: IterationRecord) -> None:
    """Default progress callback -> module logger (INFO)."""
    logger.info("%s", rec)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """torch.profiler trace context (CPU activity, and CUDA's where a card
    is visible) that writes a Chrome trace, trace-<pid>-<ns>.json, under
    `log_dir` when the block ends, and yields the profiler; a no-op
    (yields None) when log_dir is None.  A trace loses kernels launched
    inside a CUDA graph's IF bodies (the device loop's CG blocks): one
    counted 91 of a solve's 272 K2 launches (PERF.md §6), so launches are
    read from the kernels' counters, not from a trace."""
    if log_dir is None:
        yield None
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace-{os.getpid()}-{time.time_ns()}.json"))


@dataclasses.dataclass
class Stage:
    """One stage of a run: its wall seconds, the device's peak allocated
    bytes within it and the bytes still allocated at its end (0 off a
    card)."""

    name: str
    seconds: float
    peak_bytes: int
    held_bytes: int


# the Stage list that record_stages is filling, and its device and clock
_stages: dict = {}


@contextlib.contextmanager
def record_stages(device=None):
    """Record every stage the port marks (mark_stage) inside the block:
    yields the list of Stage it fills.  On a CUDA `device` each mark
    synchronizes it and reads, then resets, its peak allocated bytes, so
    each peak is its stage's own.  Outside the block mark_stage does
    nothing."""
    import torch

    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    log: List[Stage] = []
    _stages.update(log=log, device=dev, t=time.perf_counter())
    try:
        yield log
    finally:
        _stages.clear()


def mark_stage(name: str) -> None:
    """End the stage `name`: the time since the last mark (or the start of
    record_stages), with its device memory."""
    if not _stages:
        return
    import torch

    dev = _stages["device"]
    peak = held = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak, held = torch.cuda.max_memory_allocated(dev), torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    now = time.perf_counter()
    _stages["log"].append(Stage(name, now - _stages["t"], peak, held))
    _stages["t"] = now


class Stopwatch:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt
