"""Observability: iteration records, divergence detection, timing.

The reference's observability is `disp` lines + tic/toc (SURVEY.md §5.1,
§5.5); here solvers emit structured per-iteration records to an optional
callback and detect divergence instead of looping to the cap.  A copy of
fish_eye_bundle_adjustment_tpu/utils/observe.py without its JAX profiler
trace; in its place the port's own tracing (``trace``, ``span``,
``device_span``): spans of the host and of the device on one clock, the
device's from stamps that run inside the CUDA graph's IF bodies, where
torch.profiler sees no kernel.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import logging
import math
import threading
import time
from typing import Callable, List, Optional

import torch

from fish_eye_bundle_adjustment_tpu_torch.utils.cudagraph import count_launch

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


# -- tracing ---------------------------------------------------------------
#
# A trace (``with trace() as tr``) records spans in memory, on one clock,
# time.perf_counter_ns(), and writes no file:
#
# - host spans (``span(name)``): the host's clock around a stretch of the
#   program, each also a torch.profiler.record_function range, so that it
#   shows in a profiler's trace too;
# - device spans (``device_span(name, tensor)``): a pair of stamps, each a
#   one-thread kernel (ops/csrc/stamp.cu) that writes the device's own
#   nanosecond timer into a ring.  Captured into a CUDA graph, a stamp runs
#   where its IF body runs, in every replay, so a body that did not run
#   leaves no span; its phase says whether it ran eagerly (a warm-up) or
#   in a replay.  The ring is read back where the device loop already
#   synchronizes (its teardown) and at the trace's end.  On the CPU the
#   body runs in step with the host and a stamp reads the host's clock.
#
# The device's timer is mapped onto the host's by calibration stamps, each
# launched eagerly between two host reads: the tightest round trip at the
# trace's start and at each read-back gives an offset, interpolated in
# between.  An anchor range (ANCHOR) at a known host time at the trace's
# start and end lets a reader of a profiler trace put the profiler's
# timeline on the same clock.  Outside a trace ``span`` and
# ``device_span`` record nothing and launch nothing, so a graph captured
# with tracing off is the one it would be without them.

ADJUST = "adjust"  # a span of this name is an adjustment: its id is the adjustment id
ANCHOR = "observe.anchor"  # the record_function range that anchors the host clock
RING_RECORDS = 1 << 17  # records a device's ring holds between read-backs
CALIBRATION_STAMPS = 32  # calibration stamps when a trace opens
RECALIBRATION_STAMPS = 8  # at each read-back and at the trace's end

# the stamp kernel's launches, counted as the kernels' wrappers count theirs
# (utils/cudagraph.count_launch: the replays' launches are counted on the card)
stamp_launches = {"stamp": 0}

# a stamp's tag: replay bit, begin/end bit, site, host span it was issued in
_SITE_BITS = 18
_HOST_SHIFT = 2 + _SITE_BITS

_trace: Optional["Trace"] = None  # the open trace
_rings: dict = {}  # card index -> (ring (RING_RECORDS, 2) int64, head (2,) int64)


@dataclasses.dataclass
class Span:
    """One span of a trace: `start_ns` and `end_ns` on time.perf_counter_ns();
    `parent` the id of the span it lies in (a device span's: the device span
    around it, else the host span it was issued in, or for a replay the
    device loop's ``loop.replays``); `adjustment` the id of its ADJUST span;
    `phase` "host" for a host span, "eager" or "replay" for a device span."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    adjustment: Optional[int]
    phase: str = "host"

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class Calibration:
    """Calibration stamps on one card: (device ns, host ns before the launch,
    host ns after the synchronize) each, and the offset (host minus device)
    that the tightest round trip gives."""

    samples: list
    offset_ns: int
    round_trip_ns: int

    @property
    def device_ns(self) -> int:
        return min(self.samples, key=lambda s: s[2] - s[1])[0]


class _Null:
    """What span and device_span return outside a trace: records nothing."""

    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Trace:
    """Spans recorded by ``trace()`` (see the notes above), with the clock's
    calibrations by card index, the anchors (host ns before and inside each
    ANCHOR range), and the device records lost: `overflow` (the ring was
    full) and `unpaired` (a begin without its end, or the reverse)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.calibrations: dict = {}
        self.anchors: list = []
        self.overflow = 0
        self.unpaired = 0
        self._sites: dict = {}  # stamp site name -> id
        self._names: list = []  # stamp site id -> name
        self._begun: dict = {}  # span id -> (parent, adjustment) of every span begun
        self._stacks: dict = {}  # thread id -> ids of its open host spans
        self._host_records: list = []  # (tag, ns) of the stamps on the CPU
        self._next = 0
        self._lock = threading.Lock()

    # -- host spans ------------------------------------------------------
    def _begin(self, name: str, parent: Optional[int]) -> int:
        with self._lock:
            sid = self._next
            self._next += 1
        adj = sid if name == ADJUST else (
            self._begun[parent][1] if parent is not None else None)
        self._begun[sid] = (parent, adj)
        return sid

    def _stack(self) -> list:
        return self._stacks.setdefault(threading.get_ident(), [])

    def adjustment_of(self, sid: Optional[int]) -> Optional[int]:
        return None if sid is None else self._begun[sid][1]

    # -- device stamps ---------------------------------------------------
    def _site(self, name: str) -> int:
        site = self._sites.get(name)
        if site is None:
            site = self._sites[name] = len(self._names)
            self._names.append(name)
        return site

    def _stamp(self, site: int, end: bool, device) -> None:
        stack = self._stack()
        host = stack[-1] if stack else None
        if device.type != "cuda":
            self._host_records.append((_tag(site, end, False, host), time.perf_counter_ns()))
            return
        replay = torch.cuda.is_current_stream_capturing()
        ring, head = _ring(device, replay)
        _launch_stamp(ring, head, _tag(site, end, replay, host), device)

    def _pair(self, records, to_host, replay_parent: Optional[int]) -> None:
        """Device spans from (tag, device ns) records in the order they were
        written: a begin opens a span inside the one open before it, an end
        closes the innermost."""
        open_: list = []
        for tag, t in records:
            replay, end = tag & 1, (tag >> 1) & 1
            site, host = (tag >> 2) & ((1 << _SITE_BITS) - 1), (tag >> _HOST_SHIFT) - 1
            if not end:
                parent = (open_[-1][0] if open_ else
                          replay_parent if replay else (None if host < 0 else host))
                sid = self._begin(self._names[site], parent)
                open_.append((sid, site, t, parent, replay))
                continue
            if not open_ or open_[-1][1] != site:
                self.unpaired += 1
                continue
            sid, _, t0, parent, rep = open_.pop()
            self.spans.append(Span(sid, self._names[site], to_host(t0), to_host(t), parent,
                                   self.adjustment_of(sid), "replay" if rep else "eager"))
        self.unpaired += len(open_)

    def collect(self, device=None, replay_parent: Optional[int] = None) -> None:
        """Read back the stamps recorded so far (on `device`'s card, and on
        the CPU) into device spans, a replay's top-level ones inside
        `replay_parent`.  Synchronizes the card."""
        if self._host_records:
            records, self._host_records = self._host_records, []
            self._pair(records, lambda t: t, replay_parent)
        if device is None or device.type != "cuda":
            return
        device = _card(device)
        if device.index not in _rings:
            return
        ring, head = _rings[device.index]
        n, over = head.tolist()
        records = [tuple(r) for r in ring[: min(n, RING_RECORDS)].tolist()]
        head.zero_()
        self.overflow += over
        self._calibrate(device, RECALIBRATION_STAMPS)
        self._pair(records, self._mapper(device.index), replay_parent)

    # -- the clock -------------------------------------------------------
    def _calibrate(self, device, n: int) -> None:
        ring = torch.zeros((n, 2), dtype=torch.int64, device=device)
        head = torch.zeros(2, dtype=torch.int64, device=device)
        stream = torch.cuda.current_stream(device)
        stream.synchronize()
        hosts = []
        for _ in range(n):
            h0 = time.perf_counter_ns()
            _launch_stamp(ring, head, 0, device)
            stream.synchronize()
            hosts.append((h0, time.perf_counter_ns()))
        samples = [(g, h0, h1) for g, (h0, h1) in zip(ring[:, 1].tolist(), hosts)]
        g, h0, h1 = min(samples, key=lambda s: s[2] - s[1])
        cal = Calibration(samples, (h0 + h1) // 2 - g, h1 - h0)
        self.calibrations.setdefault(device.index, []).append(cal)

    def _mapper(self, index: int):
        """Device ns -> host ns on card `index`: the calibrations' offsets,
        linear between them, the nearest one's outside them."""
        cals = sorted(self.calibrations[index], key=lambda c: c.device_ns)
        gs = [c.device_ns for c in cals]
        offs = [c.offset_ns for c in cals]

        def to_host(g):
            i = bisect.bisect_left(gs, g)
            if i == 0 or i == len(gs):
                return g + offs[min(i, len(gs) - 1)]
            w = (g - gs[i - 1]) / (gs[i] - gs[i - 1])
            return g + round(offs[i - 1] + w * (offs[i] - offs[i - 1]))

        return to_host

    def to_host_ns(self, index: int, device_ns: int) -> int:
        """A time of card `index`'s timer on the host's clock."""
        return self._mapper(index)(device_ns)

    def _anchor(self, n: int = 3) -> None:
        """`n` ANCHOR ranges in a row (the first may pay the profiler's own
        set-up; a reader keeps the tightest)."""
        for _ in range(n):
            h0 = time.perf_counter_ns()
            with torch.profiler.record_function(ANCHOR):
                self.anchors.append((h0, time.perf_counter_ns()))

    def profiler_clock(self, events):
        """A map from a torch.profiler timeline (the us of its events'
        time_range, `events` its events) to the host's ns: the ANCHOR ranges,
        which the profiler must have seen every one of, the tightest of those
        at the trace's start and of those at its end, linear between."""
        starts = sorted(e.time_range.start for e in events if e.name == ANCHOR)
        if len(starts) != len(self.anchors):
            raise ValueError(f"the profiler saw {len(starts)} of the trace's "
                             f"{len(self.anchors)} anchors")
        pairs = list(zip(self.anchors, starts))
        half = len(pairs) // 2
        ends = [min(p, key=lambda a: a[0][1] - a[0][0]) for p in (pairs[:half], pairs[half:])]
        (p0, h0), (p1, h1) = [((h[0] + h[1]) / 2, us * 1e3) for h, us in ends]
        rate = (p1 - p0) / (h1 - h0) if h1 > h0 else 1.0
        return lambda us: p0 + (us * 1e3 - h0) * rate

    # -- reading ---------------------------------------------------------
    def named(self, name: str, phase: Optional[str] = None) -> List[Span]:
        """The spans called `name` (of `phase` where given), by start."""
        return sorted((s for s in self.spans if s.name == name and
                       (phase is None or s.phase == phase)), key=lambda s: s.start_ns)

    def children(self, sp: Span) -> List[Span]:
        return sorted((s for s in self.spans if s.parent == sp.id), key=lambda s: s.start_ns)


def _tag(site: int, end: bool, replay: bool, host: Optional[int]) -> int:
    return ((-1 if host is None else host) + 1) << _HOST_SHIFT | site << 2 | int(end) << 1 | int(replay)


def _card(device):
    """`device` ("cuda" or "cuda:i") with its card's index."""
    return device if device.index is not None else torch.device("cuda", torch.cuda.current_device())


def _ring(device, capturing: bool):
    """Card `device`'s ring and head, made on first use.  They outlive a
    trace (a graph that holds stamps keeps their addresses), and each trace
    starts them empty."""
    rh = _rings.get(device.index)
    if rh is None:
        if capturing:
            raise RuntimeError("a device's stamp ring is made outside a capture: open the "
                               "trace (or stamp once eagerly) on the card before capturing")
        rh = _rings[device.index] = (
            torch.zeros((RING_RECORDS, 2), dtype=torch.int64, device=device),
            torch.zeros(2, dtype=torch.int64, device=device))
    return rh


def _launch_stamp(ring, head, tag: int, device) -> None:
    """One stamp kernel (ops/csrc/stamp.cu) on `device`'s current stream."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    lib = _build.load()
    _build.check(lib.stamp_record(ring.data_ptr(), head.data_ptr(), ring.shape[0], tag,
                                  torch.cuda.current_stream(device).cuda_stream),
                 "stamp_record")
    count_launch(stamp_launches, "stamp", device)


def timer_ticks_ns(device, n: int = 256) -> list:
    """The steps (ns) of card `device`'s %globaltimer over its next `n`
    changes, read by one thread (the stamps' resolution); -1 marks a timer
    that stopped moving."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    out = torch.zeros(n, dtype=torch.int64, device=device)
    lib = _build.load()
    _build.check(lib.stamp_ticks(out.data_ptr(), n, torch.cuda.current_stream(device).cuda_stream),
                 "stamp_ticks")
    return out.tolist()


class _Span:
    __slots__ = ("trace", "name", "stage", "id", "parent", "start_ns", "end_ns", "_range")

    def __init__(self, tr: Optional[Trace], name: str, stage: Optional[str]):
        self.trace, self.name, self.stage = tr, name, stage
        self.id = self.parent = self.start_ns = self.end_ns = None

    def __enter__(self):
        tr = self.trace
        if tr is not None:
            stack = tr._stack()
            self.parent = stack[-1] if stack else None
            self.id = tr._begin(self.name, self.parent)
            stack.append(self.id)
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self.trace
        if tr is not None:
            self.end_ns = time.perf_counter_ns()
            self._range.__exit__(exc_type, exc, tb)
            tr._stack().pop()
            tr.spans.append(Span(self.id, self.name, self.start_ns, self.end_ns, self.parent,
                                 tr.adjustment_of(self.id)))
        if exc_type is None and self.stage is not None:
            mark_stage(self.stage)
        return False


class _DeviceSpan:
    __slots__ = ("trace", "site", "device")

    def __init__(self, tr: Trace, name: str, device):
        self.trace, self.site, self.device = tr, tr._site(name), device

    def __enter__(self):
        self.trace._stamp(self.site, False, self.device)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.trace._stamp(self.site, True, self.device)
        return False


def span(name: str, stage: Optional[str] = None):
    """A host span `name` while a trace is open (a context).  Its end marks
    the record_stages stage `stage` where one is given, trace or not.
    Outside a trace, and with no stage to mark, it records nothing."""
    if _trace is None and (stage is None or not _stages):
        return _NULL
    return _Span(_trace, name, stage)


def device_span(name: str, like):
    """A device span `name` (a context) on the device of the tensor `like`:
    a stamp before the block's work and one after it, on the current
    stream, eager or captured.  Outside a trace it launches nothing."""
    if _trace is None:
        return _NULL
    return _DeviceSpan(_trace, name, like.device)


def collect_stamps(device, replay_parent: Optional[int] = None) -> None:
    """Trace.collect on the open trace; nothing outside one."""
    if _trace is not None:
        _trace.collect(torch.device(device), replay_parent)


@contextlib.contextmanager
def trace(device=None):
    """Trace the block (see the notes above): yields the Trace it fills.
    On a card (`device`, default the current card where one is visible) it
    empties the card's stamp ring and calibrates the card's timer against
    the host's clock; an ANCHOR range marks its start and its end.  One
    trace at a time in the process."""
    global _trace
    if _trace is not None:
        raise RuntimeError("a trace is open already")
    if device is None and torch.cuda.is_available():
        device = "cuda"
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        dev = _card(dev)
    tr = Trace()
    if dev is not None and dev.type == "cuda":
        _ring(dev, False)[1].zero_()
        tr._calibrate(dev, CALIBRATION_STAMPS)
    tr._anchor()
    _trace = tr
    try:
        yield tr
    finally:
        _trace = None
        for index in sorted(set(tr.calibrations) | set(_rings)):
            tr.collect(torch.device("cuda", index))
        tr.collect()
        tr._anchor()
