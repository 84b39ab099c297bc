"""A GN step captured as a CUDA graph, with conditional nodes.

The JAX package's device loop and its CG are ``lax.while_loop``s: work
that the loop's condition rules out is not run.  The port captures one
step as a ``torch.cuda.CUDAGraph`` and replays it, and expresses such
conditions as IF nodes (CUDA 12.3+): ``run_if(pred, body)`` runs ``body``
only where the 0-d bool device tensor ``pred`` is true.

- Under capture (``StepGraph.capture``) it adds an IF node to the graph
  being captured (ops/csrc/graphcond.cu, since PyTorch 2.11 has no API for
  conditional nodes) and captures ``body`` into the node's body graph, on a
  side stream of its own (one per nesting depth), with its allocations in
  the capture's second memory pool.  ``body`` must leave its results in
  tensors that exist before the node (``copy_``): a tensor it allocates
  holds nothing when the node does not run.
- Eagerly it reads ``pred`` (on the CPU, a read of host memory) and runs
  ``body`` when it is true, which is what the node does.

NCCL collectives between several ranks do not capture inside an IF node's
body (NCCL adds nodes of its own that a conditional body graph may not
hold), so over several ranks on the card the mesh's collectives are the
port's own kernels over peer memory (ops/peercoll.py), which capture like
any other kernel.

A kernel's launches inside a graph are counted on the device: each
wrapper counts through ``count_launch``, which under a capture also notes
the count against the body being captured (the capture's root, or an IF
node's body).  A body runs all of its nodes or none, so one captured
one-element add per body that counts anything, into the graph's tally on
the card, says how often each of its counts ran; ``StepGraph.collect``
adds each body's counts times its runs to the counters, so they hold what
the replays ran (an IF node that is off runs nothing), not what was
captured.

Nothing here runs at import; a capture builds the kernel library first.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# cudaStreamCaptureModeThreadLocal: the capturing thread may not make
# unsafe calls; other threads (other block solves) may
_THREAD_LOCAL = 1

# one capture at a time in the process: the warm-up and capture of a step
# take the lock, replays do not
capture_lock = threading.Lock()

_local = threading.local()

def _state():
    if not hasattr(_local, "pool"):
        _local.pool = None
        _local.streams = {}
        _local.depth = 0
        _local.frames = []  # [graph, slot or None] per body being captured
    return _local


def run_if(pred, body) -> None:
    """body() where the 0-d bool tensor `pred` is true: an IF node of the
    graph being captured, or, eagerly, a read of pred."""
    st = _state()
    if st.pool is None:
        if bool(pred):
            body()
        return
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    if pred.dtype != torch.bool or pred.dim() != 0 or pred.device.type != "cuda":
        raise ValueError(f"run_if takes a 0-d bool CUDA tensor, got {pred.dtype} "
                         f"{tuple(pred.shape)} on {pred.device}")
    key = (pred.device.index, st.depth)
    if key not in st.streams:
        st.streams[key] = torch.cuda.Stream(device=pred.device)
    child = st.streams[key]
    lib = _build.load()
    parent = torch.cuda.current_stream(pred.device)
    _build.check(lib.graphcond_begin_if(parent.cuda_stream, pred.data_ptr(),
                                        child.cuda_stream, _THREAD_LOCAL),
                 "graphcond_begin_if")
    # the outermost body routes this thread's allocations to the pool; the
    # bodies nested in it are inside that routing already
    pool = (torch.cuda.use_mem_pool(st.pool, device=pred.device) if st.depth == 0
            else contextlib.nullcontext())
    st.depth += 1
    st.frames.append([st.frames[-1][0], None])
    try:
        with torch.cuda.stream(child), pool:
            body()
    finally:
        st.frames.pop()
        st.depth -= 1
        _build.check(lib.graphcond_end(child.cuda_stream), "graphcond_end")


def count_launch(counts: dict, key, device, n: int = 1) -> None:
    """Count one launch of a kernel just issued on `device`'s current
    stream into counts[key] (`n` where the count is of something else a
    launch moves, such as bytes).  Eagerly the count moves at once.  Under
    a capture it moves at once too (what the graph holds, which the
    capture's caller may take back), and, in a StepGraph's capture, the
    count is noted against the body being captured, whose runs the graph's
    tally counts (StepGraph.collect)."""
    counts[key] = counts.get(key, 0) + n
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        return
    frames = _state().frames
    if frames:
        graph, slot = frames[-1]
        if slot is None:
            slot = frames[-1][1] = graph.new_body()
        entry = graph.bodies[slot].setdefault((id(counts), key), [counts, key, 0])
        entry[2] += n


class StepGraph:
    """One captured function and what its replays need alive: the graph,
    the memory pool of its conditional bodies, and the tally of its bodies'
    runs on the current card (a slot per body that counts launches, at
    most `bodies`; `bodies[slot]` holds the body's counts as
    {(id(counts), key): [counts, key, n]}).  The tally is made here,
    before the capture: a tally taken under the capture did not stay the
    tally's alone (its slots read back other data after replays)."""

    def __init__(self, bodies: int = 256):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = torch.cuda.MemPool()
        self.bodies: list = []
        self._tally = torch.zeros(bodies, dtype=torch.int64,
                                  device=torch.cuda.current_device())

    def new_body(self) -> int:
        """A slot for the body being captured, and the add of one into it
        on the current stream: it runs where the body runs."""
        slot = len(self.bodies)
        if slot == self._tally.numel():
            raise RuntimeError(f"StepGraph: more than {slot} bodies count launches; "
                               "make the graph with more `bodies`")
        self.bodies.append({})
        self._tally[slot].add_(1)
        return slot

    def capture(self, fn) -> None:
        """Capture fn() (on a side stream, in thread-local mode) after the
        caller's warm-up; run_if inside it adds IF nodes."""
        st = _state()
        st.pool = self.pool
        st.frames = [[self, None]]
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                fn()
        finally:
            st.pool = None
            st.depth = 0
            st.frames = []

    def replay(self) -> None:
        self.graph.replay()

    def collect(self, add: bool = True) -> dict:
        """The counts the replays ran since the last collect ({key: n},
        summed over the counter dicts), added to the counters when `add`;
        the tally starts again from zero.  Synchronizes the card."""
        runs = self._tally.tolist()
        self._tally.zero_()
        ran = {}
        for body, times in zip(self.bodies, runs):
            if not times:
                continue
            for counts, key, n in body.values():
                ran[key] = ran.get(key, 0) + times * n
                if add:
                    counts[key] = counts.get(key, 0) + times * n
        return ran
