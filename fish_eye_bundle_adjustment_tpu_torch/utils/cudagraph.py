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
hold), so a distributed solve over several ranks is not captured.

A kernel's launches inside a graph are counted on the device: each
wrapper counts through ``count_launch``, which under a capture also
captures a one-element add beside the kernel into a tally on the card.
The add runs where and as often as a replay runs the kernel (an IF node
that is off runs neither), and ``collect_replayed`` adds the tally to the
wrapper's counter, so the counters hold what ran, not what was captured.

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

# the device tallies of launches inside graphs: a slot per (counter dict,
# key), one int64 tensor per card
_MAX_SLOTS = 64
_slots: dict = {}
_slot_keys: list = []
_tallies: dict = {}


def _state():
    if not hasattr(_local, "pool"):
        _local.pool = None
        _local.streams = {}
        _local.depth = 0
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
    try:
        with torch.cuda.stream(child), pool:
            body()
    finally:
        st.depth -= 1
        _build.check(lib.graphcond_end(child.cuda_stream), "graphcond_end")


def _tally(index: int):
    if index not in _tallies:
        _tallies[index] = torch.zeros(_MAX_SLOTS, dtype=torch.int64,
                                      device=torch.device("cuda", index))
    return _tallies[index]


def count_launch(counts: dict, key, device) -> None:
    """Count one launch of a kernel just issued on `device`'s current
    stream into counts[key].  Eagerly the count moves at once.  Under a
    capture it moves at once too (what the graph holds, which the capture's
    caller may take back), and an add into the card's tally is captured
    beside the kernel, which collect_replayed turns into launches run."""
    counts[key] = counts.get(key, 0) + 1
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        return
    slot = _slots.get((id(counts), key))
    if slot is None:
        if len(_slot_keys) == _MAX_SLOTS:
            raise RuntimeError(f"count_launch: more than {_MAX_SLOTS} counted kernels")
        slot = _slots[(id(counts), key)] = len(_slot_keys)
        _slot_keys.append((counts, key))
    _tally(torch.cuda.current_device() if device.index is None else device.index)[slot].add_(1)


def collect_replayed(device, add: bool = True) -> dict:
    """The launches graph replays ran on `device` since the last collect,
    by kernel ({key: n} per counter dict's key), added to the counters when
    `add`; the tally starts again from zero.  Synchronizes the card."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    tally = _tally(index)
    vals = tally.tolist()
    tally.zero_()
    ran = {}
    for (counts, key), n in zip(_slot_keys, vals):
        if n:
            ran[key] = ran.get(key, 0) + n
            if add:
                counts[key] = counts.get(key, 0) + n
    return ran


class StepGraph:
    """One captured function and what its replays need alive: the graph,
    and the memory pool of its conditional bodies."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = torch.cuda.MemPool()

    def capture(self, fn) -> None:
        """Capture fn() (on a side stream, in thread-local mode) after the
        caller's warm-up; run_if inside it adds IF nodes."""
        st = _state()
        st.pool = self.pool
        _tally(torch.cuda.current_device())  # made before the capture, not in it
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                fn()
        finally:
            st.pool = None
            st.depth = 0

    def replay(self) -> None:
        self.graph.replay()
