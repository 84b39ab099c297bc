"""The observation-axis mesh on torch.distributed: one rank per device.

PyTorch port of fish_eye_bundle_adjustment_tpu/parallel/mesh.py.  The JAX
package runs one process over a 1-D device mesh (``shard_map``); PyTorch's
idiom is one process per device in a process group, which is the JAX
package's multi-process path (parallel/dist_schur.shard_obs).  Every rank
calls the same solver on the same problem, builds the same host plans,
and keeps only its own slice of the observation stream on its device;
state the JAX package replicates is computed alike on every rank from
all-reduced values, so every host decision (the CG flag, the LM
accept/reject, convergence) is taken on values equal bit for bit on
every rank.

A `Mesh` is one rank's handle on the group: its size, its index (the JAX
``axis_index``), its device and the three collectives the solvers take,
each standing where the JAX package has ``psum``, ``psum_scatter`` and
``all_gather``.  It counts the calls and bytes of each (`counts`), as the
kernel wrappers count their launches (utils/cudagraph.count_launch: under
a captured graph, what the replays ran).  Over several ranks on the card
the collectives are the port's own kernels over peer memory
(ops/peercoll.py, the Mesh's `comm`), so that the device loop's graph holds
them inside its IF nodes; at one rank on the card they are NCCL's, and on
the CPU gloo's.  NCCL (gloo on the CPU) also carries what is not in a
step: the group's start, barriers and the peer handles' exchange.

`run_ranks` starts the ranks of one run as processes (spawned, so they
import this package and torch only) and returns rank 0's result;
`spawn_each` is its process pool, which the pose graph's block solves
take without a process group.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import socket
import tempfile
import time
import traceback
import warnings
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll
from fish_eye_bundle_adjustment_tpu_torch.utils.cudagraph import count_launch

OBS_AXIS = "obs"

# the process group's time limit on one collective: a rank that stops
# taking part (a fault, or ranks that took different branches) fails the
# run instead of hanging it
DEFAULT_TIMEOUT_S = 600.0


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


_OPS = ("all_reduce", "reduce_scatter", "all_gather")


@dataclasses.dataclass
class Mesh:
    """One rank of the default process group, a 1-D mesh over the
    observation axis."""

    device: torch.device
    size: int
    index: int
    # calls and bytes sent (the input of each call) by operation
    counts: dict = dataclasses.field(
        default_factory=lambda: {op: {"calls": 0, "bytes": 0} for op in _OPS})
    # the peer kernels' communicator: over several ranks on the card
    comm: Optional[peercoll.PeerComm] = dataclasses.field(default=None, repr=False)

    def reset_counts(self) -> None:
        for c in self.counts.values():
            c["calls"] = c["bytes"] = 0

    def _count(self, op, t):
        count_launch(self.counts[op], "calls", self.device)
        count_launch(self.counts[op], "bytes", self.device, t.numel() * t.element_size())

    def check(self) -> None:
        """Raise if a peer collective gave up waiting for a rank (after a
        read of the card: it sees the launches that have ended)."""
        if self.comm is not None:
            self.comm.check()

    def psum(self, x):
        """Sum over the ranks (``psum``): a new tensor, equal on every rank."""
        self._count("all_reduce", x)
        if self.comm is not None:
            return peercoll.all_reduce(x, self.comm)
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    def psum_scatter(self, x):
        """Sum over the ranks, then this rank's slice of dim 0
        (``psum_scatter(tiled=True)``): x (size * m, ...) -> (m, ...)."""
        self._count("reduce_scatter", x)
        if self.comm is not None:
            return peercoll.reduce_scatter(x, self.comm)
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        with warnings.catch_warnings():
            _quiet_deprecation()
            dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM)
        return out

    def all_gather(self, x):
        """Every rank's x stacked along dim 0 in rank order
        (``all_gather(tiled=True)``): (m, ...) -> (size * m, ...)."""
        self._count("all_gather", x)
        if self.comm is not None:
            return peercoll.all_gather(x, self.comm)
        x = x.contiguous()
        out = x.new_empty((x.shape[0] * self.size,) + tuple(x.shape[1:]))
        with warnings.catch_warnings():
            _quiet_deprecation()
            dist.all_gather_into_tensor(out, x)
        return out


def _quiet_deprecation():
    """Recent PyTorch marks reduce_scatter_tensor and
    all_gather_into_tensor deprecated in favour of names that older
    releases lack; the calls stay, for both."""
    warnings.filterwarnings("ignore", category=FutureWarning, message=".*is deprecated")


# this process's device in the default group, and its peer communicator
# (over several ranks on the card: one a group, opened by the first
# make_mesh, closed by shutdown)
_STATE = {"device": None, "comm": None}


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group as rank `process_id` of
    `num_processes`, meeting the others at `coordinator`
    ("tcp://host:port" or "file://path"; None: the torchrun environment).  `device` is this
    rank's device: "cuda" means cuda:<rank>, and a CUDA device takes NCCL,
    the CPU gloo -- never the one in place of the other.  Returns the
    device."""
    if device is None or str(device) == "cuda":
        device = f"cuda:{process_id if process_id is not None else _local_rank()}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu'")
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator is not None:
        kw.update(init_method=coordinator, world_size=num_processes, rank=process_id)
    dist.init_process_group(**kw)
    _STATE["device"] = dev
    return dev


def _local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's)."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The Mesh of the default process group (init_distributed first) on
    this rank's device.  `n_devices`, when given, must be the group's
    size: a rank cannot take part in a smaller mesh.  Over several ranks
    on the card the first call opens the group's peer communicator
    (collective: every rank calls it), which every later Mesh of the group
    shares."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call init_distributed first")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: the process group has {size} ranks, not {n_devices}")
    dev, rank = _STATE["device"], dist.get_rank()
    if dev.type == "cuda" and size > 1 and _STATE["comm"] is None:
        _STATE["comm"] = peercoll.PeerComm(dev, rank, size)
    return Mesh(device=dev, size=size, index=rank, comm=_STATE["comm"])


def shutdown() -> None:
    """Close the group's peer communicator, then leave the group."""
    if dist.is_initialized():
        if _STATE["comm"] is not None:
            _STATE["comm"].close()
        dist.destroy_process_group()
    _STATE.update(device=None, comm=None)


# ---------------------------------------------------------------------------
# starting the ranks of one run
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _process_main(index, fn, out_dir, threads):
    """One spawned process: fn(*args) with torch on `threads` threads, its
    args read from out_dir; its result, or its traceback, into out_dir."""
    torch.set_num_threads(threads)
    try:
        with open(Path(out_dir) / f"args{index}.pkl", "rb") as f:
            args = pickle.load(f)
        result = fn(*args)
        with open(Path(out_dir) / f"result{index}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (Path(out_dir) / f"error{index}.txt").write_text(traceback.format_exc())
        raise SystemExit(1)


def spawn_each(fn, arg_lists, timeout_s: float = DEFAULT_TIMEOUT_S, threads: int = 1,
               what: str = "spawn_each"):
    """fn(*args) for each `args` of `arg_lists`, each in a process of its
    own, all started together (spawned: they import this package and torch
    only); their results in order.  `fn` must be a module-level function,
    its arguments and result picklable.  A failing process fails the call
    with its traceback (RuntimeError, every process stopped); past
    `timeout_s` every process is stopped and the call raises TimeoutError.
    Each process runs torch on `threads` threads; `what` names the caller
    in the errors.  The arguments go through files: a spawned process
    reads what its start() sends only once it has imported the caller's
    main module, so large arguments sent that way would start the
    processes one after the other."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        for i, args in enumerate(arg_lists):
            with open(Path(out_dir) / f"args{i}.pkl", "wb") as f:
                pickle.dump(args, f)
        procs = [ctx.Process(target=_process_main, args=(i, fn, out_dir, threads))
                 for i in range(len(arg_lists))]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                failed = [p for p in procs if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = sorted(Path(out_dir).glob("error*.txt"))
        if errors:
            raise RuntimeError(f"{what}: a process failed:\n"
                               + "\n".join(e.read_text() for e in errors))
        bad = [i for i, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what}: processes {bad} still running after {timeout_s} s")
            raise RuntimeError(f"{what}: processes {bad} exited with "
                               f"{[procs[i].exitcode for i in bad]}")
        out = []
        for i in range(len(procs)):
            with open(Path(out_dir) / f"result{i}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(rank, n, coordinator, device, fn, args, timeout_s):
    """One rank: join the group, run fn(mesh, *args), leave; rank 0's
    result (the others return None)."""
    dev = "cpu" if str(device) == "cpu" else f"cuda:{rank}"
    init_distributed(coordinator, n, rank, dev, timeout_s=timeout_s)
    result = fn(make_mesh(), *args)
    shutdown()
    return result if rank == 0 else None


def run_ranks(fn, n: int, device=None, args=(), timeout_s: float = DEFAULT_TIMEOUT_S,
              collective_timeout_s: Optional[float] = None):
    """Run fn(mesh, *args) on `n` ranks, each a spawned process
    (spawn_each): rank r on cuda:r over NCCL (device None or "cuda";
    without a card it raises), or on the CPU over gloo when asked (device
    "cpu").  `fn` must be a module-level function, and what it returns
    picklable.  Returns rank 0's result.  A failing rank fails the run with
    its traceback; past `timeout_s` every rank is stopped and the run
    raises TimeoutError.  Each rank runs torch on one thread."""
    from fish_eye_bundle_adjustment_tpu_torch.solver.dense import resolve_device

    device = resolve_device(device, "run_ranks")
    if device.type != "cpu":
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"run_ranks: {n} ranks need {n} CUDA devices; {have} visible")
    coll_s = collective_timeout_s or timeout_s
    with tempfile.TemporaryDirectory() as meet:
        # the ranks meet at a file of the run's own directory: no port to
        # pick, which another process could take before rank 0 listens
        coordinator = f"file://{Path(meet) / 'rendezvous'}"
        return spawn_each(_rank_main, [(r, n, coordinator, device, fn, args, coll_s)
                                       for r in range(n)],
                          timeout_s, threads=1, what="run_ranks")[0]
