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
import this package and torch only), as one host or as several emulated
ones, and returns rank 0's result;
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
_LEVELS = ("local", "cross_host")


def _zero_counts():
    return {op: {"calls": 0, "bytes": 0} for op in _OPS}


@dataclasses.dataclass
class Hosts:
    """A group's ranks by host: `n_hosts` hosts of `per_host` ranks each,
    host h holding ranks h * per_host ... (h + 1) * per_host - 1; this
    rank is rank `local` of host `host`.  `local_group` is the process
    group of this rank's host, `rail_group` that of the ranks at index
    `local` of every host (its rank h on host h)."""

    n_hosts: int
    per_host: int
    host: int
    local: int
    local_group: object = dataclasses.field(default=None, repr=False)
    rail_group: object = dataclasses.field(default=None, repr=False)


def host_layout(names):
    """(hosts, ranks a host) of a group whose rank r runs on host
    names[r].  Raises ValueError unless each host's ranks have consecutive
    rank numbers and every host holds as many."""
    runs = []  # (host, ranks) in rank order
    for name in names:
        if runs and runs[-1][0] == name:
            runs[-1][1] += 1
        else:
            runs.append([name, 1])
    seen = [h for h, _ in runs]
    if len(set(seen)) != len(seen):
        raise ValueError(f"the ranks of one host must have consecutive rank numbers "
                         f"(as torchrun gives them); hosts by rank: {list(names)}")
    sizes = {n for _, n in runs}
    if len(sizes) != 1:
        raise ValueError(f"every host must hold the same number of ranks; ranks by host: "
                         f"{ {h: n for h, n in runs} }")
    return len(runs), sizes.pop()


@dataclasses.dataclass
class Mesh:
    """One rank of the default process group, a 1-D mesh over the
    observation axis."""

    device: torch.device
    size: int
    index: int
    # calls and bytes sent (the input of each call) by operation
    counts: dict = dataclasses.field(default_factory=_zero_counts)
    # the peer kernels' communicator: over several ranks on the card (over
    # several hosts: the ranks of this rank's host)
    comm: Optional[peercoll.PeerComm] = dataclasses.field(default=None, repr=False)
    # the ranks by host, where the group spans hosts (None: one host)
    hosts: Optional[Hosts] = None
    # over several hosts, each level's calls and bytes (the input of each
    # call) by operation: "local" the host's peer collectives (none at one
    # rank a host), "cross_host" the rail's
    levels: dict = dataclasses.field(
        default_factory=lambda: {lv: _zero_counts() for lv in _LEVELS})

    def reset_counts(self) -> None:
        for c in self.counts.values():
            c["calls"] = c["bytes"] = 0
        for level in self.levels.values():
            for c in level.values():
                c["calls"] = c["bytes"] = 0

    def _count(self, op, t, counts=None):
        counts = self.counts if counts is None else counts
        count_launch(counts[op], "calls", self.device)
        count_launch(counts[op], "bytes", self.device, t.numel() * t.element_size())

    def check(self) -> None:
        """Raise if a peer collective gave up waiting for a rank (after a
        read of the card: it sees the launches that have ended)."""
        if self.comm is not None:
            self.comm.check()

    def psum(self, x):
        """Sum over the ranks (``psum``): a new tensor, equal on every rank."""
        self._count("all_reduce", x)
        if self.hosts is not None:
            return self._psum_hosts(x)
        if self.comm is not None:
            return peercoll.all_reduce(x, self.comm)
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    def psum_scatter(self, x):
        """Sum over the ranks, then this rank's slice of dim 0
        (``psum_scatter(tiled=True)``): x (size * m, ...) -> (m, ...)."""
        self._count("reduce_scatter", x)
        if self.hosts is not None:
            return self._psum_scatter_hosts(x)
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
        if self.hosts is not None:
            return self._all_gather_hosts(x)
        if self.comm is not None:
            return peercoll.all_gather(x, self.comm)
        x = x.contiguous()
        out = x.new_empty((x.shape[0] * self.size,) + tuple(x.shape[1:]))
        with warnings.catch_warnings():
            _quiet_deprecation()
            dist.all_gather_into_tensor(out, x)
        return out

    # -- over several hosts: the host's peer collective, then the rail's --
    #
    # Why two levels and not NCCL over the whole group: each host sends
    # the network its bytes once, split over its rails (an all-reduce puts
    # 1x the input out of a host, NCCL's flat ring 1.5x), and inside a
    # host the peer kernels run.  On 2 emulated hosts x 2 H100s (700 W)
    # whose NCCL takes its socket transport between them
    # (bench_torch_hosts.py coll) the three collectives took 0.64-0.83x
    # the time of NCCL's over the whole group at 2.4 and 23.5 MB; where
    # NCCL sees one machine and crosses the "hosts" over NVLink, they lose
    # to it (1.3-1.4x at the same sizes).
    #
    # The sums: a value of rank (h, l) -- rank l of host h -- is summed
    # first over the ranks of its host in local order (((x_h0 + x_h1) +
    # x_h2) + ..., the peer reduce-scatter's order, one rank of the host
    # holding each column), then over the hosts by the rail's collective:
    # NCCL's on the card, gloo's on the CPU.  With two hosts that is one
    # addition, which commutes; past two both reduce each column on one
    # rank of the rail and hand the result on, so every rank of the rail
    # holds the same bits, and the local all-gather gives them to the
    # host: a psum is equal bit for bit on every rank.

    def _local(self, op, x):
        """Collective `op` of 1-D x over this rank's host: the peer kernel
        on the card, its plain version on the CPU (ops/peercoll.py); x
        itself at one rank a host."""
        if self.hosts.per_host == 1:
            return x
        self._count(op, x, self.levels["local"])
        return getattr(peercoll, op)(x, self.comm)

    def _rail(self, op, x):
        """Collective `op` of 1-D x over the rail (NCCL's or gloo's)."""
        self._count(op, x, self.levels["cross_host"])
        group, n = self.hosts.rail_group, self.hosts.n_hosts
        if op == "all_reduce":
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
            return x
        with warnings.catch_warnings():
            _quiet_deprecation()
            if op == "reduce_scatter":
                out = x.new_empty(x.numel() // n)
                dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
            else:
                out = x.new_empty(x.numel() * n)
                dist.all_gather_into_tensor(out, x, group=group)
        return out

    def _psum_hosts(self, x):
        """The all-reduce in two levels: x's values cut into per_host
        slices (zeros padding the last: a pad is a column of its own, so
        no sum takes it), each local rank's slice summed over the host,
        then over the rail, then gathered over the host."""
        per = self.hosts.per_host
        flat = x.contiguous().reshape(-1)
        n = flat.numel()
        m = -(-n // per)
        padded = torch.nn.functional.pad(flat, (0, m * per - n)) if m * per != n else flat
        part = self._local("reduce_scatter", padded)
        if part is padded:
            part = padded.clone()
        part = self._rail("all_reduce", part)
        return self._local("all_gather", part)[:n].reshape(x.shape)

    def _psum_scatter_hosts(self, x):
        """The reduce-scatter in two levels, rows in rank order: rank (h,
        l)'s rows are block h * per_host + l of x.  The blocks are put in
        (l, h) order, so that the host's reduce-scatter gives local rank l
        the blocks of every host's rank l, summed over the host; the
        rail's reduce-scatter then gives host h its block."""
        n_hosts, per = self.hosts.n_hosts, self.hosts.per_host
        rows = x.shape[0] // self.size
        blocks = x.contiguous().reshape(n_hosts, per, -1).transpose(0, 1).reshape(-1)
        part = self._local("reduce_scatter", blocks)
        out = self._rail("reduce_scatter", part.contiguous())
        return out.reshape((rows,) + tuple(x.shape[1:]))

    def _all_gather_hosts(self, x):
        """The all-gather in two levels, rows in rank order: the rail's
        gather (host h's block h), then the host's (local rank l's block
        l), the blocks put back from (l, h) to rank order (h, l)."""
        n_hosts, per = self.hosts.n_hosts, self.hosts.per_host
        rail = self._rail("all_gather", x.contiguous().reshape(-1))
        full = self._local("all_gather", rail)
        full = full.reshape(per, n_hosts, -1).transpose(0, 1)
        return full.reshape((x.shape[0] * self.size,) + tuple(x.shape[1:]))


def _quiet_deprecation():
    """Recent PyTorch marks reduce_scatter_tensor and
    all_gather_into_tensor deprecated in favour of names that older
    releases lack; the calls stay, for both."""
    warnings.filterwarnings("ignore", category=FutureWarning, message=".*is deprecated")


# this process's device in the default group, each rank's host, and its
# peer communicator (over several ranks on the card: one a group -- over
# several hosts, over the ranks of this one --, opened by the first
# make_mesh, closed by shutdown) and host groups (made by the first make_mesh)
_STATE = {"device": None, "comm": None, "host_names": None, "hosts": None}


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     host: Optional[str] = None) -> torch.device:
    """Join the default process group as rank `process_id` of
    `num_processes`, meeting the others at `coordinator`
    ("tcp://host:port" or "file://path"; None: the torchrun environment).  `device` is this
    rank's device: "cuda" means cuda:<its index among the ranks of its
    host>, and a CUDA device takes NCCL, the CPU gloo -- never the one in
    place of the other.  `host` names this rank's host (default: its host
    name); the ranks swap their hosts once, through the group's store, and
    make_mesh cuts the group by them.  Giving ranks of one machine other
    names emulates several hosts there.  Under torchrun the host names must
    agree with its LOCAL_RANK and LOCAL_WORLD_SIZE, or it raises (machines
    that share a name would otherwise make one host).  Returns the
    device."""
    cuda = device is None or torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: no CUDA device; pass device='cpu'")
    backend = "nccl" if cuda else "gloo"
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator is not None:
        kw.update(init_method=coordinator, world_size=num_processes, rank=process_id)
    dist.init_process_group(**kw)
    names = _swap_hosts(socket.gethostname() if host is None else str(host))
    rank = dist.get_rank()
    local = (sum(1 for n in names[:rank] if n == names[rank]), names.count(names[rank]))
    launcher = (os.environ.get("LOCAL_RANK"), os.environ.get("LOCAL_WORLD_SIZE"))
    if coordinator is None and host is None and None not in launcher \
            and local != tuple(int(v) for v in launcher):
        raise RuntimeError(
            f"init_distributed: rank {rank} is local rank {launcher[0]} of {launcher[1]} to "
            f"torchrun but {local[0]} of {local[1]} by its host name {names[rank]!r}: "
            "machines that share a host name? Give each its own (host=)")
    if device is None or str(device) == "cuda":
        device = f"cuda:{local[0]}"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _STATE.update(device=dev, host_names=names)
    return dev


def _swap_hosts(name: str):
    """Every rank's host name, in rank order, through the default group's
    store (no collective: no device is needed yet)."""
    store = dist.distributed_c10d._get_default_store()
    store.set(f"fisheye_ba_host/{dist.get_rank()}", name)
    return [store.get(f"fisheye_ba_host/{r}").decode()
            for r in range(dist.get_world_size())]


def _host_groups(names) -> Optional[Hosts]:
    """The group's Hosts where its ranks span several hosts (None on one):
    every rank makes every local group, then every rail group, in that
    order (dist.new_group is collective)."""
    n_hosts, per = host_layout(names)
    if n_hosts == 1:
        return None
    rank = dist.get_rank()
    host, local = divmod(rank, per)
    out = Hosts(n_hosts=n_hosts, per_host=per, host=host, local=local)
    for h in range(n_hosts):
        g = dist.new_group(list(range(h * per, (h + 1) * per)))
        if h == host:
            out.local_group = g
    for i in range(per):
        g = dist.new_group([h * per + i for h in range(n_hosts)])
        if i == local:
            out.rail_group = g
    return out


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The Mesh of the default process group (init_distributed first) on
    this rank's device.  `n_devices`, when given, must be the group's
    size: a rank cannot take part in a smaller mesh.  Over several ranks
    on the card the first call opens the group's peer communicator
    (collective: every rank calls it), which every later Mesh of the group
    shares.  Where the ranks span hosts, the first call also makes the
    local and rail groups (module docstring; it raises unless each host's
    ranks are consecutive and every host holds as many), and the peer
    communicator is over the ranks of this host (on the CPU too: its plain
    versions are the local level there)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call init_distributed first")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: the process group has {size} ranks, not {n_devices}")
    dev, rank = _STATE["device"], dist.get_rank()
    if _STATE["hosts"] is None:
        _STATE["hosts"] = _host_groups(_STATE["host_names"] or [""] * size)
    hosts = _STATE["hosts"]
    if _STATE["comm"] is None:
        if hosts is not None and hosts.per_host > 1:
            _STATE["comm"] = peercoll.PeerComm(dev, hosts.local, hosts.per_host,
                                               group=hosts.local_group)
        elif hosts is None and dev.type == "cuda" and size > 1:
            _STATE["comm"] = peercoll.PeerComm(dev, rank, size)
    return Mesh(device=dev, size=size, index=rank, comm=_STATE["comm"], hosts=hosts)


def shutdown() -> None:
    """Close the group's peer communicator, then leave the group."""
    if dist.is_initialized():
        if _STATE["comm"] is not None:
            _STATE["comm"].close()
        dist.destroy_process_group()
    _STATE.update(device=None, comm=None, host_names=None, hosts=None)


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


def _rank_main(rank, n, coordinator, device, fn, args, timeout_s, hosts=1):
    """One rank: join the group (as a rank of emulated host rank // (n //
    hosts)), run fn(mesh, *args), leave; rank 0's result (the others
    return None)."""
    dev = "cpu" if str(device) == "cpu" else f"cuda:{rank}"
    host = f"{socket.gethostname()}/{rank // (n // hosts)}"
    if hosts > 1 and dev != "cpu":
        # NCCL too tells the emulated hosts apart: between them it takes its
        # network transport (sockets over loopback), as between machines
        os.environ["NCCL_HOSTID"] = host
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init_distributed(coordinator, n, rank, dev, timeout_s=timeout_s, host=host)
    result = fn(make_mesh(), *args)
    shutdown()
    return result if rank == 0 else None


def run_ranks(fn, n: int, device=None, args=(), timeout_s: float = DEFAULT_TIMEOUT_S,
              collective_timeout_s: Optional[float] = None, hosts: int = 1):
    """Run fn(mesh, *args) on `n` ranks, each a spawned process
    (spawn_each): rank r on cuda:r over NCCL (device None or "cuda";
    without a card it raises), or on the CPU over gloo when asked (device
    "cpu").  The ranks act as `hosts` emulated hosts of n // hosts ranks
    each, rank r on host r // (n // hosts): over several, make_mesh gives a
    Mesh of two levels, as on as many machines, and on the card NCCL too
    is told the hosts apart (NCCL_HOSTID) and crosses them over its
    sockets on loopback (NCCL_SOCKET_IFNAME "lo" unless set).  Real
    hosts join through torchrun --nnodes, or init_distributed with a
    coordinator, as the CLI does under WORLD_SIZE.  `fn` must be a
    module-level function, and what it returns picklable.  Returns rank
    0's result.  A failing rank fails the run with its traceback; past
    `timeout_s` every rank is stopped and the run raises TimeoutError.
    Each rank runs torch on one thread."""
    from fish_eye_bundle_adjustment_tpu_torch.solver.dense import resolve_device

    if hosts < 1 or n % hosts:
        raise ValueError(f"run_ranks: {n} ranks do not make {hosts} hosts of equal size")
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
        return spawn_each(_rank_main, [(r, n, coordinator, device, fn, args, coll_s, hosts)
                                       for r in range(n)],
                          timeout_s, threads=1, what="run_ranks")[0]
