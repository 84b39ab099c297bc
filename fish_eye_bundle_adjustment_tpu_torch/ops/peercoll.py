"""The mesh's collectives as CUDA kernels over peer memory, and their plain
versions.

No Pallas kernel stands behind this module: the JAX package's parallel
solvers take XLA's ``psum``, ``psum_scatter`` and ``all_gather``
(fish_eye_bundle_adjustment_tpu/parallel/mesh.py).  The port's Mesh
(parallel/mesh.py) takes them here on the card over several ranks, so that
a GN step captured as a CUDA graph holds its collectives inside the IF
nodes of its CG blocks and step (solver/device_loop.py), where NCCL's do
not capture.

    all_reduce(x, comm): x on every rank -> the sum over the ranks
    reduce_scatter(x, comm): x (size * m, ...) -> this rank's (m, ...) slice of the sum
    all_gather(x, comm): x (m, ...) -> (size * m, ...), rank q's x at rows q * m...

for float32 and float64.  Every rank sums the ranks' values in rank order
(((x_0 + x_1) + x_2) + ...), so every rank holds the same bits, and so does
the plain version: the ranks' tensors gathered over the process group, then
summed in that order.

`plan` cuts a call into chunks of columns that fit one half of the
communicator's workspace and gives each its schedule and grid
(ops/csrc/peercoll.cu): the all-reduce one-shot ("push") up to
TWO_SHOT_BYTES and two-shot past it, the reduce-scatter "push", the
all-gather "pull"; one launch (or one plain call) a chunk, through the same
loop on either route.

Each function dispatches on the device of its input: a CPU tensor runs the
plain version; a CUDA tensor launches the kernel of ops/csrc/peercoll.cu on
the communicator's peer memory or raises -- it never falls back to NCCL or
to the plain version, whether the library does not build, the peers'
memory does not open, or a rank never arrives (the kernel's wait is
bounded: past `PeerComm.spin_s` it gives up, and `check` raises).

A `PeerComm` is one rank's communicator over a process group (the default
one, or a subgroup: over several hosts, the ranks of one host,
parallel/mesh.py): on a card it allocates the rank's workspace (two halves
of `workspace_bytes`) and flags in the C source, and exchanges the IPC
handles over its group (`dist.all_gather_object`) once, before any
capture; every rank of the group must see every card of the group, so a
group never spans hosts.  Its calls must
be stream-ordered, in the same sequence on every rank.  On the CPU it holds
only what the plain versions and the plan need.

Nothing here runs at import; the library is built at the first
communicator on a card.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

from fish_eye_bundle_adjustment_tpu_torch.utils.cudagraph import count_launch

# bytes of one half of a rank's workspace, the most one launch takes: a
# 4-rank reduce-scatter of BASELINE configs[5]'s tie sums (23.5 MB a rank in
# float64) in one launch, and two halves of it a rank
WORKSPACE_BYTES = 96 << 20
# the all-reduce runs one-shot up to this many bytes a rank, two-shot past it:
# over 4 H100s one-shot took 0.0149 ms at 512 KiB against two-shot's 0.0169,
# two-shot 0.0189 at 1 MiB against one-shot's 0.0201 (PERF.md)
TWO_SHOT_BYTES = 768 << 10
# bytes of a CTA's share: the grid is a rank's rows (two-shot: its slice)
# over this, at most the communicator's max_grid (one wave of the card); at
# 16 KiB the calls of 54-512 KB ran 9-12% slower (PERF.md)
CTA_BYTES = 4 << 10
# seconds a launch waits for the other ranks before it gives up
SPIN_S = 120.0

_OPS = {"all_reduce": 0, "reduce_scatter": 1, "all_gather": 2}
SCHEDULES = {"pull": 0, "push": 1, "two_shot": 2}
# the schedules each collective takes: the sums push (remote stores beat
# remote loads over 4 H100s at every size measured, PERF.md)
TAKES = {"all_reduce": ("push", "two_shot"), "reduce_scatter": ("push",),
         "all_gather": ("pull",)}
_DTYPES = {torch.float32: 0, torch.float64: 1}
_HANDLE_BYTES = 64

# Launch counts: the wrappers add one where they launch the kernel
# (`kernel_launches`, through count_launch, so replays of a captured graph
# count what they ran) or run the plain version (`plain_calls`), a chunk each.
kernel_launches = {f"peer_{op}": 0 for op in _OPS}
plain_calls = {f"peer_{op}": 0 for op in _OPS}


def reset_counts() -> None:
    for d in (kernel_launches, plain_calls):
        for k in d:
            d[k] = 0


class Chunk(NamedTuple):
    start: int  # first column
    width: int  # columns
    schedule: str
    grid: int  # CTAs of its launch


def plan(op: str, cols: int, elem: int, size: int, half_bytes: int, max_grid: int,
         schedule: Optional[str] = None) -> List[Chunk]:
    """The launches of collective `op` over `cols` columns of `elem`-byte
    values on `size` ranks (reduce-scatter: `size` rows of them), with
    halves of `half_bytes` and at most `max_grid` CTAs: chunks of whole
    16-byte groups that fit a half, each with its schedule (`schedule`, or
    the default: all-reduce one-shot "push" up to TWO_SHOT_BYTES of x and
    "two_shot" past it, reduce-scatter "push", all-gather "pull") and grid
    (the bytes of a rank's rows, two-shot: of its slice, over CTA_BYTES;
    1 to max_grid).  Every rank computes the same plan; the plain
    versions run its chunks too."""
    vec = 16 // elem
    if schedule is None:
        schedule = {"all_reduce": "push" if cols * elem <= TWO_SHOT_BYTES else "two_shot",
                    "reduce_scatter": "push", "all_gather": "pull"}[op]
    if schedule not in TAKES[op]:
        raise ValueError(f"{op} takes the schedules {TAKES[op]}, not {schedule!r}")
    cap = half_bytes // elem  # values a half holds
    if schedule == "two_shot":  # size slices of the inbox and the result area
        per = cap // 2 // (size * vec) * (size * vec)
    else:
        rows = size if schedule == "push" else 1  # the inbox's slots
        per = cap // rows // vec * vec
    if per < 1:
        raise ValueError(f"a half of {half_bytes} bytes holds no chunk of {op} on {size} ranks")
    rows_io = 1 if op == "all_reduce" else size  # rows a rank reads or writes
    share = CTA_BYTES * (size if schedule == "two_shot" else 1)
    out = []
    for c in range(0, cols, per):
        w = min(per, cols - c)
        grid = min(max_grid, max(1, -(-(rows_io * w * elem) // share)))
        out.append(Chunk(c, w, schedule, grid))
    return out


class PeerComm:
    """One rank's communicator over process group `group` (None: the
    default one): `size` ranks, this one its rank `rank` there, on
    `device`, with halves of `workspace_bytes`; a launch waits `spin_s`
    seconds for the other ranks before it gives up."""

    def __init__(self, device, rank: int, size: int, spin_s: float = SPIN_S,
                 workspace_bytes: int = WORKSPACE_BYTES, group=None):
        self.device = torch.device(device)
        self.rank, self.size = rank, size
        self.group = group
        self.spin_s = spin_s
        self.workspace_bytes = workspace_bytes
        self.handle: Optional[int] = None  # the C communicator, on a card
        self.max_grid = 1  # CTAs a launch may take (on a card: one wave)
        if self.device.type == "cuda":
            self._open()

    def _open(self) -> None:
        from fish_eye_bundle_adjustment_tpu_torch.ops import _build

        lib = _build.load()
        if not 1 <= self.size <= lib.peercoll_max_ranks():
            raise ValueError(f"peer collectives take 1 to {lib.peercoll_max_ranks()} ranks, "
                             f"not {self.size}")
        index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        comm = ctypes.c_void_p()
        ipc = ctypes.create_string_buffer(_HANDLE_BYTES)
        _build.check(lib.peercoll_create(index, self.rank, self.size, self.workspace_bytes,
                                         self.spin_s, ctypes.byref(comm), ipc),
                     "peercoll_create")
        self.handle = comm.value
        try:
            self.max_grid = lib.peercoll_max_grid(self.handle)
            handles = [None] * self.size
            dist.all_gather_object(handles, ipc.raw, group=self.group)
            _build.check(lib.peercoll_open(self.handle, b"".join(handles)), "peercoll_open")
        except BaseException:
            lib.peercoll_destroy(self.handle)
            self.handle = None
            raise

    def check(self) -> None:
        """Raise if a launch of this communicator gave up waiting for a
        rank.  Reads the host-mapped error word: what the launches that
        have ended wrote."""
        if self.handle is None:
            return
        from fish_eye_bundle_adjustment_tpu_torch.ops import _build

        code = _build.load().peercoll_error(self.handle)
        if code:
            raise RuntimeError(
                f"peer collective on rank {self.rank}: waited more than {self.spin_s} s for "
                f"rank {code - 1} (a rank that stopped, or took another branch); the "
                "communicator is dead")

    def close(self) -> None:
        """Free the workspace and unmap the peers' once every rank's
        launches have ended (a synchronize, then a barrier of the group)."""
        if self.handle is None:
            return
        from fish_eye_bundle_adjustment_tpu_torch.ops import _build

        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        _build.check(_build.load().peercoll_destroy(self.handle), "peercoll_destroy")
        self.handle = None


def all_reduce(x, comm: PeerComm):
    """The sum over the ranks of x, in rank order: a new tensor of x's
    shape, equal on every rank."""
    return run("all_reduce", x, comm)


def reduce_scatter(x, comm: PeerComm):
    """The sum over the ranks of x (size * m, ...), then this rank's rows
    [rank * m, (rank + 1) * m)."""
    return run("reduce_scatter", x, comm)


def all_gather(x, comm: PeerComm):
    """Every rank's x (m, ...) stacked along dim 0 in rank order."""
    return run("all_gather", x, comm)


def plain(op: str, x, comm: PeerComm):
    """The plain version of collective `op` ("all_reduce",
    "reduce_scatter" or "all_gather") on x's device, in the kernel's
    chunks: what the CPU runs, and what chip_smoke.py and the card's tests
    hold the kernels against."""
    return run(op, x, comm, route=_plain)


def run(op, x, comm, schedule=None, route=None):
    """Collective `op` of x: shaped as columns (reduce-scatter: `size`
    rows of them), cut by `plan` (at `schedule`, or the default), each
    chunk a launch of the kernel (a CUDA tensor) or a plain call (the
    CPU, or `route`)."""
    size = comm.size
    if op == "reduce_scatter" and x.shape[0] % size:
        raise ValueError(f"reduce_scatter takes dim 0 a multiple of {size}, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"peer collectives take float32 or float64, got {x.dtype}")
    rows_in = size if op == "reduce_scatter" else 1
    cols = x.numel() // rows_in
    if op == "all_reduce":
        shape = tuple(x.shape)
    elif op == "reduce_scatter":
        shape = (x.shape[0] // size,) + tuple(x.shape[1:])
    else:
        shape = (x.shape[0] * size,) + tuple(x.shape[1:])
    chunks = plan(op, cols, x.element_size(), size, comm.workspace_bytes, comm.max_grid,
                  schedule)
    if route is None:
        route = _plain if x.device.type == "cpu" else _kernel
    return route(op, x, comm, cols, chunks).reshape(shape)


def _kernel(op, x, comm, cols, chunks):
    if x.device.type != "cuda":
        raise ValueError(f"the peer-collective kernels take a CUDA tensor, got {x.device}")
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    lib = _build.load()
    if comm.handle is None or comm.device != x.device:
        raise ValueError(f"no peer communicator open on {x.device} (the communicator is on "
                         f"{comm.device}, {'open' if comm.handle else 'not open'})")
    comm.check()
    x = x.contiguous()
    rows_out = comm.size if op == "all_gather" else 1
    out = torch.empty((rows_out, cols), dtype=x.dtype, device=x.device)
    elem = x.element_size()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for c, w, schedule, grid in chunks:
        code = lib.peercoll_run(comm.handle, _OPS[op], SCHEDULES[schedule], _DTYPES[x.dtype],
                                x.data_ptr() + c * elem, cols, out.data_ptr() + c * elem,
                                cols, w, grid, stream)
        _build.check(code, f"peer {op}")
        count_launch(kernel_launches, f"peer_{op}", x.device)
    return out


def _gather(t, comm):
    """Every rank's t in rank order, over the communicator's process group
    (through the host on a gloo group)."""
    via_host = t.device.type == "cpu" or dist.get_backend(comm.group) == "gloo"
    src = t.cpu() if via_host else t
    parts = [torch.empty_like(src) for _ in range(comm.size)]
    dist.all_gather(parts, src.contiguous(), group=comm.group)
    return [p.to(t.device) for p in parts]


def _plain(op, x, comm, cols, chunks):
    """The plain version: per chunk, a gather of the ranks' values, then
    the rank-ordered sum (or the rows placed)."""
    rows_in = comm.size if op == "reduce_scatter" else 1
    src = x.reshape(rows_in, cols)
    rows_out = comm.size if op == "all_gather" else 1
    out = torch.empty((rows_out, cols), dtype=x.dtype, device=x.device)
    for c, w, _, _ in chunks:
        parts = _gather(src[:, c : c + w], comm)
        if op == "all_gather":
            out[:, c : c + w] = torch.cat(parts)
        else:
            acc = parts[0].clone()
            for p in parts[1:]:
                acc += p
            out[:, c : c + w] = acc[comm.rank] if op == "reduce_scatter" else acc
        plain_calls[f"peer_{op}"] += 1
    return out
