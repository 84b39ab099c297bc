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
summed in that order.  A call larger than the communicator's workspace runs
in chunks of columns, one launch (or one plain call) each, through the same
loop on either route.

Each function dispatches on the device of its input: a CPU tensor runs the
plain version; a CUDA tensor launches the kernel of ops/csrc/peercoll.cu on
the communicator's peer memory or raises -- it never falls back to NCCL or
to the plain version, whether the library does not build, the peers'
memory does not open, or a rank never arrives (the kernel's wait is
bounded: past `PeerComm.spin_s` it gives up, and `check` raises).

A `PeerComm` is one rank's communicator: on a card it allocates the rank's
workspace (two halves of WORKSPACE_BYTES) and flags in the C source, and
exchanges the IPC handles over the process group (`dist.all_gather_object`)
once, before any capture; every rank must see every card.  Its calls must
be stream-ordered, in the same sequence on every rank.  On the CPU it holds
only what the plain versions need (rank and size).

Nothing here runs at import; the library is built at the first
communicator on a card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.distributed as dist

from fish_eye_bundle_adjustment_tpu_torch.utils.cudagraph import count_launch

# bytes of one half of a rank's workspace: the most one launch moves per rank
# (the Hcc blocks at 36 x n_img float64 are 288 KB at 1,000 images)
WORKSPACE_BYTES = 4 << 20
# seconds a launch waits for the other ranks before it gives up
SPIN_S = 120.0

_OPS = {"all_reduce": 0, "reduce_scatter": 1, "all_gather": 2}
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


class PeerComm:
    """One rank's communicator over the default process group: `size`
    ranks, this one `rank`, on `device`; a launch waits `spin_s` seconds
    for the other ranks before it gives up."""

    def __init__(self, device, rank: int, size: int, spin_s: float = SPIN_S):
        self.device = torch.device(device)
        self.rank, self.size = rank, size
        self.spin_s = spin_s
        self.handle: Optional[int] = None  # the C communicator, on a card
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
        _build.check(lib.peercoll_create(index, self.rank, self.size, WORKSPACE_BYTES,
                                         self.spin_s, ctypes.byref(comm), ipc),
                     "peercoll_create")
        self.handle = comm.value
        try:
            handles = [None] * self.size
            dist.all_gather_object(handles, ipc.raw)
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
        dist.barrier()
        _build.check(_build.load().peercoll_destroy(self.handle), "peercoll_destroy")
        self.handle = None


def all_reduce(x, comm: PeerComm):
    """The sum over the ranks of x, in rank order: a new tensor of x's
    shape, equal on every rank."""
    return _run("all_reduce", x, comm)


def reduce_scatter(x, comm: PeerComm):
    """The sum over the ranks of x (size * m, ...), then this rank's rows
    [rank * m, (rank + 1) * m)."""
    return _run("reduce_scatter", x, comm)


def all_gather(x, comm: PeerComm):
    """Every rank's x (m, ...) stacked along dim 0 in rank order."""
    return _run("all_gather", x, comm)


def plain(op: str, x, comm: PeerComm):
    """The plain version of collective `op` ("all_reduce",
    "reduce_scatter" or "all_gather") on x's device, in the kernel's
    chunks: what the CPU runs, and what chip_smoke.py and the card's tests
    hold the kernels against."""
    return _run(op, x, comm, route=_plain)


def _run(op, x, comm, route=None):
    """Shape the call as columns (reduce-scatter: `size` rows of them),
    cut it into chunks that fit one half of the workspace, and run each
    chunk as a launch of the kernel (a CUDA tensor) or a plain call (the
    CPU)."""
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
    per = max(1, WORKSPACE_BYTES // (x.element_size() * rows_in))
    chunks = [(c, min(per, cols - c)) for c in range(0, cols, per)]
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
    for c, w in chunks:
        code = lib.peercoll_run(comm.handle, _OPS[op], _DTYPES[x.dtype],
                                x.data_ptr() + c * elem, cols, out.data_ptr() + c * elem,
                                cols, w, stream)
        _build.check(code, f"peer {op}")
        count_launch(kernel_launches, f"peer_{op}", x.device)
    return out


def _gather(t, comm):
    """Every rank's t in rank order, over the process group (through the
    host on a gloo group)."""
    via_host = t.device.type == "cpu" or dist.get_backend() == "gloo"
    src = t.cpu() if via_host else t
    parts = [torch.empty_like(src) for _ in range(comm.size)]
    dist.all_gather(parts, src.contiguous())
    return [p.to(t.device) for p in parts]


def _plain(op, x, comm, cols, chunks):
    """The plain version: per chunk, a gather of the ranks' values, then
    the rank-ordered sum (or the rows placed)."""
    rows_in = comm.size if op == "reduce_scatter" else 1
    src = x.reshape(rows_in, cols)
    rows_out = comm.size if op == "all_gather" else 1
    out = torch.empty((rows_out, cols), dtype=x.dtype, device=x.device)
    for c, w in chunks:
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
