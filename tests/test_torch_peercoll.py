"""The mesh's peer collectives (ops/peercoll.py) on the CPU: their plain
versions, which the CUDA kernels of ops/csrc/peercoll.cu match bit for bit
on the card (tests/test_torch_peercoll_cuda.py, chip_smoke.py), and the
wrappers' refusal to fall back.

The plain versions run on groups of 2 and 4 gloo ranks
(tests/_torch_dist_worker.py, no jax), the larger calls past a 4 MiB
half in chunks: each result must equal a numpy rank-ordered sum
(((x_0 + x_1) + x_2) + ...) or concatenation of every rank's input
exactly.  `peercoll.plan`, which cuts every call on either route, is
checked against what the kernels' source needs of a half."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_dist_worker import PEER_CHUNKED_BYTES, peer_inputs, run_group
from fish_eye_bundle_adjustment_tpu_torch.ops import _build, peercoll


@pytest.fixture(scope="module")
def groups():
    return {n: run_group(n, {"peer": ("peer_plain", {})})["peer"] for n in (2, 4)}


def _want(op, xs, rank):
    if op == "all_gather":
        return np.concatenate(xs)
    acc = xs[0].copy()
    for x in xs[1:]:
        acc = acc + x
    if op == "reduce_scatter":
        m = acc.shape[0] // len(xs)
        return acc[rank * m : (rank + 1) * m]
    return acc


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [2, 4])
def test_plain_collectives_are_rank_ordered(groups, n, dtype):
    """Rank 0's result of every case equals the numpy rank-ordered sum
    (all-reduce; reduce-scatter, rank 0's rows) or concatenation
    (all-gather) of the ranks' inputs bit for bit, in the input's shape
    and type; calls past the workspace ran in as many chunks as fit."""
    got = groups[n]
    inputs = [peer_inputs(r, n, dtype) for r in range(n)]
    for name, (op, x) in inputs[0].items():
        res, calls = got[(name, dtype)]
        want = _want(op, [inp[name][1] for inp in inputs], 0)
        assert res.dtype == want.dtype and res.shape == want.shape, name
        np.testing.assert_array_equal(res, want, err_msg=name)
        rows = n if op == "reduce_scatter" else 1
        chunks = peercoll.plan(op, x.size // rows, x.itemsize, n, PEER_CHUNKED_BYTES, 1)
        assert calls == len(chunks), name
        if name.startswith("big"):
            assert calls > 1, name


def _no_library(monkeypatch, tmp_path):
    """The kernel library absent, and no compiler to build it."""
    def no_nvcc():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "missing.so")


def test_cuda_tensor_without_library_raises(monkeypatch, tmp_path):
    """A CUDA tensor goes to the kernel or raises: with no library built
    (no nvcc) each collective raises the build's error, runs no plain
    version and takes no collective of the process group; a communicator
    on a card cannot open."""
    _no_library(monkeypatch, tmp_path)

    def refuse(*a, **k):
        raise AssertionError("fell back to a process-group collective")

    for name in ("all_gather", "all_reduce", "all_gather_object", "reduce_scatter_tensor"):
        monkeypatch.setattr(peercoll.dist, name, refuse)
    peercoll.reset_counts()
    comm = peercoll.PeerComm("cpu", 0, 2)
    with FakeTensorMode():
        x = torch.zeros(8, device="cuda")
        for op in ("all_reduce", "reduce_scatter", "all_gather"):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                getattr(peercoll, op)(x, comm)
    assert not any(peercoll.plain_calls.values())
    assert not any(peercoll.kernel_launches.values())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        peercoll.PeerComm("cuda:0", 0, 2)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Reduce-scatter needs dim 0 a multiple of the ranks; only float32
    and float64 are summed."""
    comm = peercoll.PeerComm("cpu", 0, 2)
    with pytest.raises(ValueError, match="multiple of 2"):
        peercoll.reduce_scatter(torch.zeros(3), comm)
    with pytest.raises(ValueError, match="float32 or float64"):
        peercoll.all_reduce(torch.zeros(4, dtype=torch.int64), comm)


def _need(schedule, w, size, vec):
    """Values of a half one launch needs (peercoll_run in
    ops/csrc/peercoll.cu): the inbox's slots and the result area
    (two-shot), or the rows (push, pull)."""
    up = lambda v: -(-v // vec) * vec
    if schedule == "two_shot":
        return size * up(-(-w // size)) + w
    return (size if schedule == "push" else 1) * up(w)


PLAN_CASES = [
    # (op, columns, bytes a value, ranks, half bytes)
    ("all_reduce", 4, 8, 4, peercoll.WORKSPACE_BYTES),  # the step's stats
    ("all_reduce", 6_768, 8, 4, peercoll.WORKSPACE_BYTES),  # camera outputs
    ("all_reduce", 36_000, 8, 4, peercoll.WORKSPACE_BYTES),  # the Hcc blocks
    ("all_reduce", 295_572, 8, 4, peercoll.WORKSPACE_BYTES),  # the bench tie sum
    ("all_reduce", 2_969_994, 8, 4, peercoll.WORKSPACE_BYTES),  # configs[5]'s tie sum
    ("all_reduce", 2_969_994, 8, 8, peercoll.WORKSPACE_BYTES),
    ("reduce_scatter", 295_572, 8, 4, peercoll.WORKSPACE_BYTES),  # the tie sums
    ("reduce_scatter", 2_969_994, 8, 4, peercoll.WORKSPACE_BYTES),  # configs[5]'s
    ("reduce_scatter", 3_000, 8, 4, peercoll.WORKSPACE_BYTES),  # the pose sums
    ("all_gather", 515_728, 8, 4, peercoll.WORKSPACE_BYTES),  # the residual rows
    ("all_reduce", 1_300_001, 4, 2, PEER_CHUNKED_BYTES),
    ("all_reduce", 1_300_001, 8, 3, PEER_CHUNKED_BYTES),
    ("reduce_scatter", 700_001, 4, 4, PEER_CHUNKED_BYTES),
    ("all_gather", 1_400_002, 8, 2, PEER_CHUNKED_BYTES),
    ("all_reduce", 0, 4, 2, PEER_CHUNKED_BYTES),
]


@pytest.mark.parametrize("op, cols, elem, size, half", PLAN_CASES)
def test_plan_chunks_fit_a_half(op, cols, elem, size, half):
    """Every chunk of the plan fits a half as the kernels' source counts
    it; the chunks tile the columns in order from whole 16-byte groups
    (a two-shot chunk from whole slices of them); the grid is 1 to
    max_grid, more for larger chunks; every call of the solvers at
    configs[5]'s sizes (and the bench block's) runs in one launch at the
    default half over 4 ranks."""
    vec = 16 // elem
    max_grid = 264
    chunks = peercoll.plan(op, cols, elem, size, half, max_grid)
    assert [c.start for c in chunks] == list(range(0, cols, chunks[0].width if chunks else 1))
    assert sum(c.width for c in chunks) == cols
    for c in chunks:
        assert _need(c.schedule, c.width, size, vec) * elem <= half, c
        assert c.start % (size * vec if c.schedule == "two_shot" else vec) == 0, c
        assert 1 <= c.grid <= max_grid, c
    if half == peercoll.WORKSPACE_BYTES and size <= 4:
        assert len(chunks) == 1
    grids = [c.grid for c in chunks]
    assert grids == sorted(grids, reverse=True)  # the ragged last chunk no larger


@pytest.mark.parametrize("elem", [4, 8])
def test_plan_threshold_and_schedules(elem):
    """The all-reduce runs one-shot ("push") up to TWO_SHOT_BYTES of x
    and two-shot past it; the reduce-scatter pushes, the all-gather pulls
    (and nothing else: the sums do not pull); a schedule an op does not
    take raises; the grid grows with the bytes
    up to max_grid, one CTA for the smallest calls."""
    at = peercoll.TWO_SHOT_BYTES // elem
    plan = lambda op, cols, **k: peercoll.plan(op, cols, elem, 4, peercoll.WORKSPACE_BYTES,
                                               132, **k)
    assert plan("all_reduce", at)[0].schedule == "push"
    assert plan("all_reduce", at + 1)[0].schedule == "two_shot"
    assert plan("reduce_scatter", 10 * at)[0].schedule == "push"
    assert plan("all_gather", 10 * at)[0].schedule == "pull"
    assert plan("all_reduce", at, schedule="two_shot")[0].schedule == "two_shot"
    for op, schedule in (("all_gather", "push"), ("all_reduce", "pull"),
                         ("reduce_scatter", "pull")):
        with pytest.raises(ValueError, match="schedules"):
            plan(op, 10, schedule=schedule)
    with pytest.raises(ValueError, match="schedules"):
        plan("reduce_scatter", 10, schedule="two_shot")
    assert plan("all_reduce", 4)[0].grid == 1
    assert plan("all_reduce", 100 * at)[0].grid == 132
    grids = [plan("all_reduce", n)[0].grid for n in (at // 4, at, 4 * at)]
    assert grids == sorted(grids) and grids[0] < grids[-1]
