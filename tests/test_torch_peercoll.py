"""The mesh's peer collectives (ops/peercoll.py) on the CPU: their plain
versions, which the CUDA kernels of ops/csrc/peercoll.cu match bit for bit
on the card (tests/test_torch_peercoll_cuda.py, chip_smoke.py), and the
wrappers' refusal to fall back.

The plain versions run on groups of 2 and 4 gloo ranks
(tests/_torch_dist_worker.py, no jax), the larger calls past the
workspace in chunks: each result must equal a numpy rank-ordered sum
(((x_0 + x_1) + x_2) + ...) or concatenation of every rank's input
exactly."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_dist_worker import peer_inputs, run_group
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
        per = peercoll.WORKSPACE_BYTES // (x.itemsize * rows)
        assert calls == max(1, -(-(x.size // rows) // per)), name
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
