"""The port's streaming segment sum (ops/streamseg.py, K3) against the JAX
package's (ops/attic/streamseg.py), on the CPU.

The port's K3 runs as its plain version here (the CUDA kernel needs a
card: tests/test_torch_probes_cuda.py); the JAX Pallas kernel runs in
interpret mode, as tests/test_streamseg.py runs it.  The cases and the
tolerance (rtol 2e-5, atol 1e-5) are that file's.  The plans are
host-side numpy arrays: equal exactly, field for field."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fish_eye_bundle_adjustment_tpu.ops.attic import streamseg as jss
from fish_eye_bundle_adjustment_tpu_torch.ops import streamseg as tss

CASES = [
    (4096, 300, 8, 128),
    (5000, 700, 5, 64),  # non-128 D, partial last group
    (2000, 2000, 3, 128),  # all length-1 segments
]
EMPTY = (np.array([0, 3, 3, 7]), np.array([3, 3, 7, 9]))  # segment 1 has no rows


def _bounds(n, n_seg):
    rng = np.random.default_rng(n + n_seg)
    ids = np.sort(rng.integers(0, n_seg, n)).astype(np.int32)
    starts = np.searchsorted(ids, np.arange(n_seg + 1)).astype(np.int32)
    return rng, starts[:-1], starts[1:]


def _same_plan(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name
    assert a.G == b.G and a.read_amplification == b.read_amplification


@pytest.mark.parametrize("n,n_seg,d,m", CASES)
def test_plan_identical(n, n_seg, d, m):
    _, begs, ends = _bounds(n, n_seg)
    _same_plan(tss.GroupedSegPlan.build(begs, ends, M=m), jss.GroupedSegPlan.build(begs, ends, M=m))


def test_plan_identical_with_empty_segments():
    _same_plan(tss.GroupedSegPlan.build(*EMPTY), jss.GroupedSegPlan.build(*EMPTY))


def test_plan_rejects_what_jax_rejects():
    # one hot segment: the same worst-case span T in both messages
    begs, ends = np.array([0, 70_000]), np.array([70_000, 70_001])
    with pytest.raises(jss.GroupTooWide) as want:
        jss.GroupedSegPlan.build(begs, ends)
    with pytest.raises(tss.GroupTooWide) as got:
        tss.GroupedSegPlan.build(begs, ends)
    assert str(got.value) == str(want.value)
    assert issubclass(tss.GroupTooWide, ValueError)
    # segments that do not tile [0, n_rows) contiguously
    for begs, ends in ((np.array([1, 3]), np.array([3, 5])), (np.array([0, 2]), np.array([3, 5]))):
        with pytest.raises(ValueError, match="contiguous"):
            jss.GroupedSegPlan.build(begs, ends)
        with pytest.raises(ValueError, match="contiguous"):
            tss.GroupedSegPlan.build(begs, ends)


@pytest.mark.parametrize("n,n_seg,d,m", CASES)
def test_plain_matches_interpret_mode(n, n_seg, d, m):
    rng, begs, ends = _bounds(n, n_seg)
    x = rng.standard_normal((n, d)).astype(np.float32)
    want = np.asarray(jss.sorted_segment_sum_streaming(
        jnp.asarray(x), jss.GroupedSegPlan.build(begs, ends, M=m), interpret=True))
    plan = tss.GroupedSegPlan.build(begs, ends, M=m)
    tss.reset_counts()
    got = tss.sorted_segment_sum_streaming(torch.from_numpy(x), plan)
    assert tss.plain_calls["span_segment_sum"] == 1
    assert tss.kernel_launches["span_segment_sum"] == 0
    assert tuple(got.shape) == (n_seg, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    # the transposed entry on the (D, N) stream: the same sums
    assert torch.equal(tss.streaming_segment_sum_t(torch.from_numpy(x.T.copy()), plan), got.T)


def test_empty_segments_match_interpret_mode():
    x = np.ones((9, 4), np.float32)
    want = np.asarray(jss.sorted_segment_sum_streaming(
        jnp.asarray(x), jss.GroupedSegPlan.build(*EMPTY), interpret=True))
    got = tss.sorted_segment_sum_streaming(torch.from_numpy(x), tss.GroupedSegPlan.build(*EMPTY))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.zeros(4))


def test_plan_arrays_built_once_per_device():
    _, begs, ends = _bounds(4096, 300)
    plan = tss.GroupedSegPlan.build(begs, ends)
    arrays = plan.on("cpu")
    assert plan.on(torch.device("cpu")) is arrays
    assert arrays.rel.dtype == torch.int32
    assert np.array_equal(arrays.rel.numpy(), plan.rel.astype(np.int32))
    # each owned row's output column: its group's block plus its slot
    assert np.array_equal(arrays.col.numpy(), np.searchsorted(ends, np.arange(4096), side="right"))


def test_entries_raise_off_the_cpu_without_a_kernel():
    _, begs, ends = _bounds(4096, 300)
    plan = tss.GroupedSegPlan.build(begs, ends)
    x = torch.zeros((8, 4096))
    with pytest.raises(ValueError, match="CUDA"):
        tss.streaming_segment_sum_t_kernel(x, plan)
    with pytest.raises(ValueError, match="CUDA"):
        tss.streaming_segment_sum_t(x.to("meta"), plan)
    ids = torch.zeros(4096, dtype=torch.int32)
    r = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tss.span_segment_sum(x.T, ids, r, r, None, torch.zeros((1, 4, 8)))
