"""The port's segment sums (ops/segment.py) and chunk prefix (ops/prefix.py)
against the JAX package's, on the CPU.

The port's chunk prefix runs as its plain version here (the K4 CUDA kernel
needs a card: tests/test_torch_segment_cuda.py); the JAX Pallas kernel runs
in interpret mode.  Tolerances: 1e-12 relative norm in float64 and 1e-5
in float32 -- both sides take the same hierarchical prefix, so only the
summation order inside the cumsums can differ; the segment sums are
compared against the norm of the segment sums of |vals|, the scale their
rounding error is relative to (a segment sum itself may cancel to ~0).
Plans are host-side integer arrays: equal exactly."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_eye_bundle_adjustment_tpu.ops import segment as jseg
from fish_eye_bundle_adjustment_tpu.ops.attic import prefix as jprefix
from fish_eye_bundle_adjustment_tpu_torch.ops import prefix as tprefix
from fish_eye_bundle_adjustment_tpu_torch.ops import segment as tseg

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _rel(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref = np.linalg.norm(want if scale is None else scale)
    return np.linalg.norm(got - want) / max(ref, 1e-300)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 6, 21])
def test_chunk_prefix_ref_matches_pallas(d, dtype):
    rng = np.random.default_rng(d)
    vals = rng.standard_normal((2 * tprefix.CHUNK, d)).astype(dtype)
    want_p, want_t = jprefix.chunk_prefix_pallas(jnp.asarray(vals), interpret=True)
    tprefix.reset_counts()
    got_p, got_t = tprefix.chunk_prefix(torch.from_numpy(vals))
    assert tprefix.plain_calls["chunk_prefix"] == 1
    assert tprefix.kernel_launches["chunk_prefix"] == 0
    assert got_p.dtype == torch.from_numpy(vals).dtype
    assert tuple(got_p.shape) == vals.shape and tuple(got_t.shape) == (2, d)
    assert _rel(got_p, want_p) <= TOL[dtype]
    assert _rel(got_t, want_t) <= TOL[dtype]


def _sorted_ids(rng, n, n_seg):
    """Sorted ids in [0, n_seg + 2): some segments empty, some rows past the
    last segment (they must be ignored)."""
    ids = np.sort(rng.integers(0, n_seg + 2, size=n))
    ids[ids == n_seg // 3] = n_seg // 3 + 1  # an empty segment inside
    return np.sort(ids)


@functools.lru_cache(maxsize=None)
def _jax_segsum():
    return jax.jit(jseg.sorted_segment_sum)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 3, 6, 21])
def test_sorted_segment_sum_matches_jax(d, dtype):
    rng = np.random.default_rng(100 + d)
    n, n_seg = 3 * tprefix.CHUNK + 517, 700  # N not a multiple of CHUNK
    ids = _sorted_ids(rng, n, n_seg)
    vals = rng.standard_normal((n, d)).astype(dtype)
    want = _jax_segsum()(jnp.asarray(vals), jseg.SegmentLayout.from_sorted_ids(ids, n_seg))
    got = tseg.sorted_segment_sum(
        torch.from_numpy(vals), tseg.SegmentLayout.from_sorted_ids(ids, n_seg)
    )
    assert tuple(got.shape) == (n_seg, d) and got.dtype == torch.from_numpy(vals).dtype
    scale = np.zeros((n_seg, d))
    live = ids < n_seg
    np.add.at(scale, ids[live], np.abs(vals[live]).astype(np.float64))
    assert _rel(got, want, scale) <= TOL[dtype]
    # the exact answer, to the same bound
    assert _rel(got, _exact(ids, vals, n_seg), scale) <= TOL[dtype]
    assert not got[n_seg // 3].any()  # the empty segment sums to zero


def _exact(ids, vals, n_seg):
    out = np.zeros((n_seg, vals.shape[1]))
    live = ids < n_seg
    np.add.at(out, ids[live], vals[live].astype(np.float64))
    return out


def test_dual_axis_plan_matches_jax():
    rng = np.random.default_rng(7)
    n, n_tie, n_img = 5000, 800, 40
    tie = np.sort(rng.integers(0, n_tie + 1, size=n))
    img = rng.integers(0, n_img, size=n)
    want = jseg.DualAxisPlan.build(tie, n_tie + 1, img, n_img)
    got = tseg.DualAxisPlan.build(tie, n_tie + 1, img, n_img)
    assert np.array_equal(got.perm.numpy(), np.asarray(want.perm))
    for side in ("primary", "secondary"):
        g, w = getattr(got, side), getattr(want, side)
        assert np.array_equal(g.begs.numpy(), np.asarray(w.begs)), side
        assert np.array_equal(g.ends.numpy(), np.asarray(w.ends)), side
    vals = rng.standard_normal((n, 6))
    assert np.allclose(got.secondary_sum(torch.from_numpy(vals)).numpy(),
                       _exact(img, vals, n_img), rtol=1e-12, atol=1e-12)
    assert np.allclose(got.primary_sum(torch.from_numpy(vals)).numpy(),
                       _exact(tie, vals, n_tie + 1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sorted_ids", [False, True])
def test_sort_plan_sums_by_id(sorted_ids):
    """SortPlan: the per-id sums of an unsorted (or already sorted) id
    column equal the exact sums."""
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 3, size=9000)
    if sorted_ids:
        ids = np.sort(ids)
    plan = tseg.SortPlan.build(ids, 3)
    vals = rng.standard_normal((9000, 5))
    np.testing.assert_allclose(plan.sum(torch.from_numpy(vals)).numpy(),
                               _exact(ids, vals, 3), rtol=1e-12, atol=1e-11)
