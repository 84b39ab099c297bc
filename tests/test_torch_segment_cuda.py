"""The K4 chunk-prefix kernel on the card (marked gpu; skipped without one).

This file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_segment_cuda.py

(--noconftest: tests/conftest.py sets up JAX for the other test files.)
Whether there is a card is decided inside each test.

Tolerances: the kernel against its plain PyTorch version (torch's cumsum
per chunk) on the same inputs at relative norm <= 1e-12 in float64 and
<= 1e-5 in float32 -- only the order of the additions inside a chunk
differs -- and bitwise-equal output on a repeated launch (no atomics).
A segment sum and an unfused solve on the card against the same on the
CPU: x within rtol=1e-9, atol=1e-7 in float64."""

import numpy as np
import pytest
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import prefix, segment
from fish_eye_bundle_adjustment_tpu_torch.solver import schur
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.cpu().double(), want.cpu().double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def _check_prefix(vals):
    """Two launches on vals: counted (in total and at its width), within
    the tolerance of the plain version, bitwise repeatable."""
    n, d = vals.shape
    prefix.reset_counts()
    got, tot = prefix.chunk_prefix(vals)
    again, _ = prefix.chunk_prefix(vals)
    assert prefix.kernel_launches["chunk_prefix"] == 2
    assert prefix.kernel_launches_by_width == {d: 2}
    assert prefix.plain_calls["chunk_prefix"] == 0
    want, want_tot = prefix.chunk_prefix_ref(vals)
    assert got.dtype == vals.dtype and tuple(tot.shape) == (n // prefix.CHUNK, d)
    assert _rel(got, want) <= TOL[vals.dtype]
    assert _rel(tot, want_tot) <= TOL[vals.dtype]
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8, 21, 33])
def test_kernel_matches_plain(d, dtype):
    dev = _card()
    rng = np.random.default_rng(d)
    _check_prefix(torch.as_tensor(rng.standard_normal((5 * prefix.CHUNK, d)), dtype=dtype,
                                  device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_chunks,d", [(1, 6), (1, 21), (300, 3), (300, 6), (300, 21)])
def test_kernel_chunk_counts_mixed_magnitudes(n_chunks, d, dtype):
    """One chunk and 300 chunks, values of either sign from 1e-3 to 1e3."""
    dev = _card()
    rng = np.random.default_rng(n_chunks * d)
    mag = 10.0 ** rng.uniform(-3, 3, (n_chunks * prefix.CHUNK, d))
    vals = mag * rng.choice([-1.0, 1.0], mag.shape)
    _check_prefix(torch.as_tensor(vals, dtype=dtype, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 3, 6])
def test_kernel_base_not_16_byte_aligned(d, dtype):
    """A contiguous view one element into its storage: copied from the
    aligned block below it and read at the offset."""
    dev = _card()
    rng = np.random.default_rng(d + 7)
    flat = torch.as_tensor(rng.standard_normal(3 * prefix.CHUNK * d + 1), dtype=dtype, device=dev)
    vals = flat[1:].view(3 * prefix.CHUNK, d)
    assert vals.data_ptr() % 16
    _check_prefix(vals)


def test_segment_sum_on_card_matches_cpu():
    dev = _card()
    rng = np.random.default_rng(3)
    n, n_seg = 3 * prefix.CHUNK + 100, 500
    ids = np.sort(rng.integers(0, n_seg, size=n))
    vals = rng.standard_normal((n, 6))
    layout_cpu = segment.SegmentLayout.from_sorted_ids(ids, n_seg)
    layout_dev = segment.SegmentLayout.from_sorted_ids(ids, n_seg, dev)
    want = segment.sorted_segment_sum(torch.from_numpy(vals), layout_cpu)
    got = segment.sorted_segment_sum(torch.from_numpy(vals).to(dev), layout_dev)
    assert _rel(got, want) <= 1e-12


def test_kernel_entry_raises_on_inputs_it_does_not_take():
    dev = _card()
    ok = torch.zeros((prefix.CHUNK, 3), device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        prefix.chunk_prefix_kernel(ok.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        prefix.chunk_prefix_kernel(torch.zeros((prefix.CHUNK, 6), device=dev)[:, ::2])
    with pytest.raises(ValueError, match="dtype"):
        prefix.chunk_prefix_kernel(ok.half())
    with pytest.raises(ValueError, match="N % 4096"):
        prefix.chunk_prefix_kernel(ok[:100])
    with pytest.raises(ValueError, match="D >= 1"):
        prefix.chunk_prefix_kernel(torch.zeros((prefix.CHUNK, 0), device=dev))
    with pytest.raises(ValueError, match="shared memory"):  # 4 rows of 4000 doubles, twice
        prefix.chunk_prefix_kernel(torch.zeros((prefix.CHUNK, 4000), dtype=torch.float64,
                                               device=dev))


def test_unfused_solve_on_card_matches_cpu():
    dev = _card()
    p = make_block(n_img=12, n_pts=150, model="fisheye", seed=13, control_frac=0.08,
                   settings_overrides={"inner_constraints": False}).problem
    opts = schur.SchurOptions(explicit_s=False)
    prefix.reset_counts()
    on_card = schur.solve_schur(p, opts, compute_covariance=False, device=dev)
    cg = on_card.cg_iterations
    assert prefix.kernel_launches["chunk_prefix"] == 6 * len(cg) + 2 * sum(cg)
    # tie sums of 3 columns, image sums of 6, the pose preconditioner's 21
    assert prefix.kernel_launches_by_width == {
        3: sum(cg) + 2 * len(cg), 6: sum(cg) + 3 * len(cg), 21: len(cg)}
    assert prefix.plain_calls["chunk_prefix"] == 0
    on_cpu = schur.solve_schur(p, opts, compute_covariance=False, device="cpu")
    assert on_card.iterations == on_cpu.iterations
    assert on_card.cg_iterations == on_cpu.cg_iterations
    np.testing.assert_allclose(on_card.x, on_cpu.x, rtol=1e-9, atol=1e-7)
