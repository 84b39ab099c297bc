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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 21])
def test_kernel_matches_plain(d, dtype):
    dev = _card()
    rng = np.random.default_rng(d)
    vals = torch.as_tensor(rng.standard_normal((5 * prefix.CHUNK, d)), dtype=dtype, device=dev)
    prefix.reset_counts()
    got, tot = prefix.chunk_prefix(vals)
    again, _ = prefix.chunk_prefix(vals)
    assert prefix.kernel_launches["chunk_prefix"] == 2
    assert prefix.plain_calls["chunk_prefix"] == 0
    want, want_tot = prefix.chunk_prefix_ref(vals)
    assert got.dtype == dtype and tuple(tot.shape) == (5, d)
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(tot, want_tot) <= TOL[dtype]
    assert torch.equal(got, again)


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


def test_unfused_solve_on_card_matches_cpu():
    dev = _card()
    p = make_block(n_img=12, n_pts=150, model="fisheye", seed=13, control_frac=0.08,
                   settings_overrides={"inner_constraints": False}).problem
    opts = schur.SchurOptions(explicit_s=False)
    prefix.reset_counts()
    on_card = schur.solve_schur(p, opts, compute_covariance=False, device=dev)
    cg = on_card.cg_iterations
    assert prefix.kernel_launches["chunk_prefix"] == 6 * len(cg) + 2 * sum(cg)
    assert prefix.plain_calls["chunk_prefix"] == 0
    on_cpu = schur.solve_schur(p, opts, compute_covariance=False, device="cpu")
    assert on_card.iterations == on_cpu.iterations
    assert on_card.cg_iterations == on_cpu.cg_iterations
    np.testing.assert_allclose(on_card.x, on_cpu.x, rtol=1e-9, atol=1e-7)
