"""The span segment-sum (K3, probe W), row-gather, gather-contract and scatter
kernels on the card (marked gpu; skipped without one).

This file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_probes_cuda.py

(--noconftest: tests/conftest.py sets up JAX for the other test files.)
Whether there is a card is decided inside each test.

Tolerances: each kernel against its plain PyTorch version on the same
inputs.  The gathers only copy, so they are bitwise equal; the sums are
within 1e-5 relative norm in float32, since only the order of the
additions differs.  Every kernel repeats bit for bit on a second launch
(no atomics).  Sizes are small and ragged: stream lengths that are no
multiple of the chunk, empty segments, ids outside the table, a window
that a chunk's ids break."""

import numpy as np
import pytest
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import probes, streamseg

pytestmark = pytest.mark.gpu

TOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.cpu().double(), want.cpu().double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def _twice(fn, module, key):
    """Two launches of a kernel's wrapper, counted; (first, second)."""
    module.reset_counts()
    got, again = fn(), fn()
    torch.cuda.synchronize()
    assert module.kernel_launches[key] == 2
    assert module.plain_calls[key] == 0
    assert torch.equal(got, again), "not bitwise repeatable"
    return got


def _plan(rng, n, n_seg, m):
    ids = np.sort(rng.integers(0, n_seg, n))
    starts = np.searchsorted(ids, np.arange(n_seg + 1))
    return streamseg.GroupedSegPlan.build(starts[:-1], starts[1:], M=m)


@pytest.mark.parametrize("n,n_seg,d,m", [
    (4096, 300, 8, 128),
    (5000, 700, 5, 64),
    (2000, 2000, 3, 128),
    (60_000, 50, 8, 128),  # one group, a span of many tiles
])
def test_streaming_segment_sum_matches_plain(n, n_seg, d, m):
    dev = _card()
    rng = np.random.default_rng(n + n_seg)
    plan = _plan(rng, n, n_seg, m)
    x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=dev)
    xt = x.T.contiguous()
    got = _twice(lambda: streamseg.streaming_segment_sum_t(xt, plan),
                 streamseg, "span_segment_sum")
    want = streamseg.streaming_segment_sum_t_ref(xt, plan)
    assert tuple(got.shape) == (d, n_seg)
    assert _rel(got, want) <= TOL
    # the (N, D) stream read through its strides: the same sums, bitwise
    assert torch.equal(streamseg.sorted_segment_sum_streaming(x, plan), got.T)


def test_streaming_segment_sum_empty_segments_and_short_stream():
    dev = _card()
    plan = streamseg.GroupedSegPlan.build(np.array([0, 3, 3, 7]), np.array([3, 3, 7, 9]), M=128)
    got = streamseg.sorted_segment_sum_streaming(torch.ones((9, 4), device=dev), plan)
    assert torch.equal(got.cpu(), torch.tensor([[3.0] * 4, [0.0] * 4, [4.0] * 4, [2.0] * 4]))
    # a stream shorter than the plan is padded with zero rows; longer rows add nothing
    short = streamseg.sorted_segment_sum_streaming(torch.ones((7, 4), device=dev), plan)
    assert torch.equal(short[:, 0].cpu(), torch.tensor([3.0, 0.0, 4.0, 0.0]))
    long = streamseg.sorted_segment_sum_streaming(torch.ones((20, 4), device=dev), plan)
    assert torch.equal(long, got)


@pytest.mark.parametrize("chunk,W,c", [(100, 12, 4), (2048, 256, 8), (333, 40, 3)])
def test_window_segment_partials_matches_plain(chunk, W, c):
    dev = _card()
    rng = np.random.default_rng(chunk)
    n, n_seg = 5 * chunk + chunk // 3, 5 * W
    ids = np.sort(rng.integers(0, 2 * W, n))  # a chunk spans ~0.4 W ids...
    ids[2 * chunk - 5:] += 3 * W  # ...but chunk 1's last 5 rows lie past its window
    plan = probes.WindowPlan.build(ids, n_seg, chunk, W, dev)
    vals = torch.as_tensor(rng.standard_normal((n, c)).astype(np.float32), device=dev)
    got = _twice(lambda: probes.window_segment_partials(vals, plan), streamseg, "span_segment_sum")
    want = probes.window_segment_partials_ref(vals, plan)
    assert _rel(got, want) <= TOL
    sums = probes.window_segment_sum(vals, plan)
    assert _rel(sums, probes.window_combine(want, plan)) <= TOL


@pytest.mark.parametrize("c", [8, 4, 3, 1])
def test_gather_rows_bitwise_plain(c):
    dev = _card()
    rng = np.random.default_rng(c)
    n, n_tab = 10_007, 300
    idx = torch.as_tensor(rng.integers(-2, n_tab + 2, n).astype(np.int32), device=dev)
    tab = torch.as_tensor(rng.standard_normal((n_tab, c)).astype(np.float32), device=dev)
    got = _twice(lambda: probes.gather_rows(idx, tab), probes, "gather_rows")
    assert torch.equal(got, probes.gather_rows_ref(idx, tab))
    live = (idx >= 0) & (idx < n_tab)
    assert torch.equal(got[live], tab[idx[live].long()])
    assert not got[~live].any()
    # a table that is not 16-byte aligned takes the one-float path, same rows
    odd = torch.empty(n_tab * c + 1, device=dev)[1:].view(n_tab, c).copy_(tab)
    assert torch.equal(probes.gather_rows(idx, odd), got)


def test_gather_rows_window_bitwise_plain():
    dev = _card()
    rng = np.random.default_rng(5)
    chunk, W, n = 256, 32, 7 * 256
    ids_np = np.sort(rng.integers(0, 5 * W, n)).astype(np.int32)  # ~23 ids a chunk
    ids_np[3 * chunk + 100:] += 3 * W  # chunk 3 breaks its window: zero rows
    n_seg = 8 * W
    ids = torch.as_tensor(ids_np, device=dev)
    blk = torch.as_tensor((ids_np[::chunk] // W).astype(np.int32), device=dev)
    tab = torch.as_tensor(rng.standard_normal((n_seg + 2 * W, 8)).astype(np.float32), device=dev)
    got = _twice(lambda: probes.gather_rows(ids, tab, (blk, W)), probes, "gather_rows")
    assert torch.equal(got, probes.gather_rows_ref(ids, tab, (blk, W)))
    assert not got[3 * chunk + 100: 4 * chunk].any()


def test_gather_contract_matches_plain():
    dev = _card()
    rng = np.random.default_rng(11)
    n, n_tab = 9_001, 1024
    idx = torch.as_tensor(rng.integers(-1, n_tab + 1, n).astype(np.int32), device=dev)
    m = torch.as_tensor(rng.standard_normal((n, 24)).astype(np.float32), device=dev)
    tab = torch.as_tensor(rng.standard_normal((n_tab, 8)).astype(np.float32), device=dev)
    got = _twice(lambda: probes.gather_contract(idx, m, tab), probes, "gather_contract")
    assert tuple(got.shape) == (n, 4)
    assert _rel(got, probes.gather_contract_ref(idx, m, tab)) <= TOL


@pytest.mark.parametrize("round_bf16,partials", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("n,n_tab,chunk,c", [(10_000, 1024, 4096, 8), (5_555, 1500, 2048, 3)])
def test_scatter_rows_matches_plain(n, n_tab, chunk, c, round_bf16, partials):
    dev = _card()
    rng = np.random.default_rng(n_tab + c)
    idx = torch.as_tensor(rng.integers(-3, n_tab + 3, n).astype(np.int32), device=dev)
    vals = torch.as_tensor(rng.standard_normal((n, c)).astype(np.float32), device=dev)
    args = (idx, vals, n_tab, chunk, round_bf16, partials)
    got = _twice(lambda: probes.scatter_rows(*args), probes, "scatter_rows")
    want = probes.scatter_rows_ref(*args)
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


def test_kernels_raise_on_inputs_they_do_not_take():
    dev = _card()
    idx = torch.zeros(64, dtype=torch.int32, device=dev)
    tab = torch.zeros((16, 8), device=dev)
    vals = torch.zeros((64, 8), device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        probes.gather_rows_kernel(idx.cpu(), tab)
    with pytest.raises(ValueError, match="int32"):
        probes.gather_rows_kernel(idx.long(), tab)
    with pytest.raises(ValueError, match="contiguous"):
        probes.gather_rows_kernel(idx, torch.zeros((16, 16), device=dev)[:, ::2])
    with pytest.raises(ValueError, match="equal chunks"):
        probes.gather_rows_kernel(idx, tab, (torch.zeros(3, dtype=torch.int32, device=dev), 8))
    with pytest.raises(ValueError, match=r"\(N, 24\)"):
        probes.gather_contract_kernel(idx, torch.zeros((64, 12), device=dev), tab)
    with pytest.raises(ValueError, match="aligned"):
        m = torch.zeros(64 * 24 + 1, device=dev)[1:].view(64, 24)
        probes.gather_contract_kernel(idx, m, tab)
    with pytest.raises(ValueError, match="float32"):
        probes.scatter_rows_kernel(idx, vals.double(), 16, 32)
    with pytest.raises(ValueError, match="1..8"):
        probes.scatter_rows_kernel(idx, torch.zeros((64, 9), device=dev), 16, 32)
    with pytest.raises(ValueError, match="shared memory"):  # a chunk's ids past 227 KB
        probes.scatter_rows_kernel(idx, vals, 16, 100_000)
    ids = torch.zeros(64, dtype=torch.int32, device=dev)
    r = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        streamseg.span_segment_sum(vals.double(), ids, r, r, None, torch.zeros((1, 4, 8), device=dev))
    with pytest.raises(ValueError, match="do not fit"):
        streamseg.span_segment_sum(vals, ids, r, r, None, torch.zeros((1, 4, 7), device=dev))
    with pytest.raises(ValueError, match="shared memory"):  # S * D slots past 227 KB
        streamseg.span_segment_sum(vals, ids, r, r, None, torch.zeros((1, 60_000, 8), device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        streamseg.streaming_segment_sum_t_kernel(vals.T.cpu(), _plan(np.random.default_rng(0), 64, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        streamseg.streaming_segment_sum_t(vals.T.to("meta"), _plan(np.random.default_rng(0), 64, 8, 4))
