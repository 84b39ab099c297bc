"""The gather / scatter probes' plain versions (ops/probes.py) against the
numpy references of bench_pallas_gather.py (P1) and bench_pallas_onehot.py
(P2), on the CPU.

The P1 and P2 Pallas kernels are defined inside the ``main()`` of their
scripts, on TPU memory spaces (VMEM blocks, scalar prefetch): no test can
call them, in interpret mode or otherwise.  So each plain version is held
against the numpy reference its script asserts or prints with
(bench_pallas_gather.py:48,159,203; bench_pallas_onehot.py:52,91,140,203)
at N = 8192 rows, through the twins' own probe setup (bench_torch_*.py)
and with the script's tolerance where it asserts; the gathers exactly.
W and P are also held against a numpy emulation of their kernel bodies,
``(cols == ids) @ x`` per chunk, with one chunk whose ids break the
window, which pins down the rows that W drops and P zeroes.  F is held
against the values rounded to bf16 (nearest even).  The CUDA kernels:
tests/test_torch_probes_cuda.py."""

import functools

import numpy as np
import pytest
import torch

import bench_torch_pallas_gather as tg
import bench_torch_pallas_onehot as to
from fish_eye_bundle_adjustment_tpu_torch.ops import probes, streamseg
from fish_eye_bundle_adjustment_tpu_torch.utils import cudatime

CPU = torch.device("cpu")
N = 8192
N_TIE = to.N_TIE * N // to.N  # the scripts' id density: ~207 ids a chunk of 2048


@functools.lru_cache(maxsize=None)
def _probes():
    found = {p.name: p for p in tg.make_probes(CPU, "ABCDEF", n=N)}
    found.update((p.name, p) for p in to.make_probes(CPU, "GS", n=N)[0])
    return found


def _bf16(x):
    """float32 values rounded to bf16, nearest even, kept as float32."""
    u = x.view(np.uint32).astype(np.uint64)
    return (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("name", ["A", "B", "C", "D", "E", "G", "S"])
def test_plain_matches_script_reference(name):
    p = _probes()[name]
    probes.reset_counts()
    got = p.call()
    assert sum(probes.plain_calls.values()) == 1 and not any(probes.kernel_launches.values())
    assert torch.equal(got, p.plain())
    out = p.result(got).numpy()
    assert out.shape == p.ref.shape
    if p.exact:  # the gathers: the table's rows themselves
        np.testing.assert_array_equal(out, p.ref)
    # the script's assert_allclose where it asserts (A-C, D, E); S's sum of
    # partials to the same 1e-5 as D
    np.testing.assert_allclose(out, p.ref, **(p.ref_tol or dict(rtol=1e-5, atol=1e-5)))


def test_f_sums_values_rounded_to_bf16():
    p = _probes()["F"]
    rng = np.random.default_rng(0)
    img_np = rng.integers(0, tg.N_IMG, N).astype(np.int32)
    vals_np = tg.normal((N, 8))
    want = np.zeros((tg.N_IMG, 8))
    np.add.at(want, img_np, _bf16(vals_np).astype(np.float64))
    out = p.result().numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    # ...which is off the exact float32 sums by the bf16 rounding the script prints
    assert 1e-4 < cudatime.ref_error(p, out) < 1e-2
    assert np.array_equal(_bf16(vals_np), torch.from_numpy(vals_np).bfloat16().float().numpy())


def _sorted_stream(rng, n, n_seg, chunk, break_chunk=None, jump=0):
    ids = np.sort(rng.integers(0, n_seg, n)).astype(np.int32)
    if break_chunk is not None:  # that chunk's last 100 rows jump past its window
        ids[(break_chunk + 1) * chunk - 100:] += jump
    return ids


def _onehot(local, W):
    """The W and P kernel bodies' one-hot, (cols == local ids) over W
    columns, in float64."""
    return (np.arange(W)[None, :] == local[:, None]).astype(np.float64)


def _rel_max(got, want):
    """bench_pallas_onehot.py's printed error: max |got - want| over the
    larger of max |want| and 1.  W's combine is a sorted segment sum, a
    difference of prefix sums over 4096 partial rows, so its float32
    rounding is relative to those prefixes: held to 1e-5 of the sums'
    scale, not elementwise."""
    return np.abs(got - want).max() / max(np.abs(want).max(), 1)


def test_w_matches_script_reference():
    rng = np.random.default_rng(1)
    ids = _sorted_stream(rng, N, N_TIE, to.CHUNK)
    assert to._span(ids, to.CHUNK) <= to.W  # the window holds, as at the script's size
    vals = tg.normal((N, 8))
    plan = probes.WindowPlan.build(ids, N_TIE, to.CHUNK, to.W)
    streamseg.reset_counts()
    got = probes.window_segment_sum(torch.from_numpy(vals), plan)
    assert streamseg.plain_calls["span_segment_sum"] == 1
    want = np.zeros((N_TIE, 8), np.float32)
    np.add.at(want, ids, vals)
    assert tuple(got.shape) == (N_TIE, 8)
    assert _rel_max(got.numpy(), want) <= 1e-5


def test_w_partials_match_onehot_emulation_and_drop_rows_past_the_window():
    rng = np.random.default_rng(2)
    W = to.W
    ids = _sorted_stream(rng, N, N_TIE, to.CHUNK, break_chunk=1, jump=3 * W)
    vals = rng.standard_normal((N, 8)).astype(np.float32)
    plan = probes.WindowPlan.build(ids, N_TIE + 3 * W, to.CHUNK, W)
    parts = probes.window_segment_partials(torch.from_numpy(vals), plan).numpy()
    assert parts.shape == (N // to.CHUNK, W, 8)
    base = ids[:: to.CHUNK]
    kept = np.zeros(N, bool)
    for c in range(N // to.CHUNK):
        rows = slice(c * to.CHUNK, (c + 1) * to.CHUNK)
        oh = _onehot(ids[rows] - base[c], W)
        np.testing.assert_allclose(parts[c], oh.T @ vals[rows], rtol=1e-5, atol=1e-5)
        kept[rows] = oh.any(1)
    assert kept.sum() == N - 100  # chunk 1's last 100 rows add nothing
    want = np.zeros((N_TIE + 3 * W, 8))
    np.add.at(want, ids[kept], vals[kept].astype(np.float64))
    got = probes.window_segment_sum(torch.from_numpy(vals), plan).numpy()
    assert _rel_max(got, want) <= 1e-5


def test_p_matches_script_reference():
    rng = np.random.default_rng(3)
    ids = _sorted_stream(rng, N, N_TIE, to.CHUNK)
    tab = tg.normal((N_TIE + 2 * to.W, 8))
    blk = torch.from_numpy(ids[:: to.CHUNK] // to.W)
    got = probes.gather_rows(torch.from_numpy(ids), torch.from_numpy(tab), (blk, to.W))
    np.testing.assert_array_equal(got.numpy(), tab[ids])


def test_p_matches_onehot_emulation_and_zeroes_rows_past_the_window():
    rng = np.random.default_rng(4)
    W = to.W
    ids = _sorted_stream(rng, N, N_TIE, to.CHUNK, break_chunk=2, jump=3 * W)
    tab = rng.standard_normal((N_TIE + 5 * W, 8)).astype(np.float32)
    lo = (ids[:: to.CHUNK] // W) * W
    got = probes.gather_rows(torch.from_numpy(ids), torch.from_numpy(tab),
                             (torch.from_numpy(lo // W), W)).numpy()
    zero = np.zeros(N, bool)
    for c in range(N // to.CHUNK):
        rows = slice(c * to.CHUNK, (c + 1) * to.CHUNK)
        oh_lo, oh_hi = _onehot(ids[rows] - lo[c], W), _onehot(ids[rows] - lo[c] - W, W)
        want = oh_lo @ tab[lo[c]: lo[c] + W] + oh_hi @ tab[lo[c] + W: lo[c] + 2 * W]
        np.testing.assert_array_equal(got[rows], want.astype(np.float32))
        zero[rows] = ~(oh_lo.any(1) | oh_hi.any(1))
    assert zero.sum() == 100 and not got[zero].any()  # chunk 2's last 100 rows
    np.testing.assert_array_equal(got[~zero], tab[ids[~zero]])


def test_ids_outside_the_table():
    idx = torch.tensor([-1, 0, 3, 4, 2], dtype=torch.int32)
    tab = torch.arange(8.0).view(4, 2)
    got = probes.gather_rows(idx, tab)
    assert torch.equal(got, torch.tensor([[0.0, 0], [0, 1], [6, 7], [0, 0], [4, 5]]))
    sums = probes.scatter_rows(idx, torch.ones((5, 2)), 4, chunk=2)
    assert torch.equal(sums, torch.tensor([[1.0, 1], [0, 0], [1, 1], [1, 1]]))
    parts = probes.scatter_rows(idx, torch.ones((5, 2)), 4, chunk=2, partials=True)
    assert tuple(parts.shape) == (3, 4, 2) and torch.equal(parts.sum(0), sums)
    m = torch.ones((5, 24))
    assert torch.equal(probes.gather_contract(idx, m, torch.ones((4, 8)))[[0, 3]],
                       torch.zeros((2, 4)))


def test_kernel_entries_raise_on_cpu_tensors():
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        probes.gather_rows_kernel(idx, torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        probes.gather_contract_kernel(idx, torch.zeros((8, 24)), torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        probes.scatter_rows_kernel(idx, torch.zeros((8, 8)), 4, 4)
    plan = probes.WindowPlan.build(np.arange(8), 8, 4, 4)
    with pytest.raises(ValueError, match="on a card"):
        probes.window_segment_partials(torch.zeros((8, 8), device="meta"), plan)
