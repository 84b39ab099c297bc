"""The span segment-sum kernel (ops/csrc/streamseg.cu, K3 and probe W) on the
card, called through ops/streamseg.span_segment_sum (marked gpu; skipped
without one).

This file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_streamseg_cuda.py

(--noconftest: tests/conftest.py sets up JAX for the other test files.)
Whether there is a card is decided inside each test.

Each case is held to a plain PyTorch sum of the same spans (float64 sums of
the float32 rows, rounded once): relative norm <= 1e-5, since only the order
of the additions differs, and bitwise equal on a second launch (no atomics).
Both layouts of the main path -- K3's stream held transposed (row stride 1,
column stride N, output slots adjacent) and W's row-major one (8 columns a
row) -- and their variants: an empty span, one slot holding a whole span,
runs across lanes, warps and tiles of the kernel, slots outside [0, S), a
span of 64K rows, bases and strides that rule out 16-byte loads, and
D = 1, 3, 8, 21.  The kernel prefetches the next tile only when every
span's CTA is resident at once; the many_spans cases launch more CTAs than
the card can hold (5,000 spans against at most 32 CTAs an SM), so they run
the variant without prefetch, as K3 does at the bench shape (782 spans)."""

import numpy as np
import pytest
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import streamseg

pytestmark = pytest.mark.gpu

TOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _plain(vals, ids, r0, r1, s0, S):
    """(n_blocks, S, D) float32: each span's rows added into slot ids - s0."""
    vals, ids = vals.double().cpu(), ids.long().cpu()
    r0, r1 = r0.tolist(), r1.tolist()
    s0 = [0] * len(r0) if s0 is None else s0.tolist()
    out = torch.zeros((len(r0), S, vals.shape[1]), dtype=torch.float64)
    for b, (a, e, s) in enumerate(zip(r0, r1, s0)):
        slot = ids[a:e] - s
        ok = (slot >= 0) & (slot < S)
        out[b].index_add_(0, slot[ok], vals[a:e][ok])
    return out.float()


def _spans(rng, n, n_blocks, empty=False):
    """n_blocks spans tiling [0, n) at random cuts; `empty` adds a block
    with r0 == r1."""
    cuts = np.sort(rng.choice(np.arange(1, n), n_blocks - 1, replace=False))
    r0 = np.concatenate([[0], cuts])
    r1 = np.concatenate([cuts, [n]])
    if empty:
        r0 = np.concatenate([r0, [n // 2]])
        r1 = np.concatenate([r1, [n // 2]])
    return r0.astype(np.int32), r1.astype(np.int32)


# name -> (rows, blocks, S, D, ids per span, slot offset s0 or None, empty block)
CASES = {
    "k3_like": (60_000, 40, 128, 8, 128, None, False),
    "w_like": (40_960, 20, 256, 8, 300, "base", False),
    "one_slot": (9_000, 3, 4, 8, 1, None, False),
    "outside_slots": (12_000, 6, 64, 8, 200, "shifted", True),
    "span_64k": (65_536, 1, 512, 8, 512, None, False),
    "d1": (10_000, 5, 128, 1, 128, None, True),
    "d3": (10_000, 5, 128, 3, 128, None, False),
    "d21": (10_000, 5, 64, 21, 100, "base", False),
    # more spans than the card holds at once: the variant without prefetch
    "many_spans": (100_000, 5_000, 64, 8, 64, None, True),
    "many_spans_d21": (100_000, 5_000, 32, 21, 32, "base", False),
    "many_spans_outside_d3": (100_000, 5_000, 16, 3, 40, "shifted", True),
}
MANY = [name for name in CASES if name.startswith("many_spans")]
MAX_CTAS_PER_SM = 32  # sm_90


def _past_resident(n_blocks, dev):
    """Whether n_blocks CTAs are more than the card can hold at once."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return n_blocks > sms * MAX_CTAS_PER_SM


def _case(name, dev):
    n, n_blocks, S, D, per, s0_kind, empty = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    r0, r1 = _spans(rng, n, n_blocks, empty)
    ids = np.zeros(n, np.int64)
    s0 = None
    for a, e in zip(r0, r1):
        ids[a:e] = np.sort(rng.integers(0, per, e - a))
    if s0_kind == "base":  # W: slot = id - the span's first id
        s0 = np.array([ids[a] if e > a else 0 for a, e in zip(r0, r1)], np.int32)
    elif s0_kind == "shifted":  # slots from -20 to past S
        s0 = np.full(len(r0), 20, np.int32)
    vals = rng.standard_normal((n, D)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(vals), t(ids.astype(np.int32)), t(r0), t(r1),
            None if s0 is None else t(s0), S)


def _run_twice(vals, ids, r0, r1, s0, out):
    streamseg.reset_counts()
    streamseg.span_segment_sum(vals, ids, r0, r1, s0, out)
    first = out.clone()
    out.fill_(float("nan"))
    streamseg.span_segment_sum(vals, ids, r0, r1, s0, out)
    torch.cuda.synchronize()
    assert streamseg.kernel_launches["span_segment_sum"] == 2
    assert torch.equal(first, out), "not bitwise repeatable"
    return first


def _rel(got, want):
    got, want = got.cpu().double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


@pytest.mark.parametrize("layout", ["transposed", "row_major"])
@pytest.mark.parametrize("name", list(CASES))
def test_span_sum_matches_plain(name, layout):
    """K3's layout reads a (D, N) stream through its transpose and writes
    slots adjacent ((D, blocks * S) seen as (blocks, S, D)); W's reads the
    row-major (N, D) stream and writes (blocks, S, D) contiguous."""
    dev = _card()
    vals, ids, r0, r1, s0, S = _case(name, dev)
    n_blocks, D = r0.shape[0], vals.shape[1]
    if layout == "transposed":
        src = vals.T.contiguous().T  # strides (1, N)
        out = torch.empty((D, n_blocks * S), device=dev).T.view(n_blocks, S, D)
    else:
        src = vals
        out = torch.empty((n_blocks, S, D), device=dev)
    got = _run_twice(src, ids, r0, r1, s0, out)
    want = _plain(vals, ids, r0, r1, s0, S)
    assert _rel(got, want) <= TOL
    if name in MANY:
        assert _past_resident(n_blocks, dev)
    if name == "one_slot" or name == "d1":
        assert (r1 > r0).any() and torch.count_nonzero(want) > 0


@pytest.mark.parametrize("name", ["k3_like", "many_spans"])
@pytest.mark.parametrize("variant", ["vals_base", "odd_stride", "ids_base"])
def test_span_sum_without_16_byte_loads(variant, name):
    """Bases and strides that rule out 16-byte loads take the kernel's
    scalar loads: a stream starting one float past a 16-byte boundary, a
    transposed stream of odd column stride, ids starting one int past one;
    with the next tile prefetched (k3_like) and without (many_spans)."""
    dev = _card()
    vals, ids, r0, r1, s0, S = _case(name, dev)
    n, D = vals.shape
    if variant == "vals_base":
        big = torch.empty((D, n + 1), device=dev)
        big[:, 1:] = vals.T
        src = big[:, 1:].T  # strides (1, n + 1), base 4 bytes past the allocation
    elif variant == "odd_stride":
        big = torch.empty((D, n + 3), device=dev)
        big[:, :n] = vals.T
        src = big[:, :n].T  # column stride n + 3
    else:
        src = vals
        big = torch.empty(n + 1, dtype=torch.int32, device=dev)
        big[1:] = ids
        ids = big[1:]
    out = torch.empty((r0.shape[0], S, D), device=dev)
    got = _run_twice(src, ids, r0, r1, s0, out)
    assert _rel(got, _plain(vals, ids, r0, r1, s0, S)) <= TOL
