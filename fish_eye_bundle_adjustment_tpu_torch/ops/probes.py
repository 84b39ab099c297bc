"""The gather / scatter probes (P1, P2): CUDA kernels and their plain versions.

PyTorch port of the Pallas kernels that bench_pallas_gather.py (P1, probes
A-F) and bench_pallas_onehot.py (P2, probes G, S, W, P) define inside their
``main()``; bench_torch_pallas_gather.py and bench_torch_pallas_onehot.py
drive these.  The TPU cannot index per row inside a kernel, so the JAX
scripts tried ``jnp.take``, advanced indexing, a per-row loop and one-hot
MXU products for the same few functions.  Hopper indexes per row natively,
so each function is one kernel here, whichever TPU strategy it replaces:

    gather_rows(idx, tab)                A, B, C, G: tab[idx]
    gather_rows(idx, tab, (blk, W))      P: tab[idx], 0 outside each chunk's
                                         window [blk*W, blk*W + 2W)
    gather_contract(idx, M, tab)         D: sum_e M[n, 4e + p] * tab[idx[n], e]
    scatter_rows(idx, vals, n_tab, chunk, round_bf16, partials)
                                         E (exact), F (values rounded to
                                         bf16), S (per-chunk partials)
    window_segment_partials(vals, plan)  W: per-chunk windowed segment sums
                                         (the span kernel of ops/streamseg.py)
    window_segment_sum(vals, plan)       W with its combine

(ops/csrc/gather.cu, ops/csrc/scatter.cu).  Every wrapper dispatches on the
device of its input: a CPU tensor runs the plain PyTorch version, a CUDA
tensor launches the kernel and raises on anything it does not take.  Ids
outside the table give zero rows in a gather and add nothing in a scatter,
in the kernels and the plain versions alike.  No kernel takes atomics, so
every output repeats bit for bit; the gathers only copy, so they equal
``tab[idx]`` bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import segment, streamseg
from fish_eye_bundle_adjustment_tpu_torch.utils.cudagraph import count_launch

# Launch counts: the wrappers add one where they launch their kernel
# (`kernel_launches`) or run the plain version on the CPU (`plain_calls`).
# window_segment_partials counts in streamseg's, whose kernel it launches.
kernel_launches = {"gather_rows": 0, "gather_contract": 0, "scatter_rows": 0}
plain_calls = {"gather_rows": 0, "gather_contract": 0, "scatter_rows": 0}

_MAX_COLS = 8  # columns the scatter kernel keeps in registers


def reset_counts() -> None:
    for d in (kernel_launches, plain_calls):
        for k in d:
            d[k] = 0


def _check_cuda(what, **tensors):
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"the {what} kernel takes CUDA tensors, {name} is on {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"the {what} kernel takes tensors on one card, {name} is on {t.device}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"the {what} kernel takes contiguous tensors, {name} is not")


def _check_type(what, t, name, dtype, dim):
    if t.dtype != dtype or t.dim() != dim:
        raise ValueError(
            f"the {what} kernel takes {name} as a {dim}-D {dtype} tensor, "
            f"got {t.dtype} {tuple(t.shape)}"
        )


def _chunk_of_rows(n, blk):
    """Rows per chunk of a windowed gather: N / len(blk), a whole number."""
    if len(blk) < 1 or n % len(blk):
        raise ValueError(f"a windowed gather cuts its {n} rows into len(blk) = {len(blk)} equal chunks")
    return n // len(blk)


# ---- gathers: A, B, C, G, P -------------------------------------------------


def gather_rows_ref(idx, tab, window: Optional[Tuple[torch.Tensor, int]] = None):
    """Plain version of the row-gather kernel (see gather_rows)."""
    n_tab = tab.shape[0]
    ok = (idx >= 0) & (idx < n_tab)
    if window is not None:
        blk, W = window
        lo = blk.long().repeat_interleave(_chunk_of_rows(idx.shape[0], blk)) * W
        ok &= (idx >= lo) & (idx < lo + 2 * W)
    rows = tab[idx.long().clamp(0, n_tab - 1)]
    return torch.where(ok[:, None], rows, rows.new_zeros(()))


def gather_rows_kernel(idx, tab, window=None):
    """The row-gather kernel: idx (N,) int32, tab (n_tab, C) float32, blk
    (N / chunk,) int32, all contiguous CUDA tensors."""
    what = "row-gather"
    named = dict(idx=idx, tab=tab)
    if window is not None:
        named["blk"] = window[0]
    _check_cuda(what, **named)
    _check_type(what, idx, "idx", torch.int32, 1)
    _check_type(what, tab, "tab", torch.float32, 2)
    n, (n_tab, c) = idx.shape[0], tab.shape
    if n_tab < 1 or c < 1:
        raise ValueError(f"the {what} kernel takes a non-empty table, got {tuple(tab.shape)}")
    blk_ptr, W, chunk = None, 0, 1
    if window is not None:
        blk, W = window
        _check_type(what, blk, "blk", torch.int32, 1)
        if W < 1:
            raise ValueError(f"the {what} kernel takes a window W >= 1, got {W}")
        blk_ptr, chunk = blk.data_ptr(), _chunk_of_rows(n, blk)
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    out = torch.empty((n, c), dtype=tab.dtype, device=tab.device)
    code = _build.load().gather_rows_f32(
        idx.data_ptr(), tab.data_ptr(), blk_ptr, n, n_tab, c, W, chunk,
        out.data_ptr(), torch.cuda.current_stream(tab.device).cuda_stream,
    )
    _build.check(code, "gather_rows")
    count_launch(kernel_launches, "gather_rows", tab.device)
    return out


def gather_rows(idx, tab, window=None):
    """tab[idx] (N, C).  With window=(blk, W), row n of chunk c = n // chunk
    (chunk = N / len(blk)) keeps probe P's semantics: an id outside
    [blk[c]*W, blk[c]*W + 2W) gives a zero row.  The plain version on the
    CPU, the kernel on a card."""
    if idx.device.type == "cpu":
        plain_calls["gather_rows"] += 1
        return gather_rows_ref(idx, tab, window)
    return gather_rows_kernel(idx, tab, window)


# ---- gather + contraction: D ------------------------------------------------


def gather_contract_ref(idx, m, tab):
    """Plain version of the gather-contract kernel (see gather_contract)."""
    vg = gather_rows_ref(idx, tab)[:, :6]
    return (m.view(-1, 6, 4) * vg[:, :, None]).sum(1)


def gather_contract_kernel(idx, m, tab):
    """The gather-contract kernel: idx (N,) int32, m (N, 24) 16-byte aligned
    and tab (n_tab, C >= 6) float32, all contiguous CUDA tensors."""
    what = "gather-contract"
    _check_cuda(what, idx=idx, m=m, tab=tab)
    _check_type(what, idx, "idx", torch.int32, 1)
    _check_type(what, m, "m", torch.float32, 2)
    _check_type(what, tab, "tab", torch.float32, 2)
    n, (n_tab, c) = idx.shape[0], tab.shape
    if tuple(m.shape) != (n, 24) or n_tab < 1 or c < 6:
        raise ValueError(
            f"the {what} kernel takes m (N, 24) and tab (n_tab >= 1, C >= 6) with N = {n}, "
            f"got {tuple(m.shape)} and {tuple(tab.shape)}"
        )
    if m.data_ptr() % 16:
        raise ValueError(f"the {what} kernel reads m as float4: it takes m 16-byte aligned")
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    out = torch.empty((n, 4), dtype=m.dtype, device=m.device)
    code = _build.load().gather_contract_f32(
        idx.data_ptr(), m.data_ptr(), tab.data_ptr(), n, n_tab, c, out.data_ptr(),
        torch.cuda.current_stream(m.device).cuda_stream,
    )
    _build.check(code, "gather_contract")
    count_launch(kernel_launches, "gather_contract", m.device)
    return out


def gather_contract(idx, m, tab):
    """out[n, p] = sum over e < 6 of m[n, 4e + p] * tab[idx[n], e], (N, 4):
    probe D's gather fused with its contraction.  The plain version on the
    CPU, the kernel on a card."""
    if idx.device.type == "cpu":
        plain_calls["gather_contract"] += 1
        return gather_contract_ref(idx, m, tab)
    return gather_contract_kernel(idx, m, tab)


# ---- scatter-add: E, F, S ---------------------------------------------------


def scatter_rows_ref(idx, vals, n_tab, chunk, round_bf16=False, partials=False):
    """Plain version of the scatter kernels (see scatter_rows)."""
    n, c = vals.shape
    if round_bf16:
        vals = vals.to(torch.bfloat16).to(vals.dtype)
    n_chunks = -(-n // chunk)
    ok = (idx >= 0) & (idx < n_tab)
    slot = torch.arange(n, device=idx.device) // chunk * n_tab + idx.long()
    parts = vals.new_zeros((n_chunks * n_tab, c)).index_add_(0, slot[ok], vals[ok])
    parts = parts.view(n_chunks, n_tab, c)
    return parts if partials else parts.sum(0)


def scatter_rows_kernel(idx, vals, n_tab, chunk, round_bf16=False, partials=False):
    """The scatter kernels: idx (N,) int32 and vals (N, C <= 8) float32,
    contiguous CUDA tensors; chunk <= 8192 rows (one block sorts a chunk)."""
    what = "scatter"
    _check_cuda(what, idx=idx, vals=vals)
    _check_type(what, idx, "idx", torch.int32, 1)
    _check_type(what, vals, "vals", torch.float32, 2)
    n, c = vals.shape
    if idx.shape[0] != n or not 1 <= c <= _MAX_COLS or n_tab < 1 or chunk < 1:
        raise ValueError(
            f"the {what} kernel takes idx (N,) and vals (N, 1..{_MAX_COLS}), n_tab >= 1 and "
            f"chunk >= 1, got {tuple(idx.shape)}, {tuple(vals.shape)}, {n_tab}, {chunk}"
        )
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    lib = _build.load()
    if chunk > lib.scatter_max_chunk():
        raise ValueError(
            f"the {what} kernel sorts a chunk's rows in one block's shared memory: "
            f"chunk <= {lib.scatter_max_chunk()}, got chunk={chunk}"
        )
    if n_tab > lib.scatter_max_table():
        raise ValueError(
            f"the {what} kernel packs a table id and a chunk row into 32 bits: "
            f"n_tab <= {lib.scatter_max_table()}, got n_tab={n_tab}"
        )
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    n_chunks = -(-n // chunk)
    parts = torch.empty((n_chunks, n_tab, c), dtype=vals.dtype, device=vals.device)
    code = lib.scatter_partials_f32(idx.data_ptr(), vals.data_ptr(), n, n_tab, c, chunk,
                                    int(round_bf16), parts.data_ptr(), stream)
    _build.check(code, "scatter_rows (partials)")
    count_launch(kernel_launches, "scatter_rows", idx.device)
    if partials:
        return parts
    out = torch.empty((n_tab, c), dtype=vals.dtype, device=vals.device)
    code = lib.scatter_reduce_f32(parts.data_ptr(), n_chunks, n_tab * c, out.data_ptr(), stream)
    _build.check(code, "scatter_rows (reduce)")
    return out


def scatter_rows(idx, vals, n_tab, chunk, round_bf16=False, partials=False):
    """acc[idx[i]] += vals[i] into an (n_tab, C) table, built as one partial
    table per chunk of `chunk` rows.  partials=True returns the partials
    (ceil(N / chunk), n_tab, C), as probe S's kernel does; otherwise their
    sum over the chunks in chunk order (E, F).  round_bf16 rounds each
    value to bf16 (nearest even) before the float32 sums, as probe F casts
    its values.  The plain version on the CPU, the kernels on a card."""
    if idx.device.type == "cpu":
        plain_calls["scatter_rows"] += 1
        return scatter_rows_ref(idx, vals, n_tab, chunk, round_bf16, partials)
    return scatter_rows_kernel(idx, vals, n_tab, chunk, round_bf16, partials)


# ---- windowed segment sum: W ------------------------------------------------


@dataclasses.dataclass
class WindowPlan:
    """Probe W's static layout: a sorted id stream cut into chunks of
    `chunk` rows (the last may be short); chunk c sums into the window of
    segments [base[c], base[c] + W), base[c] being its first id, and drops
    the rows past the window.  `combine` sums the (n_chunks * W) partial
    rows into the n_seg segments: a static sort plan over the window slots,
    so the combine is a gather and a sorted segment sum (K4), not a
    scatter."""

    ids: torch.Tensor  # (N,) int32, sorted
    base: torch.Tensor  # (n_chunks,) int32
    r0: torch.Tensor  # (n_chunks,) int32 first row of each chunk
    r1: torch.Tensor  # (n_chunks,) int32 one past its last row
    combine: segment.SortPlan  # over base[c] + j, n_seg + W segments
    n_seg: int
    chunk: int
    W: int

    @staticmethod
    def build(ids: np.ndarray, n_seg: int, chunk: int, W: int, device="cpu") -> "WindowPlan":
        ids = np.asarray(ids)
        n = ids.shape[0]
        if n < 1 or chunk < 1 or W < 1:
            raise ValueError(f"WindowPlan takes N >= 1 rows, chunk >= 1 and W >= 1, got {n}, {chunk}, {W}")
        if np.any(ids[1:] < ids[:-1]) or ids[0] < 0 or ids[-1] >= n_seg:
            raise ValueError(f"WindowPlan takes sorted ids in [0, {n_seg})")
        r0 = np.arange(0, n, chunk, dtype=np.int64)
        r1 = np.minimum(r0 + chunk, n)
        base = ids[r0].astype(np.int64)
        slots = (base[:, None] + np.arange(W)[None, :]).reshape(-1)
        as_int32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)
        return WindowPlan(
            ids=as_int32(ids), base=as_int32(base), r0=as_int32(r0), r1=as_int32(r1),
            combine=segment.SortPlan.build(slots, n_seg + W, device),
            n_seg=n_seg, chunk=chunk, W=W,
        )


def window_segment_partials_ref(vals, plan: WindowPlan):
    """Plain version of probe W's kernel (see window_segment_partials)."""
    n, c = vals.shape
    chunk_of = torch.arange(n, device=vals.device) // plan.chunk
    local = plan.ids.long() - plan.base.long()[chunk_of]
    ok = (local >= 0) & (local < plan.W)
    n_chunks = plan.base.shape[0]
    parts = vals.new_zeros((n_chunks * plan.W, c))
    parts.index_add_(0, (chunk_of * plan.W + local)[ok], vals[ok])
    return parts.view(n_chunks, plan.W, c)


def window_segment_partials(vals, plan: WindowPlan):
    """Per-chunk windowed segment sums (n_chunks, W, C) of vals (N, C):
    partial[c, j] = the sum of chunk c's rows whose id is base[c] + j; rows
    whose id is past the window add nothing.  The plain version on the
    CPU; on a card the span segment-sum kernel (ops/csrc/streamseg.cu)."""
    if vals.device.type == "cpu":
        streamseg.plain_calls["span_segment_sum"] += 1
        return window_segment_partials_ref(vals, plan)
    if vals.device.type != "cuda" or vals.dim() != 2 or vals.shape[0] != plan.ids.shape[0]:
        raise ValueError(
            f"the windowed segment sum takes vals (N, C) on a card with N = "
            f"{plan.ids.shape[0]}, got {tuple(vals.shape)} on {vals.device}"
        )
    out = torch.empty((plan.base.shape[0], plan.W, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    streamseg.span_segment_sum(vals, plan.ids, plan.r0, plan.r1, plan.base, out)
    return out


def window_combine(parts, plan: WindowPlan):
    """(n_chunks, W, C) partials -> (n_seg, C) segment sums: the
    `.at[seg].add` of bench_pallas_onehot.py, which runs outside its kernel,
    here a gather and a sorted segment sum through the plan's static sort
    plan, so it repeats bit for bit."""
    return plan.combine.sum(parts.reshape(-1, parts.shape[-1]))[: plan.n_seg]


def window_segment_sum(vals, plan: WindowPlan):
    """Probe W whole: the partials, then their combine into (n_seg, C)."""
    return window_combine(window_segment_partials(vals, plan), plan)
