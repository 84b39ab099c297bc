"""Streaming segment sum of a sorted stream (K3): a CUDA kernel and its plain
version.

PyTorch port of fish_eye_bundle_adjustment_tpu/ops/attic/streamseg.py.  The
JAX package keeps that Pallas kernel in attic/, off every production path;
its only callers are bench_streamseg.py (twinned by bench_torch_streamseg.py)
and tests/test_streamseg.py.  Segments are grouped M at a time by a host-static
``GroupedSegPlan`` (a copy of the JAX package's, numpy only): group g owns
segments [g*M, (g+1)*M), whose rows form the contiguous span
[first_row[g], end_row[g]) of the sorted stream, and row r goes to slot
rel[r] = seg_id % M of the group's (D, M) output block.

    streaming_segment_sum_t(vals_t, plan): (D, n) -> (D, n_seg)
    sorted_segment_sum_streaming(vals, plan): (N, D) -> (n_seg, D)

Both dispatch on the device of their input: a CPU tensor runs the plain
PyTorch version (``streaming_segment_sum_t_ref``); a CUDA tensor launches the
span segment-sum kernel of ops/csrc/streamseg.cu and raises on anything it
does not take; any other device raises.  The kernel reads the stream through
its strides, so ``sorted_segment_sum_streaming`` hands it ``vals.T`` as a
view, with no transposed copy.  It sums in a fixed order without atomics,
so its output repeats bit for bit.

``span_segment_sum`` is the kernel's own entry, which probe W of
bench_pallas_onehot.py also takes (ops/probes.py): block b sums the rows of
the span [r0[b], r1[b]) into S slots, slot = ids[row] - s0[b], dropping rows
whose slot falls outside [0, S).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.utils.cudagraph import count_launch

# Launch counts: the wrappers add one where they launch the kernel
# (`kernel_launches`) or run the plain version on the CPU (`plain_calls`).
kernel_launches = {"span_segment_sum": 0}
plain_calls = {"span_segment_sum": 0}


def reset_counts() -> None:
    kernel_launches["span_segment_sum"] = 0
    plain_calls["span_segment_sum"] = 0


class GroupTooWide(ValueError):
    """A segment group's span exceeds the plan's bound; fall back to the
    prefix-sum segment sum (ops/segment.py)."""


@dataclasses.dataclass(frozen=True)
class GroupedSegPlan:
    """Host-static grouping of consecutive segments for the streaming
    reduce: group g covers segments [g*M, (g+1)*M) whose rows form the
    contiguous span [first_row[g], end_row[g]), DMA'd from the 128-aligned
    row_start[g] with span <= T."""

    row_start: np.ndarray  # (G,) int32 128-aligned DMA start per group
    first_row: np.ndarray  # (G,) int32 first row owned by the group
    end_row: np.ndarray  # (G,) int32 one past the last row owned
    rel: np.ndarray  # (n_pad,) float32 seg_id % M per row (-1 padding)
    n_seg: int
    n_rows: int  # unpadded stream length N
    n_pad: int  # padded stream length the kernel expects
    T: int  # worst-case aligned span, rounded up to 128 lanes
    M: int  # segments per group

    @staticmethod
    def build(begs: np.ndarray, ends: np.ndarray, M: int = 128,
              max_T: int = 64 * 1024) -> "GroupedSegPlan":
        """Raises GroupTooWide when the worst-case aligned span exceeds
        `max_T` lanes: one hot segment (a tie seen by thousands of
        observations, or heavily skewed counts) would make the (D, T)
        VMEM scratch and per-step DMA arbitrarily large — past ~16 MB
        VMEM the kernel cannot compile, and well before that the
        read amplification erases the one-pass advantage.  Callers fall
        back to the XLA prefix-sum path (ops/segment.py)."""
        begs = np.asarray(begs, np.int64)
        ends = np.asarray(ends, np.int64)
        n_seg = begs.shape[0]
        if n_seg:
            # segments must contiguously tile [0, n_rows): `rel` is built
            # by np.repeat from segment lengths, so a leading gap or
            # overlapping segments would silently misalign it vs rows
            if int(begs[0]) != 0 or not np.array_equal(begs[1:], ends[:-1]):
                raise ValueError(
                    "GroupedSegPlan requires contiguous segments tiling "
                    "[0, n_rows) (begs[0]==0, begs[i+1]==ends[i])"
                )
        n_rows = int(ends[-1]) if n_seg else 0
        G = max(1, -(-max(n_seg, 1) // M))
        pad = G * M - n_seg
        begs_p = np.concatenate([begs, np.full(pad, n_rows, np.int64)])
        ends_p = np.concatenate([ends, np.full(pad, n_rows, np.int64)])
        gb = begs_p.reshape(G, M)
        ge = ends_p.reshape(G, M)
        first_row = gb[:, 0]
        end_row = ge[:, -1]
        # DMA lane offsets must be 128-aligned (HBM (8,128) tiling): align
        # each span start down; the worst-case span T absorbs the slack.
        row_start = (first_row // 128) * 128
        span = end_row - row_start
        T = int(max(128, -(-int(span.max()) // 128) * 128)) if n_seg else 128
        if T > max_T:
            raise GroupTooWide(
                f"worst-case group span T={T} exceeds max_T={max_T} "
                f"(M={M} segments/group; a hot or skewed segment)"
            )
        n_pad = int(max(row_start.max() + T, n_rows)) if n_seg else T
        # static rel-segment ids: seg_id % M per row; -1 on padding rows
        seg_id = np.repeat(
            np.arange(n_seg, dtype=np.int64), (ends - begs).astype(np.int64)
        )
        rel = np.full(n_pad, -1.0, np.float32)
        rel[:n_rows] = (seg_id % M).astype(np.float32)
        return GroupedSegPlan(
            row_start=row_start.astype(np.int32),
            first_row=first_row.astype(np.int32),
            end_row=end_row.astype(np.int32),
            rel=rel,
            n_seg=n_seg,
            n_rows=n_rows,
            n_pad=n_pad,
            T=T,
            M=M,
        )

    @property
    def G(self) -> int:
        return self.row_start.shape[0]

    @property
    def read_amplification(self) -> float:
        """HBM rows read / logical rows (span + alignment overhead)."""
        return self.G * self.T / max(self.n_rows, 1)

    def on(self, device) -> "PlanArrays":
        """The plan's tensors on `device`, built on the first call for that
        device and kept with the plan."""
        cache = self.__dict__.setdefault("_arrays", {})
        device = torch.device(device)
        if device not in cache:
            cache[device] = PlanArrays.build(self, device)
        return cache[device]


@dataclasses.dataclass
class PlanArrays:
    """A GroupedSegPlan's tensors on one device.  The CUDA kernel reads the
    owned rows from first_row directly, so it needs no 128-aligned
    row_start."""

    first_row: torch.Tensor  # (G,) int32
    end_row: torch.Tensor  # (G,) int32
    rel: torch.Tensor  # (n_pad,) int32 seg_id % M, -1 on padding rows
    col: torch.Tensor  # (n_rows,) int64 output column g*M + rel of each owned row

    @staticmethod
    def build(plan: GroupedSegPlan, device) -> "PlanArrays":
        owned = (plan.end_row - plan.first_row).astype(np.int64)
        group = np.repeat(np.arange(plan.G, dtype=np.int64), owned)
        col = group * plan.M + plan.rel[: plan.n_rows].astype(np.int64)
        return PlanArrays(
            first_row=torch.as_tensor(plan.first_row, device=device),
            end_row=torch.as_tensor(plan.end_row, device=device),
            rel=torch.as_tensor(plan.rel.astype(np.int32), device=device),
            col=torch.as_tensor(col, device=device),
        )


def _padded(vals_t, plan):
    """vals_t with at least plan.n_rows columns: zero columns appended, as
    the JAX package pads a short stream."""
    short = plan.n_rows - vals_t.shape[1]
    return torch.nn.functional.pad(vals_t, (0, short)) if short > 0 else vals_t


def streaming_segment_sum_t_ref(vals_t, plan: GroupedSegPlan):
    """Plain version of the K3 kernel (see streaming_segment_sum_t): each
    owned row added to its group's slot, rows in stream order."""
    vals_t = _padded(vals_t, plan)
    arrays = plan.on(vals_t.device)
    out = vals_t.new_zeros((vals_t.shape[0], plan.G * plan.M))
    out.index_add_(1, arrays.col, vals_t[:, : plan.n_rows])
    return out[:, : plan.n_seg]


def span_segment_sum(vals, ids, r0, r1, s0, out) -> None:
    """The span segment-sum kernel on CUDA tensors, writing every element of
    `out` (n_blocks, S, D): out[b, s] = the sum of the rows r of the span
    [r0[b], r1[b]) whose slot ids[r] - s0[b] is s, in stream order; rows
    whose slot falls outside [0, S) add nothing.

    vals (rows, D) float32 and out float32 with any non-negative strides
    (the kernel reads and writes through them); ids (rows,) int32,
    non-decreasing inside every span; r0, r1 (n_blocks,) int32 with
    0 <= r0 <= r1 <= rows; s0 (n_blocks,) int32, or None for 0."""
    named = dict(vals=vals, ids=ids, r0=r0, r1=r1, out=out)
    if s0 is not None:
        named["s0"] = s0
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"the span segment-sum kernel takes CUDA tensors, {name} is on {t.device}")
        if t.device != vals.device:
            raise ValueError(f"the span segment-sum kernel takes tensors on one card, {name} is on {t.device}")
    for name in ("vals", "out"):
        if named[name].dtype != torch.float32:
            raise ValueError(f"the span segment-sum kernel takes float32 {name}, got dtype {named[name].dtype}")
    for name in [k for k in named if k not in ("vals", "out")]:
        t = named[name]
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"the span segment-sum kernel takes {name} as a contiguous 1-D int32 tensor, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    if vals.dim() != 2 or out.dim() != 3:
        raise ValueError(
            f"the span segment-sum kernel takes vals (rows, D) and out (n_blocks, S, D), "
            f"got {tuple(vals.shape)} and {tuple(out.shape)}"
        )
    n_blocks, S, D = out.shape
    if vals.shape[1] != D or D < 1 or S < 1 or ids.shape[0] != vals.shape[0]:
        raise ValueError(
            f"the span segment-sum kernel: vals {tuple(vals.shape)}, ids {tuple(ids.shape)} "
            f"and out {tuple(out.shape)} do not fit (D >= 1, S >= 1)"
        )
    if any(t.shape[0] != n_blocks for k, t in named.items() if k in ("r0", "r1", "s0")):
        raise ValueError(f"the span segment-sum kernel takes r0, r1 and s0 of length {n_blocks}")
    if min(*vals.stride(), *out.stride()) < 0:
        raise ValueError("the span segment-sum kernel takes non-negative strides")
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    lib = _build.load()
    smem = lib.streamseg_smem_bytes(S, D)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"the span segment-sum kernel needs {smem} bytes of shared memory at "
            f"S={S}, D={D}; a block has {_build.SMEM_LIMIT}"
        )
    code = lib.streamseg_span_sum(
        vals.data_ptr(), ids.data_ptr(), r0.data_ptr(), r1.data_ptr(),
        None if s0 is None else s0.data_ptr(), n_blocks, S, D, *vals.stride(),
        *out.stride(), out.data_ptr(),
        torch.cuda.current_stream(vals.device).cuda_stream,
    )
    _build.check(code, "span_segment_sum")
    count_launch(kernel_launches, "span_segment_sum", vals.device)


def streaming_segment_sum_t_kernel(vals_t, plan: GroupedSegPlan):
    """The K3 kernel on a CUDA tensor: vals_t (D, n) float32, any strides."""
    if vals_t.device.type != "cuda":
        raise ValueError(f"the streaming segment-sum kernel takes a CUDA tensor, got {vals_t.device}")
    if vals_t.dim() != 2:
        raise ValueError(f"the streaming segment-sum kernel takes (D, n), got {tuple(vals_t.shape)}")
    vals_t = _padded(vals_t, plan)
    arrays = plan.on(vals_t.device)
    out = torch.empty((vals_t.shape[0], plan.G * plan.M), dtype=vals_t.dtype, device=vals_t.device)
    # the stream's rows are vals_t's columns, and the kernel reads only the
    # owned rows [0, n_rows); out (D, G*M) is written as a (G, M, D) view
    n = plan.n_rows
    span_segment_sum(vals_t[:, :n].T, arrays.rel[:n], arrays.first_row,
                     arrays.end_row, None, out.T.view(plan.G, plan.M, -1))
    return out[:, : plan.n_seg]


def streaming_segment_sum_t(vals_t, plan: GroupedSegPlan):
    """Segment sums of a sorted stream held TRANSPOSED.

    vals_t: (D, n) float32, n >= plan.n_rows (zero columns are appended when
    it is shorter; columns past n_rows belong to no segment).  Returns
    (D, n_seg): the plain version on the CPU, the kernel on a card."""
    if vals_t.device.type == "cpu":
        plain_calls["span_segment_sum"] += 1
        return streaming_segment_sum_t_ref(vals_t, plan)
    return streaming_segment_sum_t_kernel(vals_t, plan)


def sorted_segment_sum_streaming(vals, plan: GroupedSegPlan):
    """Drop-in (N, D) -> (n_seg, D) form.  The kernel reads (N, D) through
    its strides, so the transpose at the boundary is a view, not a copy."""
    return streaming_segment_sum_t(vals.T, plan).T
