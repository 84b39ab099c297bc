"""Scatter-free segment reductions for sorted observation streams.

PyTorch port of fish_eye_bundle_adjustment_tpu/ops/segment.py.  For a
SORTED id stream a segment sum is a difference of prefix sums at the
segment boundaries: two row gathers of n_segments rows plus a prefix.
The prefix is hierarchical -- a per-chunk inclusive prefix over chunks of
CHUNK rows (K4, ops/prefix.py: a CUDA kernel on the card) and an
exclusive scan of the chunk totals -- so float32 cancellation stays
bounded by the chunk length, independent of the stream length.

A secondary axis (images, in the tie-sorted stream) is a static
permutation into its own sorted order followed by the same reduction: one
gather instead of one scatter.  ``SortPlan`` is that secondary axis on its
own, for any id column.

``DirectPlan`` sums float32 segments directly instead: each segment's
rows added in one fixed order by the span segment sum (K3's kernel,
ops/streamseg.py), after one static gather into that order.  A prefix
difference loses in float32 the low bits of a segment whose sum is small
beside the prefix; a direct sum keeps them, as the JAX package's
scatter-add does where it sums directly.

Gathers only: ``index_add_`` and ``scatter_add_`` take float atomics on
CUDA, so their sums change from run to run; these repeat bit for bit.
The layouts are built once on the host (numpy) and live on the stream's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops.prefix import CHUNK, chunk_prefix
from fish_eye_bundle_adjustment_tpu_torch.ops.streamseg import (
    GroupedSegPlan,
    sorted_segment_sum_streaming,
)

# rows a DirectPlan group spans on average: the span kernel runs one CTA per
# group, so small segments (ties) are grouped up to 128 a CTA and large
# ones (images, cameras) take one each
SPAN_ROWS = 1024


@dataclasses.dataclass
class SegmentLayout:
    """Static boundary structure of one sorted id stream.

    begs/ends are row offsets per segment (exclusive end); empty segments
    have begs == ends and reduce to zero."""

    begs: torch.Tensor  # (n_seg,) int64
    ends: torch.Tensor  # (n_seg,) int64

    @staticmethod
    def from_sorted_ids(ids: np.ndarray, n_seg: int, device="cpu") -> "SegmentLayout":
        starts = np.searchsorted(ids, np.arange(n_seg + 1)).astype(np.int64)
        return SegmentLayout(
            begs=torch.as_tensor(starts[:-1], device=device),
            ends=torch.as_tensor(starts[1:], device=device),
        )


def _exclusive_prefix_at(local, offs, rows):
    """ex(r) = sum of vals[:r] for each r in `rows`, from the per-chunk
    inclusive prefix `local` (N, D) and the exclusive chunk offsets `offs`
    (N // CHUNK + 1, D)."""
    inner = torch.where(
        (rows % CHUNK > 0)[:, None], local[(rows - 1).clamp(min=0)], 0.0
    )
    return offs[rows // CHUNK] + inner


def sorted_segment_sum(vals, layout: SegmentLayout):
    """Segment sum of a sorted stream. vals (N, D) -> (n_seg, D).

    N is padded with zero rows to a multiple of CHUNK (a copy, which the
    solver's streams avoid by coming padded); the chunk prefix is taken
    once and shared by the begin and end boundary lookups.  Rows past the
    last segment's end are ignored."""
    n, d = vals.shape
    pad = -n % CHUNK
    if pad:
        vals = torch.cat([vals, vals.new_zeros((pad, d))])
    local, chunk_tot = chunk_prefix(vals.contiguous())
    offs = torch.cat([chunk_tot.new_zeros((1, d)), torch.cumsum(chunk_tot, dim=0)])
    hi = _exclusive_prefix_at(local, offs, layout.ends)
    lo = _exclusive_prefix_at(local, offs, layout.begs)
    return hi - lo


@dataclasses.dataclass
class SortPlan:
    """Segment sums by one id column of a stream: a static stable argsort
    and the layout of the sorted ids -- a DualAxisPlan's secondary axis on
    its own."""

    perm: torch.Tensor  # (N,) int64 sorted position -> stream row
    layout: SegmentLayout

    @staticmethod
    def build(ids: np.ndarray, n_seg: int, device="cpu") -> "SortPlan":
        perm = np.argsort(ids, kind="stable")
        return SortPlan(
            torch.as_tensor(perm.astype(np.int64), device=device),
            SegmentLayout.from_sorted_ids(np.asarray(ids)[perm], n_seg, device),
        )

    def sum(self, vals):
        """vals (N, D) in stream order -> (n_seg, D) sums per id."""
        return sorted_segment_sum(vals[self.perm], self.layout)


@dataclasses.dataclass
class DualAxisPlan:
    """Segment layouts for a stream sorted on a primary axis, plus the
    static permutation that re-sorts it on a secondary axis.

    primary: reductions use sorted_segment_sum directly.
    secondary: vals[perm] is sorted on the secondary axis; one gather
    replaces one scatter."""

    primary: SegmentLayout
    perm: torch.Tensor  # (N,) int64: secondary-sorted position -> primary row
    secondary: SegmentLayout

    @staticmethod
    def build(primary_ids: np.ndarray, n_primary: int,
              secondary_ids: np.ndarray, n_secondary: int,
              device="cpu") -> "DualAxisPlan":
        by_secondary = SortPlan.build(secondary_ids, n_secondary, device)
        return DualAxisPlan(
            primary=SegmentLayout.from_sorted_ids(primary_ids, n_primary, device),
            perm=by_secondary.perm,
            secondary=by_secondary.layout,
        )

    @staticmethod
    def build_sharded(primary_ids: np.ndarray, n_primary: int,
                      secondary_ids: np.ndarray, n_secondary: int,
                      n_shards: int, shard: int, device="cpu") -> "DualAxisPlan":
        """Shard `shard`'s plan of a stream split into `n_shards` equal
        contiguous slices (a rank holds one; the JAX package stacks them
        all).  The stream is sorted on the primary axis, so each slice is
        too; a segment that straddles a slice boundary is summed in part
        by each shard, and the caller's all-reduce completes it.  Row
        offsets are local to the slice."""
        n = primary_ids.shape[0]
        assert n % n_shards == 0, (n, n_shards)
        m = n // n_shards
        sl = slice(shard * m, (shard + 1) * m)
        return DualAxisPlan.build(primary_ids[sl], n_primary, secondary_ids[sl],
                                  n_secondary, device)

    def secondary_sum(self, vals):
        return sorted_segment_sum(vals[self.perm], self.secondary)

    def primary_sum(self, vals):
        return sorted_segment_sum(vals, self.primary)


@dataclasses.dataclass
class DirectPlan:
    """Direct float32 segment sums by one id column of a stream: a static
    gather into (id, rank) order -- None where the stream is in it already
    -- and the GroupedSegPlan of the gathered ids, whose span segment sum
    adds each segment's rows in rank order.  With `rank` the position of
    each row in another stream, each sum adds its rows in the order a
    serial scatter-add over that stream adds them.  Rows whose id is
    n_seg or more (padding, or a segment no caller reads) sort last and
    are not read: the kernel's time is its slowest group's, and one large
    group of such rows would set it.

    Group size: M segments a group, M = SPAN_ROWS * n_seg / N clamped to
    [1, 128].  The span kernel's shared memory, 5,248 + 4 * M * D bytes,
    stays under the H100's 232,448 up to D = 443 columns at M = 128; the
    widest sum the solver takes is 55 (the IOP preconditioner blocks at 10
    IOPs).  A group's span is not bounded: the CUDA kernel reads each
    group's rows from its first, so the TPU kernel's bound on the aligned
    span (max_T) does not apply."""

    perm: Optional[torch.Tensor]  # (N,) int64 sorted position -> stream row
    plan: GroupedSegPlan

    @staticmethod
    def build(ids: np.ndarray, n_seg: int, rank: np.ndarray, device="cpu") -> "DirectPlan":
        ids = np.asarray(ids)
        n = ids.shape[0]
        perm = np.lexsort((np.asarray(rank), ids))
        starts = np.searchsorted(ids[perm], np.arange(n_seg + 1)).astype(np.int64)
        M = int(np.clip(SPAN_ROWS * n_seg // max(n, 1), 1, 128))
        plan = GroupedSegPlan.build(starts[:-1], starts[1:], M=M,
                                    max_T=-(-(n + 256) // 128) * 128)
        if np.array_equal(perm, np.arange(n)):
            return DirectPlan(None, plan)
        return DirectPlan(torch.as_tensor(perm.astype(np.int64), device=device), plan)

    def sum(self, vals):
        """vals (N, D) float32 in stream order -> (n_seg, D) sums per id."""
        if self.perm is not None:
            vals = vals[self.perm]
        return sorted_segment_sum_streaming(vals, self.plan)
