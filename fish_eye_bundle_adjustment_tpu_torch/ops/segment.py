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

Gathers only: ``index_add_`` and ``scatter_add_`` take float atomics on
CUDA, so their sums change from run to run; these repeat bit for bit.
The layouts are built once on the host (numpy) and live on the stream's
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops.prefix import CHUNK, chunk_prefix


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
    def build_sharded(primary_ids, n_primary, secondary_ids, n_secondary,
                      n_shards):
        """Per-shard plans for an observation axis split over devices."""
        raise NotImplementedError(
            "DualAxisPlan.build_sharded: needs parallel/ on torch.distributed "
            "(ROADMAP.md Queue 1, item 8), not ported yet"
        )

    def secondary_sum(self, vals):
        return sorted_segment_sum(vals[self.perm], self.secondary)

    def primary_sum(self, vals):
        return sorted_segment_sum(vals, self.primary)
