"""Tie-axis (point-state) sharding for the distributed Schur solver.

PyTorch port of fish_eye_bundle_adjustment_tpu/parallel/tieshard.py.  The
observation stream is tie-sorted and cut into contiguous slices, so

* each rank's slice covers a contiguous tie range [t_lo, t_hi];
* at most one tie straddles each slice boundary (<= N - 1 "boundary"
  ties in all);
* a tie is owned by the rank that holds its first row.

A rank's point state is local: (L + 1, ...) tables over its tie span
(L = the widest span, ~ n_tie / N, plus a sentinel row L for control and
padding rows).  Local segment sums are complete but on the boundary
ties, which one all-reduce of a (Bp, k) buffer completes (Bp <= N - 1):
O(N) words a sum instead of the 3 n_tie of a replicated tie sum.  The
global (n_tie, 3) point correction is gathered once a step from the
owned slices (one all_gather).

`build_tie_shard` is the JAX package's host plan, copied exactly (numpy,
every rank's row stacked); `TieShardPlan.shard` gives one rank's row on
its device, which `LocalTieOps` works on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops.segment import SegmentLayout, sorted_segment_sum


@dataclasses.dataclass
class TieShardPlan:
    """The host plan of every rank (leading axis N); the fields and their
    values are the JAX package's TieShardArrays'."""

    # (N, m) local tie id per local row (L = the sentinel: control and
    # padding rows, and rows of ties outside the local span)
    tie_local: np.ndarray
    # (N, L + 1) local segment layout (row offsets within the slice)
    begs: np.ndarray
    ends: np.ndarray
    # (N, Bp) local slot of each global boundary tie (L = absent)
    bslot: np.ndarray
    # (N, 1) first owned local slot / length of the owned slot range
    # (owned ids may hold zero-observation holes)
    own_lo: np.ndarray
    own_n: np.ndarray
    # global tie -> (owner rank, slot within the owner's owned range);
    # owner N is a virtual zero plane for ties without observations
    owner_of_tie: np.ndarray  # (n_tie,) int32
    pos_in_owner: np.ndarray  # (n_tie,) int32
    L: int = 0
    Bp: int = 1
    max_own: int = 0
    n_tie: int = 0
    n_shards: int = 1

    def shard(self, d: int, device, n_rows: int) -> "TieShardArrays":
        """Rank d's row on `device`, its stream padded to `n_rows` rows
        (sentinel ids; the layouts read none of them)."""
        dev = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        tie_local = np.full(n_rows, self.L, np.int64)
        tie_local[: self.tie_local.shape[1]] = self.tie_local[d]
        return TieShardArrays(
            tie_local=dev(tie_local), begs=dev(self.begs[d]), ends=dev(self.ends[d]),
            bslot=dev(self.bslot[d]), own_lo=int(self.own_lo[d, 0]),
            owner_of_tie=dev(self.owner_of_tie), pos_in_owner=dev(self.pos_in_owner),
            L=self.L, max_own=self.max_own, n_shards=self.n_shards,
        )


@dataclasses.dataclass
class TieShardArrays:
    """One rank's row of a TieShardPlan on its device."""

    tie_local: torch.Tensor  # (n_rows,)
    begs: torch.Tensor  # (L + 1,)
    ends: torch.Tensor  # (L + 1,)
    bslot: torch.Tensor  # (Bp,)
    own_lo: int
    owner_of_tie: torch.Tensor  # (n_tie,)
    pos_in_owner: torch.Tensor  # (n_tie,)
    L: int
    max_own: int
    n_shards: int


def build_tie_shard(tie_sorted: np.ndarray, n_tie: int, n_shards: int) -> TieShardPlan:
    """Host-side plan from the PADDED tie-sorted id stream (control and
    padding rows carry id == n_tie), split into n_shards equal slices."""
    n = tie_sorted.shape[0]
    assert n % n_shards == 0, (n, n_shards)
    m = n // n_shards
    tie_sorted = np.asarray(tie_sorted, np.int64)

    # global tie start rows (ties tile the live prefix contiguously)
    starts = np.searchsorted(tie_sorted, np.arange(n_tie + 1))
    counts = np.diff(starts)
    owner_of_tie = np.minimum(starts[:-1] // m, n_shards - 1).astype(np.int64)
    # a tie with no observations has no rows anywhere; its "start" is the
    # next tie's start, which can land in a shard whose span excludes it:
    # such ties go to a virtual zero plane (owner == n_shards), their
    # correction exactly 0
    owner_of_tie[counts == 0] = n_shards

    spans = []  # (t_lo, t_hi_incl) live tie range per shard; (0, -1) if none
    for d in range(n_shards):
        sl = tie_sorted[d * m : (d + 1) * m]
        live = sl[sl < n_tie]
        if live.size:
            spans.append((int(live[0]), int(live[-1])))
        else:
            spans.append((0, -1))
    L = max((hi - lo + 1) for lo, hi in spans) if spans else 0
    L = max(L, 1)

    boundary = sorted(
        {t for d in range(1, n_shards)
         for t in [int(tie_sorted[d * m])] if t < n_tie
         if starts[t] < d * m}  # starts before the boundary -> straddles
    )
    Bp = max(len(boundary), 1)

    tie_local = np.full((n_shards, m), L, np.int32)
    begs = np.zeros((n_shards, L + 1), np.int32)
    ends = np.zeros((n_shards, L + 1), np.int32)
    bslot = np.full((n_shards, Bp), L, np.int32)
    own_lo = np.zeros((n_shards, 1), np.int32)
    own_n = np.zeros((n_shards, 1), np.int32)
    pos_in_owner = np.zeros(n_tie, np.int32)

    for d in range(n_shards):
        lo, hi = spans[d]
        sl = tie_sorted[d * m : (d + 1) * m]
        if hi >= lo:
            loc = sl - lo
            tie_local[d] = np.where(sl < n_tie, loc, L).astype(np.int32)
            # local segment layout over ids 0..L (sentinel L collects the rest)
            s = np.searchsorted(tie_local[d], np.arange(L + 2))
            begs[d] = s[:-1][: L + 1]
            ends[d] = s[1:][: L + 1]
            for j, t in enumerate(boundary):
                if lo <= t <= hi:
                    bslot[d, j] = t - lo
            owned = np.nonzero(owner_of_tie == d)[0]
            if owned.size:
                # positions are SLOT-based (owned[i] - owned[0]): an interior
                # zero-observation tie leaves a hole (which holds 0) that
                # must not shift later owned ties' positions
                own_lo[d, 0] = int(owned[0]) - lo
                own_n[d, 0] = int(owned[-1] - owned[0] + 1)
                pos_in_owner[owned] = (owned - owned[0]).astype(np.int32)
                assert own_lo[d, 0] >= 0, (d, own_lo[d, 0])
    max_own = int(own_n.max()) if n_tie else 0

    return TieShardPlan(
        tie_local=tie_local, begs=begs, ends=ends, bslot=bslot,
        own_lo=own_lo, own_n=own_n,
        owner_of_tie=owner_of_tie.astype(np.int32), pos_in_owner=pos_in_owner,
        L=int(L), Bp=int(Bp), max_own=max(max_own, 1),
        n_tie=int(n_tie), n_shards=int(n_shards),
    )


class LocalTieOps:
    """A rank's point-block operations over its local tie span."""

    def __init__(self, ts: TieShardArrays, mesh):
        self.ts = ts
        self.mesh = mesh
        self.L = ts.L
        self.tie_local = ts.tie_local
        self.layout = SegmentLayout(begs=ts.begs, ends=ts.ends)
        self.present = (ts.bslot < ts.L)[:, None]

    def complete(self, partial):
        """Finish the boundary segments of a local (L + 1, k) partial sum
        with one all-reduce of the (Bp, k) boundary rows."""
        bslot = self.ts.bslot
        zero = torch.zeros((), dtype=partial.dtype, device=partial.device)
        done = self.mesh.psum(torch.where(self.present, partial[bslot], zero))
        out = partial.clone()
        # absent slots (bslot == L) write the sentinel row back unchanged
        out[bslot] = torch.where(self.present, done, partial[bslot])
        return out

    def segsum(self, vals):
        """Local sorted segment sum (n_rows, k) -> (L + 1, k) (the chunk
        prefix of ops/segment.py), boundary rows completed across ranks;
        the sentinel row L, of the control and padding rows, is zeroed
        (expand reads it for those rows)."""
        out = self.complete(sorted_segment_sum(vals, self.layout))
        out[self.L] = 0.0
        return out

    def expand(self, table):
        """Local per-tie table (L + 1, k) -> per-row values (row L zero)."""
        return table[self.tie_local]

    def gather_global(self, local_vals):
        """Owned slices -> the replicated global (n_tie, k): one all_gather."""
        ts = self.ts
        k = local_vals.shape[-1]
        padded = torch.cat([local_vals, local_vals.new_zeros((ts.max_own, k))])
        own = padded[ts.own_lo : ts.own_lo + ts.max_own]
        allg = self.mesh.all_gather(own).reshape(ts.n_shards, ts.max_own, k)
        # the virtual zero plane of the ties without observations
        allg = torch.cat([allg, allg.new_zeros((1, ts.max_own, k))])
        return allg[ts.owner_of_tie, ts.pos_in_owner]
