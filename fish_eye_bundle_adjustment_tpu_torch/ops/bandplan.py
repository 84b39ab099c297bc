"""Host-side banded grouping of the observation stream for the fused
S-matvec kernels (ops/fusedmv.py).

A numpy copy of fish_eye_bundle_adjustment_tpu/ops/bandplan.py: identical
band plans are a precondition for parity with the JAX package, and
tests/test_torch_host.py holds the two equal field by field.  The notes
below on the TPU (MXU, VMEM) are the JAX package's reasons for the
geometry; the CUDA kernels reuse the geometry unchanged.

The matrix-free Schur matvec couples two axes of the observation stream:
every row needs its image's 6 pose entries (gather) and its tie point's
3x3 eliminated block (segment reduce + expand).  XLA prices each of
those at ~2.6 ns/row — five per matvec ~= 12-17 ms at 1M observations —
because it treats the indices as arbitrary.  They are not:

* sorted by tie, the tie side is CONTIGUOUS (grouped spans, exactly the
  streamseg structure), and
* a survey block is spatially coherent — the images observing a bucket
  of nearby ties form a narrow BAND of the (suitably ordered) image
  axis.

This module computes that structure on the host, once per problem:

1. ties are RENUMBERED by spatial coherence (mean observing image id —
   input image order is flight order in a survey block, reference
   analogue: the .ext row order of main.m:53) so consecutive tie ranks
   see overlapping image sets;
2. optionally the images are renumbered the same way (mean observing
   tie rank) and the better of the two orderings kept;
3. the stream is sorted by tie rank, ranks grouped M at a time into
   contiguous spans padded to T lanes (128-aligned DMA starts), and the
   image band [img_base, img_base + W) of each group recorded with
   img_base 128-aligned and W the worst-case padded width.

If the data has no band structure (every image sees every tie — e.g. a
calibration-lab dataset like cam0), W degenerates to ~n_img, which is
exactly the dense one-hot fallback: still correct, still fast for small
n_img, and the caller can reject the plan past a width cap for large
unstructured problems (fused=False -> the XLA path).

The reference has no analogue of any of this (dense A in one memory,
main.m:424-425); the banding is what makes the coupling MXU-shaped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _align_down(a, m):
    return (a // m) * m


def _align_up(a, m):
    return -(-a // m) * m


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Static banded-stream structure (host arrays; ints are Python)."""

    # observation ordering: position in the banded stream -> original row
    order: np.ndarray  # (n_obs,) int64
    # tie renumbering: slot (layout order) <-> rank (stream order)
    rank_of_slot: np.ndarray  # (n_tie,) int32
    slot_of_rank: np.ndarray  # (n_tie,) int32
    # image renumbering (identity unless reordering won)
    imgrank_of_img: np.ndarray  # (n_img,) int32
    img_of_imgrank: np.ndarray  # (n_img,) int32
    # grouped spans over the rank-sorted stream (all row offsets global)
    row_start: np.ndarray  # (G,) int32, 128-aligned DMA start
    first_row: np.ndarray  # (G,) int32 first row owned by the group
    end_row: np.ndarray  # (G,) int32 one past the last owned row
    img_base: np.ndarray  # (G,) int32, 128-aligned image-band start
    rel: np.ndarray  # (n_pad,) float32: tie rank % M per row, -1 padding
    imgrow: np.ndarray  # (n_pad,) float32: image rank per row, -1 padding
    n_tie: int
    n_img: int
    n_rows: int  # live rows (tie obs only; control obs follow)
    n_obs: int  # total observations (incl. control)
    n_pad: int  # padded stream length the kernel expects
    M: int  # tie ranks per group
    T: int  # worst-case 128-aligned span (lanes)
    W: int  # worst-case 128-aligned image-band width (lanes)
    n_img_pad: int  # padded image-axis length (>= img_base.max() + W)

    @property
    def G(self) -> int:
        return int(self.row_start.shape[0])

    @property
    def read_amplification(self) -> float:
        return self.G * self.T / max(self.n_rows, 1)

    @property
    def band_amplification(self) -> float:
        """Mean one-hot work vs the dense n_img alternative (W / n_img)."""
        return self.W / max(self.n_img, 1)


def _bands_for_order(tie_rank_per_obs, img_rank_per_obs, n_tie, M):
    """Group spans + image bands for one candidate ordering.

    Returns (order, row_start, first_row, end_row, img_lo, img_hi, T)
    with the stream sorted by tie rank (control obs, rank == n_tie,
    sorted last and excluded from every group)."""
    order = np.argsort(tie_rank_per_obs, kind="stable")
    ranks = tie_rank_per_obs[order]
    imgs = img_rank_per_obs[order]
    n_rows = int(np.searchsorted(ranks, n_tie))
    starts = np.searchsorted(ranks[:n_rows], np.arange(n_tie + 1)).astype(
        np.int64
    )
    G = max(1, -(-n_tie // M))
    pad = G * M - n_tie
    begs = np.concatenate([starts[:-1], np.full(pad, n_rows, np.int64)])
    ends = np.concatenate([starts[1:], np.full(pad, n_rows, np.int64)])
    gb = begs.reshape(G, M)
    ge = ends.reshape(G, M)
    first_row = gb[:, 0]
    end_row = ge[:, -1]
    row_start = _align_down(first_row, 128)
    span = end_row - row_start
    T = int(max(128, _align_up(int(span.max(initial=0)), 128)))
    # image band per group over its owned rows
    img_lo = np.zeros(G, np.int64)
    img_hi = np.ones(G, np.int64)
    for g in range(G):
        a, b = int(first_row[g]), int(end_row[g])
        if b > a:
            seg = imgs[a:b]
            img_lo[g] = int(seg.min())
            img_hi[g] = int(seg.max()) + 1
    return order, ranks, row_start, first_row, end_row, img_lo, img_hi, T


def build_band_plan(
    tie_per_obs: np.ndarray,
    img_per_obs: np.ndarray,
    n_tie: int,
    n_img: int,
    M: int = 128,
    max_T: int = 16 * 1024,
    max_W: int = 2048,
    try_image_reorder: bool = True,
) -> Optional[BandPlan]:
    """Build the banded plan, or None when the structure is too ragged
    (T or W past the VMEM/MXU-derived caps) and the caller should use
    the XLA gather/segsum path.

    `tie_per_obs` uses layout slot ids with n_tie marking control
    observations; `img_per_obs` original image indices."""
    if n_tie == 0:
        return None
    tie_per_obs = np.asarray(tie_per_obs, np.int64)
    img_per_obs = np.asarray(img_per_obs, np.int64)
    n_obs = tie_per_obs.shape[0]
    live = tie_per_obs < n_tie

    # -- tie renumbering by mean observing image id ----------------------
    sum_img = np.zeros(n_tie, np.float64)
    cnt = np.zeros(n_tie, np.float64)
    np.add.at(sum_img, tie_per_obs[live], img_per_obs[live])
    np.add.at(cnt, tie_per_obs[live], 1.0)
    key = np.where(cnt > 0, sum_img / np.maximum(cnt, 1.0), np.inf)
    slot_of_rank = np.argsort(key, kind="stable").astype(np.int32)
    rank_of_slot = np.empty(n_tie, np.int32)
    rank_of_slot[slot_of_rank] = np.arange(n_tie, dtype=np.int32)
    tie_rank_per_obs = np.where(
        live, rank_of_slot[np.minimum(tie_per_obs, n_tie - 1)], n_tie
    ).astype(np.int64)

    candidates = []
    ident = np.arange(n_img, dtype=np.int32)
    cand = _bands_for_order(tie_rank_per_obs, img_per_obs, n_tie, M)
    candidates.append((ident, ident, cand))

    if try_image_reorder and n_img > 1:
        # image renumbering by mean observing tie rank
        s2 = np.zeros(n_img, np.float64)
        c2 = np.zeros(n_img, np.float64)
        np.add.at(s2, img_per_obs[live], tie_rank_per_obs[live])
        np.add.at(c2, img_per_obs[live], 1.0)
        key2 = np.where(c2 > 0, s2 / np.maximum(c2, 1.0), np.inf)
        img_of_imgrank = np.argsort(key2, kind="stable").astype(np.int32)
        imgrank_of_img = np.empty(n_img, np.int32)
        imgrank_of_img[img_of_imgrank] = np.arange(n_img, dtype=np.int32)
        cand2 = _bands_for_order(
            tie_rank_per_obs, imgrank_of_img[img_per_obs].astype(np.int64),
            n_tie, M,
        )
        candidates.append((imgrank_of_img, img_of_imgrank, cand2))

    def width(c):
        _, _, _, _, _, lo, hi, _ = c
        base = _align_down(lo, 128)
        return int(_align_up(int((hi - base).max(initial=1)), 128))

    candidates.sort(key=lambda t: width(t[2]))
    imgrank_of_img, img_of_imgrank, best = candidates[0]
    order, ranks, row_start, first_row, end_row, img_lo, img_hi, T = best
    if T > max_T:
        return None

    n_rows = int(np.searchsorted(ranks, n_tie))
    img_ranked = imgrank_of_img[img_per_obs[order]].astype(np.int64)

    # -- control-observation tail: camera-only groups --------------------
    # Control obs (rank == n_tie) still contribute to the Hcc part of the
    # matvec (schur.py _cam_apply/_cam_applyT include them); cover the
    # tail with extra groups whose tie mask is empty (rel = -1).  Their
    # relative order is free, so sort by image rank for tight bands.
    if n_rows < n_obs:
        tail = np.argsort(img_ranked[n_rows:n_obs], kind="stable") + n_rows
        order = np.concatenate([order[:n_rows], order[tail], order[n_obs:]])
        img_ranked = imgrank_of_img[img_per_obs[order]].astype(np.int64)
        span_cap = max(T - 128, 128)
        t_first = np.arange(n_rows, n_obs, span_cap, dtype=np.int64)
        t_end = np.minimum(t_first + span_cap, n_obs)
        t_start = _align_down(t_first, 128)
        t_lo = np.array(
            [img_ranked[a:b].min() for a, b in zip(t_first, t_end)], np.int64
        )
        t_hi = np.array(
            [img_ranked[a:b].max() + 1 for a, b in zip(t_first, t_end)],
            np.int64,
        )
        T = max(T, int(_align_up(int((t_end - t_start).max()), 128)))
        row_start = np.concatenate([row_start, t_start])
        first_row = np.concatenate([first_row, t_first])
        end_row = np.concatenate([end_row, t_end])
        img_lo = np.concatenate([img_lo, t_lo])
        img_hi = np.concatenate([img_hi, t_hi])
        if T > max_T:
            return None

    img_base = _align_down(img_lo, 128)
    W = max(128, int(_align_up(int((img_hi - img_base).max(initial=1)), 128)))
    if W > max_W:
        return None
    n_img_pad = int(max(_align_up(n_img, 128), (img_base + W).max(initial=W)))

    n_pad = int(max(int(row_start.max(initial=0)) + T, n_obs))
    rel = np.full(n_pad, -1.0, np.float32)
    rel[:n_rows] = (ranks[:n_rows] % M).astype(np.float32)
    imgrow = np.full(n_pad, -1.0, np.float32)
    # control rows keep their image rank: they contribute to the camera
    # (Hcc) part of the matvec even without a tie block
    imgrow[:n_obs] = img_ranked.astype(np.float32)

    return BandPlan(
        order=order,
        rank_of_slot=rank_of_slot,
        slot_of_rank=slot_of_rank,
        imgrank_of_img=imgrank_of_img,
        img_of_imgrank=img_of_imgrank,
        row_start=row_start.astype(np.int32),
        first_row=first_row.astype(np.int32),
        end_row=end_row.astype(np.int32),
        img_base=img_base.astype(np.int32),
        rel=rel,
        imgrow=imgrow,
        n_tie=int(n_tie),
        n_img=int(n_img),
        n_rows=n_rows,
        n_obs=int(n_obs),
        n_pad=n_pad,
        M=int(M),
        T=int(T),
        W=int(W),
        n_img_pad=n_img_pad,
    )


@dataclasses.dataclass(frozen=True)
class ShardedBandPlan:
    """Group-partition of a global BandPlan over n_shards devices.

    The global banded stream is cut at GROUP boundaries (each group owns
    M tie ranks, so per-shard tie reductions are complete by construction
    — no boundary exchange needed); each shard's slice is the 128-aligned
    row window covering its groups, padded to a common slice_len.  Rows
    inside a shard's window but outside its groups' [first_row, end_row)
    union (alignment lead-in / tail, i.e. rows owned by a NEIGHBOR shard)
    are DUPLICATED into the window for DMA alignment but carried with
    W = 0 so the XLA-side per-row sums (costs, residual stats) never
    double count; the kernel masks them via fr/er regardless.

    All leading-axis-(n_shards) arrays shard on the mesh axis; the
    remaining fields are replicated / static.
    """

    # per-shard expanded stream: original obs row of each slot (-1 = dead)
    shard_rows: np.ndarray  # (n_shards, slice_len) int64
    owned: np.ndarray  # (n_shards, slice_len) bool — owned live rows
    # per-shard group geometry, LOCAL row offsets
    sb: np.ndarray  # (n_shards, G_loc) int32  row_start // 128 (local)
    fr: np.ndarray  # (n_shards, G_loc) int32
    er: np.ndarray  # (n_shards, G_loc) int32
    ib: np.ndarray  # (n_shards, G_loc) int32  img_base // 128 (global)
    rel: np.ndarray  # (n_shards, slice_len) f32
    imgrow: np.ndarray  # (n_shards, slice_len) f32
    # global maps (replicated)
    rank_of_slot: np.ndarray
    slot_of_rank: np.ndarray
    imgrank_of_img: np.ndarray
    img_of_imgrank: np.ndarray
    # owned copy of each original observation row in the CONCATENATED
    # (n_shards * slice_len) expanded stream (report-order recovery)
    owned_pos: np.ndarray  # (n_obs,) int64
    n_shards: int
    G_loc: int
    slice_len: int
    M: int
    T: int
    W: int
    n_tie: int
    n_img: int
    n_img_pad: int
    n_obs: int

    @property
    def rank_pad(self) -> int:
        """Global padded rank-axis length = n_shards * G_loc * M."""
        return self.n_shards * self.G_loc * self.M


def split_band_plan(plan: BandPlan, n_shards: int) -> ShardedBandPlan:
    """Partition `plan`'s groups across n_shards (see ShardedBandPlan)."""
    G = plan.G
    M, T = plan.M, plan.T
    G_loc = -(-G // n_shards)
    G_pad = G_loc * n_shards
    # pad with empty groups anchored at the stream end (fr == er -> no
    # live lanes; sb positioned so the slice window stays tight)
    end_anchor = int(plan.end_row[-1]) if G else 0
    anchor_start = _align_down(end_anchor, 128)
    row_start = np.concatenate(
        [plan.row_start, np.full(G_pad - G, anchor_start, np.int64)])
    first_row = np.concatenate(
        [plan.first_row, np.full(G_pad - G, end_anchor, np.int64)])
    end_row = np.concatenate(
        [plan.end_row, np.full(G_pad - G, end_anchor, np.int64)])
    img_base = np.concatenate(
        [plan.img_base, np.zeros(G_pad - G, np.int64)])

    bases = np.empty(n_shards, np.int64)
    ends = np.empty(n_shards, np.int64)
    for d in range(n_shards):
        gs = slice(d * G_loc, (d + 1) * G_loc)
        bases[d] = int(row_start[gs].min())
        ends[d] = int((row_start[gs] + T).max())
    slice_len = int(_align_up(int((ends - bases).max()), 128))

    # global padded per-row tables (extend past n_pad if windows overrun)
    need = int((bases + slice_len).max())
    rel_g = plan.rel
    img_g = plan.imgrow
    if need > rel_g.shape[0]:
        extra = need - rel_g.shape[0]
        rel_g = np.concatenate([rel_g, np.full(extra, -1.0, np.float32)])
        img_g = np.concatenate([img_g, np.full(extra, -1.0, np.float32)])

    shard_rows = np.full((n_shards, slice_len), -1, np.int64)
    owned = np.zeros((n_shards, slice_len), bool)
    sb = np.zeros((n_shards, G_loc), np.int32)
    fr = np.zeros((n_shards, G_loc), np.int32)
    er = np.zeros((n_shards, G_loc), np.int32)
    ib = np.zeros((n_shards, G_loc), np.int32)
    rel = np.full((n_shards, slice_len), -1.0, np.float32)
    imgrow = np.full((n_shards, slice_len), -1.0, np.float32)
    owned_pos = np.full(plan.n_obs, -1, np.int64)

    n_stream = plan.order.shape[0]  # live+control rows in stream order
    for d in range(n_shards):
        base = int(bases[d])
        gs = slice(d * G_loc, (d + 1) * G_loc)
        sb[d] = ((row_start[gs] - base) // 128).astype(np.int32)
        fr[d] = (first_row[gs] - base).astype(np.int32)
        er[d] = (end_row[gs] - base).astype(np.int32)
        ib[d] = (img_base[gs] // 128).astype(np.int32)
        hi = min(base + slice_len, rel_g.shape[0])
        rel[d, : hi - base] = rel_g[base:hi]
        imgrow[d, : hi - base] = img_g[base:hi]
        hi_rows = min(base + slice_len, n_stream)
        if hi_rows > base:
            shard_rows[d, : hi_rows - base] = plan.order[base:hi_rows]
        for g in range(d * G_loc, (d + 1) * G_loc):
            a, b = int(first_row[g]), int(end_row[g])
            if b > a:
                owned[d, a - base : b - base] = True
                rows = plan.order[a:b]
                owned_pos[rows] = d * slice_len + np.arange(a - base,
                                                           b - base)
    assert (owned_pos >= 0).all(), "every observation needs an owned copy"

    return ShardedBandPlan(
        shard_rows=shard_rows, owned=owned, sb=sb, fr=fr, er=er, ib=ib,
        rel=rel, imgrow=imgrow,
        rank_of_slot=plan.rank_of_slot, slot_of_rank=plan.slot_of_rank,
        imgrank_of_img=plan.imgrank_of_img,
        img_of_imgrank=plan.img_of_imgrank,
        owned_pos=owned_pos,
        n_shards=n_shards, G_loc=G_loc, slice_len=slice_len,
        M=M, T=T, W=plan.W, n_tie=plan.n_tie, n_img=plan.n_img,
        n_img_pad=plan.n_img_pad, n_obs=plan.n_obs,
    )
