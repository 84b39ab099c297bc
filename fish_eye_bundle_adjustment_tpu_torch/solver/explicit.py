"""Explicitly materialized reduced camera system (dense S).

PyTorch port of fish_eye_bundle_adjustment_tpu/solver/explicit.py.  Once
per Gauss-Newton step the reduced camera system

    S = Hcc - Hcp Hpp^-1 Hpc          (nc x nc, nc = 6 n_img + n_cam ni)

is built as a dense matrix, after which every CG matvec is one dense GEMV
(``S @ v``) and the Schur-Jacobi preconditioner is read off S's diagonal
blocks.

The coupling term is a sum over observation PAIRS sharing a tie point
(each (image, point) pair has exactly one observation):

    S_corr[ia, ib] += Mt_a @ Mt_b',   Mt_o = (Je' W Jp)_o @ chol(Hpp^-1)

The unordered cross pairs (a < b) are enumerated on the host once per
problem (PairPlan) and sorted by the flat block key ia * n_img + ib
(ia <= ib after a swap), so the device work is two row gathers, one
batched (6 x 3) @ (3 x 6) product and one sorted segment sum into the
(n_img^2, 36) block table.  Self pairs (a == b) reduce through the
stream's image sums.

Every reduction is a segment sum of ops/segment.py (gathers and the K4
chunk prefix, or the span segment sum in float32 where the JAX package
scatter-adds), so nothing scatters: no float atomics, and S repeats bit
for bit on the card.  The JAX module keeps its blocks in flat (P, 36)
columns because XLA:TPU pads the two trailing dimensions of every array
to (8, 128); here the blocks are (P, 6, 3) views and each product of
them is three broadcast products (``abt``).  The pair stream is padded once, in PairPlan, to whole K4
chunks, so its segment sum copies nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops.segment import (
    CHUNK,
    DirectPlan,
    SegmentLayout,
    SortPlan,
    sorted_segment_sum,
)


def _chol3x3(H):
    """Batched closed-form lower Cholesky of (m, 3, 3) SPD blocks."""
    a = torch.sqrt(H[:, 0, 0])
    b = H[:, 1, 0] / a
    c = H[:, 2, 0] / a
    d = torch.sqrt(H[:, 1, 1] - b * b)
    e = (H[:, 2, 1] - c * b) / d
    f = torch.sqrt(H[:, 2, 2] - c * c - e * e)
    z = torch.zeros_like(a)
    return torch.stack([a, z, z, b, d, z, c, e, f], dim=1).reshape(-1, 3, 3)


def tie_cam_plan(tie: np.ndarray, cam: np.ndarray, n_tie: int, n_cam: int,
                 dtype, device="cpu"):
    """Sums of a stream by (tie, camera) key, key = tie * n_cam + cam, over
    (n_tie * n_cam) segments: the JAX package's ``.at[key].add`` and
    ``np.add.at`` over that key.  Rows of the dummy tie slot (control
    observations, padding) fall past the last segment and are not read.
    float64: prefix differences of a SortPlan; float32: a DirectPlan in
    stream order, the scatter's."""
    key = np.minimum(tie, n_tie) * n_cam + cam
    n_seg = n_tie * n_cam
    if np.dtype(dtype) == np.float32:
        return DirectPlan.build(np.minimum(key, n_seg), n_seg, np.arange(key.size), device)
    return SortPlan.build(key, n_seg, device)


@dataclasses.dataclass
class PairPlan:
    """Static observation-pair structure for the explicit S_corr build.

    pa/pb index rows of the tie-sorted observation stream; pairs are
    sorted by flat block key ia * n_img + ib with ia <= ib and padded to
    whole K4 chunks with pairs past the last segment's end (row 0 twice),
    so the reduction into the (n_img^2,) block table is a sorted segment
    sum that reads no padding.  With several cameras and IOP unknowns,
    `by_tie_cam` sums the stream by (tie, camera)."""

    pa: torch.Tensor  # (P_pad,) int64 observation row of the first member
    pb: torch.Tensor  # (P_pad,) int64 second member; img[pa] <= img[pb]
    keys: SegmentLayout  # (n_img^2,) segments of the pair stream
    n_pairs: int  # P, live pairs
    by_tie_cam: Optional[SortPlan | DirectPlan] = None

    @staticmethod
    def build(tie_sorted: np.ndarray, img: np.ndarray, n_tie: int,
              n_img: int, device="cpu", cam: Optional[np.ndarray] = None,
              n_cam: int = 1, dtype=np.float64) -> "PairPlan":
        """Host-side enumeration of unordered cross pairs (a < b) of
        observations sharing a live tie, normalized and sorted by block
        key.  `tie_sorted` must be sorted ascending with control/padding
        rows carrying id >= n_tie.  `cam` (the stream's camera column)
        with n_cam > 1 adds the (tie, camera) sums."""
        tie_sorted = np.asarray(tie_sorted)
        n_live = int(np.searchsorted(tie_sorted, n_tie))
        ids = tie_sorted[:n_live]
        starts = np.searchsorted(ids, np.arange(n_tie + 1)).astype(np.int64)
        counts = np.diff(starts)
        # all ordered pairs (a, b) within a segment, then keep a < b
        seg_pairs = counts**2
        P_full = int(seg_pairs.sum())
        pair_seg = np.repeat(np.arange(n_tie), seg_pairs)
        offs = np.concatenate([[0], np.cumsum(seg_pairs)])
        within = np.arange(P_full) - np.repeat(offs[:-1], seg_pairs)
        k = counts[pair_seg]
        pa = starts[pair_seg] + within // np.maximum(k, 1)
        pb = starts[pair_seg] + within % np.maximum(k, 1)
        lt = pa < pb
        pa, pb = pa[lt], pb[lt]
        ia, ib = img[pa].astype(np.int64), img[pb].astype(np.int64)
        swap = ia > ib
        pa2 = np.where(swap, pb, pa)
        pb2 = np.where(swap, pa, pb)
        key = np.minimum(ia, ib) * n_img + np.maximum(ia, ib)
        order = np.argsort(key, kind="stable")
        P = int(key.size)
        pad = -P % CHUNK
        fill = np.zeros(pad, np.int64)
        by_tie_cam = None
        if cam is not None and n_cam > 1:
            by_tie_cam = tie_cam_plan(tie_sorted, np.asarray(cam), n_tie, n_cam, dtype, device)
        return PairPlan(
            pa=torch.as_tensor(np.concatenate([pa2[order], fill]), device=device),
            pb=torch.as_tensor(np.concatenate([pb2[order], fill]), device=device),
            keys=SegmentLayout.from_sorted_ids(key[order], n_img * n_img, device),
            n_pairs=P,
            by_tie_cam=by_tie_cam,
        )



def point_chol(fac):
    """chol(Hpp^-1) per tie as (n_tie + 1, 3, 3) lower factors, the last
    (dummy) one zero."""
    nt = fac.k.n_tie
    H = fac.Hpi_flat[:nt].reshape(nt, 3, 3)
    # tiny jitter keeps the Cholesky finite on degenerate (rank<3) points;
    # such points are equally degenerate in the matrix-free path.
    L = _chol3x3(H + 1e-30 * torch.eye(3, dtype=H.dtype, device=H.device))
    return torch.cat([L, L.new_zeros((1, 3, 3))])


def abt(A, B):
    """Rowwise A @ B' of (n, m, 3) and (n, k, 3) blocks -> (n, m, k), as
    three broadcast products added in order (the JAX module's flat-column
    sums): a batched GEMM of millions of such small blocks takes ~3x as
    long on the card."""
    return (A[:, :, None, 0] * B[:, None, :, 0] + A[:, :, None, 1] * B[:, None, :, 1]
            + A[:, :, None, 2] * B[:, None, :, 2])


def weighted_outer(fac, Ax, Ay, Bx, By):
    """Per-observation wx Ax' Bx + wy Ay' By: (N, m) x (N, n) -> (N, m, n)."""
    wx, wy = fac._w
    return ((wx[:, None] * Ax)[:, :, None] * Bx[:, None, :]
            + (wy[:, None] * Ay)[:, :, None] * By[:, None, :])


def coupling_factors(fac):
    """Mt_o = (Je' W Jp)_o @ chol(Hpp^-1_tie(o)) as (N, ne, 3), plus the
    unwhitened D_o = (Je' W Jp)_o (N, ne, 3).

    Rows of control observations (tie == n_tie) are zero (their Jp rows
    are masked in SchurFactors and the dummy factor is zero)."""
    D = weighted_outer(fac, fac.Jex, fac.Jey, fac.Jpx, fac.Jpy)  # (N, ne, 3)
    Lg = point_chol(fac)[fac.obs.tie]  # (N, 3, 3) row gather
    return abt(D, Lg.transpose(1, 2)), D


def build_dense_S(fac, pairs: PairPlan):
    """Materialize the dense reduced camera system S (nc x nc) from one
    linearization point."""
    k = fac.k
    ne, n_img = k.ne, k.n_img
    Mt, _ = coupling_factors(fac)  # (N, ne, 3)

    # ---- pose-pose: Hcc diag + pair correction --------------------------
    # self pairs a == b: sum_o (Hcc_o - Mt_o Mt_o') per image
    self_outer = abt(Mt, Mt)
    hcc = weighted_outer(fac, fac.Jex, fac.Jey, fac.Jex, fac.Jey)
    per_img = fac.obs.img_sum((hcc - self_outer).reshape(-1, ne * ne))

    # cross pairs a < b (block-key sorted): gather, product, segment sum
    prod = abt(Mt[pairs.pa], Mt[pairs.pb])
    U = sorted_segment_sum(prod.reshape(-1, ne * ne), pairs.keys)
    # mirror the strictly-upper blocks: S[ia, ib] = -U[ia, ib] and
    # S[ib, ia] = -U[ia, ib]' (a diagonal block ia == ib appears once in U
    # and takes both orientations: a < b pairs contribute only one)
    U4 = U.reshape(n_img, n_img, ne, ne)
    U_full = U4 + U4.permute(1, 0, 3, 2)
    S = -U_full.permute(0, 2, 1, 3).reshape(n_img * ne, n_img * ne)
    # Hcc minus the self-pair correction on the block diagonal, added
    # through a strided view of the diagonal blocks
    block_diagonal(S, n_img, ne).add_(per_img.reshape(n_img, ne, ne).permute(1, 2, 0))

    if k.ni:
        S = _append_iop_borders(fac, Mt, S, pairs)

    if k.opts.camera_damping:
        S = S + k.opts.camera_damping * torch.eye(k.nc, dtype=S.dtype, device=S.device)
    return S


def block_diagonal(M, b, m):
    """(m, m, b) strided view of the b diagonal (m, m) blocks of M (b*m,
    b*m), or of a (b*m, b*m) slice of a larger matrix."""
    return torch.diagonal(M.view(b, m, b, m), dim1=0, dim2=2)


def _append_iop_borders(fac, Mt, S, pairs: PairPlan):
    """Extend the pose-pose S with the IOP coupling columns/rows and the
    IOP-IOP block (full self-calibration, reference stage 3)."""
    k = fac.k
    ne, ni, nt, n_cam, n_img = k.ne, k.ni, k.n_tie, k.n_cam, k.n_img
    obs = fac.obs
    Fi = weighted_outer(fac, fac.Jix, fac.Jiy, fac.Jpx, fac.Jpy)  # (N, ni, 3)
    hii = weighted_outer(fac, fac.Jix, fac.Jiy, fac.Jix, fac.Jiy)  # (N, ni, ni)
    hci = weighted_outer(fac, fac.Jex, fac.Jey, fac.Jix, fac.Jiy)  # (N, ne, ni)
    L = point_chol(fac)[:nt]  # (nt, 3, 3)

    if n_cam == 1:
        Ei = obs.tie_sum(Fi.reshape(-1, ni * 3))[:nt].reshape(nt, ni, 3)
        EiL = abt(Ei, L.transpose(1, 2))  # (nt, ni, 3)
        Sii = (obs.cam_sum(hii.reshape(-1, ni * ni)).reshape(ni, ni)
               - torch.einsum("tip,tjp->ij", EiL, EiL))
        EiL_pad = torch.cat([EiL, EiL.new_zeros((1, ni, 3))])
        cross = abt(Mt, EiL_pad[obs.tie])  # (N, ne, ni)
        Sei = obs.img_sum((hci - cross).reshape(-1, ne * ni)).reshape(n_img * ne, ni)
        return torch.cat([torch.cat([S, Sei], dim=1), torch.cat([Sei.T, Sii], dim=1)])

    # several cameras: per-(tie, camera) IOP aggregates
    Ei = pairs.by_tie_cam.sum(Fi.reshape(-1, ni * 3))[: nt * n_cam].reshape(nt * n_cam, ni, 3)
    L_cam = L.repeat_interleave(n_cam, dim=0)  # (nt * n_cam, 3, 3)
    EiL = abt(Ei, L_cam.transpose(1, 2))  # (nt * n_cam, ni, 3)
    Hii = obs.cam_sum(hii.reshape(-1, ni * ni)).reshape(n_cam, ni, ni)
    Sii = -_cross_cam_corr(EiL, nt, n_cam, ni)
    block_diagonal(Sii, n_cam, ni).add_(Hii.permute(1, 2, 0))
    EiL_pad = torch.cat([EiL, EiL.new_zeros((n_cam, ni, 3))])
    # The direct Hci term exists only for an image's OWN camera (each
    # observation's Ji columns live in one camera's block), but the
    # point-elimination correction couples every image to EVERY camera's
    # IOPs through shared tie points: Sei[a, c] = Hci(a) [cam(a)==c]
    # - sum_{o in a} Mt_o @ EiL[tie(o), c]'.
    cam_blocks = []
    control = obs.tie >= nt
    for c in range(n_cam):
        # control rows (tie == nt) land in the zero pad rows
        key_c = torch.where(control, nt * n_cam + c, obs.tie * n_cam + c)
        cross_c = abt(Mt, EiL_pad[key_c])  # (N, ne, ni)
        direct_c = hci * (obs.cam == c)[:, None, None]
        per_img_c = obs.img_sum((direct_c - cross_c).reshape(-1, ne * ni))
        cam_blocks.append(per_img_c.reshape(n_img * ne, ni))
    Sei = torch.cat(cam_blocks, dim=1)  # (n_img*ne, n_cam*ni)
    return torch.cat([torch.cat([S, Sei], dim=1), torch.cat([Sei.T, Sii], dim=1)])


def _cross_cam_corr(EiL, nt, n_cam, ni):
    """sum_t EiL[t, c1] EiL[t, c2]' -> (n_cam*ni, n_cam*ni)."""
    E = EiL.reshape(nt, n_cam * ni * 3)
    G = E.T @ E  # (n_cam*ni*3, n_cam*ni*3) -- small (contract over ties)
    return torch.einsum("apbp->ab", G.reshape(n_cam * ni, 3, n_cam * ni, 3))


def dense_precond(S, kernel):
    """Exact Schur-Jacobi preconditioner read off the dense S diagonal.

    Unlike the matrix-free ``make_preconditioner`` (whose IOP block omits
    the point-elimination correction), both blocks here are true diagonal
    blocks of S."""
    ne, ni, n_img, n_cam = kernel.ne, kernel.ni, kernel.n_img, kernel.n_cam
    io = n_img * ne

    Pb = torch.linalg.inv(block_diagonal(S[:io, :io], n_img, ne).permute(2, 0, 1))
    Ib = (torch.linalg.inv(block_diagonal(S[io:, io:], n_cam, ni).permute(2, 0, 1))
          if ni else None)

    def apply(vc):
        parts = [torch.einsum("bij,bj->bi", Pb, vc[:io].reshape(n_img, ne)).reshape(-1)]
        if ni:
            parts.append(torch.einsum("bij,bj->bi", Ib, vc[io:].reshape(n_cam, ni)).reshape(-1))
        return torch.cat(parts)

    return apply
