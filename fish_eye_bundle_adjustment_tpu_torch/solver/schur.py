"""Schur-complement Gauss-Newton solver on one device.

PyTorch port of the single-device paths of
fish_eye_bundle_adjustment_tpu/solver/schur.py.  Per-observation Jacobian
blocks feed a block-sparse normal system

    [ Hcc  Hcp ] [dc]   [gc]         c = poses (6/img) + shared IOPs
    [ Hpc  Hpp ] [dp] = [gp]         p = tie points (3/pt)

Point blocks are eliminated in closed form (Hpp is block-diagonal 3x3),
and the reduced camera system

    S dc = gc - Hcp Hpp^-1 gp,   S = Hcc - Hcp Hpp^-1 Hpc

is solved matrix-free with preconditioned conjugate gradients.  Two
paths compute the same operator:

- fused (float32, one camera, tie points, at most 8 IOP unknowns, a band
  plan): every S-product, the reduced right-hand side with the
  Schur-Jacobi preconditioner blocks, and the back-substitution are one
  pass of the fused banded operator (ops/fusedmv.py);
- unfused (float64, and every float32 block the fused path refuses): each
  pass is gathers, per-observation block products and segment sums over
  the observation stream (ops/segment.py), by tie, image and camera.  The
  sums follow the JAX package's: where it takes prefix differences
  (obs_order="tie", a DualAxisPlan over the tie-sorted stream, by tie
  directly and by image through a static permutation) the port does too,
  over the K4 chunk prefix of ops/prefix.py; where it scatter-adds (the
  tie and image sums at obs_order "img" or None, the camera sums of
  several cameras) a float32 stream is summed directly, in the scatter's
  order, by the span segment sum of ops/streamseg.py (DirectPlan), and a
  float64 one keeps the prefix differences, which hold it to 1e-9.
  Nothing scatters, so no float atomics and runs repeat bit for bit.

A third form of the same step builds S itself: the explicit dense
reduced camera system of solver/explicit.py (``explicit_s=True``, and the
auto gate ``explicit_s=None`` at n_img <= explicit_s_max_images with
obs_order="tie" on the unfused path), after which each CG matvec is one
dense ``S @ v`` and the preconditioner is read off S's diagonal blocks.

The kernels run on the card; CPU tensors take their plain PyTorch
versions.  Free-network datum (Inner_Constraints): CG runs projected
onto null(G^T).  ``compute_covariance=True`` (the default) adds every
unknown's std from solver/covariance.py: the exact block covariance up to
1000 images, the Hutchinson estimate past them.

Two drivers run the deferred Levenberg-Marquardt control, as in the JAX
package: the host loop (`run_gn_loop`, one host read a step) and the
device loop (solver/device_loop.py: on a card the step is one replay of a
CUDA graph and the host reads once per chunk of steps).  solve_schur
takes the device loop where the JAX package does: with no explicit dense
S and no kept history (``device_loop=None``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Optional

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.models.projection import (
    MODEL_IDS,
    batched_jacobian_blocks,
    batched_residuals,
)
from fish_eye_bundle_adjustment_tpu_torch.ops.fusedmv import (
    BandArrays,
    fused_hpp_pass,
    fused_schur_apply,
)
from fish_eye_bundle_adjustment_tpu_torch.ops.segment import (
    CHUNK,
    DirectPlan,
    DualAxisPlan,
    SortPlan,
)
from fish_eye_bundle_adjustment_tpu_torch.solver.constraints import (
    build_G,
    validate_inner_constraints,
)
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import DenseResult, resolve_device
from fish_eye_bundle_adjustment_tpu_torch.solver.explicit import (
    PairPlan,
    build_dense_S,
    dense_precond,
)
from fish_eye_bundle_adjustment_tpu_torch.utils import checkpoint as ckpt_mod
from fish_eye_bundle_adjustment_tpu_torch.utils.cudagraph import run_if
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout
from fish_eye_bundle_adjustment_tpu_torch.utils.observe import (
    ADJUST,
    IterationRecord,
    SolverDivergence,
    Stopwatch,
    check_divergence,
    device_span,
    mark_stage,
    span,
)

# rows of the operator's IOP outputs (out_iop, di): one camera's IOPs fit
# when nk <= 3 with every IOP estimated
_MAX_FUSED_IOP = 8

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (as in SchurOptions.dtype) -> torch dtype."""
    return _TORCH_DTYPES[np.dtype(dtype)]


def _expand_sym(sym, k):
    """(m, k(k+1)/2) symmetric columns -> (m, k, k)."""
    out = sym.new_zeros(sym.shape[:1] + (k, k))
    idx = 0
    for e in range(k):
        for f in range(e, k):
            out[:, e, f] = sym[:, idx]
            out[:, f, e] = sym[:, idx]
            idx += 1
    return out


def _clamp_diag(d):
    """Marquardt-diagonal relative floor per block row: each entry of a
    (b, k) diag-block table clamped to >= 1e-6 * the row's max entry (and
    an absolute 1e-30), so lam * diag damping regularizes EVERY direction
    of the block."""
    mx = d.max(dim=-1, keepdim=True).values
    return torch.maximum(d, torch.clamp(1e-6 * mx, min=1e-30))


def _stable_sum(vals):
    """Two-stage chunked summation: pads to a multiple of 1024 and reduces
    (n/1024, 1024) -> (n/1024,) -> scalar, keeping the f32 relative error
    of a 1M-term weighted SSR near sqrt(N)*eps instead of N*eps -- the LM
    gain ratio subtracts two such sums, so accumulation noise directly
    widens the accept slack."""
    flat = vals.reshape(-1)
    pad = (-flat.shape[0]) % 1024
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, 1024).sum(dim=1).sum()


def _inv3x3(M):
    """Batched closed-form (adjugate) 3x3 inverse."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / det
    rows = [
        torch.stack([A, B, C], dim=-1),
        torch.stack([D, E, F], dim=-1),
        torch.stack([G, H, I], dim=-1),
    ]
    return torch.stack(rows, dim=-2) * inv_det[..., None, None]


def inv_blocks(A):
    """torch.linalg.inv without its error check, which reads the device's
    info flags back to the host (a CUDA graph cannot capture that read).
    The same LU and the same numbers: a singular block gives inf/nan, as
    the JAX package's jnp.linalg.inv does."""
    return torch.linalg.inv_ex(A).inverse


def shard_rows(n: int, n_shards: int):
    """(m, n_loc): the rows of the stream each of n_shards slices takes --
    the JAX package pads the stream to a multiple of n_shards and cuts it
    into equal contiguous slices of m rows -- and the rows each slice is
    padded to here, whole CHUNKs (at least one), so that no segment sum
    pads it again."""
    m = -(-n // n_shards)
    return m, max(1, -(-m // CHUNK)) * CHUNK


@dataclasses.dataclass
class ObsData:
    """Per-observation tensors on one device, with the structure that
    reduces them: a band plan's BandArrays (fused path) or the segment-sum
    plans (unfused path)."""

    img: torch.Tensor  # (n,) int64 image index
    cam: torch.Tensor  # (n,) int64 camera index
    pt: torch.Tensor  # (n,) int64 target index (into the full point table)
    tie: torch.Tensor  # (n,) int64 tie slot (RANK under a band plan), n_tie: control
    xy: torch.Tensor  # (n, 2) measured coordinates
    W: torch.Tensor  # (n, 2) weights (0 on padding rows)
    ydir_cam: torch.Tensor  # (n_cam,)
    iop_scale_cam: torch.Tensor  # (n_cam, 3+nk+2) distortion conditioning
    # host observation order of the stream's first n_obs rows
    order: np.ndarray
    # prefix-difference tie and image sums (unfused, obs_order "tie" or
    # float64): the tie-sorted stream, tie axis primary, image secondary
    plan: Optional[DualAxisPlan] = None
    # banded-stream structure for the fused kernels; `tie` then holds RANKs
    band: Optional[BandArrays] = None
    # direct tie and image sums (unfused float32 at obs_order "img"/None;
    # a banded stream builds them on first use, see _band_sums)
    by_tie: Optional[DirectPlan] = None
    by_img: Optional[DirectPlan] = None
    # per-camera sums of the unfused stream when n_cam > 1: direct in
    # float32, prefix differences in float64
    by_cam: Optional[SortPlan | DirectPlan] = None

    @staticmethod
    def from_problem(problem: BAProblem, layout: ParamLayout, band_plan=None,
                     dtype=np.float32, device="cpu", obs_order="tie",
                     n_shards: Optional[int] = None, shard: int = 0) -> "ObsData":
        """With `band_plan`: the stream sorted by tie RANK (tie ids
        relabeled to ranks) and padded to the plan's n_pad, with the
        BandArrays attached.  Without one, the unfused path's stream,
        padded once to a multiple of the segment sums' CHUNK so no
        reduction pads again: in sort_order_by_tie order with a
        DualAxisPlan; or, in float32 with `obs_order` other than "tie",
        image-major in problem order, as the JAX package's stream, with
        DirectPlans that add each tie's and each image's rows in problem
        order, the order of its scatter-add.  Several cameras add a
        camera plan: in float32 a DirectPlan in the order of the JAX
        package's stream, in float64 a SortPlan.  Padding rows have zero
        weight and the dummy tie slot; the unfused ones repeat the last
        row's image, point and coordinates, so their (ignored) residuals
        stay finite.

        `n_shards` (unfused only): rank `shard`'s slice of that stream, as
        the JAX package splits it over a mesh: the stream cut into
        n_shards contiguous slices of ceil(n_obs / n_shards) rows (see
        shard_rows), each padded on its own to whole CHUNKs, with the
        plans of its own rows (DualAxisPlan.build_sharded, local row
        offsets).  Every rank holds as many rows; `order` lists the host
        rows of the slice's live ones."""
        n = problem.n_obs
        tie = problem.target_tie_slot[problem.obs_pt]
        # control obs, and every obs when the tie points are held fixed
        # (layout.n_tie == 0), go to the dummy slot n_tie
        tie = np.where((tie >= 0) & (tie < layout.n_tie), tie, layout.n_tie)
        band = None
        if band_plan is not None and n_shards:
            raise ValueError("a band plan is split by split_band_plan, not by shards")
        if band_plan is not None:
            live = tie < layout.n_tie
            tie = np.where(
                live,
                band_plan.rank_of_slot[np.minimum(tie, layout.n_tie - 1)],
                layout.n_tie,
            )
            order = band_plan.order
            # stream row -> host row; padding rows read row 0 and are filled
            idx = np.concatenate([order, np.zeros(band_plan.n_pad - n, np.int64)])
            live = np.arange(band_plan.n_pad) < n
            band = BandArrays.from_plan(band_plan, device)
            edge = False
        else:
            # the span segment sum takes float32 only
            direct = np.dtype(dtype) == np.float32
            by_img = direct and obs_order != "tie"
            order = ObsData.stream_order(problem, layout, dtype, obs_order)
            # each row's position in the JAX package's stream: problem
            # order, or its tie-sorted order (this stream's own)
            pos = np.empty(n, np.int64)
            pos[order] = order if by_img else np.arange(n)
            # the whole stream, slice by slice (one slice on one device):
            # stream row -> host row, padding rows repeating their slice's
            # last row (the stream's, for an empty slice)
            n_sh = n_shards or 1
            m, n_loc = shard_rows(n, n_sh)
            idx_all = np.empty(n_sh * n_loc, np.int64)
            live_all = np.zeros(n_sh * n_loc, bool)
            for r in range(n_sh):
                rows = order[r * m : (r + 1) * m]
                last = rows[-1:] if len(rows) else order[-1:]
                idx_all[r * n_loc : (r + 1) * n_loc] = np.concatenate(
                    [rows, np.repeat(last, n_loc - len(rows))])
                live_all[r * n_loc : r * n_loc + len(rows)] = True
            sl = slice(shard * n_loc, (shard + 1) * n_loc)
            idx, live = idx_all[sl], live_all[sl]
            order = idx[live]
            edge = True

        def _host(a, fill=None):
            a = a[idx]
            if fill is not None or not edge:
                mask = live.reshape((-1,) + (1,) * (a.ndim - 1))
                a = np.where(mask, a, 0 if fill is None else fill).astype(a.dtype)
            return a

        on_dev = lambda a: torch.as_tensor(a, device=device)
        tie_h = _host(tie.astype(np.int64), fill=layout.n_tie)
        img_h = _host(problem.obs_img.astype(np.int64))
        cam_h = _host(problem.obs_cam.astype(np.int64))
        plans = {}
        if band is None:
            rank = np.where(live, pos[idx], n + np.arange(len(idx)))
            # the direct sums read no padding row, and no row of the dummy
            # tie slot, whose sum no caller reads: their ids are past the
            # last segment
            if by_img:
                plans["by_tie"] = DirectPlan.build(tie_h, layout.n_tie, rank, device)
                plans["by_img"] = DirectPlan.build(
                    np.where(live, img_h, layout.n_img), layout.n_img, rank, device)
            else:
                tie_all = np.where(live_all, tie[idx_all], layout.n_tie)
                plans["plan"] = DualAxisPlan.build_sharded(
                    tie_all, layout.n_tie + 1, problem.obs_img[idx_all].astype(np.int64),
                    layout.n_img, n_sh, shard, device)
            if problem.n_cam > 1:
                plans["by_cam"] = (
                    DirectPlan.build(np.where(live, cam_h, problem.n_cam),
                                     problem.n_cam, rank, device) if direct
                    else SortPlan.build(cam_h, problem.n_cam, device)
                )
        return ObsData(
            img=on_dev(img_h),
            cam=on_dev(cam_h),
            pt=on_dev(_host(problem.obs_pt.astype(np.int64))),
            tie=on_dev(tie_h),
            xy=on_dev(_host(problem.obs_xy.astype(dtype))),
            # zero weight rows: padding contributes nothing
            W=on_dev(_host(problem.obs_weights().astype(dtype), fill=0)),
            ydir_cam=on_dev(problem.y_dir.astype(dtype)),
            iop_scale_cam=on_dev(layout.iop_scale_full.astype(dtype)),
            order=order,
            band=band,
            **plans,
        )

    @staticmethod
    def stream_order(problem: BAProblem, layout: ParamLayout, dtype, obs_order) -> np.ndarray:
        """Host order of the unfused stream: image-major at float32 with
        `obs_order` other than "tie" (the direct sums'), else tie-sorted."""
        if np.dtype(dtype) == np.float32 and obs_order != "tie":
            return np.argsort(problem.obs_img, kind="stable")
        return ObsData.sort_order_by_tie(problem, layout)

    @staticmethod
    def sort_order_by_tie(problem: BAProblem, layout: ParamLayout) -> np.ndarray:
        """Stable observation order sorted by tie slot (control obs last)."""
        tie = problem.target_tie_slot[problem.obs_pt]
        tie = np.where(tie >= 0, tie, layout.n_tie)
        return np.argsort(tie, kind="stable")

    # -- the unfused path's reductions (segment sums) --------------------
    def tie_sum(self, vals):
        """(n, D) -> per-tie sums, (n_tie, D); the prefix sums add a last
        row, of the control observations and the padding, which callers
        drop."""
        if self.plan is None:
            return self._band_sums().by_tie.sum(vals)
        return self.plan.primary_sum(vals)

    def img_sum(self, vals):
        """(n, D) -> (n_img, D) per-image sums."""
        if self.plan is None:
            return self._band_sums().by_img.sum(vals)
        return self.plan.secondary_sum(vals)

    def _band_sums(self) -> "ObsData":
        """Direct tie and image plans over a banded stream, built on first
        use: the fused solve never reads them, but the unfused factor
        pieces (the covariance estimator's C^T b, P^T b and Schur-Jacobi
        blocks) do.  Each segment's rows add in the band stream's own row
        order, as a serial scatter-add over that stream.  Rows of the dummy
        tie slot (control observations) and of the padding get ids past
        the last segment: no caller reads their sums, and one long group
        of them would set the span kernel's time."""
        if self.by_tie is None and self.band is not None:
            band = self.band
            n_pad = self.tie.shape[0]
            live = np.arange(n_pad) < len(self.order)
            rank = np.arange(n_pad)
            dev = self.tie.device
            self.by_tie = DirectPlan.build(self.tie.cpu().numpy(), band.n_tie, rank, dev)
            self.by_img = DirectPlan.build(
                np.where(live, self.img.cpu().numpy(), band.n_img), band.n_img, rank, dev)
        return self

    def cam_sum(self, vals):
        """(n, D) -> (n_cam, D) per-camera sums."""
        if self.by_cam is None:  # one camera
            return vals.sum(dim=0, keepdim=True)
        return self.by_cam.sum(vals)


@dataclasses.dataclass
class SchurOptions:
    """The JAX package's SchurOptions, same fields and defaults; see
    fish_eye_bundle_adjustment_tpu/solver/schur.py for the reasons behind
    each."""

    cg_tol: float = 1e-10  # relative residual tolerance for the inner CG
    cg_maxiter: int = 500
    point_damping: float = 0.0  # optional LM damping on Hpp
    camera_damping: float = 0.0  # optional LM damping on the reduced system
    dtype: np.dtype = np.float64
    # None | "img" | "tie": picks the path as in the JAX package (the fused
    # operator and the explicit-S auto gate need "tie") and, on the unfused
    # float32 path, the order and the form of the tie and image sums (see
    # ObsData.from_problem)
    obs_order: Optional[str] = "tie"
    # explicit dense reduced camera system (solver/explicit.py): True
    # forces it, None picks it at n_img <= explicit_s_max_images
    explicit_s: Optional[bool] = None
    explicit_s_max_images: int = 600
    # Inexact-Newton forcing (Eisenstat-Walker style): the inner CG runs to
    # max(cg_tol, min(forcing_max, rel_progress^2)).
    adaptive_forcing: bool = True
    forcing_max: float = 1e-2
    # Adaptive Levenberg-Marquardt trust-region schedule (deferred
    # accept/reject on the true weighted SSR, Nielsen's lambda update,
    # Marquardt damping lam * diag(Hcc) / (1 + lam) on the Hpp diagonal).
    adaptive_damping: bool = True
    init_damping: float = 0.0  # lambda_0 (0 -> pure GN until a rejection)
    damping_kick: float = 1e-4  # lambda floor applied at the first rejection
    max_damping: float = 1e10  # exceeded -> SolverDivergence
    # f32 precision-floor stop: the last 5 accepted deltas flat within 2%
    # and not improving on the previous 5 -> converged, "plateau"
    plateau_detection: bool = True
    # fused banded operator (ops/fusedmv.py); None -> on where it applies
    fused: Optional[bool] = None
    # the fused operator's mask-contraction operands, rounded as the JAX
    # package's _dot rounds them: 'bf16' single pass | 'bf16x2' hi/lo split
    # (~1.5e-5 relative); rhs, back-substitution, preconditioner and K1 use
    # fused_precision, the CG matvec fused_precision_mv (None: 'bf16' at
    # u <= 600,000, where an inexact operator only perturbs the CG)
    fused_precision: str = "bf16x2"
    fused_precision_mv: Optional[str] = None
    band_M: int = 128  # tie ranks per group
    band_max_W: int = 2048  # reject plans with wider image bands
    # on-device GN driver (solver/device_loop.py): None -> on where it
    # applies (no explicit dense S, no kept history); device_chunk steps per
    # host read
    device_loop: Optional[bool] = None
    device_chunk: int = 16


class SchurKernel:
    """Static problem structure + the block-sparse linear algebra.

    `reduce_fn` is applied after every observation-axis segment sum and
    every sum over the stream: the identity on one device, a mesh's
    all-reduce (parallel/mesh.Mesh.psum) when each rank holds a slice of
    the stream."""

    def __init__(self, layout: ParamLayout, opts: SchurOptions, reduce_fn=None):
        self.layout = layout
        self.opts = opts
        self.reduce = reduce_fn or (lambda t: t)
        self.model_id = MODEL_IDS[layout.problem.settings.model]
        self.nk = layout.nk
        self.n_img = layout.n_img
        self.n_cam = layout.n_cam
        self.n_tie = layout.n_tie
        self.ne = layout.n_eop
        self.ni = layout.n_iop
        self.nc = layout.eop_size + layout.iop_size
        # CG-matvec operand precision (see SchurOptions.fused_precision_mv)
        self.mv_precision = opts.fused_precision_mv or (
            "bf16" if layout.u <= 600_000 else "bf16x2"
        )
        self._cols = {}

    def _col_index(self, name, device):
        key = (name, str(device))
        if key not in self._cols:
            cols = getattr(self.layout, name)
            self._cols[key] = torch.as_tensor(cols, dtype=torch.long, device=device)
        return self._cols[key]

    # -- linearization ---------------------------------------------------
    def blocks(self, q, obs: ObsData):
        """Residual + Jacobian blocks, split by residual row (x/y) as 2-D
        tensors (N, k)."""
        layout = self.layout
        eop, iop, pts = layout.unpack_scaled(q)
        eop_o = eop[obs.img]
        xyz_o = pts[obs.pt]
        iop_o, ydir_o = self._camera_rows(iop, obs)
        r, Je, Ji, Jp = batched_jacobian_blocks(
            eop_o, iop_o, xyz_o, obs.xy, ydir_o, self.model_id, self.nk,
        )
        if self.ne:
            cols = self._col_index("eop_cols", q.device)
            Jex, Jey = Je[:, 0, cols], Je[:, 1, cols]
        else:
            Jex = Jey = Je[:, 0, :0]
        if self.ni:
            if self.n_cam == 1:
                Jis = Ji / obs.iop_scale_cam[0][None, None, :]
            else:
                Jis = Ji / obs.iop_scale_cam[obs.cam][:, None, :]
            cols = self._col_index("iop_cols", q.device)
            Jix, Jiy = Jis[:, 0, cols], Jis[:, 1, cols]
        else:
            Jix = Jiy = Ji[:, 0, :0]
        live = (obs.tie < self.n_tie)[:, None]
        Jpx = Jp[:, 0, :] * live
        Jpy = Jp[:, 1, :] * live
        return r[:, 0], r[:, 1], Jex, Jey, Jix, Jiy, Jpx, Jpy

    def _camera_rows(self, iop, obs: ObsData):
        """(IOPs, y_dir) for the Jacobian pass: one camera's, shared by
        every row, or gathered per row for several cameras."""
        if self.n_cam == 1:
            return iop[0], obs.ydir_cam[0]
        return iop[obs.cam], obs.ydir_cam[obs.cam]

    def residual_cost(self, q, obs: ObsData):
        """True weighted SSR at q -- residual rows only, no Jacobians: the
        LM merit function.  Padded rows (W == 0) are masked BEFORE the
        product so garbage residuals on padding can't poison the sum."""
        eop, iop, pts = self.layout.unpack_scaled(q)
        iop_o, ydir_o = self._camera_rows(iop, obs)
        r = batched_residuals(
            eop[obs.img], iop_o, pts[obs.pt], obs.xy, ydir_o,
            self.model_id, self.nk,
        )
        w = obs.W
        rm = torch.where(w > 0, r, torch.zeros_like(r))
        return self.reduce(_stable_sum(w[:, 0] * rm[:, 0] ** 2 + w[:, 1] * rm[:, 1] ** 2))

    def linearize(self, q, obs: ObsData, lam=None) -> "SchurFactors":
        """`lam` (0-d tensor or None) is the adaptive LM parameter:
        Marquardt scaling multiplies the Hpp diagonal by (1 + lam), so the
        damped Hpp^-1 flows through elimination, reduced rhs,
        back-substitution, and preconditioner consistently."""
        rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy = self.blocks(q, obs)
        nt = self.n_tie
        wx, wy = obs.W[:, 0], obs.W[:, 1]
        if self.use_fused(obs):
            return self._linearize_fused(
                obs, lam, rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy, wx, wy
            )
        if obs.band is not None:
            raise ValueError("a banded stream takes the fused path only")
        # Hpp in symmetric 6-column form [00 01 02 11 12 22]
        sym6 = torch.stack(
            [wx * Jpx[:, a] * Jpx[:, b] + wy * Jpy[:, a] * Jpy[:, b]
             for a in range(3) for b in range(a, 3)],
            dim=1,
        )  # (N, 6)
        Hs = self.reduce(obs.tie_sum(sym6)[:nt])
        Hpp_inv = self._damped_hpp_inv(Hs, lam) if nt else rx.new_zeros((0, 3, 3))
        # row-flattened with a zero dummy row for per-observation gathers
        Hpi_flat = torch.cat([Hpp_inv.reshape(nt, 9), Hpp_inv.new_zeros((1, 9))])
        # adaptive LM: the UNDAMPED raw diag(Hcc) as a flat camera vector
        # (not diag(S), which the Schur correction can drive toward zero in
        # exactly the directions that need damping)
        dcc = None
        if lam is not None:
            parts = []
            if self.ne:
                de = wx[:, None] * Jex**2 + wy[:, None] * Jey**2  # (N, ne)
                parts.append(_clamp_diag(self.reduce(obs.img_sum(de))).reshape(-1))
            if self.ni:
                di = wx[:, None] * Jix**2 + wy[:, None] * Jiy**2
                parts.append(_clamp_diag(self.reduce(obs.cam_sum(di))).reshape(-1))
            dcc = torch.cat(parts) if parts else rx.new_zeros((0,))
        return SchurFactors(
            self, obs, rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy, Hpi_flat, dcc=dcc,
        )

    def _damped_hpp_inv(self, Hs, lam):
        """(nt, 6) sym columns -> damped, inverted (nt, 3, 3) blocks.

        Marquardt diag with a PER-TIE relative floor (each diag entry
        clamped to >= 1e-6 * the tie's max diag) keeps the damped block
        PD for every lam."""
        lam_fix = self.opts.point_damping + 1e-300
        i00, i01, i02, i11, i12, i22 = Hs.unbind(1)
        if lam is None:
            d0 = d1 = d2 = 0.0
        else:
            mx = torch.maximum(torch.maximum(i00, i11), i22)
            floor = 1e-6 * mx
            d0 = lam * torch.maximum(i00, floor)
            d1 = lam * torch.maximum(i11, floor)
            d2 = lam * torch.maximum(i22, floor)
        Hpp = torch.stack(
            [
                torch.stack([i00 + d0 + lam_fix, i01, i02], dim=1),
                torch.stack([i01, i11 + d1 + lam_fix, i12], dim=1),
                torch.stack([i02, i12, i22 + d2 + lam_fix], dim=1),
            ],
            dim=1,
        )  # (nt, 3, 3)
        return _inv3x3(Hpp)

    def _linearize_fused(self, obs, lam, rx, ry, Jex, Jey, Jix, Jiy,
                         Jpx, Jpy, wx, wy):
        """Fold the streams by sqrt(w), transpose them to (D, n_pad), then
        one fused_hpp_pass gives the per-tie Hpp columns AND the raw
        diag(Hcc)."""
        band = obs.band
        nt = self.n_tie
        f32 = torch.float32
        acam_t, apt_t = fold_streams(wx, wy, Jex, Jey, Jix, Jiy, Jpx, Jpy, band.n_pad)
        hs8, de8, di8 = fused_hpp_pass(
            band, acam_t, apt_t, self.ne, self.ni,
            precision=self.opts.fused_precision,
        )
        Hs = hs8[:6, :nt].T  # (nt, 6) rank order (kernel column = rank)
        Hpp_inv = self._damped_hpp_inv(Hs, lam)
        Hpi_flat = torch.cat([Hpp_inv.reshape(nt, 9), Hpp_inv.new_zeros((1, 9))])
        hpi_t = Hpp_inv.reshape(nt, 9).T.to(f32)
        hpi_t = torch.nn.functional.pad(
            hpi_t, (0, band.G * band.M - nt, 0, 7)
        ).contiguous()
        dcc = None
        if lam is not None:
            # kernel de columns are image-RANK; map to original order
            parts = []
            if self.ne:
                de = de8.T[band.imgrank_of_img][:, : self.ne]  # (n_img, ne)
                parts.append(_clamp_diag(de).reshape(-1).to(rx.dtype))
            if self.ni:
                di = di8[: self.ni].sum(dim=1).reshape(1, self.ni)
                parts.append(_clamp_diag(di).reshape(-1).to(rx.dtype))
            dcc = torch.cat(parts) if parts else rx.new_zeros((0,))
        return SchurFactors(
            self, obs, rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy, Hpi_flat,
            acam_t, apt_t, hpi_t, dcc,
        )

    def use_fused(self, obs: ObsData) -> bool:
        """Fused banded kernel applies: band plan built, f32, one shared
        camera, tie points present, pose block active, at most 8 IOP
        unknowns (the operator's IOP outputs have 8 rows)."""
        if obs.band is None or self.opts.fused is False:
            return False
        return (
            np.dtype(self.opts.dtype) == np.float32
            and self.n_cam == 1
            and self.n_tie > 0
            and self.ne > 0
            and self.ni <= _MAX_FUSED_IOP
        )


def fold_streams(wx, wy, Jex, Jey, Jix, Jiy, Jpx, Jpy, n_cols):
    """The fused kernels' streams: the Jacobian blocks folded by sqrt(w),
    float32, transposed and zero-padded to (CA, n_cols) -- the camera rows
    [Jex; Jey; Jix; Jiy] padded to a multiple of 8 -- and (8, n_cols)."""
    f32 = torch.float32
    sx = torch.sqrt(wx).to(f32)
    sy = torch.sqrt(wy).to(f32)
    rows = [(Jex * sx[:, None]).T, (Jey * sy[:, None]).T]
    if Jix.shape[1]:
        rows += [(Jix * sx[:, None]).T, (Jiy * sy[:, None]).T]
    acam_t = torch.cat(rows, dim=0).to(f32)
    pad_cols = n_cols - acam_t.shape[1]
    acam_t = torch.nn.functional.pad(
        acam_t, (0, pad_cols, 0, -acam_t.shape[0] % 8)).contiguous()
    apt_t = torch.cat([(Jpx * sx[:, None]).T, (Jpy * sy[:, None]).T]).to(f32)
    apt_t = torch.nn.functional.pad(apt_t, (0, pad_cols, 0, 2)).contiguous()
    return acam_t, apt_t


def fold_residuals(wx, wy, rx, ry, n_cols):
    """Whitened residual rows for the fused kernels' injection, float32,
    zero-padded to (8, n_cols)."""
    rows = torch.stack([(torch.sqrt(wx) * rx).to(torch.float32),
                        (torch.sqrt(wy) * ry).to(torch.float32)])
    return torch.nn.functional.pad(rows, (0, n_cols - rows.shape[1], 0, 6)).contiguous()


class SchurFactors:
    """One linearization point: residuals + blocks + eliminated points,
    with the transposed folded streams of the fused operator when it is
    on."""

    def __init__(self, kernel, obs, rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy,
                 Hpi_flat, acam_t=None, apt_t=None, hpi_t=None, dcc=None):
        self.k = kernel
        self.obs = obs
        self.rx, self.ry = rx, ry
        self.Jex, self.Jey = Jex, Jey
        self.Jix, self.Jiy = Jix, Jiy
        self.Jpx, self.Jpy = Jpx, Jpy
        self.Hpi_flat = Hpi_flat  # (n_tie + 1, 9), zero dummy row
        # transposed streams for the fused banded kernels (None when off)
        self.acam_t = acam_t
        self.apt_t = apt_t
        self.hpi_t = hpi_t
        # raw diag(Hcc) camera vector for adaptive-LM damping (None when
        # the linearization was built undamped)
        self.dcc = dcc

    # -- building blocks -------------------------------------------------
    @property
    def _w(self):
        return self.obs.W[:, 0], self.obs.W[:, 1]

    def _split(self, vc):
        k = self.k
        vp_img = vc[: k.layout.eop_size].reshape(k.n_img, k.ne)
        vi_cam = vc[k.layout.eop_size :].reshape(k.n_cam, k.ni)
        return vp_img, vi_cam

    def _cam_apply(self, vc):
        """(ax, ay) = C vc per observation, C = [Je | Ji]."""
        k = self.k
        vp_img, vi_cam = self._split(vc)
        ax = torch.zeros_like(self.rx)
        ay = torch.zeros_like(self.ry)
        if k.ne:
            vg = vp_img[self.obs.img]  # (N, ne) row gather
            ax = ax + (self.Jex * vg).sum(dim=1)
            ay = ay + (self.Jey * vg).sum(dim=1)
        if k.ni:
            if k.n_cam == 1:
                vi = vi_cam[0]
                ax = ax + self.Jix @ vi
                ay = ay + self.Jiy @ vi
            else:
                vg = vi_cam[self.obs.cam]
                ax = ax + (self.Jix * vg).sum(dim=1)
                ay = ay + (self.Jiy * vg).sum(dim=1)
        return ax, ay

    def _cam_applyT(self, bx, by):
        """C^T b reduced into the camera vector."""
        k = self.k
        parts = []
        if k.ne:
            g = self.Jex * bx[:, None] + self.Jey * by[:, None]  # (N, ne)
            parts.append(self.obs.img_sum(g).reshape(-1))
        if k.ni:
            g = self.Jix * bx[:, None] + self.Jiy * by[:, None]
            parts.append(self.obs.cam_sum(g).reshape(-1))
        return k.reduce(torch.cat(parts)) if parts else self.rx.new_zeros((0,))

    def _point_applyT(self, bx, by):
        """P^T b -> (n_tie, 3) (dummy control slot dropped)."""
        tp = self.Jpx * bx[:, None] + self.Jpy * by[:, None]  # (N, 3)
        return self.k.reduce(self.obs.tie_sum(tp)[: self.k.n_tie])

    def _point_apply(self, vp):
        """(px, py) = P vp per observation; control obs contribute zero."""
        vp_ext = torch.cat([vp, vp.new_zeros((1, 3))])
        yg = vp_ext[self.obs.tie]  # (N, 3) row gather
        return (self.Jpx * yg).sum(dim=1), (self.Jpy * yg).sum(dim=1)

    def _hpp_inv_apply(self, t):
        """y = Hpp^-1 t at tie scale: (n_tie, 3) -> (n_tie, 3)."""
        k = self.k
        H = self.Hpi_flat[: k.n_tie].reshape(k.n_tie, 3, 3)
        return torch.einsum("tpq,tq->tp", H, t)

    # -- fused banded operator plumbing (ops/fusedmv.py) -----------------
    @property
    def fused(self):
        return self.acam_t is not None

    def _fused_v(self, vc):
        """Camera vector -> ((8, n_img_pad) rank-ordered pose planes,
        (128,) IOP scalars)."""
        k = self.k
        band = self.obs.band
        vp_img, vi_cam = self._split(vc)
        vpose = self.acam_t.new_zeros((8, band.n_img_pad))
        vpose[: k.ne, : band.n_img] = vp_img[band.img_of_imgrank].to(torch.float32).T
        vi = self.acam_t.new_zeros(128)
        if k.ni:
            vi[: k.ni] = vi_cam[0].to(torch.float32)
        return vpose, vi

    def _fused_cam_out(self, out_pose, out_iop):
        """Kernel outputs -> flat camera vector in layout order."""
        k = self.k
        band = self.obs.band
        op = out_pose[: k.ne, : k.n_img].T  # (n_img, ne) rank order
        op = op[band.imgrank_of_img]  # original image order
        parts = [op.reshape(-1)]
        if k.ni:
            parts.append(out_iop[: k.ni].sum(dim=1))
        return torch.cat(parts).to(self.rx.dtype)

    def _fused_arows(self):
        """Whitened residual rows (8, n_pad) for rhs/backsub injection."""
        wx, wy = self._w
        return fold_residuals(wx, wy, self.rx, self.ry, self.obs.band.n_pad)

    def _fused_apply(self, vpose=None, vi=None, a_rows=None,
                     with_precond=False, precision=None):
        k = self.k
        return fused_schur_apply(
            self.obs.band, self.acam_t, self.apt_t, self.hpi_t,
            k.ne, k.ni, vpose=vpose, vi=vi, a_rows=a_rows,
            with_precond=with_precond,
            precision=precision or k.opts.fused_precision,
        )

    # -- Schur pieces ----------------------------------------------------
    def schur_matvec(self, vc):
        """S vc = C'WC vc - C'WP Hpp^-1 P'WC vc."""
        with device_span("schur_matvec", vc):
            return self._schur_matvec(vc)

    def _schur_matvec(self, vc):
        k = self.k
        if self.fused:
            vpose, vi = self._fused_v(vc)
            out_pose, out_iop, _ = self._fused_apply(
                vpose=vpose, vi=vi, precision=k.mv_precision
            )
            out = self._fused_cam_out(out_pose, out_iop)
        else:
            wx, wy = self._w
            ax, ay = self._cam_apply(vc)
            awx, awy = wx * ax, wy * ay
            if k.n_tie:
                y = self._hpp_inv_apply(self._point_applyT(awx, awy))
                # fold the correction into one image-axis reduction:
                # C'(aw) - C'(W P y) = C'(aw - W P y)
                px, py = self._point_apply(y)
                awx = awx - wx * px
                awy = awy - wy * py
            out = self._cam_applyT(awx, awy)
        if k.opts.camera_damping:
            out = out + k.opts.camera_damping * vc
        return out

    def reduced_rhs(self):
        """gc_tilde = -(C'W r - C'WP Hpp^-1 P'W r)."""
        if self.fused:
            out_pose, out_iop, _ = self._fused_apply(a_rows=self._fused_arows())
            return -self._fused_cam_out(out_pose, out_iop)
        wx, wy = self._w
        rwx, rwy = wx * self.rx, wy * self.ry
        if self.k.n_tie:
            y = self._hpp_inv_apply(self._point_applyT(rwx, rwy))
            px, py = self._point_apply(y)
            rwx = rwx - wx * px
            rwy = rwy - wy * py
        return -self._cam_applyT(rwx, rwy)

    def back_substitute(self, dc):
        """dp = Hpp^-1 (-P'W r - P'W C dc)  -> (n_tie, 3), in the solver's
        internal tie id space (tie RANK order under the band plan, layout
        slot order otherwise) -- convert with tie_to_layout_order before
        packing."""
        k = self.k
        if not k.n_tie:
            return self.rx.new_zeros((0, 3))
        if self.fused:
            vpose, vi = self._fused_v(dc)
            _, _, y = self._fused_apply(
                vpose=vpose, vi=vi, a_rows=self._fused_arows()
            )
            return -y[:3, : k.n_tie].T.to(self.rx.dtype)
        wx, wy = self._w
        ax, ay = self._cam_apply(dc)
        rhs = -self._point_applyT(wx * (self.rx + ax), wy * (self.ry + ay))
        return self._hpp_inv_apply(rhs)

    def tie_to_layout_order(self, vp):
        """Internal (rank-space) per-tie rows -> layout slot order."""
        if self.obs.band is None:
            return vp
        return vp[self.obs.band.rank_of_slot]

    def tie_from_layout_order(self, vp):
        """Layout slot order -> the solver's internal tie id space."""
        if self.obs.band is None:
            return vp
        return vp[self.obs.band.slot_of_rank]

    # -- Schur-Jacobi preconditioner, unfused ------------------------------
    def pose_precond_sym(self):
        """Per-observation symmetric columns (N, ne(ne+1)/2) of the
        pose-diagonal Schur blocks (Hcc diag minus the Hpp^-1 correction),
        un-reduced.  Each (image, point) pair is observed once, so the
        diagonal Schur correction Sum_o Je_o' W Jp_o Hpp^-1 Jp_o' W Je_o is
        one segment sum over observations."""
        k = self.k
        ne = k.ne
        wx, wy = self._w
        pairs = [(e, f) for e in range(ne) for f in range(e, ne)]
        cols = [
            wx * self.Jex[:, e] * self.Jex[:, f]
            + wy * self.Jey[:, e] * self.Jey[:, f]
            for e, f in pairs
        ]
        if k.n_tie:
            Hg = self.Hpi_flat[self.obs.tie]  # (N, 9) row gather
            # B[e][p] = (Je' W Jp)[e, p] per observation
            B = [
                [
                    wx * self.Jex[:, e] * self.Jpx[:, p]
                    + wy * self.Jey[:, e] * self.Jpy[:, p]
                    for p in range(3)
                ]
                for e in range(ne)
            ]
            # C[e][q] = sum_p B[e][p] H[p, q]
            C = [
                [sum(B[e][p] * Hg[:, 3 * p + q] for p in range(3)) for q in range(3)]
                for e in range(ne)
            ]
            for idx, (e, f) in enumerate(pairs):
                cols[idx] = cols[idx] - sum(C[e][q] * B[f][q] for q in range(3))
        return torch.stack(cols, dim=1)

    def iop_precond_sym(self):
        """Per-observation symmetric columns (N, ni(ni+1)/2) of the IOP
        diagonal blocks, un-reduced."""
        ni = self.k.ni
        wx, wy = self._w
        return torch.stack(
            [
                wx * self.Jix[:, e] * self.Jix[:, f]
                + wy * self.Jiy[:, e] * self.Jiy[:, f]
                for e in range(ni) for f in range(e, ni)
            ],
            dim=1,
        )

    def _sym_blocks(self, sym, nb):
        """(b, nb(nb+1)/2) symmetric columns -> (b, nb, nb) blocks, plus
        the fixed camera_damping on the diagonal."""
        out = _expand_sym(sym, nb)
        if self.k.opts.camera_damping:
            out = out + self.k.opts.camera_damping * torch.eye(
                nb, dtype=out.dtype, device=out.device
            )
        return out

    def pose_precond_blocks(self):
        """Exact Schur-Jacobi diagonal: per-image (ne, ne) blocks of S."""
        k = self.k
        return self._sym_blocks(k.reduce(self.obs.img_sum(self.pose_precond_sym())), k.ne)

    def iop_precond_blocks(self):
        """Per-camera (ni, ni) IOP diagonal blocks."""
        k = self.k
        return self._sym_blocks(k.reduce(self.obs.cam_sum(self.iop_precond_sym())), k.ni)

    def make_preconditioner(self, lam=None):
        """(preconditioner, raw diag(Hcc) or None); lam damps the blocks
        (see _precond_from_blocks)."""
        k = self.k
        blocks = []
        if k.ne:
            blocks.append(("pose", self.pose_precond_blocks()))
        if k.ni:
            blocks.append(("iop", self.iop_precond_blocks()))
        return self._precond_from_blocks(blocks, lam), self.dcc

    def _precond_apply_from(self, Ms):
        def apply(vc):
            vp_img, vi_cam = self._split(vc)
            parts = []
            for kind, Minv in Ms:
                v = vp_img if kind == "pose" else vi_cam
                parts.append(torch.einsum("bij,bj->bi", Minv, v).reshape(-1))
            return torch.cat(parts)

        return apply

    def _precond_from_blocks(self, blocks, lam):
        """Invert Schur-Jacobi diagonal blocks into the preconditioner
        apply fn, first damping each block's diagonal by lam * the
        matching slice of raw diag(Hcc) (self.dcc) -- the same damping the
        LM matvec adds.  `blocks` is [(kind, B)] with B (b, k, k) in
        [pose | iop] order matching the dcc layout."""
        eye_reg = 1e-300
        Ms = []
        off = 0
        for kind, B in blocks:
            nb = B.shape[-1]
            nrow = B.shape[0]
            eye = torch.eye(nb, dtype=B.dtype, device=B.device)
            if lam is not None and self.dcc is not None:
                d = self.dcc[off : off + nrow * nb].reshape(nrow, nb)
                B = B + lam * d[..., None] * eye
            off += nrow * nb
            Ms.append((kind, inv_blocks(B + eye_reg * eye)))
        return self._precond_apply_from(Ms)

    def rhs_and_precond(self, lam=None):
        """(reduced_rhs, preconditioner, raw diag(Hcc) or None): one fused
        pass when the banded operator is on, the separate unfused passes
        otherwise."""
        k = self.k
        if not self.fused:
            rhs = self.reduced_rhs()
            precond, dvec = self.make_preconditioner(lam)
            return rhs, precond, dvec
        band = self.obs.band
        out_pose, out_iop, _, p21, i55 = self._fused_apply(
            a_rows=self._fused_arows(), with_precond=True
        )
        rhs = -self._fused_cam_out(out_pose, out_iop)
        dtype = self.rx.dtype
        npair = k.ne * (k.ne + 1) // 2
        sym = p21[:npair, : k.n_img].T  # (n_img, npair) rank order
        sym = sym[band.imgrank_of_img].to(dtype)
        blocks = [("pose", self._sym_blocks(sym, k.ne))]
        if k.ni:
            ipair = k.ni * (k.ni + 1) // 2
            symi = i55[:ipair].sum(dim=1).reshape(1, ipair).to(dtype)
            blocks.append(("iop", self._sym_blocks(symi, k.ni)))
        return rhs, self._precond_from_blocks(blocks, lam), self.dcc


_CG_UNROLL = 8  # masked iterations per host check (see _pcg)

# What _pcg did since the last reset_cg_counts(): calls, flags read back to
# the host, and matvecs run (masked iterations included).
cg_counts = {"calls": 0, "host_reads": 0, "matvecs": 0}

_cg_mode = threading.local()


def reset_cg_counts():
    for key in cg_counts:
        cg_counts[key] = 0


@contextlib.contextmanager
def device_cg():
    """_pcg with no host read, in this thread (the device loop): each
    block of _CG_UNROLL masked iterations runs under the flag the host loop
    would read (utils/cudagraph.run_if: an IF node of a captured graph, or
    a read of host memory on the CPU)."""
    prev = getattr(_cg_mode, "device", False)
    _cg_mode.device = True
    try:
        yield
    finally:
        _cg_mode.device = prev


def _tmap(fn, *vs):
    """fn leaf by leaf over CG vectors: tensors, or tuples of tensors."""
    if isinstance(vs[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*vs))
    return fn(*vs)


def _pcg(matvec, b, precond, project, tol, maxiter, dot=None):
    """Projected preconditioned CG with masked iterations, as the JAX
    package's _pcg runs it.

    `project` restricts iterates to null(G^T) for free-network solves
    (identity otherwise).  Each iteration is masked: alpha and beta are
    forced to 0 once ||r|| <= tol ||b||, once the budget of maxiter is
    spent, or after the curvature guard trips, which makes every later
    iteration an exact no-op.  The count of iterations taken stays on the
    device.  At maxiter <= 2 * _CG_UNROLL the iterations are all issued
    with no host read; otherwise one flag (i < maxiter, r'r > tol^2 b'b,
    guard not tripped) decides each block of _CG_UNROLL: read back to the
    host before the block, or, under device_cg(), the condition of the
    block on the device.  The semantics are the guarded loop's: the same
    updates while active, the same x, count and stop.  The vectors are
    tensors, or tuples of tensors with `dot` their inner product (the
    sharded camera state of parallel/sharded_state.py: a rank's pose
    slice and the replicated
    IOPs, its dot an all-reduce); the flag read back must then be equal on
    every rank, which it is when `dot` is.  Curvature guard: on a PD system p'Ap > 0 in
    exact arithmetic, but f32 rounding near the CG noise floor of an
    ill-conditioned system can measure p'Ap <= 0 -- the unguarded step
    would then be huge and wrong-signed, so CG stops at the current
    iterate instead.  Masked iterations still run the matvec.  Returns
    (x, iterations taken as a 0-d int32 tensor, ||r|| / ||b||)."""
    cg_counts["calls"] += 1
    dot = dot or torch.dot
    b = project(b)
    bnorm2 = dot(b, b)
    tol2 = tol * tol * bnorm2
    zero, one = torch.zeros_like(bnorm2), torch.ones_like(bnorm2)

    def mv(v):
        cg_counts["matvecs"] += 1
        return project(matvec(project(v)))

    def masked_iter(state):
        i, x, r, z, p, rz, ok = state
        active = (dot(r, r) > tol2) & (i < maxiter) & ok
        Ap = mv(p)
        pAp = dot(p, Ap)
        ok = ok & (pAp > 0)
        take = active & (pAp > 0)
        alpha = torch.where(take, rz / torch.where(pAp != 0, pAp, one), zero)
        x = _tmap(lambda x_, p_: x_ + alpha * p_, x, p)
        r = _tmap(lambda r_, a_: r_ - alpha * a_, r, Ap)
        z = project(precond(r))
        rz_new = dot(r, z)
        beta = torch.where(take, rz_new / torch.where(rz != 0, rz, one), zero)
        p = _tmap(lambda z_, p_: torch.where(take, z_ + beta * p_, p_), z, p)
        rz = torch.where(take, rz_new, rz)
        return i + take.to(torch.int32), x, r, z, p, rz, ok

    def flag(state):
        """Whether the next block of iterations has work: the host loop's
        read, the device loop's IF node."""
        i, _, r, *_, ok = state
        return (i < maxiter) & (dot(r, r) > tol2) & ok

    z0 = project(precond(b))
    dev = bnorm2.device
    state = (torch.zeros((), dtype=torch.int32, device=dev),
             _tmap(torch.zeros_like, b), b, z0, z0, dot(b, z0),
             torch.ones((), dtype=torch.bool, device=dev))
    if maxiter <= 2 * _CG_UNROLL:
        for _ in range(maxiter):
            state = masked_iter(state)
    elif getattr(_cg_mode, "device", False):
        # the state in tensors of its own, which each block updates in place,
        # and the flag of the next block, which each block sets at its end:
        # a block that does not run leaves them as they are, so the blocks
        # past CG's stop compute nothing, not even their flag (an all-reduce
        # where `dot` is one) -- the flags computed are the host loop's reads
        live = [_tmap(torch.clone, t) for t in state]
        go = flag(live)

        def block():
            with device_span("pcg.block", go):
                out = tuple(live)
                for _ in range(_CG_UNROLL):
                    out = masked_iter(out)
                for dst, src in zip(live, out):
                    _tmap(lambda d, v: d.copy_(v), dst, src)
                go.copy_(flag(out))

        for _ in range(-(-maxiter // _CG_UNROLL)):
            run_if(go, block)
        state = tuple(live)
    else:
        def go_on(state):
            cg_counts["host_reads"] += 1
            return bool(flag(state))

        while go_on(state):
            with device_span("pcg.block", bnorm2):
                for _ in range(_CG_UNROLL):
                    state = masked_iter(state)
    i, x, r = state[:3]
    return x, i, torch.sqrt(dot(r, r) / bnorm2)


def cg_matvecs(iterations: int, maxiter: int) -> int:
    """The matvecs _pcg runs for a solve that took `iterations`, on the
    device or the host alike: all maxiter at maxiter <= 2 * _CG_UNROLL,
    else every block of _CG_UNROLL begun while CG was active.  (A block
    whose first iteration trips the curvature guard runs one block more.)"""
    if maxiter <= 2 * _CG_UNROLL:
        return maxiter
    return _CG_UNROLL * -(-iterations // _CG_UNROLL)


def make_projection_builder(layout, nc, use_ic: bool):
    """Null(G^T) projector factory for free-network CG."""

    def build(q):
        if not use_ic:
            return lambda v: v
        G = build_G(layout, q)[:nc]  # G is zero on tie rows
        GtG_inv = inv_blocks(G.T @ G)

        def project(v):
            return v - G @ (GtG_inv @ (G.T @ v))

        return project

    return build


def schur_step_fn(kernel: SchurKernel, layout: ParamLayout, use_ic: bool,
                  pairs=None):
    """One (damped) Gauss-Newton step as a function of (x, obs, cg_tol,
    lam).  `cg_tol` and `lam` are Python floats or 0-d tensors (lam = 0
    is a pure GN step).

    With `pairs` (a solver.explicit.PairPlan), the reduced camera system
    is built densely once per step and CG runs with GEMV matvecs and a
    preconditioner read off S's diagonal blocks; otherwise the
    matrix-free matvec (fused or unfused, as the linearization picks).

    Returns (x_trial, L1(delta), v_local, stats, cg_iters) with cg_iters a
    0-d device tensor and stats =
    [vPv_model, sum_vx2, sum_vy2, cost_old]: vPv_model is the LINEARIZED
    weighted SSR at the trial point (sigma0^2 numerator, and the LM
    predicted cost), cost_old the TRUE weighted SSR at x."""
    opts = kernel.opts
    project_builder = make_projection_builder(layout, kernel.nc, use_ic)
    adaptive = opts.adaptive_damping

    def step(x, obs: ObsData, cg_tol, lam=0.0):
        scalar = lambda v: torch.as_tensor(v, dtype=x.dtype, device=x.device)
        scale = layout.scale_like(x)
        q = x * scale
        lam_t = scalar(lam) if adaptive else None
        with device_span("linearize", q):
            fac = kernel.linearize(q, obs, lam=lam_t)
        wx, wy = obs.W[:, 0], obs.W[:, 1]
        zero = torch.zeros_like(fac.rx)
        rxm = torch.where(wx > 0, fac.rx, zero)
        rym = torch.where(wy > 0, fac.ry, zero)
        cost_old = _stable_sum(wx * rxm**2 + wy * rym**2)
        project = project_builder(q)
        if pairs is not None:
            S = build_dense_S(fac, pairs)
            if lam_t is not None:
                # damp with raw diag(Hcc) -- the dense-parity LM geometry
                S.diagonal().add_(lam_t * fac.dcc)
            matvec = lambda v: S @ v
            precond = dense_precond(S, kernel)
            rhs = fac.reduced_rhs()
        else:
            # one fused pass produces the rhs and the preconditioner blocks
            rhs, precond, dvec = fac.rhs_and_precond(lam=lam_t)
            if lam_t is not None:
                base_mv = fac.schur_matvec
                matvec = lambda v: base_mv(v) + (lam_t * dvec) * v
            else:
                matvec = fac.schur_matvec
        dc, cg_iters, _ = _pcg(
            matvec, rhs, precond, project, scalar(cg_tol), opts.cg_maxiter
        )
        dp = fac.back_substitute(dc)  # tie rank order
        delta_q = torch.cat([dc, fac.tie_to_layout_order(dp).reshape(-1)])
        delta_x = delta_q / scale
        # linearized residual rows (padding rows carry W=0 but a bogus raw
        # residual -- mask by weight sign)
        ax, ay = fac._cam_apply(dc)
        px, py = fac._point_apply(dp)
        vx = torch.where(wx > 0, ax + px + fac.rx, zero)
        vy = torch.where(wy > 0, ay + py + fac.ry, zero)
        vPv = _stable_sum(vx * vx * wx + vy * vy * wy)
        # the four sums over the stream, reduced together
        stats = kernel.reduce(
            torch.stack([vPv, (vx * vx).sum(), (vy * vy).sum(), cost_old]))
        v_local = torch.stack([vx, vy], dim=1)
        return x + delta_x, delta_x.abs().sum(), v_local, stats, cg_iters

    return step


def run_gn_loop(step, obs, layout, problem, opts: SchurOptions,
                keep_history=False, x0=None, progress_fn=None,
                checkpoint_path=None, checkpoint_every: int = 1,
                device="cpu", writes_checkpoints: bool = True):
    """The outer Gauss-Newton driver: convergence on L1 of the de-scaled
    correction vs Threshold_Value with Iteration_Cap (main.m:412,487-493),
    adaptive Eisenstat-Walker forcing for the inner CG tolerance,
    divergence detection, progress callbacks, and checkpoint/resume.

    Globalization (opts.adaptive_damping): each step is a TRIAL, validated
    DEFERRED against the next step's cost_old (the true weighted SSR at
    the trial point).  The gain ratio rho = actual / predicted decrease
    drives accept/reject and Nielsen's lambda schedule (accept: lam *=
    max(1/3, 1-(2 rho-1)^3), nu=2; reject: lam = max(nu*lam,
    damping_kick), nu *= 2, x unchanged).  Tiny steps (L1 <= threshold)
    are always accepted; an eps^(2/3) relative slack absorbs summation
    noise in the cost difference; lambda > max_damping raises
    SolverDivergence.

    Under a mesh every rank runs this loop in lockstep on replicated
    values; each resumes from the checkpoint, and only the rank with
    `writes_checkpoints` saves one.

    Returns (x, history, delta_history, v_local, stats, count, converged,
    elapsed, stopped_on)."""
    settings = problem.settings
    t0 = time.perf_counter()
    tdt = torch_dtype(opts.dtype)
    x = torch.as_tensor(
        (layout.initial() if x0 is None else np.asarray(x0)).astype(opts.dtype),
        dtype=tdt, device=device,
    )
    history = [x.cpu().numpy()] if keep_history else []
    delta_history = []
    v_local = None
    stats = torch.zeros(3)
    converged = False
    count = 0
    delta0 = None
    cg_tol = opts.forcing_max if opts.adaptive_forcing else opts.cg_tol
    # resume from a prior checkpoint when one exists (utils/checkpoint.py)
    if checkpoint_path is not None:
        resumed = ckpt_mod.load_checkpoint(checkpoint_path, problem)
        if resumed is not None:
            x = torch.as_tensor(resumed.x.astype(opts.dtype), device=device)
            count = resumed.iteration
            delta_history = list(resumed.delta_history)
            if delta_history:
                delta0 = max(delta_history[0], 1e-300)
                rel = delta_history[-1] / delta0
                cg_tol = max(opts.cg_tol, min(opts.forcing_max, rel * rel))
    watch = Stopwatch()
    adaptive = opts.adaptive_damping
    stopped_on = "cap"
    lam = float(opts.init_damping)
    nu = 2.0
    # cost-difference slack eps^(2/3) * cost (the scipy-TRF convention)
    slack_rel = float(np.finfo(np.dtype(opts.dtype)).eps) ** (2.0 / 3.0)

    # `pend` holds the yet-unvalidated trial
    pend = None

    def accept_pending():
        """Bookkeeping when the pending trial becomes an accepted iterate."""
        nonlocal count, x, v_local, stats, delta0, cg_tol, converged
        nonlocal stopped_on
        count += 1
        deltasum = pend["delta"]
        x, v_local, stats = pend["x_new"], pend["v"], pend["stats"]
        delta_history.append(deltasum)
        if not adaptive:
            check_divergence(count, deltasum, delta_history)
        if progress_fn is not None:
            progress_fn(IterationRecord(
                count, deltasum, watch.lap(), cg_tol, damping=lam,
            ))
        if (checkpoint_path is not None and writes_checkpoints
                and count % checkpoint_every == 0):
            ckpt_mod.save_checkpoint(
                checkpoint_path,
                ckpt_mod.SolverCheckpoint(
                    x=x.cpu().numpy(), iteration=count,
                    delta_history=delta_history,
                    meta={k: str(v) for k, v in
                          ckpt_mod.problem_fingerprint(problem).items()},
                ),
            )
        if opts.adaptive_forcing:
            delta0 = delta0 or max(deltasum, 1e-300)
            rel = deltasum / delta0
            cg_tol = max(opts.cg_tol, min(opts.forcing_max, rel * rel))
        if keep_history:
            history.append(x.cpu().numpy())
        # the reference's L1-of-correction contract (main.m:412), once the
        # damping has decayed back to ~pure GN
        if deltasum <= settings.threshold and (not adaptive or lam <= 1e-3):
            converged = True
            stopped_on = "threshold"
            return True
        if (
            opts.plateau_detection
            and len(delta_history) >= 10
            and lam <= 1e-3
        ):
            last = delta_history[-5:]
            prev = delta_history[-10:-5]
            m_last = sum(last) / 5.0
            m_prev = sum(prev) / 5.0
            flat = (max(last) - min(last)) <= 0.02 * abs(m_last)
            improving = m_last < 0.98 * m_prev
            if flat and not improving:
                converged = True
                stopped_on = "plateau"
                return True
        if count >= settings.iteration_cap:
            stopped_on = "cap"
            return True
        return False

    while True:
        x_in = pend["x_new"] if pend is not None else x
        x_trial, deltasum, v_trial, stats_t, _ = step(x_in, obs, cg_tol, lam)
        deltasum = float(deltasum)
        s = stats_t.double().cpu().numpy()
        cost_here = s[3]  # TRUE weighted SSR at x_in
        if pend is not None and adaptive:
            # validate the pending trial against the cost its point shows
            actual = pend["cost_prev"] - cost_here
            pred = pend["cost_prev"] - pend["model"]
            slack = slack_rel * max(pend["cost_prev"], 1.0)
            finite = np.isfinite(cost_here) and np.isfinite(pend["delta"])
            tiny = finite and pend["delta"] <= settings.threshold
            accept = tiny or (finite and actual >= -slack)
            if not accept:
                lam = max(lam * nu, opts.damping_kick)
                nu = min(nu * 2.0, 64.0)
                if lam > opts.max_damping:
                    raise SolverDivergence(
                        count + 1, pend["delta"], delta_history)
                if progress_fn is not None:
                    progress_fn(IterationRecord(
                        count, pend["delta"], watch.lap(), cg_tol,
                        accepted=False, damping=lam,
                    ))
                pend = None  # roll back; current outputs are from the bad
                continue  # trial point and are discarded with it
            rho = actual / pred if pred > slack else 1.0
            lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            if lam < 1e-14:
                lam = 0.0
            nu = 2.0
        if pend is not None:
            if accept_pending():
                break
        pend = {
            "x_new": x_trial, "cost_prev": cost_here, "model": s[0],
            "delta": deltasum, "v": v_trial, "stats": stats_t,
        }
        # a tiny trial needs no validation -- and neither does a pure-GN
        # trial when adaptivity is off
        if not adaptive or (
            np.isfinite(deltasum) and deltasum <= settings.threshold
        ):
            if accept_pending():
                break
            pend = None
    elapsed = time.perf_counter() - t0
    return (x, history, delta_history, v_local, stats, count, converged,
            elapsed, stopped_on)


def unpermute_v(v_local, order, n_obs):
    """Undo the solver's observation sort (and drop padding) so residual
    rows line up with the input .pho order."""
    v_sorted = v_local.cpu().numpy()[:n_obs]
    v_unsorted = np.empty_like(v_sorted)
    v_unsorted[order] = v_sorted
    return v_unsorted.reshape(-1)


def _finalize(problem, layout, x, history, delta_history, v_np, stats, count,
              converged, elapsed, keep_history, stopped_on=None):
    vPv, sx2, sy2 = (float(s) for s in np.asarray(stats)[:3])
    n = problem.n
    dof = n - layout.u
    if dof <= 0:
        import warnings

        warnings.warn(
            f"non-positive redundancy (n={n}, u={layout.u}): sigma0^2 "
            "clamped to v'Pv/1 — the adjustment is under-determined",
            stacklevel=2,
        )
    sigma02 = vPv / max(dof, 1)
    rms_x = float(np.sqrt(sx2 / problem.n_obs))
    rms_y = float(np.sqrt(sy2 / problem.n_obs))
    return DenseResult(
        problem=problem,
        layout=layout,
        x=x.cpu().numpy(),
        iterations=count,
        converged=converged,
        delta_history=delta_history,
        x_history=np.asarray(history) if keep_history else np.zeros((0, layout.u)),
        v=v_np,
        sigma02=sigma02,
        rms_x=rms_x,
        rms_y=rms_y,
        rms=float(np.sqrt(rms_x**2 + rms_y**2)),
        Cx=None,
        std=None,
        Cx_q=None,
        elapsed_s=elapsed,
        stopped_on=stopped_on,
    )


def make_band_plan(problem, layout, opts: SchurOptions):
    """Host-side banded plan for the fused operator when it applies
    (ops/bandplan.py); None -> the unfused path.  Unlike the JAX package
    this needs no particular backend (the plain versions run the plan on
    the CPU), and it refuses more than 8 IOP unknowns, which the
    operator's 8-row IOP outputs cannot hold (the JAX gate lets them
    through and fails; ROADMAP.md Queue 3): such blocks run unfused."""
    if opts.fused is False or opts.obs_order != "tie":
        return None
    if not (
        np.dtype(opts.dtype) == np.float32
        and problem.n_cam == 1
        and layout.n_tie > 0
        and layout.n_eop > 0
        and layout.n_iop <= _MAX_FUSED_IOP
    ):
        return None
    from fish_eye_bundle_adjustment_tpu_torch.ops.bandplan import build_band_plan

    tie = problem.target_tie_slot[problem.obs_pt]
    tie = np.where(tie >= 0, tie, layout.n_tie)
    return build_band_plan(
        tie, problem.obs_img, layout.n_tie, problem.n_img,
        M=opts.band_M, max_W=opts.band_max_W,
    )


def make_pair_plan(problem, layout, opts: SchurOptions, device="cpu"):
    """The static observation-pair plan of the explicit dense-S path when
    it applies, as the JAX package's make_pair_plan gates it: explicit_s
    True, or None at n_img <= explicit_s_max_images with obs_order="tie";
    with poses and tie points to pair.  None otherwise.  The plan indexes
    the tie-sorted stream (ObsData.sort_order_by_tie, the unfused path's
    order at obs_order="tie")."""
    tie_order = opts.obs_order == "tie"
    explicit = opts.explicit_s
    if explicit is None:
        explicit = problem.n_img <= opts.explicit_s_max_images and tie_order
    if not explicit or layout.n_eop == 0 or layout.n_tie == 0:
        return None
    if not tie_order:
        raise ValueError("explicit_s requires the tie-sorted obs order")
    order = ObsData.sort_order_by_tie(problem, layout)
    tie = problem.target_tie_slot[problem.obs_pt]
    tie = np.where((tie >= 0) & (tie < layout.n_tie), tie, layout.n_tie).astype(np.int64)
    return PairPlan.build(
        tie[order], problem.obs_img[order], layout.n_tie, layout.n_img, device,
        cam=problem.obs_cam[order] if layout.n_iop else None, n_cam=problem.n_cam,
        dtype=opts.dtype,
    )


def use_device_loop(opts: SchurOptions, keep_history: bool, pairs=None, mesh=None) -> bool:
    """Whether the device loop drives a solve: at device_loop=None the JAX
    package's rule (no explicit dense S, no kept history), False the host
    loop.  device_loop=True where the device loop does not apply raises,
    where the JAX package runs the host loop silently.  The rule is the same
    at every rank count on one host: over several ranks on the card the
    mesh's collectives are kernels (ops/peercoll.py) that the graph's IF
    nodes hold.  A `mesh` whose ranks span hosts takes the host loop: its
    collectives cross hosts over NCCL, which does not capture inside the
    IF nodes (the JAX package's XLA loop does run across hosts)."""
    if opts.device_loop is False:
        return False
    why = ("the explicit dense S (a PairPlan) runs the host loop" if pairs is not None
           else "keep_history runs the host loop" if keep_history
           else "a mesh that spans hosts runs the host loop (NCCL between hosts does not "
                "capture inside the device loop's IF nodes)"
           if mesh is not None and mesh.hosts is not None
           else None)
    if why is None:
        return True
    if opts.device_loop:
        raise ValueError(f"device_loop=True: {why}; pass device_loop=None or False")
    return False


def drive(raw_step, obs, layout, problem, opts, keep_history, pairs=None,
          writes_checkpoints=True, n_pad=None, mesh=None, **kw):
    """Run the GN loop use_device_loop picks over `raw_step`: (the loop's
    9-tuple, the CG iterations of every step as ints).  `kw` are the
    loops' common keywords (x0, progress_fn, checkpoint_path,
    checkpoint_every, device); `n_pad` and `mesh` (the Mesh of a
    distributed step) go to the device loop.  One call is one adjustment:
    the span ADJUST of a trace (utils/observe), whose end marks the stage
    "loop"."""
    with span(ADJUST, stage="loop"):
        return _drive(raw_step, obs, layout, problem, opts, keep_history, pairs,
                      writes_checkpoints, n_pad, mesh, **kw)


def _drive(raw_step, obs, layout, problem, opts, keep_history, pairs, writes_checkpoints,
           n_pad, mesh, **kw):
    if use_device_loop(opts, keep_history, pairs, mesh):
        from fish_eye_bundle_adjustment_tpu_torch.solver.device_loop import run_gn_loop_device

        cg_iterations = []
        out = run_gn_loop_device(
            raw_step, obs, layout, problem, opts, chunk=opts.device_chunk, n_pad=n_pad,
            writes_checkpoints=writes_checkpoints, cg_iterations=cg_iterations,
            mesh=mesh, **kw)
        return out, cg_iterations
    counted = []  # 0-d device counts, read once at the end

    def step(x, o, tol, lam):
        out = raw_step(x, o, tol, lam)
        counted.append(out[4])
        return out

    out = run_gn_loop(step, obs, layout, problem, opts, keep_history=keep_history,
                      writes_checkpoints=writes_checkpoints, **kw)
    return out, torch.stack(counted).tolist() if counted else []


def solve_schur(
    problem: BAProblem,
    options: Optional[SchurOptions] = None,
    keep_history: bool = False,
    x0=None,
    progress_fn=None,
    checkpoint_path=None,
    checkpoint_every: int = 1,
    compute_covariance: bool = True,
    device=None,
) -> DenseResult:
    """Outer Gauss-Newton loop with the Schur/PCG inner solve on one
    device (`device`, default "cuda").

    Matches the reference's convergence conventions (L1 of the de-scaled
    correction vs Threshold_Value, Iteration_Cap).  Dispatches in the JAX
    package's order: explicit_s=True forces the explicit dense S; else a
    band plan means the fused path; else the unfused path, with the
    explicit dense S where its auto gate is on (n_img <=
    explicit_s_max_images at obs_order="tie").  Parameter stds
    (compute_covariance=True) come from solver/covariance.py on the same
    device: the exact block covariance up to 1000 images, the Hutchinson
    estimate past them.  The device loop (solver/device_loop.py) drives
    the solve where the JAX package's rule puts it (use_device_loop).
    """
    opts = options or SchurOptions()
    dev = resolve_device(device, "solve_schur")
    result = _solve(problem, opts, keep_history, x0, progress_fn, checkpoint_path,
                    checkpoint_every, dev)
    if compute_covariance:
        from fish_eye_bundle_adjustment_tpu_torch.solver.covariance import compute_stds

        # the solve's device state (its stream, step and captured graph) went
        # with _solve's frame, but for what a cycle of frames holds: on the
        # CPU the first solve in a process imports torch._dynamo, whose
        # torch.fx.wrap keeps its own frame, and with it the first step's
        # frames and tensors.  The stds build their own stream and factors
        gc.collect()
        std, Cc_q, method = compute_stds(
            problem, result.layout, result.x, result.sigma02, device=dev
        )
        if std is not None:
            result.std = std
            result.Cc_q = Cc_q
            result.std_method = method
    return result


def _solve(problem, opts, keep_history, x0, progress_fn, checkpoint_path, checkpoint_every,
           dev) -> DenseResult:
    """solve_schur's Gauss-Newton solve on `dev`, without the stds; what it
    held on the device is released when it returns."""
    settings = problem.settings
    layout = ParamLayout(problem)
    use_ic = settings.inner_constraints
    if use_ic:
        validate_inner_constraints(layout)

    kernel = SchurKernel(layout, opts)
    # explicit_s=True is a force knob: honor it over the fused banded path
    band_plan = (None if opts.explicit_s is True
                 else make_band_plan(problem, layout, opts))
    pairs = (None if band_plan is not None
             else make_pair_plan(problem, layout, opts, dev))
    mark_stage("layout")
    obs = ObsData.from_problem(
        problem, layout, band_plan, dtype=opts.dtype, device=dev,
        obs_order=opts.obs_order,
    )
    mark_stage("obs")
    raw_step = schur_step_fn(kernel, layout, use_ic, pairs=pairs)
    (x, history, delta_history, v_local, stats, count, converged,
     elapsed, stopped_on), cg_iterations = drive(
        raw_step, obs, layout, problem, opts, keep_history, pairs,
        x0=x0, progress_fn=progress_fn, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, device=dev,
    )
    v_np = unpermute_v(v_local, obs.order, problem.n_obs)
    result = _finalize(
        problem, layout, x, history, delta_history, v_np,
        stats.double().cpu().numpy(), count, converged, elapsed,
        keep_history, stopped_on,
    )
    result.cg_iterations = cg_iterations
    mark_stage("finalize")
    return result
