"""Schur-complement Gauss-Newton solver: the float32 fused path.

PyTorch port of the single-device fused path of
fish_eye_bundle_adjustment_tpu/solver/schur.py.  Per-observation Jacobian
blocks feed a block-sparse normal system

    [ Hcc  Hcp ] [dc]   [gc]         c = poses (6/img) + shared IOPs
    [ Hpc  Hpp ] [dp] = [gp]         p = tie points (3/pt)

Point blocks are eliminated in closed form (Hpp is block-diagonal 3x3),
and the reduced camera system

    S dc = gc - Hcp Hpp^-1 gp,   S = Hcc - Hcp Hpp^-1 Hpc

is solved matrix-free with preconditioned conjugate gradients.  Every
S-product, the reduced right-hand side with the Schur-Jacobi
preconditioner blocks, and the back-substitution are one pass of the
fused banded operator (ops/fusedmv.py): a CUDA kernel on the card, its
plain PyTorch version on the CPU.  Free-network datum (Inner_Constraints):
CG runs projected onto null(G^T).

The slice covers ``solve_schur(problem, SchurOptions(dtype=np.float32),
compute_covariance=False)`` on a single-camera block with tie points,
driven by the host Gauss-Newton loop with the deferred Levenberg-Marquardt
control.  Every other configuration raises NotImplementedError naming the
ROADMAP.md item that ports it; nothing falls back.
"""

from __future__ import annotations

import dataclasses
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
from fish_eye_bundle_adjustment_tpu_torch.solver.constraints import (
    build_G,
    validate_inner_constraints,
)
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import DenseResult
from fish_eye_bundle_adjustment_tpu_torch.utils import checkpoint as ckpt_mod
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout
from fish_eye_bundle_adjustment_tpu_torch.utils.observe import (
    IterationRecord,
    SolverDivergence,
    Stopwatch,
    check_divergence,
)

# What each configuration outside the slice waits for (ROADMAP.md Queue 1).
_NOT_PORTED = {
    "unfused": "the unfused Schur path with ops/segment.py (ROADMAP.md Queue 1, item 1)",
    "explicit": "solver/explicit.py, the explicit dense-S PairPlan (ROADMAP.md Queue 1, item 5)",
    "covariance": "solver/covariance.py (ROADMAP.md Queue 1, item 6)",
    "device_loop": "solver/device_loop.py (ROADMAP.md Queue 1, item 7)",
}


def _not_ported(what: str, why: str) -> NotImplementedError:
    return NotImplementedError(f"{why}: needs {_NOT_PORTED[what]}, not ported yet")


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


@dataclasses.dataclass
class ObsData:
    """Per-observation tensors in banded-stream order, on one device."""

    img: torch.Tensor  # (n,) int64 image index
    pt: torch.Tensor  # (n,) int64 target index (into the full point table)
    tie: torch.Tensor  # (n,) int64 tie RANK, == n_tie for control obs
    xy: torch.Tensor  # (n, 2) measured coordinates
    W: torch.Tensor  # (n, 2) weights (0 on padding rows)
    ydir_cam: torch.Tensor  # (n_cam,)
    iop_scale_cam: torch.Tensor  # (n_cam, 3+nk+2) distortion conditioning
    band: BandArrays  # banded-stream structure for the fused kernels

    @staticmethod
    def from_problem(problem: BAProblem, layout: ParamLayout, band_plan,
                     dtype=np.float32, device="cpu") -> "ObsData":
        """The stream sorted by tie RANK (tie ids relabeled to ranks) and
        padded to the plan's n_pad, with the BandArrays attached."""
        n = problem.n_obs
        tie = problem.target_tie_slot[problem.obs_pt]
        tie = np.where(tie >= 0, tie, layout.n_tie)
        live = tie < layout.n_tie
        tie = np.where(
            live,
            band_plan.rank_of_slot[np.minimum(tie, layout.n_tie - 1)],
            layout.n_tie,
        )
        order = band_plan.order
        pad = band_plan.n_pad - n

        def _prep(a, fill=0):
            a = a[order]
            if pad:
                width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, width, constant_values=fill)
            return torch.as_tensor(a, device=device)

        idx = lambda a, fill=0: _prep(np.asarray(a, np.int64), fill)
        return ObsData(
            img=idx(problem.obs_img),
            pt=idx(problem.obs_pt),
            tie=idx(tie, fill=layout.n_tie),
            xy=_prep(problem.obs_xy.astype(dtype)),
            # zero weight rows: padding contributes nothing
            W=_prep(problem.obs_weights().astype(dtype)),
            ydir_cam=torch.as_tensor(problem.y_dir.astype(dtype), device=device),
            iop_scale_cam=torch.as_tensor(
                layout.iop_scale_full.astype(dtype), device=device
            ),
            band=BandArrays.from_plan(band_plan, device),
        )


@dataclasses.dataclass
class SchurOptions:
    """The JAX package's SchurOptions, same fields and defaults; see
    fish_eye_bundle_adjustment_tpu/solver/schur.py for the reasons behind
    each.  The port covers dtype=float32 with the fused path; the options
    of the paths not ported yet are kept so configurations carry over, and
    selecting one raises NotImplementedError in solve_schur."""

    cg_tol: float = 1e-10  # relative residual tolerance for the inner CG
    cg_maxiter: int = 500
    point_damping: float = 0.0  # optional LM damping on Hpp
    camera_damping: float = 0.0  # optional LM damping on the reduced system
    dtype: np.dtype = np.float64
    obs_order: Optional[str] = "tie"  # None | "img" | "tie" observation sort
    # explicit dense reduced camera system (solver/explicit.py, not ported)
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
    # accepted for API parity; the kernels compute in f32 throughout
    fused_precision: str = "bf16x2"
    fused_precision_mv: Optional[str] = None
    band_M: int = 128  # tie ranks per group
    band_max_W: int = 2048  # reject plans with wider image bands
    # on-device GN driver (solver/device_loop.py, not ported); None -> the
    # host loop
    device_loop: Optional[bool] = None
    device_chunk: int = 16


class SchurKernel:
    """Static problem structure + the block-sparse linear algebra, for one
    shared camera (the fused path's condition, see use_fused)."""

    def __init__(self, layout: ParamLayout, opts: SchurOptions):
        self.layout = layout
        self.opts = opts
        self.model_id = MODEL_IDS[layout.problem.settings.model]
        self.nk = layout.nk
        self.n_img = layout.n_img
        self.n_cam = layout.n_cam
        self.n_tie = layout.n_tie
        self.ne = layout.n_eop
        self.ni = layout.n_iop
        self.nc = layout.eop_size + layout.iop_size
        # kept for API parity (SchurOptions.fused_precision_mv); ignored by
        # the f32 kernels
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
        # one camera: its IOPs and y_dir are shared by every row
        r, Je, Ji, Jp = batched_jacobian_blocks(
            eop_o, iop[0], xyz_o, obs.xy, obs.ydir_cam[0],
            self.model_id, self.nk,
        )
        if self.ne:
            cols = self._col_index("eop_cols", q.device)
            Jex, Jey = Je[:, 0, cols], Je[:, 1, cols]
        else:
            Jex = Jey = Je[:, 0, :0]
        if self.ni:
            Jis = Ji / obs.iop_scale_cam[0][None, None, :]
            cols = self._col_index("iop_cols", q.device)
            Jix, Jiy = Jis[:, 0, cols], Jis[:, 1, cols]
        else:
            Jix = Jiy = Ji[:, 0, :0]
        live = (obs.tie < self.n_tie)[:, None]
        Jpx = Jp[:, 0, :] * live
        Jpy = Jp[:, 1, :] * live
        return r[:, 0], r[:, 1], Jex, Jey, Jix, Jiy, Jpx, Jpy

    def residual_cost(self, q, obs: ObsData):
        """True weighted SSR at q -- residual rows only, no Jacobians: the
        LM merit function.  Padded rows (W == 0) are masked BEFORE the
        product so garbage residuals on padding can't poison the sum."""
        eop, iop, pts = self.layout.unpack_scaled(q)
        r = batched_residuals(
            eop[obs.img], iop[0], pts[obs.pt], obs.xy, obs.ydir_cam[0],
            self.model_id, self.nk,
        )
        w = obs.W
        rm = torch.where(w > 0, r, torch.zeros_like(r))
        return _stable_sum(w[:, 0] * rm[:, 0] ** 2 + w[:, 1] * rm[:, 1] ** 2)

    def linearize(self, q, obs: ObsData, lam=None) -> "SchurFactors":
        """`lam` (0-d tensor or None) is the adaptive LM parameter:
        Marquardt scaling multiplies the Hpp diagonal by (1 + lam), so the
        damped Hpp^-1 flows through elimination, reduced rhs,
        back-substitution, and preconditioner consistently."""
        if not self.use_fused(obs):
            raise _not_ported("unfused", "this linearization is off the fused path")
        rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy = self.blocks(q, obs)
        wx, wy = obs.W[:, 0], obs.W[:, 1]
        return self._linearize_fused(
            obs, lam, rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy, wx, wy
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
        sx = torch.sqrt(wx).to(f32)
        sy = torch.sqrt(wy).to(f32)
        rows = [(Jex * sx[:, None]).T, (Jey * sy[:, None]).T]
        if self.ni:
            rows += [(Jix * sx[:, None]).T, (Jiy * sy[:, None]).T]
        acam_t = torch.cat(rows, dim=0).to(f32)
        ca_pad = -acam_t.shape[0] % 8
        n_here = acam_t.shape[1]
        acam_t = torch.nn.functional.pad(
            acam_t, (0, band.n_pad - n_here, 0, ca_pad)
        ).contiguous()
        apt_t = torch.cat([(Jpx * sx[:, None]).T, (Jpy * sy[:, None]).T]).to(f32)
        apt_t = torch.nn.functional.pad(
            apt_t, (0, band.n_pad - n_here, 0, 2)
        ).contiguous()
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


class SchurFactors:
    """One linearization point: residuals + blocks + eliminated points,
    with the transposed folded streams of the fused operator."""

    def __init__(self, kernel, obs, rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy,
                 Hpi_flat, acam_t, apt_t, hpi_t, dcc=None):
        self.k = kernel
        self.obs = obs
        self.rx, self.ry = rx, ry
        self.Jex, self.Jey = Jex, Jey
        self.Jix, self.Jiy = Jix, Jiy
        self.Jpx, self.Jpy = Jpx, Jpy
        self.Hpi_flat = Hpi_flat  # (n_tie + 1, 9), zero dummy row
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
            vi = vi_cam[0]
            ax = ax + self.Jix @ vi
            ay = ay + self.Jiy @ vi
        return ax, ay

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
        band = self.obs.band
        wx, wy = self._w
        ax = (torch.sqrt(wx) * self.rx).to(torch.float32)
        ay = (torch.sqrt(wy) * self.ry).to(torch.float32)
        rows = torch.stack([ax, ay])
        return torch.nn.functional.pad(
            rows, (0, band.n_pad - rows.shape[1], 0, 6)
        ).contiguous()

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
        k = self.k
        vpose, vi = self._fused_v(vc)
        out_pose, out_iop, _ = self._fused_apply(
            vpose=vpose, vi=vi, precision=k.mv_precision
        )
        out = self._fused_cam_out(out_pose, out_iop)
        if k.opts.camera_damping:
            out = out + k.opts.camera_damping * vc
        return out

    def reduced_rhs(self):
        """gc_tilde = -(C'W r - C'WP Hpp^-1 P'W r)."""
        out_pose, out_iop, _ = self._fused_apply(a_rows=self._fused_arows())
        return -self._fused_cam_out(out_pose, out_iop)

    def back_substitute(self, dc):
        """dp = Hpp^-1 (-P'W r - P'W C dc)  -> (n_tie, 3), in tie RANK
        order -- convert with tie_to_layout_order before packing."""
        k = self.k
        if not k.n_tie:
            return self.rx.new_zeros((0, 3))
        vpose, vi = self._fused_v(dc)
        _, _, y = self._fused_apply(vpose=vpose, vi=vi, a_rows=self._fused_arows())
        return -y[:3, : k.n_tie].T.to(self.rx.dtype)

    def tie_to_layout_order(self, vp):
        """Internal (rank-space) per-tie rows -> layout slot order."""
        return vp[self.obs.band.rank_of_slot]

    def tie_from_layout_order(self, vp):
        """Layout slot order -> the solver's internal tie id space."""
        return vp[self.obs.band.slot_of_rank]

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
            Ms.append((kind, torch.linalg.inv(B + eye_reg * eye)))
        return self._precond_apply_from(Ms)

    def rhs_and_precond(self, lam=None):
        """(reduced_rhs, preconditioner, raw diag(Hcc) or None) from one
        fused pass."""
        k = self.k
        band = self.obs.band
        out_pose, out_iop, _, p21, i55 = self._fused_apply(
            a_rows=self._fused_arows(), with_precond=True
        )
        rhs = -self._fused_cam_out(out_pose, out_iop)
        dtype = self.rx.dtype
        damp = k.opts.camera_damping
        blocks = []
        npair = k.ne * (k.ne + 1) // 2
        sym = p21[:npair, : k.n_img].T  # (n_img, npair) rank order
        sym = sym[band.imgrank_of_img].to(dtype)
        Pb = _expand_sym(sym, k.ne)
        if damp:
            Pb = Pb + damp * torch.eye(k.ne, dtype=dtype, device=Pb.device)
        blocks.append(("pose", Pb))
        if k.ni:
            ipair = k.ni * (k.ni + 1) // 2
            symi = i55[:ipair].sum(dim=1).reshape(1, ipair).to(dtype)
            Ib = _expand_sym(symi, k.ni)
            if damp:
                Ib = Ib + damp * torch.eye(k.ni, dtype=dtype, device=Ib.device)
            blocks.append(("iop", Ib))
        return rhs, self._precond_from_blocks(blocks, lam), self.dcc


def _pcg(matvec, b, precond, project, tol, maxiter):
    """Projected preconditioned CG.

    `project` restricts iterates to null(G^T) for free-network solves
    (identity otherwise).  Stops when ||r|| <= tol ||b|| or after maxiter
    iterations.  Curvature guard: on a PD system p'Ap > 0 in exact
    arithmetic, but f32 rounding near the CG noise floor of an
    ill-conditioned system can measure p'Ap <= 0 -- the unguarded step
    would then be huge and wrong-signed, so CG stops at the current
    iterate instead.  Returns (x, iterations taken, ||r|| / ||b||).  The
    comparisons run in the working dtype on the device; each reads one
    flag back to the host."""
    b = project(b)
    bnorm2 = torch.dot(b, b)
    tol2 = tol * tol * bnorm2

    def mv(v):
        return project(matvec(project(v)))

    x = torch.zeros_like(b)
    r = b
    z = project(precond(b))
    p = z
    rz = torch.dot(r, z)
    i = 0
    while i < maxiter and bool(torch.dot(r, r) > tol2):
        Ap = mv(p)
        pAp = torch.dot(p, Ap)
        if not bool(pAp > 0):
            break
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = project(precond(r))
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))
        p = z + beta * p
        rz = rz_new
        i += 1
    return x, i, torch.sqrt(torch.dot(r, r) / bnorm2)


def make_projection_builder(layout, nc, use_ic: bool):
    """Null(G^T) projector factory for free-network CG."""

    def build(q):
        if not use_ic:
            return lambda v: v
        G = build_G(layout, q)[:nc]  # G is zero on tie rows
        GtG_inv = torch.linalg.inv(G.T @ G)

        def project(v):
            return v - G @ (GtG_inv @ (G.T @ v))

        return project

    return build


def schur_step_fn(kernel: SchurKernel, layout: ParamLayout, use_ic: bool,
                  pairs=None):
    """One (damped) Gauss-Newton step as a function of (x, obs, cg_tol,
    lam) on the matrix-free fused path.  `cg_tol` and `lam` are Python
    floats or 0-d tensors (lam = 0 is a pure GN step).

    Returns (x_trial, L1(delta), v_local, stats, cg_iters) with stats =
    [vPv_model, sum_vx2, sum_vy2, cost_old]: vPv_model is the LINEARIZED
    weighted SSR at the trial point (sigma0^2 numerator, and the LM
    predicted cost), cost_old the TRUE weighted SSR at x."""
    if pairs is not None:
        raise _not_ported("explicit", "a PairPlan was given")
    opts = kernel.opts
    project_builder = make_projection_builder(layout, kernel.nc, use_ic)
    adaptive = opts.adaptive_damping

    def step(x, obs: ObsData, cg_tol, lam=0.0):
        scalar = lambda v: torch.as_tensor(v, dtype=x.dtype, device=x.device)
        scale = layout.scale_like(x)
        q = x * scale
        lam_t = scalar(lam) if adaptive else None
        fac = kernel.linearize(q, obs, lam=lam_t)
        wx, wy = obs.W[:, 0], obs.W[:, 1]
        zero = torch.zeros_like(fac.rx)
        rxm = torch.where(wx > 0, fac.rx, zero)
        rym = torch.where(wy > 0, fac.ry, zero)
        cost_old = _stable_sum(wx * rxm**2 + wy * rym**2)
        project = project_builder(q)
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
        stats = torch.stack([vPv, (vx * vx).sum(), (vy * vy).sum(), cost_old])
        v_local = torch.stack([vx, vy], dim=1)
        return x + delta_x, delta_x.abs().sum(), v_local, stats, cg_iters

    return step


def run_gn_loop(step, obs, layout, problem, opts: SchurOptions,
                keep_history=False, x0=None, progress_fn=None,
                checkpoint_path=None, checkpoint_every: int = 1,
                device="cpu"):
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
        if checkpoint_path is not None and count % checkpoint_every == 0:
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
    if order is not None:
        v_unsorted = np.empty_like(v_sorted)
        v_unsorted[order] = v_sorted
        v_sorted = v_unsorted
    return v_sorted.reshape(-1)


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
    (ops/bandplan.py); None otherwise.  Unlike the JAX package this needs
    no particular backend (the plain versions run the plan on the CPU),
    and it refuses more than 8 IOP unknowns, which the operator's 8-row
    IOP outputs cannot hold (the JAX gate lets them through; ROADMAP.md
    Queue 3)."""
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


def _resolve_device(device=None) -> torch.device:
    """`device` or, when None, "cuda" -- which must then exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "solve_schur: no CUDA device available; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels"
        )
    return dev


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
    """Outer Gauss-Newton loop with the fused Schur/PCG inner solve on one
    device (`device`, default "cuda").

    Matches the reference's convergence conventions (L1 of the de-scaled
    correction vs Threshold_Value, Iteration_Cap).  The slice runs
    float32 with the fused banded operator on a single-camera block with
    tie points; parameter stds (compute_covariance=True), the f64 and
    unfused paths, the explicit dense S and the device loop raise
    NotImplementedError.
    """
    opts = options or SchurOptions()
    if compute_covariance:
        raise _not_ported("covariance", "compute_covariance=True")
    if opts.explicit_s is True:
        raise _not_ported("explicit", "explicit_s=True")
    if opts.device_loop:
        raise _not_ported("device_loop", "device_loop=True")
    dev = _resolve_device(device)
    settings = problem.settings
    layout = ParamLayout(problem)
    use_ic = settings.inner_constraints
    if use_ic:
        validate_inner_constraints(layout)

    kernel = SchurKernel(layout, opts)
    band_plan = make_band_plan(problem, layout, opts)
    if band_plan is None:
        raise _not_ported(
            "unfused",
            "the fused path needs dtype=float32, fused != False, obs_order='tie', "
            "one camera, tie points, estimated poses, at most 8 IOP unknowns "
            "and a band plan within its caps",
        )
    obs = ObsData.from_problem(
        problem, layout, band_plan, dtype=opts.dtype, device=dev
    )
    raw_step = schur_step_fn(kernel, layout, use_ic)
    cg_iterations = []

    def step(x, o, tol, lam):
        out = raw_step(x, o, tol, lam)
        cg_iterations.append(int(out[4]))
        return out

    (x, history, delta_history, v_local, stats, count, converged,
     elapsed, stopped_on) = run_gn_loop(
        step, obs, layout, problem, opts,
        keep_history=keep_history, x0=x0, progress_fn=progress_fn,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, device=dev,
    )
    v_np = unpermute_v(v_local, band_plan.order, problem.n_obs)
    result = _finalize(
        problem, layout, x, history, delta_history, v_np,
        stats.double().cpu().numpy(), count, converged, elapsed,
        keep_history, stopped_on,
    )
    result.cg_iterations = cg_iterations
    return result
