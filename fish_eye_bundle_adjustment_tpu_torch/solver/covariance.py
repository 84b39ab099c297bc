"""Parameter covariance for the Schur path -- stds at scale.

PyTorch port of fish_eye_bundle_adjustment_tpu/solver/covariance.py.  The
reference reports a standard deviation for every unknown from
Cx = sigma0^2 * N^-1 (or the bordered [N G; G' 0]^-1 -- main.m:428-443,
712-897).  The Schur solver never materializes N, so this module computes
the same quantities from the block factors:

  camera block:   Cc = sigma0^2 * (S^-1  or  [S Gc; Gc' 0]^-1 top-left),
                  where S = Hcc - Hcp Hpp^-1 Hpc is the reduced camera
                  system (materialized DENSELY, once, at report time);
  point blocks:   Cp_t = sigma0^2 * (Hpp_t^-1 + Z_t' Cc Z_t),
                  Z_t = Hpp_t^-1-folded coupling columns of point t.

The coupling term factorizes per tie: Hcp Hpp^-1 Hpc = Ghat' Ghat with
Ghat[(t,p),(i,e)] = sum_o (D_o R_t)[e,p] (R = chol(Hpp^-1)) -- ONE dense
placement per tie chunk followed by GEMMs, covering the ee/ei/ii
corrections in a single product; the point variances are one quadratic
form diag3(Hpp^-1 + K' Cc K) per tie chunk.  Each (tie, image) pair is one
observation in any real block, so the placement writes each cell once
(checked on the host; repeated pairs are summed first by a host-built
segment plan) and nothing scatters with float atomics: the result repeats
bit for bit on the card.

Where it runs: the JAX package pins this float64 path to the host CPU
because float64 on a TPU is emulated.  An H100 runs float64 natively (its
tensor cores included), so here it runs on the solve's device, in
float64; the CPU only when the caller asks for it.  Complexity: GEMM
flops ~ nc^2 * 3 * n_tie (~n_img^3 at fixed density), S is
(6 n_img + n_cam ni)^2 -- gated by ``max_images`` (default 1000).  Past
the gate ``compute_stds`` takes the deflated Hutchinson estimator, whose
probe solves run the solver's own matvec (the fused K2 kernel on a
single-camera float32 block).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.ops.segment import SortPlan
from fish_eye_bundle_adjustment_tpu_torch.solver.constraints import build_G
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import resolve_device
from fish_eye_bundle_adjustment_tpu_torch.solver.explicit import (
    abt,
    block_diagonal,
    tie_cam_plan,
    weighted_outer,
)
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout
from fish_eye_bundle_adjustment_tpu_torch.utils.observe import mark_stage

@dataclasses.dataclass
class SchurCovariance:
    std: np.ndarray  # (u,) sigma0-scaled, de-scaled to x units
    Cc_q: np.ndarray  # (nc, nc) camera-block covariance, q-space,
    #                   pre-sigma02 (for report correlations, like Cx_q)


class _Pieces:
    """Wall seconds of named pieces, the device synchronized at each mark;
    a no-op without a dict to fill."""

    def __init__(self, out: Optional[dict], device):
        self.out, self.device = out, device
        self.t = time.perf_counter() if out is not None else None

    def mark(self, name):
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = self.out.get(name, 0.0) + now - self.t
        self.t = now


def schur_covariance(
    problem: BAProblem,
    layout: ParamLayout,
    x: np.ndarray,
    sigma02: float,
    max_images: int = 1000,
    device=None,
    pieces: Optional[dict] = None,
) -> Optional[SchurCovariance]:
    """Covariance diagonal (stds) + camera-block covariance at solution x,
    in float64 on `device` (None: the CUDA card).

    Returns None when n_img exceeds `max_images`.  `pieces`, when given,
    receives the wall seconds of linearize, hcc, coupling, placement,
    gemm and inverse (each ended by a device synchronization) and the
    GEMMs' flops."""
    if problem.n_img > max_images:
        return None
    dev = resolve_device(device, "schur_covariance")
    return _schur_covariance_impl(problem, layout, x, sigma02, dev, pieces)


def _cells(tie: np.ndarray, img: np.ndarray, n_live: int, n_img: int, device):
    """The (tie, image) cells of the tie-sorted stream's live rows: (tie,
    image) per cell and a function summing (n, ...) rows into cells --
    the identity on the live rows when every pair is one observation,
    else a SortPlan over the cell ids."""
    key = tie[:n_live].astype(np.int64) * n_img + img[:n_live]
    cells, inv = np.unique(key, return_inverse=True)
    if cells.size == n_live:
        return tie[:n_live], img[:n_live], lambda a: a[:n_live]
    plan = SortPlan.build(inv, cells.size, device)

    def to_cells(a):
        return plan.sum(a[:n_live].reshape(n_live, -1)).reshape(-1, *a.shape[1:])

    return cells // n_img, cells % n_img, to_cells


def _schur_covariance_impl(problem, layout, x, sigma02, dev, pieces=None):
    from fish_eye_bundle_adjustment_tpu_torch.solver.schur import (
        ObsData,
        SchurKernel,
        SchurOptions,
    )

    f64 = torch.float64
    clock = _Pieces(pieces, dev)
    opts = SchurOptions(dtype=np.float64, obs_order="tie")
    kernel = SchurKernel(layout, opts)
    ne, ni = kernel.ne, kernel.ni
    n_img, n_cam, nt = kernel.n_img, kernel.n_cam, kernel.n_tie
    nc = kernel.nc
    use_ic = problem.settings.inner_constraints

    obs = ObsData.from_problem(problem, layout, None, dtype=np.float64, device=dev,
                               obs_order="tie")
    x_t = torch.as_tensor(np.array(x, dtype=np.float64), device=dev)
    q = x_t * layout.scale_like(x_t)
    fac = kernel.linearize(q, obs)
    tie_np = obs.tie.cpu().numpy()
    img_np = obs.img.cpu().numpy()
    clock.mark("linearize")

    # ---- Hcc blocks (no Schur correction) ------------------------------
    J = {"e": (fac.Jex, fac.Jey), "i": (fac.Jix, fac.Jiy)}
    hcc = lambda a, b: weighted_outer(fac, *J[a], *J[b])  # (N, na, nb)
    if ne:
        ee = obs.img_sum(hcc("e", "e").reshape(-1, ne * ne)).reshape(n_img, ne, ne)
    if ne and ni:
        ei = obs.img_sum(hcc("e", "i").reshape(-1, ne * ni)).reshape(n_img, ne, ni)
    if ni:
        ii = obs.cam_sum(hcc("i", "i").reshape(-1, ni * ni)).reshape(n_cam, ni, ni)

    # ---- per-observation coupling blocks -------------------------------
    # D_o = Je' W Jp (ne,3); E_o = Ji' W Jp (ni,3); folded G_o = D_o Hpp^-1
    Hpi = fac.Hpi_flat[:nt].reshape(nt, 3, 3)
    Hg = fac.Hpi_flat[obs.tie].reshape(-1, 3, 3)  # zero rows for control obs
    if ne:
        D = weighted_outer(fac, fac.Jex, fac.Jey, fac.Jpx, fac.Jpy)
        G = abt(D, Hg.transpose(1, 2))
    # per-(tie, cam) IOP aggregates: Esum (nt, n_cam, ni, 3)
    Esum = EHsum = None
    if ni and nt:
        E = weighted_outer(fac, fac.Jix, fac.Jiy, fac.Jpx, fac.Jpy)
        plan = tie_cam_plan(tie_np, obs.cam.cpu().numpy(), nt, n_cam, np.float64, dev)
        Esum = plan.sum(E.reshape(-1, ni * 3))[: nt * n_cam].reshape(nt, n_cam, ni, 3)
        EHsum = torch.einsum("tcip,tpq->tciq", Esum, Hpi)
    clock.mark("hcc and coupling")

    # ---- assemble dense S ------------------------------------------------
    io = layout.eop_size  # offset of the IOP block inside the camera vector
    S = torch.zeros((nc, nc), dtype=f64, device=dev)
    if ne:
        block_diagonal(S[:io, :io], n_img, ne).copy_(ee.permute(1, 2, 0))
    if ne and ni:
        img_cam = torch.as_tensor(problem.img_cam.astype(np.int64), device=dev)
        S[:io, io:].view(n_img, ne, n_cam, ni)[
            torch.arange(n_img, device=dev), :, img_cam, :] = ei
        S[io:, :io] = S[:io, io:].T
    if ni:
        block_diagonal(S[io:, io:], n_cam, ni).copy_(ii.permute(1, 2, 0))

    # ---- Schur correction U = Ghat' Ghat as chunked dense GEMMs ----------
    #     U[(i,e),(j,f)] = sum_t  Ghat_t' Ghat_t,
    #     Ghat[(t,p), (i,e)] = sum_{o: tie=t, img=i} (D_o R_t)[e, p]
    # with Hpp^-1 = R R', extended with the folded IOP columns (Esum R):
    # ONE (3*chunk, nc) dense placement per tie chunk, then a GEMM.
    tie_chunk = max(1, min(nt, 16384)) if nt else 1
    gemm_flops = 0.0
    if nt:
        n_live = int(np.searchsorted(tie_np, nt))
        cell_tie, cell_img, to_cells = _cells(tie_np, img_np, n_live, n_img, dev)
        starts = np.searchsorted(cell_tie, np.arange(0, nt + 1))
        cell_tie_t = torch.as_tensor(cell_tie.astype(np.int64), device=dev)
        cell_img_t = torch.as_tensor(cell_img.astype(np.int64), device=dev)
        R = torch.linalg.cholesky(Hpi)  # (nt, 3, 3) lower
        R_pad = torch.cat([R, R.new_zeros((1, 3, 3))])
        M = to_cells(abt(D, R_pad[obs.tie].transpose(1, 2))) if ne else None
        Gcell = to_cells(G) if ne else None
        EsumR = torch.einsum("tcip,tpq->tciq", Esum, R) if ni else None
        ar3 = torch.arange(3, device=dev)
        ar_e = torch.arange(ne, device=dev)

        def placed(t0, t1, cell_vals, iop_vals):
            """(3c, nc) rows of ties [t0, t1): per-cell (ne, 3) blocks at
            (3 (t - t0) + p, img * ne + e), each cell written once, and the
            folded IOP columns."""
            c = t1 - t0
            r0, r1 = int(starts[t0]), int(starts[t1])
            out = torch.zeros((3 * c, nc), dtype=f64, device=dev)
            if ne and r1 > r0:
                rows = (3 * (cell_tie_t[r0:r1] - t0))[:, None, None] + ar3[None, None, :]
                cols = (cell_img_t[r0:r1] * ne)[:, None, None] + ar_e[None, :, None]
                out[rows, cols] = cell_vals[r0:r1]
            if ni:
                # folded IOP columns: out[3(t-t0)+q, io + cam*ni + i]
                out[:, io:].view(c, 3, n_cam, ni).copy_(iop_vals[t0:t1].permute(0, 3, 1, 2))
            return out

        U = torch.zeros((nc, nc), dtype=f64, device=dev)
        for t0 in range(0, nt, tie_chunk):
            t1 = min(t0 + tie_chunk, nt)
            Gh = placed(t0, t1, M, EsumR)
            clock.mark("placement")
            U += Gh.T @ Gh
            gemm_flops += 2.0 * Gh.shape[0] * nc * nc
            clock.mark("gemm")
        S -= U

    # ---- invert (f64) -----------------------------------------------------
    if use_ic:
        Gc = build_G(layout, q)[:nc]  # (nc, 7); tie rows are zero
        d = Gc.shape[1]
        K = torch.zeros((nc + d, nc + d), dtype=f64, device=dev)
        K[:nc, :nc] = S
        K[:nc, nc:] = Gc
        K[nc:, :nc] = Gc.T
        # the bordered system is indefinite: an LU inverse, as np.linalg.inv
        Cc = torch.linalg.inv(K)[:nc, :nc]
    else:
        Cc = torch.linalg.inv(S)
    clock.mark("inverse")

    # ---- stds ------------------------------------------------------------
    var_q = torch.zeros(layout.u, dtype=f64, device=dev)
    var_q[:nc] = torch.diagonal(Cc)
    if nt:
        # pvar_t = diag3(Hpp^-1 + K_t' Cc K_t) with K_t the full camera-
        # to-point coupling (pose columns G_o = D_o Hpp^-1, IOP columns
        # EHsum): one quadratic form, the same chunked placement as U
        pvar = torch.diagonal(Hpi, dim1=1, dim2=2).clone()  # (nt, 3)
        for t0 in range(0, nt, tie_chunk):
            t1 = min(t0 + tie_chunk, nt)
            Kh = placed(t0, t1, Gcell, EHsum)
            clock.mark("placement")
            T = Kh @ Cc
            gemm_flops += 2.0 * Kh.shape[0] * nc * nc
            pvar[t0:t1] += (Kh * T).sum(dim=1).reshape(t1 - t0, 3)
            clock.mark("gemm")
        var_q[layout.tie_offset:] = pvar.reshape(-1)

    var_x = var_q / layout.scale_like(var_q) ** 2 * sigma02
    std = torch.sqrt(torch.clamp(var_x, min=0.0))
    out = SchurCovariance(std=std.cpu().numpy(), Cc_q=Cc.cpu().numpy())
    clock.mark("stds")
    if pieces is not None:
        pieces["gemm_flops"] = gemm_flops
    return out


# ---------------------------------------------------------------------------
# Selected-diagonal estimation past the dense-S gate (stds at scale)
# ---------------------------------------------------------------------------

def estimate_schur_stds(
    problem: BAProblem,
    layout: ParamLayout,
    x: np.ndarray,
    sigma02: float,
    n_probe: int = 64,
    seed: int = 0,
    cg_tol: float = 1e-5,
    cg_maxiter: int = 400,
    dtype=np.float32,
    mesh=None,
    device=None,
    info: Optional[dict] = None,
) -> np.ndarray:
    """Hutchinson estimate of every unknown's standard deviation.

    Past the dense-S gate this estimates diag(N^-1) with Rademacher probes
    through the matrix-free Schur machinery.  With K = Hcp Hpp^-1 the
    blocks of N^-1 are

        camera:  Cc = S^-1          points:  Hpp^-1 + K' Cc K

    and the probes are SPLIT per block (ec with ep=0, and ep with ec=0):
    a joint probe's cross terms have zero mean but dominate the
    estimator's variance.  Each half subtracts an exact control variate:

        camera probes:  d .* ec .* (Cc w - M w)     + exact diag(M),
                        w = ec ./ d,  d = sqrt(diag(M))
        point  probes:  ep .* (K' Cc K ep)          + exact diag(Hpp^-1)

    (M = the solver's block-Jacobi preconditioner).  The camera probes are
    importance-scaled by d, so the per-entry relative error is uniform.
    The dominant low-rank part of S^-1 (near-gauge modes of a weak datum)
    is deflated exactly: V spans its k-dim eigenspace by inverse subspace
    iteration, diag(Cc V V') is computed from Cc V, and only the remainder
    is sampled.  With inner constraints the probe solves run projected
    onto Null(G'), matching the minimum-norm covariance.

    Cost: 2 k + k + n_probe PCG solves (k = min(16, nc // 4)).  The block
    is linearized ONCE and its factors serve every solve (the JAX package
    re-linearizes inside each jitted probe; the numbers are the same).  A
    single-camera float32 block takes the fused operator, so every CG
    matvec is one K2 launch.  With `mesh` (parallel/mesh.Mesh, every rank
    calling) the probe solves run over it, as the JAX package's SPMD probe
    solves: each rank holds its slice of the float32 unfused tie-sorted
    stream (the chunk prefix K4 under its sums) on mesh.device, and every
    sum is all-reduced, so every rank returns the same stds.  `info`, when
    given, receives the CG iterations of every solve (`cg_iterations`) and
    the same by class of solve, in the order they ran (`cg_classes`):
    "subspace" (the deflation basis's inverse subspace iterations, 2 k),
    "deflation" (Cc V, k), "camera" and "point" (the probes)."""
    from fish_eye_bundle_adjustment_tpu_torch.solver.schur import (
        ObsData,
        SchurKernel,
        SchurOptions,
        _pcg,
        make_band_plan,
        make_projection_builder,
        torch_dtype,
    )

    tdt = torch_dtype(dtype)
    opts = SchurOptions(dtype=dtype, obs_order="tie")
    if mesh is None:
        dev = resolve_device(device, "estimate_schur_stds")
        kernel = SchurKernel(layout, opts)
        band_plan = make_band_plan(problem, layout, opts)
        obs = ObsData.from_problem(problem, layout, band_plan, dtype=dtype, device=dev,
                                   obs_order="tie")
    else:
        dev = mesh.device
        kernel = SchurKernel(layout, opts, reduce_fn=mesh.psum)
        obs = ObsData.from_problem(problem, layout, None, dtype=dtype, device=dev,
                                   obs_order="tie", n_shards=mesh.size, shard=mesh.index)
    mark_stage("stds obs")
    use_ic = problem.settings.inner_constraints
    q = torch.as_tensor((np.asarray(x) * layout.scale).astype(dtype), device=dev)
    nc, nt = kernel.nc, kernel.n_tie
    fac = kernel.linearize(q, obs)
    project = make_projection_builder(layout, nc, use_ic)(q)
    precond = fac.make_preconditioner()[0]
    wx, wy = fac._w
    iters = []
    # the index in `iters` where each class of solve begins
    starts = {}
    mark_stage("stds factor")

    def solve_probe(ec, ep, V):
        """One probe through N^-1.  Returns the CONTROL-VARIATE-REDUCED
        pair (zc - M ec, zp - Hpp^-1 ep); with ep = 0 the first entry
        samples the camera block, with ec = 0 the second samples the
        point-block correction K' Cc K ep (y0 = Hpp^-1 ep cancels).
        `ep` arrives/leaves in layout slot order.  `V` (nc, k) is the
        deflation basis: the CG right-hand side is projected onto its
        orthogonal complement (zeros: the full operator)."""
        if nt:
            y0 = fac._hpp_inv_apply(fac.tie_from_layout_order(ep))
            px, py = fac._point_apply(y0)
            rhs = ec - fac._cam_applyT(wx * px, wy * py)
        else:
            rhs = ec
        rhs = rhs - V @ (V.T @ rhs)
        zc, it, _ = _pcg(fac.schur_matvec, rhs, precond, project, cg_tol, cg_maxiter)
        iters.append(it)
        return zc - precond(ec), bt_apply(zc)

    def bt_apply(v):
        """B' v with B = the camera->point coupling (K' v in the module
        notation): the exact deflated part of the point correction."""
        if not nt:
            return v.new_zeros((0, 3))
        ax, ay = fac._cam_apply(v)
        t = fac._point_applyT(wx * ax, wy * ay)
        return fac.tie_to_layout_order(-fac._hpp_inv_apply(t))

    host = lambda t: t.double().cpu().numpy()
    dev_vec = lambda a: torch.as_tensor(np.asarray(a).astype(dtype), device=dev)

    # exact diag of the block-Jacobi M: apply M to per-block-position
    # indicator patterns (ne patterns cover every pose block at once,
    # ni patterns the IOP blocks)
    ne_, ni_ = kernel.ne, kernel.ni
    n_img_ = kernel.n_img
    diagM = np.zeros(nc)
    for j in range(max(ne_, ni_)):
        pat = np.zeros(nc, dtype)
        if j < ne_:
            pat[j: n_img_ * ne_: ne_] = 1.0
        if j < ni_:
            pat[n_img_ * ne_ + j:: ni_] = 1.0
        diagM += np.asarray(pat, np.float64) * host(precond(dev_vec(pat)))
    mark_stage("stds diag(M)")

    rng = np.random.default_rng(seed)
    zero_c = torch.zeros(nc, dtype=tdt, device=dev)
    zero_p = torch.zeros((nt, 3), dtype=tdt, device=dev)
    d = np.sqrt(np.maximum(diagM, 1e-300))  # importance scale (see docstring)

    # ---- DEFLATION of the globally-correlated subspace -----------------
    # Cc = Cc V V' + Cc (I - VV'): diag(Cc V V') = sum_k (Cc V)[:,k] V[:,k]
    # exactly, and only the deflated remainder is sampled.  The point
    # correction B' Cc B splits the same way with B'V / B'(Cc V) exact.
    k_defl = int(min(16, max(nc // 4, 0)))
    subspace_iters = 2
    diag_defl_c = np.zeros(nc)
    diag_defl_p = np.zeros((nt, 3))
    V_np = np.zeros((nc, max(k_defl, 1)))
    V_zero = torch.zeros((nc, max(k_defl, 1)), dtype=tdt, device=dev)

    def cc_apply(v_np, V_arg):
        """Cc (I - V V') v via one CG solve (+ M v control variate undo)."""
        v_j = dev_vec(v_np)
        zc, _ = solve_probe(v_j, zero_p, V_arg)
        return host(zc) + host(precond(v_j))

    if k_defl >= 2:
        starts["subspace"] = len(iters)
        V_np, _ = np.linalg.qr(rng.normal(size=(nc, k_defl)))
        for _ in range(subspace_iters):
            Z = np.stack([cc_apply(V_np[:, j], V_zero) for j in range(k_defl)], 1)
            V_np, _ = np.linalg.qr(Z)
        mark_stage("stds subspace solves")
        starts["deflation"] = len(iters)
        CV = np.stack([cc_apply(V_np[:, j], V_zero) for j in range(k_defl)], 1)
        diag_defl_c = np.einsum("ik,ik->i", CV, V_np)
        if nt:
            BtV = np.stack([host(bt_apply(dev_vec(V_np[:, j]))) for j in range(k_defl)], 2)
            BtCV = np.stack([host(bt_apply(dev_vec(CV[:, j]))) for j in range(k_defl)], 2)
            diag_defl_p = np.einsum("tpk,tpk->tp", BtV, BtCV)
        mark_stage("stds deflation solves")
    V_dev = dev_vec(V_np)

    n_cam_probes = n_probe - n_probe // 2 if nt else n_probe
    n_pt_probes = n_probe - n_cam_probes
    acc_c = np.zeros(nc)
    starts["camera"] = len(iters)
    for _ in range(n_cam_probes):
        e = (rng.integers(0, 2, nc) * 2 - 1).astype(np.float64)
        zc, _ = solve_probe(dev_vec(e / d), zero_p, V_dev)
        acc_c += d * e * host(zc)
    mark_stage("stds camera probes")
    acc_p = np.zeros((nt, 3))
    starts["point"] = len(iters)
    for _ in range(n_pt_probes):
        e = (rng.integers(0, 2, (nt, 3)) * 2 - 1).astype(dtype)
        _, zp_corr = solve_probe(zero_c, dev_vec(e), V_dev)
        acc_p += e.astype(np.float64) * host(zp_corr)
    mark_stage("stds point probes")
    var_q = np.zeros(layout.u)
    var_q[:nc] = acc_c / max(n_cam_probes, 1) + diag_defl_c + diagM
    if nt:
        base_p = host(fac.tie_to_layout_order(fac.Hpi_flat[:nt][:, (0, 4, 8)]))
        var_q[layout.tie_offset:] = (acc_p / max(n_pt_probes, 1) + diag_defl_p
                                     + base_p).reshape(-1)
    if info is not None:
        its = torch.stack(iters).tolist() if iters else []
        bounds = list(starts.values()) + [len(its)]
        info["cg_iterations"] = its
        info["cg_classes"] = {name: its[a:b] for name, a, b in zip(starts, bounds, bounds[1:])}
    var_x = var_q / layout.scale**2 * sigma02
    std = np.sqrt(np.maximum(var_x, 0.0))
    mark_stage("stds finish")
    return std


def compute_stds(
    problem: BAProblem,
    layout: ParamLayout,
    x: np.ndarray,
    sigma02: float,
    max_images: int = 1000,
    n_probe: int = 64,
    mesh=None,
    device=None,
    pieces: Optional[dict] = None,
    info: Optional[dict] = None,
):
    """Stds for every unknown: exact block covariance below the dense-S
    gate, Hutchinson estimate past it (the reference always reports
    +-sigma, main.m:712-897).  Returns (std, Cc_q or None, method).
    `mesh` (from a distributed solver, every rank calling) runs the
    estimate's probe solves over it; the exact covariance runs alike on
    every rank, on `device`.  `pieces` goes to schur_covariance, `info`
    to estimate_schur_stds."""
    cov = schur_covariance(problem, layout, x, sigma02, max_images=max_images,
                           device=device, pieces=pieces)
    if cov is not None:
        mark_stage("stds exact")
        return cov.std, cov.Cc_q, "exact"
    if n_probe:
        std = estimate_schur_stds(problem, layout, x, sigma02, n_probe=n_probe,
                                  mesh=mesh, device=device, info=info)
        return std, None, "hutchinson"
    return None, None, None
