"""Sharded camera-state distributed solver.

PyTorch port of fish_eye_bundle_adjustment_tpu/parallel/sharded_state.py.
parallel/dist_schur.py replicates the camera and point state and
all-reduces every sum; this mode shards the camera state:

- the per-image pose blocks of the CG vectors, the reduced rhs and the
  block-Jacobi preconditioner live on the rank that owns the image (each
  rank owns n_img / N images, the image axis padded to a multiple of N);
- pose-side sums over the stream end in a reduce-scatter (each rank keeps
  its image slice) instead of an all-reduce;
- the full pose vector exists only inside the S matvec, gathered once a
  matvec (one all_gather), the least the stream's access pattern needs;
- the IOPs (n_cam * ni, touched by every row) and, at
  point_mode="replicated", the point factors Hpp^-1 stay replicated;
- CG inner products all-reduce the pose part and add the replicated IOP
  part once (_pcg's `dot`).

point_mode="sharded" shards the point state too (parallel/tieshard.py):
Hpp^-1 and every per-tie sum live on each rank's tie span, boundary ties
completed by an O(N)-word all-reduce.

The unknown vector stays replicated between steps, so the GN loops and
checkpoints are those of the other solvers.  Free-network inner
constraints run projected; each rank holds its own images' rows of G.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.parallel.dist_schur import (
    run_distributed,
    shard_obs,
)
from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_to_multiple
from fish_eye_bundle_adjustment_tpu_torch.parallel.tieshard import LocalTieOps, build_tie_shard
from fish_eye_bundle_adjustment_tpu_torch.solver.constraints import (
    build_G,
    validate_inner_constraints,
)
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import DenseResult
from fish_eye_bundle_adjustment_tpu_torch.solver.schur import (
    ObsData,
    SchurFactors,
    SchurKernel,
    SchurOptions,
    _clamp_diag,
    _expand_sym,
    _inv3x3,
    _pcg,
    _stable_sum,
    inv_blocks,
    shard_rows,
    torch_dtype,
)
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout


def make_sharded_camera_step(problem: BAProblem, mesh: Mesh,
                             options: Optional[SchurOptions] = None,
                             point_mode: str = "replicated"):
    """Build (step_fn, obs, layout, order) for this rank, as
    dist_schur.make_distributed_step: the unknown vector replicated at the
    step's boundary, the sharding inside its CG solve."""
    opts = options or SchurOptions()
    layout = ParamLayout(problem)
    use_ic = problem.settings.inner_constraints
    if use_ic:
        validate_inner_constraints(layout)
    n_dev, d_idx = mesh.size, mesh.index
    obs = shard_obs(problem, layout, mesh, opts)
    order = ObsData.stream_order(problem, layout, opts.dtype, opts.obs_order)

    lops = None
    if point_mode == "sharded":
        if opts.obs_order != "tie" or layout.n_tie == 0:
            raise ValueError("point_mode='sharded' needs the tie-sorted stream and "
                             "tie points to shard")
        n = problem.n_obs
        m, n_loc = shard_rows(n, n_dev)
        tie = problem.target_tie_slot[problem.obs_pt]
        tie = np.where(tie >= 0, tie, layout.n_tie).astype(np.int64)
        tie_sorted = np.concatenate([tie[order], np.full(m * n_dev - n, layout.n_tie, np.int64)])
        plan = build_tie_shard(tie_sorted, layout.n_tie, n_dev)
        lops = LocalTieOps(plan.shard(d_idx, mesh.device, n_loc), mesh)
    elif point_mode != "replicated":
        raise ValueError(f"unknown point_mode {point_mode!r}")

    kernel = SchurKernel(layout, opts, reduce_fn=mesh.psum)
    ne, ni = kernel.ne, kernel.ni
    n_img, n_cam = kernel.n_img, kernel.n_cam
    if ne == 0:
        raise ValueError("sharded camera state needs per-image EOP unknowns; "
                         "use solve_schur_distributed for IOP/tie-only problems")
    n_img_pad = pad_to_multiple(max(n_img, 1), n_dev)
    m_loc = n_img_pad // n_dev  # images per rank
    adaptive = opts.adaptive_damping
    dev = mesh.device
    tdt = torch_dtype(opts.dtype)

    def img_scatter(cols):
        """Per-row pose columns -> this rank's image slice: the local sum,
        then a reduce-scatter."""
        part = obs.img_sum(cols)  # (n_img, k) partial
        if n_img_pad != n_img:
            part = torch.cat([part, part.new_zeros((n_img_pad - n_img,) + part.shape[1:])])
        return mesh.psum_scatter(part)  # (m_loc, k)

    def iop_reduce(cols):
        return mesh.psum(obs.cam_sum(cols))

    def step(x, obs_l, cg_tol, lam=0.0):
        scalar = lambda v: torch.as_tensor(v, dtype=x.dtype, device=x.device)
        scale = layout.scale_like(x)
        q = x * scale
        lam_t = scalar(lam) if adaptive else None
        wx, wy = obs_l.W[:, 0], obs_l.W[:, 1]
        zero = torch.zeros((), dtype=tdt, device=dev)
        if lops is not None:
            # local point state: Hpp over this rank's tie span, boundary ties
            # completed by the O(N) exchange; the factor view carries LOCAL
            # tie ids so its per-row Hpp^-1 gathers (the pose
            # preconditioner's correction) read the local table, whose
            # sentinel row L is zero for control and padding rows
            L = lops.L
            rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy = kernel.blocks(q, obs_l)
            cols = [wx * Jpx[:, a] * Jpx[:, b] + wy * Jpy[:, a] * Jpy[:, b]
                    for a in range(3) for b in range(a, 3)]
            Hs = lops.segsum(torch.stack(cols, 1))[:L]
            lam_fix = opts.point_damping + 1e-300
            i00, i01, i02, i11, i12, i22 = Hs.unbind(1)
            if lam_t is None:
                d0 = d1 = d2 = 0.0
            else:
                # clamped Marquardt diagonal (see SchurKernel._damped_hpp_inv)
                mx = torch.maximum(torch.maximum(i00, i11), i22)
                floor = torch.clamp(1e-6 * mx, min=1e-30)
                d0 = lam_t * torch.maximum(i00, floor)
                d1 = lam_t * torch.maximum(i11, floor)
                d2 = lam_t * torch.maximum(i22, floor)
            Hpp = torch.stack([
                torch.stack([i00 + d0 + lam_fix, i01, i02], dim=1),
                torch.stack([i01, i11 + d1 + lam_fix, i12], dim=1),
                torch.stack([i02, i12, i22 + d2 + lam_fix], dim=1),
            ], dim=1)
            Hpi_loc = torch.cat([_inv3x3(Hpp).reshape(L, 9), Hpp.new_zeros((1, 9))])
            obs_view = dataclasses.replace(obs_l, tie=lops.tie_local)
            fac = SchurFactors(kernel, obs_view, rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy,
                               Hpi_loc)

            def point_applyT(bx, by):
                return lops.segsum(Jpx * bx[:, None] + Jpy * by[:, None])  # (L+1, 3)

            def hpp_apply(t):
                return torch.einsum("tpq,tq->tp", Hpi_loc.reshape(L + 1, 3, 3), t)

            def point_apply(yext):
                yg = yext[lops.tie_local]
                return (Jpx * yg).sum(dim=1), (Jpy * yg).sum(dim=1)
        else:
            fac = kernel.linearize(q, obs_l, lam=lam_t)  # Hpp all-reduced inside
            point_applyT = fac._point_applyT
            hpp_apply = fac._hpp_inv_apply
            point_apply = fac._point_apply

        # ---- sharded block-Jacobi preconditioner ------------------------
        # the adaptive-LM damping vector, raw diag(Hcc): its pose part
        # reduced straight into this rank's image slice
        if lam_t is not None:
            dcc_pose = _clamp_diag(img_scatter(wx[:, None] * fac.Jex**2
                                               + wy[:, None] * fac.Jey**2))
            dcc_iop = (_clamp_diag(iop_reduce(wx[:, None] * fac.Jix**2
                                              + wy[:, None] * fac.Jiy**2))
                       if ni else q.new_zeros((n_cam, 0)))
        else:
            dcc_pose = dcc_iop = None
        pose_blocks = _expand_sym(img_scatter(fac.pose_precond_sym()), ne)
        # padded image slots have all-zero blocks: identity keeps their
        # inverse finite (their CG rows are identically zero)
        empty = (pose_blocks.abs().sum((1, 2)) == 0)[:, None, None]
        eye = torch.eye(ne, dtype=tdt, device=dev)
        if lam_t is not None:
            pose_blocks = pose_blocks + lam_t * dcc_pose[..., None] * eye
        pose_inv = inv_blocks(pose_blocks + torch.where(empty, eye, 1e-300 * eye))
        if ni:
            iop_blocks = _expand_sym(iop_reduce(fac.iop_precond_sym()), ni)
            eye_i = torch.eye(ni, dtype=tdt, device=dev)
            if lam_t is not None:
                iop_blocks = iop_blocks + lam_t * dcc_iop[..., None] * eye_i
            iop_inv = inv_blocks(iop_blocks + 1e-300 * eye_i)
        else:
            iop_inv = q.new_zeros((n_cam, 0, 0))

        def precond(v):
            vp, vi = v
            pz = torch.einsum("bij,bj->bi", pose_inv, vp)
            iz = (torch.einsum("bij,bj->bi", iop_inv, vi.reshape(n_cam, ni)).reshape(-1)
                  if ni else vi)
            return pz, iz

        # ---- inner-constraint projection (local G rows) -----------------
        if use_ic:
            G = build_G(layout, q)[: kernel.nc]  # (nc, 7)
            Gp = G[: layout.eop_size].reshape(n_img, ne, -1)
            if n_img_pad != n_img:
                Gp = torch.cat([Gp, Gp.new_zeros((n_img_pad - n_img, ne, G.shape[1]))])
            Gp_loc = Gp[d_idx * m_loc : (d_idx + 1) * m_loc]
            Gi = G[layout.eop_size :]
            GtG_inv = inv_blocks(G.T @ G)

            def project(v):
                vp, vi = v
                gtv = mesh.psum(torch.einsum("bed,be->d", Gp_loc, vp)) + Gi.T @ vi
                coef = GtG_inv @ gtv
                return vp - torch.einsum("bed,d->be", Gp_loc, coef), vi - Gi @ coef
        else:
            def project(v):
                return v

        # ---- S matvec on (sharded pose, replicated IOPs) ----------------
        def matvec(v):
            vp_loc, vi = v
            vp_full = mesh.all_gather(vp_loc)[:n_img]  # (n_img, ne)
            vc = torch.cat([vp_full.reshape(-1), vi])
            ax, ay = fac._cam_apply(vc)
            awx, awy = wx * ax, wy * ay
            if kernel.n_tie:
                px, py = point_apply(hpp_apply(point_applyT(awx, awy)))
                awx = awx - wx * px
                awy = awy - wy * py
            out_p = img_scatter(fac.Jex * awx[:, None] + fac.Jey * awy[:, None])
            out_i = (iop_reduce(fac.Jix * awx[:, None] + fac.Jiy * awy[:, None]).reshape(-1)
                     if ni else q.new_zeros((0,)))
            if opts.camera_damping:
                out_p = out_p + opts.camera_damping * vp_loc
                out_i = out_i + opts.camera_damping * vi
            if lam_t is not None:
                out_p = out_p + lam_t * dcc_pose * vp_loc
                out_i = out_i + lam_t * dcc_iop.reshape(-1) * vi
            return out_p, out_i

        def dot(a, b):
            return mesh.psum(torch.vdot(a[0].reshape(-1), b[0].reshape(-1))) + torch.dot(a[1], b[1])

        # ---- reduced rhs --------------------------------------------------
        rwx, rwy = wx * fac.rx, wy * fac.ry
        if kernel.n_tie:
            px, py = point_apply(hpp_apply(point_applyT(rwx, rwy)))
            rwx = rwx - wx * px
            rwy = rwy - wy * py
        rhs = (
            -img_scatter(fac.Jex * rwx[:, None] + fac.Jey * rwy[:, None]),
            -(iop_reduce(fac.Jix * rwx[:, None] + fac.Jiy * rwy[:, None]).reshape(-1)
              if ni else q.new_zeros((0,))),
        )

        dc_sh, cg_iters, _ = _pcg(matvec, rhs, precond, project, scalar(cg_tol),
                                  opts.cg_maxiter, dot=dot)
        dp_full = mesh.all_gather(dc_sh[0])[:n_img]
        dc = torch.cat([dp_full.reshape(-1), dc_sh[1]])
        ax, ay = fac._cam_apply(dc)
        if kernel.n_tie:
            # back-substitution through the mode's point machinery; the
            # global (n_tie, 3) correction materializes once a step
            rhs_p = point_applyT(wx * (fac.rx + ax), wy * (fac.ry + ay))
            dp_int = hpp_apply(-rhs_p)
            px, py = point_apply(dp_int)
            dp = lops.gather_global(dp_int[: lops.L]) if lops is not None else dp_int
        else:
            dp = q.new_zeros((0, 3))
            px = py = torch.zeros_like(fac.rx)
        delta_x = torch.cat([dc, dp.reshape(-1)]) / scale
        vx = torch.where(wx > 0, ax + px + fac.rx, zero)
        vy = torch.where(wy > 0, ay + py + fac.ry, zero)
        rxm = torch.where(wx > 0, fac.rx, zero)
        rym = torch.where(wy > 0, fac.ry, zero)
        stats = mesh.psum(torch.stack([
            _stable_sum(vx * vx * wx + vy * vy * wy), (vx * vx).sum(), (vy * vy).sum(),
            _stable_sum(wx * rxm**2 + wy * rym**2)]))
        # the trial is validated deferred, against the next step's cost_old
        return x + delta_x, delta_x.abs().sum(), torch.stack([vx, vy], 1), stats, cg_iters

    return step, obs, layout, order


def solve_schur_sharded_state(
    problem: BAProblem,
    mesh: Optional[Mesh] = None,
    options: Optional[SchurOptions] = None,
    keep_history: bool = False,
    x0=None,
    progress_fn=None,
    checkpoint_path=None,
    checkpoint_every: int = 1,
    compute_covariance: bool = False,
    point_mode: str = "replicated",
) -> DenseResult:
    """The distributed solve with sharded camera state (the result
    contract of solve_schur_distributed, stds included).
    point_mode="sharded" shards the point state too."""
    opts = options or SchurOptions()
    mesh = mesh if mesh is not None else make_mesh()
    step, obs, layout, order = make_sharded_camera_step(problem, mesh, opts,
                                                        point_mode=point_mode)
    return run_distributed(problem, mesh, opts, step, obs, layout, order, keep_history,
                           x0, progress_fn, checkpoint_path, checkpoint_every,
                           compute_covariance)
