"""Distributed Schur solver over the fused banded kernels (K1, K2).

PyTorch port of fish_eye_bundle_adjustment_tpu/parallel/fusedshard.py.
The global band plan is partitioned at group boundaries
(ops/bandplan.split_band_plan):

- each group owns M whole tie ranks, so a rank's tie sums are complete:
  the point state is rank-sharded with no exchange at all;
- each rank runs the fused kernels of ops/fusedmv.py over its row window
  (128-aligned; lead-in rows copied from a neighbour carry W = 0 and lie
  outside every group's owned rows), with the kernels' host index built
  for the window (`shard_band`), its streams folded from its own rows
  (`window_streams`);
- the camera-side outputs of each kernel call (pose planes, IOP lane
  partials, Schur-Jacobi columns, the LM diagonal) are completed by one
  all-reduce;
- the back-substituted point correction lives rank-sharded and is
  gathered once a step (one all_gather).

The fused gate applies (float32, one camera, tie points, pose unknowns,
at most 8 IOPs); callers pick this mode explicitly, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Optional

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.ops.bandplan import (
    ShardedBandPlan,
    build_band_plan,
    split_band_plan,
)
from fish_eye_bundle_adjustment_tpu_torch.ops.fusedmv import (
    BandArrays,
    fused_hpp_pass,
    fused_schur_apply,
)
from fish_eye_bundle_adjustment_tpu_torch.parallel.dist_schur import check_options, run_distributed
from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import Mesh, make_mesh
from fish_eye_bundle_adjustment_tpu_torch.solver.constraints import validate_inner_constraints
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import DenseResult
from fish_eye_bundle_adjustment_tpu_torch.solver.schur import (
    _MAX_FUSED_IOP,
    ObsData,
    SchurKernel,
    SchurOptions,
    _clamp_diag,
    _expand_sym,
    _pcg,
    _stable_sum,
    fold_residuals,
    fold_streams,
    make_projection_builder,
)
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout


@dataclasses.dataclass
class FusedShardData:
    """A rank's expanded observation window (as ObsData, `tie` holding
    GLOBAL tie ranks, n_tie for control and dead rows, W zero on dead and
    duplicated rows) and its band geometry."""

    obs: ObsData
    band: BandArrays


def shard_band(sp: ShardedBandPlan, d: int, device) -> BandArrays:
    """Shard d's window of a split plan as the kernels' BandArrays: its
    G_loc groups at local row offsets over slice_len rows (the padding
    groups own no row, fr == er at the stream's end), the global image
    band, and the kernels' host index built for that geometry."""
    window = types.SimpleNamespace(
        row_start=sp.sb[d].astype(np.int64) * 128, first_row=sp.fr[d], end_row=sp.er[d],
        img_base=sp.ib[d].astype(np.int64) * 128, rel=sp.rel[d], imgrow=sp.imgrow[d],
        img_of_imgrank=sp.img_of_imgrank, imgrank_of_img=sp.imgrank_of_img,
        rank_of_slot=sp.rank_of_slot, slot_of_rank=sp.slot_of_rank,
        M=sp.M, T=sp.T, W=sp.W, G=sp.G_loc, n_pad=sp.slice_len,
        n_img_pad=sp.n_img_pad, n_tie=sp.n_tie, n_img=sp.n_img,
    )
    return BandArrays.from_plan(window, device)


def build_fused_shard_data(problem: BAProblem, layout: ParamLayout, sp: ShardedBandPlan,
                           d: int, device) -> FusedShardData:
    """Expand the observation arrays into shard d's window."""
    n_tie = layout.n_tie
    tie = problem.target_tie_slot[problem.obs_pt]
    tie = np.where(tie >= 0, tie, n_tie).astype(np.int64)
    rank = np.where(tie < n_tie, sp.rank_of_slot[np.minimum(tie, n_tie - 1)], n_tie)

    rows = sp.shard_rows[d]  # original rows, -1 dead
    live = rows >= 0
    safe = np.where(live, rows, 0)
    i64 = lambda a: torch.as_tensor(np.where(live, a[safe], 0).astype(np.int64), device=device)
    xy = np.where(live[:, None], problem.obs_xy[safe], 0.0).astype(np.float32)
    # zero weight on dead AND non-owned duplicate rows
    W = np.where((live & sp.owned[d])[:, None], problem.obs_weights()[safe], 0.0)
    on_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    obs = ObsData(
        img=i64(problem.obs_img), cam=i64(problem.obs_cam), pt=i64(problem.obs_pt),
        tie=torch.as_tensor(np.where(live, rank[safe], n_tie).astype(np.int64), device=device),
        xy=on_dev(xy), W=on_dev(W), ydir_cam=on_dev(problem.y_dir),
        iop_scale_cam=on_dev(layout.iop_scale_full), order=rows[live],
    )
    return FusedShardData(obs=obs, band=shard_band(sp, d, device))


def window_streams(kernel: SchurKernel, q, obs: ObsData):
    """A window's Jacobian pass (SchurKernel.blocks) and its streams for
    the fused kernels: (blocks, acam_t, apt_t, a_rows)."""
    blocks = kernel.blocks(q, obs)
    rx, ry = blocks[:2]
    wx, wy = obs.W[:, 0], obs.W[:, 1]
    n = wx.shape[0]
    return (blocks, *fold_streams(wx, wy, *blocks[2:], n),
            fold_residuals(wx, wy, rx, ry, n))


def make_fused_sharded_step(problem: BAProblem, mesh: Mesh,
                            options: Optional[SchurOptions] = None):
    """Build (step_fn, data, layout, sp) for this rank.  step_fn(x, data,
    cg_tol, lam) is one fused GN iteration over the mesh (replicated x in
    and out, the contract of the other distributed steps)."""
    opts = options or SchurOptions(dtype=np.float32)
    layout = ParamLayout(problem)
    use_ic = problem.settings.inner_constraints
    if use_ic:
        validate_inner_constraints(layout)
    if not (np.dtype(opts.dtype) == np.float32 and problem.n_cam == 1
            and layout.n_tie > 0 and layout.n_eop > 0 and layout.n_iop <= _MAX_FUSED_IOP):
        raise ValueError("fused sharded mode needs the fused gate: float32, one camera, "
                         "tie points, pose unknowns, at most 8 IOPs (use "
                         "solve_schur_distributed otherwise)")
    tie = problem.target_tie_slot[problem.obs_pt]
    tie = np.where(tie >= 0, tie, layout.n_tie)
    plan = build_band_plan(tie, problem.obs_img, layout.n_tie, problem.n_img,
                           M=opts.band_M, max_W=opts.band_max_W)
    if plan is None:
        raise ValueError("band structure too ragged for the fused kernels")
    sp = split_band_plan(plan, mesh.size)
    dev = mesh.device
    data = build_fused_shard_data(problem, layout, sp, mesh.index, dev)

    kernel = SchurKernel(layout, opts)
    ne, ni = kernel.ne, kernel.ni
    n_img = kernel.n_img
    project_builder = make_projection_builder(layout, kernel.nc, use_ic)
    adaptive = opts.adaptive_damping
    G_loc, M, n_tie = sp.G_loc, sp.M, sp.n_tie
    n_rank = G_loc * M
    rank_pad = sp.rank_pad
    f32 = torch.float32
    eye3 = torch.eye(3, dtype=f32, device=dev)
    # this rank's global tie ranks: ranks past n_tie are padding
    rank_ok = (mesh.index * n_rank + torch.arange(n_rank, device=dev) < n_tie)[:, None, None]

    def psum_parts(*parts):
        """One all-reduce of several camera-side outputs."""
        flat = mesh.psum(torch.cat([p.reshape(-1) for p in parts]))
        return [v.reshape(p.shape) for v, p in
                zip(torch.split(flat, [p.numel() for p in parts]), parts)]

    def step(x, d: FusedShardData, cg_tol, lam=0.0):
        scalar = lambda v: torch.as_tensor(v, dtype=x.dtype, device=x.device)
        scale = layout.scale_like(x)
        q = x * scale
        lam_t = scalar(lam) if adaptive else None
        obs, band = d.obs, d.band
        blocks, acam_t, apt_t, a_rows = window_streams(kernel, q, obs)
        rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy = blocks
        wx, wy = obs.W[:, 0], obs.W[:, 1]

        # ---- fused linearization pass (local ranks) ---------------------
        hs8, de8, di8 = fused_hpp_pass(band, acam_t, apt_t, ne, ni,
                                       precision=opts.fused_precision)
        Hpp_inv = kernel._damped_hpp_inv(hs8[:6].T, lam_t)  # (n_rank, 3, 3)
        # padding ranks carry zero sums whose inverse is garbage: identity
        # (their t and y are 0)
        Hpp_inv = torch.where(rank_ok, Hpp_inv, eye3)
        hpi_t = torch.nn.functional.pad(Hpp_inv.reshape(n_rank, 9).T, (0, 0, 0, 7)).contiguous()

        def apply(vpose=None, vi=None, a_rows=None, with_precond=False, precision=None):
            return fused_schur_apply(band, acam_t, apt_t, hpi_t, ne, ni, vpose=vpose,
                                     vi=vi, a_rows=a_rows, with_precond=with_precond,
                                     precision=precision or opts.fused_precision)

        def fused_v(vc):
            vp_img = vc[: layout.eop_size].reshape(n_img, ne)
            vpose = acam_t.new_zeros((8, sp.n_img_pad))
            vpose[:ne, :n_img] = vp_img[band.img_of_imgrank].to(f32).T
            vi = acam_t.new_zeros(128)
            if ni:
                vi[:ni] = vc[layout.eop_size :].to(f32)
            return vpose, vi

        def cam_vector(op, oi):
            """Completed kernel outputs -> flat camera vector in layout order."""
            parts = [op.T[band.imgrank_of_img].reshape(-1)]
            if ni:
                parts.append(oi.sum(dim=1))
            return torch.cat(parts)

        def cam_out(out_pose, out_iop):
            return cam_vector(*psum_parts(out_pose[:ne, :n_img], out_iop[:ni]))

        # rhs + Schur-Jacobi preconditioner in one pass, completed by one
        # all-reduce (with the LM diagonal of the linearization pass)
        out_pose, out_iop, _, p21, i55 = apply(a_rows=a_rows, with_precond=True)
        npair = ne * (ne + 1) // 2
        ipair = ni * (ni + 1) // 2
        parts = [out_pose[:ne, :n_img], out_iop[:ni], p21[:npair, :n_img], i55[:ipair]]
        if lam_t is not None:
            parts += [de8[:ne, :n_img], di8[:ni]]
        done = psum_parts(*parts)
        rhs = -cam_vector(done[0], done[1])
        blocks = [("pose", _expand_sym(done[2].T[band.imgrank_of_img], ne))]
        if ni:
            blocks.append(("iop", _expand_sym(done[3].sum(dim=1).reshape(1, ipair), ni)))
        dcc = None
        if lam_t is not None:
            dparts = [_clamp_diag(done[4].T[band.imgrank_of_img]).reshape(-1)]
            if ni:
                dparts.append(_clamp_diag(done[5].sum(dim=1).reshape(1, ni)).reshape(-1))
            dcc = torch.cat(dparts)

        Ms = []
        off = 0
        for kind, B in blocks:
            nb = B.shape[-1]
            eye = torch.eye(nb, dtype=B.dtype, device=dev)
            if lam_t is not None:
                B = B + lam_t * dcc[off : off + B.shape[0] * nb].reshape(-1, nb)[..., None] * eye
            off += B.shape[0] * nb
            Ms.append((kind, torch.linalg.inv(B + 1e-300 * eye)))

        def precond(vc):
            out = []
            for kind, Minv in Ms:
                v = (vc[: layout.eop_size].reshape(n_img, ne) if kind == "pose"
                     else vc[layout.eop_size :].reshape(1, ni))
                out.append(torch.einsum("bij,bj->bi", Minv, v).reshape(-1))
            return torch.cat(out)

        def matvec(vc):
            vpose, vi = fused_v(vc)
            out_pose, out_iop, _ = apply(vpose=vpose, vi=vi, precision=kernel.mv_precision)
            out = cam_out(out_pose, out_iop)
            if opts.camera_damping:
                out = out + opts.camera_damping * vc
            if lam_t is not None:
                out = out + (lam_t * dcc) * vc
            return out

        dc, cg_iters, _ = _pcg(matvec, rhs, precond, project_builder(q), scalar(cg_tol),
                               opts.cg_maxiter)

        # back-substitution: the local rank block, one all_gather a step
        vpose, vi = fused_v(dc)
        _, _, y = apply(vpose=vpose, vi=vi, a_rows=a_rows)
        dp_rank = mesh.all_gather(-y[:3].T.contiguous())  # (rank_pad, 3)
        delta_x = torch.cat([dc, dp_rank[band.rank_of_slot].reshape(-1)]) / scale

        # this window's linearized residual rows
        vg = dc[: layout.eop_size].reshape(n_img, ne)[obs.img]
        ax = (Jex * vg).sum(dim=1)
        ay = (Jey * vg).sum(dim=1)
        if ni:
            vi_c = dc[layout.eop_size :]
            ax = ax + Jix @ vi_c
            ay = ay + Jiy @ vi_c
        yg = torch.cat([dp_rank, dp_rank.new_zeros((1, 3))])[obs.tie.clamp(max=rank_pad)]
        px = (Jpx * yg).sum(dim=1)
        py = (Jpy * yg).sum(dim=1)
        zero = torch.zeros((), dtype=f32, device=dev)
        vx = torch.where(wx > 0, ax + px + rx, zero)
        vy = torch.where(wy > 0, ay + py + ry, zero)
        rxm = torch.where(wx > 0, rx, zero)
        rym = torch.where(wy > 0, ry, zero)
        stats = mesh.psum(torch.stack([
            _stable_sum(vx * vx * wx + vy * vy * wy), (vx * vx).sum(), (vy * vy).sum(),
            _stable_sum(wx * rxm**2 + wy * rym**2)]))
        # the trial is validated deferred, against the next step's cost_old
        return x + delta_x, delta_x.abs().sum(), torch.stack([vx, vy], 1), stats, cg_iters

    return step, data, layout, sp


def solve_schur_fused_sharded(
    problem: BAProblem,
    mesh: Optional[Mesh] = None,
    options: Optional[SchurOptions] = None,
    keep_history: bool = False,
    x0=None,
    progress_fn=None,
    checkpoint_path=None,
    checkpoint_every: int = 1,
    compute_covariance: bool = False,
) -> DenseResult:
    """The distributed solve through the fused banded kernels (the result
    contract of solve_schur_distributed)."""
    opts = options or SchurOptions(dtype=np.float32)
    check_options(opts)
    mesh = mesh if mesh is not None else make_mesh()
    step, data, layout, sp = make_fused_sharded_step(problem, mesh, opts)

    def v_rows(v_local):
        # report-order residual rows: each observation's owned copy
        allv = mesh.all_gather(v_local).cpu().numpy().reshape(-1, 2)
        return allv[sp.owned_pos].reshape(-1)

    return run_distributed(problem, mesh, opts, step, data, layout, None, keep_history,
                           x0, progress_fn, checkpoint_path, checkpoint_every,
                           compute_covariance, v_rows=v_rows)
