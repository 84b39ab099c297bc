"""The plain reference: the block's least-squares problem written out again
in plain PyTorch, in float64, and the judge of an adjustment's answer.

It imports nothing of the program and takes nothing the program made: it
reads the block's raw arrays (blockgen.Block) and builds its own unknown
layout, observation order, residuals, Jacobians and normal equations.
The program's answer (the adjusted EOPs, IOPs and target coordinates, and
the sigma0^2 it reported) is read only to judge it.

The model (the reference MATLAB's BuildAwG.m, equidistant fish-eye):
camera-frame (U, V, W) = R3(kappa) R2(phi) R1(omega) (X - Xc);
fx = -c U g + xp + dr xb + dec_x, fy = -c ydir V g + yp + dr yb + dec_y,
g = atan(R / W) / R with R = |(U, V)|, where distortion is taken at the
MEASURED point (xb, yb) = (x - xp, y - yp): dr = sum_j k_j r^(2j),
dec_x = p1 (r^2 + 2 xb^2) + 2 p2 xb yb, dec_y = p2 (r^2 + 2 yb^2) +
2 p1 xb yb.  The residual is f - measured, weighted by 1 / meas_std^2.
Distortion unknowns are conditioned as the reference conditions them:
k_j scaled by rmax^(2j), p1 and p2 by rmax^2.

The judge (``judge``) evaluates, at the answer: the weighted cost and
sigma0^2 = cost / (2 n_obs - u); the float64 Gauss-Newton correction dx
(the normal equations reduced to the camera unknowns by eliminating each
tie point, solved by preconditioned CG to a relative residual of 1e-10,
points back-substituted).  From these, three numbers:

- cost_gap: the decrease the GN step predicts, -g'dx, over the cost: how
  far the answer is from the least-squares optimum (0 at the optimum);
- max_shift_m: the largest |dx| of a camera position or tie-point
  coordinate, in metres: one coordinate left far from where it belongs;
- sigma02_gap: |reported sigma0^2 - the reference's| over the reference's.

A correction whose CG stopped short of its tolerance is no reference: the
two numbers read from it (cost_gap, max_shift_m) are then infinite, so
the answer is not judged correct.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the numbers judge() gives for each answer
NUMBERS = ("cost_gap", "max_shift_m", "sigma02_gap")
CHUNK = 1 << 20  # observation rows a Jacobian pass takes at once
CG_TOL = 1e-10
CG_MAXITER = 3000


def _rotation(w, p, k):
    """(n, 3, 3) = R3(kappa) @ R2(phi) @ R1(omega), from the elementary
    rotations."""
    one, zero = torch.ones_like(w), torch.zeros_like(w)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    cw, sw, cp, sp, ck, sk = w.cos(), w.sin(), p.cos(), p.sin(), k.cos(), k.sin()
    r1 = mat([[one, zero, zero], [zero, cw, sw], [zero, -sw, cw]])
    r2 = mat([[cp, zero, -sp], [zero, one, zero], [sp, zero, cp]])
    r3 = mat([[ck, sk, zero], [-sk, ck, zero], [zero, zero, one]])
    return r3 @ r2 @ r1


def residual_rows(eop, iop, xyz, meas, ydir, model: str, nk: int):
    """(n, 2) residuals f - measured of n observation rows, each with its
    own EOPs (n, 6), IOPs (n, 5 + nk) and target (n, 3)."""
    rot = _rotation(eop[:, 3], eop[:, 4], eop[:, 5])
    uvw = (rot @ (xyz - eop[:, :3]).unsqueeze(-1)).squeeze(-1)
    U, V, W = uvw.unbind(-1)
    R = torch.sqrt(U * U + V * V)
    small = R < 1e-12
    Rs = torch.where(small, torch.ones_like(R), R)
    if model == "fisheye":
        g = torch.where(small, 1 / W, torch.atan2(Rs, W) / Rs)
    elif model == "pinhole":
        g = 1 / W
    else:
        raise ValueError(f"the reference has no {model!r} model")
    xp, yp, c = iop[:, 0], iop[:, 1], iop[:, 2]
    xb = meas[:, 0] - xp
    yb = meas[:, 1] - yp
    r2 = xb * xb + yb * yb
    dr = torch.zeros_like(r2)
    for j in range(1, nk + 1):
        dr = dr + iop[:, 2 + j] * r2**j
    p1, p2 = iop[:, 3 + nk], iop[:, 4 + nk]
    dec_x = p1 * (r2 + 2 * xb * xb) + 2 * p2 * xb * yb
    dec_y = p2 * (r2 + 2 * yb * yb) + 2 * p1 * xb * yb
    fx = -c * U * g + xp + dr * xb + dec_x
    fy = -c * ydir * V * g + yp + dr * yb + dec_y
    return torch.stack([fx, fy], dim=-1) - meas


class Problem:
    """The block's least-squares problem on `device`, in `dtype`."""

    def __init__(self, block, device="cpu", dtype=torch.float64):
        s = block.settings
        self.block = block
        self.device = torch.device(device)
        self.dtype = dtype
        self.model = block.model
        self.nk = nk = int(s["num_radial_distortions"])
        self.eop_cols = [i for i, k in enumerate(
            ("estimate_xc", "estimate_yc", "estimate_zc", "estimate_w", "estimate_p",
             "estimate_k")) if s[k]]
        iop_flags = ([s["estimate_xp"], s["estimate_yp"], s["estimate_c"]]
                     + [s["estimate_radial"]] * nk + [s["estimate_decent"]] * 2)
        self.iop_cols = [i for i, f in enumerate(iop_flags) if f]
        if s["inner_constraints"] or s["estimate_all_gcp"] or not s["estimate_tie"]:
            raise ValueError("the reference adjusts tie points with fixed control only")
        rmax = float(block.rmax[0])
        scale = np.ones(5 + nk)
        scale[3:3 + nk] = [rmax ** (2 * j) for j in range(1, nk + 1)]
        scale[3 + nk:] = rmax**2
        self.iop_scale = scale
        self.ne, self.ni = len(self.eop_cols), len(self.iop_cols)
        self.n_img, self.n_cam, self.n_tie = block.n_img, block.n_cams, block.n_tie
        self.nc = self.n_img * self.ne + self.n_cam * self.ni
        self.u = self.nc + 3 * self.n_tie
        self.n_obs = block.n_obs
        self.dof = 2 * self.n_obs - self.u
        sd = float(s["meas_std"])
        sy = s.get("meas_std_y") or sd
        dev = self.device
        self.w = torch.tensor([1 / sd**2, 1 / sy**2], dtype=dtype, device=dev)
        self.img = torch.as_tensor(block.obs_img.astype(np.int64), device=dev)
        self.cam = torch.as_tensor(block.img_cam[block.obs_img].astype(np.int64), device=dev)
        self.pt = torch.as_tensor(block.obs_pt.astype(np.int64), device=dev)
        slot = block.target_tie_slot[block.obs_pt].astype(np.int64)
        # control observations go to a dummy slot past the last tie point
        self.tie = torch.as_tensor(np.where(slot >= 0, slot, self.n_tie), device=dev)
        self.meas = torch.as_tensor(block.obs_xy, dtype=dtype, device=dev)

    # -- residuals and Jacobians --------------------------------------
    def _tables(self, eop, iop, pts):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype,
                                      device=self.device)
        return t(eop), t(iop), t(pts)

    def _jacobian_chunk(self, eop, iop, pts, sl):
        """Residuals (m, 2) and Jacobian blocks of a chunk of rows: wrt the
        active EOPs (m, 2, ne), the active conditioned IOPs (m, 2, ni) and
        the target (m, 2, 3), by forward mode over the 14 + nk columns."""
        e, i, x = eop[self.img[sl]], iop[self.cam[sl]], pts[self.pt[sl]]
        meas = self.meas[sl]
        f = lambda e_, i_, x_: residual_rows(e_, i_, x_, meas, 1, self.model, self.nk)
        k = 9 + 5 + self.nk
        basis = torch.eye(k, dtype=self.dtype, device=self.device)

        def column(t):
            tang = (t[:6].expand_as(e), t[6:11 + self.nk].expand_as(i), t[11 + self.nk:].expand_as(x))
            return torch.func.jvp(f, (e, i, x), tang)

        r, J = torch.func.vmap(column, out_dims=(None, 2))(basis)  # J (m, 2, k)
        Je = J[:, :, :6][:, :, self.eop_cols]
        scale = torch.as_tensor(self.iop_scale[self.iop_cols], dtype=self.dtype,
                                device=self.device)
        Ji = J[:, :, 6:11 + self.nk][:, :, self.iop_cols] / scale
        Jp = J[:, :, 11 + self.nk:] * (self.tie[sl] < self.n_tie)[:, None, None]
        return r, Je, Ji, Jp

    # -- the Gauss-Newton correction ------------------------------------
    def gn_correction(self, eop, iop, pts, cg_tol=CG_TOL, cg_maxiter=CG_MAXITER) -> dict:
        """The GN correction at the given tables: dx as (deop (n_img, ne),
        diop (n_cam, ni) de-scaled, dpts (n_tie, 3)), with the cost at the
        point, the predicted decrease -g'dx and the CG's iterations."""
        eop, iop, pts = self._tables(eop, iop, pts)
        dev, dt = self.device, self.dtype
        ne, ni, nt = self.ne, self.ni, self.n_tie
        n = self.n_obs
        w = self.w
        Je = torch.empty((n, 2, ne), dtype=dt, device=dev)
        Ji = torch.empty((n, 2, ni), dtype=dt, device=dev)
        Jp = torch.empty((n, 2, 3), dtype=dt, device=dev)
        rr = torch.empty((n, 2), dtype=dt, device=dev)
        for a in range(0, n, CHUNK):
            sl = slice(a, min(a + CHUNK, n))
            rr[sl], Je[sl], Ji[sl], Jp[sl] = self._jacobian_chunk(eop, iop, pts, sl)
        cost = float((rr**2 * w).sum())
        img, cam, tie = self.img, self.cam, self.tie

        def tie_sum(vals):  # (n, ...) -> (nt, ...), control rows dropped
            out = torch.zeros((nt + 1,) + vals.shape[1:], dtype=dt, device=dev)
            return out.index_add_(0, tie, vals)[:nt]

        def img_sum(vals):
            out = torch.zeros((self.n_img,) + vals.shape[1:], dtype=dt, device=dev)
            return out.index_add_(0, img, vals)

        def cam_sum(vals):
            out = torch.zeros((self.n_cam,) + vals.shape[1:], dtype=dt, device=dev)
            return out.index_add_(0, cam, vals)

        wJp = Jp * w[None, :, None]
        Hpp = tie_sum(torch.einsum("nra,nrb->nab", wJp, Jp))  # (nt, 3, 3)
        Hpp_inv = torch.linalg.inv(Hpp)
        gp = tie_sum(torch.einsum("nra,nr->na", wJp, rr))  # P'W r
        z_ext = lambda z: torch.cat([z, z.new_zeros((1, 3))])

        def split(v):
            return v[: self.n_img * ne].reshape(self.n_img, ne), v[self.n_img * ne:].reshape(
                self.n_cam, ni)

        def cam_apply(v):  # (n, 2) = C v
            vi, vc = split(v)
            return (torch.einsum("nrk,nk->nr", Je, vi[img])
                    + torch.einsum("nrk,nk->nr", Ji, vc[cam]))

        def cam_applyT(b):  # C' b
            return torch.cat([img_sum(torch.einsum("nrk,nr->nk", Je, b)).reshape(-1),
                              cam_sum(torch.einsum("nrk,nr->nk", Ji, b)).reshape(-1)])

        def eliminate(aw):  # aw - W P Hpp^-1 P' aw
            y = torch.einsum("tab,tb->ta", Hpp_inv, tie_sum(torch.einsum("nra,nr->na", Jp, aw)))
            return aw - w * torch.einsum("nra,na->nr", Jp, z_ext(y)[tie])

        def S(v):
            return cam_applyT(eliminate(cam_apply(v) * w))

        b = -cam_applyT(eliminate(rr * w))
        # block-Jacobi preconditioner: S's exact diagonal blocks, each
        # image's (one observation per image and tie point) and the cameras'
        HpiE = torch.cat([Hpp_inv, Hpp_inv.new_zeros((1, 3, 3))])[tie]  # (n, 3, 3)
        Bi = torch.einsum("nre,nrp->nep", Je * w[None, :, None], Jp)  # Je'W Jp (n, ne, 3)
        Sii = img_sum(torch.einsum("nrk,nrl->nkl", Je * w[None, :, None], Je)
                      - torch.einsum("nep,npq,nfq->nef", Bi, HpiE, Bi))
        Bc = tie_sum(torch.einsum("nri,nrp->nip", Ji * w[None, :, None], Jp))  # (nt, ni, 3)
        Scc = (cam_sum(torch.einsum("nrk,nrl->nkl", Ji * w[None, :, None], Ji))
               - torch.einsum("tip,tpq,tjq->ij", Bc, Hpp_inv, Bc)[None])
        Mi = torch.linalg.inv(Sii)
        Mc = torch.linalg.inv(Scc) if ni else Scc

        def precond(r):
            ri, rc = split(r)
            return torch.cat([torch.einsum("ikl,il->ik", Mi, ri).reshape(-1),
                              torch.einsum("ckl,cl->ck", Mc, rc).reshape(-1)])

        x = torch.zeros_like(b)
        r = b.clone()
        zv = precond(r)
        p = zv.clone()
        rz = torch.dot(r, zv)
        bnorm = float(b.norm())
        it = 0
        while it < cg_maxiter and bnorm > 0:
            Sp = S(p)
            alpha = rz / torch.dot(p, Sp)
            x += alpha * p
            r -= alpha * Sp
            it += 1
            if it % 10 == 0 and float(r.norm()) <= cg_tol * bnorm:
                break
            zv = precond(r)
            rz_new = torch.dot(r, zv)
            p = zv + (rz_new / rz) * p
            rz = rz_new
        dc = x
        # dp = Hpp^-1 (-P'W r - P'W C dc)
        ac = cam_apply(dc) * w
        dp = -torch.einsum("tab,tb->ta", Hpp_inv,
                           gp + tie_sum(torch.einsum("nra,nr->na", Jp, ac)))
        gc = cam_applyT(rr * w)
        pred = -float(torch.dot(gc, dc) + (gp * dp).sum())
        di, dcam = split(dc)
        scale = torch.as_tensor(self.iop_scale[self.iop_cols], dtype=dt, device=dev)
        return dict(deop=di, diop=dcam / scale, dpts=dp, cost=cost, pred=pred,
                    cg_iterations=it,
                    cg_rel_residual=float(r.norm()) / max(bnorm, 1e-300))


def judge(problem: Problem, eop, iop, pts, sigma02_reported: float,
          cg_maxiter=CG_MAXITER) -> dict:
    """The three numbers compared for one answer (see the module's
    docstring), with what they were computed from."""
    g = problem.gn_correction(eop, iop, pts, cg_maxiter=cg_maxiter)
    cost = g["cost"]
    sigma02 = cost / max(problem.dof, 1)
    shifts = [g["dpts"].abs().max()]
    pos = [c for c in range(problem.ne) if problem.eop_cols[c] < 3]
    if pos:
        shifts.append(g["deop"][:, pos].abs().max())
    max_shift = float(max(float(s) for s in shifts))
    solved = g["cg_rel_residual"] <= CG_TOL
    return dict(
        cost_gap=g["pred"] / cost if solved else math.inf,
        max_shift_m=max_shift if solved else math.inf,
        sigma02_gap=abs(sigma02_reported - sigma02) / sigma02,
        sigma02=sigma02,
        cost=cost,
        cg_iterations=g["cg_iterations"],
        cg_rel_residual=g["cg_rel_residual"],
    )

