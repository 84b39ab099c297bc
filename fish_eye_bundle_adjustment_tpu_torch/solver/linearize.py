"""Batched residual + Jacobian evaluation over all observations.

PyTorch port of fish_eye_bundle_adjustment_tpu/solver/linearize.py: gather
per-observation parameters by integer index, evaluate the residual and its
forward-mode Jacobian blocks (models/projection.py, the ``torch.func``
batch the Schur path's ``SchurKernel.blocks`` uses), and for the dense
parity path place the blocks into the full design matrix A.

Everything operates in q-space (the conditioned parameter vector
q = scale * x — see utils/layout.py), so the assembled design matrix columns
match the reference's rmax^(2j)-scaled distortion columns
(BuildAwG.m:421-446) and the normal equations stay well-conditioned.
"""

from __future__ import annotations

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.models.projection import (
    MODEL_IDS,
    batched_jacobian_blocks,
    batched_residuals,
)
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout


class Linearizer:
    """Static index tensors on one device (float64 observations); the
    methods take q as a tensor on that device."""

    def __init__(self, problem: BAProblem, layout: ParamLayout, device="cpu"):
        self.problem = problem
        self.layout = layout
        self.model_id = MODEL_IDS[problem.settings.model]
        self.nk = layout.nk
        on_dev = lambda a, dtype=torch.long: torch.as_tensor(a, dtype=dtype, device=device)

        self.obs_img = on_dev(problem.obs_img)
        self.obs_cam = on_dev(problem.obs_cam)
        self.obs_pt = on_dev(problem.obs_pt)
        self.obs_xy = on_dev(problem.obs_xy, torch.float64)
        self.obs_ydir = on_dev(problem.y_dir, torch.float64)[self.obs_cam]
        # tie slot per observation, -1 for control-point observations
        tie_slot = problem.target_tie_slot[problem.obs_pt].astype(np.int64)
        self.obs_is_tie = on_dev(tie_slot >= 0, torch.bool)

        # per-observation active-column scale for iop jacobian (chain rule
        # d r/d q = (d r/d x) / s)
        self.iop_scale = on_dev(layout.iop_scale_full, torch.float64)[self.obs_cam]

        # design-matrix indices: observation i owns rows (2i, 2i+1); its EOP,
        # IOP and tie column ranges never overlap, so each entry of A is
        # written once.  Control observations have no tie columns.
        ne, ni = layout.n_eop, layout.n_iop
        n_obs = problem.n_obs
        self.rows = on_dev(2 * np.arange(n_obs)[:, None] + np.arange(2)[None, :])
        self.eop_cols = on_dev(
            problem.obs_img.astype(np.int64)[:, None] * ne + np.arange(ne)[None, :]
        )
        self.iop_cols = on_dev(
            layout.iop_offset + problem.obs_cam.astype(np.int64)[:, None] * ni
            + np.arange(ni)[None, :]
        )
        self.eop_sel = on_dev(layout.eop_cols)
        self.iop_sel = on_dev(layout.iop_cols)
        tie_obs = np.flatnonzero(tie_slot >= 0)
        self.tie_obs = on_dev(tie_obs)
        self.tie_cols = on_dev(
            layout.tie_offset + 3 * tie_slot[tie_obs][:, None] + np.arange(3)[None, :]
        )

    # -- parameter gather ---------------------------------------------------
    def gather(self, q):
        """Per-observation (eop, iop, xyz) parameter rows from a q-vector."""
        eop, iop, pts = self.layout.unpack_scaled(q)
        return eop[self.obs_img], iop[self.obs_cam], pts[self.obs_pt]

    # -- residuals ----------------------------------------------------------
    def residuals(self, q):
        """(n_obs, 2) misclosure w rows."""
        eop_o, iop_o, xyz_o = self.gather(q)
        return batched_residuals(eop_o, iop_o, xyz_o, self.obs_xy, self.obs_ydir,
                                 self.model_id, self.nk)

    # -- jacobian blocks ----------------------------------------------------
    def blocks(self, q):
        """Residuals + per-observation Jacobian blocks in q-space.

        Returns r (n_obs,2), J_eop (n_obs,2,6), J_iop (n_obs,2,3+nk+2),
        J_pt (n_obs,2,3). J_iop columns are already divided by the
        conditioning scale; J_pt is zeroed for control-point observations.
        """
        eop_o, iop_o, xyz_o = self.gather(q)
        r, J_eop, J_iop, J_pt = batched_jacobian_blocks(
            eop_o, iop_o, xyz_o, self.obs_xy, self.obs_ydir, self.model_id, self.nk
        )
        J_iop = J_iop / self.iop_scale[:, None, :]
        J_pt = J_pt * self.obs_is_tie[:, None, None]
        return r, J_eop, J_iop, J_pt

    # -- dense design matrix (parity path) ---------------------------------
    def dense_design(self, q):
        """Assemble the full dense A (n, u) and misclosure w (n,) in q-space.

        Row pairs (2i, 2i+1) are the x/y rows of observation i
        (BuildAwG.m:355-366 placement, zero-based).  Each block is placed
        by an indexed assignment, one write per entry, with no
        accumulation."""
        layout = self.layout
        r, J_eop, J_iop, J_pt = self.blocks(q)
        A = r.new_zeros((2 * self.problem.n_obs, layout.u))
        rows = self.rows[:, :, None]  # (n_obs, 2, 1)
        if layout.n_eop:
            A[rows, self.eop_cols[:, None, :]] = J_eop[:, :, self.eop_sel]
        if layout.n_iop:
            A[rows, self.iop_cols[:, None, :]] = J_iop[:, :, self.iop_sel]
        if layout.n_tie:
            A[rows[self.tie_obs], self.tie_cols[:, None, :]] = J_pt[self.tie_obs]
        return A, r.reshape(-1)
