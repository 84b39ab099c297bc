"""Global unknown-vector layout.

The reference hard-codes its parameter layout via index arithmetic scattered
across BuildAwG.m:52,97,110, Buildxhat.m:22-135, BuildRSD.m:14 and the report
walker (main.m:712-897).  Here it lives in one typed object.

Canonical flat order (matches Buildxhat.m so converged vectors are
directly comparable):

  [per-image active EOPs: subset of (Xc Yc Zc omega phi kappa)] * n_img
  [per-camera active IOPs: subset of (xp yp c k1..kN p1 p2)]   * n_cam
  [per-tie-point X Y Z]                                        * n_tie

Distortion conditioning: the reference scales radial/decentering design
columns by rmax^(2j) (BuildAwG.m:421-446) and de-scales delta + Cx diag after
the solve (main.m:458-482).  That is exactly a diagonal reparametrization
q = s * x, so this layout exposes a per-entry ``scale`` vector and the solvers
work throughout in q-space; unscaled x is recovered as q / s.

PyTorch port of fish_eye_bundle_adjustment_tpu/utils/layout.py: the host
tables (``scale``, the fixed values) stay float64 numpy; ``pack`` takes
numpy or torch, and ``unpack``/``unpack_scaled`` work on tensors in the
tensor's own dtype and device.
"""

from __future__ import annotations

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem

_EOP_NAMES = ("Xc", "Yc", "Zc", "w", "p", "k")


class ParamLayout:
    def __init__(self, problem: BAProblem):
        s = problem.settings
        self.problem = problem
        nk = s.num_radial_distortions
        self.nk = nk

        self.eop_active = np.array(s.eop_toggles, dtype=bool)  # (6,)
        self.iop_active = np.array(
            [s.estimate_xp, s.estimate_yp, s.estimate_c]
            + [s.estimate_radial] * nk
            + [s.estimate_decent] * 2,
            dtype=bool,
        )  # (3+nk+2,)

        self.n_eop = int(self.eop_active.sum())
        self.n_iop = int(self.iop_active.sum())
        self.n_img = problem.n_img
        self.n_cam = problem.n_cam
        self.n_tie = problem.n_tie if (s.estimate_tie or s.estimate_all_gcp) else 0

        self.eop_size = self.n_img * self.n_eop
        self.iop_size = self.n_cam * self.n_iop
        self.tie_size = self.n_tie * 3
        self.iop_offset = self.eop_size
        self.tie_offset = self.eop_size + self.iop_size
        self.u = self.eop_size + self.iop_size + self.tie_size

        self.eop_cols = np.nonzero(self.eop_active)[0]  # active columns into (.,6)
        self.iop_cols = np.nonzero(self.iop_active)[0]

        # fixed (non-estimated) values come from the input files
        self.fixed_eop = problem.eop0.copy()
        self.fixed_iop = problem.iop0.copy()
        self.fixed_points = problem.cnt_xyz.copy()

        # --- distortion conditioning scale, per active iop column -------
        # radial k_j -> rmax^(2j) (j=1..nk); decentering p1,p2 -> rmax^2
        # (BuildAwG.m:421-446; per camera since rmax is per camera).
        per_iop_scale = np.ones((self.n_cam, 3 + nk + 2), dtype=np.float64)
        rmax = problem.rmax  # (n_cam,)
        for j in range(1, nk + 1):
            per_iop_scale[:, 2 + j] = rmax ** (2 * j)
        per_iop_scale[:, 3 + nk] = rmax**2
        per_iop_scale[:, 4 + nk] = rmax**2
        self.iop_scale_full = per_iop_scale  # (n_cam, 3+nk+2)

        scale = np.ones(self.u, dtype=np.float64)
        if self.n_iop:
            scale[self.iop_offset : self.tie_offset] = per_iop_scale[
                :, self.iop_cols
            ].reshape(-1)
        self.scale = scale  # (u,)
        # device copies of the fixed tables, one set per (device, dtype)
        self._tables = {}

    # ------------------------------------------------------------------
    def pack(self, eop_full, iop_full, tie_xyz) -> np.ndarray:
        """Flatten full parameter tables into the canonical unknown vector."""
        torch_in = isinstance(eop_full, torch.Tensor)
        parts = []
        if self.n_eop:
            parts.append(eop_full[:, self.eop_cols].reshape(-1))
        if self.n_iop:
            parts.append(iop_full[:, self.iop_cols].reshape(-1))
        if self.n_tie:
            parts.append(tie_xyz.reshape(-1))
        if torch_in:
            if not parts:
                return eop_full.new_zeros((0,))
            return torch.cat(parts)
        if not parts:
            return np.zeros((0,), dtype=eop_full.dtype)
        return np.concatenate(parts)

    def initial(self) -> np.ndarray:
        """Initial unknown vector from the input files (Buildxhat.m:2-135)."""
        tie0 = self.problem.cnt_xyz[self.problem.tie_target_idx]
        return self.pack(self.problem.eop0, self.problem.iop0, tie0)

    # ------------------------------------------------------------------
    def unpack(self, x):
        """Expand an unknown vector into full parameter tables.

        Returns (eop_full (n_img,6), iop_full (n_cam,3+nk+2),
        points_full (n_targets,3)) where non-estimated entries hold their
        fixed input values and tie rows of points_full are overridden from x
        (BuildAwG.m:56-158 gather semantics).  `x` is a tensor; the tables
        come back as new tensors in its dtype, on its device.
        """
        t = self._device_tables(x.device, x.dtype)
        eop, iop, pts = t["eop"].clone(), t["iop"].clone(), t["pts"].clone()
        if self.n_eop:
            block = x[: self.eop_size].reshape(self.n_img, self.n_eop)
            eop[:, t["eop_cols"]] = block
        if self.n_iop:
            block = x[self.iop_offset : self.tie_offset].reshape(self.n_cam, self.n_iop)
            iop[:, t["iop_cols"]] = block
        if self.n_tie:
            block = x[self.tie_offset :].reshape(self.n_tie, 3)
            pts[t["tie_idx"]] = block
        return eop, iop, pts

    def unpack_scaled(self, q):
        """unpack() for a q-space (conditioned) vector: x = q / scale."""
        return self.unpack(q / self.scale_like(q))

    def scale_like(self, x):
        """``scale`` as a tensor in x's dtype, on x's device."""
        return self._device_tables(x.device, x.dtype)["scale"]

    def _device_tables(self, device, dtype):
        key = (str(device), dtype)
        if key not in self._tables:
            f = dict(device=device, dtype=dtype)
            i = dict(device=device, dtype=torch.long)
            self._tables[key] = {
                "eop": torch.as_tensor(self.fixed_eop, **f),
                "iop": torch.as_tensor(self.fixed_iop, **f),
                "pts": torch.as_tensor(self.fixed_points, **f),
                "scale": torch.as_tensor(self.scale, **f),
                "eop_cols": torch.as_tensor(self.eop_cols, **i),
                "iop_cols": torch.as_tensor(self.iop_cols, **i),
                "tie_idx": torch.as_tensor(self.problem.tie_target_idx, **i),
            }
        return self._tables[key]

    # ------------------------------------------------------------------
    def names(self):
        """Human-readable unknown names (Buildxhat.m:34,94,132 convention:
        ``Xc_<image>_<camera>``, ``k1_<camera>``, ``X_<target>``)."""
        p = self.problem
        out = []
        iop_names = (
            ["xp", "yp", "c"]
            + [f"k{j}" for j in range(1, self.nk + 1)]
            + ["p1", "p2"]
        )
        for i in range(self.n_img):
            cam = p.camera_ids[p.img_cam[i]]
            for col in self.eop_cols:
                out.append(f"{_EOP_NAMES[col]}_{p.image_ids[i]}_{cam}")
        for ci in range(self.n_cam):
            for col in self.iop_cols:
                out.append(f"{iop_names[col]}_{p.camera_ids[ci]}")
        for t in range(self.n_tie):
            tid = p.tie_ids[t]
            out.extend([f"X_{tid}", f"Y_{tid}", f"Z_{tid}"])
        return out

    # ------------------------------------------------------------------
    def eop_slot(self, img_idx: int, eop_col: int):
        """Flat index of an EOP unknown, or None if not estimated."""
        if not self.eop_active[eop_col]:
            return None
        local = int(np.searchsorted(self.eop_cols, eop_col))
        return img_idx * self.n_eop + local

    def iop_slot(self, cam_idx: int, iop_col: int):
        if not self.iop_active[iop_col]:
            return None
        local = int(np.searchsorted(self.iop_cols, iop_col))
        return self.iop_offset + cam_idx * self.n_iop + local

    def tie_slot(self, tie_idx: int):
        """Flat index of the X coordinate of tie point `tie_idx`."""
        return self.tie_offset + 3 * tie_idx
