"""Result type of the solvers.

Only ``DenseResult`` is ported so far: it is what the Schur path's
``_finalize`` returns.  ``solve_dense``, the f64 dense parity solver of
fish_eye_bundle_adjustment_tpu/solver/dense.py, waits for its ROADMAP
item (Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout


@dataclasses.dataclass
class DenseResult:
    problem: BAProblem
    layout: ParamLayout
    x: np.ndarray  # (u,) converged unknowns (unscaled)
    iterations: int
    converged: bool
    delta_history: List[float]  # L1(delta) per iteration
    x_history: np.ndarray  # (iterations+1, u) including initial
    v: np.ndarray  # (n,) linearized residuals at convergence
    sigma02: float
    rms_x: float
    rms_y: float
    rms: float
    Cx: Optional[np.ndarray]  # (u,u) sigma02-scaled, diag de-scaled
    std: Optional[np.ndarray]  # (u,)
    Cx_q: Optional[np.ndarray]  # pre-descale, pre-sigma02 (for correlations)
    elapsed_s: float
    # camera-block covariance from the Schur path (solver/covariance.py):
    # (nc, nc) over [EOPs | IOPs], q-space, pre-sigma02.  The report's
    # correlation sections only touch camera-block entries, so this is
    # enough at scales where the full (u, u) Cx cannot exist.
    Cc_q: Optional[np.ndarray] = None
    # provenance of `std`: "exact" (dense covariance / dense-S block
    # back-substitution) or "hutchinson" (stochastic selected-diagonal
    # estimate past the dense-S gate).  The report annotates estimated
    # sigmas so a metrology reader can tell them from exact values.
    std_method: Optional[str] = None
    # why the iteration stopped: "threshold" (reference L1 contract),
    # "plateau" (precision floor — f32 at scale; still converged=True),
    # "cap" (iteration cap, converged=False), or None (dense path /
    # pre-r5 callers)
    stopped_on: Optional[str] = None
    # CG iterations of every Gauss-Newton step the Schur path took,
    # rejected LM trials included (one linearization each); None elsewhere
    cg_iterations: Optional[List[int]] = None

    @property
    def names(self):
        return self.layout.names()

    def correlation(self) -> np.ndarray:
        """Full correlation matrix (main.m:447-456) — computed on demand."""
        d = np.sqrt(np.diag(self.Cx_q))
        return self.Cx_q / np.outer(d, d)

    def camera_correlation(self) -> Optional[np.ndarray]:
        """Camera-block (EOP+IOP) correlation matrix; indexable exactly
        like correlation() for indices < nc."""
        C = self.Cx_q if self.Cx_q is not None else self.Cc_q
        if C is None:
            return None
        nc = self.layout.eop_size + self.layout.iop_size
        C = C[:nc, :nc]
        d = np.sqrt(np.diag(C))
        return C / np.outer(d, d)
