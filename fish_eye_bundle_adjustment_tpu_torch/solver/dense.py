"""Dense Gauss-Newton solver — the parity path.

PyTorch port of fish_eye_bundle_adjustment_tpu/solver/dense.py, in float64
on one device.  It reproduces the reference's solver-layer semantics
(main.m:396-497,567-628):

- weights P = diag(1/sigma^2) from Meas_std (+ optional distinct y sigma,
  interleaved x,y — main.m:396-405);
- normal equations N = A'PA, u = A'Pw over the conditioned (q-space) design
  matrix;
- free-network datum via the bordered KKT system [N G; G' 0]
  (main.m:428-440) when Inner_Constraints is set;
- convergence on the L1 norm of the DE-SCALED correction
  (main.m:458-487, functions/sumabs.m), iteration cap main.m:490-493;
- statistics from the LAST iteration's linearization: v = A*delta + w
  (main.m:569), sigma0^2 = v'Pv/(n-u) EXCLUDING the 7 constraint
  pseudo-observations (main.m:601), covariance de-scaling asymmetry (delta +
  Cx diagonal only, main.m:458-482), correlations from the pre-descale Cx
  (main.m:447-456).

One iteration (linearize + assemble + solve + the trial cost) is device
work; only the L1 norm and the three costs cross back to the host.  The
two large products are ``torch.matmul`` and the solve and inverse
``torch.linalg``: the JAX package computes them outside any Pallas kernel
too.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.solver.constraints import (
    NUM_INNER_CONSTRAINTS,
    build_G,
    validate_inner_constraints,
)
from fish_eye_bundle_adjustment_tpu_torch.solver.linearize import Linearizer
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout
from fish_eye_bundle_adjustment_tpu_torch.utils.observe import SolverDivergence


def resolve_device(device=None, caller: str = "the solver") -> torch.device:
    """`device` or, when None, "cuda" -- which must then exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}: no CUDA device available; pass device='cpu' to run "
            "on the CPU (the plain PyTorch versions of the kernels)"
        )
    return dev


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


class DenseSystem:
    """The dense normal equations of one problem on one device, float64:
    the pieces of one solve_dense iteration, each a function of tensors."""

    def __init__(self, problem: BAProblem, layout: ParamLayout, device):
        self.layout = layout
        self.lin = Linearizer(problem, layout, device)
        f64 = dict(dtype=torch.float64, device=device)
        self.scale = torch.as_tensor(layout.scale, **f64)
        self.p_diag = torch.as_tensor(problem.obs_weights().reshape(-1), **f64)
        self.use_ic = problem.settings.inner_constraints

    def design(self, x):
        """(q, A, w) at the unscaled unknowns x."""
        q = x * self.scale
        A, w = self.lin.dense_design(q)
        return q, A, w

    def normal(self, A, w):
        """N = A'PA and u = A'Pw."""
        return A.T @ (self.p_diag[:, None] * A), A.T @ (self.p_diag * w)

    def bordered(self, q, N):
        """[N G; G' 0] with the inner-constraint matrix G at q."""
        G = build_G(self.layout, q)
        d = NUM_INNER_CONSTRAINTS
        return torch.cat([torch.cat([N, G], dim=1),
                          torch.cat([G.T, N.new_zeros((d, d))], dim=1)])

    def delta(self, q, N, uvec):
        """The correction in q-space: -N^-1 u, or the KKT solve."""
        if self.use_ic:
            rhs = torch.cat([uvec, uvec.new_zeros(NUM_INNER_CONSTRAINTS)])
            return -torch.linalg.solve(self.bordered(q, N), rhs)[: self.layout.u]
        return -torch.linalg.solve(N, uvec)

    def step(self, x, lam: float):
        """One damped GN step; lam is the adaptive-LM parameter (0.0 -> the
        reference's pure GN step).  Marquardt scaling N + lam*diag(N)
        preserves the fixed point (the rhs u = A'Pw is untouched); the
        constraint border is never damped.  Returns (x + delta_x, v,
        [L1(delta_x), cost_old, model_new, cost_new])."""
        q, A, w = self.design(x)
        N, uvec = self.normal(A, w)
        dN = torch.diagonal(N)
        # relative floor keeps lam*diag damping effective in directions
        # whose diagonal is ~0 (see schur.py _clamp_diag)
        dN = torch.maximum(dN, torch.clamp(1e-6 * dN.max(), min=1e-30))
        Nd = N + torch.diag(lam * dN)
        delta_q = self.delta(q, Nd, uvec)
        delta_x = delta_q / self.scale
        v = A @ delta_q + w  # linearized residual (main.m:569)
        p = self.p_diag
        w_new = self.lin.residuals((x + delta_x) * self.scale).reshape(-1)
        scalars = torch.stack([
            delta_x.abs().sum(), torch.sum(p * w * w), torch.sum(p * v * v),
            torch.sum(p * w_new * w_new),
        ])
        return x + delta_x, v, scalars

    def covariance(self, x):
        """Cx from the inverse of the (bordered) normal matrix at x — the
        reference computes this inside the loop (main.m:428-443); it is
        evaluated once, at the final iteration's linearization point."""
        q, A, w = self.design(x)
        N, _ = self.normal(A, w)
        if self.use_ic:
            return torch.linalg.inv(self.bordered(q, N))[: self.layout.u, : self.layout.u]
        return torch.linalg.inv(N)


def solve_dense(
    problem: BAProblem,
    compute_covariance: bool = True,
    keep_history: bool = True,
    device=None,
) -> DenseResult:
    """The dense parity solve on `device` (default "cuda", which must then
    exist), with the JAX package's adaptive-LM control."""
    dev = resolve_device(device, "solve_dense")
    settings = problem.settings
    layout = ParamLayout(problem)
    u = layout.u
    n = problem.n
    if settings.inner_constraints:
        validate_inner_constraints(layout)
    system = DenseSystem(problem, layout, dev)

    t0 = time.perf_counter()
    x = torch.as_tensor(layout.initial(), dtype=torch.float64, device=dev)
    history = [x.cpu().numpy()] if keep_history else []
    delta_history: List[float] = []
    v = torch.zeros(n, dtype=torch.float64, device=dev)
    converged = False
    count = 0
    x_prev = x
    # adaptive-LM trust-region control (same controller as
    # solver/schur.py run_gn_loop): lam stays 0 while every GN step is
    # accepted — the reference-parity trajectory — and kicks in only when
    # the true weighted SSR increases (main.m has no globalization and
    # can silently loop to its cap on a divergent block)
    lam, nu = 0.0, 2.0
    slack_rel = float(np.finfo(np.float64).eps) ** (2.0 / 3.0)
    while True:
        x_trial, v_trial, scalars = system.step(x, lam)
        deltasum, cost_old, model_new, cost_new = scalars.cpu().numpy()
        deltasum = float(deltasum)
        actual, pred = cost_old - cost_new, cost_old - model_new
        slack = slack_rel * max(cost_old, 1.0)
        finite = np.isfinite(cost_new) and np.isfinite(deltasum)
        tiny = finite and deltasum <= settings.threshold
        if not (tiny or (finite and actual >= -slack)):
            lam = max(lam * nu, 1e-4)
            nu = min(nu * 2.0, 64.0)
            if lam > 1e10:
                raise SolverDivergence(count + 1, deltasum, delta_history)
            continue
        rho = actual / pred if pred > slack else 1.0
        lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        if lam < 1e-14:
            lam = 0.0
        nu = 2.0
        count += 1
        x_prev = x
        x, v = x_trial, v_trial
        delta_history.append(deltasum)
        if keep_history:
            history.append(x.cpu().numpy())
        # converge only once damping has decayed (see run_gn_loop note)
        if deltasum <= settings.threshold and lam <= 1e-3:
            converged = True
            break
        if count >= settings.iteration_cap:
            break
    elapsed = time.perf_counter() - t0

    v_np = v.cpu().numpy()
    p_np = problem.obs_weights().reshape(-1)
    # sigma0^2 redundancy EXCLUDES the 7 constraints (main.m:601)
    sigma02 = float(v_np @ (p_np * v_np) / (n - u))
    rms_x = float(np.sqrt(np.mean(v_np[0::2] ** 2)))
    rms_y = float(np.sqrt(np.mean(v_np[1::2] ** 2)))

    Cx = std = Cx_q = std_method = None
    if compute_covariance:
        Cx_q = system.covariance(x_prev).cpu().numpy()
        # de-scale the diagonal only (main.m:458-482), then apply sigma02
        # to the whole matrix (main.m:602)
        Cx = Cx_q.copy()
        np.fill_diagonal(Cx, np.diag(Cx_q) / layout.scale**2)
        Cx = sigma02 * Cx
        std = np.sqrt(np.maximum(np.diag(Cx), 0.0))
        std_method = "exact"

    return DenseResult(
        problem=problem,
        layout=layout,
        x=x.cpu().numpy(),
        iterations=count,
        converged=converged,
        delta_history=delta_history,
        x_history=np.asarray(history) if keep_history else np.zeros((0, u)),
        v=v_np,
        sigma02=sigma02,
        rms_x=rms_x,
        rms_y=rms_y,
        rms=float(np.sqrt(rms_x**2 + rms_y**2)),
        Cx=Cx,
        std=std,
        Cx_q=Cx_q,
        elapsed_s=elapsed,
        std_method=std_method,
    )
