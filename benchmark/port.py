"""The system under test: the PyTorch port, driven as ``solve_schur`` drives
it.  The only module of the benchmark that imports the port.

``Prepared`` takes a block (blockgen.Block) and a traffic mix's solver
options, prepares the block once through the port (ParamLayout,
SchurKernel, the band plan, ObsData on the device, the step function) and
then runs adjustments with ``adjust``: one call of ``solver/schur.drive``,
the call ``solve_schur`` makes, from given initial approximations.
Everything the port derives from the block (layout, band plan, stream,
factors) stays here; the reference works it out again.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.ops import _build, fusedmv, prefix, streamseg
from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop
from fish_eye_bundle_adjustment_tpu_torch.solver.constraints import validate_inner_constraints
from fish_eye_bundle_adjustment_tpu_torch.solver.schur import (
    ObsData,
    SchurKernel,
    SchurOptions,
    drive,
    make_band_plan,
    make_pair_plan,
    schur_step_fn,
    torch_dtype,
)
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

_DTYPES = {"float32": np.float32, "float64": np.float64}


def build_kernels():
    """Build (first run in a checkout) or load the port's CUDA kernels."""
    _build.load()


def solver_options(traffic: dict, overrides: dict | None = None) -> SchurOptions:
    """The traffic mix's SchurOptions: its `options`, with `overrides`
    (a control's) on top; dtype by name."""
    kw = dict(traffic.get("options", {}))
    kw.update(overrides or {})
    kw["dtype"] = _DTYPES[kw.get("dtype", "float64")]
    return SchurOptions(**kw)


def make_problem(block, traffic: dict) -> BAProblem:
    """The port's BAProblem for a block, with the traffic mix's threshold
    (`threshold_per_u` times u, where given) and iteration cap."""
    settings = dict(block.settings)
    if "iteration_cap" in traffic:
        settings["iteration_cap"] = traffic["iteration_cap"]
    n_img, n_t = block.n_img, block.n_targets
    fields = dict(
        settings=settings,
        image_ids=[f"I{i:05d}" for i in range(n_img)],
        camera_ids=[str(c) for c in range(block.n_cams)],
        target_ids=[f"P{i:06d}" for i in range(n_t)],
        tie_ids=[f"P{i:06d}" for i in block.tie_target_idx],
        eop0=block.true_eop.copy(),
        iop0=block.iop0,
        cnt_xyz=block.true_points.copy(),
        y_dir=np.ones(block.n_cams),
        bounds=np.tile([-block.half_wh[0], -block.half_wh[1], *block.half_wh],
                       (block.n_cams, 1)),
        rmax=block.rmax,
        obs_xy=block.obs_xy,
        obs_img=block.obs_img,
        obs_cam=block.img_cam[block.obs_img],
        obs_pt=block.obs_pt,
        tie_target_idx=block.tie_target_idx,
        target_tie_slot=block.target_tie_slot,
        img_cam=block.img_cam,
    )
    problem = BAProblem.from_arrays(fields)
    if "threshold_per_u" in traffic:
        u = ParamLayout(problem).u
        problem = dataclasses.replace(problem, settings=dataclasses.replace(
            problem.settings, threshold=traffic["threshold_per_u"] * u))
    return problem


@dataclasses.dataclass
class Answer:
    """What one adjustment returned, as drive returns it."""

    x: torch.Tensor  # (u,) on the device, the solver's dtype
    stats: torch.Tensor  # (4,) [vPv, sum vx^2, sum vy^2, cost]
    iterations: int
    converged: bool
    stopped_on: str
    cg_iterations: list
    capture_s: float  # the device loop's warm-up and graph capture
    loop_s: float  # the device loop's replays and reads


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Prepared:
    """One block prepared through the port for one traffic mix."""

    def __init__(self, block, traffic: dict, device, overrides: dict | None = None):
        self.device = dev = torch.device(device)
        self.problem = problem = make_problem(block, traffic)
        self.opts = opts = solver_options(traffic, overrides)
        t0 = time.perf_counter()
        self.layout = layout = ParamLayout(problem)
        use_ic = problem.settings.inner_constraints
        if use_ic:
            validate_inner_constraints(layout)
        self.kernel = SchurKernel(layout, opts)
        band_plan = None if opts.explicit_s is True else make_band_plan(problem, layout, opts)
        self.pairs = None if band_plan is not None else make_pair_plan(problem, layout, opts, dev)
        self.obs = ObsData.from_problem(problem, layout, band_plan, dtype=opts.dtype,
                                        device=dev, obs_order=opts.obs_order)
        self.step = schur_step_fn(self.kernel, layout, use_ic, pairs=self.pairs)
        _sync(dev)
        self.prepare_s = time.perf_counter() - t0
        self.band = None if band_plan is None else dict(W=band_plan.W, T=band_plan.T,
                                                        G=band_plan.G, n_pad=band_plan.n_pad)
        self.fused = self.kernel.use_fused(self.obs)

    @property
    def u(self) -> int:
        return self.layout.u

    @property
    def n_obs(self) -> int:
        return self.problem.n_obs

    @property
    def dof(self) -> int:
        return self.problem.n - self.layout.u

    def pack(self, init) -> np.ndarray:
        """Initial approximations (blockgen.Initial) as the port's x."""
        tie = init.points[self.problem.tie_target_idx]
        return self.layout.pack(init.eop, init.iop, tie)

    def adjust(self, init) -> Answer:
        """One adjustment from `init`, as solve_schur's _solve runs it."""
        (x, _, _, _, stats, count, converged, _, stopped_on), cg = drive(
            self.step, self.obs, self.layout, self.problem, self.opts, False, self.pairs,
            x0=self.pack(init), device=self.device)
        lc = device_loop.loop_counts
        return Answer(x=x, stats=stats, iterations=int(count), converged=bool(converged),
                      stopped_on=stopped_on, cg_iterations=list(cg),
                      capture_s=float(lc.get("capture_s", 0.0)),
                      loop_s=float(lc.get("loop_s", 0.0)))

    def sigma02(self, ans: Answer) -> float:
        """The adjustment's reported sigma0^2 (solve_schur's _finalize)."""
        return float(ans.stats[0].double()) / max(self.dof, 1)

    def tables(self, x) -> tuple:
        """The adjustment's answer as float64 numpy tables: EOPs (n_img, 6),
        IOPs (n_cam, 5 + nk), target coordinates (n_targets, 3)."""
        eop, iop, pts = self.layout.unpack(x.detach().to("cpu", torch.float64))
        return eop.numpy(), iop.numpy(), pts.numpy()

    # -- the layers' calls, at the cell's shapes -------------------------
    def _q(self, x):
        return x.to(torch_dtype(self.opts.dtype)) * self.layout.scale_like(x)

    def linearize_call(self, x):
        """kernel.linearize at x as the step calls it (undamped lambda 0)."""
        q = self._q(x)
        lam = torch.zeros((), dtype=q.dtype, device=q.device) \
            if self.opts.adaptive_damping else None
        return lambda: self.kernel.linearize(q, self.obs, lam=lam)

    def matvec_call(self, x):
        """One Schur matvec of the CG (SchurFactors.schur_matvec) at x."""
        fac = self.linearize_call(x)()
        nc = self.kernel.nc
        v = torch.linspace(-1, 1, nc, dtype=fac.rx.dtype, device=fac.rx.device)
        return lambda: fac.schur_matvec(v)

    @staticmethod
    def launch_counts() -> dict:
        """The kernels' launch counters (eager launches and the replays'
        launches added after each loop)."""
        return {"fusedmv": dict(fusedmv.kernel_launches), "prefix": dict(prefix.kernel_launches),
                "streamseg": dict(streamseg.kernel_launches)}
