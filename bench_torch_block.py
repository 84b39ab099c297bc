"""One free-network block of the pose graph, solved alone with a record of
every GN trial: the port's probe of how a float32 block of BASELINE
configs[5] (10k images) fails.

    python3 bench_torch_block.py [--n-img 10000] [--n-pts 1000000] [--blocks 4]
                                 [--block 2] [--control-frac 0.01] [--dtype float32]
                                 [--unfused] [--max-w W] [--cap 20] [--cpu]
    python3 bench_torch_block.py --compare [--cap 3] [--max-w W]  # on the card

The block is bench_torch_posegraph.py's: make_block(n_img, n_pts,
seed=2, model="fisheye", control_frac=0.01), cut by
parallel/posegraph.partition_images into `--blocks` parts, part `--block`
taken by extract_block (a free network: inner constraints).
`--control-frac 0.02` is make_block's default instead (the same
observations, other control points).  The band plan's T and W (uncapped)
are printed beside its caps: where they pass them, the float32 solve is
the unfused one whatever `--unfused` says, unless `--max-w` raises the
plan's cap on W (SchurOptions.band_max_W) to let the fused path take it.  The solve is
solve_schur's with SchurOptions(dtype, cg_maxiter=40, fused=False with
--unfused), run by the host loop (solver/schur.run_gn_loop, as
device_loop=False) so that every trial shows: one line a trial with the
damping it ran at, L1(delta), the true weighted SSR at its start point,
the model's SSR at the trial point and its CG iterations; a trial whose
start-point cost is above the last accepted one's is the rejection of
the trial before it.  A divergence (SolverDivergence) ends the run and
is printed.

--compare follows the float32 run's trials (fused where the band plan
takes the block) for `--cap` iterations and, at each trial's start
point, damping and CG tolerance, runs the step in parts on each path:
fused float32 (where the plan takes it), unfused float32 and unfused
float64.  For each part (the start-point cost, the reduced
rhs, the preconditioner and the reduced operator applied to that rhs,
CG's solution and its iterations, the back-substituted points, L1 of
the correction, the model's cost) it prints the relative distance of
each float32 path from the float64 one (and of the fused from the
unfused): the first part that parts by more than its rounding is where
float32 goes another way.

Each line is JSON.  Without --cpu it runs on the card and raises without
one.  Imports nothing of JAX.
"""

import argparse
import json
import time

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.parallel.posegraph import (
    extract_block,
    partition_images,
)
from fish_eye_bundle_adjustment_tpu_torch.solver import schur
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import SolverDivergence, resolve_device
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
from fish_eye_bundle_adjustment_tpu_torch.utils.cudatime import card
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout


def block_problem(n_img, n_pts, blocks, block, cap, control_frac=0.01):
    """Part `block` of bench_torch_posegraph.py's block (at
    `control_frac`), its iteration cap set to `cap`."""
    import dataclasses

    blk = make_block(n_img=n_img, n_pts=n_pts, model="fisheye", seed=2,
                     settings_overrides={"inner_constraints": False},
                     control_frac=control_frac)
    parts = partition_images(blk.problem, blocks)
    sub = extract_block(blk.problem, parts[block]).problem
    return dataclasses.replace(
        sub, settings=dataclasses.replace(sub.settings, iteration_cap=cap))


class Solver:
    """solve_schur's pieces for one block and one option set: the layout,
    the kernel, the stream and the raw step."""

    def __init__(self, problem, opts, dev):
        self.problem, self.opts, self.dev = problem, opts, dev
        self.layout = ParamLayout(problem)
        self.kernel = schur.SchurKernel(self.layout, opts)
        band = schur.make_band_plan(problem, self.layout, opts)
        self.fused = band is not None
        self.obs = schur.ObsData.from_problem(problem, self.layout, band, dtype=opts.dtype,
                                              device=dev, obs_order=opts.obs_order)
        self.use_ic = problem.settings.inner_constraints
        self.step = schur.schur_step_fn(self.kernel, self.layout, self.use_ic)
        self.project = schur.make_projection_builder(self.layout, self.kernel.nc, self.use_ic)

    def parts(self, x, cg_tol, lam):
        """The step at (x, cg_tol, lam) in parts, as schur_step_fn runs it
        without an explicit S: {part: tensor on the host, float64}."""
        x = torch.as_tensor(x, dtype=schur.torch_dtype(self.opts.dtype), device=self.dev)
        scalar = lambda v: torch.as_tensor(v, dtype=x.dtype, device=x.device)
        scale = self.layout.scale_like(x)
        q = x * scale
        lam_t = scalar(lam)
        fac = self.kernel.linearize(q, self.obs, lam=lam_t)
        wx, wy = self.obs.W[:, 0], self.obs.W[:, 1]
        zero = torch.zeros_like(fac.rx)
        rxm = torch.where(wx > 0, fac.rx, zero)
        rym = torch.where(wy > 0, fac.ry, zero)
        cost = schur._stable_sum(wx * rxm**2 + wy * rym**2)
        project = self.project(q)
        rhs, precond, dvec = fac.rhs_and_precond(lam=lam_t)
        matvec = lambda v: fac.schur_matvec(v) + (lam_t * dvec) * v
        dc, iters, _ = schur._pcg(matvec, rhs, precond, project, scalar(cg_tol),
                                  self.opts.cg_maxiter)
        dp = fac.back_substitute(dc)
        delta = torch.cat([dc, fac.tie_to_layout_order(dp).reshape(-1)]) / scale
        ax, ay = fac._cam_apply(dc)
        px, py = fac._point_apply(dp)
        vx = torch.where(wx > 0, ax + px + fac.rx, zero)
        vy = torch.where(wy > 0, ay + py + fac.ry, zero)
        model = schur._stable_sum(vx * vx * wx + vy * vy * wy)
        host = lambda t: t.detach().double().cpu().reshape(-1)
        return {"cost": host(cost), "rhs": host(rhs), "precond(rhs)": host(precond(rhs)),
                "S(rhs)": host(matvec(rhs)), "cg_solution": host(dc),
                "cg_iterations": host(iters), "points": host(fac.tie_to_layout_order(dp)),
                "l1_delta": host(delta.abs().sum()), "model_cost": host(model)}


def record_trials(solver, out):
    """The raw step wrapped so that each call appends its trial to `out`
    and prints it."""
    def step(x, obs, cg_tol, lam):
        res = solver.step(x, obs, cg_tol, lam)
        s = res[3].double().cpu().numpy()
        rec = dict(trial=len(out) + 1, damping=float(lam), cg_tol=float(cg_tol),
                   l1_delta=float(res[1]), cost_at_start=float(s[3]),
                   model_cost=float(s[0]), cg_iterations=int(res[4]),
                   x_start=x.detach().cpu().numpy())
        out.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "x_start"}), flush=True)
        return res

    return step


def solve(solver):
    """The host loop over the recorded step: (trials, outcome)."""
    trials = []
    t0 = time.perf_counter()
    try:
        out = schur.run_gn_loop(record_trials(solver, trials), solver.obs, solver.layout,
                                solver.problem, solver.opts, device=solver.dev)
        outcome = dict(iterations=out[5], converged=out[6], stopped_on=out[8],
                       delta_history=[float(d) for d in out[2]])
    except SolverDivergence as e:
        outcome = dict(diverged=str(e))
    outcome["wall_s"] = round(time.perf_counter() - t0, 2)
    return trials, outcome


def _dist(a, b):
    """(relative 2-norm distance, max abs distance) of a from b."""
    d = (a - b).norm() / max(float(b.norm()), 1e-300)
    return float(d), float((a - b).abs().max())


def band_shape(problem):
    """The band plan's T and W on this block without caps, beside the
    caps that make_band_plan applies."""
    from fish_eye_bundle_adjustment_tpu_torch.ops.bandplan import build_band_plan

    layout, opts = ParamLayout(problem), schur.SchurOptions(dtype=np.dtype(np.float32))
    tie = problem.target_tie_slot[problem.obs_pt]
    tie = np.where(tie >= 0, tie, layout.n_tie)
    plan = build_band_plan(tie, problem.obs_img, layout.n_tie, problem.n_img, M=opts.band_M,
                           max_T=1 << 40, max_W=1 << 40)
    return dict(T=plan.T, W=plan.W, max_T=16 * 1024, max_W=opts.band_max_W)


def compare(problem, dev, cap, max_w=None):
    """The float32 run's trials (fused where the plan takes the block, at
    a W cap of `max_w` if given), then each trial's step in parts on
    every path at the trial's inputs."""
    f32 = np.dtype(np.float32)
    fused = schur.SchurOptions(dtype=f32, cg_maxiter=40)
    if max_w:
        fused = schur.SchurOptions(dtype=f32, cg_maxiter=40, band_max_W=max_w)
    paths = {
        "fused f32": Solver(problem, fused, dev),
        "unfused f32": Solver(problem, schur.SchurOptions(dtype=f32, cg_maxiter=40,
                                                          fused=False), dev),
        "unfused f64": Solver(problem, schur.SchurOptions(dtype=np.dtype(np.float64),
                                                          cg_maxiter=40, fused=False), dev),
    }
    if not paths["fused f32"].fused:
        del paths["fused f32"]
    lead = next(iter(paths))
    trials, outcome = solve(paths[lead])
    print(json.dumps({"path": lead, **outcome}), flush=True)
    for t in trials:
        got = {name: s.parts(t["x_start"], t["cg_tol"], t["damping"])
               for name, s in paths.items()}
        ref = got["unfused f64"]
        row = dict(trial=t["trial"], damping=t["damping"])
        for part in ref:
            row[part] = {"f64": float(ref[part].abs().max()) if ref[part].numel() > 1
                         else float(ref[part][0])}
            for name in paths:
                if name != "unfused f64":
                    row[part][f"{name} vs f64"] = _dist(got[name][part], ref[part])
            if "fused f32" in got:
                row[part]["fused vs unfused"] = _dist(got["fused f32"][part],
                                                      got["unfused f32"][part])
        print(json.dumps(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-img", type=int, default=10_000)
    ap.add_argument("--n-pts", type=int, default=1_000_000)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--block", type=int, default=2)
    ap.add_argument("--control-frac", type=float, default=0.01)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--unfused", action="store_true", help="fused=False")
    ap.add_argument("--max-w", type=int, default=None,
                    help="the band plan's cap on W (SchurOptions.band_max_W)")
    ap.add_argument("--cap", type=int, default=20, help="the block's iteration cap")
    ap.add_argument("--compare", action="store_true",
                    help="fused against unfused against float64 at the fused run's trials")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None, "bench_torch_block")
    t0 = time.perf_counter()
    problem = block_problem(args.n_img, args.n_pts, args.blocks, args.block, args.cap,
                            args.control_frac)
    print(json.dumps(dict(
        n_img=problem.n_img, n_obs=problem.n_obs, n_tie=int(problem.tie_target_idx.size),
        control_frac=args.control_frac, inner_constraints=problem.settings.inner_constraints,
        band=band_shape(problem), build_s=round(time.perf_counter() - t0, 2),
        device=str(dev), card=card() if dev.type == "cuda" else None)), flush=True)
    if args.compare:
        compare(problem, dev, args.cap, args.max_w)
        return
    opts = schur.SchurOptions(dtype=np.dtype(args.dtype), cg_maxiter=40,
                              fused=False if args.unfused else None,
                              **({"band_max_W": args.max_w} if args.max_w else {}))
    solver = Solver(problem, opts, dev)
    _, outcome = solve(solver)
    print(json.dumps({"path": ("fused " if solver.fused else "unfused ") + args.dtype,
                      **outcome}), flush=True)


if __name__ == "__main__":
    main()
