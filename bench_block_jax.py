"""The JAX package's host loop on one free-network block of the pose graph,
every GN trial recorded: the reference that bench_torch_block.py's float64
records are held to.

    python3 bench_block_jax.py [--n-img 10000] [--n-pts 1000000] [--blocks 4]
                               [--block 2] [--control-frac 0.01] [--cap 20]
                               [--out FILE]

The block is bench_torch_block.py's, built by the JAX package's own
generator: make_block(n_img, n_pts, seed=2, model="fisheye",
control_frac=0.01, inner_constraints off), cut by
parallel/posegraph.partition_images into `--blocks` parts, part `--block`
taken by extract_block (a free network).  The solve is the unfused
float64 step (SchurOptions(dtype=float64, cg_maxiter=40, fused=False,
device_loop=False)) under solver/schur.run_gn_loop, iteration cap
`--cap`.  One JSON line a trial with bench_torch_block.py's fields
(damping, CG tolerance, L1(delta), the true weighted SSR at the trial's
start point, the model's SSR at the trial point, CG iterations), then
the outcome (iterations, converged, stopped_on, delta_history, or the
divergence).  `--out` also writes the lines to FILE.

Runs on the CPU only (the JAX platform is pinned before any compile);
at the default size the block build takes ~1 min and the solve minutes.
"""

import argparse
import dataclasses
import json
import time

import numpy as np


def block_problem(n_img, n_pts, blocks, block, cap, control_frac):
    """Part `block` of the JAX package's make_block(n_img, n_pts, seed=2)
    at `control_frac`, its iteration cap set to `cap`."""
    from fish_eye_bundle_adjustment_tpu.parallel.posegraph import (
        extract_block,
        partition_images,
    )
    from fish_eye_bundle_adjustment_tpu.synth import make_block

    blk = make_block(n_img=n_img, n_pts=n_pts, model="fisheye", seed=2,
                     settings_overrides={"inner_constraints": False},
                     control_frac=control_frac)
    sub = extract_block(blk.problem, partition_images(blk.problem, blocks)[block]).problem
    return dataclasses.replace(sub, settings=dataclasses.replace(
        sub.settings, iteration_cap=cap))


def solve(problem, emit):
    """The JAX host loop over the unfused float64 step; `emit(record)` is
    called once a trial.  Returns the outcome."""
    import jax

    from fish_eye_bundle_adjustment_tpu.solver import schur
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout
    from fish_eye_bundle_adjustment_tpu.utils.observe import SolverDivergence

    dtype = np.float64
    opts = schur.SchurOptions(dtype=dtype, cg_maxiter=40, fused=False, device_loop=False)
    layout = ParamLayout(problem)
    kernel = schur.SchurKernel(layout, opts, obs_order=opts.obs_order)
    order = schur.ObsData.sort_order_by_tie(problem, layout)
    obs = schur.ObsData.from_problem(problem, layout, dtype=dtype, order=order, with_plan=True)
    raw = jax.jit(schur.schur_step_fn(kernel, layout, problem.settings.inner_constraints))
    n = [0]

    def step(x, o, tol, lam):
        res = raw(x, o, tol, lam, None)
        s = np.asarray(res[3], np.float64)
        n[0] += 1
        emit(dict(trial=n[0], damping=float(lam), cg_tol=float(tol),
                  l1_delta=float(res[1]), cost_at_start=float(s[3]),
                  model_cost=float(s[0]), cg_iterations=int(res[4])))
        return res

    t0 = time.perf_counter()
    try:
        out = schur.run_gn_loop(step, obs, layout, problem, opts)
        outcome = dict(iterations=int(out[5]), converged=bool(out[6]), stopped_on=out[8],
                       delta_history=[float(d) for d in out[2]])
    except SolverDivergence as e:
        outcome = dict(diverged=str(e))
    outcome["wall_s"] = round(time.perf_counter() - t0, 2)
    return outcome


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-img", type=int, default=10_000)
    ap.add_argument("--n-pts", type=int, default=1_000_000)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--block", type=int, default=2)
    ap.add_argument("--control-frac", type=float, default=0.01)
    ap.add_argument("--cap", type=int, default=20, help="the block's iteration cap")
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sink = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    t0 = time.perf_counter()
    problem = block_problem(args.n_img, args.n_pts, args.blocks, args.block, args.cap,
                            args.control_frac)
    emit(dict(n_img=problem.n_img, n_obs=problem.n_obs,
              n_tie=int(problem.tie_target_idx.size), control_frac=args.control_frac,
              inner_constraints=problem.settings.inner_constraints, cap=args.cap,
              package="jax", build_s=round(time.perf_counter() - t0, 2)))
    emit({"path": "unfused float64", **solve(problem, emit)})
    if sink:
        sink.close()


if __name__ == "__main__":
    main()
