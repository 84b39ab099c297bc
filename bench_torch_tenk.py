"""BASELINE configs[5]'s 10k-image block on one CUDA card: the PyTorch
port's twin of bench_tenk.py (prints ONE JSON line).

    python3 bench_torch_tenk.py [--n-img 10000] [--n-pts 1000000] [--seed 13]
                                [--steps 5] [--cpu]        # from the repository root

The block, options and keys of bench_tenk.py, through the port's fused
float32 path:

1. the band plan's geometry at 10k images (W, T, G, M, n_pad, read
   amplification, whether W is under the cap);
2. the host-synced GN step at 10 CG iterations (the step function called
   outside the device loop, its CG reading its flag back), the median of
   `--steps`, and the observations a second from it; `compile_s` is the
   first step's wall (allocator, cuBLAS and host-cache warm-up: the port
   compiles nothing per shape; the kernel library is built before,
   `kernels_build_s`);
3. a converged solve (threshold 3e-4 u, at most 60 iterations, 40 CG
   iterations to 1e-6) under the device loop, the port's default;
4. device memory after the steps (the JAX script's keys).

Keys the JAX script lacks, from the card only (null on the CPU): the
replay's ms and the capture's seconds (solver/device_loop.loop_counts),
the converged solve's torch.cuda.max_memory_allocated, each visible
card's name and power limit (nvidia-smi, a line a card).  Without --cpu it runs on the card and
raises without one; --cpu runs on the CPU (the kernels' plain versions),
for a small block.  Imports nothing of JAX.
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import _build
from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import resolve_device
from fish_eye_bundle_adjustment_tpu_torch.solver.schur import (
    ObsData, SchurKernel, SchurOptions, make_band_plan, schur_step_fn, solve_schur,
)
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
from fish_eye_bundle_adjustment_tpu_torch.utils.cudatime import card
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-img", type=int, default=10_000)
    ap.add_argument("--n-pts", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None, "bench_torch_tenk")
    on_card = dev.type == "cuda"

    # the kernel library is built (nvcc) before anything is timed
    t0 = time.perf_counter()
    if on_card:
        _build.load()
    kernels_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blk = make_block(
        n_img=args.n_img, n_pts=args.n_pts, model="fisheye", seed=args.seed,
        settings_overrides={"inner_constraints": False, "iteration_cap": 60},
        control_frac=0.01,
    )
    problem = blk.problem
    layout = ParamLayout(problem)
    build_s = time.perf_counter() - t0
    print(f"# build: {build_s:.0f}s  {problem.n_img} img / {problem.n_tie} tie / "
          f"{problem.n_obs} obs / u={layout.u}", file=sys.stderr)

    opts = SchurOptions(dtype=np.float32, cg_maxiter=10, cg_tol=1e-6, device_loop=False)
    kernel = SchurKernel(layout, opts)
    plan = make_band_plan(problem, layout, opts)
    result = {
        "metric": "tenk_cuda_single_device",
        "block": {"n_img": problem.n_img, "n_tie": problem.n_tie,
                  "n_obs": problem.n_obs, "u": int(layout.u)},
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card().splitlines() if on_card else None,
        "build_s": round(build_s, 1),
        "kernels_build_s": round(kernels_build_s, 1),
    }
    if plan is None:
        result["band_plan"] = None
        print("# band plan REJECTED: the unfused path", file=sys.stderr)
    else:
        result["band_plan"] = {
            "W": plan.W, "T": plan.T, "G": plan.G, "M": plan.M, "n_pad": plan.n_pad,
            "read_amplification": round(plan.read_amplification, 3),
            "under_W_cap": bool(plan.W <= opts.band_max_W),
        }
    obs = ObsData.from_problem(problem, layout, plan, dtype=np.float32, device=dev)
    step = schur_step_fn(kernel, layout, False)
    x0 = torch.as_tensor(layout.initial().astype(np.float32), device=dev)
    tol = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    lam = torch.tensor(0.0, dtype=torch.float32, device=dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = step(x0, obs, tol, lam)
    float(out[1])
    result["compile_s"] = round(time.perf_counter() - t0, 1)
    times = []
    xs = x0
    for _ in range(args.steps):
        t0 = time.perf_counter()
        out = step(xs, obs, tol, lam)
        xs = out[0]
        float(out[1])
        times.append(time.perf_counter() - t0)
    times.sort()
    t_step = times[len(times) // 2]
    result["step_ms"] = round(t_step * 1e3, 2)
    result["observations_per_second"] = round(problem.n_obs / t_step, 1)
    result["step_cg_iterations"] = int(out[4])
    print(f"# step {t_step * 1e3:.1f} ms -> {problem.n_obs / t_step / 1e6:.2f}M obs/s",
          file=sys.stderr)
    if on_card:
        result["hbm_bytes_in_use"] = int(torch.cuda.memory_allocated(dev))
        result["hbm_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    del obs, out, xs, step
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # converged solve (f32 floor; plateau detection stops at the floor)
    p2 = dataclasses.replace(
        problem, settings=dataclasses.replace(problem.settings, threshold=3e-4 * layout.u))
    sopts = SchurOptions(dtype=np.float32, cg_maxiter=40, cg_tol=1e-6)
    t0 = time.perf_counter()
    res = solve_schur(p2, options=sopts, keep_history=False, compute_covariance=False,
                      device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    lc = device_loop.loop_counts
    result["solve"] = {
        "converged": bool(res.converged),
        "stopped_on": res.stopped_on,
        "iterations": int(res.iterations),
        "sigma02": round(float(res.sigma02), 5),
        "final_delta_l1": round(float(res.delta_history[-1]), 2),
        "wall_s": round(wall, 1),
        "driver": ("device loop (CUDA graph)" if lc.get("graph") else
                   "device loop (eager body)" if lc else "host loop"),
        "steps": lc.get("steps"),
        "cg_iterations": int(sum(res.cg_iterations)),
        "replay_ms": (round(lc["loop_s"] / lc["steps"] * 1e3, 2)
                      if on_card and lc.get("graph") and lc["steps"] else None),
        "capture_s": round(lc["capture_s"], 2) if on_card and lc.get("graph") else None,
        "max_memory_allocated": int(torch.cuda.max_memory_allocated(dev)) if on_card else None,
    }
    print(f"# solve: converged={res.converged} ({res.stopped_on}) iters={res.iterations} "
          f"sigma02={res.sigma02:.5f}", file=sys.stderr)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
