"""The pose graph end to end on the CUDA cards: the PyTorch port's twin
of bench_posegraph.py (prints ONE JSON line).

    python3 bench_torch_posegraph.py [--n-img 1000] [--n-pts 100000] [--blocks 4]
                                     [--dtype float32] [--cpu]   # from the repository root

The block, options and keys of bench_posegraph.py: make_block(n_img,
n_pts, seed=2), SchurOptions(dtype=float32, cg_maxiter=40), then
solve_posegraph(refine=True, compute_covariance=False) with its default
parallel blocks: over two or more visible cards one spawned process a
card, at one card the blocks one after the other.  Each block's wall is
its DenseResult.elapsed_s (the GN loop's), as the JAX script takes it.

Keys the JAX script lacks: the host seconds of the block's build and of
the kernel library's (built before the timed call), the cards visible, each block's device,
iterations and convergence, each block process's start-up seconds (spawn
to ready: torch imported, CUDA context, kernel library loaded), the
stages' host seconds (partition, blocks, merge, refine), the refine's
driver and convergence, each card's name and power limit (nvidia-smi,
a line a card; null on the CPU).  Without --cpu it runs on the cards and raises without one; --cpu
runs on the CPU (the kernels' plain versions, the blocks one after the
other), for a small block.  Imports nothing of JAX.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.parallel.posegraph import solve_posegraph
from fish_eye_bundle_adjustment_tpu_torch.ops import _build
from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import resolve_device
from fish_eye_bundle_adjustment_tpu_torch.solver.schur import SchurOptions
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
from fish_eye_bundle_adjustment_tpu_torch.utils.cudatime import card


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-img", type=int, default=1000)
    ap.add_argument("--n-pts", type=int, default=100_000)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None, "bench_torch_posegraph")
    on_card = dev.type == "cuda"

    # the kernel library is built (nvcc) before anything is timed
    t0 = time.perf_counter()
    if on_card:
        _build.load()
    kernels_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blk = make_block(
        n_img=args.n_img, n_pts=args.n_pts, model="fisheye", seed=2,
        settings_overrides={"inner_constraints": False}, control_frac=0.01,
    )
    problem = blk.problem
    build_s = time.perf_counter() - t0
    opts = SchurOptions(dtype=np.dtype(args.dtype), cg_maxiter=40)

    t0 = time.perf_counter()
    pg = solve_posegraph(
        problem, n_blocks=args.blocks, options=opts, refine=True,
        compute_covariance=False, device=dev,
    )
    t_total = time.perf_counter() - t0
    ref = pg.refined
    lc = device_loop.loop_counts
    runs = pg.block_runs
    out = {
        "n_img": problem.n_img, "n_obs": problem.n_obs,
        "n_blocks": args.blocks, "n_edges": len(pg.edges), "dtype": args.dtype,
        "end_to_end_s": round(t_total, 2),
        "block_solve_s": [round(r.elapsed_s, 2) for r in pg.block_results],
        "refine_iterations": ref.iterations if ref else None,
        "refine_sigma02": round(ref.sigma02, 5) if ref else None,
        "build_s": round(build_s, 1),
        "kernels_build_s": round(kernels_build_s, 1),
        "cards": torch.cuda.device_count() if on_card else 0,
        "block_devices": runs.devices,
        "block_n_obs": [r.problem.n_obs for r in pg.block_results],
        "block_iterations": [r.iterations for r in pg.block_results],
        "block_converged": [bool(r.converged) for r in pg.block_results],
        "startup_s": [round(s, 2) for s in runs.startup_s],
        "stage_s": {k: round(v, 3) for k, v in pg.stage_s.items()},
        "merge_ms": round(pg.stage_s["merge"] * 1e3, 1),
        "refine_converged": bool(ref.converged) if ref else None,
        "refine_stopped_on": ref.stopped_on if ref else None,
        "refine_driver": ("device loop (CUDA graph)" if lc.get("graph") else
                          "device loop (eager body)" if lc else "host loop"),
        "card": card().splitlines() if on_card else None,
    }
    print(f"# posegraph {args.blocks} blocks on {problem.n_img} img / {problem.n_obs} obs: "
          f"{t_total:.1f}s end-to-end, refine {out['refine_iterations']} iters "
          f"sigma02={out['refine_sigma02']}", file=sys.stderr)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
