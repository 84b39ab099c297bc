"""Runs the port's scale-out solvers (parallel/) over every visible CUDA
card, one NCCL rank each, on the 1k-image self-calibrating bench block,
beside the single-card solves they stand for.

    python3 bench_torch_parallel.py          # from the repository root

The single-card references are chip_smoke.py's phases 6 (float32 fused, 5
GN iterations) and 9 (float64 unfused, 3 iterations) on cuda:0; the
ranks then run chip_smoke's phase-16 solves (`_distributed_rank`:
solve_schur_distributed, solve_schur_sharded_state(point_mode="sharded"),
solve_schur_fused_sharded, then the mesh estimate of the stds of a
300-image block) spawned by parallel/mesh.run_ranks.  Prints each
solve's step walls, launches and collectives (rank 0's), and x's
distance from the single-card solve in units of chip_smoke's tolerances
(printed, not enforced: with several ranks the sums add in another
order, which a CG cut at 40 iterations carries on).  Imports nothing of
JAX.
"""

import time

import numpy as np
import torch

import chip_smoke as cs
from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import run_ranks


def main():
    card = cs.phase_environment()
    dev = torch.device("cuda")
    cs.phase_build()
    p, layout, opts, plan = cs.phase_block()
    _, res6 = cs.phase_main_path(p, layout, plan, dev)
    _, res9 = cs.phase_unfused_main_path(p, layout, dev)
    stds_p, pre = cs.stds_block(dev)
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    out = run_ranks(cs._distributed_rank, n, "cuda", args=(p, stds_p, pre.x, pre.sigma02),
                    timeout_s=1500)
    print(f"[parallel] {n} NCCL ranks ({out['backend']}), {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    for name, ref, tol in (("distributed", res9, cs.X_TOL_F64),
                           ("sharded", res9, cs.X_TOL_F64),
                           ("fused_sharded", res6, cs.FUSED_SHARD_TOL)):
        r = out[name]
        diff = np.abs(r["x"] - ref.x)
        use = float(np.max(diff / (tol["atol"] + tol["rtol"] * np.abs(ref.x))))
        print(f"[parallel] {name} at {n} ranks: {r['iterations']} iterations (one card: "
              f"{ref.iterations}), step walls {', '.join(f'{w:.1f}' for w in r['walls'])} ms "
              f"(one card: phase {9 if ref is res9 else 6}'s lines above), peak "
              f"{r['peak']:.2f} GiB on rank 0; max |dx| {diff.max():.3e} ({use:.3f} of "
              f"rtol={tol['rtol']:g}, atol={tol['atol']:g}); sigma0^2 {r['sigma02']:.9f} "
              f"(one card {ref.sigma02:.9f}); cg {r['cg']} (one card {ref.cg_iterations}); "
              f"launches {r['launches']}; collectives {cs._coll(r['counts'])} [{card}]")
    for what, us in out["psum_us"].items():
        print(f"[parallel] mesh.psum of {what}: {us:.1f} us a call [{card}]")
    st = out["stds"]
    print(f"[parallel] mesh stds of the {stds_p.n_img}-image block at {n} ranks: wall "
          f"{st['wall']:.2f} s, {st['cgc']['calls']} CG solves, {sum(st['its'])} iterations; "
          f"launches {st['launches']}; collectives {cs._coll(st['counts'])} [{card}]")


if __name__ == "__main__":
    main()
