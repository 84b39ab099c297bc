"""Runs the port's scale-out paths over every visible CUDA card on the
1k-image self-calibrating bench block, beside the single-card solves they
stand for.

    python3 bench_torch_parallel.py [ranks] [posegraph]   # from the repository root

With no argument it runs both parts.

- ranks: one NCCL rank a card.  The single-card references are
  chip_smoke.py's phases 6 (float32 fused, 5 GN iterations) and 9 (float64
  unfused, 3 iterations) on cuda:0; the ranks then run chip_smoke's
  phase-16 solves (`_distributed_rank`: solve_schur_distributed,
  solve_schur_sharded_state(point_mode="sharded"),
  solve_schur_fused_sharded on the host loop, which is also their default
  over several ranks, then the mesh estimate of the stds of a 300-image
  block) spawned by parallel/mesh.run_ranks.  Prints each solve's step
  walls, launches and collectives (rank 0's), and x's distance from the
  single-card solve in units of chip_smoke's tolerances (printed, not
  enforced: with several ranks the sums add in another order, which a CG
  cut at 40 iterations carries on).
- posegraph: the block solves of parallel/posegraph.solve_posegraph
  (n_blocks=4) one after the other on cuda:0 (its default), then block i
  on cuda:(i mod cards) still one after the other, then threaded over the
  cards (a worker a card: parallel_blocks=True), then threaded with torch
  on one CPU thread a worker: each block's card and wall, the block
  stage's wall, and each block's x against the serial cuda:0 solve's
  (which must agree within chip_smoke's float64 tolerance, and the
  merged poses with them).

Imports nothing of JAX.
"""

import sys
import threading
import time

import numpy as np
import torch

import chip_smoke as cs
from fish_eye_bundle_adjustment_tpu_torch.parallel import posegraph
from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import run_ranks
from fish_eye_bundle_adjustment_tpu_torch.solver import schur


def run_ranks_part(p, layout, plan, dev, card):
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
        d = out.get(f"{name} device loop")
        if d is not None:
            print(f"[parallel] {name} at {n} rank(s) under the device loop: "
                  f"{d['iterations']} iterations, {d['steps']} steps, {d['step_ms']:.1f} ms "
                  f"of chunk loop a step (capture {d['capture_s']:.2f} s, {d['reads']} packed "
                  f"reads), max |dx| from its host loop {np.abs(d['x'] - r['x']).max():.3e}; "
                  f"cg {d['cg']} [{card}]")
    for what, us in out["psum_us"].items():
        print(f"[parallel] mesh.psum of {what}: {us:.1f} us a call [{card}]")
    st = out["stds"]
    print(f"[parallel] mesh stds of the {stds_p.n_img}-image block at {n} ranks: wall "
          f"{st['wall']:.2f} s, {st['cgc']['calls']} CG solves, {sum(st['its'])} iterations; "
          f"launches {st['launches']}; collectives {cs._coll(st['counts'])} [{card}]")


def run_posegraph_part(p, card):
    n = torch.cuda.device_count()
    lock = threading.Lock()
    subs = [posegraph.extract_block(p, part) for part in posegraph.partition_images(p, 4)]
    kw = dict(keep_history=False, compute_covariance=False)
    walls = []

    def timed(problem, device, **kw):
        t0 = time.perf_counter()
        r = schur.solve_schur(problem, device=device, **kw)
        torch.cuda.synchronize(device)
        with lock:
            walls.append((problem.n_img, str(device), time.perf_counter() - t0,
                          r.iterations, r.converged))
        return r

    def a_card_a_block():
        out = []
        for i, sb in enumerate(subs):
            dev = torch.device("cuda", i % n)
            with torch.cuda.device(dev):
                out.append(timed(sb.problem, device=dev, **kw))
        return out

    modes = (
        ("serial on cuda:0", lambda: [timed(sb.problem, device=dev0, **kw) for sb in subs]),
        ("a card a block, one after the other", a_card_a_block),
        ("threaded, a worker a card (solve_posegraph's)",
         lambda: posegraph._solve_blocks(subs, None, timed, True, torch.device("cuda"))),
        ("threaded, torch on one thread a worker",
         lambda: posegraph._solve_blocks(subs, None, one_thread, True, torch.device("cuda"))),
    )
    print(f"[posegraph] torch.get_num_threads() = {torch.get_num_threads()}")

    def one_thread(problem, device, **kw):
        torch.set_num_threads(1)
        return timed(problem, device, **kw)
    dev0 = torch.device("cuda", 0)
    threads0 = torch.get_num_threads()
    results, failed = {}, []
    for what, run in modes:
        walls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            results[what] = run()
        except Exception as e:  # noqa: BLE001 (the next mode still runs; fails below)
            failed.append(what)
            print(f"[posegraph] {what}: FAILED: {type(e).__name__}: {e}")
            continue
        wall = time.perf_counter() - t0
        print(f"[posegraph] {what}: 4 block solves {wall:.2f} s over {n} card(s): "
              + "; ".join(f"{ni} images on {d} {s:.2f} s {i} it"
                          f"{'' if c else ' NOT converged'}" for ni, d, s, i, c in walls)
              + f"; sum of block walls {sum(w[2] for w in walls):.2f} s [{card}]")
        if not all(w[4] for w in walls):
            failed.append(what)
    ref = results.get(modes[0][0])
    for what, res in results.items():
        if res is ref or ref is None:
            continue
        worst = 0.0
        for a, b in zip(res, ref):
            tol = cs.X_TOL_F64
            diff = np.abs(a.x - b.x)
            worst = max(worst, float(np.max(diff / (tol["atol"] + tol["rtol"] * np.abs(b.x)))))
        eop = posegraph.merge_blocks(p, subs, res)[0]
        deop = np.abs(eop - posegraph.merge_blocks(p, subs, ref)[0]).max()
        print(f"[posegraph] {what} against serial on cuda:0: blocks' x tolerance use "
              f"{worst:.3f} (rtol {cs.X_TOL_F64['rtol']:g}, atol {cs.X_TOL_F64['atol']:g}); "
              f"merged poses max |d eop| {deop:.3e}")
        if worst > 1.0 or deop > 1e-6:
            failed.append(what)
    torch.set_num_threads(threads0)
    if failed:
        raise RuntimeError(f"[posegraph] FAIL: {failed}")


def main():
    parts = sys.argv[1:] or ["ranks", "posegraph"]
    if set(parts) - {"ranks", "posegraph"}:
        raise SystemExit(f"usage: {sys.argv[0]} [ranks] [posegraph]")
    card = cs.phase_environment()
    dev = torch.device("cuda")
    cs.phase_build()
    p, layout, opts, plan = cs.phase_block()
    if "ranks" in parts:
        run_ranks_part(p, layout, plan, dev, card)
    if "posegraph" in parts:
        run_posegraph_part(p, card)


if __name__ == "__main__":
    main()
