"""Runs the port's scale-out paths over every visible CUDA card on the
1k-image self-calibrating bench block, beside the single-card solves they
stand for.

    python3 bench_torch_parallel.py [ranks] [posegraph] [order]   # from the repository root

With no argument it runs ranks and posegraph.

- ranks: one NCCL rank a card, the mesh's collectives the peer kernels
  of ops/csrc/peercoll.cu.  The single-card references are chip_smoke.py's
  phases 6 (float32 fused, 5 GN iterations) and 9 (float64 unfused, 3
  iterations) on cuda:0; the ranks then run chip_smoke's phase-16 work
  (`_distributed_rank`: solve_schur_distributed,
  solve_schur_sharded_state(point_mode="sharded") and
  solve_schur_fused_sharded under the host loop and then under the device
  loop, their default, the collectives inside the graph's IF nodes; the
  mesh estimate of the stds of a 300-image block; each collective at the
  solvers' shapes against its plain version and NCCL) spawned by
  parallel/mesh.run_ranks.  Prints each solve's step walls and replay
  wall, capture seconds, launches and collectives (rank 0's, and per
  step), x against the other driver (which chip_smoke holds bitwise) and
  its distance from the single-card solve in units of chip_smoke's
  tolerances (printed, not enforced: with several ranks the sums add in
  another order, which a CG cut at 40 iterations carries on), and each
  collective's time a call against NCCL's.
- posegraph: the block solves of parallel/posegraph.solve_posegraph
  (n_blocks=4) one after the other on cuda:0 (its default), then block i
  on cuda:(i mod cards) still one after the other, then threaded over the
  cards (a worker a card: parallel_blocks=True), then threaded with torch
  on one CPU thread a worker: each block's card and wall, the block
  stage's wall, and each block's x against the serial cuda:0 solve's
  (which must agree within chip_smoke's float64 tolerance, and the
  merged poses with them).
- order (one card is enough): where fused_sharded's x over several ranks
  lands against one card's.  chip_smoke's phase-6 solve (float32 fused,
  5 GN iterations) on cuda:0, then solve_schur_fused_sharded at 2 and 4
  ranks as spawned processes on cuda:0 (a gloo group, every collective a
  peer kernel, as phase 19 runs them: the same sums in the same rank order
  as over as many cards), each at phase 6's CG cut (40 iterations) and at
  the solver's default (500: CG to its tolerance).  Prints each x's
  distance from one card's at the same CG depth in units of chip_smoke's
  fused_sharded tolerance, the CG counts, and a digest of each x (phase
  16 prints the same digest over several cards).

Imports nothing of JAX.
"""

import dataclasses
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
        d = out[f"{name} device loop"]
        use = float(np.max(np.abs(d["x"] - ref.x) / (tol["atol"] + tol["rtol"] * np.abs(ref.x))))
        steps = len(r["cg"])
        per_step = ", ".join(f"{op} {c['calls'] / steps:.1f}" for op, c in r["counts"].items())
        print(f"[parallel] {name} at {n} ranks under the device loop (device_loop="
              f"{d['asked']}): {d['iterations']} iterations, {d['steps']} steps, replay wall "
              f"{d['step_ms']:.1f} ms a step (chunk loop over the steps; host-loop step walls "
              f"above), capture {d['capture_s']:.2f} s, {d['reads']} packed reads; x bitwise "
              f"the host loop's: {d['bitwise']}, from one card {use:.3f} of the tolerance; "
              f"cg {d['cg']}; launches {d['launches']}; collectives a step (host loop) "
              f"{per_step} [{card}]")
    for what, us in out["psum_us"].items():
        print(f"[parallel] mesh.psum of {what}: {us:.1f} us a call [{card}]")
    if "coll" in out:
        cs._print_coll("parallel", out["coll"], card)
    st = out["stds"]
    print(f"[parallel] mesh stds of the {stds_p.n_img}-image block at {n} ranks: wall "
          f"{st['wall']:.2f} s, {st['cgc']['calls']} CG solves, {sum(st['its'])} iterations; "
          f"launches {st['launches']}; collectives {cs._coll(st['counts'])} [{card}]")


ORDER_RANKS = (2, 4)
ORDER_DEPTHS = (40, 500)  # phase 6's CG cut; SchurOptions' default


def _order_problem(p):
    return dataclasses.replace(p, settings=dataclasses.replace(p.settings, iteration_cap=5))


def _order_rank(mesh, p):
    """fused_sharded at each CG depth on this rank of a gloo group, every
    rank on cuda:0 with its peer communicator: {depth: (x, cg, sigma0^2)}."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll
    from fish_eye_bundle_adjustment_tpu_torch.parallel import fusedshard
    from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    comm = peercoll.PeerComm(dev, mesh.index, mesh.size)
    cmesh = Mesh(device=dev, size=mesh.size, index=mesh.index, comm=comm)
    out = {}
    for depth in ORDER_DEPTHS:
        r = fusedshard.solve_schur_fused_sharded(
            _order_problem(p), cmesh,
            schur.SchurOptions(dtype=np.float32, cg_maxiter=depth, device_loop=False))
        out[depth] = (r.x, r.cg_iterations, r.sigma02)
    comm.close()
    return out


def run_order_part(p, dev, card):
    tol = cs.FUSED_SHARD_TOL
    one = {}
    for depth in ORDER_DEPTHS:
        r = schur.solve_schur(
            _order_problem(p),
            schur.SchurOptions(dtype=np.float32, cg_maxiter=depth, device_loop=False),
            compute_covariance=False, device=dev)
        one[depth] = (r.x, r.cg_iterations, r.sigma02)
        print(f"[order] one card, CG cut {depth}: cg {r.cg_iterations}, sigma0^2 "
              f"{r.sigma02:.9f}, x digest {cs.digest(r.x)} [{card}]")
    failed = []
    for n in ORDER_RANKS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got = run_ranks(_order_rank, n, "cpu", args=(p,), timeout_s=1500)
        print(f"[order] {n} ranks on cuda:0: {time.perf_counter() - t0:.1f} s")
        for depth in ORDER_DEPTHS:
            x, cg, s02 = got[depth]
            ref = one[depth][0]
            diff = np.abs(x - ref)
            use = float(np.max(diff / (tol["atol"] + tol["rtol"] * np.abs(ref))))
            print(f"[order] fused_sharded at {n} ranks, CG cut {depth}: max |dx| from one "
                  f"card's {diff.max():.3e} ({use:.3f} of rtol={tol['rtol']:g}, "
                  f"atol={tol['atol']:g}); cg {cg} (one card {one[depth][1]}); sigma0^2 "
                  f"{s02:.9f} (one card {one[depth][2]:.9f}); x digest {cs.digest(x)} [{card}]")
            if not np.isfinite(x).all():
                failed.append((n, depth))
    if failed:
        raise RuntimeError(f"[order] FAIL: x not finite at {failed}")


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
    if set(parts) - {"ranks", "posegraph", "order"}:
        raise SystemExit(f"usage: {sys.argv[0]} [ranks] [posegraph] [order]")
    card = cs.phase_environment()
    dev = torch.device("cuda")
    cs.phase_build()
    p, layout, opts, plan = cs.phase_block()
    if "ranks" in parts:
        run_ranks_part(p, layout, plan, dev, card)
    if "posegraph" in parts:
        run_posegraph_part(p, card)
    if "order" in parts:
        run_order_part(p, dev, card)


if __name__ == "__main__":
    main()
