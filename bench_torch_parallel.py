"""Runs the port's scale-out paths over every visible CUDA card on the
1k-image self-calibrating bench block, beside the single-card solves they
stand for.

    python3 bench_torch_parallel.py [ranks] [order] [coll]   # from the repository root

With no argument it runs ranks.  The pose graph's block solves over the
cards (a spawned process a card) are bench_torch_posegraph.py's and
chip_smoke.py phase 18's.

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

- coll: one NCCL rank a card (two cards or more), each rank's peer
  communicator: every schedule each collective takes (ops/peercoll.py
  `run(..., schedule=...)`) at four CTA_BYTES (so four grids), at
  all-reduce sizes across the two-shot threshold and at the solvers'
  calls on the bench block and BASELINE configs[5]'s 10k block
  (chip_smoke._coll_cases), float64 (and float32 at the tie sum), each
  bitwise its plain version, against NCCL on the same tensors: CUDA
  events, medians of 20 calls after 3 warm-ups, every rank timing
  together; rank 0's table.

Imports nothing of JAX.
"""

import dataclasses
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
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


CTA_SWEEP = (1 << 10, 4 << 10, 16 << 10, 64 << 10)
# all-reduces across the two-shot threshold (float64 values)
AR_SWEEP = (16_384, 65_536, 131_072, 196_608)


def _coll_sweep(shapes, size):
    """[(what, op, columns, dtype)]: the sweep's all-reduces, then the
    solvers' calls of chip_smoke._coll_cases (float64; the tie sum in
    float32 too)."""
    out = [(f"sweep {n}", "all_reduce", n, torch.float64) for n in AR_SWEEP]
    for what, op, shape in cs._coll_cases(shapes, size):
        cols = int(np.prod(shape)) // (size if op == "reduce_scatter" else 1)
        out.append((what, op, cols, torch.float64))
        if what == "the distributed matvec's tie sum":
            out.append((what, op, cols, torch.float32))
    return out


def _coll_rank(mesh, shapes):
    """The sweep on this rank (every rank alike): rows of rank 0."""
    import torch.distributed as dist

    from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll
    from fish_eye_bundle_adjustment_tpu_torch.utils.cudatime import cuda_ms

    comm, size = mesh.comm, mesh.size
    rng = np.random.default_rng([5, mesh.index])
    rows, default_cta = [], peercoll.CTA_BYTES
    for what, op, cols, dt in _coll_sweep(shapes, size):
        rows_in = size if op == "reduce_scatter" else 1
        x = torch.as_tensor(rng.standard_normal(rows_in * cols), dtype=dt, device=comm.device)
        default = peercoll.plan(op, cols, x.element_size(), size, comm.workspace_bytes,
                                comm.max_grid)[0]
        want = peercoll.plain(op, x, comm)
        for schedule in peercoll.TAKES[op]:
            for cta in CTA_SWEEP:
                peercoll.CTA_BYTES = cta
                chunks = peercoll.plan(op, cols, x.element_size(), size, comm.workspace_bytes,
                                       comm.max_grid, schedule)
                fn = lambda op=op, x=x, schedule=schedule: peercoll.run(op, x, comm,
                                                                       schedule=schedule)
                got = fn()
                torch.cuda.synchronize()
                comm.check()
                if not torch.equal(got, want):
                    raise RuntimeError(f"[coll] FAIL: {op} {schedule} of {what} {dt}: not "
                                       "bitwise its plain version")
                dist.barrier()
                ms = cuda_ms(fn, reps=20, warmup=3)
                rows.append(dict(what=what, op=op, cols=cols, dtype=str(dt).split(".")[-1],
                                 schedule=schedule, cta_bytes=cta, grid=chunks[0].grid,
                                 launches=len(chunks), ms=ms,
                                 default=(schedule, chunks[0].grid) == (default.schedule,
                                                                        default.grid)))
            peercoll.CTA_BYTES = default_cta
        lib = cs._library_call(op, x, torch.empty_like(want))
        lib()
        torch.cuda.synchronize()
        dist.barrier()
        rows.append(dict(what=what, op=op, cols=cols, dtype=str(dt).split(".")[-1],
                         schedule="NCCL", ms=cuda_ms(lib, reps=20, warmup=3)))
    return rows


def run_coll_part(p, card):
    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit("coll needs two cards or more: one NCCL rank a card")
    shapes = cs._coll_shapes(p)
    rows = run_ranks(_coll_rank, n, "cuda", args=(shapes,), timeout_s=900)
    for r in rows:
        if r["schedule"] == "NCCL":
            print(f"[coll] {r['op']} of {r['what']} ({r['cols']} columns, {r['dtype']}), "
                  f"{n} cards: NCCL {r['ms']:.4f} ms [{card}]")
        else:
            print(f"[coll] {r['op']} of {r['what']} ({r['cols']} columns, {r['dtype']}), "
                  f"{n} cards: {r['schedule']} grid {r['grid']} (CTA_BYTES {r['cta_bytes']}) "
                  f"{r['launches']} launch(es) {r['ms']:.4f} ms"
                  f"{' (the default)' if r['default'] else ''} [{card}]")


def main():
    parts = sys.argv[1:] or ["ranks"]
    if set(parts) - {"ranks", "order", "coll"}:
        raise SystemExit(f"usage: {sys.argv[0]} [ranks] [order] [coll]")
    card = cs.phase_environment()
    dev = torch.device("cuda")
    cs.phase_build()
    p, layout, opts, plan = cs.phase_block()
    if "ranks" in parts:
        run_ranks_part(p, layout, plan, dev, card)
    if "order" in parts:
        run_order_part(p, dev, card)
    if "coll" in parts:
        run_coll_part(p, card)


if __name__ == "__main__":
    main()
