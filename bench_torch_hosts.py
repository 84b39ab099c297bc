"""The port's distributed solver over two emulated hosts (parallel/mesh.py's
two levels: the peer kernels inside a host, NCCL between hosts), on
BASELINE configs[5]'s 10k-image block.

    python3 bench_torch_hosts.py [tenk] [smoke] [coll] [--n-img 10000] [--n-pts 1000000]
                                 [--ranks 4] [--cpu]           # from the repository root

With no part it runs tenk; smoke, then coll, run before it when asked.

- tenk: chip_smoke.py's TENK_BLOCK (bench_tenk.py's make_block: 10,000
  images, 1,000,000 points, seed 13, 11,105,599 observations, iteration
  cap 60), then `--ranks` ranks (rank r on cuda:r) as two emulated hosts
  (parallel/mesh.run_ranks(..., hosts=2)) run solve_schur_distributed
  with SchurOptions() -- float64, the unfused stream, K4 under every
  segment sum -- until it stops, under its default driver on such a mesh
  (the host loop); then, in the same ranks, the same solve as one host (a
  Mesh of the flat peer kernels over every rank, as make_mesh builds on
  one host) under its default driver (the device loop).  One JSON line a
  solve: wall, iterations, stop, sigma0^2, CG counts, peak device memory
  of rank 0, K4 and peer launches, the collectives (Mesh.counts: each
  call once) and, over the hosts, each level's calls and bytes
  (Mesh.levels: "local" the host's peer collectives, "cross_host" the
  rails' NCCL calls), in total and a step, whether every rank holds x's
  bits; then a line with the largest |dx| between the two solves.  One
  untimed iteration over the hosts comes first (the rails' NCCL
  communicators, the first linearization's set-up).
- smoke: chip_smoke.py's phase 22 alone (the bench block's solve over two
  hosts against one, and the all-reduce in two levels against the flat
  peer kernel and NCCL at 2.4 MB and 23.5 MB), without the other phases.

- coll: the three collectives of the mesh over the hosts (two levels)
  against NCCL's over the whole group and the flat peer kernel over
  every rank, at the bench block's tie sum (2.4 MB) and configs[5]'s
  (23.5 MB), float64; and the rails' NCCL all-reduce of the half alone.

run_ranks tells NCCL the emulated hosts apart (NCCL_HOSTID), so between
them it takes its socket transport over loopback, as between machines
without RDMA: these times check the path and its bytes, not a real
network.  `--cpu` runs gloo ranks on the CPU with the kernels' plain
versions (a small block: `--n-img 32 --n-pts 400`).
Imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import time
import warnings

import numpy as np
import torch

import chip_smoke as cs
from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import run_ranks
from fish_eye_bundle_adjustment_tpu_torch.solver import schur
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import resolve_device
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block


def _solve(m, p):
    """solve_schur_distributed(p) on mesh m under its default driver
    (chip_smoke.solve_counted): the record of rank 0, and x."""
    r = cs.solve_counted(m, p, schur.SchurOptions())
    steps = len(r["cg"])
    per_step = lambda c: {op: dict(calls=v["calls"] / steps, bytes=v["bytes"] / steps)
                          for op, v in c.items()}
    digests = cs._every_rank(cs.digest(r["x"]))
    rec = dict(
        driver=r["driver"], wall_s=r["wall"], iterations=r["iterations"],
        stopped_on=r["stopped_on"], converged=r["converged"], sigma02=r["sigma02"],
        cg=r["cg"], steps=steps, launches=r["launches"], peer_launches=r["peer"],
        plain_calls=r["plain"], peak_gib=r["peak_gib"], collectives=r["counts"],
        collectives_a_step=per_step(r["counts"]),
        x_bitwise_every_rank=len(set(digests)) == 1, x_digest=digests[0])
    if m.hosts is not None:
        rec["levels"] = r["levels"]
        rec["levels_a_step"] = {lv: per_step(c) for lv, c in r["levels"].items()}
    lc = r["loop"]
    if lc:
        rec.update(replays=lc["replays"], capture_s=lc["capture_s"],
                   step_ms=lc["loop_s"] / lc["steps"] * 1e3)
    return rec, r["x"]


def _tenk_rank(mesh, p):
    """Both solves on this rank (every rank alike): over the hosts, then
    as one host over the same ranks.  Rank 0's records and x."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll
    from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import Mesh

    from fish_eye_bundle_adjustment_tpu_torch.parallel import dist_schur

    # one iteration first, untimed: the rails' NCCL communicators, the
    # kernel library and the first linearization's set-up
    dist_schur.solve_schur_distributed(cs._capped(p, 1), mesh, schur.SchurOptions())
    out = {}
    out["two hosts"], x_hosts = _solve(mesh, p)
    flat = (peercoll.PeerComm(mesh.device, mesh.index, mesh.size)
            if mesh.device.type == "cuda" else None)
    one = Mesh(device=mesh.device, size=mesh.size, index=mesh.index, comm=flat)
    out["one host"], x_one = _solve(one, p)
    if flat is not None:
        flat.close()
    out["max_abs_dx"] = float(np.abs(x_hosts - x_one).max())
    return out


def _coll_rank(mesh, sizes):
    """Each collective of the mesh over the hosts (two levels) against
    NCCL's over the whole group and the flat peer kernel over every rank,
    at each of `sizes` float64 values (the all-reduce's and reduce-
    scatter's input, the all-gather's output); the rails' NCCL all-reduce
    of the half alone.  Rank 0's times, ms (CUDA events, medians of 20)."""
    import torch.distributed as dist

    from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll
    from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import _quiet_deprecation
    from fish_eye_bundle_adjustment_tpu_torch.utils.cudatime import cuda_ms

    flat = peercoll.PeerComm(mesh.device, mesh.index, mesh.size)
    rng = np.random.default_rng([16, mesh.index])
    out = []
    for what, n in sizes:
        n -= n % mesh.size
        x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float64, device=mesh.device)
        part = x[: n // mesh.size].clone()
        half = x[: n // mesh.hosts.per_host].clone()
        buf, rs, ag = x.clone(), x.new_empty(n // mesh.size), x.new_empty(n)
        nccl = {
            "all_reduce": lambda: dist.all_reduce(buf),
            "reduce_scatter": lambda: dist.reduce_scatter_tensor(rs, x),
            "all_gather": lambda: dist.all_gather_into_tensor(ag, part),
        }
        ours = {"all_reduce": lambda: mesh.psum(x), "reduce_scatter": lambda: mesh.psum_scatter(x),
                "all_gather": lambda: mesh.all_gather(part)}
        peer = {op: (lambda op=op, t=t: getattr(peercoll, op)(t, flat))
                for op, t in (("all_reduce", x), ("reduce_scatter", x), ("all_gather", part))}
        rec = dict(what=what, n=n, mbytes=n * 8 / 1e6)
        with warnings.catch_warnings():
            _quiet_deprecation()
            for op in ours:
                dist.barrier()
                rec[op] = dict(two_levels_ms=cuda_ms(ours[op]), nccl_ms=cuda_ms(nccl[op]),
                               flat_peer_ms=cuda_ms(peer[op]))
            rec["rail_all_reduce_of_the_half_ms"] = cuda_ms(
                lambda: dist.all_reduce(half, group=mesh.hosts.rail_group))
        mesh.check()
        flat.check()
        out.append(rec)
    flat.close()
    return dict(out=out, nccl_hostid=os.environ.get("NCCL_HOSTID"),
                socket_ifname=os.environ.get("NCCL_SOCKET_IFNAME"))


def run_coll(args, card):
    p, _, _, _ = cs.phase_block()
    sizes = cs._hosts_sizes(p)
    t0 = time.perf_counter()
    res = run_ranks(_coll_rank, args.ranks, "cuda", args=(sizes,), timeout_s=300,
                    hosts=cs.HOSTS)
    for rec in res["out"]:
        print(json.dumps(dict(part="coll", ranks=args.ranks, hosts=cs.HOSTS,
                              nccl_hostid_rank0=res["nccl_hostid"],
                              socket_ifname=res["socket_ifname"], card=card, **rec)), flush=True)
    print(json.dumps(dict(part="coll", ranks_s=time.perf_counter() - t0)), flush=True)


def run_tenk(args, dev, card):
    t0 = time.perf_counter()
    block = dict(cs.TENK_BLOCK, n_img=args.n_img, n_pts=args.n_pts)
    p = make_block(**block).problem
    print(json.dumps(dict(part="tenk", n_img=p.n_img, n_obs=p.n_obs, n_tie=p.n_tie,
                          ranks=args.ranks, hosts=cs.HOSTS, build_s=time.perf_counter() - t0,
                          device=dev.type, card=card)), flush=True)
    t0 = time.perf_counter()
    out = run_ranks(_tenk_rank, args.ranks, dev.type, args=(p,), timeout_s=780,
                    hosts=cs.HOSTS)
    for name in ("two hosts", "one host"):
        print(json.dumps(dict(solve=name, ranks=args.ranks, **out[name])), flush=True)
    print(json.dumps(dict(max_abs_dx=out["max_abs_dx"], ranks_s=time.perf_counter() - t0,
                          card=card)), flush=True)
    bad = [n for n in ("two hosts", "one host")
           if not out[n]["x_bitwise_every_rank"]
           or (dev.type == "cuda" and out[n]["plain_calls"])]
    if bad:
        raise RuntimeError(f"[hosts] FAIL: {bad}: x not bitwise on every rank, or a plain "
                           "version ran on the card")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("parts", nargs="*", help="tenk (the default), smoke and/or coll")
    ap.add_argument("--n-img", type=int, default=cs.TENK_BLOCK["n_img"])
    ap.add_argument("--n-pts", type=int, default=cs.TENK_BLOCK["n_pts"])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU (plain versions)")
    args = ap.parse_args(argv)
    args.parts = args.parts or ["tenk"]
    if set(args.parts) - {"tenk", "smoke", "coll"}:
        ap.error(f"parts are tenk, smoke and coll, not {args.parts}")
    dev = resolve_device("cpu" if args.cpu else None, "bench_torch_hosts")
    card = None
    if dev.type == "cuda":
        card = cs.phase_environment()
        cs.phase_build()
        if torch.cuda.device_count() < args.ranks:
            raise SystemExit(f"bench_torch_hosts: {args.ranks} ranks need {args.ranks} cards")
    if "smoke" in args.parts:
        if dev.type != "cuda":
            raise SystemExit("bench_torch_hosts: smoke runs on the cards")
        p, _, _, _ = cs.phase_block()
        if cs.phase_hosts(p, card) is None:
            raise SystemExit("bench_torch_hosts: smoke needs two cards")
    if "coll" in args.parts:
        if dev.type != "cuda":
            raise SystemExit("bench_torch_hosts: coll runs on the cards")
        run_coll(args, card)
    if "tenk" in args.parts:
        run_tenk(args, dev, card)


if __name__ == "__main__":
    main(sys.argv[1:])
