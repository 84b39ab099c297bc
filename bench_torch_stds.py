"""The Hutchinson stds estimator alone on one CUDA card: the PyTorch port's
twin of bench_stds.py (prints ONE JSON line).

    python3 bench_torch_stds.py [--accuracy-img 500] [--accuracy-pts 20000]
                                [--scale-img 5000] [--scale-pts 400000]
                                [--n-probe 16] [--cpu]     # from the repository root

The blocks, options and keys of bench_stds.py: each block solved by
solve_schur(SchurOptions(float32, cg_maxiter=40), compute_covariance=False),
then estimate_schur_stds(n_probe, seed=1) at its x (float32; one camera,
so the fused K2 is every CG matvec).  The accuracy block (500 images,
20,000 points) holds the estimate against schur_covariance's exact stds,
which the port runs on the card in float64 (the JAX script pins them to its
host CPU); the scale block (5,000 images, 400,000 points, the script's mild
start) times the estimate, seconds a probe and the extrapolation to 64
probes as the JAX script takes them (the estimate's wall over n_probe).

Keys the JAX script lacks: each estimate's stage walls (utils/observe:
the stream, factor, diag(M), the 2 k subspace and k deflation solves, the
camera and point probes), its CG solves and iterations by class, the
extrapolation to 64 probes from those walls (everything but the probes,
plus 64 times a probe's mean), K1 and K2 launches and the CG matvecs,
peak device memory, and the card's name and power limit (nvidia-smi).
Without --cpu it runs on the card and raises without one; --cpu runs on
the CPU (the kernels' plain versions), for small blocks.  Imports nothing
of JAX.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import _build, fusedmv
from fish_eye_bundle_adjustment_tpu_torch.solver import covariance, schur
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import resolve_device
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
from fish_eye_bundle_adjustment_tpu_torch.utils import observe
from fish_eye_bundle_adjustment_tpu_torch.utils.cudatime import card
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

PROBES = ("stds camera probes", "stds point probes")


def _solve(problem, dev):
    return schur.solve_schur(
        problem, schur.SchurOptions(dtype=np.float32, cg_maxiter=40),
        keep_history=False, compute_covariance=False, device=dev,
    )


def _estimate(p, layout, res, n_probe, dev):
    """estimate_schur_stds at res.x: (stds, wall seconds, what it ran)."""
    schur.reset_cg_counts()
    fusedmv.reset_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    info = {}
    with observe.record_stages(dev) as stages:
        est = covariance.estimate_schur_stds(p, layout, res.x, res.sigma02, n_probe=n_probe,
                                             seed=1, device=dev, info=info)
    wall = time.perf_counter() - t0
    by_class = info["cg_classes"]
    stage_s = {s.name: s.seconds for s in stages}
    per_probe = sum(stage_s.get(k, 0.0) for k in PROBES) / max(n_probe, 1)
    ran = {
        "stage_s": {k: round(v, 3) for k, v in stage_s.items()},
        "cg_solves": {k: len(v) for k, v in by_class.items()},
        "cg_iterations": {k: int(sum(v)) for k, v in by_class.items()},
        "cg_matvecs": schur.cg_counts["matvecs"],
        "launches": {k: v for k, v in fusedmv.kernel_launches.items() if v},
        "peak_gib": (round(max(s.peak_bytes for s in stages) / 2**30, 3)
                     if dev.type == "cuda" else None),
        "s_per_probe_solve": round(per_probe, 4),
        "extrapolated_s_at_64_probes_by_stage": round(
            wall - per_probe * n_probe + 64 * per_probe, 1),
    }
    return est, wall, ran


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--accuracy-img", type=int, default=500)
    ap.add_argument("--accuracy-pts", type=int, default=20_000)
    ap.add_argument("--scale-img", type=int, default=5000)
    ap.add_argument("--scale-pts", type=int, default=400_000)
    ap.add_argument("--n-probe", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None, "bench_torch_stds")
    on_card = dev.type == "cuda"
    if on_card:
        _build.load()
    out = {"backend": dev.type, "card": card().splitlines() if on_card else None}

    # ---- accuracy vs exact on a mid-size block --------------------------
    p = make_block(
        n_img=args.accuracy_img, n_pts=args.accuracy_pts, model="fisheye",
        seed=3, settings_overrides={"inner_constraints": False},
        control_frac=0.02,
    ).problem
    layout = ParamLayout(p)
    res = _solve(p, dev)
    t0 = time.perf_counter()
    exact = covariance.schur_covariance(p, layout, res.x, res.sigma02, device=dev).std
    t_exact = time.perf_counter() - t0
    est, t_est, ran = _estimate(p, layout, res, args.n_probe, dev)
    live = exact > 0
    rel = np.abs(est[live] - exact[live]) / exact[live]
    out["accuracy_block"] = {
        "n_img": p.n_img, "n_obs": p.n_obs, "u": layout.u,
        "exact_s": round(t_exact, 2),
        "hutchinson_s": round(t_est, 2),
        "n_probe": args.n_probe,
        "median_rel_err": round(float(np.median(rel)), 4),
        "q90_rel_err": round(float(np.quantile(rel, 0.9)), 4),
        "zero_clip_frac": round(float((live & (est == 0)).sum() / live.sum()), 5),
        **ran,
    }
    print(f"# accuracy: {p.n_img} img u={layout.u}: exact {t_exact:.1f}s, "
          f"hutchinson({args.n_probe}) {t_est:.1f}s, "
          f"median rel {np.median(rel):.3f}", file=sys.stderr)

    # ---- wall time at scale (no exact possible) -------------------------
    # bench_stds.py's mild initialization: this times the estimator, so the
    # solve starts near its basin
    p = make_block(
        n_img=args.scale_img, n_pts=args.scale_pts, model="fisheye",
        seed=4, settings_overrides={"inner_constraints": False},
        control_frac=0.01, init_pose_sigma=0.1, init_angle_sigma=5e-4,
        init_point_sigma=0.2,
    ).problem
    layout = ParamLayout(p)
    res = _solve(p, dev)
    est, t_scale, ran = _estimate(p, layout, res, args.n_probe, dev)
    if not np.all(np.isfinite(est)):
        raise RuntimeError("the scale block's stds are not finite")
    out["scale_block"] = {
        "n_img": p.n_img, "n_obs": p.n_obs, "u": layout.u,
        "n_probe": args.n_probe,
        "hutchinson_s": round(t_scale, 2),
        "s_per_probe": round(t_scale / args.n_probe, 3),
        "extrapolated_s_at_64_probes": round(t_scale / args.n_probe * 64, 1),
        "frac_positive": round(float((est > 0).mean()), 4),
        **ran,
    }
    print(f"# scale: {p.n_img} img u={layout.u} n_obs={p.n_obs}: "
          f"hutchinson({args.n_probe}) {t_scale:.1f}s "
          f"({t_scale / args.n_probe:.2f}s/probe)", file=sys.stderr)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
