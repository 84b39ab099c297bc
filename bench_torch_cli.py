"""The CLI's default route on BASELINE configs[5]'s 10k-image block, on one
CUDA card (prints one JSON line a stage, then a summary line).

    python3 bench_torch_cli.py [--n-img 10000] [--n-pts 1000000] [--seed 13]
                               [--cap N] [--keep DIR]       # from the repository root

A photogrammetrist's run of `python -m fish_eye_bundle_adjustment_tpu_torch.cli
<folder>` on an aerial block of 10,000 images: bench_tenk.py's block
(make_block(10_000, 1_000_000, seed=13, control_frac=0.01), 11,105,599
observations, u = 3,029,994) written as a dataset by synth.write_block, then
cli.main(folder, plot=False) on the card with every default.  `pick_solver`
takes "schur" (u > 3000); solve_schur runs SchurOptions() (float64,
past explicit_s_max_images = 600 the matrix-free unfused solve with K4 under
its sorted segment sums, under the device loop), then compute_stds past
max_images = 1000 the Hutchinson estimate (float32, fused: K1 once, K2 a CG
matvec, 3 k + 64 CG solves); last write_reports (.out, .rsd, .par).

The .cfg's Iteration_Cap is the block's own 20 unless `--cap` cuts it.  A
stage line gives each stage's wall and the device's peak and held bytes
(utils/observe.record_stages: the CLI's read, the solve's layout, stream,
warm-up, capture and chunk loop, the estimator's stream, factor, diag(M),
subspace, deflation and probe solves, the reports).  The summary: the
solve's iterations, stop, sigma0^2 and CG counts a step, the estimate's CG
solves and iterations by class, the launches of K4 (the solve) and K1, K2
and the span segment sum (the estimate), the plain versions called (0), and
the card's name and power limit.  The dataset goes to a temporary folder,
removed at the end, or to `--keep DIR`.  Needs a card; imports nothing of
JAX.  chip_smoke.py phase 21 runs the same route at --cap 3.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

from fish_eye_bundle_adjustment_tpu_torch import cli
from fish_eye_bundle_adjustment_tpu_torch.ops import _build
from fish_eye_bundle_adjustment_tpu_torch.solver import covariance, device_loop, schur
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import resolve_device
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block, write_block
from fish_eye_bundle_adjustment_tpu_torch.utils import observe
from fish_eye_bundle_adjustment_tpu_torch.utils.cudatime import card
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

# bench_tenk.py's block (BASELINE configs[5]) with make_block's own settings
# (Iteration_Cap 20, threshold 1e-6) but for its free network
TENK_BLOCK = dict(n_img=10_000, n_pts=1_000_000, model="fisheye", seed=13, control_frac=0.01,
                  settings_overrides={"inner_constraints": False})
# the launch counters' keys of the kernels' plain versions
PLAIN = ("fusedmv_plain", "prefix_plain", "streamseg_plain", "probes_plain", "peercoll_plain")
GIB = 2**30


def write_dataset(problem, folder, cap=None) -> float:
    """synth.write_block of `problem` into `folder`, with the .cfg's
    Iteration_Cap `cap` (None: the problem's own).  Returns the seconds."""
    if cap is not None:
        problem = dataclasses.replace(
            problem, settings=dataclasses.replace(problem.settings, iteration_cap=cap))
    t0 = time.perf_counter()
    write_block(types.SimpleNamespace(problem=problem), folder)
    return time.perf_counter() - t0


def _count_lines(path) -> int:
    n = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            n += chunk.count(b"\n")
    return n


def run_route(folder, device=None, solver="auto") -> dict:
    """cli.main(folder, plot=False, solver=solver, device=device) with its
    stages recorded (on `device`, None: the card).  Returns rc, the CLI's printed text,
    its DenseResult, the solver it picked, the stages, the counters' moves
    over the call and over compute_stds alone, the device loop's
    loop_counts and the estimate's CG iterations by class (compute_stds'
    `info`)."""
    dev = resolve_device(device, "bench_torch_cli")
    solved, stds_moves = [], []
    solve, stds = cli._solve, covariance.compute_stds

    def keep_result(*a, **k):
        solved.append(solve(*a, **k))
        return solved[-1]

    def count_stds(*a, **k):
        before = device_loop.snapshot_counters()
        out = stds(*a, info=info, **k)
        stds_moves.append(device_loop.counter_moves(before))
        return out

    text, info = io.StringIO(), {}
    device_loop.loop_counts.clear()
    before = device_loop.snapshot_counters()
    cli._solve, covariance.compute_stds = keep_result, count_stds
    try:
        with observe.record_stages(dev) as stages, contextlib.redirect_stdout(text):
            rc = cli.main(folder, plot=False, solver=solver, device=device)
    finally:
        cli._solve, covariance.compute_stds = solve, stds
    result = solved[0] if solved else None
    return dict(
        rc=rc, text=text.getvalue(), result=result, device=dev,
        solver=cli.pick_solver(result.problem, solver) if result is not None else None,
        stages=stages, moves=device_loop.counter_moves(before),
        stds_moves=stds_moves[0] if stds_moves else None,
        loop_counts=dict(device_loop.loop_counts),
        estimate=info.get("cg_classes", {}),
    )


def summarize(route) -> dict:
    """The route's numbers as one JSON-ready dict (see the module's
    docstring), with the launches each kernel should have made, from the
    CG counts, beside those it made."""
    res, lc, est = route["result"], route["loop_counts"], route["estimate"]
    moves, sm = route["moves"], route["stds_moves"] or {}
    opts = schur.SchurOptions()
    solve_k4 = moves["prefix"]["chunk_prefix"] - sm.get("prefix", {}).get("chunk_prefix", 0)
    warm = lc.get("warmup", {}).get("prefix", {}).get("chunk_prefix", 0)
    steps = len(res.cg_iterations)
    matvecs = sum(schur.cg_matvecs(c, opts.cg_maxiter) for c in res.cg_iterations)
    its = [i for cls in est.values() for i in cls]
    layout = ParamLayout(res.problem)
    k = min(16, (layout.eop_size + layout.iop_size) // 4)
    est_mv = sum(schur.cg_matvecs(i, 400) for i in its)
    fused = sm.get("fusedmv", {})
    return {
        "metric": "cli_default_route",
        "block": {"n_img": res.problem.n_img, "n_obs": res.problem.n_obs,
                  "n_tie": res.problem.n_tie, "u": int(layout.u)},
        "rc": route["rc"],
        "solver": route["solver"],
        "driver": ("device loop (CUDA graph)" if lc.get("graph") else
                   "device loop (eager body)" if lc else "host loop"),
        "iterations": int(res.iterations),
        "iteration_cap": int(res.problem.settings.iteration_cap),
        "stopped_on": res.stopped_on,
        "converged": bool(res.converged),
        "sigma02": float(res.sigma02),
        "delta_history": [float(d) for d in res.delta_history],
        "cg_per_step": [int(c) for c in res.cg_iterations],
        "replay_ms": (lc["loop_s"] / lc["steps"] * 1e3
                      if lc.get("graph") and lc.get("steps") else None),
        "capture_s": lc.get("capture_s"),
        "capture_reserved_gib": lc.get("capture_reserved_bytes", 0) / GIB,
        "std_method": res.std_method,
        "stds_cg_solves": {c: len(v) for c, v in est.items()},
        "stds_cg_iterations": {c: int(sum(v)) for c, v in est.items()},
        "stds_cg_at_cap": int(sum(i >= 400 for i in its)),
        "stds_cg_solves_want": 3 * k + 64,
        "stds": {"finite": bool(np.isfinite(res.std).all()),
                 "min": float(np.min(res.std)), "median": float(np.median(res.std))}
        if res.std is not None else None,
        "launches": {"chunk_prefix (solve)": solve_k4,
                     "fused_hpp_pass (stds)": fused.get("fused_hpp_pass", 0),
                     "fused_schur_apply (stds)": fused.get("fused_schur_apply", 0),
                     "span_segment_sum (stds)": sm.get("streamseg", {}).get(
                         "span_segment_sum", 0)},
        "launches_want": {"chunk_prefix (solve)": warm + 6 * steps + 2 * matvecs,
                          "fused_hpp_pass (stds)": 1, "fused_schur_apply (stds)": est_mv},
        "stds_cg_matvecs": sm.get("cg", {}).get("matvecs", 0),
        "plain_calls": int(sum(v for key in PLAIN for v in moves.get(key, {}).values())),
        "stage_s": {s.name: s.seconds for s in route["stages"]},
        "peak_gib": max((s.peak_bytes / GIB for s in route["stages"]), default=0.0),
    }


def stage_rows(route) -> list:
    """A dict a stage: its name, wall seconds, peak and held GiB."""
    return [dict(stage=s.name, s=round(s.seconds, 3), peak_gib=round(s.peak_bytes / GIB, 3),
                 held_gib=round(s.held_bytes / GIB, 3)) for s in route["stages"]]


def check(route, summary, folder) -> list:
    """The route's faults (empty: none): rc, solver and stds method, the
    estimate's CG solves, finite non-negative stds, the reports (.rsd with
    a row an observation, counted into summary["rsd_rows"]), and on the
    card the device loop's graph, each kernel's launches as the CG counts
    want them and no plain version."""
    res = route["result"]
    bad = []
    if route["rc"] != 0 or res is None:
        return [f"cli.main returned {route['rc']}:\n{route['text'][-2000:]}"]
    if summary["solver"] != "schur" or summary["std_method"] != "hutchinson":
        bad.append(f"solver {summary['solver']}, stds {summary['std_method']}")
    if sum(summary["stds_cg_solves"].values()) != summary["stds_cg_solves_want"]:
        bad.append(f"CG solves {summary['stds_cg_solves']}, want "
                   f"{summary['stds_cg_solves_want']}")
    if not (np.isfinite(res.std).all() and (res.std >= 0).all()):
        bad.append("stds not finite and non-negative")
    stem = Path(folder).name
    for ext in ("out", "rsd", "par"):
        if not (Path(folder) / f"{stem}.{ext}").exists():
            bad.append(f"no .{ext}")
    if not bad:
        rows = _count_lines(Path(folder) / f"{stem}.rsd")
        summary["rsd_rows"] = rows
        if rows != res.problem.n_obs:
            bad.append(f".rsd has {rows} rows, n_obs {res.problem.n_obs}")
    if route["device"].type == "cuda":
        if summary["driver"] != "device loop (CUDA graph)":
            bad.append(f"driver {summary['driver']}")
        got = {k: v for k, v in summary["launches"].items() if k in summary["launches_want"]}
        if got != summary["launches_want"] or summary["plain_calls"]:
            bad.append(f"launches {got}, want {summary['launches_want']}; plain "
                       f"{summary['plain_calls']}")
        if summary["launches"]["fused_schur_apply (stds)"] != summary["stds_cg_matvecs"]:
            bad.append("K2's launches are not the estimate's CG matvecs")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-img", type=int, default=TENK_BLOCK["n_img"])
    ap.add_argument("--n-pts", type=int, default=TENK_BLOCK["n_pts"])
    ap.add_argument("--seed", type=int, default=TENK_BLOCK["seed"])
    ap.add_argument("--cap", type=int, help="the .cfg's Iteration_Cap (default: the block's)")
    ap.add_argument("--keep", help="write the dataset and reports here, and keep them")
    args = ap.parse_args(argv)
    resolve_device(None, "bench_torch_cli")
    lines = card().splitlines()

    def emit(d):
        print(json.dumps(d), flush=True)

    t0 = time.perf_counter()
    _build.load()
    emit({"stage": "kernels build", "s": round(time.perf_counter() - t0, 3)})
    t0 = time.perf_counter()
    kw = dict(TENK_BLOCK, n_img=args.n_img, n_pts=args.n_pts, seed=args.seed)
    problem = make_block(**kw).problem
    emit({"stage": "make_block", "s": round(time.perf_counter() - t0, 3),
          "n_obs": problem.n_obs, "u": int(ParamLayout(problem).u)})
    with contextlib.ExitStack() as stack:
        root = (Path(args.keep) if args.keep else
                Path(stack.enter_context(tempfile.TemporaryDirectory(prefix="cli10k-"))))
        folder = root / "ds"
        emit({"stage": "write", "s": round(write_dataset(problem, folder, args.cap), 3),
              "pho_bytes": (folder / "synth.pho").stat().st_size})
        del problem
        t0 = time.perf_counter()
        route = run_route(folder)
        wall = time.perf_counter() - t0
        for row in stage_rows(route):
            emit(row)
        if route["result"] is None:
            summary, bad = {"rc": route["rc"]}, [route["text"][-2000:]]
        else:
            summary = summarize(route)
            bad = check(route, summary, folder)
        summary.update(cli_wall_s=wall, card=lines, faults=bad,
                       report_bytes={ext: (folder / f"ds.{ext}").stat().st_size
                                     for ext in ("out", "rsd", "par")
                                     if (folder / f"ds.{ext}").exists()})
    emit(summary)
    if bad:
        print("FAULTS: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
