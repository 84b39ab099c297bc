"""CLI entry point + batch driver of the PyTorch port (reference L5:
main.m:10, BatchRun.m).

Usage:
    python -m fish_eye_bundle_adjustment_tpu_torch.cli DATASET_DIR [options]
    python -m fish_eye_bundle_adjustment_tpu_torch.cli --batch ROOT_DIR [options]

A port of fish_eye_bundle_adjustment_tpu/cli.py: `main(folder, plot)`
mirrors the reference entry point main.m:10; batch mode mirrors
BatchRun.m's recursive scan for complete {.pho,.ext,.cnt,.int} sets
(BatchRun.m:52,68-150) with the project-directory .cfg fallback
(main.m:76-85).  The solve runs on the CUDA card unless the caller asks
for the CPU (`device="cpu"`, `--cpu`); without a card and without that
request it fails.  Solvers: `dense` runs the dense parity solver, `schur`
the Schur solver with its defaults (float64, the explicit dense reduced
camera system up to 600 images, the stds of solver/covariance.py), and
`auto` picks dense at u <= 3000 and schur above.  The scale modes
`distributed`, `sharded` and `fused_sharded` run the solvers of
parallel/ over `--devices` ranks (default: every visible card): started
plainly the CLI spawns them, rank r on cuda:r over NCCL (or, with --cpu,
gloo ranks on the CPU); started under torchrun (WORLD_SIZE set) it is one
of them.  Rank 0 prints and writes the reports.  `posegraph` partitions
the images into `--blocks` blocks, solves each (over several cards one
spawned process a card), merges them by a similarity pose graph and
refines the merged estimate with the Schur solver (parallel/posegraph.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path
from typing import Optional

REQUIRED_EXTS = (".pho", ".ext", ".cnt", ".int")

SCALE_MODES = ("distributed", "sharded", "fused_sharded")


def main(folder, plot: bool = True, cfg: Optional[str] = None,
         solver: str = "auto", out_dir=None, checkpoint: Optional[str] = None,
         devices: Optional[int] = None, blocks: int = 4, device=None) -> int:
    """Run one adjustment on `device` (None: the CUDA card). Returns 0 on
    success, 1 on error (the reference's main_error convention,
    main.m:23)."""
    from fish_eye_bundle_adjustment_tpu_torch.config import ConfigError
    from fish_eye_bundle_adjustment_tpu_torch.io.problem import load_problem
    from fish_eye_bundle_adjustment_tpu_torch.io.readers import DatasetError
    from fish_eye_bundle_adjustment_tpu_torch.report.writers import write_reports
    from fish_eye_bundle_adjustment_tpu_torch.utils.observe import mark_stage

    folder = Path(folder)
    out_dir = Path(out_dir) if out_dir else folder
    try:
        problem = load_problem(folder, fallback_cfg=Path(cfg) if cfg else None)
    except (DatasetError, ConfigError, OSError) as e:
        print(f"Error reading files: {e}", file=sys.stderr)
        return 1
    mark_stage("read")

    print(f"Files read successfully! ({folder})")
    print(
        f"Type set to {problem.settings.model}; "
        f"{problem.n_img} images / {problem.n_cam} cameras / "
        f"{problem.n_obs} image points / {problem.n_tie} tie points"
    )

    t0 = time.perf_counter()
    try:
        result = _solve(problem, solver, checkpoint, devices=devices,
                        blocks=blocks, keep_history=plot, device=device)
    except Exception as e:  # solver-level failure: report and continue batch
        print(f"Error during adjustment: {e}", file=sys.stderr)
        return 1
    elapsed = time.perf_counter() - t0
    # what the solver's own marks (utils/observe.mark_stage) left unnamed
    mark_stage("solve")
    if not _writes_reports():
        return 0

    for i, d in enumerate(result.delta_history, 1):
        print(f"Iteration {i}: sum|delta| = {d:.6g}")
    if not result.converged:
        print("Iteration Cap reached. This can be changed in the .cfg file")
    print(f"Elapsed time is {elapsed:.4g} seconds.")

    try:
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = write_reports(result, out_dir, elapsed_s=elapsed)
        print(f"Wrote {paths['out'].name}, {paths['rsd'].name}, {paths['par'].name}")
        mark_stage("reports")
        if plot:
            from fish_eye_bundle_adjustment_tpu_torch.report.plots import write_plots

            for p in write_plots(result, out_dir):
                print(f"Wrote {Path(p).name}")
            mark_stage("plots")
    except OSError as e:
        print(f"Error writing output: {e}", file=sys.stderr)
        return 1
    print("Done!")
    return 0


def pick_solver(problem, solver: str = "auto") -> str:
    """`auto`: the dense parity path for report-sized problems (u <= 3000),
    Schur for scale; any other name is returned as given."""
    if solver != "auto":
        return solver
    from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

    return "dense" if ParamLayout(problem).u <= 3000 else "schur"


def _solve(problem, solver: str, checkpoint: Optional[str] = None,
           devices: Optional[int] = None, blocks: int = 4,
           keep_history: bool = False, device=None):
    solver = pick_solver(problem, solver)
    if solver == "dense":
        from fish_eye_bundle_adjustment_tpu_torch.solver.dense import solve_dense

        if checkpoint:
            print("note: --checkpoint applies to the schur solver only", file=sys.stderr)
        return solve_dense(problem, keep_history=keep_history, device=device)
    if solver == "schur":
        from fish_eye_bundle_adjustment_tpu_torch.solver.schur import solve_schur
        from fish_eye_bundle_adjustment_tpu_torch.utils.observe import log_progress

        return solve_schur(
            problem, progress_fn=log_progress, checkpoint_path=checkpoint,
            keep_history=keep_history, device=device,
        )
    if solver in SCALE_MODES:
        return _solve_scale(problem, solver, checkpoint, devices, keep_history, device)
    if solver == "posegraph":
        from fish_eye_bundle_adjustment_tpu_torch.parallel.posegraph import solve_posegraph

        pg = solve_posegraph(problem, n_blocks=blocks, refine=True, device=device)
        if pg.refined is None:
            raise RuntimeError("pose-graph refine produced no global result")
        return pg.refined
    raise ValueError(f"unknown solver {solver!r}")


def _writes_reports() -> bool:
    """Rank 0 of a torchrun group prints and writes; a lone process does."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _solve_scale(problem, solver, checkpoint, devices, keep_history, device):
    """A scale mode over `devices` ranks: this process's rank under
    torchrun, else spawned ranks (parallel/mesh.run_ranks), whose rank 0
    hands its result back."""
    import torch

    from fish_eye_bundle_adjustment_tpu_torch import cli
    from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
        run_ranks,
    )

    on_cpu = device is not None and str(device) == "cpu"
    if "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        if not dist.is_initialized():
            init_distributed(device="cpu" if on_cpu else None)
        return cli.solve_on_mesh(make_mesh(devices), problem, solver, checkpoint,
                                 keep_history)
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --cpu for gloo ranks on the CPU")
    n = devices or max(torch.cuda.device_count(), 1)
    return run_ranks(cli.solve_on_mesh, n, "cpu" if on_cpu else "cuda",
                     args=(problem, solver, checkpoint, keep_history))


def solve_on_mesh(mesh, problem, solver: str, checkpoint=None, keep_history=False):
    """One rank's part of a scale mode (every rank calls it alike), with
    the JAX CLI's choices: fused_sharded at float32, every mode with the
    stds a report prints."""
    import numpy as np

    from fish_eye_bundle_adjustment_tpu_torch.utils.observe import log_progress

    kw = dict(progress_fn=log_progress, checkpoint_path=checkpoint,
              keep_history=keep_history, compute_covariance=True)
    if solver == "fused_sharded":
        from fish_eye_bundle_adjustment_tpu_torch.parallel.fusedshard import (
            solve_schur_fused_sharded,
        )
        from fish_eye_bundle_adjustment_tpu_torch.solver.schur import SchurOptions

        return solve_schur_fused_sharded(problem, mesh, SchurOptions(dtype=np.float32), **kw)
    if solver == "distributed":
        from fish_eye_bundle_adjustment_tpu_torch.parallel.dist_schur import (
            solve_schur_distributed,
        )

        return solve_schur_distributed(problem, mesh, **kw)
    if solver == "sharded":
        from fish_eye_bundle_adjustment_tpu_torch.parallel.sharded_state import (
            solve_schur_sharded_state,
        )

        return solve_schur_sharded_state(problem, mesh, **kw)
    raise ValueError(f"unknown scale mode {solver!r}")


def find_datasets(root) -> list:
    """Recursively find folders holding a complete {.pho,.ext,.cnt,.int} set;
    warn on partial or duplicated sets (BatchRun.m:68-150)."""
    root = Path(root)
    complete, partial = [], []
    for d in sorted({p.parent for ext in REQUIRED_EXTS for p in root.rglob(f"*{ext}")}):
        counts = {ext: len(list(d.glob(f"*{ext}"))) for ext in REQUIRED_EXTS}
        if all(c >= 1 for c in counts.values()):
            if any(c > 1 for c in counts.values()):
                print(f"warning: duplicate dataset files in {d}: {counts}", file=sys.stderr)
            else:
                complete.append(d)
        elif any(c > 0 for c in counts.values()):
            partial.append(d)
    for d in partial:
        print(f"warning: incomplete dataset (missing required files): {d}", file=sys.stderr)
    return complete


def batch(root, plot: bool = False, cfg: Optional[str] = None, solver: str = "auto",
          device=None) -> int:
    """Run every complete dataset under `root` (BatchRun.m:57-65).

    Unlike the reference (which aborts the whole batch on first error,
    BatchRun.m:60-64), failures are reported and the batch continues;
    the return code is the number of failed datasets."""
    datasets = find_datasets(root)
    if not datasets:
        print(f"no complete datasets under {root}", file=sys.stderr)
        return 1
    failures = 0
    for d in datasets:
        print(f"=== {d} ===")
        failures += 1 if main(d, plot=plot, cfg=cfg, solver=solver, device=device) else 0
    print(f"Batch finished: {len(datasets) - failures}/{len(datasets)} succeeded")
    return failures


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fish_eye_bundle_adjustment_tpu_torch",
        description="fish-eye bundle adjustment, PyTorch/CUDA port",
    )
    ap.add_argument("folder", nargs="?", default=".", help="dataset folder (default: cwd)")
    ap.add_argument("--batch", metavar="ROOT", help="recursively adjust every dataset under ROOT")
    ap.add_argument("--no-plots", action="store_true", help="skip PNG plot output")
    ap.add_argument("--cfg", help="fallback .cfg when the dataset folder has none")
    ap.add_argument(
        "--solver",
        choices=("auto", "dense", "schur", "distributed", "sharded",
                 "fused_sharded", "posegraph"),
        default="auto",
        help="dense parity solver, Schur solver, or size-based auto (dense at "
             "u <= 3000, schur above); distributed, sharded and fused_sharded run "
             "over --devices ranks; posegraph solves --blocks image blocks and "
             "merges them",
    )
    ap.add_argument("--devices", type=int,
                    help="ranks of --solver distributed/sharded/fused_sharded (default: "
                         "every visible CUDA card; with --cpu, 1)")
    ap.add_argument("--blocks", type=int, default=4,
                    help="number of image partitions for --solver posegraph")
    ap.add_argument("--out-dir", help="write outputs here instead of the dataset folder")
    ap.add_argument("--checkpoint", help="solver checkpoint file (schur solver: resume if present)")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU instead of the CUDA card")
    return ap


def cli(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.batch:
        return batch(args.batch, plot=not args.no_plots, cfg=args.cfg, solver=args.solver,
                     device=device)
    return main(
        args.folder,
        plot=not args.no_plots,
        cfg=args.cfg,
        solver=args.solver,
        out_dir=args.out_dir,
        checkpoint=args.checkpoint,
        devices=args.devices,
        blocks=args.blocks,
        device=device,
    )


if __name__ == "__main__":
    sys.exit(cli())
