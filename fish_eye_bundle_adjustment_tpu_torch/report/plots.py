"""Convergence / residual diagnostic plots (reference: main.m:502-584).

Four PNGs per run, named like the reference's outputs:
  delta_<stem>.png  — L1 norm of the correction per iteration
  XcYcZc_<stem>.png — first-image position trajectory over iterations
  wpk_<stem>.png    — first-image attitude trajectory over iterations
  RSDvR_<stem>.png  — radial residual component vs radial distance

A copy of fish_eye_bundle_adjustment_tpu/report/plots.py.  Importing it
imports matplotlib, so callers import it only when they plot.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from fish_eye_bundle_adjustment_tpu_torch.solver import stats as stats_mod  # noqa: E402
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import DenseResult  # noqa: E402


def write_plots(result: DenseResult, out_dir) -> list:
    out_dir = Path(out_dir)
    stem = Path(result.problem.settings.output_filename or "adjustment.out").stem
    layout = result.layout
    paths = []

    fig, ax = plt.subplots()
    ax.plot(range(1, len(result.delta_history) + 1), result.delta_history)
    ax.set_yscale("log")
    ax.set_title(r"L1 norm of $\delta$ over iterations")
    ax.set_xlabel("Iteration")
    ax.set_ylabel(r"$\sum|\delta|$")
    p = out_dir / f"delta_{stem}.png"
    fig.savefig(p, dpi=100)
    plt.close(fig)
    paths.append(p)

    if result.x_history.size and layout.n_eop:
        hist = result.x_history
        labels = [
            ("Xc", "Yc", "Zc"),
            ("omega", "phi", "kappa"),
        ]
        for fname, (cols, names) in {
            f"XcYcZc_{stem}.png": ([0, 1, 2], labels[0]),
            f"wpk_{stem}.png": ([3, 4, 5], labels[1]),
        }.items():
            fig, ax = plt.subplots()
            plotted = False
            for col, name in zip(*([cols, names])):
                slot = layout.eop_slot(0, col)
                if slot is None:
                    continue
                ax.plot(hist[:, slot], label=name)
                plotted = True
            if plotted:
                ax.legend()
                ax.set_xlabel("Iteration")
                ax.set_title(f"first-image {'position' if 'Xc' in names else 'attitude'}")
                p = out_dir / fname
                fig.savefig(p, dpi=100)
                paths.append(p)
            plt.close(fig)

    rsd = stats_mod.build_rsd(result.problem, layout, result.x, result.v)
    fig, ax = plt.subplots()
    ax.scatter(rsd.r, rsd.vr, s=4)
    ax.set_title("$v_r$ vs $r$")
    ax.set_xlabel("radial distance r")
    ax.set_ylabel("radial residual component $v_r$")
    p = out_dir / f"RSDvR_{stem}.png"
    fig.savefig(p, dpi=100)
    plt.close(fig)
    paths.append(p)
    return paths
