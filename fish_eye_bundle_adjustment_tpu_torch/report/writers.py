"""Report writers: the `.out` human-readable report and the `.rsd`/`.par`
machine-readable tables (reference L5: main.m:631-958, printCell.m).

Section structure mirrors the reference .out report:
  header (version/date/time/iterations/model) -> settings echo ->
  observation/unknown/DOF summary -> per-image EOPs +- sigma ->
  per-camera IOPs +- sigma + IOP correlation sub-matrix ->
  estimated tie-point coordinates +- sigma + mean sigmas ->
  corrected image measurements ->
  mean |EOP-IOP| correlation matrices per camera ->
  check-point differences (when configured).

A copy of fish_eye_bundle_adjustment_tpu/report/writers.py: the same
files, byte for byte, apart from the execution date and time taken.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from fish_eye_bundle_adjustment_tpu_torch.config import settings_echo_pairs
from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.solver import stats as stats_mod
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import DenseResult

RAD2DEG = 180.0 / math.pi
LINE = "*" * 109
_IOP_LABELS = ["xp", "yp", "c"]


def _git_version() -> str:
    try:
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            capture_output=True, text=True, timeout=5,
            cwd=Path(__file__).resolve().parent,
        )
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:
        pass
    return "unknown"


def _dot_leaders(pairs: List[Tuple[str, str]], pad: int = 4) -> str:
    """Dot-leader aligned key/value block (functions/printCell.m:1-41)."""
    width = max((len(k) for k, _ in pairs if k not in ("\\line", "\\n")), default=0) + pad
    out = []
    for k, v in pairs:
        if k == "\\line":
            out.append("-" * (width + 8))
        elif k == "\\n":
            out.append("")
        else:
            out.append(f"{k}{'.' * (width - len(k))}{v}")
    return "\n".join(out) + "\n"


def _git_modified_files() -> List[str]:
    """Modified-file provenance on dirty runs (main.m:41-50: when
    `git describe --dirty` reports dirty, the reference lists
    `git ls-files -m` in the .out header)."""
    try:
        out = subprocess.run(
            ["git", "ls-files", "-m"],
            capture_output=True, text=True, timeout=5,
            cwd=Path(__file__).resolve().parent,
        )
        if out.returncode == 0:
            return [l for l in out.stdout.splitlines() if l.strip()]
    except Exception:
        pass
    return []


def _fmt(v, width=14, dec=5):
    return f"{v:<{width}.{dec}f}"


def _fmt_e(v, width=14, dec=5):
    return f"{v:<{width}.{dec}e}"


def _fmt_sd(v, width=14, dec=5, exp=False):
    """Standard-deviation cell: 'n/a' when the solver produced no stds
    (solver/covariance.py past its size gate) instead of literal NaN."""
    if not np.isfinite(v):
        return f"{'n/a':<{width}s}"
    return _fmt_e(v, width, dec) if exp else _fmt(v, width, dec)


def _corr_block(names: List[str], mat: np.ndarray) -> str:
    """Lower-triangular correlation sub-matrix print (main.m:832-843)."""
    out = ["".join(f"{'':<6}" if i == 0 else f"{n[:2]:<6}" for i, n in enumerate([""] + names))]
    for j in range(mat.shape[0]):
        row = f"{names[j][:2]:<6}"
        row += "".join(f"{mat[j, k]:<+6.2f}" for k in range(j + 1))
        out.append(row)
    return "\n".join(out) + "\n"


def write_reports(
    result: DenseResult,
    out_dir,
    elapsed_s: Optional[float] = None,
    version: Optional[str] = None,
) -> dict:
    """Write `.out`, `.rsd`, `.par` next to the dataset (main.m:631-958).

    Returns {"out": path, "rsd": path, "par": path}.
    """
    problem = result.problem
    layout = result.layout
    settings = problem.settings
    out_dir = Path(out_dir)
    out_name = settings.output_filename or "adjustment.out"
    stem = Path(out_name).stem
    out_path = out_dir / out_name
    version = version or _git_version()
    date = datetime.datetime.now().strftime("%d-%b-%Y %H:%M:%S")
    elapsed_s = elapsed_s if elapsed_s is not None else result.elapsed_s

    x = result.x
    std = result.std if result.std is not None else np.full(layout.u, np.nan)
    # full correlations when the dense path ran; camera-block (EOP+IOP)
    # correlations from the Schur covariance otherwise — the correlation
    # sections below only index camera-block entries either way
    corr = result.camera_correlation()
    rsd = stats_mod.build_rsd(problem, layout, x, result.v)
    corrected = stats_mod.corrected_coords(problem, rsd)
    img_counts = stats_mod.count_image_points(problem)
    tgt_counts = stats_mod.count_target_images(problem)
    cp = stats_mod.check_point_diffs(problem, layout, x)

    n_ic = 7 * int(settings.inner_constraints)
    ne, ni = layout.n_eop, layout.n_iop
    iop_labels = (
        _IOP_LABELS
        + [f"k{j}" for j in range(1, layout.nk + 1)]
        + ["p1", "p2"]
    )
    active_iop_labels = [iop_labels[c] for c in layout.iop_cols]
    active_eop_labels = [
        ("Xc", "Yc", "Zc", "Omega", "Phi", "Kappa")[c] for c in layout.eop_cols
    ]

    with open(out_path, "w") as f:
        f.write(f"Version: {version}\n")
        # the JAX package's report, byte for byte (tests/test_torch_cli.py)
        f.write("TPU-native Fish-eye Bundle Adjustment (fish_eye_bundle_adjustment_tpu)\n")
        if "dirty" in version:
            # dirty-run provenance: list modified files (main.m:41-50)
            for name in _git_modified_files():
                f.write(f"modified:\t{name}\n")
        f.write("\n" + LINE + "\n\n")
        f.write(f"Execution date:\t{date}\n")
        f.write(f"Time Taken:\t\t{elapsed_s:.6g} seconds\n")
        f.write(f"Iterations:\t\t{result.iterations}\n")
        f.write(f"Model Used:\t\t{settings.model}\n")

        f.write("\nSettings used:\n")
        # echoed in the reference's .cfg key vocabulary (main.m:647-652)
        f.write(_dot_leaders(
            [("\t\t" + k, v) for k, v in settings_echo_pairs(settings)]
        ))
        f.write("\n" + LINE + "\n")

        # observation / unknown summary (main.m:654-683)
        f.write("\nObservations/Unknowns Summary\n\n")
        pairs = [
            ("Number of Photos", str(problem.n_img)),
            ("Total EOP unknowns", str(ne * problem.n_img)),
            ("Number of Cameras", str(problem.n_cam)),
            (
                "Total IOP unknowns",
                str((int(settings.estimate_c) + int(settings.estimate_xp) + int(settings.estimate_yp)) * problem.n_cam),
            ),
            (
                "Total distortion unknowns",
                str(
                    (
                        int(settings.estimate_radial) * layout.nk
                        + int(settings.estimate_decent) * 2
                    )
                    * problem.n_cam
                ),
            ),
            ("Number of tie/control points", str(problem.num_gcp)),
            ("Number of tie/control points to be estimated", str(layout.n_tie)),
            ("Number of control/tie point unknowns", str(layout.tie_size)),
            ("\\line", ""),
            ("Total Unknowns", str(layout.u)),
            ("\\n", ""),
            ("Number of image points", str(problem.n_obs)),
            ("Total number of observations", str(problem.n)),
            ("Number of Inner Constraints", str(n_ic)),
            ("\\line", ""),
            ("Total Number of Observations", str(problem.n + n_ic)),
            ("\\n", ""),
            ("Total Degrees of Freedom", str(problem.n + n_ic - layout.u)),
            ("\\n", ""),
            ("A-Posteriori", f"{result.sigma02:.10g}"),
            ("RMSx", f"{result.rms_x:.10g}"),
            ("RMSy", f"{result.rms_y:.10g}"),
            ("RMS", f"{result.rms:.10g}"),
        ]
        f.write(_dot_leaders(pairs))
        f.write(LINE + "\n\n")

        # per-image EOPs (main.m:709-769); angles reported in degrees
        if result.std_method == "hutchinson":
            # estimated sigmas must be distinguishable from exact
            # covariance values in a metrology report (the Hutchinson
            # selected-diagonal estimator carries ~sqrt(2/n_probe)
            # per-entry relative error, solver/covariance.py)
            f.write(
                "NOTE: standard deviations below are stochastic "
                "(Hutchinson) estimates of the\ncovariance diagonal, not "
                "exact values — the problem exceeds the dense-S gate.\n\n"
            )
        f.write("Estimated EOPs\nEOP Name\tValue\tStandard Deviation\n")
        for i in range(problem.n_img):
            f.write("\n")
            f.write(
                _dot_leaders(
                    [
                        ("Image", problem.image_ids[i]),
                        ("Camera", problem.camera_ids[problem.img_cam[i]]),
                        ("Number of image points", str(img_counts[i])),
                        ("\\line", ""),
                    ]
                )
            )
            for local, col in enumerate(layout.eop_cols):
                idx = i * ne + local
                val, sd = x[idx], std[idx]
                if col >= 3:  # angles -> degrees (main.m:750-767)
                    val, sd = val * RAD2DEG, sd * RAD2DEG
                f.write(f"{active_eop_labels[local]:<14.5s}{_fmt(val)}{_fmt_sd(sd)}\n")

        # per-camera IOPs + correlation sub-matrix (main.m:771-864)
        f.write(
            "\n" + LINE + "\n\nEstimated IOPs and Distortions for each Camera\n"
            "IOP Name\tValue\tStandard Deviation\n\n"
        )
        eop_iop_corr_blocks = []
        for ci in range(problem.n_cam):
            f.write(
                _dot_leaders(
                    [
                        ("Camera", problem.camera_ids[ci]),
                        ("y axis dir", f"{problem.y_dir[ci]:g}"),
                        ("x min", f"{problem.bounds[ci,0]:g}"),
                        ("y min", f"{problem.bounds[ci,1]:g}"),
                        ("x max", f"{problem.bounds[ci,2]:g}"),
                        ("y max", f"{problem.bounds[ci,3]:g}"),
                        ("\\line", ""),
                    ]
                )
            )
            start = layout.iop_offset + ci * ni
            for local, col in enumerate(layout.iop_cols):
                idx = start + local
                label = iop_labels[col]
                if col >= 3:  # distortion terms in scientific notation (printDist)
                    f.write(f"{label:<14.5s}{_fmt_e(x[idx])}{_fmt_sd(std[idx], exp=True)}\n")
                else:
                    f.write(f"{label:<14.5s}{_fmt(x[idx])}{_fmt_sd(std[idx])}\n")
            if corr is not None and ni > 0:
                f.write("\nIOP Correlation sub-matrix\n" + "-" * 31 + "\n")
                sub = corr[start : start + ni, start : start + ni]
                f.write(_corr_block(active_iop_labels, sub))
                f.write("\n")

        # estimated tie-point ground coordinates (main.m:866-889)
        if layout.n_tie:
            f.write(
                "\n" + LINE + "\n\nEstimated Ground Coordinates of targets\n"
                "TargetID\tnumImages\tX\tY\tZ\tstdX\tstdY\tstdZ\n\n"
            )
            var_sum = np.zeros(3)
            for t in range(layout.n_tie):
                s0 = layout.tie_slot(t)
                xyz = x[s0 : s0 + 3]
                sd = std[s0 : s0 + 3]
                var_sum += sd**2
                n_im = tgt_counts[problem.tie_target_idx[t]]
                f.write(
                    f"{problem.tie_ids[t]:<14s}{n_im:<14d}"
                    + "".join(_fmt(v) for v in xyz)
                    + "".join(_fmt_sd(s) for s in sd)
                    + "\n"
                )
            mean_std = np.sqrt(var_sum / layout.n_tie)
            f.write("\n\t\tMeanStd X\tMeanStd Y\tMeanStd Z\n")
            f.write("\t\t" + "".join(_fmt_sd(v) for v in mean_std) + "\n")

        # corrected image measurements (main.m:891-895)
        f.write(
            "\n" + LINE + "\n\nCorrected Image Measurements\n"
            "PointID\tImageID\tCorrected x\tCorrected y\n\n"
        )
        for i in range(problem.n_obs):
            f.write(
                f"{rsd.target_ids[i]:<14s}{rsd.image_ids[i]:<14s}"
                f"{_fmt(corrected[i,0])}{_fmt(corrected[i,1])}\n"
            )

        # mean |EOP-IOP| correlation per camera (main.m:901-937)
        if corr is not None and ni > 0 and ne > 0:
            f.write(
                "\n" + LINE + "\n\nAbsolute (positive) mean correlation "
                "coefficients between EOPs and IOPs\n\n"
            )
            labels = active_eop_labels + active_iop_labels
            for ci in range(problem.n_cam):
                imgs = [i for i in range(problem.n_img) if problem.img_cam[i] == ci]
                if not imgs:
                    continue
                iop_idx = np.arange(layout.iop_offset + ci * ni, layout.iop_offset + (ci + 1) * ni)
                acc = np.zeros((ne + ni, ne + ni))
                for i in imgs:
                    idx = np.concatenate([np.arange(i * ne, (i + 1) * ne), iop_idx])
                    acc += np.abs(corr[np.ix_(idx, idx)])
                acc /= len(imgs)
                f.write(f"Camera {problem.camera_ids[ci]}\n")
                f.write(_corr_block(labels, np.tril(acc)))
                f.write("\n")

        # check points (main.m:940-950)
        if cp is not None:
            f.write("\n" + LINE + "\n\nCheck point differences\n")
            f.write(f"{'TargetID':<14s}{'diff X':<14s}{'diff Y':<14s}{'diff Z':<14s}\n\n")
            for i, cid in enumerate(cp.ids):
                f.write(f"{cid:<14s}" + "".join(_fmt(v) for v in cp.diffs[i]) + "\n")
            for cid in cp.missing:
                f.write(f"{cid:<14s}(not found among estimated tie points)\n")
            f.write(f"\n{'Mean':<14s}" + "".join(_fmt(v) for v in cp.mean) + "\n")
            f.write(f"{'RMS':<14s}" + "".join(_fmt(v) for v in cp.rms) + "\n")

    # .rsd — tab-delimited residual table (main.m:957, BuildRSD columns)
    rsd_path = out_dir / f"{stem}.rsd"
    with open(rsd_path, "w") as f:
        for row in rsd.rows():
            f.write(
                "\t".join(
                    [row[0], row[1]] + [f"{v:.10g}" for v in row[2:]]
                )
                + "\n"
            )

    # .par — calibration parameters + stds (main.m:772-824,958)
    par_path = out_dir / f"{stem}.par"
    with open(par_path, "w") as f:
        f.write(
            "Created with TPU-native Fish-eye Bundle Adjustment version:\t"
            f"{version}\t\n"
        )
        f.write(f"Execution date\t{date}\t\n\t\t\n")
        if result.std_method == "hutchinson":
            f.write("NOTE\tstds are Hutchinson estimates\t\n")
        for ci in range(problem.n_cam):
            f.write(f"Camera\t{problem.camera_ids[ci]}\t\n")
            start = layout.iop_offset + ci * ni
            for local, col in enumerate(layout.iop_cols):
                idx = start + local
                sd = f"{std[idx]:.10g}" if np.isfinite(std[idx]) else "n/a"
                f.write(f"{iop_labels[col]}\t{x[idx]:.10g}\t{sd}\n")

    return {"out": out_path, "rsd": rsd_path, "par": par_path}
