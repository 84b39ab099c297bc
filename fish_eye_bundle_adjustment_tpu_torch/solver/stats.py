"""Statistics / QA layer: residual decomposition, corrected measurements,
check-point differences (reference L4: main.m:567-628, functions/BuildRSD.m).

A copy of fish_eye_bundle_adjustment_tpu/solver/stats.py, numpy on the
host; the layout's unpack runs on a CPU tensor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout


@dataclasses.dataclass
class RsdTable:
    """Per-image-point residual decomposition (BuildRSD.m:1-43).

    Columns: target, image, x, y, r (radial distance from the principal
    point), vx, vy, vr (radial residual component), vt (tangential).
    """

    target_ids: List[str]
    image_ids: List[str]
    x: np.ndarray
    y: np.ndarray
    r: np.ndarray
    vx: np.ndarray
    vy: np.ndarray
    vr: np.ndarray
    vt: np.ndarray

    def rows(self):
        for i in range(len(self.target_ids)):
            yield (
                self.target_ids[i],
                self.image_ids[i],
                self.x[i],
                self.y[i],
                self.r[i],
                self.vx[i],
                self.vy[i],
                self.vr[i],
                self.vt[i],
            )


def build_rsd(problem: BAProblem, layout: ParamLayout, x: np.ndarray, v: np.ndarray) -> RsdTable:
    """Polar residual decomposition about the (estimated) principal point.

    vr = |v| cos(theta - phi), vt = |v| sin(theta - phi) with
    theta = atan2(y_bar, x_bar), phi = atan2(vy, vx) (BuildRSD.m:30-36).
    xp/yp come from the adjusted unknowns when estimated, else from .int
    (BuildRSD.m:14-27).
    """
    _, iop_full, _ = layout.unpack(torch.from_numpy(np.asarray(x, dtype=np.float64)))
    iop_full = iop_full.numpy()
    xp = iop_full[problem.obs_cam, 0]
    yp = iop_full[problem.obs_cam, 1]

    vx = v[0::2]
    vy = v[1::2]
    xb = problem.obs_xy[:, 0] - xp
    yb = problem.obs_xy[:, 1] - yp
    theta = np.arctan2(yb, xb)
    phi = np.arctan2(vy, vx)
    vdist = np.hypot(vx, vy)
    return RsdTable(
        target_ids=[problem.target_ids[i] for i in problem.obs_pt],
        image_ids=[problem.image_ids[i] for i in problem.obs_img],
        x=problem.obs_xy[:, 0].copy(),
        y=problem.obs_xy[:, 1].copy(),
        r=np.hypot(xb, yb),
        vx=vx.copy(),
        vy=vy.copy(),
        vr=vdist * np.cos(theta - phi),
        vt=vdist * np.sin(theta - phi),
    )


def corrected_coords(problem: BAProblem, rsd: RsdTable) -> np.ndarray:
    """(n_obs, 2) corrected image measurements x+vx, y+vy (main.m:586-590)."""
    return np.column_stack([problem.obs_xy[:, 0] + rsd.vx, problem.obs_xy[:, 1] + rsd.vy])


@dataclasses.dataclass
class CheckPointResult:
    ids: List[str]
    diffs: np.ndarray  # (n_found, 3) estimated - measured
    mean: np.ndarray  # (3,)
    rms: np.ndarray  # (3,)
    missing: List[str]  # check-point IDs not found among estimated ties


def check_point_diffs(
    problem: BAProblem, layout: ParamLayout, x: np.ndarray
) -> Optional[CheckPointResult]:
    """Estimated-minus-measured differences for .cze check points
    (main.m:604-628). Returns None when check points are not configured."""
    if problem.cze_ids is None:
        return None
    tie_index = {tid: t for t, tid in enumerate(problem.tie_ids)}
    ids, diffs, missing = [], [], []
    for i, cid in enumerate(problem.cze_ids):
        t = tie_index.get(cid)
        if t is None:
            missing.append(cid)
            continue
        est = x[layout.tie_slot(t) : layout.tie_slot(t) + 3]
        ids.append(cid)
        diffs.append(est - problem.cze_xyz[i])
    if not diffs:
        return CheckPointResult(ids, np.zeros((0, 3)), np.zeros(3), np.zeros(3), missing)
    diffs = np.asarray(diffs)
    return CheckPointResult(
        ids=ids,
        diffs=diffs,
        mean=diffs.mean(axis=0),
        rms=np.sqrt((diffs**2).mean(axis=0)),
        missing=missing,
    )


def count_image_points(problem: BAProblem) -> np.ndarray:
    """(n_img,) observations per image (main.m:981-988 countImagePoints)."""
    return np.bincount(problem.obs_img, minlength=problem.n_img)


def count_target_images(problem: BAProblem) -> np.ndarray:
    """(n_targets,) observations per target (main.m:989-996)."""
    return np.bincount(problem.obs_pt, minlength=problem.n_targets)
