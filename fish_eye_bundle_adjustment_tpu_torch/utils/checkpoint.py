"""Checkpoint / resume for long-running adjustments.

The reference has no checkpointing (runs are seconds-long, SURVEY.md §5.4);
at the scales this framework targets (10k+ images, multi-host) solver state
must survive preemption.  State is the unknown vector + iteration metadata;
storage is a plain .npz (no external dependencies, atomic via rename).

A numpy copy of fish_eye_bundle_adjustment_tpu/utils/checkpoint.py, so a
checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from pathlib import Path
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SolverCheckpoint:
    x: np.ndarray  # current unknown vector (unscaled)
    iteration: int
    delta_history: List[float]
    meta: dict  # problem fingerprint for safety


def problem_fingerprint(problem) -> dict:
    return {
        "n_img": problem.n_img,
        "n_cam": problem.n_cam,
        "n_tie": problem.n_tie,
        "n_obs": problem.n_obs,
        "model": problem.settings.model,
    }


def save_checkpoint(path, ckpt: SolverCheckpoint) -> None:
    """Atomic write (tmp file + rename) so a preempted writer never leaves
    a truncated checkpoint."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                x=ckpt.x,
                iteration=np.int64(ckpt.iteration),
                delta_history=np.asarray(ckpt.delta_history, dtype=np.float64),
                meta_keys=np.array(sorted(ckpt.meta.keys())),
                meta_vals=np.array(
                    [str(ckpt.meta[k]) for k in sorted(ckpt.meta.keys())]
                ),
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path, problem=None) -> Optional[SolverCheckpoint]:
    """Load a checkpoint; validates the problem fingerprint when given.
    Returns None if the file does not exist."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = dict(zip(z["meta_keys"].tolist(), z["meta_vals"].tolist()))
        ckpt = SolverCheckpoint(
            x=z["x"],
            iteration=int(z["iteration"]),
            delta_history=z["delta_history"].tolist(),
            meta=meta,
        )
    if problem is not None:
        fp = {k: str(v) for k, v in problem_fingerprint(problem).items()}
        if fp != ckpt.meta:
            raise ValueError(
                f"checkpoint {path} was written for a different problem: "
                f"{ckpt.meta} != {fp}"
            )
    return ckpt
