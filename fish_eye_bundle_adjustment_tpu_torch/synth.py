"""Synthetic bundle-adjustment block generator.

The reference ships one 42-image dataset; the BASELINE targets require 1k-
and 10k-image synthetic blocks (1k img / 100k tie points single-chip;
10k-image multi-host).  This generates aerial-survey-style blocks:

- cameras on a jittered grid at altitude, looking nadir (omega ~ pi so the
  camera-frame depth W is positive for ground points, matching the
  reference's projection sign conventions);
- ground points uniform in a box; visibility by footprint radius
  (scipy cKDTree) then exact in-sensor check via the real projection model;
- Gaussian measurement noise; optional pose/point initialization
  perturbation so Gauss-Newton has real work;
- a configurable fraction of targets held fixed as control points (datum)
  or none (use inner constraints).

Returns a BAProblem plus the ground truth for error metrics, and can write
the block back out as .pho/.ext/.cnt/.int/.tie/.cfg files (round-trips
through the io layer).

A numpy copy of fish_eye_bundle_adjustment_tpu/synth.py, so that blocks
can be made where JAX is not installed; tests/test_torch_host.py holds
the two generators to identical problems for the same seed.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Optional

import numpy as np

from fish_eye_bundle_adjustment_tpu_torch.config import Settings
from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem

DEFAULT_SETTINGS = dict(
    iteration_cap=20,
    threshold=1e-6,
    inner_constraints=False,
    estimate_xc=True,
    estimate_yc=True,
    estimate_zc=True,
    estimate_w=True,
    estimate_p=True,
    estimate_k=True,
    estimate_c=False,
    estimate_xp=False,
    estimate_yp=False,
    estimate_radial=False,
    num_radial_distortions=1,
    estimate_decent=False,
    estimate_tie=True,
    estimate_all_gcp=False,
)


@dataclasses.dataclass
class SynthBlock:
    problem: BAProblem
    true_eop: np.ndarray  # (n_img, 6)
    true_points: np.ndarray  # (n_targets, 3)


def make_block(
    n_img: int = 100,
    n_pts: int = 2000,
    n_cams: int = 1,
    model: str = "fisheye",
    noise_px: float = 0.3,
    control_frac: float = 0.02,
    init_pose_sigma: float = 0.5,
    init_angle_sigma: float = 0.002,
    init_point_sigma: float = 1.0,
    seed: int = 0,
    settings_overrides: Optional[dict] = None,
    target_track_len: float = 6.0,
) -> SynthBlock:
    """Generate a synthetic aerial block.

    `target_track_len` tunes the camera footprint so each point is seen by
    roughly that many images.
    """
    rng = np.random.default_rng(seed)

    # --- camera rig: n_cams cameras round-robin across images, slightly
    # different focal lengths (exercises per-camera IOP blocks + rmax)
    altitude = 1000.0
    c_focal = 1200.0
    focals = c_focal * (1.0 + 0.05 * np.arange(n_cams))
    img_cam = (np.arange(n_img) % n_cams).astype(np.int32)
    half_w, half_h = 1224.0, 1024.0  # 2448 x 2048 sensor
    # nadir pinhole footprint half-extent on the ground
    foot_x = half_w / c_focal * altitude
    foot_y = half_h / c_focal * altitude

    grid_cols = max(1, int(math.ceil(math.sqrt(n_img))))
    grid_rows = max(1, int(math.ceil(n_img / grid_cols)))
    # spacing for the requested overlap (track length)
    overlap = max(1.0, target_track_len)
    dx = 2 * foot_x / math.sqrt(overlap)
    dy = 2 * foot_y / math.sqrt(overlap)

    ix, iy = np.meshgrid(np.arange(grid_cols), np.arange(grid_rows))
    ix = ix.reshape(-1)[:n_img]
    iy = iy.reshape(-1)[:n_img]
    cam_xy = np.column_stack([ix * dx, iy * dy]).astype(np.float64)
    cam_xy += rng.normal(scale=0.05 * dx, size=cam_xy.shape)
    cam_z = altitude + rng.normal(scale=0.01 * altitude, size=n_img)

    # nadir attitude: omega ~ pi flips Z so W = depth > 0 for ground points
    omega = math.pi + rng.normal(scale=0.02, size=n_img)
    phi = rng.normal(scale=0.02, size=n_img)
    kappa = rng.uniform(-math.pi, math.pi, size=n_img)
    true_eop = np.column_stack([cam_xy[:, 0], cam_xy[:, 1], cam_z, omega, phi, kappa])

    # --- ground points -------------------------------------------------
    margin = 0.6 * max(foot_x, foot_y)
    lo = cam_xy.min(axis=0) - margin
    hi = cam_xy.max(axis=0) + margin
    pts_xy = rng.uniform(lo, hi, size=(n_pts, 2))
    pts_z = rng.uniform(0.0, 60.0, size=(n_pts, 1))
    true_points = np.concatenate([pts_xy, pts_z], axis=1)

    # --- visibility: KD-tree candidates, exact projection filter -------
    from scipy.spatial import cKDTree

    tree = cKDTree(true_points[:, :2])
    radius = math.hypot(foot_x, foot_y) * 1.2
    cand_lists = tree.query_ball_point(cam_xy, r=radius)

    obs_img_l, obs_pt_l = [], []
    for i, cand in enumerate(cand_lists):
        if not cand:
            continue
        obs_img_l.append(np.full(len(cand), i, dtype=np.int64))
        obs_pt_l.append(np.asarray(cand, dtype=np.int64))
    obs_img = np.concatenate(obs_img_l) if obs_img_l else np.zeros(0, np.int64)
    obs_pt = np.concatenate(obs_pt_l) if obs_pt_l else np.zeros(0, np.int64)

    # exact projection of candidates (vectorized numpy mirror of
    # models/projection.py — float64, zero distortion)
    xy, valid = _project_np(
        true_eop[obs_img], true_points[obs_pt], focals[img_cam[obs_img]], model
    )
    inside = (
        valid
        & (np.abs(xy[:, 0]) <= half_w * 0.98)
        & (np.abs(xy[:, 1]) <= half_h * 0.98)
    )
    obs_img, obs_pt, xy = obs_img[inside], obs_pt[inside], xy[inside]

    # drop under-observed points (need >= 2 rays to triangulate)
    counts = np.bincount(obs_pt, minlength=n_pts)
    keep_pt = counts >= 2
    remap = -np.ones(n_pts, dtype=np.int64)
    remap[keep_pt] = np.arange(keep_pt.sum())
    sel = keep_pt[obs_pt]
    obs_img, obs_pt, xy = obs_img[sel], remap[obs_pt[sel]], xy[sel]
    true_points = true_points[keep_pt]
    n_pts = true_points.shape[0]

    xy = xy + rng.normal(scale=noise_px, size=xy.shape)

    # --- control vs tie split ------------------------------------------
    n_control = max(0, int(round(control_frac * n_pts)))
    sset = dict(DEFAULT_SETTINGS)
    sset.update(settings_overrides or {})
    if n_control == 0 and not sset.get("inner_constraints", False):
        sset["inner_constraints"] = True
    control_idx = rng.choice(n_pts, size=n_control, replace=False) if n_control else np.zeros(0, np.int64)
    is_control = np.zeros(n_pts, dtype=bool)
    is_control[control_idx] = True
    tie_target_idx = np.nonzero(~is_control)[0].astype(np.int32)
    target_tie_slot = np.full(n_pts, -1, dtype=np.int32)
    target_tie_slot[tie_target_idx] = np.arange(tie_target_idx.size, dtype=np.int32)

    settings = Settings(meas_std=noise_px if noise_px > 0 else 1.0, model=model, **sset)

    # --- perturbed initialization --------------------------------------
    eop0 = true_eop.copy()
    eop0[:, :3] += rng.normal(scale=init_pose_sigma, size=(n_img, 3))
    eop0[:, 3:] += rng.normal(scale=init_angle_sigma, size=(n_img, 3))
    cnt0 = true_points.copy()
    cnt0[~is_control] += rng.normal(scale=init_point_sigma, size=(int((~is_control).sum()), 3))

    nk = settings.num_radial_distortions
    iop0 = np.zeros((n_cams, 5 + nk))
    iop0[:, 2] = focals

    image_ids = [f"I{i:05d}" for i in range(n_img)]
    target_ids = [f"P{i:06d}" for i in range(n_pts)]
    problem = BAProblem(
        settings=settings,
        image_ids=image_ids,
        camera_ids=[str(c) for c in range(n_cams)],
        target_ids=target_ids,
        tie_ids=[target_ids[i] for i in tie_target_idx],
        eop0=eop0,
        iop0=iop0,
        cnt_xyz=cnt0,
        y_dir=np.ones(n_cams),
        bounds=np.tile([-half_w, -half_h, half_w, half_h], (n_cams, 1)),
        rmax=np.full(n_cams, math.hypot(half_w, half_h)),
        obs_xy=xy,
        obs_img=obs_img.astype(np.int32),
        obs_cam=img_cam[obs_img],
        obs_pt=obs_pt.astype(np.int32),
        tie_target_idx=tie_target_idx,
        target_tie_slot=target_tie_slot,
        img_cam=img_cam,
    )
    return SynthBlock(problem=problem, true_eop=true_eop, true_points=true_points)


def _project_np(eop, xyz, c_focal, model: str):
    """Vectorized numpy projection (no distortion) for visibility testing;
    mirrors models/projection.py conventions."""
    w, p, k = eop[:, 3], eop[:, 4], eop[:, 5]
    cw, sw, cp, sp, ck, sk = np.cos(w), np.sin(w), np.cos(p), np.sin(p), np.cos(k), np.sin(k)
    d = xyz - eop[:, :3]
    U = d[:, 0] * (ck * cp) + d[:, 1] * (cw * sk + ck * sp * sw) + d[:, 2] * (sk * sw - ck * cw * sp)
    V = d[:, 0] * (-cp * sk) + d[:, 1] * (ck * cw - sk * sp * sw) + d[:, 2] * (ck * sw + cw * sk * sp)
    W = d[:, 0] * sp + d[:, 1] * (-cp * sw) + d[:, 2] * (cp * cw)
    R = np.hypot(U, V)
    valid = W > 1e-6
    Ws = np.where(valid, W, 1.0)
    Rs = np.where(R < 1e-12, 1e-12, R)
    theta = np.arctan(Rs / Ws)
    if model == "fisheye":
        g = theta / Rs
    elif model == "pinhole":
        g = 1.0 / Ws
    elif model == "equisolid":
        g = 2.0 * np.sin(0.5 * theta) / Rs
    elif model == "orthographic":
        g = np.sin(theta) / Rs
    elif model == "stereographic":
        g = 2.0 * np.tan(0.5 * theta) / Rs
    else:
        raise ValueError(model)
    fx = -c_focal * U * g
    fy = -c_focal * V * g
    return np.column_stack([fx, fy]), valid


def write_block(block: SynthBlock, out_dir, cfg: bool = True):
    """Write a synthetic block as reference-format dataset files."""
    p = block.problem
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = "synth"
    with open(out / f"{name}.pho", "w") as f:
        for i in range(p.n_obs):
            f.write(
                f"{p.target_ids[p.obs_pt[i]]}\t{p.image_ids[p.obs_img[i]]}\t"
                f"{p.obs_xy[i,0]:.6f}\t{p.obs_xy[i,1]:.6f}\n"
            )
    with open(out / f"{name}.ext", "w") as f:
        r2d = 180.0 / math.pi
        for i in range(p.n_img):
            e = p.eop0[i]
            f.write(
                f"{p.image_ids[i]}\t{p.camera_ids[p.img_cam[i]]}\t"
                f"{e[0]:.10f}\t{e[1]:.10f}\t{e[2]:.10f}\t"
                f"{e[3]*r2d:.12f}\t{e[4]*r2d:.12f}\t{e[5]*r2d:.12f}\n"
            )
    with open(out / f"{name}.cnt", "w") as f:
        for i in range(p.n_targets):
            c = p.cnt_xyz[i]
            f.write(f"{p.target_ids[i]}\t{c[0]:.10f}\t{c[1]:.10f}\t{c[2]:.10f}\n")
    with open(out / f"{name}.int", "w") as f:
        for ci in range(p.n_cam):
            b = p.bounds[ci]
            f.write(
                f"{p.camera_ids[ci]}\t{p.y_dir[ci]:g}\t{b[0]:g}\t{b[1]:g}\t{b[2]:g}\t{b[3]:g}\n"
            )
            f.write("\t".join(f"{v:.10g}" for v in p.iop0[ci]) + "\n")
    with open(out / f"{name}.tie", "w") as f:
        for tid in p.tie_ids:
            f.write(tid + "\n")
    if cfg:
        s = p.settings
        with open(out / "config.cfg", "w") as f:
            f.write(
                f"Iteration_Cap\t{s.iteration_cap}\n"
                f"Threshold_Value\t{s.threshold}\n"
                f"Meas_std\t{s.meas_std}\n"
                f"Inner_Constraints\t{int(s.inner_constraints)}\n"
                f"Estimate_Xc\t{int(s.estimate_xc)}\nEstimate_Yc\t{int(s.estimate_yc)}\n"
                f"Estimate_Zc\t{int(s.estimate_zc)}\nEstimate_Omega\t{int(s.estimate_w)}\n"
                f"Estimate_Phi\t{int(s.estimate_p)}\nEstimate_Kappa\t{int(s.estimate_k)}\n"
                f"Estimate_xp\t{int(s.estimate_xp)}\nEstimate_yp\t{int(s.estimate_yp)}\n"
                f"Estimate_c\t{int(s.estimate_c)}\n"
                f"Estimate_Radial_Distortions\t{int(s.estimate_radial)}\n"
                f"Num_Radial_Distortions\t{s.num_radial_distortions}\n"
                f"Estimate_Decentering_Distortions\t{int(s.estimate_decent)}\n"
                f"Estimate_tie\t{int(s.estimate_tie)}\n"
                f"Estimate_AllGCP\t{int(s.estimate_all_gcp)}\n"
                f"Type\t'{s.model}'\n"
            )
