"""The benchmark's block generator and the draws of initial approximations.

A frozen numpy copy of the port's ``synth.make_block`` (an aerial survey
block: cameras on a jittered grid at 1,000 m looking nadir, ground points
uniform in a box, visibility by footprint and an exact in-sensor test,
Gaussian image noise, a share of the targets held fixed as control), kept
here so that no change to the program moves the data it is measured on.
For the same arguments it draws the same random numbers in the same order
as the port's generator, so a configuration's ``block_seed`` gives
BASELINE's blocks.

It returns plain numpy arrays (``Block``), which both the system under
test (port.py) and the plain reference (refba.py) read; neither side makes
anything the other reads.  ``initial`` draws one adjustment's initial
approximations from a run's seed and the adjustment's index.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# the port's DEFAULT_SETTINGS: the block's own adjustment settings, before
# a configuration's overrides
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
class Block:
    """One block's raw data.  Targets are numbered 0..n_targets-1; tie
    slot t is target ``tie_target_idx[t]``; the others are control."""

    settings: dict  # adjustment settings (the port's Settings fields)
    model: str
    obs_xy: np.ndarray  # (n_obs, 2) measured image coordinates, px
    obs_img: np.ndarray  # (n_obs,) int32
    obs_pt: np.ndarray  # (n_obs,) int32 target index
    img_cam: np.ndarray  # (n_img,) int32 camera of each image
    focals: np.ndarray  # (n_cams,)
    half_wh: tuple  # sensor half width and height, px
    true_eop: np.ndarray  # (n_img, 6) Xc Yc Zc omega phi kappa
    true_points: np.ndarray  # (n_targets, 3)
    tie_target_idx: np.ndarray  # (n_tie,) int32
    target_tie_slot: np.ndarray  # (n_targets,) int32, -1 for control

    @property
    def n_img(self) -> int:
        return self.true_eop.shape[0]

    @property
    def n_obs(self) -> int:
        return self.obs_xy.shape[0]

    @property
    def n_targets(self) -> int:
        return self.true_points.shape[0]

    @property
    def n_tie(self) -> int:
        return self.tie_target_idx.shape[0]

    @property
    def n_cams(self) -> int:
        return self.focals.shape[0]

    @property
    def nk(self) -> int:
        return int(self.settings["num_radial_distortions"])

    @property
    def rmax(self) -> np.ndarray:
        return np.full(self.n_cams, math.hypot(*self.half_wh))

    @property
    def iop0(self) -> np.ndarray:
        """(n_cams, 5 + nk) xp yp c k1..kN p1 p2: the focal lengths, no
        distortion (the generator's own, and the initial values)."""
        iop = np.zeros((self.n_cams, 5 + self.nk))
        iop[:, 2] = self.focals
        return iop


def make_block(n_img=100, n_pts=2000, n_cams=1, model="fisheye", noise_px=0.3,
               control_frac=0.02, seed=0, settings_overrides=None,
               target_track_len=6.0) -> Block:
    """The port's synth.make_block, up to its random draws of initial
    values (``initial`` draws those): same geometry, noise, control split
    and settings for the same arguments."""
    rng = np.random.default_rng(seed)

    altitude = 1000.0
    c_focal = 1200.0
    focals = c_focal * (1.0 + 0.05 * np.arange(n_cams))
    img_cam = (np.arange(n_img) % n_cams).astype(np.int32)
    half_w, half_h = 1224.0, 1024.0  # 2448 x 2048 sensor
    foot_x = half_w / c_focal * altitude
    foot_y = half_h / c_focal * altitude

    grid_cols = max(1, int(math.ceil(math.sqrt(n_img))))
    grid_rows = max(1, int(math.ceil(n_img / grid_cols)))
    overlap = max(1.0, target_track_len)
    dx = 2 * foot_x / math.sqrt(overlap)
    dy = 2 * foot_y / math.sqrt(overlap)

    ix, iy = np.meshgrid(np.arange(grid_cols), np.arange(grid_rows))
    ix = ix.reshape(-1)[:n_img]
    iy = iy.reshape(-1)[:n_img]
    cam_xy = np.column_stack([ix * dx, iy * dy]).astype(np.float64)
    cam_xy += rng.normal(scale=0.05 * dx, size=cam_xy.shape)
    cam_z = altitude + rng.normal(scale=0.01 * altitude, size=n_img)

    omega = math.pi + rng.normal(scale=0.02, size=n_img)
    phi = rng.normal(scale=0.02, size=n_img)
    kappa = rng.uniform(-math.pi, math.pi, size=n_img)
    true_eop = np.column_stack([cam_xy[:, 0], cam_xy[:, 1], cam_z, omega, phi, kappa])

    margin = 0.6 * max(foot_x, foot_y)
    lo = cam_xy.min(axis=0) - margin
    hi = cam_xy.max(axis=0) + margin
    pts_xy = rng.uniform(lo, hi, size=(n_pts, 2))
    pts_z = rng.uniform(0.0, 60.0, size=(n_pts, 1))
    true_points = np.concatenate([pts_xy, pts_z], axis=1)

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

    xy, valid = _project_np(
        true_eop[obs_img], true_points[obs_pt], focals[img_cam[obs_img]], model
    )
    inside = (
        valid
        & (np.abs(xy[:, 0]) <= half_w * 0.98)
        & (np.abs(xy[:, 1]) <= half_h * 0.98)
    )
    obs_img, obs_pt, xy = obs_img[inside], obs_pt[inside], xy[inside]

    counts = np.bincount(obs_pt, minlength=n_pts)
    keep_pt = counts >= 2
    remap = -np.ones(n_pts, dtype=np.int64)
    remap[keep_pt] = np.arange(keep_pt.sum())
    sel = keep_pt[obs_pt]
    obs_img, obs_pt, xy = obs_img[sel], remap[obs_pt[sel]], xy[sel]
    true_points = true_points[keep_pt]
    n_pts = true_points.shape[0]

    xy = xy + rng.normal(scale=noise_px, size=xy.shape)

    n_control = max(0, int(round(control_frac * n_pts)))
    sset = dict(DEFAULT_SETTINGS)
    sset.update(settings_overrides or {})
    if n_control == 0 and not sset.get("inner_constraints", False):
        sset["inner_constraints"] = True
    control_idx = (rng.choice(n_pts, size=n_control, replace=False) if n_control
                   else np.zeros(0, np.int64))
    is_control = np.zeros(n_pts, dtype=bool)
    is_control[control_idx] = True
    tie_target_idx = np.nonzero(~is_control)[0].astype(np.int32)
    target_tie_slot = np.full(n_pts, -1, dtype=np.int32)
    target_tie_slot[tie_target_idx] = np.arange(tie_target_idx.size, dtype=np.int32)
    sset["meas_std"] = noise_px if noise_px > 0 else 1.0
    sset["model"] = model

    return Block(
        settings=sset, model=model, obs_xy=xy, obs_img=obs_img.astype(np.int32),
        obs_pt=obs_pt.astype(np.int32), img_cam=img_cam, focals=focals,
        half_wh=(half_w, half_h), true_eop=true_eop, true_points=true_points,
        tie_target_idx=tie_target_idx, target_tie_slot=target_tie_slot,
    )


def _project_np(eop, xyz, c_focal, model: str):
    """Projection without distortion, for the visibility test."""
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


def from_config(cfg: dict) -> Block:
    """A configuration file's block."""
    return make_block(
        n_img=cfg["n_img"], n_pts=cfg["n_pts"], n_cams=cfg["n_cams"], model=cfg["model"],
        noise_px=cfg["noise_px"], control_frac=cfg["control_frac"], seed=cfg["block_seed"],
        settings_overrides=cfg["settings"], target_track_len=cfg["target_track_len"],
    )


@dataclasses.dataclass
class Initial:
    """One adjustment's initial approximations: every image's EOPs, every
    target's coordinates (control targets at their true, fixed values)
    and the cameras' IOPs."""

    eop: np.ndarray  # (n_img, 6)
    points: np.ndarray  # (n_targets, 3)
    iop: np.ndarray  # (n_cams, 5 + nk)


def initial(block: Block, seed: int, index: int, sigmas: dict) -> Initial:
    """Adjustment `index`'s initial approximations for a run of `seed`:
    the block's true values moved by Gaussian draws at `sigmas` (pose_m,
    angle_rad, point_m), as make_block perturbs its own.  The same seed and
    index give the same values."""
    # the whole seed goes into the key, in 64-bit words (any whole number)
    seed = int(seed)
    rng = np.random.default_rng([seed % 2**64, (seed // 2**64) % 2**64, int(index)])
    eop = block.true_eop.copy()
    eop[:, :3] += rng.normal(scale=sigmas["pose_m"], size=(block.n_img, 3))
    eop[:, 3:] += rng.normal(scale=sigmas["angle_rad"], size=(block.n_img, 3))
    pts = block.true_points.copy()
    tie = block.tie_target_idx
    pts[tie] += rng.normal(scale=sigmas["point_m"], size=(tie.size, 3))
    return Initial(eop=eop, points=pts, iop=block.iop0)
