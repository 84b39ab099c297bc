"""Problem assembly: ID joins -> dense integer index arrays.

Replaces the reference's per-observation linear string searches
(main.m:280-378, O(n*m) strcmp joins) with hash-map factorization into
static integer index arrays, the form every downstream kernel consumes
(gathers/segment-sums over ``obs_img / obs_cam / obs_pt``).

A numpy copy of fish_eye_bundle_adjustment_tpu/io/problem.py.  The dataset
readers (io/readers.py) and ``load_problem`` are not ported yet (ROADMAP
Queue 1); until they are, ``DatasetError`` lives here and problems come
from ``synth.make_block`` or from ``BAProblem.from_arrays``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from fish_eye_bundle_adjustment_tpu_torch.config import Settings


class DatasetError(ValueError):
    """Raised on missing/ambiguous/malformed dataset files."""


@dataclasses.dataclass
class BAProblem:
    """A fully-joined bundle-adjustment problem, ready for the solvers.

    All cross-references are integer indices:
      - observation i measures target ``obs_pt[i]`` on image ``obs_img[i]``
        taken by camera ``obs_cam[i]``;
      - images/cameras/targets are numbered in .ext/.int/.cnt file order
        (matching the reference's unknown layout, Buildxhat.m:22-135);
      - tie points: ``tie_target_idx[t]`` is the .cnt row of the t-th
        .tie entry; ``target_tie_slot[p]`` is the tie slot of target p or
        -1 for fixed control points.
    """

    settings: Settings

    # identity tables (report layer needs the names)
    image_ids: List[str]
    camera_ids: List[str]
    target_ids: List[str]
    tie_ids: List[str]

    # initial values
    eop0: np.ndarray  # (n_img, 6) Xc Yc Zc w p k (radians)
    iop0: np.ndarray  # (n_cam, 3 + nk + 2) xp yp c k1..kN p1 p2
    cnt_xyz: np.ndarray  # (n_targets, 3) object coordinates from .cnt

    # camera constants
    y_dir: np.ndarray  # (n_cam,)
    bounds: np.ndarray  # (n_cam, 4)
    rmax: np.ndarray  # (n_cam,)

    # observations
    obs_xy: np.ndarray  # (n_obs, 2)
    obs_img: np.ndarray  # (n_obs,) int32 -> image index
    obs_cam: np.ndarray  # (n_obs,) int32 -> camera index
    obs_pt: np.ndarray  # (n_obs,) int32 -> target index

    # tie bookkeeping
    tie_target_idx: np.ndarray  # (n_tie,) int32 target index per tie slot
    target_tie_slot: np.ndarray  # (n_targets,) int32 tie slot or -1

    # image -> camera map (each image taken by one camera; .ext column 2)
    img_cam: np.ndarray  # (n_img,) int32

    # optional check points
    cze_ids: Optional[List[str]] = None
    cze_xyz: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    @property
    def n_img(self) -> int:
        return len(self.image_ids)

    @property
    def n_cam(self) -> int:
        return len(self.camera_ids)

    @property
    def n_targets(self) -> int:
        return len(self.target_ids)

    @property
    def n_tie(self) -> int:
        return len(self.tie_ids)

    @property
    def n_obs(self) -> int:
        return self.obs_xy.shape[0]

    @property
    def n(self) -> int:
        """Scalar observation count (2 per image point — main.m:381)."""
        return 2 * self.n_obs

    @property
    def num_gcp(self) -> int:
        """Distinct targets actually observed (main.m:382)."""
        return int(np.unique(self.obs_pt).size)

    @property
    def nk(self) -> int:
        return self.iop0.shape[1] - 5

    @property
    def obs_is_tie(self) -> np.ndarray:
        return self.target_tie_slot[self.obs_pt] >= 0

    @classmethod
    def from_arrays(cls, fields: dict) -> "BAProblem":
        """A problem from plain fields: numpy arrays, lists of ids and the
        settings as a dict -- e.g. ``dataclasses.asdict`` of a JAX-package
        BAProblem, which carries the same state across the two packages."""
        kw = {}
        for f in dataclasses.fields(cls):
            v = fields.get(f.name)
            if f.name == "settings":
                v = v if isinstance(v, Settings) else Settings(**v)
            elif isinstance(v, np.ndarray):
                v = v.copy()
            elif v is not None:
                v = list(v) if isinstance(v, (list, tuple)) else np.array(v)
            kw[f.name] = v
        return cls(**kw)

    def obs_weights(self) -> np.ndarray:
        """(n_obs, 2) inverse-variance weights (P diagonal, main.m:396-405)."""
        sx = self.settings.meas_std
        sy = self.settings.meas_std_y if self.settings.meas_std_y is not None else sx
        w = np.empty((self.n_obs, 2), dtype=np.float64)
        w[:, 0] = 1.0 / sx**2
        w[:, 1] = 1.0 / sy**2
        return w


def _index_map(keys: List[str], kind: str, path) -> Dict[str, int]:
    m: Dict[str, int] = {}
    for i, k in enumerate(keys):
        if k in m:
            raise DatasetError(f"{path}: duplicate {kind} ID {k!r}")
        m[k] = i
    return m


def build_problem(
    pho,
    ext,
    cnt,
    int_,
    tie_ids: Optional[List[str]],
    settings: Settings,
    cze=None,
) -> BAProblem:
    """Join parsed files into a BAProblem (the reference's points-struct
    build, main.m:280-378, vectorized).  `pho`, `ext`, `cnt`, `int_` and
    `cze` are the parsed-file records of the JAX package's io/readers.py
    (PhoData, ExtData, CntData, IntData)."""
    img_map = _index_map(ext.image_ids, "image", ".ext")
    cam_map = _index_map(int_.camera_ids, "camera", ".int")
    tgt_map = _index_map(cnt.target_ids, "target", ".cnt")

    # Estimate_AllGCP: every observed target becomes a tie point, in
    # first-observation order of np.unique on the PHO column (main.m:261-264
    # uses MATLAB unique = sorted; we match sorted order).
    if settings.estimate_all_gcp:
        tie_ids = sorted(pho.uniq_targets)
    elif not settings.estimate_tie:
        tie_ids = []
    elif tie_ids is None:
        raise DatasetError("Estimate_tie=1 requires a .tie file (or Estimate_AllGCP=1)")

    # Factorized join: the .pho columns arrive as int32 codes into
    # first-appearance-ordered unique tables (native parse or PhoData
    # interning), so the per-observation remap is a gather through a
    # unique-sized lookup table.  Missing-ID errors fire in first-observation
    # order, matching the reference's per-row scan (main.m:294-298,352-356).
    def _lut(uniq, target_map, what, other):
        out = np.empty(len(uniq), dtype=np.int32)
        for j, u in enumerate(uniq):
            idx = target_map.get(u)
            if idx is None:
                raise DatasetError(f"{what} {u!r} from .pho not found in {other}")
            out[j] = idx
        return out

    obs_img = _lut(pho.uniq_images, img_map, "image", ".ext")[pho.img_codes]
    obs_pt = _lut(pho.uniq_targets, tgt_map, "target", ".cnt")[pho.tgt_codes]

    img_cam = np.empty(len(ext.image_ids), dtype=np.int32)
    for j, cam_id in enumerate(ext.camera_ids):
        if cam_id not in cam_map:
            raise DatasetError(f"camera {cam_id!r} from .ext not found in .int")  # main.m:317-321
        img_cam[j] = cam_map[cam_id]
    obs_cam = img_cam[obs_img]

    tie_target_idx = np.empty(len(tie_ids), dtype=np.int32)
    for t, tid in enumerate(tie_ids):
        if tid not in tgt_map:
            # Buildxhat.m:125-129
            raise DatasetError(f"tie point {tid!r} from .tie not found in .cnt")
        tie_target_idx[t] = tgt_map[tid]
    target_tie_slot = np.full(len(cnt.target_ids), -1, dtype=np.int32)
    target_tie_slot[tie_target_idx] = np.arange(len(tie_ids), dtype=np.int32)

    iop0 = np.concatenate([int_.xp_yp_c, int_.k, int_.p], axis=1)

    return BAProblem(
        settings=settings,
        image_ids=list(ext.image_ids),
        camera_ids=list(int_.camera_ids),
        target_ids=list(cnt.target_ids),
        tie_ids=list(tie_ids),
        eop0=ext.eops.copy(),
        iop0=iop0,
        cnt_xyz=cnt.xyz.copy(),
        y_dir=int_.y_dir.copy(),
        bounds=int_.bounds.copy(),
        rmax=int_.rmax,
        obs_xy=pho.xy.copy(),
        obs_img=obs_img,
        obs_cam=obs_cam,
        obs_pt=obs_pt,
        tie_target_idx=tie_target_idx,
        target_tie_slot=target_tie_slot,
        img_cam=img_cam,
        cze_ids=list(cze.target_ids) if cze is not None else None,
        cze_xyz=cze.xyz.copy() if cze is not None else None,
    )
