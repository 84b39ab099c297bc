"""Parsers for the bundle-adjustment text formats.

File contract (reference: main.m:51-58, functions/ReadFiles.m:4-52):

- ``.pho``  image measurements      ``pointID imageID x y``
- ``.ext``  exterior orientation    ``imageID cameraID Xc Yc Zc omega phi kappa``
  (angles in decimal degrees on disk, converted to radians here —
  main.m:215-217)
- ``.cnt``  object coordinates      ``targetID X Y Z``
- ``.int``  interior orientation, two rows per camera:
  ``cameraID y_axis_dir xmin ymin xmax ymax`` then
  ``xp yp c [k1..kN p1 p2]`` — missing distortion coefficients default to 0
  (main.m:229-256); ``y_axis_dir`` must be +-1 (main.m:332-337)
- ``.tie``  tie-point target IDs, one per row (main.m:179-188)
- ``.cze``  check points            ``targetID X Y Z`` (main.m:266-275)

All formats are whitespace-delimited (spaces/tabs, runs collapsed), allow
``#`` comments and blank lines (ReadFiles.m:49 readmatrix options).

Unlike the reference there are no GUI fallbacks: ambiguous or missing files
raise (the reference pops file dialogs, ReadFiles.m:25-44).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

DEG2RAD = math.pi / 180.0


class DatasetError(ValueError):
    """Raised on missing/ambiguous/malformed dataset files."""


def _tokenize(path) -> List[List[str]]:
    """Split a file into rows of whitespace-separated tokens.

    Strips ``#`` comments and blank lines, mirroring the reference's
    ``readmatrix(..., 'CommentStyle','#', 'ConsecutiveDelimitersRule','join')``.
    """
    rows = []
    for raw in Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        rows.append(line.split())
    return rows


@dataclasses.dataclass
class PhoData:
    """Image measurements, stored factorized: string IDs are interned into
    first-appearance-ordered unique tables with int32 code columns — the
    form the problem-assembly join consumes directly (and the form the
    native C++ parser emits, io/native.py)."""

    uniq_targets: List[str]
    uniq_images: List[str]
    tgt_codes: np.ndarray  # (n_obs,) int32 -> uniq_targets
    img_codes: np.ndarray  # (n_obs,) int32 -> uniq_images
    xy: np.ndarray  # (n_obs, 2) float64

    @classmethod
    def from_rows(cls, target_ids: List[str], image_ids: List[str],
                  xy: np.ndarray) -> "PhoData":
        ut, tc = _intern(target_ids)
        ui, ic = _intern(image_ids)
        return cls(ut, ui, tc, ic, np.asarray(xy, dtype=np.float64))

    # per-observation expanded views (report/debug convenience)
    @property
    def target_ids(self) -> List[str]:
        return [self.uniq_targets[i] for i in self.tgt_codes]

    @property
    def image_ids(self) -> List[str]:
        return [self.uniq_images[i] for i in self.img_codes]

    @property
    def n_obs(self) -> int:
        return int(self.xy.shape[0])


def _intern(ids: List[str]):
    """First-appearance-order factorization of a string column."""
    uniq: List[str] = []
    m: Dict[str, int] = {}
    codes = np.empty(len(ids), dtype=np.int32)
    for i, s in enumerate(ids):
        j = m.get(s)
        if j is None:
            j = m[s] = len(uniq)
            uniq.append(s)
        codes[i] = j
    return uniq, codes


@dataclasses.dataclass
class ExtData:
    image_ids: List[str]
    camera_ids: List[str]
    eops: np.ndarray  # (n_img, 6) float64: Xc Yc Zc omega phi kappa (radians)


@dataclasses.dataclass
class CntData:
    target_ids: List[str]
    xyz: np.ndarray  # (n_pts, 3) float64


@dataclasses.dataclass
class IntData:
    """One entry per camera, in file order."""

    camera_ids: List[str]
    y_dir: np.ndarray  # (n_cam,) float64, +-1
    bounds: np.ndarray  # (n_cam, 4): xmin ymin xmax ymax
    xp_yp_c: np.ndarray  # (n_cam, 3)
    k: np.ndarray  # (n_cam, num_radial) radial coefficients
    p: np.ndarray  # (n_cam, 2) decentering coefficients

    @property
    def rmax(self) -> np.ndarray:
        """Sensor half-diagonal per camera — the distortion conditioning scale
        (BuildAwG.m:422-425)."""
        half_w = (self.bounds[:, 2] - self.bounds[:, 0]) * 0.5
        half_h = (self.bounds[:, 3] - self.bounds[:, 1]) * 0.5
        return np.sqrt(half_w**2 + half_h**2)


def read_pho(path) -> PhoData:
    pho = _read_pho_native(path)
    if pho is None:
        pho = _read_pho_python(path)
    if pho.n_obs == 0:
        raise DatasetError(f"{path}: empty .pho file")
    return pho


def _read_pho_native(path) -> Optional[PhoData]:
    """Native C++ parse (io/native.py); None -> fall back to Python."""
    try:
        from fish_eye_bundle_adjustment_tpu_torch.io import native
    except ImportError:
        return None
    if not native.available():
        return None
    try:
        ut, ui, tc, ic, xy = native.parse_pho(path)
    except native.NativeError as e:
        raise DatasetError(str(e)) from None
    return PhoData(ut, ui, tc, ic, xy)


def _read_pho_python(path) -> PhoData:
    tgt, img, xs, ys = [], [], [], []
    for r in _tokenize(path):
        if len(r) < 4:
            raise DatasetError(f"{path}: .pho row needs 4 columns, got {r}")
        tgt.append(r[0])
        img.append(r[1])
        try:
            xs.append(float(r[2]))
            ys.append(float(r[3]))
        except ValueError:
            raise DatasetError(
                f"{path}: .pho row has non-numeric coordinate: {r}"
            ) from None
    return PhoData.from_rows(
        tgt, img, np.column_stack([xs, ys]) if tgt else np.empty((0, 2))
    )


def read_ext(path) -> ExtData:
    rows = _tokenize(path)
    img, cam, eops = [], [], []
    for r in rows:
        if len(r) < 8:
            raise DatasetError(f"{path}: .ext row needs 8 columns, got {r}")
        img.append(r[0])
        cam.append(r[1])
        vals = [float(v) for v in r[2:8]]
        # angles on disk are decimal degrees (main.m:215-217)
        vals[3] *= DEG2RAD
        vals[4] *= DEG2RAD
        vals[5] *= DEG2RAD
        eops.append(vals)
    if len(set(img)) != len(img):
        raise DatasetError(f"{path}: duplicate image IDs in .ext")
    return ExtData(img, cam, np.asarray(eops, dtype=np.float64))


def read_cnt(path) -> CntData:
    native_res = _read_idtable_native(path, 3)
    if native_res is not None:
        uniq, codes, vals = native_res
        # .cnt IDs are expanded (duplicates preserved; duplicate detection
        # happens in the join, matching the Python path)
        ids = [uniq[i] for i in codes]
        return CntData(ids, vals)
    ids, xyz = [], []
    for r in _tokenize(path):
        if len(r) < 4:
            raise DatasetError(f"{path}: .cnt row needs 4 columns, got {r}")
        ids.append(r[0])
        try:
            xyz.append([float(v) for v in r[1:4]])
        except ValueError:
            raise DatasetError(
                f"{path}: .cnt row has non-numeric value: {r}"
            ) from None
    return CntData(ids, np.asarray(xyz, dtype=np.float64).reshape(len(ids), 3))


def _read_idtable_native(path, n_num: int):
    try:
        from fish_eye_bundle_adjustment_tpu_torch.io import native
    except ImportError:
        return None
    if not native.available():
        return None
    try:
        return native.parse_idtable(path, n_num)
    except native.NativeError as e:
        raise DatasetError(str(e)) from None


def read_int(path, num_radial: int) -> IntData:
    """Two-row-per-camera parse; absent distortion coefficients are zero
    (main.m:243-254). `num_radial` fixes how many radial terms are read —
    extra on-disk coefficients beyond num_radial+2 are ignored, matching the
    reference's slice at main.m:329-330."""
    rows = _tokenize(path)
    if len(rows) % 2 != 0:
        raise DatasetError(f"{path}: .int needs 2 rows per camera, got {len(rows)} rows")
    cams, ydirs, bounds, iops, ks, ps = [], [], [], [], [], []
    for i in range(0, len(rows), 2):
        hdr, body = rows[i], rows[i + 1]
        if len(hdr) < 6:
            raise DatasetError(f"{path}: .int header row needs 6 columns, got {hdr}")
        if len(body) < 3:
            raise DatasetError(f"{path}: .int data row needs >=3 columns, got {body}")
        cams.append(hdr[0])
        y_dir = float(hdr[1])
        if y_dir not in (1.0, -1.0):
            raise DatasetError(f"{path}: y_axis_dir must be +-1, got {y_dir}")  # main.m:334
        ydirs.append(y_dir)
        bounds.append([float(v) for v in hdr[2:6]])
        iops.append([float(v) for v in body[0:3]])
        dist = [float(v) for v in body[3:]]
        # pad with zeros up to num_radial + 2 decentering
        dist = dist + [0.0] * max(0, num_radial + 2 - len(dist))
        ks.append(dist[:num_radial])
        ps.append(dist[num_radial : num_radial + 2])
    return IntData(
        cams,
        np.asarray(ydirs, dtype=np.float64),
        np.asarray(bounds, dtype=np.float64),
        np.asarray(iops, dtype=np.float64),
        np.asarray(ks, dtype=np.float64),
        np.asarray(ps, dtype=np.float64),
    )


def read_tie(path) -> List[str]:
    return [r[0] for r in _tokenize(path)]


def read_cze(path) -> CntData:
    """Check points share the .cnt format (main.m:266-275)."""
    return read_cnt(path)


def discover_dataset(folder, extensions=(".pho", ".ext", ".cnt", ".int")) -> Dict[str, Path]:
    """Find exactly one file per extension in `folder` (ReadFiles.m:14-44
    behavior, minus the GUI dialogs — 0 or >1 matches is an error)."""
    folder = Path(folder)
    found: Dict[str, Path] = {}
    for ext in extensions:
        matches = sorted(folder.glob(f"*{ext}"))
        if len(matches) == 0:
            raise DatasetError(f"no {ext} file in {folder}")
        if len(matches) > 1:
            raise DatasetError(f"multiple {ext} files in {folder}: {[m.name for m in matches]}")
        found[ext] = matches[0]
    return found


def find_optional(folder, ext) -> Optional[Path]:
    matches = sorted(Path(folder).glob(f"*{ext}"))
    if len(matches) > 1:
        raise DatasetError(f"multiple {ext} files in {folder}")
    return matches[0] if matches else None
