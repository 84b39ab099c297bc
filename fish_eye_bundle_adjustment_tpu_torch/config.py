"""Config schema + `.cfg` parser.

Mirrors the reference's flat key/value config contract
(reference config.cfg:1-43, functions/findSetting.m:7-55,
main.m:113-177): `#` comments, order-free keys, `'quoted'` strings vs
numerics, required-vs-defaulted keys, 0/1 validation for boolean toggles.
Unlike the reference (which pops modal error dialogs), parsing fails fast
with a ConfigError listing every problem at once (the reference's
error-tally pattern, surfaced as an exception).

A copy of fish_eye_bundle_adjustment_tpu/config.py (pure Python), so the
port parses settings without importing JAX.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional

VALID_MODELS = ("fisheye", "pinhole", "equisolid", "orthographic", "stereographic")


class ConfigError(ValueError):
    """Raised when a .cfg file is missing required keys or has invalid values."""


@dataclasses.dataclass(frozen=True)
class Settings:
    """Adjustment settings (the reference's `data.settings` struct).

    Field names follow the reference main.m:116-171; defaults follow
    main.m:113-145 (Output_Filename/Meas_std/Type/Check_Points are optional,
    everything else is required).
    """

    # required (main.m:147-171)
    iteration_cap: int
    threshold: float
    inner_constraints: bool
    estimate_xc: bool
    estimate_yc: bool
    estimate_zc: bool
    estimate_w: bool
    estimate_p: bool
    estimate_k: bool
    estimate_c: bool
    estimate_xp: bool
    estimate_yp: bool
    estimate_radial: bool
    num_radial_distortions: int
    estimate_decent: bool
    estimate_tie: bool
    estimate_all_gcp: bool
    # optional with defaults (main.m:113-145)
    output_filename: Optional[str] = None
    meas_std: float = 1.0
    meas_std_y: Optional[float] = None  # separate y sigma; None => use meas_std
    model: str = "fisheye"
    check_points: bool = False

    def __post_init__(self):
        if self.model not in VALID_MODELS:
            raise ConfigError(
                f"invalid Type {self.model!r}; valid: {', '.join(VALID_MODELS)}"
            )
        # BuildAwG.m:18-20 clamps Num_Radial_Distortions to >= 1
        if self.num_radial_distortions < 1:
            object.__setattr__(self, "num_radial_distortions", 1)

    @property
    def eop_toggles(self):
        """(Xc, Yc, Zc, omega, phi, kappa) estimation toggles, canonical order."""
        return (
            self.estimate_xc,
            self.estimate_yc,
            self.estimate_zc,
            self.estimate_w,
            self.estimate_p,
            self.estimate_k,
        )

    @property
    def u_per_image(self) -> int:
        return sum(self.eop_toggles)

    @property
    def u_per_camera(self) -> int:
        return (
            int(self.estimate_xp)
            + int(self.estimate_yp)
            + int(self.estimate_c)
            + int(self.estimate_radial) * self.num_radial_distortions
            + int(self.estimate_decent) * 2
        )


def settings_echo_pairs(settings: Settings) -> list:
    """(cfg_key, value) pairs for the .out settings echo, in the
    reference's .cfg vocabulary (Estimate_Xc, Meas_std, Type, ... —
    main.m:647-652 echoes the cfg keys, not internal field names)."""
    field_to_key = {f: k for k, (f, _) in _REQUIRED_KEYS.items()}
    field_to_key.update({
        "output_filename": "Output_Filename",
        "meas_std": "Meas_std",
        "meas_std_y": "Meas_std_y",
        "model": "Type",
        "check_points": "Check_Points",
    })
    pairs = []
    for f in dataclasses.fields(settings):
        v = getattr(settings, f.name)
        if v is None:
            continue
        if isinstance(v, bool):
            v = int(v)
        pairs.append((field_to_key[f.name], str(v)))
    return pairs


_REQUIRED_KEYS = {
    # cfg key -> (field name, is_bool)
    "Iteration_Cap": ("iteration_cap", False),
    "Threshold_Value": ("threshold", False),
    "Inner_Constraints": ("inner_constraints", True),
    "Estimate_Xc": ("estimate_xc", True),
    "Estimate_Yc": ("estimate_yc", True),
    "Estimate_Zc": ("estimate_zc", True),
    "Estimate_Omega": ("estimate_w", True),
    "Estimate_Phi": ("estimate_p", True),
    "Estimate_Kappa": ("estimate_k", True),
    "Estimate_c": ("estimate_c", True),
    "Estimate_xp": ("estimate_xp", True),
    "Estimate_yp": ("estimate_yp", True),
    "Estimate_Radial_Distortions": ("estimate_radial", True),
    "Num_Radial_Distortions": ("num_radial_distortions", False),
    "Estimate_Decentering_Distortions": ("estimate_decent", True),
    "Estimate_tie": ("estimate_tie", True),
    "Estimate_AllGCP": ("estimate_all_gcp", True),
}


def parse_cfg_text(text: str) -> dict:
    """Parse raw .cfg text into a {key: str_value} dict.

    Whitespace-delimited key/value pairs; `#` starts a comment
    (functions/ReadFiles.m:49 comment convention; findSetting.m:21-27
    quoted-string convention is resolved by the caller).
    """
    out = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = re.split(r"[\t ]+", line, maxsplit=1)
        if len(parts) != 2:
            continue  # the reference's readmatrix silently pads; a bare key is useless
        out[parts[0]] = parts[1].strip()
    return out


def _coerce(key: str, raw: str, errors: list):
    """findSetting.m:21-27 — 'quoted' => string, else numeric (NaN is an error)."""
    if len(raw) >= 2 and raw[0] == "'" and raw[-1] == "'":
        return raw[1:-1]
    try:
        val = float(raw)
    except ValueError:
        errors.append(f"{key}: invalid numeric value {raw!r}")
        return None
    if val != val:  # NaN check (findSetting.m:40)
        errors.append(f"{key}: cannot be NaN")
        return None
    return val


def load_settings(cfg_path, default_output_stem: Optional[str] = None) -> Settings:
    """Read a .cfg file into a Settings object.

    `default_output_stem` supplies the Output_Filename default (the reference
    uses the dataset folder name, main.m:117-120).
    """
    text = Path(cfg_path).read_text()
    return settings_from_dict(parse_cfg_text(text), default_output_stem)


def settings_from_dict(kv: dict, default_output_stem: Optional[str] = None) -> Settings:
    errors: list = []
    fields = {}

    for key, (field, is_bool) in _REQUIRED_KEYS.items():
        if key not in kv:
            errors.append(f"missing required setting {key}")
            continue
        val = _coerce(key, kv[key], errors)
        if val is None:
            continue
        if is_bool:
            if val not in (0.0, 1.0):  # findSetting.m:47-52
                errors.append(f"{key} must be 1 or 0")
                continue
            fields[field] = bool(val)
        else:
            fields[field] = val

    if errors:
        raise ConfigError("; ".join(errors))

    fields["iteration_cap"] = int(fields["iteration_cap"])
    fields["num_radial_distortions"] = int(fields["num_radial_distortions"])

    # optional keys
    if "Output_Filename" in kv:
        fields["output_filename"] = _coerce("Output_Filename", kv["Output_Filename"], errors)
    elif default_output_stem:
        fields["output_filename"] = f"{default_output_stem}.out"

    if "Meas_std" in kv:
        fields["meas_std"] = _coerce("Meas_std", kv["Meas_std"], errors)
        # Meas_std_y only consulted when Meas_std present (main.m:124-130)
        if "Meas_std_y" in kv:
            fields["meas_std_y"] = _coerce("Meas_std_y", kv["Meas_std_y"], errors)

    if "Type" in kv:
        fields["model"] = _coerce("Type", kv["Type"], errors)

    if "Check_Points" in kv:
        cp = _coerce("Check_Points", kv["Check_Points"], errors)
        if cp not in (0.0, 1.0):
            errors.append("Check_Points must be 1 or 0")
        else:
            fields["check_points"] = bool(cp)

    if errors:
        raise ConfigError("; ".join(errors))
    return Settings(**fields)
