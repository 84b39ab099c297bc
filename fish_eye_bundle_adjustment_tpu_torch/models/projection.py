"""Projection models, distortion, and the per-observation residual.

PyTorch port of fish_eye_bundle_adjustment_tpu/models/projection.py: the
same single residual definition, with Jacobians from forward-mode
autodiff (``torch.func.jacfwd``) batched over observations with
``torch.func.vmap`` -- no Python loop runs per observation.

Conventions reproduced from the reference:

1. Rotation: camera frame vector (U,V,W) = R3(kappa) R2(phi) R1(omega) @
   (X - Xc) with the expanded element forms of BuildAwG.m:163-166.
2. Distortion (radial Sum_j K_j r^(2j) and Conrady-Brown decentering) is
   evaluated at the MEASURED image coordinates (x - xp, y - yp), not the
   projected ones — the additive-correction convention of BuildAwG.m:168-181.
3. ``y_dir`` (+-1) flips the sign of the projected y term only
   (BuildAwG.m:187 et al.).
4. Five projection models (BuildAwG.m:184-214), all of the form
   fx = -c * U * g(R, W) + xp + dr*x_bar + dec_x with R = sqrt(U^2+V^2):

   | model         | g(R, W)                  |
   |---------------|--------------------------|
   | fisheye       | atan(R/W) / R            | (equidistant)
   | pinhole       | 1 / W                    | (collinearity)
   | equisolid     | 2 sin(atan(R/W)/2) / R   |
   | orthographic  | sin(atan(R/W)) / R       |
   | stereographic | 2 tan(atan(R/W)/2) / R   |

   All non-pinhole g have the removable singularity g -> 1/W as R -> 0,
   handled with a double-where so neither values nor forward-mode
   derivatives produce NaN on-axis.

Constants are Python ints, never floats: jacfwd promotes a tangent to
float64 where a 0-d tensor meets a Python float (torch 2.11 and 2.13:
``2.0 * t`` for a float32 0-d ``t``), while an int keeps the tensor's
dtype.  So a float32 residual gets float32 tangents, as JAX's jacfwd
does, and ``x / 2``, ``1 / W`` give the same bits as ``0.5 * x``,
``1.0 / W`` in either dtype.
"""

from __future__ import annotations

import threading

import torch

MODEL_IDS = {
    "fisheye": 0,
    "pinhole": 1,
    "equisolid": 2,
    "orthographic": 3,
    "stereographic": 4,
}

_R_EPS = 1e-12

# Observations per vmap chunk in the batched Jacobian: forward mode carries
# one tangent per unknown of the observation (6 EOP + 3+nk+2 IOP + 3 point
# = 15 at nk=1), so every intermediate of a chunk is (chunk, 15) values.
# The pass is bound by host dispatch, which grows with the number of
# chunks: at the 1M-observation bench block one chunk of 2^21 rows takes
# 29 ms where four of 2^18 took 35-76 ms, for 2.6 GiB of device memory at
# peak instead of 1.4 GiB (H100; profile_torch_step.py, PERF.md).  Larger
# streams go in chunks of 2^21 rows.
JACOBIAN_CHUNK = 1 << 21

# torch.func's forward mode is not thread-safe: jvp decides whether to open
# a dual level from a process-global count (JVP_NESTING in
# torch/_functorch/eager_transforms.py), so a second thread inside jacfwd
# opens none, and its tangents vanish when the first thread's level closes
# (zero Jacobian columns on the card; a RuntimeError naming the level at
# times).  The port runs no solves in threads (the pose graph's blocks run
# a process a card), but a caller's threads may: every Jacobian pass takes
# this lock.
_FORWARD_MODE = threading.Lock()


def rotation_matrix(w, p, k):
    """R = R3(kappa) @ R2(phi) @ R1(omega), rows expanded exactly as the
    U/V/W expressions at BuildAwG.m:163-166."""
    cw, sw = torch.cos(w), torch.sin(w)
    cp, sp = torch.cos(p), torch.sin(p)
    ck, sk = torch.cos(k), torch.sin(k)
    rows = [
        [ck * cp, cw * sk + ck * sp * sw, sk * sw - ck * cw * sp],
        [-cp * sk, ck * cw - sk * sp * sw, ck * sw + cw * sk * sp],
        [sp, -cp * sw, cp * cw],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def world_to_camera(eop, xyz):
    """(U, V, W) camera-frame coordinates of world point `xyz` for a camera
    with EOPs ``eop = (Xc, Yc, Zc, omega, phi, kappa)``."""
    R = rotation_matrix(eop[3], eop[4], eop[5])
    return R @ (xyz - eop[:3])


def _safe_axis_factor(R, W, fn):
    """fn(R, W)/R with the R->0 limit 1/W, autodiff-safe (double-where)."""
    near = R < _R_EPS
    R_safe = torch.where(near, torch.ones_like(R), R)
    return torch.where(near, 1 / W, fn(R_safe, W) / R_safe)


def projection_factor(model_id: int, R, W):
    """g(R, W) table above. `model_id` is a Python int."""
    if model_id == MODEL_IDS["fisheye"]:
        return _safe_axis_factor(R, W, lambda R, W: torch.atan(R / W))
    if model_id == MODEL_IDS["pinhole"]:
        return 1 / W
    if model_id == MODEL_IDS["equisolid"]:
        return _safe_axis_factor(
            R, W, lambda R, W: 2 * torch.sin(torch.atan(R / W) / 2)
        )
    if model_id == MODEL_IDS["orthographic"]:
        return _safe_axis_factor(R, W, lambda R, W: torch.sin(torch.atan(R / W)))
    if model_id == MODEL_IDS["stereographic"]:
        return _safe_axis_factor(
            R, W, lambda R, W: 2 * torch.tan(torch.atan(R / W) / 2)
        )
    raise ValueError(f"unknown model id {model_id}")


def distortion(iop, obs_xy, nk: int):
    """Additive distortion corrections at the MEASURED point.

    Returns (dx, dy) where dx = dr*x_bar + dec_x etc.
    (BuildAwG.m:168-181.)
    """
    xp, yp = iop[0], iop[1]
    K = iop[3 : 3 + nk]
    P = iop[3 + nk : 5 + nk]
    xb = obs_xy[0] - xp
    yb = obs_xy[1] - yp
    r2 = xb * xb + yb * yb
    # delta_r = sum_j K_j r^(2j); Horner in r^2
    dr = torch.zeros_like(r2)
    for j in range(nk - 1, -1, -1):
        dr = dr * r2 + K[j]
    dr = dr * r2
    dec_x = P[0] * (yb * yb + 3 * xb * xb) + 2 * P[1] * xb * yb
    dec_y = P[1] * (xb * xb + 3 * yb * yb) + 2 * P[0] * xb * yb
    return dr * xb + dec_x, dr * yb + dec_y


def project_obs(eop, iop, xyz, obs_xy, y_dir, model_id: int, nk: int):
    """Predicted image coordinates (fx, fy) for one observation.

    `obs_xy` participates because the distortion correction is anchored
    at the measured point (convention 2 above).
    """
    U, V, W = world_to_camera(eop, xyz).unbind(-1)
    R = torch.sqrt(U * U + V * V)
    g = projection_factor(model_id, R, W)
    c = iop[2]
    dx, dy = distortion(iop, obs_xy, nk)
    fx = -c * U * g + iop[0] + dx
    fy = -c * y_dir * V * g + iop[1] + dy
    return torch.stack([fx, fy])


def residual_obs(eop, iop, xyz, obs_xy, y_dir, model_id: int, nk: int):
    """Misclosure w = f(x_hat) - observed (BuildAwG.m:506-512)."""
    return project_obs(eop, iop, xyz, obs_xy, y_dir, model_id, nk) - obs_xy


def obs_jacobian_blocks(eop, iop, xyz, obs_xy, y_dir, model_id: int, nk: int):
    """Per-observation residual Jacobian blocks via forward-mode autodiff.

    Returns (r (2,), J_eop (2,6), J_iop (2,3+nk+2), J_pt (2,3)) for ONE
    observation; ``batched_jacobian_blocks`` maps it over a stream.
    """
    fn = lambda e, i, x: residual_obs(e, i, x, obs_xy, y_dir, model_id, nk)
    r = fn(eop, iop, xyz)
    J_eop, J_iop, J_pt = torch.func.jacfwd(fn, argnums=(0, 1, 2))(eop, iop, xyz)
    return r, J_eop, J_iop, J_pt


def _in_dims(iop, y_dir):
    """vmap in_dims: a 1-D `iop` / 0-D `y_dir` is shared by every row
    (the single-camera case), otherwise it is per observation."""
    return (0, None if iop.dim() == 1 else 0, 0, 0, None if y_dir.dim() == 0 else 0)


def batched_jacobian_blocks(eop, iop, xyz, obs_xy, y_dir, model_id: int, nk: int):
    """``obs_jacobian_blocks`` over (n, .) observation rows: returns r
    (n, 2), J_eop (n, 2, 6), J_iop (n, 2, 3+nk+2), J_pt (n, 2, 3).
    Chunked by JACOBIAN_CHUNK rows to bound forward-mode memory."""
    fn = lambda e, i, x, oxy, yd: obs_jacobian_blocks(e, i, x, oxy, yd, model_id, nk)
    with _FORWARD_MODE:
        return torch.func.vmap(
            fn, in_dims=_in_dims(iop, y_dir), chunk_size=JACOBIAN_CHUNK
        )(eop, iop, xyz, obs_xy, y_dir)


def batched_residuals(eop, iop, xyz, obs_xy, y_dir, model_id: int, nk: int):
    """``residual_obs`` over (n, .) observation rows -> (n, 2)."""
    fn = lambda e, i, x, oxy, yd: residual_obs(e, i, x, oxy, yd, model_id, nk)
    return torch.func.vmap(fn, in_dims=_in_dims(iop, y_dir))(
        eop, iop, xyz, obs_xy, y_dir
    )
