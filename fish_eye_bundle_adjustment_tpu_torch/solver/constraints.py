"""Inner-constraints (free-network datum) matrix G.

The reference adds d=7 datum-defect constraints (3 translation, 3 rotation,
1 scale) over the camera-station EOP block only — tie-point and IOP rows of
G stay zero (BuildAwG.m:514-527) — and solves the bordered KKT system
[N G; G' 0] (main.m:428-440).

Per-image 6x7 block, built from the CURRENT pose estimates each iteration
(columns: Tx Ty Tz Rx Ry Rz scale):

  Xc row:  [1 0 0 |   0  -Zc   Yc | Xc]
  Yc row:  [0 1 0 |  Zc    0  -Xc | Yc]
  Zc row:  [0 0 1 | -Yc   Xc    0 | Zc]
  w  row:  [0 0 0 |  -1  -sin(w)tan(p)  cos(w)tan(p) | 0]
  p  row:  [0 0 0 |   0  -cos(w)        -sin(w)      | 0]
  k  row:  [0 0 0 |   0   sin(w)/cos(p) -cos(w)/cos(p) | 0]

The reference's row placement assumes all six EOPs are estimated (it always
writes 6 rows at the image's xhat offset); we validate that instead of
silently mis-aligning.  PyTorch port of
fish_eye_bundle_adjustment_tpu/solver/constraints.py; the blocks are built
batched over images.
"""

from __future__ import annotations

import torch

from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

NUM_INNER_CONSTRAINTS = 7


def _g_blocks(eop):
    """(n_img, 6) EOP table -> (n_img, 6, 7) blocks."""
    Xc, Yc, Zc, w, p = (eop[:, j] for j in range(5))
    sw, cw = torch.sin(w), torch.cos(w)
    tp = torch.tan(p)
    sec = 1.0 / torch.cos(p)
    z = torch.zeros_like(Xc)
    one = torch.ones_like(Xc)
    rows = [
        [one, z, z, z, -Zc, Yc, Xc],
        [z, one, z, Zc, z, -Xc, Yc],
        [z, z, one, -Yc, Xc, z, Zc],
        [z, z, z, -one, -sw * tp, cw * tp, z],
        [z, z, z, z, -cw, -sw, z],
        [z, z, z, z, sw * sec, -cw * sec, z],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def validate_inner_constraints(layout: ParamLayout):
    if layout.n_eop != 6:
        raise ValueError(
            "Inner_Constraints requires all six EOPs to be estimated "
            "(the reference's G-row placement assumes it, BuildAwG.m:522-526)"
        )


def build_G(layout: ParamLayout, q):
    """(u, 7) inner-constraint matrix from the current q-vector.

    EOP entries have unit conditioning scale, so q-space == x-space here."""
    eop, _, _ = layout.unpack_scaled(q)
    blocks = _g_blocks(eop)  # (n_img, 6, 7)
    G = q.new_zeros((layout.u, NUM_INNER_CONSTRAINTS))
    G[: layout.eop_size] = blocks.reshape(layout.eop_size, 7)
    return G
