"""The yardstick's arithmetic: the bytes and operations the algorithm
needs, from the problem's own counts, and the chip's peaks.

Counts never read the implementation's padding, band widths or layouts,
so a change to those moves the time and not the bound.  Bytes count each
input once and each output once, in the cell's stated type (the fused
path's in-register bf16 rounding of operands is part of float32's stated
precision and not of its storage).

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit:
3.35 TB/s of HBM3, 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the
tensor cores (67 with them; the Schur operator has no matrix product to
give them).
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEM_BYTES = {"float32": 4, "float64": 8}
INDEX_BYTES = 4  # an image or tie index of one observation, int32


@dataclass(frozen=True)
class Sizes:
    """The problem's counts: observations (image points, two rows each),
    images, cameras, tie points, and the unknowns of each image (ne) and
    camera (ni)."""

    n_obs: int
    n_img: int
    n_cam: int
    n_tie: int
    ne: int
    ni: int
    dtype: str

    @property
    def nc(self) -> int:
        """Unknowns of the reduced camera system."""
        return self.n_img * self.ne + self.n_cam * self.ni


def matvec(s: Sizes) -> tuple:
    """(bytes, flops) of one reduced-camera-system product
    S v = C'W (C v - P Hpp^-1 P'W C v), C = [Je | Ji], from stored
    Jacobian blocks.

    Bytes: each observation's two rows of camera and point Jacobian
    blocks (2 (ne + ni + 3) values, the weights folded in), its image and
    tie index; each tie point's Hpp^-1 (6 values, symmetric); v read and
    S v written once.  Flops, multiply and add counted apart: per
    observation C v (4 (ne + ni)), P'(W C v) (12), P y (12) and the
    difference and weights (4), C'(.) (4 (ne + ni)); per tie point the
    3 x 3 product (15)."""
    item = ITEM_BYTES[s.dtype]
    k = s.ne + s.ni
    nbytes = (s.n_obs * (2 * (k + 3) * item + 2 * INDEX_BYTES)
              + s.n_tie * 6 * item + 2 * s.nc * item)
    flops = s.n_obs * (8 * k + 28) + s.n_tie * 15
    return nbytes, flops


def bound_s(nbytes: float, flops: float, dtype: str) -> tuple:
    """(least seconds at the chip's peaks, "bytes" or "operations")."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS[dtype]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

