"""Fused banded Schur operator: two CUDA kernels and their plain versions.

PyTorch port of fish_eye_bundle_adjustment_tpu/ops/fusedmv.py.  Over the
tie-RANK-sorted observation stream (ops/bandplan.py), cut into groups of
M tie ranks (span of T rows from a 128-aligned start, image band
[base, base + W)), one pass evaluates the reduced camera system pieces

    per group g, on the rows the group owns ([fr, er) inside its span):
      V   = v_pose at each row's image        camera-vector expansion
      a   = sum_e Aex_e V_e (+ IOP terms + optional injected rows)
      t   = per-tie sum of Ap' a
      y   = Hpp^-1 t                          3x3 blocks, rank order
      b   = a - Ap y(row's tie)
      out = C' b                              image-band + IOP reduction

All streams are sqrt(W)-folded (Ae = sqrt(w) Je etc.) and carried
transposed, (D, n_pad).  Modes: ``vpose`` given expands the camera vector;
``a_rows`` given adds injected per-row values (whitened residuals).  One
operator therefore serves

  matvec          (vpose, no a_rows)
  reduced_rhs     (a_rows = sqrt(w) r; negate outside), + with_precond
  back_substitute (vpose = dc, a_rows = sqrt(w) r; dp = -y)

Each public wrapper dispatches on the device of its inputs: CUDA tensors
launch the hand-written kernel of ops/csrc/fusedmv.cu (and raise on
anything it does not take), which also reads the host index of
``group_index`` that BandArrays carries; CPU tensors run the plain
PyTorch version (``*_ref``) beside it.  The output shapes are the TPU kernels' -- including
the (., 128) lane partials of the IOP outputs, which callers sum over
lanes -- so the solver glue ports line for line.

Precision: as the JAX package's ``_dot`` does before each one-hot mask
contraction, the kernels and the plain versions round the operand that is
not the mask -- the camera vector at each row's image, P = Ap'a, the
tie's y = Hpp^-1 t, the rows of C'b, the preconditioner's Hpp^-1 and sym
rows (K2); the Hpp sym rows and the pose diagonal terms (K1) -- to
nearest even: to bf16 for ``precision="bf16"``, to hi = bf16(x) plus
lo = bf16(x - hi) for "bf16x2".  Everything else, and every sum, is f32.
The arithmetic before each rounding is the same in the kernel and in the
plain version, operation for operation (no fused multiply-add), and the
plain version sums each tie's run in row order as the kernel does, so
that a value near a bf16 rounding boundary rounds the same way in both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops.bandplan import BandPlan
from fish_eye_bundle_adjustment_tpu_torch.utils.cudagraph import count_launch

# Launch counts: the wrappers add one where they launch a kernel
# (`kernel_launches`) or run the plain version on the CPU (`plain_calls`).
# chip_smoke.py and the tests reset and read them to show which path ran.
kernel_launches = {"fused_hpp_pass": 0, "fused_schur_apply": 0}
plain_calls = {"fused_hpp_pass": 0, "fused_schur_apply": 0}


def reset_counts() -> None:
    for d in (kernel_launches, plain_calls):
        for k in d:
            d[k] = 0


@dataclasses.dataclass
class BandArrays:
    """Banded-plan tensors on one device + static geometry (Python ints)."""

    sb: torch.Tensor  # (G,) int32 row_start // 128
    fr: torch.Tensor  # (G,) int32 first owned row
    er: torch.Tensor  # (G,) int32 one past last owned row
    ib: torch.Tensor  # (G,) int32 img_base // 128
    rel: torch.Tensor  # (1, n_pad) f32 tie rank % M (-1 pad)
    imgrow: torch.Tensor  # (1, n_pad) f32 image rank (-1 pad)
    img_of_imgrank: torch.Tensor  # (n_img,) int64
    imgrank_of_img: torch.Tensor  # (n_img,) int64
    rank_of_slot: torch.Tensor  # (n_tie,) int64
    slot_of_rank: torch.Tensor  # (n_tie,) int64
    # owning group of each stream row (-1: owned by none), for the plain
    # versions; the kernels derive ownership from sb/fr/er themselves
    row_group: torch.Tensor  # (n_pad,) int64
    # the kernels' index (group_index), over each group's owned rows,
    # numbered from the group's first owned row
    tie_off: torch.Tensor  # (G, M+1) int32 run of tie slot m: [tie_off[m], tie_off[m+1])
    col_perm: torch.Tensor  # (G, T) int16 in-band rows by band column, then row; -1 pad
    col_off: torch.Tensor  # (G, W+1) int32 run of column c in col_perm
    cover_off: torch.Tensor  # (n_img_pad/128 + 1,) int32 CSR offsets into cover_ids
    cover_ids: torch.Tensor  # (G*W/128,) int32 groups whose band covers each 128-image block
    M: int = 128
    T: int = 128
    W: int = 128
    G: int = 1
    n_pad: int = 0
    n_img_pad: int = 0
    n_tie: int = 0
    n_img: int = 0

    @staticmethod
    def from_plan(plan: BandPlan, device) -> "BandArrays":
        index = group_index(plan)
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
        i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        f32 = lambda a: torch.as_tensor(
            np.asarray(a, np.float32), device=device
        ).reshape(1, -1)
        return BandArrays(
            sb=i32(plan.row_start // 128),
            fr=i32(plan.first_row),
            er=i32(plan.end_row),
            ib=i32(plan.img_base // 128),
            rel=f32(plan.rel),
            imgrow=f32(plan.imgrow),
            img_of_imgrank=i64(plan.img_of_imgrank),
            imgrank_of_img=i64(plan.imgrank_of_img),
            rank_of_slot=i64(plan.rank_of_slot),
            slot_of_rank=i64(plan.slot_of_rank),
            row_group=i64(index["row_group"]),
            tie_off=i32(index["tie_off"]),
            col_perm=torch.as_tensor(index["col_perm"], device=device),
            col_off=i32(index["col_off"]),
            cover_off=i32(index["cover_off"]),
            cover_ids=i32(index["cover_ids"]),
            M=plan.M, T=plan.T, W=plan.W, G=plan.G,
            n_pad=plan.n_pad, n_img_pad=plan.n_img_pad,
            n_tie=plan.n_tie, n_img=plan.n_img,
        )


def _csr_offsets(keys, n):
    """Offsets (n + 1,) of the runs of sorted integer keys in [0, n)."""
    off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n), out=off[1:])
    return off


def group_index(plan) -> dict:
    """The kernels' host index of a band plan, built once per problem.

    Each group owns the rows [max(fr, 128 sb), min(er, 128 sb + T)) of
    the tie-rank-sorted stream; its row i is stream row lo + i.

    row_group (n_pad,)   owning group of each stream row, -1 for none
    tie_off   (G, M+1)   tie slot m's rows are [tie_off[m], tie_off[m+1]):
                         the stream is sorted by tie rank, so each slot is
                         one run; control rows (rel = -1) lie in none
    col_perm  (G, T)     the group's in-band rows ordered by band column
                         and, within a column, by row; -1 past the end
    col_off   (G, W+1)   column c's rows are col_perm[col_off[c]:col_off[c+1]]
    cover_off, cover_ids CSR over the 128-image blocks of n_img_pad: the
                         groups, ascending, whose band [128 ib, 128 ib + W)
                         holds the block
    """
    G, M, T, W = plan.G, plan.M, plan.T, plan.W
    if T > np.iinfo(np.int16).max + 1 or W % 128:
        raise ValueError(f"the kernels' index takes T <= 32768 and W % 128 == 0 "
                         f"(T={T}, W={W})")
    start = np.asarray(plan.row_start, np.int64)
    lo = np.maximum(np.asarray(plan.first_row, np.int64), start)
    n = np.maximum(np.minimum(np.asarray(plan.end_row, np.int64), start + T) - lo, 0)
    grp = np.repeat(np.arange(G), n)
    first = np.concatenate([[0], np.cumsum(n)])
    local = np.arange(first[-1]) - first[grp]
    rows = lo[grp] + local
    row_group = np.full(plan.n_pad, -1, np.int64)
    row_group[rows] = grp

    # tie runs: slot keys, control rows keyed M (past every run)
    rel = np.asarray(plan.rel)[rows]
    key = np.where((rel >= 0) & (rel < M), rel, M).astype(np.int64)
    if (np.diff(key)[grp[1:] == grp[:-1]] < 0).any():
        raise ValueError("a group's rows are not sorted by tie slot")
    tie_off = _csr_offsets(grp * (M + 1) + key, G * (M + 1))[:-1].reshape(G, M + 1)
    tie_off = tie_off - tie_off[:, :1]

    # column order: stable sort of the in-band rows by (group, column)
    img = np.asarray(plan.imgrow)[rows].astype(np.int64)
    col = img - np.asarray(plan.img_base, np.int64)[grp]
    inb = (img >= 0) & (col >= 0) & (col < W)
    ck = grp[inb] * W + col[inb]
    order = np.argsort(ck, kind="stable")
    col_off = _csr_offsets(ck, G * W)[:-1].reshape(G, W)
    col_off = np.concatenate([col_off, _csr_offsets(grp[inb], G)[1:, None]], axis=1)
    col_off = col_off - col_off[:, :1]
    g_in = grp[inb][order]
    col_perm = np.full((G, T), -1, np.int16)
    col_perm[g_in, np.arange(g_in.size) - _csr_offsets(g_in, G)[g_in]] = local[inb][order]

    # covering groups of each 128-image block, ascending
    wb = W // 128
    blocks = (np.asarray(plan.img_base, np.int64)[:, None] // 128 + np.arange(wb)).ravel()
    cover_ids = np.repeat(np.arange(G), wb)[np.argsort(blocks, kind="stable")]
    cover_off = _csr_offsets(blocks, plan.n_img_pad // 128)
    return dict(row_group=row_group, tie_off=tie_off, col_perm=col_perm,
                col_off=col_off, cover_off=cover_off, cover_ids=cover_ids)


def _sym_rows(k: int):
    """Output rows of the (k, k) symmetric blocks: pairs padded to 8."""
    return -(-(k * (k + 1) // 2) // 8) * 8


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def _row_maps(band: BandArrays):
    """Per stream row: owned, tie rank (valid where `tie`), tie mask, image
    rank (valid where `inband`), in-band mask and the 128-lane index."""
    owned = band.row_group >= 0
    g = band.row_group.clamp(min=0)
    rel = band.rel[0].long()
    tie = owned & (rel >= 0) & (rel < band.M)
    rank = torch.where(tie, g * band.M + rel, torch.zeros_like(rel))
    img = band.imgrow[0].long()
    base = band.ib.long()[g] * 128
    inband = owned & (img >= base) & (img < base + band.W)
    img = torch.where(inband, img, torch.zeros_like(img))
    lane = torch.arange(band.n_pad, device=img.device) % 128
    return owned, rank, tie, img, inband, lane


PRECISIONS = {"bf16": 0, "bf16x2": 1}  # the C entry points' precision codes


def _precision_code(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision is 'bf16' or 'bf16x2', got {precision!r}")
    return PRECISIONS[precision]


def _round(x, precision):
    """The operand rounding of the JAX package's _dot: bf16 (nearest even),
    or the bf16 hi/lo pair summed in f32 (exact)."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    if not _precision_code(precision):
        return hi
    return hi + (x - hi).to(torch.bfloat16).to(x.dtype)


def _tie_sums(vals, rank, tie, n_cols):
    """(k, n_pad) per-row values -> (k, n_cols) per-tie sums, each run of
    the tie-rank-sorted stream summed in row order (as the K2 kernel sums
    it): one masked add per position in the runs."""
    out = vals.new_zeros((vals.shape[0], n_cols))
    rows = torch.nonzero(tie).flatten()
    if rows.numel() == 0:
        return out
    r = rank[rows]
    idx = torch.arange(rows.numel(), device=rows.device)
    new = torch.ones_like(tie[rows])
    new[1:] = r[1:] != r[:-1]
    pos = idx - torch.where(new, idx, torch.zeros_like(idx)).cummax(0).values
    for k in range(int(pos.max()) + 1):
        at = pos == k
        out[:, r[at]] += vals[:, rows[at]]
    return out


def _sum_by(vals, idx, sel, rows, n_cols):
    """(k, n_pad) per-row values -> (rows, n_cols) sums by column idx[sel].
    On the CPU index_add_ adds in row order, in the values' type (the JAX
    scatter's arithmetic, which the CPU solves are held to).  On the card
    it adds atomically in no fixed order, so there the sums are taken in
    float64 and rounded once: a float32 total would carry that order into
    its last bits, run to run, and into the kernels' checks."""
    acc = torch.float64 if vals.device.type == "cuda" else vals.dtype
    out = torch.zeros((rows, n_cols), dtype=acc, device=vals.device)
    out[: vals.shape[0]].index_add_(1, idx[sel], vals[:, sel].to(acc))
    return out.to(vals.dtype)


def _by_image(vals, img, inband, n_img_pad):
    """(k, n_pad) per-row values -> (8 or k, n_img_pad) sums per image rank."""
    return _sum_by(vals, img, inband, max(8, vals.shape[0]), n_img_pad)


def _by_lane(vals, lane, owned, rows=8):
    """(k, n_pad) per-row values -> (rows, 128) lane partials."""
    return _sum_by(vals, lane, owned, rows, 128)


def fused_hpp_pass_ref(band: BandArrays, acam_t, apt_t, ne: int, ni: int,
                       precision: str = "bf16x2"):
    """Plain version of the K1 kernel (see fused_hpp_pass)."""
    owned, rank, tie, img, inband, lane = _row_maps(band)
    cam, pt = acam_t, apt_t
    lf = owned.to(cam.dtype)
    sym = torch.stack(
        [pt[a] * pt[b] + pt[3 + a] * pt[3 + b] for a in range(3) for b in range(a, 3)]
    ) * lf
    hs = _sum_by(_round(sym, precision), rank, tie, 8, band.G * band.M)
    de = torch.stack([cam[e] * cam[e] + cam[ne + e] * cam[ne + e] for e in range(ne)]) * lf
    de = _round(de, precision)
    di8 = cam.new_zeros((8, 128))
    if ni:
        di = torch.stack(
            [cam[2 * ne + i] ** 2 + cam[2 * ne + ni + i] ** 2 for i in range(ni)]
        ) * lf
        di8 = _by_lane(di, lane, owned)
    return hs, _by_image(de, img, inband, band.n_img_pad), di8


def fused_schur_apply_ref(band: BandArrays, acam_t, apt_t, hpi_t, ne: int,
                          ni: int, vpose=None, vi=None, a_rows=None,
                          precision: str = "bf16x2",
                          with_precond: bool = False):
    """Plain version of the K2 kernel (see fused_schur_apply)."""
    owned, rank, tie, img, inband, lane = _row_maps(band)
    cam, pt = acam_t, apt_t
    lf = owned.to(cam.dtype)
    # every sum below is taken term by term in the kernel's order
    ax = cam.new_zeros(band.n_pad)
    ay = cam.new_zeros(band.n_pad)
    if vpose is not None:
        V = _round(vpose[:ne], precision)[:, img] * inband.to(cam.dtype)  # (ne, n_pad)
        for e in range(ne):
            ax = ax + cam[e] * V[e]
            ay = ay + cam[ne + e] * V[e]
        for i in range(ni):
            ax = ax + vi[i] * cam[2 * ne + i]
            ay = ay + vi[i] * cam[2 * ne + ni + i]
    if a_rows is not None:
        ax = ax + a_rows[0]
        ay = ay + a_rows[1]
    ax = ax * lf
    ay = ay * lf

    # per-tie reduction -> Hpp^-1 -> expansion
    P2 = _round(pt[0:3] * ax + pt[3:6] * ay, precision)  # (3, n_pad)
    t = _tie_sums(P2, rank, tie, band.G * band.M)
    y = torch.stack(
        [sum(hpi_t[3 * p + q] * t[q] for q in range(3)) for p in range(3)]
    )  # (3, G*M)
    out_y = torch.cat([y, y.new_zeros((5, y.shape[1]))])
    tief = tie.to(cam.dtype)
    Y = _round(y, precision)[:, rank] * tief  # (3, n_pad)
    bx, by = ax, ay
    for q in range(3):
        bx = bx - pt[q] * Y[q]
        by = by - pt[3 + q] * Y[q]

    Be = _round(cam[:ne] * bx + cam[ne : 2 * ne] * by, precision)  # (ne, n_pad)
    out_pose = _by_image(Be, img, inband, band.n_img_pad)
    out_iop = cam.new_zeros((8, 128))
    if ni:
        Pi = cam[2 * ne : 2 * ne + ni] * bx + cam[2 * ne + ni : 2 * ne + 2 * ni] * by
        out_iop = _by_lane(Pi, lane, owned)
    if not with_precond:
        return out_pose, out_iop, out_y

    # Schur-Jacobi blocks: pose-diagonal sym columns with the exact
    # per-observation Hpp^-1 correction, IOP diagonal without correction
    Hrow = _round(hpi_t[:9], precision)[:, rank] * tief  # (9, n_pad): row 3p+q = Hpp^-1[p, q]
    B = [[cam[e] * pt[p] + cam[ne + e] * pt[3 + p] for p in range(3)]
         for e in range(ne)]
    C = [[sum(B[e][p] * Hrow[3 * p + q] for p in range(3)) for q in range(3)]
         for e in range(ne)]
    rows = []
    for e in range(ne):
        for f in range(e, ne):
            hcc = cam[e] * cam[f] + cam[ne + e] * cam[ne + f]
            rows.append(hcc - sum(C[e][q] * B[f][q] for q in range(3)))
    sym = _round(torch.stack(rows) * lf, precision)
    p21 = cam.new_zeros((_sym_rows(ne), band.n_img_pad))
    p21[: len(rows)] = _by_image(sym, img, inband, band.n_img_pad)[: len(rows)]
    i_rows = max(8, _sym_rows(ni))
    i55 = cam.new_zeros((i_rows, 128))
    if ni:
        rows_i = [
            cam[2 * ne + i] * cam[2 * ne + j]
            + cam[2 * ne + ni + i] * cam[2 * ne + ni + j]
            for i in range(ni) for j in range(i, ni)
        ]
        i55 = _by_lane(torch.stack(rows_i) * lf, lane, owned, rows=i_rows)
    return out_pose, out_iop, out_y, p21, i55


# ---------------------------------------------------------------------------
# wrappers: CUDA tensors -> kernel, CPU tensors -> plain version
# ---------------------------------------------------------------------------
def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"fused kernels take all-CPU or all-CUDA tensors, got {devs}")


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(band, acam_t, apt_t, ne, ni):
    dev = acam_t.device
    CA = acam_t.shape[0]
    if not (1 <= ne <= 6 and 0 <= ni <= 8 and 2 * (ne + ni) <= CA):
        raise ValueError(f"kernel takes 1 <= ne <= 6, ni <= 8, 2(ne+ni) <= CA "
                         f"(ne={ne}, ni={ni}, CA={CA})")
    if band.M > 32767 or band.W > 32767:
        raise ValueError("kernel takes M and W below 32768")
    _check("acam_t", acam_t, (CA, band.n_pad), torch.float32, dev)
    _check("apt_t", apt_t, (8, band.n_pad), torch.float32, dev)
    _check("rel", band.rel, (1, band.n_pad), torch.float32, dev)
    _check("imgrow", band.imgrow, (1, band.n_pad), torch.float32, dev)
    for name in ("sb", "fr", "er", "ib"):
        _check(name, getattr(band, name), (band.G,), torch.int32, dev)
    G, n_blk = band.G, band.n_img_pad // 128
    _check("tie_off", band.tie_off, (G, band.M + 1), torch.int32, dev)
    _check("col_perm", band.col_perm, (G, band.T), torch.int16, dev)
    _check("col_off", band.col_off, (G, band.W + 1), torch.int32, dev)
    _check("cover_off", band.cover_off, (n_blk + 1,), torch.int32, dev)
    _check("cover_ids", band.cover_ids, (G * band.W // 128,), torch.int32, dev)
    return dev


def _index_ptrs(band):
    """Pointers of the plan and its index, in the C entry points' order."""
    return [t.data_ptr() for t in (
        band.rel, band.imgrow, band.sb, band.fr, band.er, band.ib, band.tie_off,
        band.col_perm, band.col_off, band.cover_off, band.cover_ids)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_smem(smem, band, ne, mode):
    """Raise before a launch whose CTA would need more shared memory than
    an H100 block may have."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"{mode} needs {smem} bytes of shared memory a CTA at T={band.T}, "
            f"M={band.M}, W={band.W}, ne={ne}; a block has {_build.SMEM_LIMIT}"
        )


def fused_hpp_pass(band: BandArrays, acam_t, apt_t, ne: int, ni: int,
                   precision: str = "bf16x2"):
    """Returns (hs (8, G*M): rows 0-5 = per-tie Hpp sym cols in RANK
    column order, de (8, n_img_pad): rows 0..ne-1 = raw pose diag(Hcc) in
    image-RANK columns, di (8, 128): IOP diag lane-partials)."""
    if _on_cpu(acam_t, apt_t):
        plain_calls["fused_hpp_pass"] += 1
        return fused_hpp_pass_ref(band, acam_t, apt_t, ne, ni, precision)
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    dev = _check_common(band, acam_t, apt_t, ne, ni)
    bf16x2 = _precision_code(precision)
    lib = _build.load()
    _check_smem(lib.fusedmv_hpp_smem_bytes(band.T, band.M), band, ne, "fused_hpp_pass")
    G, M, W = band.G, band.M, band.W
    emp = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    hs, de, di = emp(8, G * M), emp(8, band.n_img_pad), emp(8, 128)
    de_part, di_part = emp(G, 8, W), emp(G, 8, 128)
    de_terms = emp(max(ne, 1), band.n_pad)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.fusedmv_hpp_pass(
        _ptr(acam_t), _ptr(apt_t), *_index_ptrs(band),
        G, M, band.T, W, band.n_pad, band.n_img_pad, ne, ni, bf16x2,
        _ptr(hs), _ptr(de_part), _ptr(di_part), _ptr(de_terms), _ptr(de), _ptr(di), stream,
    )
    _build.check(code, "fused_hpp_pass")
    count_launch(kernel_launches, "fused_hpp_pass", dev)
    return hs, de, di


def fused_schur_apply(band: BandArrays, acam_t, apt_t, hpi_t, ne: int, ni: int,
                      vpose=None, vi=None, a_rows=None,
                      precision: str = "bf16x2", with_precond: bool = False):
    """Returns (out_pose (8, n_img_pad), out_iop (8, 128) lane-partial,
    y (8, G*M)[, p21 (p_rows, n_img_pad), i55 (i_rows, 128)]) -- see the
    module docstring; with_precond adds the Schur-Jacobi diagonal sym
    columns in the same pass."""
    if _on_cpu(acam_t, apt_t, hpi_t, vpose, vi, a_rows):
        plain_calls["fused_schur_apply"] += 1
        return fused_schur_apply_ref(
            band, acam_t, apt_t, hpi_t, ne, ni, vpose=vpose, vi=vi,
            a_rows=a_rows, precision=precision, with_precond=with_precond,
        )
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    dev = _check_common(band, acam_t, apt_t, ne, ni)
    G, M, W = band.G, band.M, band.W
    _check("hpi_t", hpi_t, (16, G * M), torch.float32, dev)
    with_v = vpose is not None
    if with_v != (vi is not None):
        raise ValueError("vpose and vi come together")
    if with_v:
        _check("vpose", vpose, (8, band.n_img_pad), torch.float32, dev)
        _check("vi", vi, (128,), torch.float32, dev)
    if a_rows is not None:
        _check("a_rows", a_rows, (8, band.n_pad), torch.float32, dev)
    bf16x2 = _precision_code(precision)
    lib = _build.load()
    mode = ("rhs + preconditioner" if with_precond else
            "back-substitution" if with_v and a_rows is not None else
            "matvec" if with_v else "reduced rhs")
    _check_smem(lib.fusedmv_schur_smem_bytes(band.T, M, W, ne, int(with_v), int(with_precond),
                                             _build.SMEM_LIMIT),
                band, ne, f"fused_schur_apply ({mode})")
    p_rows = _sym_rows(ne)
    i_rows = max(8, _sym_rows(ni))
    emp = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    out_pose, out_iop, out_y = emp(8, band.n_img_pad), emp(8, 128), emp(8, G * M)
    pose_part, iop_part = emp(G, 8, W), emp(G, 8, 128)
    p21 = i55 = p21_part = i55_part = None
    if with_precond:
        p21, i55 = emp(p_rows, band.n_img_pad), emp(i_rows, 128)
        p21_part, i55_part = emp(G, p_rows, W), emp(G, i_rows, 128)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.fusedmv_schur_apply(
        _ptr(acam_t), _ptr(apt_t), *_index_ptrs(band)[:2],
        _ptr(a_rows), _ptr(vpose), _ptr(vi), _ptr(hpi_t), *_index_ptrs(band)[2:],
        G, M, band.T, W, band.n_pad, band.n_img_pad, ne, ni,
        int(with_v), int(a_rows is not None), int(with_precond), p_rows, i_rows,
        bf16x2, _build.SMEM_LIMIT, _ptr(pose_part), _ptr(iop_part), _ptr(out_y), _ptr(p21_part),
        _ptr(i55_part), _ptr(out_pose), _ptr(out_iop), _ptr(p21), _ptr(i55),
        stream,
    )
    _build.check(code, "fused_schur_apply")
    count_launch(kernel_launches, "fused_schur_apply", dev)
    if with_precond:
        return out_pose, out_iop, out_y, p21, i55
    return out_pose, out_iop, out_y


def _reduce_kernel(band: BandArrays, band_part, lane_part, band_live: int,
                   lane_live: int):
    """The second kernel of K1 and K2 alone, on given CUDA partials
    (band_part (G, rows, W), lane_part (G, rows, 128)), for the card tests:
    (band out (rows, n_img_pad), lane out (rows, 128))."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    if _on_cpu(band_part, lane_part):
        raise ValueError("_reduce_kernel runs on CUDA tensors only")
    dev = band_part.device
    G, rows, W = band_part.shape
    lane_rows = lane_part.shape[1]
    _check("band_part", band_part, (band.G, rows, band.W), torch.float32, dev)
    _check("lane_part", lane_part, (band.G, lane_rows, 128), torch.float32, dev)
    band_out = torch.empty((rows, band.n_img_pad), dtype=torch.float32, device=dev)
    lane_out = torch.empty((lane_rows, 128), dtype=torch.float32, device=dev)
    lib = _build.load()
    code = lib.fusedmv_reduce(
        _ptr(band_part), _ptr(lane_part), _ptr(band.ib), _ptr(band.cover_off),
        _ptr(band.cover_ids), G, W, band.n_img_pad, rows, band_live, lane_rows,
        lane_live, _ptr(band_out), _ptr(lane_out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "fusedmv_reduce")
    return band_out, lane_out
