"""Multi-block partitioning + pose-graph merge (the DCN tier).

PyTorch port of fish_eye_bundle_adjustment_tpu/parallel/posegraph.py.  For
blocks too large for one device, images and tie points are partitioned
across devices with a pose-graph layer merging the blocks:

1. **Partition**: cluster images spatially (grid over camera positions);
   each block takes its images' observations; targets observed by several
   blocks are estimated independently in each (the overlap that glues the
   graph together).
2. **Block solve**: each block runs the Schur solver as a free network
   (per-block inner-constraints datum), one after the other, or one
   worker thread a card when asked (solve_posegraph's parallel_blocks).
3. **Pose-graph merge**: each block's solution floats in gauge by a
   7-parameter similarity.  For every block pair sharing >= 3 targets a
   relative similarity is estimated (Umeyama); a small linear pose-graph
   least squares over per-block similarity parameters (block 0 anchored)
   makes them globally consistent; block solutions are mapped into the
   global frame (perspective projection is invariant under a global
   similarity, so reprojection costs are preserved) and shared-target
   estimates are fused by observation-count weights.
4. **Global refine**: the merged estimate warm-starts the global Schur
   solver (solve_schur, or solve_schur_distributed over a Mesh) under the
   global datum.

The numpy parts (partition, sub-block extraction, similarities, the pose
graph, the fusion) are the JAX package's, line for line; the rotation of
each merged pose evaluates the port's rotation_matrix in float64.

A similarity gauge move is exactly the null space spanned by the inner-
constraint matrix G (solver/constraints.py), which is why free-network
block solutions differ from the truth by one similarity each.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import DenseResult, resolve_device
from fish_eye_bundle_adjustment_tpu_torch.solver.schur import SchurOptions, solve_schur
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout


# ----------------------------------------------------------------------
# partitioning
# ----------------------------------------------------------------------

def partition_images(problem: BAProblem, n_blocks: int) -> List[np.ndarray]:
    """Spatial grid partition of images by camera position (balanced-ish)."""
    xy = problem.eop0[:, :2]
    cols = max(1, int(round(math.sqrt(n_blocks))))
    rows = max(1, int(math.ceil(n_blocks / cols)))
    qx = np.clip(
        np.searchsorted(np.quantile(xy[:, 0], np.linspace(0, 1, cols + 1)[1:-1]), xy[:, 0]),
        0, cols - 1,
    )
    qy = np.clip(
        np.searchsorted(np.quantile(xy[:, 1], np.linspace(0, 1, rows + 1)[1:-1]), xy[:, 1]),
        0, rows - 1,
    )
    cell = qy * cols + qx
    blocks = [np.nonzero(cell == b)[0] for b in range(rows * cols)]
    return [b for b in blocks if b.size > 0]


@dataclasses.dataclass
class SubBlock:
    problem: BAProblem
    img_idx: np.ndarray  # global image indices, block order
    tgt_idx: np.ndarray  # global target indices, block order
    tie_tgt_global: np.ndarray  # global target index per block tie slot


def extract_block(problem: BAProblem, img_idx: np.ndarray,
                  force_free_network: bool = True) -> SubBlock:
    """Build the sub-problem of one image partition.

    Every target observed by the block is re-estimated inside it (tie), so
    overlapping blocks measure their shared geometry independently — that
    overlap drives the merge. With `force_free_network` each block gets its
    own inner-constraints datum regardless of global datum choice."""
    img_idx = np.asarray(img_idx)
    in_block = np.zeros(problem.n_img, dtype=bool)
    in_block[img_idx] = True
    sel = in_block[problem.obs_img]

    img_remap = -np.ones(problem.n_img, dtype=np.int64)
    img_remap[img_idx] = np.arange(img_idx.size)

    tgt_idx = np.unique(problem.obs_pt[sel])
    tgt_remap = -np.ones(problem.n_targets, dtype=np.int64)
    tgt_remap[tgt_idx] = np.arange(tgt_idx.size)

    # targets seen by >= 2 block observations are re-estimated (tie); a
    # single ray cannot triangulate, so singly-observed targets stay fixed
    # at their current coordinates inside this block
    block_counts = np.bincount(tgt_remap[problem.obs_pt[sel]], minlength=tgt_idx.size)
    tie_target_idx = np.nonzero(block_counts >= 2)[0].astype(np.int32)
    target_tie_slot = np.full(tgt_idx.size, -1, dtype=np.int32)
    target_tie_slot[tie_target_idx] = np.arange(tie_target_idx.size, dtype=np.int32)

    settings = problem.settings
    if force_free_network and not settings.inner_constraints:
        settings = dataclasses.replace(settings, inner_constraints=True)

    sub = BAProblem(
        settings=settings,
        image_ids=[problem.image_ids[i] for i in img_idx],
        camera_ids=list(problem.camera_ids),
        target_ids=[problem.target_ids[t] for t in tgt_idx],
        tie_ids=[problem.target_ids[tgt_idx[t]] for t in tie_target_idx],
        eop0=problem.eop0[img_idx].copy(),
        iop0=problem.iop0.copy(),
        cnt_xyz=problem.cnt_xyz[tgt_idx].copy(),
        y_dir=problem.y_dir.copy(),
        bounds=problem.bounds.copy(),
        rmax=problem.rmax.copy(),
        obs_xy=problem.obs_xy[sel].copy(),
        obs_img=img_remap[problem.obs_img[sel]].astype(np.int32),
        obs_cam=problem.obs_cam[sel].copy(),
        obs_pt=tgt_remap[problem.obs_pt[sel]].astype(np.int32),
        tie_target_idx=tie_target_idx,
        target_tie_slot=target_tie_slot,
        img_cam=problem.img_cam[img_idx].copy(),
    )
    return SubBlock(
        problem=sub,
        img_idx=img_idx,
        tgt_idx=tgt_idx,
        tie_tgt_global=tgt_idx[tie_target_idx],
    )


# ----------------------------------------------------------------------
# similarity estimation + pose-graph least squares
# ----------------------------------------------------------------------

def umeyama(src: np.ndarray, dst: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity (s, R, t) with dst ~= s R src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (sc**2).sum() / src.shape[0]
    s = float(np.trace(np.diag(D) @ S) / var_s) if var_s > 0 else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def _sim_to_vec(s, R, t) -> np.ndarray:
    """Near-identity similarity -> 7-vector (log s, rotvec, t)."""
    log_s = math.log(max(s, 1e-12))
    # small-angle rotation vector from R
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) * 0.5
    tr = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    ang = math.acos(tr)
    if ang > 1e-9:
        w = w / max(math.sin(ang), 1e-12) * ang
    return np.concatenate([[log_s], w, t])


def _vec_to_sim(v: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    s = math.exp(v[0])
    w = v[1:4]
    ang = np.linalg.norm(w)
    if ang < 1e-12:
        R = np.eye(3)
    else:
        k = w / ang
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + math.sin(ang) * K + (1 - math.cos(ang)) * (K @ K)
    return s, R, v[4:7]


def solve_pose_graph(n_blocks: int, edges: Sequence[Tuple[int, int, np.ndarray]]):
    """Linear pose-graph LS: find per-block 7-vectors xi_b (xi_0 = 0)
    minimizing sum ||xi_b - xi_a - tau_ab||^2 over edges (a, b, tau_ab)."""
    if n_blocks == 1:
        return np.zeros((1, 7))
    m = n_blocks - 1  # unknowns: blocks 1..B-1
    A = np.zeros((7 * len(edges), 7 * m))
    rhs = np.zeros(7 * len(edges))
    for e, (a, b, tau) in enumerate(edges):
        r = slice(7 * e, 7 * e + 7)
        if b > 0:
            A[r, 7 * (b - 1) : 7 * b] = np.eye(7)
        if a > 0:
            A[r, 7 * (a - 1) : 7 * a] -= np.eye(7)
        rhs[r] = tau
    xi, *_ = np.linalg.lstsq(A, rhs, rcond=None)
    return np.concatenate([np.zeros((1, 7)), xi.reshape(m, 7)], axis=0)


def _apply_similarity_to_block(res: DenseResult, sub: SubBlock, s, R, t):
    """Map a block solution into the global frame.

    Positions/points: x' = s R x + t.  Attitudes: R_cam' = R_cam R^T
    (world rotated by R leaves camera-frame rays identical after the
    inverse rotation).  Euler extraction matches rotation_matrix():
    R[2,0]=sin(phi), omega=atan2(-R[2,1],R[2,2]), kappa=atan2(-R[1,0],R[0,0])."""
    from fish_eye_bundle_adjustment_tpu_torch.models.projection import rotation_matrix

    lay = res.layout
    x = res.x
    eop = x[: lay.eop_size].reshape(-1, 6).copy()
    pts = x[lay.tie_offset :].reshape(-1, 3).copy()
    eop[:, :3] = (s * (R @ eop[:, :3].T)).T + t
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    for i in range(eop.shape[0]):
        Rc = rotation_matrix(f64(eop[i, 3]), f64(eop[i, 4]), f64(eop[i, 5])).numpy()
        Rn = Rc @ R.T
        eop[i, 3] = math.atan2(-Rn[2, 1], Rn[2, 2])
        eop[i, 4] = math.asin(np.clip(Rn[2, 0], -1.0, 1.0))
        eop[i, 5] = math.atan2(-Rn[1, 0], Rn[0, 0])
    pts = (s * (R @ pts.T)).T + t
    return eop, pts


def fuse_block_points(problem: BAProblem, subs: Sequence[SubBlock],
                      mapped_pts: Sequence[np.ndarray]) -> np.ndarray:
    """Fuse per-block tie-point estimates (already mapped into the global
    frame) into one (n_targets, 3) table.

    Each block's estimate of a shared target is weighted by the block's
    OWN observation count of that target — a block triangulating a point
    from 40 rays dominates one that saw it twice.  Targets no block
    estimated keep their input coordinates."""
    n_tgt = problem.n_targets
    pt_acc = np.zeros((n_tgt, 3))
    pt_w = np.zeros(n_tgt)
    for sb, pts_b in zip(subs, mapped_pts):
        blk_counts = np.bincount(
            sb.problem.obs_pt, minlength=sb.problem.n_targets
        ).astype(np.float64)
        w = np.maximum(blk_counts[sb.problem.tie_target_idx], 1.0)
        pt_acc[sb.tie_tgt_global] += pts_b * w[:, None]
        pt_w[sb.tie_tgt_global] += w
    return np.where(
        pt_w[:, None] > 0, pt_acc / np.maximum(pt_w, 1.0)[:, None],
        problem.cnt_xyz,
    )


def _load_before_threads():
    """Load, once and in this thread, what the block solves' threads would
    otherwise load for the first time at once: the kernel library, and
    PyTorch's CUDA linear algebra, whose lazy loader raises "lazy wrapper
    should be called at most once" when two threads reach it together."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    _build.load()
    torch.linalg.inv_ex(torch.eye(2, device="cuda"))


def _solve_blocks(subs, options, block_solver, parallel_blocks, device):
    """Run the per-partition free-network solves.  Blocks are independent
    (the merge happens afterwards): one after the other on `device`, or,
    with parallel_blocks on the cards, one worker thread per visible
    card, card k solving blocks k, k + cards, ... one after the other, so
    no two blocks share a card at once (a device with an index keeps
    every block on it).  The kernels' launch counters are not valid after
    concurrent block solves."""
    # block covariances are never used (the merge consumes x only)
    kw = dict(options=options, keep_history=False, compute_covariance=False)
    n = torch.cuda.device_count() if device.type == "cuda" and device.index is None else 1
    if n == 1 or not parallel_blocks or len(subs) == 1:
        return [block_solver(sb.problem, device=device, **kw) for sb in subs]
    import concurrent.futures

    _load_before_threads()

    def run(k):
        dev = torch.device("cuda", k)
        with torch.cuda.device(dev):
            return [(i, block_solver(subs[i].problem, device=dev, **kw))
                    for i in range(k, len(subs), n)]

    with concurrent.futures.ThreadPoolExecutor(max_workers=min(len(subs), n)) as ex:
        done = dict(pair for card in ex.map(run, range(min(len(subs), n))) for pair in card)
    return [done[i] for i in range(len(subs))]


def merge_blocks(problem: BAProblem, subs: Sequence[SubBlock], results: Sequence[DenseResult],
                 min_shared: int = 3):
    """The block solutions merged in the global (block 0) frame: (eop
    (n_img, 6), points (n_targets, 3), edges) -- relative similarities of
    the block pairs sharing at least `min_shared` tie points, the pose
    graph over them, each block mapped by its similarity, the points
    fused."""
    # block-pair relative similarities from shared target estimates
    est_pts = []
    for sb, res in zip(subs, results):
        lay = res.layout
        est_pts.append(res.x[lay.tie_offset :].reshape(-1, 3))

    B = len(subs)
    edges = []
    for a in range(B):
        set_a = {t: i for i, t in enumerate(subs[a].tie_tgt_global)}
        for b in range(a + 1, B):
            shared = [
                (set_a[t], j)
                for j, t in enumerate(subs[b].tie_tgt_global)
                if t in set_a
            ]
            if len(shared) < min_shared:
                continue
            ia = np.array([p[0] for p in shared])
            ib = np.array([p[1] for p in shared])
            # T_ab maps block-b coordinates into block-a's frame
            s, R, t = umeyama(est_pts[b][ib], est_pts[a][ia])
            edges.append((a, b, _sim_to_vec(s, R, t)))

    xi = solve_pose_graph(B, edges)

    # map every block into the global (block-0) frame and fuse
    n_img = problem.n_img
    eop_acc = np.zeros((n_img, 6))
    eop_w = np.zeros(n_img)
    mapped_pts = []
    for b, (sb, res) in enumerate(zip(subs, results)):
        s, R, t = _vec_to_sim(xi[b])
        eop_b, pts_b = _apply_similarity_to_block(res, sb, s, R, t)
        eop_acc[sb.img_idx] += eop_b  # each image lives in exactly one block
        eop_w[sb.img_idx] += 1.0
        mapped_pts.append(pts_b)
    eop = eop_acc / np.maximum(eop_w, 1.0)[:, None]
    points = fuse_block_points(problem, subs, mapped_pts)

    return eop, points, edges


@dataclasses.dataclass
class PoseGraphResult:
    eop: np.ndarray  # (n_img, 6) merged global pose estimates
    points: np.ndarray  # (n_targets, 3) merged target estimates
    block_results: List[DenseResult]
    edges: List[Tuple[int, int, np.ndarray]]
    refined: Optional[DenseResult] = None


def solve_posegraph(
    problem: BAProblem,
    n_blocks: int,
    options: Optional[SchurOptions] = None,
    refine: bool = True,
    refine_mesh=None,
    min_shared: int = 3,
    block_solver=solve_schur,
    parallel_blocks: bool = False,
    compute_covariance: bool = True,
    device=None,
) -> PoseGraphResult:
    """Partition -> block solves -> similarity pose-graph merge -> refine,
    on `device` (None: the CUDA cards; "cpu" when asked).

    The block solves (`block_solver(problem, device=..., **kw)`) run one
    after the other on `device`.  `parallel_blocks=True` runs them one
    worker thread per visible card, block i on cuda:(i mod cards), a
    card's blocks one after the other (the kernels' launch counters are
    not valid after it).  It is off by default, where the JAX package's is
    on: the solves share one Python process, and on the 1k-image bench
    block's four host-bound blocks the threads took 17.6-20.5 s against
    7.3-7.5 s one after the other over the same 4 cards
    (bench_torch_parallel.py posegraph, H100).  The refine is
    solve_schur on `device`, or solve_schur_distributed over `refine_mesh`
    (a Mesh of the ranks that call this alike)."""
    dev = resolve_device(device, "solve_posegraph")
    parts = partition_images(problem, n_blocks)
    subs = [extract_block(problem, p) for p in parts]
    results = _solve_blocks(subs, options, block_solver, parallel_blocks, dev)

    eop, points, edges = merge_blocks(problem, subs, results, min_shared)
    out = PoseGraphResult(eop=eop, points=points, block_results=results, edges=edges)
    if refine:
        layout = ParamLayout(problem)
        tie0 = points[problem.tie_target_idx]
        # warm-start IOPs from the blocks' own calibration estimates when
        # the blocks ran self-calibrating (IOPs are similarity-invariant,
        # so an observation-weighted average across blocks is the natural
        # fusion); fall back to the input calibration otherwise
        iop_init = problem.iop0.copy()
        if results and results[0].layout.n_iop:
            acc = np.zeros_like(iop_init)
            wsum = 0.0
            for res in results:
                lb = res.layout
                full = lb.problem.iop0.copy()
                full[:, lb.iop_cols] = res.x[
                    lb.iop_offset : lb.tie_offset
                ].reshape(lb.n_cam, lb.n_iop)
                w = float(lb.problem.n_obs)
                acc += w * full
                wsum += w
            iop_init = acc / wsum
        x0 = layout.pack(eop, iop_init, tie0)
        if refine_mesh is not None:
            from fish_eye_bundle_adjustment_tpu_torch.parallel.dist_schur import (
                solve_schur_distributed,
            )

            out.refined = solve_schur_distributed(
                problem, refine_mesh, options=options, keep_history=False,
                x0=x0, compute_covariance=compute_covariance,
            )
        else:
            out.refined = solve_schur(
                problem, options=options, keep_history=False, x0=x0,
                compute_covariance=compute_covariance, device=dev,
            )
    return out
