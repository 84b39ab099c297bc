"""Distributed Schur solver: the observation stream split over the ranks.

PyTorch port of fish_eye_bundle_adjustment_tpu/parallel/dist_schur.py.

- each rank holds one contiguous slice of the observation stream (the
  JAX package's shards: the stream cut into equal slices), padded on its
  own to whole segment-sum chunks, with the plans of its own rows
  (ObsData.from_problem(..., n_shards, shard));
- the camera and point state (the unknowns, Hpp, the preconditioner
  blocks, the CG vectors) is replicated: every segment sum over the
  stream is followed by an all-reduce over the ranks (the kernel's
  reduce_fn), the only collectives of the step;
- the CG runs in lockstep on every rank on equal replicated iterates, and
  the GN loop's decisions are taken on all-reduced values, so every rank
  takes the same branch: the host loop's on the host, the device loop's
  on the device (its one packed read a chunk is equal on every rank).

Each rank calls solve_schur_distributed with the same problem and its
Mesh (parallel/mesh.py) and returns the same result: the residual rows
are gathered once, after the loop.  The ranks may span hosts, as in the
JAX package's multi-process mode (init_distributed(coordinator, n, rank),
then solve_schur_distributed(problem, make_mesh())): each collective then
runs in two levels, peer kernels inside a host and NCCL between hosts,
and the host loop drives the solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import Mesh, make_mesh
from fish_eye_bundle_adjustment_tpu_torch.solver.constraints import validate_inner_constraints
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import DenseResult
from fish_eye_bundle_adjustment_tpu_torch.solver.schur import (
    ObsData,
    SchurKernel,
    SchurOptions,
    _finalize,
    drive,
    schur_step_fn,
    shard_rows,
    unpermute_v,
)
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout


def shard_obs(problem: BAProblem, layout: ParamLayout, mesh: Mesh,
              options: SchurOptions) -> ObsData:
    """This rank's slice of the unfused stream on its device, as the JAX
    package's multi-process shard_obs materializes only a host's rows."""
    return ObsData.from_problem(
        problem, layout, None, dtype=options.dtype, device=mesh.device,
        obs_order=options.obs_order, n_shards=mesh.size, shard=mesh.index,
    )


def gather_v(mesh: Mesh, v_local, n_obs: int):
    """Every rank's residual rows -> the stream's (n_obs, 2) rows in stream
    order, equal on every rank: one all_gather.  A rank's live rows are
    the first of its slice (shard_rows)."""
    m, _ = shard_rows(n_obs, mesh.size)
    allv = mesh.all_gather(v_local).cpu().numpy().reshape(mesh.size, -1, 2)
    return np.concatenate([allv[r, : max(0, min(m, n_obs - r * m))]
                           for r in range(mesh.size)])


def make_distributed_step(problem: BAProblem, mesh: Mesh,
                          options: Optional[SchurOptions] = None):
    """Build (step_fn, obs, layout, order) for this rank.  step_fn(x, obs,
    cg_tol, lam) is one GN iteration over the mesh: replicated (x_trial,
    L1(delta), stats, cg_iters), and this rank's residual rows; `order`
    is the host order of the whole stream."""
    opts = options or SchurOptions()
    layout = ParamLayout(problem)
    use_ic = problem.settings.inner_constraints
    if use_ic:
        validate_inner_constraints(layout)
    obs = shard_obs(problem, layout, mesh, opts)
    kernel = SchurKernel(layout, opts, reduce_fn=mesh.psum)
    step = schur_step_fn(kernel, layout, use_ic)
    order = ObsData.stream_order(problem, layout, opts.dtype, opts.obs_order)
    return step, obs, layout, order


def run_distributed(problem, mesh, opts, step, obs, layout, order, keep_history,
                    x0, progress_fn, checkpoint_path, checkpoint_every,
                    compute_covariance, v_rows=None, n_pad=None) -> DenseResult:
    """The GN loop over a distributed step -- the device loop unless
    keep_history or device_loop=False, the JAX package's rule
    (schur.use_device_loop) at every rank count, or a mesh that spans
    hosts (the host loop: its cross-host NCCL calls do not capture) --
    then the result every
    rank returns: the residual rows gathered and unpermuted, the stds
    (with the mesh) when asked.  Progress and checkpoints are rank 0's.
    `n_pad` is the rank's residual rows when `obs` has no W."""
    writer = mesh.index == 0
    (x, history, delta_history, v_local, stats, count, converged,
     elapsed, stopped_on), cg_iterations = drive(
        step, obs, layout, problem, opts, keep_history,
        writes_checkpoints=writer, n_pad=n_pad, mesh=mesh,
        x0=x0, progress_fn=progress_fn if writer else None,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        device=mesh.device,
    )
    v_np = v_rows(v_local) if v_rows else unpermute_v(
        torch.as_tensor(gather_v(mesh, v_local, problem.n_obs)), order, problem.n_obs)
    mesh.check()  # the rows came back to the host: every collective has ended
    result = _finalize(
        problem, layout, x, history, delta_history, v_np,
        stats.double().cpu().numpy(), count, converged, elapsed,
        keep_history, stopped_on,
    )
    result.cg_iterations = cg_iterations
    if compute_covariance:
        # the exact block covariance below the dense-S gate (each rank
        # alike), the Hutchinson estimate's probe solves over the mesh past it
        from fish_eye_bundle_adjustment_tpu_torch.solver.covariance import compute_stds

        std, Cc_q, method = compute_stds(problem, layout, result.x, result.sigma02,
                                         mesh=mesh, device=mesh.device)
        if std is not None:
            result.std = std
            result.Cc_q = Cc_q
            result.std_method = method
    return result


def solve_schur_distributed(
    problem: BAProblem,
    mesh: Optional[Mesh] = None,
    options: Optional[SchurOptions] = None,
    keep_history: bool = False,
    x0=None,
    progress_fn=None,
    checkpoint_path=None,
    checkpoint_every: int = 1,
    compute_covariance: bool = False,
) -> DenseResult:
    """The distributed counterpart of solve_schur: same conventions and,
    by construction, the same arithmetic up to the order of the sums.
    Every rank of `mesh` (default: make_mesh()) calls it and gets the same
    result.  The device loop drives it by default (run_distributed).

    `compute_covariance` defaults off, as in the JAX package: past the
    dense-S gate the stds take 3k + n_probe solves (over the mesh here);
    the CLI turns it on when it writes a report."""
    opts = options or SchurOptions()
    mesh = mesh if mesh is not None else make_mesh()
    step, obs, layout, order = make_distributed_step(problem, mesh, opts)
    return run_distributed(problem, mesh, opts, step, obs, layout, order, keep_history,
                           x0, progress_fn, checkpoint_path, checkpoint_every,
                           compute_covariance)
