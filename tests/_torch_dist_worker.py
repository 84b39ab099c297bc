"""Rank workers of the port's torch.distributed parity tests
(tests/test_torch_mesh.py, test_torch_dist_schur.py,
test_torch_sharded_state.py, test_torch_fusedshard.py).

The ranks are processes that parallel.mesh.run_ranks spawns: they import
this module, torch and the port, never jax.  A test module starts one
group of ranks (`run_group`) for all of its cases; every rank runs the
same cases in the same order and rank 0's results (numpy) come back to
the test, which holds them against the JAX package's.
"""

import sys

import numpy as np
import torch

# seconds a group of ranks may take, and one collective
GROUP_TIMEOUT_S = 240.0
COLLECTIVE_TIMEOUT_S = 60.0


def run_group(n_ranks, cases):
    """Run `cases` ({name: (function name, keyword arguments)}) on
    `n_ranks` gloo ranks on the CPU; {name: rank 0's result}."""
    from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import run_ranks

    return run_ranks(_run_cases, n_ranks, "cpu", args=(cases,), timeout_s=GROUP_TIMEOUT_S,
                     collective_timeout_s=COLLECTIVE_TIMEOUT_S)


def _run_cases(mesh, cases):
    return {name: globals()[fn](mesh, **kw) for name, (fn, kw) in cases.items()}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _opts(kw):
    from fish_eye_bundle_adjustment_tpu_torch.solver.schur import SchurOptions

    return SchurOptions(**kw)


# -- the communicator and the sharded plans ---------------------------------

def collectives(mesh):
    """Each collective on rank-dependent float64 and float32 inputs, and
    the counts they leave."""
    r = mesh.index
    mesh.reset_counts()
    x = torch.arange(12, dtype=torch.float64).reshape(6, 2) * (r + 1) + r
    s = torch.tensor(0.5 * (r + 1), dtype=torch.float32)
    out = dict(
        psum=_np(mesh.psum(x)), psum_0d=_np(mesh.psum(s)),
        psum_scatter=_np(mesh.psum_scatter(torch.cat([x] * mesh.size))),
        all_gather=_np(mesh.all_gather(x[: r + 1 if mesh.size == 1 else 2])),
    )
    out["counts"] = {k: dict(v) for k, v in mesh.counts.items()}
    out["size"], out["index"] = mesh.size, mesh.index
    out["jax_loaded"] = sorted(k for k in sys.modules if k == "jax" or k.startswith((
        "jax.", "fish_eye_bundle_adjustment_tpu.")))
    return out


def dual_axis_sums(mesh, primary, n_primary, secondary, n_secondary, vals):
    """This rank's build_sharded plan summed over its slice, completed by
    psum: (primary sums, secondary sums)."""
    from fish_eye_bundle_adjustment_tpu_torch.ops.segment import DualAxisPlan

    plan = DualAxisPlan.build_sharded(primary, n_primary, secondary, n_secondary,
                                      mesh.size, mesh.index)
    m = len(primary) // mesh.size
    v = torch.as_tensor(vals[mesh.index * m : (mesh.index + 1) * m])
    return _np(mesh.psum(plan.primary_sum(v))), _np(mesh.psum(plan.secondary_sum(v)))


def tie_sums(mesh, tie_sorted, n_tie, vals):
    """LocalTieOps.segsum on this rank's slice (padded to one chunk), its
    owned rows gathered into the global (n_tie, k) table."""
    from fish_eye_bundle_adjustment_tpu_torch.ops.segment import CHUNK
    from fish_eye_bundle_adjustment_tpu_torch.parallel.tieshard import (
        LocalTieOps,
        build_tie_shard,
    )

    plan = build_tie_shard(tie_sorted, n_tie, mesh.size)
    m = len(tie_sorted) // mesh.size
    n_loc = -(-m // CHUNK) * CHUNK
    ops = LocalTieOps(plan.shard(mesh.index, "cpu", n_loc), mesh)
    v = torch.zeros((n_loc, vals.shape[1]), dtype=torch.float64)
    v[:m] = torch.as_tensor(vals[mesh.index * m : (mesh.index + 1) * m])
    local = ops.segsum(v)
    return _np(ops.gather_global(local[: ops.L])), _np(ops.expand(local)[:m])


def peer_inputs(rank, size, dtype, seed=0):
    """Rank `rank`'s inputs of the peer-collective cases, by name: (op,
    array); "below" and "above" are all-reduces on either side of
    ops/peercoll.TWO_SHOT_BYTES (one-shot, two-shot) in float32 and
    float64, lengths no multiple of the ranks times a 16-byte group; the
    "big" ones pass a 4 MiB half (PEER_CHUNKED_BYTES), so they run in
    chunks there, the last one ragged.  Every rank makes every rank's from
    the seed, so the test can."""
    g = np.random.default_rng([seed, rank])
    r = lambda *shape: (g.standard_normal(shape) * 10.0 ** g.integers(-3, 4, shape)).astype(dtype)
    return {
        "scalar": ("all_reduce", r()),
        "vector": ("all_reduce", r(7)),
        "below": ("all_reduce", r(20_001)),
        "above": ("all_reduce", r(100_003)),
        "big": ("all_reduce", r(1_300_001)),
        "blocks": ("reduce_scatter", r(size * 3, 2, 5)),
        "big_scatter": ("reduce_scatter", r(size * 700_001)),
        "rows": ("all_gather", r(3, 2)),
        "big_gather": ("all_gather", r(700_001, 2)),
    }


# 4 MiB halves: the "big" peer cases run in chunks at them
PEER_CHUNKED_BYTES = 4 << 20


def peer_plain(mesh, seed=0):
    """The plain peer collectives (ops/peercoll.py, CPU tensors) on this
    rank's inputs, in float32 and float64, with halves of
    PEER_CHUNKED_BYTES: {(name, dtype): (result, plain calls)}."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll

    comm = peercoll.PeerComm("cpu", mesh.index, mesh.size, workspace_bytes=PEER_CHUNKED_BYTES)
    out = {}
    for dtype in ("float32", "float64"):
        for name, (op, x) in peer_inputs(mesh.index, mesh.size, dtype, seed).items():
            peercoll.reset_counts()
            got = getattr(peercoll, op)(torch.as_tensor(x), comm)
            out[(name, dtype)] = (_np(got), peercoll.plain_calls[f"peer_{op}"])
    return out


# -- the three solvers ---------------------------------------------------------

_STEPS = {
    "distributed": ("fish_eye_bundle_adjustment_tpu_torch.parallel.dist_schur",
                    "make_distributed_step"),
    "sharded": ("fish_eye_bundle_adjustment_tpu_torch.parallel.sharded_state",
                "make_sharded_camera_step"),
    "fused": ("fish_eye_bundle_adjustment_tpu_torch.parallel.fusedshard",
              "make_fused_sharded_step"),
}
_SOLVES = {
    "distributed": ("fish_eye_bundle_adjustment_tpu_torch.parallel.dist_schur",
                    "solve_schur_distributed"),
    "sharded": ("fish_eye_bundle_adjustment_tpu_torch.parallel.sharded_state",
                "solve_schur_sharded_state"),
    "fused": ("fish_eye_bundle_adjustment_tpu_torch.parallel.fusedshard",
              "solve_schur_fused_sharded"),
}


def _fn(table, mode):
    import importlib

    mod, name = table[mode]
    return getattr(importlib.import_module(mod), name)


def step(mesh, mode, problem, opts, xs, lams, cg_tol, **kw):
    """One GN step of `mode` at each x of `xs` and each lam of `lams`:
    [(x_trial, L1(delta), stats, cg iterations, residual rows in the
    stream's order)] (the fused mode's rows: the concatenated windows)."""
    from fish_eye_bundle_adjustment_tpu_torch.parallel.dist_schur import gather_v

    fn, data, layout, _ = _fn(_STEPS, mode)(problem, mesh, _opts(opts), **kw)
    out = []
    for x in xs:
        for lam in lams:
            xt = torch.as_tensor(np.asarray(x), device=mesh.device)
            x1, d, v, stats, cg = fn(xt, data, cg_tol, lam)
            if mode == "fused":
                rows = _np(mesh.all_gather(v))
            else:
                rows = gather_v(mesh, v, problem.n_obs)
            out.append((_np(x1), float(d), _np(stats), int(cg), rows))
    return out


def solve(mesh, mode, problem, opts, **kw):
    """A whole solve of `mode`, the collectives it made, and its driver
    (the device loop leaves solver/device_loop.loop_counts)."""
    from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop

    mesh.reset_counts()
    device_loop.loop_counts.clear()
    r = _fn(_SOLVES, mode)(problem, mesh, _opts(opts), **kw)
    return dict(x=r.x, iterations=r.iterations, converged=r.converged,
                stopped_on=r.stopped_on, sigma02=r.sigma02, v=r.v, rms=r.rms,
                cg_iterations=r.cg_iterations, std=r.std, std_method=r.std_method,
                counts={k: dict(v) for k, v in mesh.counts.items()},
                driver="device loop" if device_loop.loop_counts else "host loop")


def fused_partials(problem, opts, n_shards):
    """K1 and K2 (plain versions, on the CPU) on each window of the
    problem's band plan split over `n_shards`, each window folded from its
    own rows (fusedshard.window_streams) with the unsharded Hpp^-1 of its
    ranks, at x0: the camera-side outputs summed over the windows, the
    unsharded operator's (the solver's own factor), and each window's
    index.  No rank group: the windows one after another."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import fusedmv
    from fish_eye_bundle_adjustment_tpu_torch.ops.bandplan import split_band_plan
    from fish_eye_bundle_adjustment_tpu_torch.parallel import fusedshard
    from fish_eye_bundle_adjustment_tpu_torch.solver.schur import (
        ObsData,
        SchurKernel,
        make_band_plan,
    )
    from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

    o = _opts(opts)
    layout = ParamLayout(problem)
    plan = make_band_plan(problem, layout, o)
    kern = SchurKernel(layout, o)
    x = torch.as_tensor(layout.initial().astype(np.float32))
    q = x * layout.scale_like(x)
    rng = np.random.default_rng(3)
    vpose = torch.as_tensor(rng.standard_normal((8, plan.n_img_pad)).astype(np.float32))
    vi = torch.as_tensor(rng.standard_normal(128).astype(np.float32))
    ne, ni = kern.ne, kern.ni

    obs = ObsData.from_problem(problem, layout, plan, dtype=np.float32, device="cpu")
    fac = kern.linearize(q, obs, lam=torch.zeros(()))
    whole = _fused_outputs(fusedmv, obs.band, fac.acam_t, fac.apt_t, fac.hpi_t, ne, ni,
                           vpose, vi, fac._fused_arows())
    sp = split_band_plan(plan, n_shards)
    n_rank = sp.G_loc * sp.M
    hpi = torch.nn.functional.pad(fac.hpi_t, (0, sp.rank_pad - fac.hpi_t.shape[1]))
    summed, index = None, []
    for d in range(n_shards):
        data = fusedshard.build_fused_shard_data(problem, layout, sp, d, "cpu")
        index.append({k: _np(getattr(data.band, k)) for k in (
            "row_group", "tie_off", "col_perm", "col_off", "cover_off", "cover_ids")})
        _, acam_t, apt_t, a_rows = fusedshard.window_streams(kern, q, data.obs)
        h = hpi[:, d * n_rank : (d + 1) * n_rank].contiguous()
        part = _fused_outputs(fusedmv, data.band, acam_t, apt_t, h, ne, ni, vpose, vi, a_rows)
        summed = part if summed is None else {k: summed[k] + part[k] for k in part}
    return dict(whole=whole, summed=summed, index=index, sp=sp, plan=plan,
                whole_index={k: _np(getattr(obs.band, k)) for k in index[0]})


def _fused_outputs(fusedmv, band, acam_t, apt_t, hpi_t, ne, ni, vpose, vi, a_rows):
    """The camera-side outputs of K1 and K2's modes on one band."""
    _, de, di = fusedmv.fused_hpp_pass(band, acam_t, apt_t, ne, ni, precision="bf16x2")
    mv = fusedmv.fused_schur_apply(band, acam_t, apt_t, hpi_t, ne, ni, vpose=vpose, vi=vi,
                                   precision="bf16")
    pre = fusedmv.fused_schur_apply(band, acam_t, apt_t, hpi_t, ne, ni, a_rows=a_rows,
                                    with_precond=True, precision="bf16x2")
    back = fusedmv.fused_schur_apply(band, acam_t, apt_t, hpi_t, ne, ni, vpose=vpose,
                                     vi=vi, a_rows=a_rows, precision="bf16x2")
    out = dict(de=de, di=di, mv_pose=mv[0], mv_iop=mv[1], rhs_pose=pre[0], rhs_iop=pre[1],
               p21=pre[3], i55=pre[4], back_pose=back[0], back_iop=back[1])
    return {k: _np(v).astype(np.float64) for k, v in out.items()}


def mesh_stds(mesh, problem, x, sigma02, n_probe, seed=0):
    """estimate_schur_stds over the mesh, and the K4 launches it made."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import prefix
    from fish_eye_bundle_adjustment_tpu_torch.solver.covariance import estimate_schur_stds
    from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

    prefix.reset_counts()
    mesh.reset_counts()
    std = estimate_schur_stds(problem, ParamLayout(problem), x, sigma02, n_probe=n_probe,
                              seed=seed, mesh=mesh)
    return dict(std=std, plain_k4=prefix.plain_calls["chunk_prefix"],
                counts={k: dict(v) for k, v in mesh.counts.items()})
