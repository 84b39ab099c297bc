"""Synthetic blocks shared by the PyTorch-port parity tests
(tests/test_torch_*.py): each is made once by the JAX package's
generator and handed to both packages as the same arrays."""

import dataclasses

import numpy as np
import pytest
import torch

SELFCAL = dict(
    estimate_c=True, estimate_xp=True, estimate_yp=True,
    estimate_radial=True, estimate_decent=True,
)

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread for the module that imports this
    (restored after it).  The parity tests run six pytest workers on a few
    cores; with torch's default pool (a thread a core in each worker) the
    pools spin against each other in every small op: one small solve test
    took 220 s beside five copies of itself, and 18 s with one thread
    each.  The tolerances do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name -> make_block keyword arguments (the sizes of tests/test_fusedmv.py)
BLOCKS = {
    "eop12": dict(n_img=12, n_pts=150, seed=13, control_frac=0.08,
                  settings_overrides={"inner_constraints": False}),
    "selfcal16": dict(n_img=16, n_pts=250, seed=11, control_frac=0.05,
                      settings_overrides={"inner_constraints": False, **SELFCAL}),
    "ic12": dict(n_img=12, n_pts=150, seed=5, control_frac=0.0,
                 settings_overrides={"inner_constraints": True}),
    # 4 of 6 EOPs and 2 IOPs: the operator's row offsets for ne < 6
    "partial12": dict(n_img=12, n_pts=150, seed=7, control_frac=0.08,
                      settings_overrides={"inner_constraints": False,
                                          "estimate_w": False, "estimate_p": False,
                                          "estimate_c": True, "estimate_xp": True}),
    # three cameras round-robin over the images, each self-calibrating:
    # per-camera IOP gathers and camera-axis segment sums
    "cam3_12": dict(n_img=12, n_pts=150, n_cams=3, seed=41, control_frac=0.08,
                    settings_overrides={"inner_constraints": False, **SELFCAL}),
}


def jax_block(name, **settings):
    """The JAX package's BAProblem for BLOCKS[name], fisheye model, with
    `settings` added to its settings overrides."""
    from fish_eye_bundle_adjustment_tpu.synth import make_block

    kw = dict(BLOCKS[name])
    kw["settings_overrides"] = {**kw["settings_overrides"], **settings}
    return make_block(model="fisheye", **kw).problem


def lm_block(scale=420.0, iteration_cap=4):
    """selfcal16 with every tie point's initial coordinates moved by a
    seeded N(0, scale m).  At the defaults the first GN step raises the
    weighted SSR and is rejected, and the LM controller damps the next
    ones (capped at 4 iterations; the solve does not converge in them)."""
    p = jax_block("selfcal16", iteration_cap=iteration_cap)
    c = p.cnt_xyz.copy()
    rng = np.random.default_rng(0)
    c[p.tie_target_idx] += rng.normal(scale=scale, size=(p.n_tie, 3))
    return dataclasses.replace(p, cnt_xyz=c)


def to_port(problem):
    """The same problem as the port's BAProblem."""
    from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem

    return BAProblem.from_arrays(dataclasses.asdict(problem))


def _stress_stream(name):
    """(tie per observation -- n_tie for control --, image per observation,
    n_tie, n_img, build_band_plan keywords) of each stress stream."""
    rng = np.random.default_rng(5)
    if name == "one_column":
        # every tie seen once, all by image 5: each group's rows in one column
        n_tie, n_img = 300, 8
        return np.arange(n_tie), np.full(n_tie, 5), n_tie, n_img, dict(M=128)
    if name == "one_tie_span":
        # tie 0 seen by all 600 images; with two ties a group, its run
        # holds nearly the whole span of its group
        n_tie, n_img = 200, 600
        others = np.repeat(np.arange(1, n_tie), 3)
        imgs = np.clip(others * 3 + rng.integers(-2, 3, others.size), 0, n_img - 1)
        tie = np.concatenate([np.zeros(n_img, np.int64), others])
        img = np.concatenate([np.arange(n_img), imgs])
        return tie, img, n_tie, n_img, dict(M=2, max_W=1024)
    if name == "empty_groups":
        # 128 of 512 ties observed (6 groups without rows), then control rows
        # (camera-only tail groups)
        n_tie, n_img = 512, 40
        tie = np.repeat(np.arange(128), 4)
        img = (tie // 4 + np.tile(np.arange(4), 128)) % n_img
        ctrl = rng.integers(0, n_img, 50)
        return (np.concatenate([tie, np.full(50, n_tie)]), np.concatenate([img, ctrl]),
                n_tie, n_img, dict(M=64))
    if name == "widest_W":
        # 32640 = the widest 128-aligned band below the kernels' 32768 limit:
        # tie 64, seen by the first and the last image, gets a group of its
        # own (images kept in their order: renumbering would close the gap)
        n_tie, n_img = 65, 32640
        tie = np.concatenate([np.repeat(np.arange(64), 2), [64, 64]])
        img = np.concatenate([np.arange(128), [0, n_img - 1]])
        return tie, img, n_tie, n_img, dict(M=64, max_W=n_img, try_image_reorder=False)
    if name == "caps":
        # the band plan's caps, M = 128: two groups of 128 ties, each tie seen
        # by 128 images of its group's 2048, so each group spans T = 16384
        # rows over a band of W = 2048 images
        n_tie, per, n_img = 256, 128, 4096
        tie = np.repeat(np.arange(n_tie), per)
        img = (tie // 128) * 2048 + ((tie % 128) * 16 + np.tile(np.arange(per), n_tie)) % 2048
        return tie, img, n_tie, n_img, dict(M=128)
    raise KeyError(name)


STRESS = ("one_column", "one_tie_span", "empty_groups", "widest_W")
CAPS = "caps"  # card tests only: its brute-force index check would take minutes


def stress_plan(name):
    """The port's band plan of a stress stream (no JAX needed)."""
    from fish_eye_bundle_adjustment_tpu_torch.ops.bandplan import build_band_plan

    tie, img, n_tie, n_img, kw = _stress_stream(name)
    return build_band_plan(np.asarray(tie), np.asarray(img), n_tie, n_img, **kw)


def stress_streams(plan, ne=6, ni=6, seed=0):
    """Random folded streams (acam_t, apt_t, hpi_t) and operator inputs
    (vpose, vi, a_rows) at a plan's shapes, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    ca = -(-2 * (ne + ni) // 8) * 8
    return dict(acam_t=f32(ca, plan.n_pad), apt_t=f32(8, plan.n_pad),
                hpi_t=f32(16, plan.G * plan.M), vpose=f32(8, plan.n_img_pad),
                vi=f32(128), a_rows=f32(8, plan.n_pad))


def jax_dist_run(make_step, problem, n_dev, opts, xs=(), lams=(0.0,), cg_tol=1e-2,
                 solve=True, **kw):
    """A JAX distributed solver's step at each x of `xs` and lam of `lams`
    ([(x_trial, L1(delta), stats, cg iterations, residual rows)]), then,
    with `solve`, its whole solve: the body of solve_schur_distributed
    (and of its sharded-state and fused twins) at device_loop=False -- the
    host loop over the same step, so each block and mode compiles once.
    `make_step` is make_distributed_step, make_sharded_camera_step or
    make_fused_sharded_step; `kw` goes to it.  The residual rows are in
    the stream's order (the fused mode's: the concatenated windows), the
    solve's in report order."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fish_eye_bundle_adjustment_tpu.parallel.mesh import make_mesh
    from fish_eye_bundle_adjustment_tpu.solver import schur as jschur

    mesh = make_mesh(n_dev)
    step, data, layout, extra = make_step(problem, mesh, opts, **kw)
    dt = np.dtype(opts.dtype)
    steps = []
    for x in xs:
        for lam in lams:
            x1, d, v, stats, cg = step(jnp.asarray(np.asarray(x, dt)), data,
                                       jnp.asarray(cg_tol, dt), jnp.asarray(lam, dt))
            steps.append((np.asarray(x1), float(d), np.asarray(stats), int(cg),
                          np.asarray(v).reshape(-1, 2)))
    if not solve:
        return steps, None
    (x, history, delta_history, v_shard, stats, count, converged,
     elapsed, stopped_on) = jschur.run_gn_loop(
        step, data, layout, problem, opts, x_sharding=NamedSharding(mesh, P()))
    if hasattr(extra, "owned_pos"):  # the fused mode's split plan
        v_np = np.asarray(v_shard).reshape(-1, 2)[extra.owned_pos].reshape(-1)
    else:
        v_np = jschur.unpermute_v(v_shard, extra, problem.n_obs)
    res = jschur._finalize(problem, layout, x, history, delta_history, v_np,
                           np.asarray(stats), count, converged, elapsed, False, stopped_on)
    return steps, res


def rel_err(got, want):
    """Norm of the difference over the norm of `want`."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))
