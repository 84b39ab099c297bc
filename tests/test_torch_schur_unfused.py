"""The port's unfused Schur Gauss-Newton solve against the JAX package's,
on the CPU (the port's K4 chunk prefix runs as its plain version).

The JAX side runs the host-loop branch of its solve_schur with
explicit_s=False and device_loop=False -- the matrix-free unfused path
the port ports -- with a step wrapper that records each step's CG count.

Tolerances.  float64: x within rtol=1e-9, atol=1e-7 and sigma0^2 within
1e-9 relative, the same iterations, stop reason and CG count of every
step.  Both sides take the same sorted segment sums; only the summation
order inside each cumsum and dot can differ, ~1e-16 relative per step,
which the CG iterations amplify to ~1e-11 in x at worst here.  float32:
x within rtol=3e-5, atol=3e-4 (tests/test_torch_schur.py's X_TOL), step
statistics and sigma0^2 within 1e-4 relative, CG counts within 2 per
step: where the residual norm falls slowly near the CG stop tolerance, an
f32 summation order of its own moves the crossing by an iteration or two
(measured 2 on selfcal16 with fused=False and on the image-sorted eop12)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_eye_bundle_adjustment_tpu.solver import schur as jschur
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout as JLayout
from fish_eye_bundle_adjustment_tpu_torch.ops import prefix as tprefix
from fish_eye_bundle_adjustment_tpu_torch.ops import segment as tsegment
from fish_eye_bundle_adjustment_tpu_torch.ops import streamseg as tstreamseg
from fish_eye_bundle_adjustment_tpu_torch.solver import schur as tschur
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout as TLayout

from _torch_blocks import jax_block, one_torch_thread, to_port  # noqa: F401 (autouse)

F64_X_TOL = dict(rtol=1e-9, atol=1e-7)
F32_X_TOL = dict(rtol=3e-5, atol=3e-4)
NINE_IOPS = dict(estimate_c=True, estimate_xp=True, estimate_yp=True,
                 estimate_radial=True, num_radial_distortions=4,
                 estimate_decent=True)


@pytest.fixture(scope="module", autouse=True)
def _one_cg_iteration_per_trip():
    """One masked CG iteration per while-loop trip in the JAX _pcg (its
    semantics do not depend on the block size), which halves each JAX
    compile; see tests/test_torch_schur.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jschur, "_CG_UNROLL", 1)
        yield


def _opts(module, dtype, **kw):
    return module.SchurOptions(dtype=dtype, explicit_s=False, **kw)


@functools.lru_cache(maxsize=None)
def _jax_step(name, dtype, settings=(), opts=()):
    """(jitted JAX unfused step, its obs, layout, obs order) for the block,
    built as the host branch of the JAX solve_schur builds them."""
    jp = jax_block(name, **dict(settings))
    layout = JLayout(jp)
    o = _opts(jschur, dtype, device_loop=False, **dict(opts))
    kernel = jschur.SchurKernel(layout, o, obs_order=o.obs_order)
    order = (jschur.ObsData.sort_order_by_tie(jp, layout)
             if o.obs_order == "tie" else None)
    obs = jschur.ObsData.from_problem(
        jp, layout, dtype=dtype, order=order, with_plan=order is not None
    )
    assert not kernel.use_fused(obs)
    step = jax.jit(jschur.schur_step_fn(kernel, layout, jp.settings.inner_constraints))
    return step, obs, layout, order, o


def _jax_solve(name, dtype, settings=(), opts=(), loop=(), inputs=None, x0=None):
    """The JAX unfused host-loop solve from `x0` (None: the layout's
    initial point), with the CG count of each step; `inputs`, a list, gets
    each step's (x, cg_tol, lam)."""
    step, obs, layout, order, o = _jax_step(name, dtype, settings, opts)
    problem = jax_block(name, **dict(settings), **dict(loop))
    cg = []

    def counted(x, ob, tol, lam):
        out = step(x, ob, tol, lam, None)
        cg.append(int(out[4]))
        if inputs is not None:
            inputs.append((np.asarray(x), float(tol), float(lam)))
        return out

    (x, hist, dh, v, stats, count, conv, elapsed, stopped) = jschur.run_gn_loop(
        counted, obs, layout, problem, o, x0=x0
    )
    v_np = jschur.unpermute_v(v, order, problem.n_obs)
    res = jschur._finalize(problem, layout, x, hist, dh, v_np, np.asarray(stats),
                           count, conv, elapsed, False, stopped)
    return problem, res, cg


def _port_solve(problem, dtype, opts=()):
    tprefix.reset_counts()
    tstreamseg.reset_counts()
    tschur.reset_cg_counts()
    res = tschur.solve_schur(
        to_port(problem), _opts(tschur, dtype, **dict(opts)),
        compute_covariance=False, device="cpu",
    )
    return res


def _assert_k4_count(res, direct=False):
    """Single-camera blocks: sym6 + dcc in linearize, 2 in the reduced rhs,
    1 for the pose preconditioner and the back-substitution, 2 per CG
    matvec -- all through the chunk prefix, here its plain version, or
    with `direct` (float32 at obs_order "img") all through the span
    segment sum's plain version and none through the prefix.  Several
    self-calibrating cameras add the camera sums of dcc, the reduced rhs
    and the IOP preconditioner, and one per matvec.  These solves run the
    device loop (the JAX rule: no explicit dense S, no history), whose CG
    reads no flag back: masked blocks of 8 iterations at cg_maxiter = 500,
    each under its flag, 8 matvecs a block that ran, the blocks at least
    as long as the iterations they took."""
    cg = res.cg_iterations
    cgc = tschur.cg_counts
    matvecs = cgc["matvecs"]
    assert cgc["calls"] == len(cg) and cgc["host_reads"] == 0 and matvecs % 8 == 0
    assert sum(cg) <= matvecs <= sum(cg) + 8 * len(cg)
    sums = (tstreamseg.plain_calls["span_segment_sum"] if direct
            else tprefix.plain_calls["chunk_prefix"])
    per_step, per_mv = (9, 3) if res.problem.n_cam > 1 else (6, 2)
    assert sums == per_step * len(cg) + per_mv * matvecs
    assert tprefix.plain_calls["chunk_prefix"] == (0 if direct else sums)
    assert tprefix.kernel_launches["chunk_prefix"] == 0
    assert tstreamseg.kernel_launches["span_segment_sum"] == 0


def _assert_same_result(got, want, dtype):
    assert got.stopped_on == want.stopped_on
    assert got.converged == want.converged
    assert got.iterations == want.iterations
    assert got.v.shape == want.v.shape and np.isfinite(got.v).all()
    if dtype == np.float64:
        np.testing.assert_allclose(got.x, want.x, **F64_X_TOL)
        assert abs(got.sigma02 - want.sigma02) <= 1e-9 * want.sigma02
        np.testing.assert_allclose(got.v, want.v, rtol=1e-9, atol=1e-7)
    else:
        np.testing.assert_allclose(got.x, want.x, **F32_X_TOL)
        assert abs(got.sigma02 - want.sigma02) <= 1e-4 * want.sigma02


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_gn_step_matches_jax_f64(lam):
    """One (damped) GN step from the initial point at the first step's CG
    tolerance (forcing_max = 1e-2)."""
    jstep, jobs, jl, _, _ = _jax_step("eop12", np.float64)
    x0 = jl.initial()
    want = jstep(jnp.asarray(x0), jobs, jnp.float64(1e-2), jnp.float64(lam))
    tp = to_port(jax_block("eop12"))
    tl = TLayout(tp)
    to = _opts(tschur, np.float64)
    tobs = tschur.ObsData.from_problem(tp, tl, dtype=np.float64)
    assert tobs.plan is not None and tobs.band is None
    assert tobs.W.shape[0] % tprefix.CHUNK == 0
    got = tschur.schur_step_fn(tschur.SchurKernel(tl, to), tl, False)(
        torch.from_numpy(x0.copy()), tobs, 1e-2, lam
    )
    x_w, l1_w, v_w, stats_w, it_w = (np.asarray(w) for w in want)
    x_g, l1_g, v_g, stats_g, it_g = got
    np.testing.assert_allclose(x_g.numpy(), x_w, **F64_X_TOL)
    np.testing.assert_allclose(stats_g.numpy(), stats_w, rtol=1e-9)
    # the port's stream is padded once to whole chunks, with zero rows
    n = v_w.shape[0]
    np.testing.assert_allclose(v_g.numpy()[:n], v_w, rtol=1e-9, atol=1e-7)
    assert not v_g[n:].any()
    assert abs(float(l1_g) - float(l1_w)) <= 1e-9 * float(l1_w)
    assert int(it_g) == int(it_w)


# block -> settings that pick the stop it exercises: the iteration cap, or
# the reference's L1 threshold
SOLVES = {
    "eop12": dict(iteration_cap=6),
    "selfcal16": dict(threshold=1.0),
    "ic12": dict(threshold=1.0),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_matches_jax_f64(name):
    """The default options (float64): solve_schur's unfused path."""
    loop = tuple(SOLVES[name].items())
    problem, want, want_cg = _jax_solve(name, np.float64, loop=loop)
    got = _port_solve(problem, np.float64)
    _assert_same_result(got, want, np.float64)
    assert got.cg_iterations == want_cg
    _assert_k4_count(got)


# float32 blocks the fused path does not take, solved: fused=False, and the
# image-sorted stream.  case -> (block, options of both sides, loop settings)
F32_CASES = {
    "fused_false": ("selfcal16", (("fused", False),), (("threshold", 1.0),)),
    "obs_order_img": ("eop12", (("obs_order", "img"),), (("iteration_cap", 6),)),
}


def _ulp_moves(x, n, seed=0):
    """n float32 copies of x, each entry moved by -1, 0 or +1 ulp (seeded)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    up, down = np.nextafter(x, np.float32(np.inf)), np.nextafter(x, np.float32(-np.inf))
    moves = []
    for _ in range(n):
        s = rng.integers(-1, 2, x.size)
        moves.append(np.where(s > 0, up, np.where(s < 0, down, x)))
    return moves


def _port_step(problem, opts):
    """The port's float32 step function and obs for the JAX problem."""
    tp = to_port(problem)
    tl = TLayout(tp)
    to = _opts(tschur, np.float32, **dict(opts))
    tobs = tschur.ObsData.from_problem(tp, tl, dtype=np.float32, obs_order=to.obs_order)
    tstep = tschur.schur_step_fn(tschur.SchurKernel(tl, to), tl,
                                 tp.settings.inner_constraints)
    return lambda x, tol, lam: int(tstep(torch.tensor(x), tobs, tol, lam)[4])


@pytest.mark.parametrize("case", list(F32_CASES))
def test_solve_matches_jax_f32(case):
    """The two float32 solves: the same stop, iteration count, x and
    sigma0^2, as many steps, and each step's CG count within 2 --

    - at the JAX step's own inputs (its x, cg_tol and lambda), where only
      the step's arithmetic differs;
    - along the port's own trajectory, against the JAX solves from x0 and
      from x0 with each entry moved by at most one ulp (8 seeded moves):
      within 2 of the lowest and the highest JAX count of that step.  Once
      the forcing tolerance falls below ~1e-5 a step's CG count is a
      threshold crossing on a plateau of the f32 residual, and one ulp in
      x0 moves the JAX solve's own count by more than 2 there
      (test_f32_cg_count_spread_matches_jax shows it).  A fault carried
      from step to step (a wrong forcing tolerance or lambda) moves the
      counts out of that envelope."""
    name, opts, loop = F32_CASES[case]
    inputs = []
    problem, want, want_cg = _jax_solve(name, np.float32, opts=opts, loop=loop,
                                        inputs=inputs)
    got = _port_solve(problem, np.float32, opts)
    _assert_same_result(got, want, np.float32)
    assert len(got.cg_iterations) == len(want_cg)
    _assert_k4_count(got, direct=dict(opts).get("obs_order", "tie") != "tie")
    step = _port_step(problem, opts)
    cg = [step(x, tol, lam) for x, tol, lam in inputs]
    assert all(abs(g - w) <= 2 for g, w in zip(cg, want_cg))
    x0 = np.asarray(JLayout(problem).initial(), np.float32)
    runs = [want_cg] + [_jax_solve(name, np.float32, opts=opts, loop=loop, x0=m)[2]
                        for m in _ulp_moves(x0, 8)]
    for k, g in enumerate(got.cg_iterations):
        seen = [r[k] for r in runs if k < len(r)]
        assert min(seen) - 2 <= g <= max(seen) + 2, (k, g, seen)


def test_f32_cg_count_spread_matches_jax():
    """At the fifth step of the image-sorted eop12 solve (forcing tolerance
    ~5e-6), 24 seeded one-ulp moves of the JAX step's input x (each entry
    -1, 0 or +1 ulp): the JAX step's own CG counts span more than 2
    iterations, and the port's counts at the same inputs have the same
    mean within 1 iteration and lie within 2 of the JAX range.  Rounding
    alone decides where the residual crosses the tolerance there."""
    name, opts, loop = F32_CASES["obs_order_img"]
    inputs = []
    problem, _, _ = _jax_solve(name, np.float32, opts=opts, loop=loop, inputs=inputs)
    x, tol, lam = inputs[4]
    assert 1e-6 < tol < 1e-5
    jstep = _jax_step(name, np.float32, (), opts)[0]
    jobs = _jax_step(name, np.float32, (), opts)[1]
    step = _port_step(problem, opts)
    moves = _ulp_moves(x, 24, seed=1)
    want = np.array([int(jstep(jnp.asarray(m), jobs, tol, lam, None)[4]) for m in moves])
    got = np.array([step(m, tol, lam) for m in moves])
    assert want.max() - want.min() > 2, want
    assert abs(got.mean() - want.mean()) <= 1.0, (got, want)
    assert want.min() - 2 <= got.min() and got.max() <= want.max() + 2, (got, want)


def test_gn_step_nine_iops_f32():
    """Nine IOP unknowns in float32: past the fused operator's 8 IOP rows,
    so the port's default options take the unfused path where they raised
    before (the JAX fused path fails there: JAX runs fused=False).

    One GN step from the initial point.  In float64 the port's step is held
    to the JAX package's float64 step at the float64 tolerances (the
    9-column IOP gathers and scales).  This self-calibration (k1..k4 on 16
    images) is ill-conditioned enough that any f32 step lies 5-30x X_TOL
    from the f64 step, on either side (measured: JAX 7.6x, the port 5.3x
    on this block; 25x and 30x on eop12), so the two f32 steps are not
    held to X_TOL of each other.  Instead the port's f32 step must lie no
    farther from the f64 step than the JAX package's f32 step does, within
    a factor 2, in the X_TOL-scaled max norm; the CG counts within 2, the
    step statistics within 1e-3 relative."""
    settings = tuple(NINE_IOPS.items())
    jstep, jobs, jl, _, _ = _jax_step("selfcal16", np.float32, settings, (("fused", False),))
    jstep64, jobs64, _, _, _ = _jax_step("selfcal16", np.float64, settings)
    x0 = jl.initial()
    want = jstep(jnp.asarray(x0.astype(np.float32)), jobs, jnp.float32(1e-2), jnp.float32(0.0))
    want64 = jstep64(jnp.asarray(x0), jobs64, jnp.float64(1e-2), jnp.float64(0.0))
    tp = to_port(jax_block("selfcal16", **NINE_IOPS))
    tl = TLayout(tp)
    got = {}
    for dt in (np.float32, np.float64):
        to = _opts(tschur, dt)
        assert tl.n_iop == 9 and tschur.make_band_plan(tp, tl, to) is None
        tobs = tschur.ObsData.from_problem(tp, tl, dtype=dt)
        got[dt] = tschur.schur_step_fn(tschur.SchurKernel(tl, to), tl, False)(
            torch.from_numpy(x0.astype(dt)), tobs, 1e-2, 0.0
        )
    x64 = got[np.float64][0].numpy()
    x_w64, l1_w64, _, stats_w64, it_w64 = (np.asarray(w) for w in want64)
    np.testing.assert_allclose(x64, x_w64, **F64_X_TOL)
    np.testing.assert_allclose(got[np.float64][3].numpy(), stats_w64, rtol=1e-9)
    assert abs(float(got[np.float64][1]) - float(l1_w64)) <= 1e-9 * float(l1_w64)
    assert int(got[np.float64][4]) == int(it_w64)
    scaled = lambda x: np.max(np.abs(np.asarray(x, np.float64) - x64)
                              / (F32_X_TOL["atol"] + F32_X_TOL["rtol"] * np.abs(x64)))
    x_g, l1_g, _, stats_g, it_g = got[np.float32]
    x_w, l1_w, _, stats_w, it_w = (np.asarray(w) for w in want)
    assert scaled(x_g.numpy()) <= 2 * scaled(x_w)
    np.testing.assert_allclose(stats_g.numpy(), stats_w, rtol=1e-3)
    assert abs(float(l1_g) - float(l1_w)) <= 1e-3 * float(l1_w)
    assert abs(int(it_g) - int(it_w)) <= 2


def test_gn_step_three_cameras():
    """One damped GN step of a 12-image, 3-camera self-calibrating block:
    per-camera IOP gathers, and camera sums through a sort plan."""
    jstep, jobs, jl, _, _ = _jax_step("cam3_12", np.float64)
    x0 = jl.initial()
    lam = 1e-3
    want = jstep(jnp.asarray(x0), jobs, jnp.float64(1e-2), jnp.float64(lam))
    tp = to_port(jax_block("cam3_12"))
    assert tp.n_cam == 3
    tl = TLayout(tp)
    tobs = tschur.ObsData.from_problem(tp, tl, dtype=np.float64)
    assert tobs.by_cam is not None
    tprefix.reset_counts()
    tschur.reset_cg_counts()
    got = tschur.schur_step_fn(
        tschur.SchurKernel(tl, _opts(tschur, np.float64)), tl, False
    )(torch.from_numpy(x0.copy()), tobs, 1e-2, lam)
    x_w, l1_w, v_w, stats_w, it_w = (np.asarray(w) for w in want)
    x_g, l1_g, v_g, stats_g, it_g = got
    np.testing.assert_allclose(x_g.numpy(), x_w, **F64_X_TOL)
    np.testing.assert_allclose(stats_g.numpy(), stats_w, rtol=1e-9)
    assert int(it_g) == int(it_w)
    # the camera axis adds dcc, reduced rhs, IOP preconditioner and one
    # per matvec to the single-camera count; CG runs masked blocks of 8
    # iterations (cg_maxiter = 500), one host check before each block and
    # one that stops
    cgc = tschur.cg_counts
    matvecs = 8 * (cgc["host_reads"] - 1)
    assert cgc["calls"] == 1 and cgc["matvecs"] == matvecs
    assert int(it_g) <= matvecs <= int(it_g) + 8
    assert tprefix.plain_calls["chunk_prefix"] == 9 + 3 * matvecs


def test_unfused_problem_without_tie_points():
    """EOP-only block with the tie points held fixed (n_tie = 0): Hpp^-1 is
    empty and the back-substitution has no rows; x and CG counts as JAX."""
    problem, want, want_cg = _jax_solve(
        "eop12", np.float64, (("estimate_tie", False),), loop=(("iteration_cap", 3),)
    )
    got = tschur.solve_schur(
        to_port(problem), _opts(tschur, np.float64),
        compute_covariance=False, device="cpu",
    )
    assert got.layout.n_tie == 0
    _assert_same_result(got, want, np.float64)
    assert got.cg_iterations == want_cg


def test_gn_step_img_three_cameras_f32():
    """One float32 GN step at obs_order="img" of the 3-camera
    self-calibrating block, from the initial point at the first step's
    inputs (cg_tol 1e-2, lambda 0): direct tie, image and camera sums on
    both sides.  x within X_TOL of the JAX step, the same CG count, the
    step statistics within 1e-4 relative.  (The prefix differences the
    port took before put this step past X_TOL from the JAX step.  Later
    steps of this block, at 40 and more CG iterations, lie past X_TOL
    from JAX's whichever sums the port takes: f32 CG on this
    ill-conditioned block amplifies any rounding.)"""
    opts = (("obs_order", "img"),)
    jstep, jobs, jl, _, _ = _jax_step("cam3_12", np.float32, (), opts)
    x0 = jl.initial().astype(np.float32)
    want = jstep(jnp.asarray(x0), jobs, jnp.float32(1e-2), jnp.float32(0.0), None)
    tp = to_port(jax_block("cam3_12"))
    tl = TLayout(tp)
    to = _opts(tschur, np.float32, **dict(opts))
    tobs = tschur.ObsData.from_problem(tp, tl, dtype=np.float32, obs_order="img")
    assert tobs.plan is None and isinstance(tobs.by_cam, tsegment.DirectPlan)
    got = tschur.schur_step_fn(tschur.SchurKernel(tl, to), tl, False)(
        torch.from_numpy(x0), tobs, 1e-2, 0.0
    )
    x_w, l1_w, _, stats_w, it_w = (np.asarray(w) for w in want)
    x_g, l1_g, _, stats_g, it_g = got
    np.testing.assert_allclose(x_g.numpy(), x_w, **F32_X_TOL)
    np.testing.assert_allclose(stats_g.numpy(), stats_w, rtol=1e-4)
    assert int(it_g) == int(it_w)


@pytest.mark.parametrize("axis", ["tie", "img", "cam"])
def test_direct_sums_match_jax_scatter(axis):
    """Float32 at obs_order="img" on the 3-camera block: the port's per-tie,
    per-image and per-camera sums of one (N, 6) stream (values in [1, 2))
    against a float64 truth.  The JAX package scatter-adds them in problem
    order; the port's error must be no larger than that scatter's (factor
    1; on the CPU the plain version adds the rows in the same order, so the
    sums are bitwise equal).  Control on the same inputs: the prefix
    differences of a tie-sorted DualAxisPlan, the port's sums before the
    direct ones, exceed the scatter's error on the tie and image axes.  On
    the camera axis (~280 rows a camera) a prefix difference is no worse
    than the serial scatter, so there the direct sum is for the JAX
    package's order only."""
    jp = jax_block("cam3_12")
    tp = to_port(jp)
    tl = TLayout(tp)
    obs = tschur.ObsData.from_problem(tp, tl, dtype=np.float32, obs_order="img")
    assert obs.plan is None and obs.by_cam is not None
    n, d = tp.n_obs, 6
    vals = (1 + np.random.default_rng(0).random((n, d))).astype(np.float32)
    stream = np.zeros((obs.W.shape[0], d), np.float32)
    stream[:n] = vals[obs.order]
    tie = jp.target_tie_slot[jp.obs_pt]
    tie = np.where(tie >= 0, tie, tl.n_tie)
    ids, n_seg, got = {
        "tie": (tie, tl.n_tie + 1, obs.tie_sum),
        "img": (jp.obs_img, tl.n_img, obs.img_sum),
        "cam": (jp.obs_cam, tp.n_cam, obs.cam_sum),
    }[axis]
    # the sums the solver reads: every tie but the dummy slot of the
    # control observations, every image, every camera
    keep = tl.n_tie if axis == "tie" else n_seg
    truth = np.zeros((n_seg, d))
    np.add.at(truth, ids, vals.astype(np.float64))
    truth = truth[:keep]
    jax_sum = np.asarray(jnp.zeros((n_seg, d), jnp.float32).at[jnp.asarray(ids)].add(vals))[:keep]
    port_sum = got(torch.from_numpy(stream)).numpy()[:keep]
    err = lambda s: float(np.abs(s - truth).max())
    assert err(port_sum) <= 1.0 * err(jax_sum)
    assert np.array_equal(port_sum, jax_sum)
    # the parent's form: prefix differences over the tie-sorted stream
    order = tschur.ObsData.sort_order_by_tie(tp, tl)
    plan = tsegment.DualAxisPlan.build(tie[order], tl.n_tie + 1, jp.obs_img[order], tl.n_img)
    prefix = {"tie": plan.primary_sum, "img": plan.secondary_sum,
              "cam": tsegment.SortPlan.build(jp.obs_cam[order], tp.n_cam).sum}[axis]
    prefix_sum = prefix(torch.from_numpy(vals[order])).numpy()[:keep]
    if axis == "cam":
        assert err(prefix_sum) <= err(jax_sum)
    else:
        assert err(prefix_sum) > err(jax_sum)
