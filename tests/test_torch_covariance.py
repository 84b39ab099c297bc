"""The port's Schur covariance (solver/covariance.py) and the default
solve_schur(problem) that reaches it, against the JAX package's, on the
CPU; and the sums of a banded stream (the fused factor's unfused pieces,
which the Hutchinson estimator reads).

Tolerances.  The default solve: x within rtol 1e-9 / atol 1e-7, sigma0^2
within 1e-9 relative, std within 1e-8 relative, camera correlations
within 1e-7, the same iterations, stop and std method.  The exact
covariance at the same x: std within 1e-9 relative and Cc_q within 1e-9
of its largest entry (float64 throughout; the two sides sum and invert in
different orders).  The float64 Hutchinson estimate within 1e-6 relative:
both sides run the same probes (numpy's seeded generator) through CG to
1e-5, with the same iteration counts, so only rounding separates them."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_eye_bundle_adjustment_tpu.solver import covariance as jcov
from fish_eye_bundle_adjustment_tpu.solver import schur as jschur
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout as JLayout
from fish_eye_bundle_adjustment_tpu_torch.ops.segment import DualAxisPlan
from fish_eye_bundle_adjustment_tpu_torch.solver import covariance as tcov
from fish_eye_bundle_adjustment_tpu_torch.solver import schur as tschur
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout as TLayout

from _torch_blocks import jax_block, one_torch_thread, to_port  # noqa: F401 (autouse)

BLOCKS4 = ["eop12", "selfcal16", "ic12", "cam3_12"]


@functools.lru_cache(maxsize=None)
def _jax_default(name):
    """The JAX package's default solve_schur(problem): float64, explicit S
    by the auto gate, compute_covariance=True."""
    jp = jax_block(name)
    return jp, jschur.solve_schur(jp)


@pytest.mark.parametrize("name", BLOCKS4)
def test_default_solve_matches_jax(name):
    jp, want = _jax_default(name)
    got = tschur.solve_schur(to_port(jp), device="cpu")
    assert (got.iterations, got.converged, got.stopped_on) == (
        want.iterations, want.converged, want.stopped_on)
    np.testing.assert_allclose(got.x, want.x, rtol=1e-9, atol=1e-7)
    assert abs(got.sigma02 - want.sigma02) <= 1e-9 * want.sigma02
    assert got.std_method == want.std_method == "exact"
    np.testing.assert_allclose(got.std, want.std, rtol=1e-8)
    np.testing.assert_allclose(got.camera_correlation(), want.camera_correlation(),
                               rtol=0, atol=1e-7)
    assert got.Cx_q is None and got.Cc_q.shape == want.Cc_q.shape


@pytest.mark.parametrize("name", BLOCKS4)
def test_schur_covariance_matches_jax(name):
    """schur_covariance at the JAX solve's x and sigma0^2, against the
    stds and Cc_q that solve reported (the JAX schur_covariance there)."""
    jp, want = _jax_default(name)
    tp = to_port(jp)
    pieces = {}
    got = tcov.schur_covariance(tp, TLayout(tp), want.x, want.sigma02, device="cpu",
                                pieces=pieces)
    np.testing.assert_allclose(got.std, want.std, rtol=1e-9)
    assert np.abs(got.Cc_q - want.Cc_q).max() <= 1e-9 * np.abs(want.Cc_q).max()
    assert {"linearize", "placement", "gemm", "inverse"} <= set(pieces)
    assert pieces["gemm_flops"] > 0


def test_schur_covariance_gate():
    jp, want = _jax_default("eop12")
    tp = to_port(jp)
    assert tcov.schur_covariance(tp, TLayout(tp), want.x, 1.0, max_images=tp.n_img - 1,
                                 device="cpu") is None


def test_repeated_observation_is_summed():
    """An image that observes a tie point twice puts two observations in
    one (tie, image) cell of the placement: they are summed first (the
    JAX package's np.add.at), not written over each other."""
    import dataclasses

    jp, _ = _jax_default("eop12")
    i = int(np.flatnonzero(jp.target_tie_slot[jp.obs_pt] >= 0)[0])
    dup = {k: np.insert(getattr(jp, k), i + 1, getattr(jp, k)[i], axis=0)
           for k in ("obs_img", "obs_cam", "obs_pt", "obs_xy")}
    dup["obs_xy"][i + 1] += 0.3
    jp2 = dataclasses.replace(jp, **dup)
    x = JLayout(jp2).initial()
    want = jcov.schur_covariance(jp2, JLayout(jp2), x, 1.0)
    tp = to_port(jp2)
    got = tcov.schur_covariance(tp, TLayout(tp), x, 1.0, device="cpu")
    np.testing.assert_allclose(got.std, want.std, rtol=1e-9)


@functools.lru_cache(maxsize=None)
def _jax_estimate(name, dtype):
    jp, want = _jax_default(name)
    std = jcov.estimate_schur_stds(jp, JLayout(jp), want.x, want.sigma02, n_probe=8,
                                   seed=3, dtype=dtype)
    return jp, want, std


def _port_estimate(jp, sol, dtype):
    tp = to_port(jp)
    layout = TLayout(tp)
    info = {}
    got = tcov.estimate_schur_stds(tp, layout, sol.x, sol.sigma02, n_probe=8, seed=3,
                                   dtype=dtype, device="cpu", info=info)
    # 2 subspace iterations and Cc V over k = min(16, nc // 4) deflation
    # vectors, then the 8 probes: one CG solve each
    k = min(16, (layout.eop_size + layout.iop_size) // 4)
    assert len(info["cg_iterations"]) == 3 * k + 8
    assert np.isfinite(got).all() and (got >= 0).all()
    return got


def _rel_err(got, want):
    live = want > 0
    return np.abs(got[live] - want[live]) / want[live]


def test_estimate_schur_stds_matches_jax():
    """Float64 on the free-network block (the probe solves projected onto
    Null(G')): within 1e-6 relative."""
    jp, sol, want = _jax_estimate("ic12", np.float64)
    got = _port_estimate(jp, sol, np.float64)
    assert got.shape == want.shape
    assert _rel_err(got, want).max() <= 1e-6


def test_fused_estimate_tracks_jax():
    """The port's float32 estimate on selfcal16 (one camera): the fused
    operator's matvec (K2's plain version at the JAX package's "bf16"
    operands), Part A's sums in the preconditioner and in the probes' C'b
    and P'b.  The JAX package runs its fused operator only on a TPU, so
    the yardstick is its unfused float32 estimate with the same probes.
    A bf16 operator moves the CG solutions by ~1e-3 (and takes ~2x the
    iterations: ~250 a solve against ~120), and an entry whose sampled
    variance lies near zero moves far more relatively, so the largest
    difference is not held: measured median 2.8e-3, q90 1.1e-2, largest
    0.44 (an entry estimated at a fifth of its exact std).  Held: median
    <= 1e-2, q90 <= 3e-2; against the exact stds the port's median error
    within 10% of JAX's (measured 0.127 and 0.126) and clipped entries
    within 2 of JAX's (28 and 29)."""
    jp, sol, want = _jax_estimate("selfcal16", np.float32)
    got = _port_estimate(jp, sol, np.float32)
    rel = _rel_err(got, want)
    assert np.median(rel) <= 1e-2 and np.quantile(rel, 0.9) <= 3e-2
    port_err, jax_err = np.median(_rel_err(got, sol.std)), np.median(_rel_err(want, sol.std))
    assert port_err <= 1.1 * jax_err
    assert abs(int((got == 0).sum()) - int((want == 0).sum())) <= 2


def test_compute_stds_switches_methods():
    """Exact up to max_images, the Hutchinson estimate past it."""
    jp, want = _jax_default("eop12")
    tp = to_port(jp)
    layout = TLayout(tp)
    std, Cc, method = tcov.compute_stds(tp, layout, want.x, want.sigma02, max_images=12,
                                        device="cpu")
    assert method == "exact" and Cc is not None
    np.testing.assert_allclose(std, want.std, rtol=1e-9)
    std, Cc, method = tcov.compute_stds(tp, layout, want.x, want.sigma02, max_images=11,
                                        n_probe=4, device="cpu")
    assert method == "hutchinson" and Cc is None and np.isfinite(std).all()
    assert np.median(np.abs(std - want.std) / want.std) < 0.3
    assert tcov.compute_stds(tp, layout, want.x, 1.0, max_images=11, n_probe=0,
                             device="cpu") == (None, None, None)


# -- Part A: the sums of a banded stream ----------------------------------

@functools.lru_cache(maxsize=None)
def _banded(name="selfcal16"):
    """JAX and port fused factors of one float32 banded stream at x0."""
    jp = jax_block(name)
    jl = JLayout(jp)
    jo = jschur.SchurOptions(dtype=np.float32, fused=True)
    jk = jschur.SchurKernel(jl, jo, obs_order="tie")
    jobs = jschur.ObsData.from_problem(jp, jl, dtype=np.float32,
                                       band_plan=jschur.make_band_plan(jp, jl, jo))
    q = (jl.initial() * jl.scale).astype(np.float32)
    jfac = jax.jit(jk.linearize)(jnp.asarray(q), jobs)

    tp = to_port(jp)
    tl = TLayout(tp)
    to = tschur.SchurOptions(dtype=np.float32)
    tk = tschur.SchurKernel(tl, to)
    tobs = tschur.ObsData.from_problem(tp, tl, tschur.make_band_plan(tp, tl, to),
                                       dtype=np.float32)
    tfac = tk.linearize(torch.from_numpy(q), tobs)
    assert tfac.fused and jfac.fused
    return jp, jobs, jfac, tobs, tfac


@pytest.mark.parametrize("axis", ["tie", "img"])
def test_banded_sums_match_jax_scatter(axis):
    """On selfcal16's banded stream the port's tie and image sums are
    bitwise equal to the JAX scatter-add (_segsum) of the same rows in the
    stream's order, on the sums a caller reads (every tie but the dummy
    slot, every image), with the padding rows zero as the solver's
    weighted rows are; the one-camera sum is torch.sum, against jnp.sum
    within 1e-6.  Built on first use: a fresh banded ObsData has none."""
    jp, jobs, _, tobs, _ = _banded()
    n = tobs.W.shape[0]
    vals = (1 + np.random.default_rng(0).random((n, 6))).astype(np.float32)
    vals[jp.n_obs:] = 0
    tp = to_port(jp)
    tl = TLayout(tp)
    fresh = tschur.ObsData.from_problem(
        tp, tl, tschur.make_band_plan(tp, tl, tschur.SchurOptions(dtype=np.float32)),
        dtype=np.float32)
    assert fresh.by_tie is None and fresh.by_img is None
    ids, n_seg, keep, got = {
        "tie": (jobs.tie, tl.n_tie + 1, tl.n_tie, fresh.tie_sum),
        "img": (jobs.img, tl.n_img, tl.n_img, fresh.img_sum),
    }[axis]
    want = np.asarray(jschur._segsum(jnp.asarray(vals), ids, n_seg))[:keep]
    port = got(torch.from_numpy(vals)).numpy()[:keep]
    assert np.array_equal(port, want)
    assert fresh.by_tie is not None and fresh.by_img is not None
    cam = fresh.cam_sum(torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(cam, np.asarray(jnp.sum(jnp.asarray(vals), 0, keepdims=True)),
                               rtol=1e-6)


def _pose_precond_truth(tfac, v):
    """The pose blocks of the preconditioner from the port's float32
    per-observation columns summed in float64, inverted in float64."""
    sym = tfac.pose_precond_sym().double().numpy()
    img = tfac.obs.img.numpy()
    n = len(tfac.obs.order)
    k = tfac.k
    sums = np.zeros((k.n_img, sym.shape[1]))
    np.add.at(sums, img[:n], sym[:n])
    blocks = tschur._expand_sym(torch.from_numpy(sums), k.ne).numpy()
    vp = v[: k.n_img * k.ne].reshape(k.n_img, k.ne).astype(np.float64)
    return np.einsum("bij,bj->bi", np.linalg.inv(blocks), vp).reshape(-1)


@pytest.mark.parametrize("piece", ["cam_applyT", "point_applyT", "preconditioner"])
def test_fused_factor_pieces_match_jax(piece):
    """A fused factor's unfused pieces -- C'b, P'b and the Schur-Jacobi
    preconditioner -- against the JAX package's at the same inputs (b zero
    on the padding rows, as the solver's weighted rows are).  C'b and P'b
    within 1e-6 relative norm.  The JAX factor sums the banded stream by
    prefix differences (its banded ObsData carries a DualAxisPlan), the
    port directly.  The preconditioner inverts 6x6 pose blocks of those
    sums whose condition numbers (median 2.5e7) carry the packages'
    float32 column differences (3.9e-7 relative) into the inverse: 1.9e-5
    from JAX's measured, and still 1.7e-5 with the port summing by JAX's
    prefix differences, so 1e-6 is out of reach from float32 columns.  It
    is held to 1e-4 of JAX's, and its pose blocks' distance from a
    float64 sum of the same columns must be below JAX's."""
    _, jobs, jfac, tobs, tfac = _banded()
    rng = np.random.default_rng(1)
    n, n_obs = tobs.W.shape[0], len(tobs.order)
    bx, by = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    bx[n_obs:] = by[n_obs:] = 0
    v = rng.standard_normal(tfac.k.nc).astype(np.float32)
    tol = 1e-6
    if piece == "cam_applyT":
        want = jfac._cam_applyT(jnp.asarray(bx), jnp.asarray(by))
        got = tfac._cam_applyT(torch.from_numpy(bx), torch.from_numpy(by))
    elif piece == "point_applyT":
        want = jfac._point_applyT(jnp.asarray(bx), jnp.asarray(by))
        got = tfac._point_applyT(torch.from_numpy(bx), torch.from_numpy(by))
    else:
        want = jfac.make_preconditioner()[0](jnp.asarray(v))
        got = tfac.make_preconditioner()[0](torch.from_numpy(v))
        tol = 1e-4
        truth = _pose_precond_truth(tfac, v)
        io = truth.size
        err = lambda a: np.linalg.norm(np.asarray(a, np.float64)[:io] - truth)
        assert err(got.numpy()) < err(want)
    want, got = np.asarray(want, np.float64), got.double().numpy()
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def test_fused_preconditioner_gap_is_the_float32_columns():
    """Why the preconditioner above is held to 1e-4, not 1e-6: the gap is
    the float32 columns', not the summation form's.  The port's pose
    columns lie within 1e-6 of JAX's (measured 3.9e-7), JAX's pose blocks
    have condition numbers above 1e6 (median 2.5e7), and with the port's
    band stream summed in JAX's form -- a DualAxisPlan's prefix
    differences -- the port's preconditioner is still more than 1e-6 from
    JAX's (measured 1.7e-5), within 1e-4."""
    _, jobs, jfac, tobs, tfac = _banded()
    cols, jcols = tfac.pose_precond_sym().double().numpy(), np.asarray(
        jfac.pose_precond_sym(), np.float64)
    assert np.linalg.norm(cols - jcols) <= 1e-6 * np.linalg.norm(jcols)
    blocks = tschur._expand_sym(
        torch.from_numpy(np.asarray(jobs.plan.secondary_sum(jfac.pose_precond_sym()),
                                    np.float64)), tfac.k.ne).numpy()
    assert np.median(np.linalg.cond(blocks)) > 1e6
    live = np.arange(tobs.W.shape[0]) < len(tobs.order)
    v = np.random.default_rng(1).standard_normal(tfac.k.nc).astype(np.float32)
    want = np.asarray(jfac.make_preconditioner()[0](jnp.asarray(v)), np.float64)
    assert tobs.plan is None
    tobs.plan = DualAxisPlan.build(tobs.tie.numpy(), tobs.band.n_tie + 1,
                                   np.where(live, tobs.img.numpy(), tobs.band.n_img),
                                   tobs.band.n_img)
    try:
        got = tfac.make_preconditioner()[0](torch.from_numpy(v)).double().numpy()
    finally:
        tobs.plan = None
    gap = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert 1e-6 < gap <= 1e-4
