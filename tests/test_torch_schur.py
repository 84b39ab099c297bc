"""The port's float32 fused Schur Gauss-Newton solve against the JAX
package's, on the CPU (the port's kernels run as their plain versions,
the JAX Pallas kernels in interpret mode at precision="bf16x2").

Tolerances: x within rtol=3e-5, atol=3e-4 (tests/test_fusedmv.py:154 --
both sides are f32, agreement is to f32 round-off on O(1e3) coordinates
plus the TPU kernel's bf16x2 operand split); the step statistics and
sigma0^2 within 1e-4 relative; CG iteration counts within 1, since an f32
residual norm can land on either side of the stop tolerance."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_eye_bundle_adjustment_tpu.solver import schur as jschur
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout as JLayout
from fish_eye_bundle_adjustment_tpu_torch.ops import fusedmv as tfused
from fish_eye_bundle_adjustment_tpu_torch.solver import schur as tschur
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout as TLayout

from _torch_blocks import jax_block, to_port

X_TOL = dict(rtol=3e-5, atol=3e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_cg_iteration_per_trip():
    """The JAX _pcg unrolls its masked iterations in blocks of _CG_UNROLL
    only to save TPU while_loop overhead; the semantics are the guarded
    loop's whatever the block size (its docstring).  One iteration per
    trip traces the interpret-mode matvec kernel once instead of 8 times,
    which halves each JAX compile here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jschur, "_CG_UNROLL", 1)
        yield


def _jax_opts(**kw):
    return jschur.SchurOptions(
        dtype=np.float32, fused=True, fused_precision_mv="bf16x2",
        device_loop=False, **kw,
    )


@functools.lru_cache(maxsize=None)
def _steps(name):
    """(jitted JAX step + its obs, the port's step + its obs, x0)."""
    jp = jax_block(name)
    jl = JLayout(jp)
    jo = _jax_opts()
    jk = jschur.SchurKernel(jl, jo, obs_order="tie")
    jobs = jschur.ObsData.from_problem(
        jp, jl, dtype=np.float32, band_plan=jschur.make_band_plan(jp, jl, jo)
    )
    jstep = jax.jit(jschur.schur_step_fn(jk, jl, jp.settings.inner_constraints))

    tp = to_port(jp)
    tl = TLayout(tp)
    to = tschur.SchurOptions(dtype=np.float32)
    tk = tschur.SchurKernel(tl, to)
    tobs = tschur.ObsData.from_problem(
        tp, tl, tschur.make_band_plan(tp, tl, to), dtype=np.float32
    )
    tstep = tschur.schur_step_fn(tk, tl, tp.settings.inner_constraints)
    return jstep, jobs, tstep, tobs, jl.initial().astype(np.float32)


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_gn_step_matches_jax(lam):
    """One (damped) GN step from the initial point at the first step's
    CG tolerance (forcing_max = 1e-2)."""
    jstep, jobs, tstep, tobs, x0 = _steps("eop12")
    cg_tol = 1e-2
    want = jstep(jnp.asarray(x0), jobs, jnp.float32(cg_tol), jnp.float32(lam))
    got = tstep(torch.from_numpy(x0.copy()), tobs, cg_tol, lam)
    x_w, l1_w, v_w, stats_w, it_w = (np.asarray(w) for w in want)
    x_g, l1_g, v_g, stats_g, it_g = got
    np.testing.assert_allclose(x_g.numpy(), x_w, **X_TOL)
    np.testing.assert_allclose(stats_g.numpy(), stats_w, rtol=1e-4)
    assert abs(float(l1_g) - float(l1_w)) <= 1e-4 * float(l1_w)
    assert abs(int(it_g) - int(it_w)) <= 1
    assert v_g.shape == v_w.shape


# block -> settings that pick the stop it exercises: the iteration cap, or
# the reference's L1 threshold (raised so f32 reaches it in a few steps)
SOLVES = {
    "eop12": dict(iteration_cap=6),
    "selfcal16": dict(threshold=1.0),
    "ic12": dict(threshold=1.0),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_schur_matches_jax(name):
    jp = jax_block(name, **SOLVES[name])
    want = jschur.solve_schur(jp, _jax_opts(), compute_covariance=False)
    tfused.reset_counts()
    got = tschur.solve_schur(
        to_port(jp), tschur.SchurOptions(dtype=np.float32),
        compute_covariance=False, device="cpu",
    )
    assert got.converged == want.converged
    assert got.stopped_on == want.stopped_on
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.x, want.x, **X_TOL)
    assert abs(got.sigma02 - want.sigma02) <= 1e-4 * want.sigma02
    assert got.v.shape == want.v.shape and np.isfinite(got.v).all()
    # the fused glue ran through the operator's plain versions: one
    # K1 pass per linearization, K2 for rhs, CG and back-substitution
    assert tfused.plain_calls["fused_hpp_pass"] >= got.iterations
    assert tfused.plain_calls["fused_schur_apply"] > 2 * got.iterations
    assert tfused.kernel_launches == {"fused_hpp_pass": 0, "fused_schur_apply": 0}


NINE_IOPS = dict(estimate_c=True, estimate_xp=True, estimate_yp=True,
                 estimate_radial=True, num_radial_distortions=4,
                 estimate_decent=True)


@pytest.mark.parametrize("opts, kw, settings, item", [
    (dict(dtype=np.float64), {}, {}, "item 5"),
    (dict(dtype=np.float32, fused=False), {}, {}, "item 5"),
    (dict(dtype=np.float32, device_loop=True), {}, {}, "item 7"),
    (dict(dtype=np.float32, explicit_s=True), {}, {}, "item 5"),
    (dict(dtype=np.float32), dict(compute_covariance=True), {}, "item 6"),
    (dict(dtype=np.float32), {}, NINE_IOPS, "item 5"),
], ids=["f64", "unfused", "device_loop", "explicit_s", "covariance", "nine_iops"])
def test_outside_the_slice_raises(opts, kw, settings, item):
    """Configurations the port does not cover yet raise, naming their
    ROADMAP Queue 1 item; nothing falls back to another path.  The f64,
    unfused and nine-IOP routes (nine IOP unknowns overflow the fused
    operator's 8 IOP rows) lead into the unfused path, where explicit_s=None
    at 12 <= explicit_s_max_images images picks the explicit dense S, as in
    the JAX package: item 5."""
    p = to_port(jax_block("eop12", **settings))
    kw = {"compute_covariance": False, "device": "cpu", **kw}
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1, {item}"):
        tschur.solve_schur(p, tschur.SchurOptions(**opts), **kw)


def test_sharded_segment_plans_raise():
    """Per-shard segment plans wait for parallel/ (ROADMAP Queue 1, item 8)."""
    from fish_eye_bundle_adjustment_tpu_torch.ops.segment import DualAxisPlan

    ids = np.arange(8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item 8"):
        DualAxisPlan.build_sharded(ids, 8, ids, 8, 2)


def test_default_device_needs_cuda():
    """device=None means "cuda" and raises when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = to_port(jax_block("eop12"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tschur.solve_schur(
            p, tschur.SchurOptions(dtype=np.float32), compute_covariance=False
        )


def test_pcg_semantics():
    """_pcg on a small SPD system: exact solve within maxiter, the
    iteration count, the maxiter stop, and the curvature guard."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((12, 12))
    A = torch.tensor(A @ A.T + 12 * np.eye(12))
    b = torch.tensor(rng.standard_normal(12))
    ident = lambda v: v
    x, it, rel = tschur._pcg(lambda v: A @ v, b, ident, ident,
                             torch.tensor(1e-12, dtype=A.dtype), 100)
    np.testing.assert_allclose((A @ x).numpy(), b.numpy(), rtol=1e-9, atol=1e-9)
    assert 0 < it <= 12 and float(rel) <= 1e-12
    _, it3, rel3 = tschur._pcg(lambda v: A @ v, b, ident, ident,
                               torch.tensor(1e-12, dtype=A.dtype), 3)
    assert it3 == 3 and float(rel3) > 1e-12
    # an indefinite operator: the guard stops before the bad step
    x0, it0, _ = tschur._pcg(lambda v: -v, b, ident, ident,
                             torch.tensor(1e-12, dtype=A.dtype), 10)
    assert it0 == 0 and not x0.any()
