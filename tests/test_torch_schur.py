"""The port's float32 fused Schur Gauss-Newton solve against the JAX
package's, on the CPU (the port's kernels run as their plain versions,
the JAX Pallas kernels in interpret mode), both sides at the same
precision of the fused operator: "bf16x2" throughout, "bf16" throughout,
or both packages' defaults ("bf16x2", and a "bf16" CG matvec at u <=
600,000).

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

from _torch_blocks import jax_block, one_torch_thread, to_port  # noqa: F401 (autouse)

X_TOL = dict(rtol=3e-5, atol=3e-4)
# A single-pass "bf16" operand rounds to 8 bits, and one GN step's CG (5
# iterations at tol 1e-2) follows those roundings: the JAX step itself,
# from x0 moved by one float32 ulp, lands 1.4-3.9e-2 (all "bf16") and
# 4.7-7.6e-3 (defaults: the CG matvec in "bf16") of the step's norm away,
# 120-270 X_TOL.  So a step at those precisions is held to the JAX step
# within a share of the step's norm, and its statistics and L1 within 5e-3.
STEP_TOL = {"bf16": 5e-2, "defaults": 2e-2}


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


# precision -> the fused operator's options, given to both packages alike
PRECISIONS = {
    "bf16x2": dict(fused_precision="bf16x2", fused_precision_mv="bf16x2"),
    "bf16": dict(fused_precision="bf16", fused_precision_mv="bf16"),
    "defaults": {},
}


def _jax_opts(prec="bf16x2", **kw):
    return jschur.SchurOptions(
        dtype=np.float32, fused=True, device_loop=False, **PRECISIONS[prec], **kw,
    )


def _port_opts(prec="bf16x2", **kw):
    return tschur.SchurOptions(dtype=np.float32, **PRECISIONS[prec], **kw)


@functools.lru_cache(maxsize=None)
def _steps(name, prec="bf16x2"):
    """(jitted JAX step + its obs, the port's step + its obs, x0)."""
    jp = jax_block(name)
    jl = JLayout(jp)
    jo = _jax_opts(prec)
    jk = jschur.SchurKernel(jl, jo, obs_order="tie")
    jobs = jschur.ObsData.from_problem(
        jp, jl, dtype=np.float32, band_plan=jschur.make_band_plan(jp, jl, jo)
    )
    jstep = jax.jit(jschur.schur_step_fn(jk, jl, jp.settings.inner_constraints))

    tp = to_port(jp)
    tl = TLayout(tp)
    to = _port_opts(prec)
    tk = tschur.SchurKernel(tl, to)
    assert tk.mv_precision == jk.mv_precision
    tobs = tschur.ObsData.from_problem(
        tp, tl, tschur.make_band_plan(tp, tl, to), dtype=np.float32
    )
    tstep = tschur.schur_step_fn(tk, tl, tp.settings.inner_constraints)
    return jstep, jobs, tstep, tobs, jl.initial().astype(np.float32)


@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_gn_step_matches_jax(lam, prec):
    """One (damped) GN step from the initial point at the first step's
    CG tolerance (forcing_max = 1e-2), at each precision."""
    jstep, jobs, tstep, tobs, x0 = _steps("eop12", prec)
    cg_tol = 1e-2
    want = jstep(jnp.asarray(x0), jobs, jnp.float32(cg_tol), jnp.float32(lam))
    got = tstep(torch.from_numpy(x0.copy()), tobs, cg_tol, lam)
    x_w, l1_w, v_w, stats_w, it_w = (np.asarray(w) for w in want)
    x_g, l1_g, v_g, stats_g, it_g = got
    if prec in STEP_TOL:
        step = x_w - x0
        assert np.linalg.norm(x_g.numpy() - x_w) <= STEP_TOL[prec] * np.linalg.norm(step)
        rtol = 5e-3
    else:
        np.testing.assert_allclose(x_g.numpy(), x_w, **X_TOL)
        rtol = 1e-4
    np.testing.assert_allclose(stats_g.numpy(), stats_w, rtol=rtol)
    assert abs(float(l1_g) - float(l1_w)) <= rtol * float(l1_w)
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
        to_port(jp), _port_opts(), compute_covariance=False, device="cpu",
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
    (dict(dtype=np.float32, device_loop=True), {}, {}, "item 7"),
], ids=["device_loop"])
def test_outside_the_slice_raises(opts, kw, settings, item):
    """Configurations the port does not cover yet raise, naming their
    ROADMAP Queue 1 item; nothing falls back to another path."""
    p = to_port(jax_block("eop12", **settings))
    kw = {"compute_covariance": False, "device": "cpu", **kw}
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1, {item}"):
        tschur.solve_schur(p, tschur.SchurOptions(**opts), **kw)


# The configurations that raised before the explicit dense S and the
# covariance were ported, each now solved on both sides: (the port's
# options, the JAX package's, solve_schur keywords, settings, x tolerance).
# The float64 default and every float32 route into the unfused path take
# the explicit dense S by the auto gate at 12 <= 600 images (nine IOP
# unknowns overflow the fused operator's 8 IOP rows); "covariance" is the
# fused float32 solve (the JAX fused operator in interpret mode) with its
# exact float64 stds.
X_TOL_F64 = dict(rtol=1e-9, atol=1e-7)
FORMERLY_RAISING = {
    "f64": (dict(dtype=np.float64), {}, {}, {}, X_TOL_F64),
    "unfused": (dict(dtype=np.float32, fused=False), {}, {}, {}, X_TOL),
    "explicit_s": (dict(dtype=np.float32, explicit_s=True), {}, {}, {}, X_TOL),
    "covariance": (dict(dtype=np.float32), dict(fused=True, device_loop=False),
                   dict(compute_covariance=True), {}, X_TOL),
    "nine_iops": (dict(dtype=np.float32), {}, {}, NINE_IOPS, X_TOL),
}


@pytest.mark.parametrize("case", list(FORMERLY_RAISING))
def test_formerly_raising_configurations_match_jax(case):
    """x within the tolerance of its precision, the same iterations and
    stop, sigma0^2 within 1e-9 (float64) or 1e-4 (float32) relative; with
    compute_covariance=True the stds of both float32 solutions, each the
    exact float64 covariance at its own x, within 1e-4 relative."""
    opts, jopts, kw, settings, tol = FORMERLY_RAISING[case]
    jp = jax_block("eop12", **settings)
    kw = {"compute_covariance": False, **kw}
    want = jschur.solve_schur(jp, jschur.SchurOptions(**opts, **jopts), **kw)
    got = tschur.solve_schur(to_port(jp), tschur.SchurOptions(**opts), device="cpu", **kw)
    assert (got.iterations, got.converged, got.stopped_on) == (
        want.iterations, want.converged, want.stopped_on)
    np.testing.assert_allclose(got.x, want.x, **tol)
    s_tol = 1e-9 if tol is X_TOL_F64 else 1e-4
    assert abs(got.sigma02 - want.sigma02) <= s_tol * want.sigma02
    if kw["compute_covariance"]:
        assert got.std_method == want.std_method == "exact"
        np.testing.assert_allclose(got.std, want.std, rtol=1e-4)
    else:
        assert got.std is None and got.std_method is None


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


def _guarded_pcg(matvec, b, precond, project, tol, maxiter):
    """The guarded CG loop that the masked _pcg must reproduce: one host
    read of the residual test and one of the curvature guard per
    iteration.  Returns (x, count, ||r|| / ||b||, stop)."""
    b = project(b)
    bnorm2 = torch.dot(b, b)
    tol2 = tol * tol * bnorm2
    mv = lambda v: project(matvec(project(v)))
    x, r = torch.zeros_like(b), b
    z = project(precond(b))
    p, rz, i, stop = z, torch.dot(b, z), 0, "maxiter"
    while i < maxiter:
        if not bool(torch.dot(r, r) > tol2):
            stop = "tol"
            break
        Ap = mv(p)
        pAp = torch.dot(p, Ap)
        if not bool(pAp > 0):
            stop = "curvature"
            break
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = project(precond(r))
        rz_new = torch.dot(r, z)
        p = z + rz_new / torch.where(rz != 0, rz, torch.ones_like(rz)) * p
        rz, i = rz_new, i + 1
    return x, i, torch.sqrt(torch.dot(r, r) / bnorm2), stop


def _cg_system(kind, dtype):
    """A 40-unknown system with eigenvalues 1..100 (SPD) or with two
    negative ones that b barely excites (indefinite: the curvature guard
    trips after 9 iterations), a Jacobi preconditioner and a projection
    off one direction, as the free network's."""
    rng = np.random.default_rng(0)
    n = 40
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.geomspace(1.0, 1e2, n)
    neg = -rng.uniform(0.5, 5.0, 2)
    b = rng.standard_normal(n)
    if kind == "indefinite":
        ev[:2] = neg
        b = b - 0.9 * Q[:, :2] @ (Q[:, :2].T @ b)
    A = torch.tensor(Q @ np.diag(ev) @ Q.T, dtype=dtype)
    g = torch.tensor(Q[:, -1], dtype=dtype)
    dinv = 1 / torch.diagonal(A).abs()
    return (lambda v: A @ v, torch.tensor(b, dtype=dtype), lambda v: dinv * v,
            lambda v: v - g * torch.dot(g, v))


# (system, maxiter, tol, the guarded loop's stop and count)
PCG_CASES = {
    "budget5": ("spd", 5, 1e-12, "maxiter", 5),
    "budget16": ("spd", 16, 1e-12, "maxiter", 16),
    "budget17": ("spd", 17, 1e-12, "maxiter", 17),
    "budget40": ("spd", 40, 1e-14, "maxiter", 40),
    "tol_in_block": ("spd", 40, 1e-2, "tol", 20),
    "curvature_in_block": ("indefinite", 40, 1e-12, "curvature", 9),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(PCG_CASES))
def test_masked_pcg_matches_guarded_loop(case, dtype):
    """The masked _pcg gives the guarded loop's x, count and residual
    bitwise (the same updates while active, exact no-ops after), at
    budgets on both sides of the full unroll (<= 16) and with a tol or a
    curvature stop inside a block of 8."""
    kind, maxiter, tol, stop, count = PCG_CASES[case]
    mv, b, pre, proj = _cg_system(kind, dtype)
    tol = torch.tensor(tol, dtype=dtype)
    xg, ig, relg, stopg = _guarded_pcg(mv, b, pre, proj, tol, maxiter)
    if dtype == torch.float64:  # the case is what its name says
        assert (stopg, ig) == (stop, count)
    x, i, rel = tschur._pcg(mv, b, pre, proj, tol, maxiter)
    assert i.dtype == torch.int32 and i.dim() == 0
    assert int(i) == ig and torch.equal(x, xg) and torch.equal(rel, relg)


@pytest.mark.parametrize("maxiter", [5, 16, 17, 40])
def test_pcg_host_reads(maxiter, monkeypatch):
    """No flag comes back to the host at maxiter <= 16, and at most one
    per block of 8 plus the last check otherwise: every bool(), item(),
    int() and float() of a tensor inside _pcg is counted."""
    mv, b, pre, proj = _cg_system("spd", torch.float64)
    reads = []

    def counted(name):
        orig = getattr(torch.Tensor, name)

        def f(self, *a, **kw):
            reads.append(name)
            return orig(self, *a, **kw)
        return f

    for name in ("__bool__", "item", "__int__", "__float__", "__index__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, counted(name))
    tschur.reset_cg_counts()
    x, i, rel = tschur._pcg(mv, b, pre, proj, torch.tensor(1e-14, dtype=b.dtype), maxiter)
    n_reads = len(reads)
    monkeypatch.undo()
    limit = 0 if maxiter <= 16 else -(-maxiter // 8) + 1
    assert n_reads <= limit and tschur.cg_counts["host_reads"] == n_reads
    assert int(i) == maxiter
    assert tschur.cg_counts["matvecs"] == -(-maxiter // 8) * 8 if maxiter > 16 else maxiter


@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_fused_solve_matches_jax_at_each_precision(prec):
    """The eop12 solve (iteration cap 6) at "bf16x2", at "bf16" and at both
    packages' defaults (no precision given: a "bf16" CG matvec here): the
    same stop and iterations, sigma0^2 within 1e-4, x within X_TOL (all
    "bf16": within 1e-2 of the solve's correction x - x0, see STEP_TOL;
    measured 2.6e-3), and each step's CG count within 1 (all "bf16": 2) of
    the JAX step's at that step's inputs (its x, cg_tol and lambda) -- past
    the float32 floor a step's count depends on the ulps of its x, so two
    trajectories are compared at the same inputs."""
    jstep, jobs, tstep, tobs, _ = _steps("eop12", prec)
    jp = jax_block("eop12", iteration_cap=6)
    jl = JLayout(jp)
    inputs, want_cg = [], []

    def counted(x, ob, tol, lam):
        out = jstep(x, ob, tol, lam)
        inputs.append((np.asarray(x), float(tol), float(lam)))
        want_cg.append(int(out[4]))
        return out

    (x, hist, dh, v, stats, count, conv, elapsed, stopped) = jschur.run_gn_loop(
        counted, jobs, jl, jp, _jax_opts(prec))
    want = jschur._finalize(jp, jl, x, hist, dh, np.asarray(v), np.asarray(stats),
                            count, conv, elapsed, False, stopped)
    got = tschur.solve_schur(to_port(jp), _port_opts(prec),
                             compute_covariance=False, device="cpu")
    assert (got.stopped_on, got.iterations) == (want.stopped_on, want.iterations)
    if prec == "bf16":
        x0 = jl.initial()
        assert np.linalg.norm(got.x - want.x) <= 1e-2 * np.linalg.norm(want.x - x0)
    else:
        np.testing.assert_allclose(got.x, want.x, **X_TOL)
    assert abs(got.sigma02 - want.sigma02) <= 1e-4 * want.sigma02
    assert len(got.cg_iterations) == len(want_cg)
    cg = [int(tstep(torch.tensor(x), tobs, tol, lam)[4]) for x, tol, lam in inputs]
    slack = 2 if prec == "bf16" else 1
    assert all(abs(g - w) <= slack for g, w in zip(cg, want_cg)), (cg, want_cg)
