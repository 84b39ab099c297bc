"""The port's explicit dense reduced camera system (solver/explicit.py) and
the solves that take it, against the JAX package's, in float64 on the CPU.

Tolerances.  The PairPlan's arrays are equal.  S within 1e-12 of the JAX
S in relative Frobenius norm, and the Schur-Jacobi preconditioner read
off it within 1e-12 relative on a seeded vector: both sides form the same
float64 products and prefix-difference sums, in different orders.
Solves: x within rtol 1e-9 / atol 1e-7 (tests/test_torch_dense.py), the
same iterations and stop, sigma0^2 within 1e-9 relative.  The solves are
compared where they stop, not along the way: CG runs to the forcing
tolerance (1e-2 early on), and on an ill-conditioned block its iterates
follow the rounding -- the JAX solve of cam3_12 from x0 moved by one ulp
takes a second correction of 135.875 instead of 127.350 (the port's:
135.875), and the 4-iteration LM block of tests/test_torch_dense.py lands
15.6x the x tolerance from itself (the port 3.2x).  So the LM rejection
case here is the same block moved by N(0, 240 m), run to convergence."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_eye_bundle_adjustment_tpu.solver import explicit as jexplicit
from fish_eye_bundle_adjustment_tpu.solver import schur as jschur
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout as JLayout
from fish_eye_bundle_adjustment_tpu_torch.ops import prefix as tprefix
from fish_eye_bundle_adjustment_tpu_torch.solver import explicit as texplicit
from fish_eye_bundle_adjustment_tpu_torch.solver import schur as tschur
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout as TLayout

from _torch_blocks import jax_block, lm_block, one_torch_thread, to_port  # noqa: F401 (autouse)

BLOCKS4 = ["eop12", "selfcal16", "ic12", "cam3_12"]
X_TOL = dict(rtol=1e-9, atol=1e-7)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@functools.lru_cache(maxsize=None)
def _both(name):
    """(JAX kernel, factors, pair plan, S; the port's kernel, factors, pair
    plan) at the block's initial point, damped by lam = 1e-3."""
    jp = jax_block(name)
    jl = JLayout(jp)
    jo = jschur.SchurOptions()
    jk = jschur.SchurKernel(jl, jo, obs_order="tie")
    order = jschur.ObsData.sort_order_by_tie(jp, jl)
    jobs = jschur.ObsData.from_problem(jp, jl, dtype=np.float64, order=order, with_plan=True)
    jpairs = jschur.make_pair_plan(jp, jl, jo, order)
    q = jl.initial() * jl.scale
    lam = 1e-3
    jfac = jax.jit(jk.linearize)(jnp.asarray(q), jobs, lam)
    jS = np.asarray(jax.jit(jexplicit.build_dense_S)(jfac, jpairs))

    tp = to_port(jp)
    tl = TLayout(tp)
    to = tschur.SchurOptions()
    tk = tschur.SchurKernel(tl, to)
    tobs = tschur.ObsData.from_problem(tp, tl, dtype=np.float64)
    tpairs = tschur.make_pair_plan(tp, tl, to)
    tfac = tk.linearize(torch.from_numpy(q), tobs, lam=torch.tensor(lam, dtype=torch.float64))
    return jk, jfac, jpairs, jS, tk, tfac, tpairs


@pytest.mark.parametrize("name", BLOCKS4)
def test_pair_plan_matches_jax(name):
    """The same pairs in the same order, the same block-key segments; the
    port's pair stream is padded to whole K4 chunks past the last segment."""
    _, _, jpairs, _, _, _, tpairs = _both(name)
    P = jpairs.n_pairs
    assert tpairs.n_pairs == P and tpairs.pa.shape[0] % tprefix.CHUNK == 0
    assert np.array_equal(tpairs.pa.numpy()[:P], np.asarray(jpairs.pa))
    assert np.array_equal(tpairs.pb.numpy()[:P], np.asarray(jpairs.pb))
    assert np.array_equal(tpairs.keys.begs.numpy(), np.asarray(jpairs.key_begs))
    assert np.array_equal(tpairs.keys.ends.numpy(), np.asarray(jpairs.key_ends))
    assert int(tpairs.keys.ends[-1]) == P
    # (tie, camera) sums only where several cameras calibrate
    assert (tpairs.by_tie_cam is not None) == (name == "cam3_12")


@pytest.mark.parametrize("name", BLOCKS4)
def test_build_dense_S_matches_jax(name):
    _, _, _, jS, _, tfac, tpairs = _both(name)
    S = texplicit.build_dense_S(tfac, tpairs)
    assert S.dtype == torch.float64 and S.shape == jS.shape
    assert _rel(S.numpy(), jS) <= 1e-12
    # the pair blocks mirror exactly; a diagonal block's per-observation
    # products round (a b) c and (a c) b apart, as in the JAX package
    assert _rel(S.numpy(), S.numpy().T) <= 1e-14


@pytest.mark.parametrize("name", BLOCKS4)
def test_dense_precond_matches_jax(name):
    jk, _, _, jS, tk, tfac, tpairs = _both(name)
    v = np.random.default_rng(3).standard_normal(jS.shape[0])
    want = np.asarray(jexplicit.dense_precond(jnp.asarray(jS), jk)(jnp.asarray(v)))
    S = texplicit.build_dense_S(tfac, tpairs)
    got = texplicit.dense_precond(S, tk)(torch.from_numpy(v)).numpy()
    assert _rel(got, want) <= 1e-12


# case -> (JAX problem, SchurOptions keywords of both sides)
SOLVES = {
    "explicit_s_true_eop12": (lambda: jax_block("eop12"), dict(explicit_s=True)),
    "auto_gate_cam3_12": (lambda: jax_block("cam3_12"), {}),
    "lm_rejection_selfcal16": (lambda: lm_block(scale=240.0, iteration_cap=40), {}),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_explicit_solve_matches_jax(case, monkeypatch):
    """solve_schur on the explicit dense S, forced and through the auto
    gate (12 <= explicit_s_max_images images), and through an LM
    rejection: the first trial raises the cost and the next steps damp S
    with lam * raw diag(Hcc)."""
    make, kw = SOLVES[case]
    jp = make()
    want = jschur.solve_schur(jp, jschur.SchurOptions(**kw), compute_covariance=False)
    lams = []
    step_fn = tschur.schur_step_fn

    def recorded(*a, **k):
        assert k["pairs"] is not None
        step = step_fn(*a, **k)

        def run(x, obs, cg_tol, lam=0.0):
            lams.append(lam)
            return step(x, obs, cg_tol, lam)

        return run

    monkeypatch.setattr(tschur, "schur_step_fn", recorded)
    got = tschur.solve_schur(to_port(jp), tschur.SchurOptions(**kw),
                             compute_covariance=False, device="cpu")
    assert (got.iterations, got.converged, got.stopped_on) == (
        want.iterations, want.converged, want.stopped_on)
    np.testing.assert_allclose(got.x, want.x, **X_TOL)
    assert abs(got.sigma02 - want.sigma02) <= 1e-9 * want.sigma02
    assert got.converged
    if case.startswith("lm_rejection"):
        # a trial raised the cost: it was rolled back and the next damped
        assert any(lam > 0.0 for lam in lams) and len(lams) > got.iterations
    else:
        assert set(lams) == {0.0}


def test_explicit_needs_tie_order():
    """explicit_s=True at obs_order="img" raises, as in the JAX package;
    at None the auto gate leaves that order matrix-free."""
    p = to_port(jax_block("eop12"))
    layout = TLayout(p)
    with pytest.raises(ValueError, match="tie-sorted"):
        tschur.make_pair_plan(p, layout, tschur.SchurOptions(explicit_s=True, obs_order="img"))
    assert tschur.make_pair_plan(p, layout, tschur.SchurOptions(obs_order="img")) is None
    assert tschur.make_pair_plan(
        p, layout, tschur.SchurOptions(explicit_s_max_images=p.n_img - 1)) is None
