"""The port's dense parity solver (solver/dense.py, solver/linearize.py)
against the JAX package's, in float64 on the CPU.

Tolerances.  The design matrix A and misclosure w within rtol 1e-12 (atol
1e-12 of A's largest entry, for entries that are zero up to rounding):
both sides evaluate the same forward-mode Jacobians in float64.  Solves:
x within rtol 1e-9 / atol 1e-7, sigma0^2 within 1e-9 relative, std and
Cx_q within 1e-8 relative (Cx_q against its largest entry), the same
iterations and `converged`.  delta_history within 1e-9 relative or 1e-10
absolute: the last corrections of a converging solve (1e-6 to 1e-9 in the
L1 norm) are as small as the rounding of the two LU solves, whose
summation orders differ, so their relative agreement is far looser than
1e-9 while their absolute difference stays well inside 1e-10."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_eye_bundle_adjustment_tpu.solver import dense as jdense
from fish_eye_bundle_adjustment_tpu.solver.linearize import Linearizer as JLinearizer
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout as JLayout
from fish_eye_bundle_adjustment_tpu_torch.solver import dense as tdense
from fish_eye_bundle_adjustment_tpu_torch.solver.linearize import Linearizer as TLinearizer
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout as TLayout

from _torch_blocks import jax_block, lm_block, to_port


# mode -> the block that exercises it
MODES = {
    "eop": lambda: jax_block("eop12"),  # EOPs and tie points, IOPs fixed
    "free_network": lambda: jax_block("ic12"),  # Inner_Constraints: bordered KKT
    "selfcal": lambda: jax_block("selfcal16"),  # c, xp, yp, k1..k3, p1, p2 too
    "lm_first_step_rejected": lm_block,
}


@functools.lru_cache(maxsize=None)
def _jax_solve(mode):
    problem = MODES[mode]()
    return problem, jdense.solve_dense(problem)


@pytest.mark.parametrize("name", ["selfcal16", "cam3_12"])
def test_dense_design_matches_jax(name):
    """A (2 n_obs, u) and w at the initial point: control observations
    (selfcal16) and per-camera IOP columns (cam3_12)."""
    jp = jax_block(name)
    jl = JLayout(jp)
    q = jl.initial() * jl.scale
    A_w, w_w = (np.asarray(a) for a in jax.jit(JLinearizer(jp, jl).dense_design)(jnp.asarray(q)))
    tp = to_port(jp)
    A_g, w_g = TLinearizer(tp, TLayout(tp)).dense_design(torch.from_numpy(q))
    assert A_g.shape == A_w.shape and A_g.dtype == torch.float64
    np.testing.assert_allclose(A_g.numpy(), A_w, rtol=1e-12, atol=1e-12 * np.abs(A_w).max())
    assert np.array_equal(A_g.numpy() == 0, A_w == 0)
    np.testing.assert_allclose(w_g.numpy(), w_w, rtol=1e-12, atol=1e-12 * np.abs(w_w).max())


@pytest.mark.parametrize("mode", list(MODES))
def test_solve_dense_matches_jax(mode, monkeypatch):
    problem, want = _jax_solve(mode)
    lams = []
    step = tdense.DenseSystem.step

    def recorded(self, x, lam):
        lams.append(lam)
        return step(self, x, lam)

    monkeypatch.setattr(tdense.DenseSystem, "step", recorded)
    got = tdense.solve_dense(to_port(problem), device="cpu")
    assert got.iterations == want.iterations and got.converged == want.converged
    np.testing.assert_allclose(got.x, want.x, rtol=1e-9, atol=1e-7)
    assert abs(got.sigma02 - want.sigma02) <= 1e-9 * want.sigma02
    np.testing.assert_allclose(got.delta_history, want.delta_history, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(got.std, want.std, rtol=1e-8)
    assert np.abs(got.Cx_q - want.Cx_q).max() <= 1e-8 * np.abs(want.Cx_q).max()
    np.testing.assert_allclose(got.v, want.v, rtol=1e-9, atol=1e-9)
    assert got.std_method == want.std_method == "exact"
    assert got.x_history.shape == want.x_history.shape
    if mode == "lm_first_step_rejected":
        # the first trial raised the cost: the second step is damped
        assert lams[0] == 0.0 and lams[1] > 0.0 and len(lams) > got.iterations
        assert not got.converged
    else:
        assert got.converged and set(lams) == {0.0}


def test_solve_dense_without_covariance_or_history():
    problem, want = _jax_solve("eop")
    got = tdense.solve_dense(to_port(problem), compute_covariance=False,
                             keep_history=False, device="cpu")
    assert got.Cx is None and got.std is None and got.Cx_q is None
    assert got.x_history.shape == (0, got.layout.u)
    np.testing.assert_allclose(got.x, want.x, rtol=1e-9, atol=1e-7)


def test_solve_dense_needs_a_card_unless_asked(monkeypatch):
    """device=None means the CUDA card: without one it raises, naming the
    missing device, and never solves on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = to_port(jax_block("eop12"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdense.solve_dense(problem)
