"""The port's sharded camera-state solver (parallel/sharded_state.py,
with parallel/tieshard.py at point_mode="sharded") against the JAX
package's.

Two rank groups on the CPU (tests/_torch_dist_worker.py): two gloo ranks
for the self-calibrating block with replicated points and an 11-image
free network (11 images over 2 ranks: a padded image slot) with sharded
points, and four ranks for the self-calibrating block with sharded
points.  The JAX side runs here on as many devices of the conftest's CPU
mesh, the host loop over its shard_map step (device_loop=False)."""

import numpy as np
import pytest

from _torch_blocks import (  # noqa: F401 (one_torch_thread: autouse)
    jax_block,
    jax_dist_run,
    one_torch_thread,
    rel_err,
    to_port,
)
from _torch_dist_worker import run_group

STEP_TOL = 1e-10
X_ATOL = 1e-8
CG_TOL = 1e-2
LAMS = (0.0, 0.3)

# case -> (ranks, point_mode, with steps)
CASES = {
    "selfcal16/replicated": (2, "replicated", True),
    "ic11/sharded": (2, "sharded", True),
    "selfcal16/sharded@4": (4, "sharded", False),
}


def _problem(case):
    if case.startswith("ic11"):
        from fish_eye_bundle_adjustment_tpu.synth import make_block

        return make_block(n_img=11, n_pts=150, model="fisheye", seed=5, control_frac=0.0,
                          settings_overrides={"inner_constraints": True}).problem
    return jax_block("selfcal16")


def _x0(case):
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    return ParamLayout(_problem(case)).initial()


def _port_cases(n):
    out = {}
    for case, (ranks, mode, steps) in CASES.items():
        if ranks != n:
            continue
        p = to_port(_problem(case))
        if steps:
            out[f"step:{case}"] = ("step", dict(mode="sharded", problem=p, opts={},
                                                xs=[_x0(case)], lams=LAMS, cg_tol=CG_TOL,
                                                point_mode=mode))
        out[f"solve:{case}"] = ("solve", dict(mode="sharded", problem=p, opts={},
                                              point_mode=mode))
    return out


@pytest.fixture(scope="module")
def ranks():
    out = run_group(2, _port_cases(2))
    out.update(run_group(4, _port_cases(4)))
    return out


_JAX = {}


def _jax(case):
    if case not in _JAX:
        from fish_eye_bundle_adjustment_tpu.parallel.sharded_state import (
            make_sharded_camera_step,
        )
        from fish_eye_bundle_adjustment_tpu.solver.schur import SchurOptions

        n, mode, steps = CASES[case]
        _JAX[case] = jax_dist_run(
            make_sharded_camera_step, _problem(case), n, SchurOptions(device_loop=False),
            xs=[_x0(case)] if steps else [], lams=LAMS, cg_tol=CG_TOL, point_mode=mode)
    return _JAX[case]


@pytest.mark.parametrize("case", [c for c, v in CASES.items() if v[2]])
def test_step_matches_jax(ranks, case):
    """One float64 step at x0, lam 0 and 0.3: the correction, L1(delta),
    the stats and the residual rows within 1e-10 relative, the CG count
    equal (the CG's inner products: the pose part all-reduced)."""
    want, _ = _jax(case)
    x0 = _x0(case)
    got = ranks[f"step:{case}"]
    assert len(got) == len(want) == len(LAMS)
    for (x1, d, stats, cg, v), (jx1, jd, jstats, jcg, jv) in zip(got, want):
        assert rel_err(x1 - x0, jx1 - x0) <= STEP_TOL
        assert abs(d - jd) <= STEP_TOL * jd
        assert rel_err(stats, jstats) <= STEP_TOL
        assert cg == jcg
        assert rel_err(v, jv[: len(v)]) <= STEP_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches_jax(ranks, case):
    """solve_schur_sharded_state: the same iterations and stop, x within
    atol 1e-8, sigma0^2 within 1e-9 relative; the collectives of the mode
    (reduce-scatters of the pose sums, an all_gather a matvec)."""
    _, want = _jax(case)
    got = ranks[f"solve:{case}"]
    assert (got["iterations"], got["converged"], got["stopped_on"]) == (
        want.iterations, want.converged, want.stopped_on)
    np.testing.assert_allclose(got["x"], want.x, rtol=0, atol=X_ATOL)
    assert abs(got["sigma02"] - want.sigma02) <= 1e-9 * want.sigma02
    np.testing.assert_allclose(got["v"], want.v, rtol=0, atol=1e-8)
    counts = got["counts"]
    assert counts["reduce_scatter"]["calls"] > 0
    assert counts["all_gather"]["calls"] > sum(got["cg_iterations"])
