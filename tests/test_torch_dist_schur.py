"""The port's observation-sharded Schur solver (parallel/dist_schur.py)
against the JAX package's, at two ranks.

One group of two gloo ranks on the CPU (tests/_torch_dist_worker.py)
runs every port case of this module; the JAX side runs here on two
devices of the conftest's CPU mesh, the host loop over its shard_map step
(SchurOptions(device_loop=False); tests/_torch_blocks.jax_dist_run).
Both split the stream into the same two slices (the JAX package's equal
contiguous slices; the port pads each to whole chunks on its own)."""

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

N = 2
STEP_TOL = 1e-10  # float64, one step at the same x: only sums' order differs
X_ATOL = 1e-8  # tests/test_parallel.py: distributed against one device
CG_TOL = 1e-2
LAMS = (0.0, 0.3)

# case -> (block, settings, options): a self-calibrating block, a
# self-calibrating free network, and float32 at obs_order="img"
CASES = {
    "selfcal16": ("selfcal16", {}, {}),
    "ic12": ("ic12", dict(estimate_c=True, estimate_xp=True, estimate_yp=True), {}),
    "f32_img": ("selfcal16", {}, dict(dtype=np.float32, obs_order="img")),
}


def _problem(case):
    block, settings, _ = CASES[case]
    return jax_block(block, **settings)


def _x0(case):
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    return ParamLayout(_problem(case)).initial()


def _port_cases():
    out = {}
    for case, (_, _, opts) in CASES.items():
        p = to_port(_problem(case))
        out[f"step:{case}"] = ("step", dict(mode="distributed", problem=p, opts=opts,
                                            xs=[_x0(case)], lams=LAMS, cg_tol=CG_TOL))
        if case != "f32_img":
            out[f"solve:{case}"] = ("solve", dict(mode="distributed", problem=p, opts=opts))
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_group(N, _port_cases())


_JAX = {}


def _jax(case):
    """The JAX package's steps at x0 and (float64) its solve, once a case."""
    if case not in _JAX:
        from fish_eye_bundle_adjustment_tpu.parallel.dist_schur import make_distributed_step
        from fish_eye_bundle_adjustment_tpu.solver.schur import SchurOptions

        _, _, opts = CASES[case]
        _JAX[case] = jax_dist_run(
            make_distributed_step, _problem(case), N,
            SchurOptions(**opts, device_loop=False), xs=[_x0(case)], lams=LAMS,
            cg_tol=CG_TOL, solve=case != "f32_img")
    return _JAX[case]


@pytest.mark.parametrize("case", ["selfcal16", "ic12"])
def test_step_matches_jax(ranks, case):
    """One float64 step at x0, at lam 0 and 0.3, tie-sorted: the
    correction, L1(delta), the four stats and the residual rows within
    1e-10 relative, the CG count equal."""
    want, _ = _jax(case)
    x0 = _x0(case)
    for (x1, d, stats, cg, v), (jx1, jd, jstats, jcg, jv) in zip(ranks[f"step:{case}"], want):
        assert rel_err(x1 - x0, jx1 - x0) <= STEP_TOL
        assert abs(d - jd) <= STEP_TOL * jd
        assert rel_err(stats, jstats) <= STEP_TOL
        assert cg == jcg
        assert rel_err(v, jv[: len(v)]) <= STEP_TOL


def test_f32_img_step_matches_jax(ranks):
    """One float32 step at obs_order="img" (the port's direct sums per
    slice, the JAX scatter-adds) at lam 0 and 0.3 within rtol 2e-4."""
    want, _ = _jax("f32_img")
    x0 = _x0("f32_img")
    for (x1, d, stats, cg, v), (jx1, jd, jstats, jcg, jv) in zip(ranks["step:f32_img"], want):
        np.testing.assert_allclose(x1, jx1, rtol=2e-4, atol=2e-4)
        assert rel_err(x1 - x0, jx1 - x0) <= 2e-4
        np.testing.assert_allclose(d, jd, rtol=2e-4)
        np.testing.assert_allclose(stats, jstats, rtol=2e-4)
        assert abs(cg - jcg) <= 2


@pytest.mark.parametrize("case", ["selfcal16", "ic12"])
def test_solve_matches_jax(ranks, case):
    """solve_schur_distributed at two ranks: the same iterations, stop
    and convergence, x within atol 1e-8, sigma0^2 within 1e-9 relative,
    the residual rows in report order; rank 0 made all-reduces and one
    all_gather (the residual rows), no reduce-scatter."""
    _, want = _jax(case)
    got = ranks[f"solve:{case}"]
    assert (got["iterations"], got["converged"], got["stopped_on"]) == (
        want.iterations, want.converged, want.stopped_on)
    np.testing.assert_allclose(got["x"], want.x, rtol=0, atol=X_ATOL)
    assert abs(got["sigma02"] - want.sigma02) <= 1e-9 * want.sigma02
    np.testing.assert_allclose(got["v"], want.v, rtol=0, atol=1e-8)
    counts = got["counts"]
    assert counts["all_reduce"]["calls"] > 0 and counts["all_gather"]["calls"] == 1
    assert counts["reduce_scatter"]["calls"] == 0
