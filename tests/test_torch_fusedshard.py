"""The port's fused sharded Schur solver (parallel/fusedshard.py: K1 and
K2 on each rank's window of a split band plan) against the JAX
package's, and the kernels' per-window pieces against the unsharded
operator.

The windows' index and their plain K1/K2 outputs are checked here in one
process (no collective is needed to sum them); the step and the solve run
on one group of two gloo ranks (tests/_torch_dist_worker.py), the JAX
side on two devices of the conftest's CPU mesh (its Pallas kernels in
interpret mode, the host loop over its shard_map step).  The port's solve
is its default call, the device loop (its eager body on gloo ranks), held
also to the port's host loop."""

import numpy as np
import pytest

from _torch_blocks import (  # noqa: F401 (one_torch_thread: autouse)
    jax_dist_run,
    one_torch_thread,
    rel_err,
    to_port,
)
from _torch_dist_worker import fused_partials, run_group

N = 2
CG_TOL = 1e-6
LAMS = (0.0, 0.3)
# tests/test_fusedshard.py's options (the JAX side adds device_loop=False)
OPTS = dict(dtype=np.float32, fused=True, cg_maxiter=120, cg_tol=CG_TOL,
            fused_precision_mv="bf16x2", adaptive_forcing=False)


def _problem():
    """tests/test_fusedshard.py's step block."""
    from fish_eye_bundle_adjustment_tpu.synth import make_block

    return make_block(n_img=10, n_pts=220, model="fisheye", seed=33,
                      settings_overrides={"inner_constraints": False},
                      control_frac=0.05).problem


def _x0():
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    return ParamLayout(_problem()).initial().astype(np.float32)


@pytest.fixture(scope="module")
def ranks():
    p = to_port(_problem())
    return run_group(N, {
        "step": ("step", dict(mode="fused", problem=p, opts=OPTS, xs=[_x0()], lams=LAMS,
                              cg_tol=CG_TOL)),
        "solve": ("solve", dict(mode="fused", problem=p, opts=OPTS)),
        "host": ("solve", dict(mode="fused", problem=p, opts=dict(OPTS, device_loop=False))),
    })


_JAX = {}


def _jax():
    if not _JAX:
        from fish_eye_bundle_adjustment_tpu.parallel.fusedshard import make_fused_sharded_step
        from fish_eye_bundle_adjustment_tpu.solver.schur import SchurOptions

        _JAX["run"] = jax_dist_run(make_fused_sharded_step, _problem(), N,
                                   SchurOptions(**OPTS, device_loop=False), xs=[_x0()],
                                   lams=LAMS, cg_tol=CG_TOL)
    return _JAX["run"]


_PARTIALS = {}


def _partials(n_shards):
    if n_shards not in _PARTIALS:
        from _torch_blocks import jax_block

        _PARTIALS[n_shards] = fused_partials(to_port(jax_block("selfcal16")),
                                             dict(dtype=np.float32), n_shards)
    return _PARTIALS[n_shards]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_window_index_is_the_plans(n_shards):
    """Each window's kernel index (BandArrays from shard_band) is the
    unsharded plan's for the window's groups, at local row offsets: the
    owning group of each owned row, each group's tie runs, column order
    and column runs, and the covering groups of each 128-image block;
    the padding groups own no row and cover only their band."""
    out = _partials(n_shards)
    sp, plan, whole = out["sp"], out["plan"], out["whole_index"]
    inv = np.empty(plan.n_obs, np.int64)
    inv[plan.order] = np.arange(plan.n_obs)
    n_blk = plan.n_img_pad // 128
    for d, idx in enumerate(out["index"]):
        rows = sp.shard_rows[d]
        j = int(np.argmax(rows >= 0))
        base = inv[rows[j]] - j  # the window's first row in the stream
        g0 = d * sp.G_loc
        own = idx["row_group"] >= 0
        np.testing.assert_array_equal(own, sp.owned[d])
        loc = np.nonzero(own)[0]
        np.testing.assert_array_equal(whole["row_group"][base + loc], g0 + idx["row_group"][loc])
        for gl in range(sp.G_loc):
            g = g0 + gl
            if g < plan.G:
                for key in ("tie_off", "col_perm", "col_off"):
                    np.testing.assert_array_equal(idx[key][gl], whole[key][g], err_msg=key)
            else:
                assert not idx["tie_off"][gl].any() and not idx["col_off"][gl].any()
                assert (idx["col_perm"][gl] == -1).all()
        for b in range(n_blk):
            got = g0 + idx["cover_ids"][idx["cover_off"][b] : idx["cover_off"][b + 1]]
            want = whole["cover_ids"][whole["cover_off"][b] : whole["cover_off"][b + 1]]
            np.testing.assert_array_equal(got[got < plan.G],
                                          want[(want >= g0) & (want < g0 + sp.G_loc)])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_window_partials_sum_to_the_operator(n_shards):
    """K1 and K2's camera-side outputs (plain versions) on each window of
    the self-calibrating block, each folded from its own rows with the
    unsharded Hpp^-1 of its ranks, summed over the windows: within 1e-5
    relative of the unsharded operator's (K1's pose diagonal and IOP
    lanes; K2's matvec at "bf16", rhs + preconditioner and
    back-substitution at "bf16x2"); IOP lane partials compared summed
    over lanes."""
    out = _partials(n_shards)
    for key, want in out["whole"].items():
        got = out["summed"][key]
        if key.endswith("iop") or key in ("di", "i55"):
            got, want = got.sum(axis=1), want.sum(axis=1)
        assert rel_err(got, want) <= 1e-5, key


def test_step_matches_jax(ranks):
    """One fused step at x0, lam 0 and 0.3, against the JAX package's
    make_fused_sharded_step on two devices: x within rtol/atol 2e-4,
    L1(delta) and the stats within 2e-3 relative (tests/test_fusedshard.py's
    bounds), the windows' residual rows within 2e-4 of their norm."""
    want, _ = _jax()
    for (x1, d, stats, cg, v), (jx1, jd, jstats, jcg, jv) in zip(ranks["step"], want):
        np.testing.assert_allclose(x1, jx1, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(d, jd, rtol=2e-3)
        np.testing.assert_allclose(stats, jstats, rtol=2e-3)
        assert rel_err(v, jv) <= 2e-4


def test_solve_matches_jax(ranks):
    """solve_schur_fused_sharded at two ranks: the same convergence, x
    within rtol 1e-3 / atol 2e-3, sigma0^2 within 1e-2, the report-order
    residual rows within 5e-2 (tests/test_fusedshard.py's bounds); one
    all_gather a step (the point correction) and one more (the residual
    rows), no reduce-scatter."""
    _, want = _jax()
    got = ranks["solve"]
    assert got["converged"] == want.converged
    np.testing.assert_allclose(got["x"], want.x, rtol=1e-3, atol=2e-3)
    assert abs(got["sigma02"] - want.sigma02) < 1e-2
    np.testing.assert_allclose(got["v"], want.v, rtol=5e-2, atol=5e-2)
    counts = got["counts"]
    assert counts["all_gather"]["calls"] == len(got["cg_iterations"]) + 1
    assert counts["reduce_scatter"]["calls"] == 0


def test_default_solve_is_the_device_loop(ranks):
    """At two ranks the default call (device_loop=None) takes the device
    loop, as the JAX package's does: it matches the JAX solve (by
    test_solve_matches_jax's bounds) and the port's host loop at the same
    ranks within 1e-12, with the same iterations, CG counts and
    collectives."""
    _, want = _jax()
    got, host = ranks["solve"], ranks["host"]
    assert got["driver"] == "device loop" and host["driver"] == "host loop"
    assert got["converged"] == want.converged
    np.testing.assert_allclose(got["x"], want.x, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got["x"], host["x"], rtol=0, atol=1e-12)
    assert (got["iterations"], got["cg_iterations"]) == (host["iterations"],
                                                         host["cg_iterations"])
    assert got["counts"] == host["counts"]
