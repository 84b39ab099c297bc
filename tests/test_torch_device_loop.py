"""The port's device loop (solver/device_loop.py) against the JAX package's
device loop, on the CPU, and against the port's own host loop.

Both packages run the matrix-free Schur step: ``explicit_s=False`` on
both sides, since a small float64 block otherwise takes the explicit
dense S, whose PairPlan sends both packages to the host loop.  On the CPU
the port's chunk body runs eagerly; the JAX package's runs under
lax.while_loop.

Tolerances (float64, the 12-image / 240-point fisheye block of
tests/test_device_loop.py): the same iterations, stop and accept/reject
sequence; x within atol 1e-10, sigma0^2 within 1e-10 relative, the
residual rows within atol 1e-9.  delta_history within rtol 1e-6 plus atol
1e-9: the last corrections of a converging solve are L1 norms of ~1e-8,
whose CG solution differs between the packages at the 1e-11 level of x
(the order of the sums), a 1e-3 share of such a norm.  The float32 fused
solve (the JAX fused kernels in interpret mode) within X_TOL (rtol 3e-5,
atol 3e-4), its iterations within one.
"""

import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch

import jax  # noqa: F401 (the JAX side runs on the CPU)

from fish_eye_bundle_adjustment_tpu.solver import schur as jschur
from fish_eye_bundle_adjustment_tpu.synth import make_block
from fish_eye_bundle_adjustment_tpu.utils import checkpoint as jckpt
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout as JLayout
from fish_eye_bundle_adjustment_tpu.utils.observe import SolverDivergence as JDivergence
from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop as tdl
from fish_eye_bundle_adjustment_tpu_torch.solver import schur as tschur
from fish_eye_bundle_adjustment_tpu_torch.utils import checkpoint as tckpt
from fish_eye_bundle_adjustment_tpu_torch.utils.observe import SolverDivergence as TDivergence

from _torch_blocks import jax_block, lm_block, one_torch_thread, to_port  # noqa: F401 (autouse)
from _torch_dist_worker import run_group

X_TOL = dict(rtol=3e-5, atol=3e-4)
DELTA_TOL = dict(rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module", autouse=True)
def _one_cg_iteration_per_trip():
    """The JAX _pcg's block of masked iterations only saves TPU loop
    overhead; its semantics are the guarded loop's whatever the block size.
    One iteration a trip halves the JAX compiles here (the fused kernels
    are traced in interpret mode once a trip)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jschur, "_CG_UNROLL", 1)
        yield


@functools.lru_cache(maxsize=None)
def _block(n_img=12, n_pts=240, seed=13):
    return make_block(n_img=n_img, n_pts=n_pts, model="fisheye", seed=seed).problem


def _with(problem, **settings):
    return dataclasses.replace(problem, settings=dataclasses.replace(problem.settings, **settings))


def _x0_diverge(problem):
    """tests/test_device_loop.py's start outside the basin (non-adaptive)."""
    layout = JLayout(problem)
    rng = np.random.default_rng(11)
    return layout.initial() * (1.0 + rng.normal(0, 0.5, layout.u)) + rng.normal(0, 10.0, layout.u)


X_ATOL = dict(rtol=0, atol=1e-10)
# a solve through rejections, held where it converges: its iterates follow
# the sums' order through the damped steps, and land together at the
# solution (tests/test_torch_explicit.py's tolerance for the same block)
X_TOL_LM = dict(rtol=1e-9, atol=1e-7)
# ... and its corrections and lambdas on the way there within 1e-4 (5.8e-5
# and 1.1e-5 measured through the damped steps)
DELTA_TOL_LM = dict(rtol=1e-4, atol=1e-9)

# case -> (problem, options both packages take, x and delta_history tolerances)
CASES = {
    "converge": (lambda: _block(), dict(device_chunk=4), (X_ATOL, DELTA_TOL)),
    # selfcal16 with its tie points moved by N(0, 240 m): the first trial
    # raises the cost and is rejected, the LM controller damps the next ones
    "reject": (lambda: lm_block(scale=240.0, iteration_cap=40), dict(device_chunk=3),
               (X_TOL_LM, DELTA_TOL_LM)),
    "cap": (lambda: _with(_block(), iteration_cap=3), dict(device_chunk=2), (X_ATOL, DELTA_TOL)),
}


def _run(pkg, case, chunk=None, device_loop=True, **extra):
    """(result, progress records) of one package's solve of `case`."""
    make, opts, _ = CASES[case]
    opts = dict(opts, explicit_s=False, device_loop=device_loop)
    if chunk is not None:
        opts["device_chunk"] = chunk
    recs = []
    kw = dict(compute_covariance=False, progress_fn=recs.append, **extra)
    p = make()
    if pkg == "jax":
        return jschur.solve_schur(p, jschur.SchurOptions(**opts), **kw), recs
    return tschur.solve_schur(to_port(p), tschur.SchurOptions(**opts), device="cpu", **kw), recs


_JAX = {}


def _jax(case):
    if case not in _JAX:
        _JAX[case] = _run("jax", case)
    return _JAX[case]


def _assert_same(got, want, got_recs=None, want_recs=None, tols=(X_ATOL, DELTA_TOL)):
    assert (got.iterations, got.converged, got.stopped_on) == (
        want.iterations, want.converged, want.stopped_on)
    np.testing.assert_allclose(got.x, want.x, **tols[0])
    np.testing.assert_allclose(got.delta_history, want.delta_history, **tols[1])
    assert abs(got.sigma02 - want.sigma02) <= 1e-10 * want.sigma02
    np.testing.assert_allclose(got.v, want.v, rtol=0, atol=1e-9)
    if want_recs is not None:
        assert [(r.iteration, r.accepted) for r in got_recs] == [
            (r.iteration, r.accepted) for r in want_recs]
        # lambda (packed to float32 by both) follows the gain ratios, held
        # as the corrections are
        np.testing.assert_allclose([r.damping for r in got_recs],
                                   [r.damping for r in want_recs], rtol=tols[1]["rtol"],
                                   atol=1e-300)


@pytest.mark.parametrize("case, chunk", [("converge", 4), ("converge", 1), ("reject", None),
                                         ("cap", None)])
def test_matches_jax_device_loop(case, chunk):
    """The port's device loop against the JAX package's (at the JAX
    case's chunk; the port also at chunk 1, which reads the host once a
    step): converging, rejecting (LM raise-and-double) and capped solves.
    The port's own CG counts come with it, one a step."""
    want, want_recs = _jax(case)
    got, got_recs = _run("port", case, chunk=chunk)
    _assert_same(got, want, got_recs, want_recs, tols=CASES[case][2])
    assert tdl.loop_counts["graph"] is False
    assert len(got.cg_iterations) == tdl.loop_counts["steps"] >= got.iterations
    assert all(c > 0 for c in got.cg_iterations)
    chunk = chunk or CASES[case][1]["device_chunk"]
    # one packed read a chunk until the chunk that stops
    assert tdl.loop_counts["reads"] == -(-tdl.loop_counts["steps"] // chunk)
    if case == "reject":
        assert any(not r.accepted for r in got_recs)


@pytest.mark.parametrize("case", ["converge", "reject"])
def test_matches_own_host_loop(case):
    """The device loop is the host loop's algorithm: on the CPU the same
    arithmetic, so the same iterates bit for bit, the same trail of
    accepts, rejects and lambdas, the same CG counts; delta_history
    rounded to float32 as the JAX package packs its records."""
    dev, dev_recs = _run("port", case)
    host, host_recs = _run("port", case, device_loop=False)
    np.testing.assert_array_equal(dev.x, host.x)
    np.testing.assert_array_equal(dev.v, host.v)
    assert dev.sigma02 == host.sigma02 and dev.cg_iterations == host.cg_iterations
    assert [(r.iteration, r.accepted, r.damping) for r in dev_recs] == [
        (r.iteration, r.accepted, float(np.float32(r.damping))) for r in host_recs]
    np.testing.assert_array_equal(
        dev.delta_history, np.float32(host.delta_history).astype(np.float64))


def test_plateau_stop():
    """The plateau stop: resumed from a checkpoint whose last ten
    corrections are flat (640 each, iteration 10), the first accepted step
    (L1 637.3, within 2% and not improving) stops both packages on
    "plateau" at iteration 11 -- and the port's host loop too."""
    p = _block()
    x0 = JLayout(p).initial()
    out = {}
    for name, mod, prob, solve, opts in (
        ("jax", jckpt, p, jschur.solve_schur, jschur.SchurOptions),
        ("port", tckpt, to_port(p), lambda *a, **k: tschur.solve_schur(*a, device="cpu", **k),
         tschur.SchurOptions),
        ("port host", tckpt, to_port(p),
         lambda *a, **k: tschur.solve_schur(*a, device="cpu", **k),
         lambda **k: tschur.SchurOptions(**dict(k, device_loop=False))),
    ):
        path = _tmp() / f"{name}.npz"
        mod.save_checkpoint(path, mod.SolverCheckpoint(
            x=x0, iteration=10, delta_history=[640.0] * 10,
            meta={k: str(v) for k, v in mod.problem_fingerprint(prob).items()}))
        kw = dict(explicit_s=False)
        if name != "port host":
            kw["device_loop"] = True
        out[name] = solve(prob, opts(**kw), compute_covariance=False, checkpoint_path=path)
    want = out["jax"]
    assert (want.stopped_on, want.iterations, want.converged) == ("plateau", 11, True)
    _assert_same(out["port"], want)
    got = out["port host"]
    assert (got.stopped_on, got.iterations) == ("plateau", 11)
    np.testing.assert_array_equal(got.x, out["port"].x)


@functools.lru_cache(maxsize=None)
def _tmp():
    import tempfile
    from pathlib import Path

    return Path(tempfile.mkdtemp(prefix="device_loop_"))


def test_checkpoint_resume_at_chunk_boundaries():
    """Capped at 2 iterations at chunk 2 with a checkpoint, then resumed
    to convergence: both packages save at the chunk boundary (iteration 2)
    and resume to the same solution and iteration count."""
    p = _block()
    res = {}
    for name in ("jax", "port"):
        path = _tmp() / f"resume_{name}.npz"
        capped = _with(p, iteration_cap=2)
        for prob, chunk in ((capped, 2), (p, 16)):
            opts = dict(explicit_s=False, device_loop=True, device_chunk=chunk)
            kw = dict(compute_covariance=False, checkpoint_path=path)
            if name == "jax":
                r = jschur.solve_schur(prob, jschur.SchurOptions(**opts), **kw)
            else:
                r = tschur.solve_schur(to_port(prob), tschur.SchurOptions(**opts),
                                       device="cpu", **kw)
            res[name, chunk] = r
        saved = (jckpt if name == "jax" else tckpt).load_checkpoint(
            path, p if name == "jax" else to_port(p))
        res[name, "saved"] = saved.iteration
    assert res["port", 2].iterations == res["jax", 2].iterations == 2
    assert not res["port", 2].converged and res["port", 2].stopped_on == "cap"
    np.testing.assert_allclose(res["port", 2].x, res["jax", 2].x, rtol=0, atol=1e-10)
    assert res["port", 16].converged and res["jax", 16].converged
    assert res["port", 16].iterations == res["jax", 16].iterations > 2
    np.testing.assert_allclose(res["port", 16].x, res["jax", 16].x, rtol=0, atol=1e-10)
    assert res["port", "saved"] == res["jax", "saved"]


def test_divergence_raises_as_jax():
    """Non-adaptive: a start with a NaN coordinate makes the first
    correction NaN, and both device loops raise SolverDivergence at
    iteration 2 (the JAX loop's count + 1, one more than the host loop's
    1); a start far outside the basin (tests/test_device_loop.py's) makes
    all three raise, the device loop one iteration past the port's own
    host loop on the same trajectory (the two packages' blow-ups follow
    the sums' order and part after a few steps)."""
    p = make_block(n_img=8, n_pts=120, seed=3).problem
    opts = dict(adaptive_damping=False, plateau_detection=False, explicit_s=False,
                device_chunk=4)
    nan_x0 = JLayout(p).initial()
    nan_x0[0] = np.nan
    for x0 in (nan_x0, _x0_diverge(p)):
        with pytest.raises(JDivergence) as want:
            jschur.solve_schur(p, jschur.SchurOptions(device_loop=True, **opts),
                               compute_covariance=False, x0=x0)
        raised = {}
        for dl in (None, False):
            with pytest.raises(TDivergence) as got:
                tschur.solve_schur(to_port(p), tschur.SchurOptions(device_loop=dl, **opts),
                                   compute_covariance=False, x0=x0, device="cpu")
            raised[dl] = got.value
        assert raised[None].iteration == raised[False].iteration + 1
        np.testing.assert_array_equal(raised[None].history,
                                      np.float32(raised[False].history).astype(np.float64))
        if x0 is nan_x0:
            assert raised[None].iteration == want.value.iteration == 2
            assert np.isnan(raised[None].delta_l1) and np.isnan(want.value.delta_l1)


def test_fused_f32_matches_jax():
    """Float32 through the fused operator (the port's plain K1/K2, the JAX
    Pallas kernels in interpret mode) at "bf16x2", both device loops at
    chunk 4, on tests/test_torch_schur.py's eop12 block capped at 6
    iterations: the same stop, iterations within one, x within X_TOL."""
    p = jax_block("eop12", iteration_cap=6)
    kw = dict(dtype=np.float32, device_loop=True, device_chunk=4,
              fused_precision="bf16x2", fused_precision_mv="bf16x2")
    want = jschur.solve_schur(p, jschur.SchurOptions(fused=True, **kw), compute_covariance=False)
    got = tschur.solve_schur(to_port(p), tschur.SchurOptions(**kw), compute_covariance=False,
                             device="cpu")
    assert got.stopped_on == want.stopped_on
    assert abs(got.iterations - want.iterations) <= 1
    np.testing.assert_allclose(got.x, want.x, **X_TOL)
    assert abs(got.sigma02 - want.sigma02) <= 1e-4 * want.sigma02


def test_dispatch_follows_the_jax_rule():
    """device_loop=None takes the device loop exactly where the JAX
    package's solve_schur does (no explicit dense S, no kept history);
    False always the host loop; True raises only for those two cases (and
    for a mesh that spans hosts: tests/test_torch_hosts.py).  The rule is
    the same at every rank count and device on one host: it takes neither
    (over several ranks on the card the collectives are the peer kernels
    that the graph's IF nodes hold), and True no longer raises for ranks."""
    default = tschur.SchurOptions()
    assert tschur.use_device_loop(default, False)
    assert not tschur.use_device_loop(default, False, pairs=object())
    assert not tschur.use_device_loop(default, True)
    assert not tschur.use_device_loop(tschur.SchurOptions(device_loop=False), False)
    asked = tschur.SchurOptions(device_loop=True)
    assert list(inspect.signature(tschur.use_device_loop).parameters) == [
        "opts", "keep_history", "pairs", "mesh"]
    assert tschur.use_device_loop(asked, False)
    with pytest.raises(ValueError, match="device_loop=True: keep_history"):
        tschur.use_device_loop(asked, True)
    with pytest.raises(ValueError, match="device_loop=True: the explicit dense S"):
        tschur.use_device_loop(asked, False, pairs=object())
    got = tschur.solve_schur(to_port(_block()), tschur.SchurOptions(explicit_s=False),
                             keep_history=True, compute_covariance=False, device="cpu")
    assert got.x_history.shape[0] == got.iterations + 1


def test_distributed_device_loop_two_ranks():
    """solve_schur_distributed at two gloo ranks under the device loop
    (device_loop=None: the default at every rank count) and the host
    loop, against the single-device device loop: the same iterations and
    stop, x within atol 1e-8 (the order of the sums), and the device
    loop's x equal to the host loop's at the same ranks within 1e-12."""
    p = to_port(_block())
    cases = {name: ("solve", dict(mode="distributed", problem=p,
                                  opts=dict(explicit_s=False, device_loop=dl)))
             for name, dl in (("device", None), ("host", False))}
    got = run_group(2, cases)
    one = tschur.solve_schur(p, tschur.SchurOptions(explicit_s=False), compute_covariance=False,
                             device="cpu")
    dev, host = got["device"], got["host"]
    assert dev["driver"] == "device loop" and host["driver"] == "host loop"
    assert (dev["iterations"], dev["stopped_on"]) == (one.iterations, one.stopped_on)
    assert (host["iterations"], host["stopped_on"]) == (one.iterations, one.stopped_on)
    np.testing.assert_allclose(dev["x"], one.x, rtol=0, atol=1e-8)
    np.testing.assert_allclose(dev["x"], host["x"], rtol=0, atol=1e-12)
    assert dev["cg_iterations"] == host["cg_iterations"]
