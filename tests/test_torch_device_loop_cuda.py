"""The device loop's CUDA graph on the card (marked gpu; skipped without one).

This file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_device_loop_cuda.py

Whether there is a card is decided inside each test.

- utils/cudagraph.run_if under capture: IF nodes (nested, with
  allocations, cuBLAS and the K4 kernel in their bodies) run their body
  exactly when the flag is set at replay.
- solver/device_loop on small float64 (unfused, K4) and float32 (fused,
  K1/K2) blocks: the captured graph against the eager body on the card,
  bitwise (the same kernels on the same inputs in the same order), and
  against the host loop on the card within rtol=3e-5, atol=3e-4 (the
  same steps; the forcing tolerance is computed in the solver dtype on the
  device, in float64 on the host); the float64 solve against the same
  solve on the CPU (plain versions) within rtol=1e-9, atol=1e-7 (a float32
  solve of this block drifts past X_TOL between the kernels and the plain
  versions over six bf16 steps; phase 5 of chip_smoke.py holds a 12-image
  one).  The launch counters (the replays' launches counted on the card,
  utils/cudagraph.count_launch) hold the warm-up body's launches plus, per
  step, the body's own and one (K2) or two (K4) a CG matvec run
  (schur.cg_matvecs): the IF nodes skip the CG blocks past CG's stop.
"""

import numpy as np
import pytest
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import fusedmv, prefix
from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop, schur
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
from fish_eye_bundle_adjustment_tpu_torch.utils.cudagraph import StepGraph, run_if
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

pytestmark = pytest.mark.gpu

X_TOL = {np.float64: dict(rtol=1e-9, atol=1e-7), np.float32: dict(rtol=3e-5, atol=3e-4)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _capture(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = StepGraph()
    g.capture(fn)
    return g


def test_if_nodes():
    """Nested IF nodes with allocations in their bodies: the outer body
    adds 1 when the flag is set, the inner adds 10 once the sum passes 6."""
    dev = _card()
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    acc = torch.zeros(4, device=dev)

    def fn():
        def outer():
            acc.copy_(acc + 1.0)
            run_if(acc.sum() > 6, lambda: acc.add_(10.0))
        run_if(flag.clone(), outer)

    g = _capture(fn)
    acc.zero_()
    for f in (False, True, True, False):
        flag.fill_(f)
        g.replay()
    torch.cuda.synchronize()
    assert acc.tolist() == [12.0] * 4


def test_if_node_runs_kernels_and_cublas():
    """cuBLAS, inv_ex and the K4 kernel in an IF body: equal to the eager
    run when the flag is set, nothing written when it is not."""
    dev = _card()
    g64 = torch.Generator(device="cpu").manual_seed(0)
    A = torch.randn(100, 6, 6, generator=g64, dtype=torch.float64).to(dev)
    vals = torch.randn(4096 * 4, 6, generator=g64, dtype=torch.float64).to(dev)
    out = torch.zeros(100, 6, 6, dtype=torch.float64, device=dev)
    pre = torch.zeros_like(vals)
    flag = torch.ones((), dtype=torch.bool, device=dev)

    def body():
        out.copy_(schur.inv_blocks(A @ A.transpose(1, 2) + torch.eye(6, device=dev)))
        pre.copy_(prefix.chunk_prefix(vals)[0])

    g = _capture(lambda: run_if(flag.clone(), body))
    want_out, want_pre = out.clone(), pre.clone()
    out.zero_()
    pre.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want_out) and torch.equal(pre, want_pre)
    flag.fill_(False)
    out.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert not out.any()


def _problem(dtype):
    selfcal = dict(estimate_c=True, estimate_xp=True, estimate_yp=True,
                   estimate_radial=True, estimate_decent=True)
    return make_block(n_img=40, n_pts=600, model="fisheye", seed=2, control_frac=0.05,
                      settings_overrides={"inner_constraints": False, "iteration_cap": 6,
                                          **selfcal}).problem


def _solve(p, dtype, device, capture=None):
    """The device loop as solve_schur drives it, with `capture` passed on."""
    opts = schur.SchurOptions(dtype=dtype, explicit_s=False, cg_maxiter=40, device_chunk=4)
    layout = ParamLayout(p)
    kern = schur.SchurKernel(layout, opts)
    plan = schur.make_band_plan(p, layout, opts)
    obs = schur.ObsData.from_problem(p, layout, plan, dtype=dtype, device=device)
    step = schur.schur_step_fn(kern, layout, p.settings.inner_constraints)
    cg = []
    out = device_loop.run_gn_loop_device(step, obs, layout, p, opts, device=device,
                                         chunk=opts.device_chunk, capture=capture,
                                         cg_iterations=cg)
    x, _, deltas, v, stats, count, converged, _, stopped_on = out
    return dict(x=x.cpu().numpy(), v=v.cpu().numpy(), stats=stats.cpu().numpy(),
                deltas=deltas, count=count, stopped_on=stopped_on, cg=cg)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64_unfused", "f32_fused"])
def test_graph_matches_eager_and_cpu(dtype):
    dev = _card()
    p = _problem(dtype)
    for mod in (fusedmv, prefix):
        mod.reset_counts()
    graph = _solve(p, dtype, dev)
    counts = dict(device_loop.loop_counts)
    assert counts["graph"] and counts["steps"] == len(graph["cg"])
    launches = dict(fusedmv.kernel_launches if dtype == np.float32 else prefix.kernel_launches)
    eager = _solve(p, dtype, dev, capture=False)
    for k in ("x", "v", "stats"):
        np.testing.assert_array_equal(graph[k], eager[k])
    assert graph["deltas"] == eager["deltas"] and graph["cg"] == eager["cg"]
    host = schur.solve_schur(p, schur.SchurOptions(dtype=dtype, explicit_s=False, cg_maxiter=40,
                                                   device_loop=False),
                             compute_covariance=False, device=dev)
    assert graph["count"] == host.iterations and graph["cg"] == host.cg_iterations
    np.testing.assert_allclose(graph["x"], host.x, **X_TOL[np.float32])
    if dtype == np.float64:
        cpu = _solve(p, dtype, "cpu")
        assert graph["count"] == cpu["count"] and graph["stopped_on"] == cpu["stopped_on"]
        np.testing.assert_allclose(graph["x"], cpu["x"], **X_TOL[dtype])
    # the counters hold the warm-up body's launches and what the replays
    # ran: per step the body's own and one (K2) or two (K4) a CG matvec run
    mod = "fusedmv" if dtype == np.float32 else "prefix"
    steps, mv = len(graph["cg"]), sum(schur.cg_matvecs(c, 40) for c in graph["cg"])
    want = ({"fused_hpp_pass": steps, "fused_schur_apply": 2 * steps + mv}
            if dtype == np.float32 else {"chunk_prefix": 6 * steps + 2 * mv})
    assert {k: n for k, n in counts["replayed"].items() if isinstance(k, str)} == want
    assert launches == {k: counts["warmup"][mod][k] + n for k, n in want.items()}
    # every CG block is captured; the IF nodes skip those past the stop
    assert counts["per_body"]["cg"]["matvecs"] == 40
    assert counts["per_body"]["cg"]["host_reads"] == 0


def test_unfused_default_solve_runs_the_cg_blocks_it_needs():
    """solve_schur's default driver on the unfused float64 path at
    cg_maxiter = 500 (63 CG blocks captured a step): the trace holds the
    warm-up body's K4 launches plus 6 a step and 2 a CG matvec run, so the
    IF nodes skipped every block past CG's stop (tie sums of 3 columns,
    image sums of 6, the pose preconditioner's 21); x and the CG counts
    are the host loop's."""
    dev = _card()
    p = make_block(n_img=12, n_pts=150, model="fisheye", seed=13, control_frac=0.08,
                   settings_overrides={"inner_constraints": False}).problem
    opts = schur.SchurOptions(explicit_s=False)
    prefix.reset_counts()
    res = schur.solve_schur(p, opts, compute_covariance=False, device=dev)
    lc = device_loop.loop_counts
    cg = res.cg_iterations
    assert lc["graph"] and lc["steps"] == len(cg)
    assert lc["per_body"]["cg"]["matvecs"] == 8 * -(-opts.cg_maxiter // 8)
    mv = sum(schur.cg_matvecs(c, opts.cg_maxiter) for c in cg)
    assert mv < len(cg) * lc["per_body"]["cg"]["matvecs"]
    steps = len(cg)
    assert lc["replayed"] == {"chunk_prefix": 6 * steps + 2 * mv,
                              3: mv + 2 * steps, 6: mv + 3 * steps, 21: steps}
    warm = lc["warmup"]
    assert prefix.kernel_launches["chunk_prefix"] == (
        warm["prefix"]["chunk_prefix"] + 6 * steps + 2 * mv)
    assert prefix.kernel_launches_by_width == {
        d: warm["prefix_by_width"].get(d, 0) + n
        for d, n in ((3, mv + 2 * steps), (6, mv + 3 * steps), (21, steps))}
    host = schur.solve_schur(p, schur.SchurOptions(explicit_s=False, device_loop=False),
                             compute_covariance=False, device=dev)
    assert res.iterations == host.iterations and cg == host.cg_iterations
    np.testing.assert_allclose(res.x, host.x, **X_TOL[np.float64])
