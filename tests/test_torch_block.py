"""bench_torch_block.py (one free-network block of the pose graph, every GN
trial recorded) on the CPU at a small size, against the JAX package's host
loop on the same block.

The script's records filed BASELINE configs[5]'s float32 block
divergence as the JAX package's own behaviour: on that 2,500-image block
both packages' float64 trials agree to 1e-10, and both float32 solves
diverge alike.  Here, on a 16-image block of the same generator, the two
packages' float64 trials (damping, L1 of the correction, the
true cost at the trial's start, the model's cost at the trial point, CG
iterations) agree trial for trial: the costs within 1e-10 relative, L1
within 1e-6 relative plus 1e-7 (a sum of ~900 corrections whose CG
solution carries the order of the sums, ~1e-10 each: near convergence
an L1 of ~4e-3 moves by ~2e-8), the same damping, and CG counts within
one (at a forcing tolerance of ~4e-6 the sums' order tips the stopping
test by an iteration).  The script's --compare rows hold a float32 step
to float64 in parts.
"""

import dataclasses
import json

import numpy as np
import torch

import jax  # noqa: F401 (the JAX side runs on the CPU)

import bench_torch_block
from fish_eye_bundle_adjustment_tpu.parallel.posegraph import (
    extract_block as jextract,
    partition_images as jpartition,
)
from fish_eye_bundle_adjustment_tpu.solver import schur as jschur
from fish_eye_bundle_adjustment_tpu.synth import make_block
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout as JLayout
from fish_eye_bundle_adjustment_tpu.utils.observe import SolverDivergence as JDivergence
from fish_eye_bundle_adjustment_tpu_torch.solver import schur as tschur

from _torch_blocks import one_torch_thread, to_port  # noqa: F401 (autouse)

COST_RTOL = 1e-10
L1_TOL = dict(rtol=1e-6, atol=1e-7)


def _block(cap=4):
    """Block 1 of 2 of make_block(32, 360, seed=2, control_frac=0.01),
    as bench_torch_block.block_problem cuts it (JAX package's generator)."""
    blk = make_block(n_img=32, n_pts=360, model="fisheye", seed=2,
                     settings_overrides={"inner_constraints": False}, control_frac=0.01)
    sub = jextract(blk.problem, jpartition(blk.problem, 2)[1]).problem
    return dataclasses.replace(sub, settings=dataclasses.replace(
        sub.settings, iteration_cap=cap))


def _jax_trials(problem, dtype):
    """The JAX package's host loop over its unfused step, every trial
    recorded as bench_torch_block records it."""
    opts = jschur.SchurOptions(dtype=dtype, cg_maxiter=40, fused=False, device_loop=False)
    layout = JLayout(problem)
    kernel = jschur.SchurKernel(layout, opts, obs_order=opts.obs_order)
    order = jschur.ObsData.sort_order_by_tie(problem, layout)
    obs = jschur.ObsData.from_problem(problem, layout, dtype=dtype, order=order, with_plan=True)
    raw = jax.jit(jschur.schur_step_fn(kernel, layout, problem.settings.inner_constraints))
    trials = []

    def step(x, o, tol, lam):
        res = raw(x, o, tol, lam, None)
        s = np.asarray(res[3], np.float64)
        trials.append(dict(damping=float(lam), l1_delta=float(res[1]),
                           cost_at_start=float(s[3]), model_cost=float(s[0]),
                           cg_iterations=int(res[4])))
        return res

    try:
        jschur.run_gn_loop(step, obs, layout, problem, opts)
        outcome = "ran"
    except JDivergence:
        outcome = "diverged"
    return trials, outcome


def _port_trials(problem, dtype, capsys):
    solver = bench_torch_block.Solver(
        to_port(problem), tschur.SchurOptions(dtype=dtype, cg_maxiter=40, fused=False), "cpu")
    trials, outcome = bench_torch_block.solve(solver)
    capsys.readouterr()
    return trials, "diverged" if "diverged" in outcome else "ran"


def test_float64_trials_match_jax(capsys):
    """Trial for trial, the same record as the JAX package's host loop in
    float64."""
    p = _block()
    assert p.n_img <= 16 and p.n_tie <= 250
    got, got_end = _port_trials(p, np.float64, capsys)
    want, want_end = _jax_trials(p, np.float64)
    assert got_end == want_end
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["damping"] == w["damping"], (g, w)
        assert abs(g["cg_iterations"] - w["cg_iterations"]) <= 1, (g, w)
        for k in ("cost_at_start", "model_cost"):
            np.testing.assert_allclose(g[k], w[k], rtol=COST_RTOL, err_msg=k)
        np.testing.assert_allclose(g["l1_delta"], w["l1_delta"], **L1_TOL)


def test_script_prints_trials_and_compare_rows(capsys):
    """main() prints the block, one line a trial and the outcome; with
    --compare one row a trial of the float32 paths' distances from
    float64, part by part (no fused path where the band plan is refused;
    here it takes the block)."""
    args = ["--n-img", "32", "--n-pts", "360", "--blocks", "2", "--block", "1", "--cpu"]
    bench_torch_block.main(args + ["--cap", "2", "--unfused"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[0]["n_img"] <= 16 and lines[0]["band"]["W"] > 0
    assert [t["trial"] for t in lines[1:-1]] == list(range(1, len(lines) - 1))
    assert lines[-1]["path"] == "unfused float32" and lines[-1]["iterations"] == 2
    bench_torch_block.main(args + ["--cap", "1", "--compare"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    parts = [r for r in rows if "rhs" in r]
    assert parts and all(set(r["rhs"]) == {"f64", "fused f32 vs f64", "unfused f32 vs f64",
                                            "fused vs unfused"} for r in parts)
    for r in parts:
        assert r["cost"]["unfused f32 vs f64"][0] < 1e-4
        assert r["rhs"]["fused vs unfused"][0] < 1e-3
    assert torch.get_num_threads() == 1
