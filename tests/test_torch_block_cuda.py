"""BASELINE configs[5]'s float64 pose-graph block on the card against the
JAX package's records of the same block (marked gpu; skipped without a
card).

This file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_block_cuda.py

(from the repository root: it imports bench_torch_block.py.)  The block is
bench_torch_block.py's default: block 2 of 4 of make_block(10_000,
1_000_000, seed=2, control_frac=0.01), 2,500 images, 2,781,596
observations, a free network, SchurOptions(float64, cg_maxiter=40,
fused=False) under the host loop.  tests/golden/block2_f64_jax.jsonl holds
the JAX package's trials of that block through its cap of 20 iterations
(bench_block_jax.py, on the CPU); here the port runs the first iterations
and each of its trials is held to the JAX trial of the same number: the
same damping, CG counts within one, the true cost at the trial's start
and the model's cost within COST_RTOL, L1(delta) within L1_RTOL plus a
floor of L1_ATOL_A_TERM a term.

The tolerances are tests/test_torch_block.py's, its L1 floor scaled by
this run's own sum: there L1 is a sum of ~900 corrections held to 1e-6
relative plus 1e-7; here it is a sum over the block's u unknowns, so the
floor is 1e-7 * u / 900 (~9e-5, against L1s of 1e4-7e5).  On the H100
the whole run (20 iterations, both stopped on the cap) agreed with the
records: costs within 7.0e-15 relative, L1 within 1.4e-7 (2.1e-10 in the
first four trials), CG counts and damping equal.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

GOLDEN = Path(__file__).resolve().parent / "golden" / "block2_f64_jax.jsonl"
ITERATIONS = 3
COST_RTOL = 1e-10  # tests/test_torch_block.py
L1_RTOL = 1e-6  # tests/test_torch_block.py
L1_ATOL_A_TERM = 1e-7 / 900  # tests/test_torch_block.py's 1e-7 over its ~900 corrections


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _golden():
    lines = [json.loads(line) for line in GOLDEN.read_text().splitlines()]
    return lines[0], [t for t in lines if "trial" in t], lines[-1]


def test_float64_block_trials_match_jax_records(capsys):
    """The port's first ITERATIONS GN iterations of the block on the card,
    trial for trial, against the JAX package's committed records."""
    dev = _card()
    import bench_torch_block
    from fish_eye_bundle_adjustment_tpu_torch.solver import schur
    from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

    head, want, end = _golden()
    problem = bench_torch_block.block_problem(10_000, 1_000_000, 4, 2, ITERATIONS, 0.01)
    assert (problem.n_img, problem.n_obs) == (head["n_img"], head["n_obs"])
    solver = bench_torch_block.Solver(
        problem, schur.SchurOptions(dtype=np.dtype(np.float64), cg_maxiter=40, fused=False), dev)
    l1_atol = L1_ATOL_A_TERM * ParamLayout(problem).u
    got, outcome = bench_torch_block.solve(solver)
    capsys.readouterr()
    assert "diverged" not in outcome and "diverged" not in end
    assert outcome["iterations"] == ITERATIONS and len(got) >= ITERATIONS
    for g in got:
        w = want[g["trial"] - 1]
        assert g["damping"] == w["damping"], (g, w)
        assert abs(g["cg_iterations"] - w["cg_iterations"]) <= 1, (g, w)
        for k in ("cost_at_start", "model_cost"):
            assert abs(g[k] - w[k]) <= COST_RTOL * abs(w[k]), (k, g[k], w[k])
        assert abs(g["l1_delta"] - w["l1_delta"]) <= L1_RTOL * w["l1_delta"] + l1_atol, (g, w)
