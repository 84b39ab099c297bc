"""The plain reference (refba.py) against the port at a tiny block, and the
control: the program's own path one precision below the stated one comes
out not correct.

    python -m pytest -q benchmark/test_bench_reference.py   # from the repository root
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(HERE), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import blockgen  # noqa: E402
import harness  # noqa: E402
import port  # noqa: E402
import refba  # noqa: E402
from fish_eye_bundle_adjustment_tpu_torch.models.projection import (  # noqa: E402
    MODEL_IDS,
    batched_jacobian_blocks,
)

TINY = dict(n_img=16, n_pts=300)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(workload: str) -> harness.Cell:
    cell = harness.Cell.load(ROOT, workload)
    cell.config = dict(cell.config, **TINY)
    return cell


def test_residuals_and_jacobians_agree_with_the_port():
    cell = tiny_cell("selfcal_1k.f32")
    block = blockgen.from_config(cell.config)
    init = blockgen.initial(block, 5, 1, cell.traffic["init_sigmas"])
    iop = init.iop.copy()
    rm = float(block.rmax[0])
    iop[0, :2] = [3.0, -2.0]  # principal point, px
    iop[0, 3] = 2e-2 / rm**2  # k1 (1% at the corner)
    iop[0, 4:6] = [1e-3 / rm, -2e-3 / rm]  # p1 p2
    ref = refba.Problem(block, "cpu")
    d = lambda a: torch.as_tensor(a, dtype=torch.float64)
    e, i, x = d(init.eop)[ref.img], d(iop)[ref.cam], d(init.points)[ref.pt]
    r_ref, Je, Ji, Jp = ref._jacobian_chunk(d(init.eop), d(iop), d(init.points),
                                            slice(0, block.n_obs))
    r, Je_p, Ji_p, Jp_p = batched_jacobian_blocks(
        e, iop_row := d(iop)[0], x, ref.meas, torch.tensor(1.0, dtype=torch.float64),
        MODEL_IDS["fisheye"], block.nk)
    assert iop_row.shape == (5 + block.nk,)
    torch.testing.assert_close(r_ref, r, rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(Je, Je_p[:, :, ref.eop_cols], rtol=1e-10, atol=1e-9)
    scale = torch.as_tensor(ref.iop_scale[ref.iop_cols])
    torch.testing.assert_close(Ji, Ji_p[:, :, ref.iop_cols] / scale, rtol=1e-10, atol=1e-12)
    live = (ref.tie < ref.n_tie)[:, None, None]
    torch.testing.assert_close(Jp, Jp_p * live, rtol=1e-10, atol=1e-12)


def test_the_reference_finds_the_ports_float64_answer_optimal():
    cell = tiny_cell("selfcal_1k.f64")
    block = blockgen.from_config(cell.config)
    prep = port.Prepared(block, cell.traffic, "cpu")
    init = blockgen.initial(block, 9, 1, cell.traffic["init_sigmas"])
    ans = prep.adjust(init)
    ref = refba.Problem(block, "cpu")
    start = refba.judge(ref, init.eop, init.iop, init.points, 1.0)
    j = refba.judge(ref, *prep.tables(ans.x), prep.sigma02(ans))
    assert start["cost_gap"] > 0.5  # the initial approximations are far off
    assert j["cost_gap"] < 1e-18 and j["max_shift_m"] < 1e-8 and j["sigma02_gap"] < 1e-12
    assert abs(j["sigma02"] - 1) < 0.1


def test_the_reference_sees_the_point_it_is_given():
    cell = tiny_cell("selfcal_1k.f64")
    block = blockgen.from_config(cell.config)
    ref = refba.Problem(block, "cpu")
    eop, iop, pts = block.true_eop, block.iop0, block.true_points
    g = ref.gn_correction(eop, iop, pts)
    moved = pts.copy()
    moved[block.tie_target_idx[0]] += [2.0, 0.0, 0.0]
    g2 = ref.gn_correction(eop, iop, moved)
    assert g2["cost"] > g["cost"]
    # the correction takes the moved point back by about its shift
    assert abs(float(g2["dpts"][0, 0]) + 2.0) < 0.5
    assert np.isfinite(g2["pred"]) and g2["cg_rel_residual"] < 1e-8


def test_a_reference_cg_short_of_its_tolerance_judges_nothing_correct():
    cell = tiny_cell("selfcal_1k.f64")
    block = blockgen.from_config(cell.config)
    ref = refba.Problem(block, "cpu")
    eop, iop, pts = block.true_eop, block.iop0, block.true_points
    solved = refba.judge(ref, eop, iop, pts, 1.0)
    short = refba.judge(ref, eop, iop, pts, 1.0, cg_maxiter=1)
    assert solved["cg_rel_residual"] <= refba.CG_TOL
    assert np.isfinite(solved["cost_gap"]) and np.isfinite(solved["max_shift_m"])
    assert short["cg_rel_residual"] > refba.CG_TOL
    assert short["cost_gap"] == np.inf and short["max_shift_m"] == np.inf


@pytest.mark.parametrize("workload", ["selfcal_1k.f32", "selfcal_1k.f64"])
def test_the_control_is_not_correct(workload):
    cell = tiny_cell(workload)
    sound = harness.run(cell, 31, 0.0, False, time.perf_counter(), device="cpu")
    control = harness.run(cell, 31, 0.0, False, time.perf_counter(), device="cpu",
                          overrides=cell.traffic["control"])
    assert sound["correct"] is True, sound["checks"]
    assert control["correct"] is False, control["checks"]
