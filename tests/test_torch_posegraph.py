"""The port's pose-graph merge (parallel/posegraph.py) against the JAX
package's, on the CPU.

The numpy pieces are the JAX package's copied: the partition and the
extracted sub-problems must be equal array for array; the similarities,
the pose graph and the mapped blocks (whose rotations the port evaluates
in float64 torch, the JAX package in float64 jnp) within 1e-12.  The whole
merge -- block solves, edges, fusion, refine -- on a 12-image block within
rtol=1e-9, atol=1e-7 on x (tests/test_torch_explicit.py's float64
tolerance: each block and the refine are default float64 Schur solves,
the same arithmetic up to the order of the sums) and 1e-8 relative on
sigma0^2 and the stds.
"""

import contextlib
import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch

from fish_eye_bundle_adjustment_tpu.parallel import posegraph as jpg
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout as JLayout
from fish_eye_bundle_adjustment_tpu_torch.parallel import posegraph as tpg
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout as TLayout

from _torch_blocks import jax_block, one_torch_thread, to_port  # noqa: F401 (autouse)

X_TOL = dict(rtol=1e-9, atol=1e-7)


def _problem_arrays(p):
    return {k: np.asarray(v) for k, v in dataclasses.asdict(p).items() if k != "settings"}


@pytest.mark.parametrize("n_blocks", [2, 3, 4])
def test_partition_and_blocks_equal_jax(n_blocks):
    """partition_images and extract_block: the same image partition and,
    block for block, the same sub-problem arrays, settings (the forced
    free network) and index maps."""
    jp = jax_block("selfcal16")
    tp = to_port(jp)
    jparts = jpg.partition_images(jp, n_blocks)
    tparts = tpg.partition_images(tp, n_blocks)
    assert len(jparts) == len(tparts)
    for jpart, tpart in zip(jparts, tparts):
        np.testing.assert_array_equal(tpart, jpart)
        jsb, tsb = jpg.extract_block(jp, jpart), tpg.extract_block(tp, tpart)
        for k in ("img_idx", "tgt_idx", "tie_tgt_global"):
            np.testing.assert_array_equal(getattr(tsb, k), getattr(jsb, k))
        want, got = _problem_arrays(jsb.problem), _problem_arrays(tsb.problem)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert dataclasses.asdict(tsb.problem.settings) == dataclasses.asdict(jsb.problem.settings)
        assert tsb.problem.settings.inner_constraints


def test_similarity_pieces_equal_jax():
    """umeyama, the 7-vector round trip, the pose-graph least squares, the
    mapping of a block into the global frame and the point fusion on the
    same inputs, within 1e-12."""
    rng = np.random.default_rng(3)
    src = rng.standard_normal((40, 3)) * 50
    ang = 0.3
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    dst = 1.7 * src @ Rz.T + np.array([3.0, -2.0, 5.0]) + rng.standard_normal((40, 3)) * 1e-3
    for want, got in zip(jpg.umeyama(src, dst), tpg.umeyama(src, dst)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    s, R, t = tpg.umeyama(src, dst)
    v = tpg._sim_to_vec(s, R, t)
    np.testing.assert_allclose(v, jpg._sim_to_vec(s, R, t), rtol=1e-12, atol=1e-12)
    for want, got in zip(jpg._vec_to_sim(v), tpg._vec_to_sim(v)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    edges = [(0, 1, rng.standard_normal(7) * 0.01), (1, 2, rng.standard_normal(7) * 0.01),
             (0, 2, rng.standard_normal(7) * 0.01), (2, 3, rng.standard_normal(7) * 0.01)]
    np.testing.assert_allclose(tpg.solve_pose_graph(4, edges), jpg.solve_pose_graph(4, edges),
                               rtol=1e-12, atol=1e-12)

    # a block solution (the block's initial x, moved) mapped by (s, R, t)
    jp = jax_block("selfcal16")
    tp = to_port(jp)
    part = jpg.partition_images(jp, 2)[1]
    jsb, tsb = jpg.extract_block(jp, part), tpg.extract_block(tp, part)
    jl, tl = JLayout(jsb.problem), TLayout(tsb.problem)
    x = jl.initial() + rng.standard_normal(jl.u) * 1e-3
    jeop, jpts = jpg._apply_similarity_to_block(types.SimpleNamespace(layout=jl, x=x), jsb, s, R, t)
    teop, tpts = tpg._apply_similarity_to_block(types.SimpleNamespace(layout=tl, x=x), tsb, s, R, t)
    np.testing.assert_allclose(teop, jeop, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tpts, jpts, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tpg.fuse_block_points(tp, [tsb], [tpts]), jpg.fuse_block_points(jp, [jsb], [jpts]),
        rtol=1e-12, atol=1e-12)


def test_solve_posegraph_matches_jax():
    """solve_posegraph(n_blocks=2, refine=True) on the 12-image block: the
    same edges (block pairs, 7-vectors within 1e-8), the merged poses and
    points, and the refined solve (x, iterations, sigma0^2, stds) as the
    JAX package's."""
    jp = jax_block("eop12")
    want = jpg.solve_posegraph(jp, n_blocks=2, refine=True)
    got = tpg.solve_posegraph(to_port(jp), n_blocks=2, refine=True, device="cpu")
    assert [(a, b) for a, b, _ in got.edges] == [(a, b) for a, b, _ in want.edges]
    for (_, _, tv), (_, _, jv) in zip(got.edges, want.edges):
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-8)
    for tb, jb in zip(got.block_results, want.block_results):
        assert tb.iterations == jb.iterations
        np.testing.assert_allclose(tb.x, jb.x, **X_TOL)
    np.testing.assert_allclose(got.eop, want.eop, **X_TOL)
    np.testing.assert_allclose(got.points, want.points, **X_TOL)
    r, w = got.refined, want.refined
    assert (r.iterations, r.converged, r.stopped_on) == (w.iterations, w.converged, w.stopped_on)
    np.testing.assert_allclose(r.x, w.x, **X_TOL)
    assert abs(r.sigma02 - w.sigma02) <= 1e-8 * w.sigma02
    np.testing.assert_allclose(r.std, w.std, rtol=1e-8)


def test_block_solves_take_a_worker_a_card(monkeypatch):
    """With several cards the block solves take one worker thread a card:
    block i on cuda:(i mod cards), a card's blocks one after the other
    (never two on a card at once), the results in block order.  The cards
    are faked: torch.cuda's count and device context, and nothing is
    loaded for them."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(tpg, "_load_before_threads", lambda: None)
    busy, seen, lock = set(), [], threading.Lock()

    def solver(problem, device, **kw):
        with lock:
            assert device not in busy, f"two blocks at once on {device}"
            busy.add(device)
        time.sleep(0.02)
        with lock:
            busy.discard(device)
            seen.append((problem, device))
        return problem

    subs = [types.SimpleNamespace(problem=i) for i in range(7)]
    got = tpg._solve_blocks(subs, None, solver, True, torch.device("cuda"))
    assert got == list(range(7))
    assert sorted(seen, key=lambda t: t[0]) == [(i, torch.device("cuda", i % 3))
                                                for i in range(7)]
    assert tpg._solve_blocks(subs, None, solver, False, torch.device("cuda")) == list(range(7))
