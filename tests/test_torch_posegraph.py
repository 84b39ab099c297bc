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
sigma0^2 and the stds.  The block solves a process a card
(_solve_blocks): one real spawn of two CPU processes against the serial
solves, bitwise; the rest with faked cards, the processes run as
threads of this process.
"""

import dataclasses
import inspect
import threading
import time
import types

import numpy as np
import pytest
import torch

from fish_eye_bundle_adjustment_tpu.parallel import posegraph as jpg
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout as JLayout
from fish_eye_bundle_adjustment_tpu_torch.ops import _build
from fish_eye_bundle_adjustment_tpu_torch.parallel import mesh as pmesh
from fish_eye_bundle_adjustment_tpu_torch.parallel import posegraph as tpg
from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop
from fish_eye_bundle_adjustment_tpu_torch.solver.schur import solve_schur
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


class _ThreadProcess:
    """A multiprocessing Process run as a thread of this process: the
    block-process tests below fake their cards, which only threads share."""

    def __init__(self, target, args):
        self.exitcode = None
        self._thread = threading.Thread(target=self._run, args=(target, args))

    def _run(self, target, args):
        try:
            target(*args)
            self.exitcode = 0
        except SystemExit as e:
            self.exitcode = e.code

    def start(self):
        self._thread.start()

    def is_alive(self):
        return self._thread.is_alive()

    def join(self, timeout=None):
        self._thread.join(timeout)

    def terminate(self):
        pass

    kill = terminate


class _ThreadContext:
    def Process(self, target, args):
        return _ThreadProcess(target, args)


@pytest.fixture
def fake_cards(monkeypatch):
    """Three faked cards: torch.cuda's count, the block processes' start on
    a card and the kernel library are stubbed, and the processes are
    threads of this process."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(tpg, "_start_on", lambda device: None)
    monkeypatch.setattr(_build, "load", lambda: None)
    monkeypatch.setattr(pmesh.multiprocessing, "get_context", lambda method: _ThreadContext())
    return tpg._block_devices(torch.device("cuda"), True, 7)


_busy, _seen, _lock = set(), [], threading.Lock()


def card_solver(problem, device, **kw):
    """A module-level block solver (the processes need one) that fails when
    two blocks share a card at once; each problem is its block's index."""
    with _lock:
        assert device not in _busy, f"two blocks at once on {device}"
        _busy.add(device)
    time.sleep(0.02)
    with _lock:
        _busy.discard(device)
        _seen.append((problem, device))
    if problem == 5 and kw.get("options") == "fail":
        raise ValueError("block 5 failed")
    return problem


def test_block_processes_take_a_card_each(fake_cards):
    """With several cards the block solves take one process a card: block i
    on cuda:(i mod cards), a card's blocks one after the other (never two
    on a card at once), the results in block order."""
    assert fake_cards == [torch.device("cuda", k) for k in range(3)]
    _seen.clear()
    subs = [types.SimpleNamespace(problem=i) for i in range(7)]
    got, runs = tpg._solve_blocks(subs, None, card_solver, fake_cards)
    assert got == list(range(7))
    assert sorted(_seen, key=lambda t: t[0]) == [(i, torch.device("cuda", i % 3))
                                                 for i in range(7)]
    assert runs.devices == [f"cuda:{i % 3}" for i in range(7)]
    assert len(runs.startup_s) == 3 and len(runs.moves) == 7


def test_failing_block_process_raises_its_error(fake_cards):
    """A block solve that raises in its process fails the call with its
    traceback, which names the block."""
    subs = [types.SimpleNamespace(problem=i) for i in range(7)]
    with pytest.raises(RuntimeError, match="ValueError: block 5 failed") as err:
        tpg._solve_blocks(subs, "fail", card_solver, fake_cards)
    assert "in the solve of block 5 on cuda:2" in str(err.value)


def test_closure_as_block_solver_raises_before_any_process(monkeypatch):
    """Over several devices the block solver crosses a process, so a
    closure raises TypeError before any process starts."""
    def no_process(method):
        raise AssertionError("a process was started")

    monkeypatch.setattr(pmesh.multiprocessing, "get_context", no_process)
    subs = [types.SimpleNamespace(problem=i) for i in range(2)]
    with pytest.raises(TypeError, match="module-level function"):
        tpg._solve_blocks(subs, None, lambda problem, device, **kw: problem,
                          [torch.device("cpu")] * 2)


@pytest.mark.parametrize("device, parallel, n_blocks, cards, want", [
    ("cuda", True, 4, 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("cuda", True, 2, 4, ["cuda:0", "cuda:1"]),
    ("cuda", True, 4, 1, ["cuda"]),
    ("cuda:1", True, 4, 4, ["cuda:1"]),
    ("cuda", False, 4, 4, ["cuda"]),
    ("cpu", True, 4, 4, ["cpu"]),
])
def test_block_devices(monkeypatch, device, parallel, n_blocks, cards, want):
    """A process a card over two or more visible cards (at most a card a
    block) on "cuda" without an index; else the one device, in the
    caller's process."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got = tpg._block_devices(torch.device(device), parallel, n_blocks)
    assert got == [torch.device(d) for d in want]


def test_parallel_blocks_default_equals_jax():
    """solve_posegraph solves the blocks in parallel by default, as the
    JAX package's does."""
    want = inspect.signature(jpg.solve_posegraph).parameters["parallel_blocks"].default
    got = inspect.signature(tpg.solve_posegraph).parameters["parallel_blocks"].default
    assert got is want is True


def test_block_processes_equal_the_serial_solves():
    """Two spawned processes on the CPU solve the 12-image block's two
    blocks: the results come back in block order, bitwise equal to the
    same solves one after the other in this process, and the counters
    they moved (the plain versions' calls, the CG counts) are added to
    this process's, equal to the serial solves'."""
    tp = to_port(jax_block("eop12"))
    subs = [tpg.extract_block(tp, part) for part in tpg.partition_images(tp, 2)]
    cpu = torch.device("cpu")
    before = device_loop.snapshot_counters()
    got, runs = tpg._solve_blocks(subs, None, solve_schur, [cpu, cpu], timeout_s=240)
    moved = device_loop.counter_moves(before)
    before = device_loop.snapshot_counters()
    want, serial = tpg._solve_blocks(subs, None, solve_schur, [cpu])
    assert device_loop.counter_moves(before) == moved
    assert runs.moves == serial.moves and runs.devices == ["cpu", "cpu"]
    assert len(runs.startup_s) == 2 and not serial.startup_s
    assert moved["prefix_plain"]["chunk_prefix"] > 0 and moved["cg"]["calls"] > 0
    for g, w, sb in zip(got, want, subs):
        assert g.problem is sb.problem and g.layout.u == w.layout.u
        assert (g.iterations, g.converged) == (w.iterations, w.converged)
        assert np.array_equal(g.x, w.x) and g.sigma02 == w.sigma02
