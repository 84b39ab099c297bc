"""The CLI's default Schur route past both of its gates, on the CPU: the
port's (cli.main through bench_torch_cli.run_route) against the JAX
package's solve_schur(problem) and write_reports on one dataset.

The CLI sends u > 3000 to solve_schur(problem) with SchurOptions().  Past
explicit_s_max_images (600) images that solve is the matrix-free unfused
float64 solve under the device loop; past compute_stds' max_images (1000)
the stds are the Hutchinson estimate (64 probes, 3 k + 64 CG solves).
Here both gates are moved to 0 in both packages (monkeypatch:
SchurOptions' explicit_s_max_images and compute_stds' max_images default),
so eop12 (12 images, EOPs and tie points, control points: configs[5]'s
settings) takes that route; both CLIs are given --solver schur, since
u <= 3000 here.

Tolerances.  x within rtol 1e-9 / atol 1e-7 and sigma0^2 within 1e-9
relative, the same iterations and stop (tests/test_torch_schur_unfused.py's
float64 bounds).  The stds: median relative difference <= 1e-2 and q90 <=
3e-2 (test_torch_covariance.py::test_fused_estimate_tracks_jax's bounds:
both run the same probes, the port through the fused operator at its
"bf16" matvec, the JAX package, which runs its fused operator only on a
TPU, through its unfused float32 one).  The .rsd: every field within 1e-9
relative or 1e-12 absolute of the JAX package's (test_torch_cli.py's Schur
rule); the .par equal but for its date line, its std column held to the
stds' bounds."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fish_eye_bundle_adjustment_tpu import synth as jsynth
from fish_eye_bundle_adjustment_tpu.io.problem import load_problem as jload
from fish_eye_bundle_adjustment_tpu.report.writers import write_reports as jwrite
from fish_eye_bundle_adjustment_tpu.solver import covariance as jcov
from fish_eye_bundle_adjustment_tpu.solver import schur as jschur
from fish_eye_bundle_adjustment_tpu_torch.solver import covariance as tcov
from fish_eye_bundle_adjustment_tpu_torch.solver import schur as tschur

import bench_torch_cli
from _torch_blocks import BLOCKS, one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
STD_MEDIAN, STD_Q90 = 1e-2, 3e-2


def _past_the_gates(mp, schur_mod, cov_mod):
    """SchurOptions() without the explicit dense S and compute_stds'
    default past its exact covariance, in one package."""

    @dataclasses.dataclass
    class MatrixFree(schur_mod.SchurOptions):
        explicit_s_max_images: int = 0

    mp.setattr(schur_mod, "SchurOptions", MatrixFree)
    f = cov_mod.compute_stds
    mp.setattr(f, "__defaults__", (0,) + f.__defaults__[1:])


@pytest.fixture(scope="module")
def gates():
    with pytest.MonkeyPatch.context() as mp:
        _past_the_gates(mp, jschur, jcov)
        _past_the_gates(mp, tschur, tcov)
        yield


@pytest.fixture(scope="module")
def route(tmp_path_factory, gates):
    """One dataset (synth.write_block of eop12), the JAX package's route on
    it and the port's on a copy: (JAX result, JAX folder, port route,
    port summary, port folder)."""
    root = tmp_path_factory.mktemp("route")
    blk = jsynth.make_block(model="fisheye", **BLOCKS["eop12"])
    jdir, tdir = root / "jax" / "ds", root / "port" / "ds"
    for d in (jdir, tdir):
        jsynth.write_block(blk, d)
    jres = jschur.solve_schur(jload(jdir))
    jwrite(jres, jdir, elapsed_s=0.0)
    got = bench_torch_cli.run_route(tdir, device="cpu", solver="schur")
    return jres, jdir, got, bench_torch_cli.summarize(got), tdir


def test_route_takes_both_gates(route):
    """The port's CLI took the matrix-free solve under the device loop (its
    eager body on the CPU) and the Hutchinson stds, each kernel as its
    plain version, and wrote a .rsd row an observation; the JAX package's
    route took the Hutchinson stds too."""
    jres, _, got, summary, tdir = route
    assert bench_torch_cli.check(got, summary, tdir) == []
    assert summary["solver"] == "schur" and summary["driver"] == "device loop (eager body)"
    assert summary["std_method"] == jres.std_method == "hutchinson"
    assert sum(summary["stds_cg_solves"].values()) == summary["stds_cg_solves_want"] == 3 * 16 + 64
    assert summary["stds_cg_solves"] == {"subspace": 32, "deflation": 16, "camera": 32,
                                         "point": 32}
    assert not any(summary["launches"].values()) and summary["plain_calls"] > 0
    assert summary["rsd_rows"] == jres.problem.n_obs


def test_route_stages_are_recorded(route):
    """utils/observe.record_stages names each stage of the route once, in
    the order it ran; off the card no memory is read."""
    stages = route[2]["stages"]
    assert [s.name for s in stages] == [
        "read", "layout", "obs", "loop", "finalize", "stds obs", "stds factor",
        "stds diag(M)", "stds subspace solves", "stds deflation solves",
        "stds camera probes", "stds point probes", "stds finish", "solve", "reports"]
    assert all(s.seconds >= 0 and s.peak_bytes == s.held_bytes == 0 for s in stages)


def test_route_solution_matches_jax(route):
    jres, _, got, _, _ = route
    res = got["result"]
    assert (res.iterations, res.converged, res.stopped_on) == (
        jres.iterations, jres.converged, jres.stopped_on)
    np.testing.assert_allclose(res.x, jres.x, rtol=1e-9, atol=1e-7)
    assert abs(res.sigma02 - jres.sigma02) <= 1e-9 * jres.sigma02


def _stds_agree(got, want):
    live = want > 0
    rel = np.abs(got[live] - want[live]) / want[live]
    return np.median(rel) <= STD_MEDIAN and np.quantile(rel, 0.9) <= STD_Q90


def test_route_stds_track_jax(route):
    jres, _, got, _, _ = route
    std = got["result"].std
    assert std.shape == jres.std.shape and np.isfinite(std).all() and (std >= 0).all()
    assert _stds_agree(std, jres.std)


def _rsd_fields_agree(a, b):
    fa, fb = a.split("\t"), b.split("\t")
    if len(fa) != len(fb) or fa[:2] != fb[:2]:
        return False
    return all(x == y or abs(float(x) - float(y))
               <= 1e-9 * max(abs(float(x)), abs(float(y))) + 1e-12
               for x, y in zip(fa[2:], fb[2:]))


def test_route_reports_match_jax(route):
    _, jdir, _, _, tdir = route
    want = (jdir / "ds.rsd").read_text().splitlines()
    got = (tdir / "ds.rsd").read_text().splitlines()
    assert len(got) == len(want)
    assert all(g == w or _rsd_fields_agree(g, w) for g, w in zip(got, want))
    want = (jdir / "ds.par").read_text().splitlines()
    got = (tdir / "ds.par").read_text().splitlines()
    assert len(got) == len(want)
    stds = []
    for g, w in zip(got, want):
        if g.startswith("Execution date") and w.startswith("Execution date"):
            continue
        fg, fw = g.split("\t"), w.split("\t")
        if len(fw) == 3 and fw[0] == fg[0] and fg[2] != fw[2]:
            # a parameter's row: name, value, std
            assert fg[1] == fw[1] or abs(float(fg[1]) - float(fw[1])) <= 1e-9 * abs(float(fw[1]))
            stds.append((float(fg[2]), float(fw[2])))
        else:
            assert g == w
    if stds:
        assert _stds_agree(*map(np.array, zip(*stds)))


def test_route_stds_equal_a_solve_then_compute_stds(route):
    """solve_schur(compute_covariance=True), as the CLI ran it, gives
    bitwise the x, sigma0^2 and stds of solve_schur(compute_covariance=False)
    followed by compute_stds at its x: releasing the solve's device state
    before the stds moves no number."""
    res = route[2]["result"]
    alone = tschur.solve_schur(res.problem, compute_covariance=False, device="cpu")
    assert np.array_equal(alone.x, res.x) and alone.sigma02 == res.sigma02
    std, _, method = tcov.compute_stds(res.problem, alone.layout, alone.x, alone.sigma02,
                                       device="cpu")
    assert method == res.std_method == "hutchinson" and np.array_equal(std, res.std)


def test_solve_releases_its_stream_before_the_stds():
    """With the collector off, no tensor as long as the solve's padded
    stream is alive when solve_schur reaches compute_stds, in a fresh
    interpreter (the first solve there imports torch._dynamo, whose
    torch.fx.wrap leaves a cycle of frames that held the first step's
    tensors)."""
    code = (
        "import gc, torch\n"
        "from fish_eye_bundle_adjustment_tpu_torch.synth import make_block\n"
        "from fish_eye_bundle_adjustment_tpu_torch.solver import covariance, schur\n"
        "from fish_eye_bundle_adjustment_tpu_torch.ops import prefix\n"
        "p = make_block(n_img=12, n_pts=150, seed=13, settings_overrides={'iteration_cap': 3}"
        ").problem\n"
        "n = -(-p.n_obs // prefix.CHUNK) * prefix.CHUNK\n"
        "seen, stds = [], covariance.compute_stds\n"
        "def probe(*a, **k):\n"
        "    seen.append(sum(isinstance(o, torch.Tensor) and o.dim() > 0 and o.shape[0] == n\n"
        "                    for o in gc.get_objects()))\n"
        "    return stds(*a, **k)\n"
        "covariance.compute_stds = probe\n"
        "gc.disable()\n"
        "r = schur.solve_schur(p, schur.SchurOptions(explicit_s=False), device='cpu')\n"
        "print(seen, r.std_method)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[0]", "exact"]
