"""The port's CLI (cli.py: dataset -> dense or Schur solve ->
.out/.rsd/.par) against the JAX package's, on the CPU, on datasets that
synth.write_block writes.

The reports must be the JAX package's, byte for byte, apart from lines
that differ between any two runs: `Execution date` (.out and .par) and
`Time Taken` (.out), which the test masks.  One exception is measured, not
masked: the .rsd prints each residual with 10 significant digits, and the
two packages' float64 residuals differ by ~1e-13 relative (their matrix
products and LU solves add in different orders), so a few fields round to
a different 10th digit (a few percent of the rows).  Such a field must
agree within 1e-9 relative (or 1e-15 absolute); every other byte of the
.rsd must be equal."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fish_eye_bundle_adjustment_tpu import cli as jcli
from fish_eye_bundle_adjustment_tpu import synth as jsynth
from fish_eye_bundle_adjustment_tpu_torch import cli as tcli
from fish_eye_bundle_adjustment_tpu_torch.io.problem import load_problem
from fish_eye_bundle_adjustment_tpu_torch.solver.dense import solve_dense
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

from _torch_blocks import BLOCKS, one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
# lines that differ between any two runs of one package
MASKED = {"out": ("Execution date:", "Time Taken:"), "par": ("Execution date",), "rsd": ()}


def _dataset(root, name="selfcal16", **settings):
    """A synthetic dataset (with its config.cfg) in root/ds; `settings`
    are added to the block's settings overrides."""
    kw = dict(BLOCKS[name])
    kw["settings_overrides"] = {**kw["settings_overrides"], **settings}
    blk = jsynth.make_block(model="fisheye", **kw)
    jsynth.write_block(blk, root / "ds")
    return root / "ds"


def _fields_agree(a, b, atol=1e-15):
    """Two tab-separated .rsd rows: the same ids, and numbers equal as text
    or within one unit of the 10th significant digit (or `atol`)."""
    fa, fb = a.split("\t"), b.split("\t")
    if len(fa) != len(fb) or fa[:2] != fb[:2]:
        return False
    for x, y in zip(fa[2:], fb[2:]):
        if x != y and not abs(float(x) - float(y)) <= 1e-9 * max(abs(float(x)), abs(float(y))) + atol:
            return False
    return True


def _reports_match(jdir, tdir, atol=1e-15):
    for ext, masked in MASKED.items():
        want = (jdir / f"ds.{ext}").read_text().splitlines()
        got = (tdir / f"ds.{ext}").read_text().splitlines()
        assert len(got) == len(want), ext
        hits = {m: 0 for m in masked}
        for g, w in zip(got, want):
            mask = [m for m in masked if w.startswith(m)]
            if mask:
                assert g.startswith(mask[0])
                hits[mask[0]] += 1
            elif g != w:
                assert ext == "rsd" and _fields_agree(g, w, atol), (ext, g, w)
        assert all(n == 1 for n in hits.values()), (ext, hits)


def _run_both(tmp_path, solver, name="selfcal16", **settings):
    """The JAX CLI's main(solver=...) and the port's CLI (a subprocess,
    --cpu) on copies of one dataset; returns both folders."""
    jdir = _dataset(tmp_path / "jax", name, **settings)
    tdir = tmp_path / "port" / "ds"
    shutil.copytree(jdir, tdir)
    assert jcli.main(jdir, plot=False, solver=solver) == 0
    run = subprocess.run(
        [sys.executable, "-m", "fish_eye_bundle_adjustment_tpu_torch.cli", str(tdir),
         "--cpu", "--no-plots", "--solver", solver],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},  # see one_torch_thread
    )
    assert run.returncode == 0, run.stderr
    assert "Done!" in run.stdout
    return jdir, tdir


def test_cli_reports_match_jax(tmp_path):
    """`python -m fish_eye_bundle_adjustment_tpu_torch.cli <folder> --cpu`
    against the JAX package's main(solver="dense") on the same files (the
    self-calibrating 16-image block: IOP correlations, tie points, control
    points)."""
    _reports_match(*_run_both(tmp_path, "dense"))


# dataset -> (block, settings): EOPs only; a self-calibrating free network
SCHUR_DATASETS = {
    "eop12": ("eop12", {}),
    "ic_selfcal12": ("ic12", dict(estimate_c=True, estimate_xp=True, estimate_yp=True,
                                  estimate_radial=True, estimate_decent=True)),
}


@pytest.mark.parametrize("dataset", list(SCHUR_DATASETS))
def test_schur_cli_reports_match_jax(tmp_path, dataset):
    """`--solver schur` (explicit dense S by the auto gate, the exact
    stds of solver/covariance.py) against the JAX CLI's schur reports.
    The .out (stds and correlations included) and .par are equal but for
    the date and time lines.  In the .rsd a residual that is small beside
    the others (1.3e-5 where most are 0.1-1) can differ past its 10th
    significant digit: the residuals come from the last step's CG
    solution, which the two packages reach with different rounding, and
    agree to ~1e-13 absolute (measured 1.3e-13), so such fields are held
    to 1e-12 absolute."""
    name, settings = SCHUR_DATASETS[dataset]
    jdir, tdir = _run_both(tmp_path, "schur", name, **settings)
    _reports_match(jdir, tdir, atol=1e-12)
    assert "n/a" not in (tdir / "ds.out").read_text()


def test_auto_picks_schur_above_3000(tmp_path, monkeypatch):
    """`auto` sends u > 3000 to the Schur solver with the CLI's arguments."""
    from fish_eye_bundle_adjustment_tpu_torch.solver import schur as tschur
    from fish_eye_bundle_adjustment_tpu_torch.synth import make_block

    big = make_block(n_img=12, n_pts=1000, model="fisheye", seed=1).problem
    assert ParamLayout(big).u > 3000 and tcli.pick_solver(big) == "schur"
    calls = []
    monkeypatch.setattr(tschur, "solve_schur", lambda p, **kw: calls.append(kw) or "solved")
    assert tcli._solve(big, "auto", "ck.npz", device="cpu") == "solved"
    assert calls[0]["checkpoint_path"] == "ck.npz" and calls[0]["device"] == "cpu"
    small = load_problem(_dataset(tmp_path, "eop12"))
    assert ParamLayout(small).u <= 3000 and tcli.pick_solver(small) == "dense"


def test_missing_dataset_returns_1(tmp_path, capsys):
    assert tcli.main(tmp_path / "nothing", plot=False, device="cpu") == 1
    assert "Error reading files" in capsys.readouterr().err


def test_find_datasets_and_batch(tmp_path, capsys):
    """Two complete datasets (one nested) and a partial one: find_datasets
    lists the two, warns about the third, and batch adjusts both."""
    root = tmp_path / "tree"
    a = _dataset(root / "a", "eop12")
    b = _dataset(root / "b" / "c", "eop12")
    partial = root / "partial"
    partial.mkdir()
    shutil.copy(a / "synth.pho", partial / "synth.pho")
    assert tcli.find_datasets(root) == [a, b]
    assert "incomplete dataset" in capsys.readouterr().err
    assert tcli.batch(root, device="cpu") == 0
    for d in (a, b):
        assert all((d / f"ds.{ext}").exists() for ext in ("out", "rsd", "par"))
    assert tcli.batch(tmp_path / "empty") == 1


def test_write_plots(tmp_path):
    from fish_eye_bundle_adjustment_tpu_torch.report.plots import write_plots

    problem = load_problem(_dataset(tmp_path, "eop12"))
    res = solve_dense(problem, device="cpu")
    paths = write_plots(res, tmp_path)
    assert sorted(Path(p).name for p in paths) == sorted(
        f"{k}_ds.png" for k in ("delta", "XcYcZc", "wpk", "RSDvR"))
    assert all(Path(p).stat().st_size > 1000 for p in paths)


@pytest.mark.parametrize("solver, item", [("posegraph", "item 9")])
def test_unported_solvers_raise(tmp_path, capsys, solver, item):
    """The pose graph raises NotImplementedError naming its ROADMAP.md
    item; main reports it and returns 1."""
    folder = _dataset(tmp_path, "eop12")
    problem = load_problem(folder)
    assert tcli.pick_solver(problem) == "dense"
    with pytest.raises(NotImplementedError, match=item):
        tcli._solve(problem, solver, device="cpu")
    assert tcli.main(folder, plot=False, solver=solver, device="cpu") == 1
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("solver", ["distributed", "sharded"])
def test_scale_cli_reports_match_jax(tmp_path, solver):
    """cli.main(folder, solver=..., devices=2, device="cpu") -- two gloo
    ranks spawned on the CPU, rank 0 writing -- against the JAX CLI's
    main(solver=..., devices=2) on two devices of the conftest's mesh,
    on the self-calibrating 16-image dataset: the .out (stds included)
    and .par equal but for the date and time lines, the .rsd as the schur
    reports (fields within 1e-12 absolute where the 10th digit differs)."""
    jdir = _dataset(tmp_path / "jax", "selfcal16")
    tdir = tmp_path / "port" / "ds"
    shutil.copytree(jdir, tdir)
    assert jcli.main(jdir, plot=False, solver=solver, devices=2) == 0
    assert tcli.main(tdir, plot=False, solver=solver, devices=2, device="cpu") == 0
    _reports_match(jdir, tdir, atol=1e-12)
    assert "n/a" not in (tdir / "ds.out").read_text()


def test_main_needs_a_card_unless_asked(tmp_path, capsys, monkeypatch):
    """main(..., device=None) solves on the CUDA card: without one it
    returns 1 naming the missing device, and writes no report."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    folder = _dataset(tmp_path, "eop12")
    assert tcli.main(folder, plot=False) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(folder.glob("*.out"))
