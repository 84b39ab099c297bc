"""The port's CLI (cli.py: dataset -> dense solve -> .out/.rsd/.par) against
the JAX package's, on the CPU, on a dataset that synth.write_block writes.

The reports must be the JAX package's, byte for byte, apart from lines
that differ between any two runs: `Execution date` (.out and .par) and
`Time Taken` (.out), which the test masks.  One exception is measured, not
masked: the .rsd prints each residual with 10 significant digits, and the
two packages' float64 residuals differ by ~1e-13 relative (their matrix
products and LU solves add in different orders), so a few fields round to
a different 10th digit (a few percent of the rows).  Such a field must
agree within 1e-9 relative (or 1e-15 absolute); every other byte of the
.rsd must be equal."""

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

from _torch_blocks import BLOCKS

REPO = Path(__file__).resolve().parents[1]
# lines that differ between any two runs of one package
MASKED = {"out": ("Execution date:", "Time Taken:"), "par": ("Execution date",), "rsd": ()}


def _dataset(root, name="selfcal16"):
    """A synthetic dataset (with its config.cfg) in root/ds."""
    blk = jsynth.make_block(model="fisheye", **BLOCKS[name])
    jsynth.write_block(blk, root / "ds")
    return root / "ds"


def _fields_agree(a, b):
    """Two tab-separated .rsd rows: the same ids, and numbers equal as text
    or within one unit of the 10th significant digit."""
    fa, fb = a.split("\t"), b.split("\t")
    if len(fa) != len(fb) or fa[:2] != fb[:2]:
        return False
    for x, y in zip(fa[2:], fb[2:]):
        if x != y and not abs(float(x) - float(y)) <= 1e-9 * max(abs(float(x)), abs(float(y))) + 1e-15:
            return False
    return True


def test_cli_reports_match_jax(tmp_path):
    """`python -m fish_eye_bundle_adjustment_tpu_torch.cli <folder> --cpu`
    against the JAX package's main(solver="dense") on the same files (the
    self-calibrating 16-image block: IOP correlations, tie points, control
    points)."""
    jdir = _dataset(tmp_path / "jax")
    tdir = tmp_path / "port" / "ds"
    shutil.copytree(jdir, tdir)
    assert jcli.main(jdir, plot=False, solver="dense") == 0
    run = subprocess.run(
        [sys.executable, "-m", "fish_eye_bundle_adjustment_tpu_torch.cli", str(tdir),
         "--cpu", "--no-plots"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr
    assert "Done!" in run.stdout
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
                assert ext == "rsd" and _fields_agree(g, w), (ext, g, w)
        assert all(n == 1 for n in hits.values()), (ext, hits)


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


@pytest.mark.parametrize("solver, item", [
    ("schur", "items 5 and 6"), ("distributed", "item 8"), ("sharded", "item 8"),
    ("fused_sharded", "item 8"), ("posegraph", "item 9"),
])
def test_unported_solvers_raise(tmp_path, capsys, solver, item):
    """The schur and scale-out solvers raise NotImplementedError naming
    their ROADMAP.md items; main reports it and returns 1."""
    folder = _dataset(tmp_path, "eop12")
    problem = load_problem(folder)
    assert tcli.pick_solver(problem) == "dense"
    with pytest.raises(NotImplementedError, match=item):
        tcli._solve(problem, solver, device="cpu")
    assert tcli.main(folder, plot=False, solver=solver, device="cpu") == 1
    assert item in capsys.readouterr().err


def test_main_needs_a_card_unless_asked(tmp_path, capsys, monkeypatch):
    """main(..., device=None) solves on the CUDA card: without one it
    returns 1 naming the missing device, and writes no report."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    folder = _dataset(tmp_path, "eop12")
    assert tcli.main(folder, plot=False) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(folder.glob("*.out"))
