"""The port's numpy host modules reproduce the JAX package's exactly:
the same synthetic problems, band plans, settings, checkpoints, dataset
readers, native parser and loaded problems (the port carries copies, since
importing the JAX package imports jax)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fish_eye_bundle_adjustment_tpu import config as jconfig
from fish_eye_bundle_adjustment_tpu import synth as jsynth
from fish_eye_bundle_adjustment_tpu.io import problem as jproblem
from fish_eye_bundle_adjustment_tpu.ops import bandplan as jbandplan
from fish_eye_bundle_adjustment_tpu.utils import checkpoint as jckpt
from fish_eye_bundle_adjustment_tpu_torch import config as tconfig
from fish_eye_bundle_adjustment_tpu_torch import synth as tsynth
from fish_eye_bundle_adjustment_tpu_torch.io import native as tnative
from fish_eye_bundle_adjustment_tpu_torch.io import problem as tproblem
from fish_eye_bundle_adjustment_tpu_torch.io import readers as treaders
from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.ops import bandplan as tbandplan
from fish_eye_bundle_adjustment_tpu_torch.utils import checkpoint as tckpt

from _torch_blocks import BLOCKS, jax_block, one_torch_thread, to_port  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _assert_same_fields(a, b):
    """Every dataclass field equal: arrays exactly (np.array_equal, same
    dtype), everything else by ==."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert isinstance(vb, np.ndarray) and va.dtype == vb.dtype, f.name
            assert np.array_equal(va, vb), f.name
        elif dataclasses.is_dataclass(va):
            assert dataclasses.asdict(va) == dataclasses.asdict(vb), f.name
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("name", ["eop12", "selfcal16"])
def test_make_block_identical(name):
    """Same seed, same generator: every array field of BAProblem equal
    (np.array_equal, tolerance 0) and equal Settings."""
    kw = dict(BLOCKS[name], model="fisheye")
    jb, tb = jsynth.make_block(**kw), tsynth.make_block(**kw)
    _assert_same_fields(jb.problem, tb.problem)
    assert np.array_equal(jb.true_eop, tb.true_eop)
    assert np.array_equal(jb.true_points, tb.true_points)


@pytest.mark.parametrize("name", ["eop12", "selfcal16"])
def test_band_plan_identical(name):
    """build_band_plan gives identical BandPlan fields (tolerance 0)."""
    p = jax_block(name)
    tie = p.target_tie_slot[p.obs_pt]
    tie = np.where(tie >= 0, tie, p.n_tie)
    args = (tie, p.obs_img, p.n_tie, p.n_img)
    _assert_same_fields(
        jbandplan.build_band_plan(*args), tbandplan.build_band_plan(*args)
    )


def test_split_band_plan_identical():
    p = jax_block("eop12")
    tie = p.target_tie_slot[p.obs_pt]
    tie = np.where(tie >= 0, tie, p.n_tie)
    args = (tie, p.obs_img, p.n_tie, p.n_img)
    _assert_same_fields(
        jbandplan.split_band_plan(jbandplan.build_band_plan(*args), 2),
        tbandplan.split_band_plan(tbandplan.build_band_plan(*args), 2),
    )


def test_from_arrays_round_trip():
    """BAProblem.from_arrays(dataclasses.asdict(jax_problem)) carries every
    field across unchanged, as copies."""
    jp = jax_block("selfcal16")
    tp = to_port(jp)
    assert isinstance(tp, BAProblem)
    _assert_same_fields(jp, tp)
    assert tp.n_obs == jp.n_obs and tp.n == jp.n and tp.nk == jp.nk
    assert np.array_equal(tp.obs_weights(), jp.obs_weights())
    assert not np.shares_memory(tp.obs_xy, jp.obs_xy)


def test_settings_parse_identically():
    text = (
        "Iteration_Cap 7\nThreshold_Value 1e-4\nInner_Constraints 0\n"
        "Estimate_Xc 1\nEstimate_Yc 1\nEstimate_Zc 1\nEstimate_Omega 1\n"
        "Estimate_Phi 1\nEstimate_Kappa 0\nEstimate_c 1\nEstimate_xp 1\n"
        "Estimate_yp 0\nEstimate_Radial_Distortions 1\n"
        "Num_Radial_Distortions 2\nEstimate_Decentering_Distortions 0\n"
        "Estimate_tie 1\nEstimate_AllGCP 0\nMeas_std 0.5 # px\n"
        "Type 'equisolid'\n"
    )
    kv = jconfig.parse_cfg_text(text)
    assert tconfig.parse_cfg_text(text) == kv
    assert dataclasses.asdict(tconfig.settings_from_dict(kv, "s")) == (
        dataclasses.asdict(jconfig.settings_from_dict(kv, "s"))
    )
    with pytest.raises(tconfig.ConfigError):
        tconfig.settings_from_dict({})


def test_checkpoint_written_by_one_package_loads_in_the_other(tmp_path):
    jp = jax_block("eop12")
    ck = jckpt.SolverCheckpoint(
        x=np.arange(5.0), iteration=3, delta_history=[3.0, 2.0, 1.0],
        meta={k: str(v) for k, v in jckpt.problem_fingerprint(jp).items()},
    )
    path = tmp_path / "ck.npz"
    jckpt.save_checkpoint(path, ck)
    back = tckpt.load_checkpoint(path, to_port(jp))
    assert back.iteration == 3 and back.delta_history == [3.0, 2.0, 1.0]
    assert np.array_equal(back.x, ck.x)


def test_port_imports_no_jax():
    """Importing every module of the port (the solvers, the io readers and
    native parser, the reports, plots and CLI included), chip_smoke.py,
    the bench twins (bench_torch_*.py, the tenk and pose-graph ones
    included), bench_torch_parallel.py, bench_torch_block.py,
    bench_torch_cli.py, bench_torch_stds.py and bench_torch_hosts.py in a
    fresh interpreter leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fish_eye_bundle_adjustment_tpu_torch as pkg\n"
        "import fish_eye_bundle_adjustment_tpu_torch.solver.schur\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import fish_eye_bundle_adjustment_tpu_torch.cli\n"
        "import fish_eye_bundle_adjustment_tpu_torch.solver.dense\n"
        "import fish_eye_bundle_adjustment_tpu_torch.io.native\n"
        "import fish_eye_bundle_adjustment_tpu_torch.report.plots\n"
        "import chip_smoke, bench_torch_streamseg, bench_torch_pallas_gather\n"
        "import bench_torch_pallas_onehot, bench_torch_fusedmv, bench_torch_parallel\n"
        "import bench_torch_tenk, bench_torch_posegraph, bench_torch_block\n"
        "import bench_torch_cli, bench_torch_stds, bench_torch_hosts\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.startswith('fish_eye_bundle_adjustment_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


JAX_PKG = REPO / "fish_eye_bundle_adjustment_tpu"
PORT_PKG = REPO / "fish_eye_bundle_adjustment_tpu_torch"


def _renamed(text):
    return text.replace("fish_eye_bundle_adjustment_tpu.", "fish_eye_bundle_adjustment_tpu_torch.")


@pytest.mark.parametrize("path", ["io/readers.py", "io/native.py", "io/__init__.py"])
def test_copied_io_modules_equal_jax(path):
    """The port's dataset readers and native-parser bindings are the JAX
    package's text, with the package name changed."""
    want = _renamed((JAX_PKG / path).read_text())
    assert (PORT_PKG / path).read_text() == want


def test_native_source_and_load_problem_equal_jax():
    """feba_io.cpp is the JAX package's file byte for byte; load_problem
    is the JAX package's function with the package name changed; the
    port builds its parser into its own cache, never the JAX package's."""
    import inspect

    src = "native/feba_io.cpp"
    assert (PORT_PKG / src).read_bytes() == (JAX_PKG / src).read_bytes()
    assert inspect.getsource(tproblem.load_problem) == _renamed(
        inspect.getsource(jproblem.load_problem))
    assert tnative._SRC == PORT_PKG / src
    assert tnative._CACHE_DIR == PORT_PKG / "native" / "_cache"
    assert tproblem.DatasetError is treaders.DatasetError


def _written(tmp_path, name="selfcal16"):
    blk = jsynth.make_block(model="fisheye", **BLOCKS[name])
    jsynth.write_block(blk, tmp_path / "ds")
    return tmp_path / "ds"


def test_load_problem_matches_jax(tmp_path):
    """A dataset written by synth.write_block loads into equal problems
    (every field, tolerance 0) in both packages."""
    folder = _written(tmp_path)
    _assert_same_fields(jproblem.load_problem(folder), tproblem.load_problem(folder))
    with pytest.raises(treaders.DatasetError, match="no .pho file"):
        tproblem.load_problem(tmp_path)


def test_native_parser_matches_python_reader(tmp_path):
    """The port's C++ parser (built with g++ into its own cache) reads the
    .pho and .cnt of a synthetic dataset into exactly what the Python
    reader makes of them."""
    if not tnative.available():
        pytest.skip("no C++ toolchain: the readers use the Python parser")
    folder = _written(tmp_path)
    pho = folder / "synth.pho"
    native = treaders._read_pho_native(pho)
    plain = treaders._read_pho_python(pho)
    _assert_same_fields(native, plain)
    uniq, codes, vals = tnative.parse_idtable(folder / "synth.cnt", 3)
    ids, xyz = [], []
    for row in treaders._tokenize(folder / "synth.cnt"):
        ids.append(row[0])
        xyz.append([float(v) for v in row[1:4]])
    assert [uniq[i] for i in codes] == ids
    assert np.array_equal(vals, np.asarray(xyz))
    assert Path(tnative._lib._name).parent == PORT_PKG / "native" / "_cache"
