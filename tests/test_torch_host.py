"""The port's numpy host modules reproduce the JAX package's exactly:
the same synthetic problems, band plans, settings and checkpoints (the
port carries copies, since importing the JAX package imports jax)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fish_eye_bundle_adjustment_tpu import config as jconfig
from fish_eye_bundle_adjustment_tpu import synth as jsynth
from fish_eye_bundle_adjustment_tpu.ops import bandplan as jbandplan
from fish_eye_bundle_adjustment_tpu.utils import checkpoint as jckpt
from fish_eye_bundle_adjustment_tpu_torch import config as tconfig
from fish_eye_bundle_adjustment_tpu_torch import synth as tsynth
from fish_eye_bundle_adjustment_tpu_torch.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu_torch.ops import bandplan as tbandplan
from fish_eye_bundle_adjustment_tpu_torch.utils import checkpoint as tckpt

from _torch_blocks import BLOCKS, jax_block, to_port

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
    """Importing every module of the port (the solver included), chip_smoke.py
    and the bench twins (bench_torch_*.py) in a fresh interpreter leaves jax
    out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fish_eye_bundle_adjustment_tpu_torch as pkg\n"
        "import fish_eye_bundle_adjustment_tpu_torch.solver.schur\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, bench_torch_streamseg, bench_torch_pallas_gather\n"
        "import bench_torch_pallas_onehot, bench_torch_fusedmv\n"
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
