"""The port's twins of bench_tenk.py, bench_posegraph.py and bench_stds.py
(bench_torch_tenk.py, bench_torch_posegraph.py, bench_torch_stds.py) at a
small size on the CPU: each prints one JSON line that carries every key of
the JAX script's committed output (TENK_r05.json, POSEGRAPH_r05.json;
nested keys too) or, for bench_stds.py, which has none, of its code, with
the card-only keys null or empty.
"""

import json
from pathlib import Path

import bench_torch_posegraph
import bench_torch_stds
import bench_torch_tenk

from _torch_blocks import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


def _printed(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_tenk_twin_prints_the_jax_keys(capsys):
    bench_torch_tenk.main(["--cpu", "--n-img", "12", "--n-pts", "150", "--steps", "2"])
    got = _printed(capsys)
    want = json.loads((REPO / "TENK_r05.json").read_text())
    assert _keys(want) <= _keys(got)
    assert got["backend"] == "cpu" and got["card"] is None
    assert got["band_plan"]["W"] > 0 and got["step_ms"] > 0
    assert got["solve"]["driver"] == "device loop (eager body)"
    assert got["solve"]["replay_ms"] is None and got["solve"]["max_memory_allocated"] is None


def test_posegraph_twin_prints_the_jax_keys(capsys):
    bench_torch_posegraph.main(["--cpu", "--n-img", "12", "--n-pts", "150", "--blocks", "2"])
    got = _printed(capsys)
    want = json.loads((REPO / "POSEGRAPH_r05.json").read_text())
    assert _keys(want) <= _keys(got)
    assert got["block_devices"] == ["cpu", "cpu"] and got["startup_s"] == []
    assert len(got["block_solve_s"]) == got["n_blocks"] == 2
    assert set(got["stage_s"]) == {"partition", "blocks", "merge", "refine"}


# the keys bench_stds.py prints for each block
STDS_KEYS = {
    "accuracy_block": {"n_img", "n_obs", "u", "exact_s", "hutchinson_s", "n_probe",
                       "median_rel_err", "q90_rel_err", "zero_clip_frac"},
    "scale_block": {"n_img", "n_obs", "u", "n_probe", "hutchinson_s", "s_per_probe",
                    "extrapolated_s_at_64_probes", "frac_positive"},
}


def test_stds_twin_prints_the_jax_keys(capsys):
    """bench_torch_stds.py at two 12-image blocks and 2 probes: bench_stds.py's
    keys, the estimate's CG solves by class (2 k + k + 2, k = 16) and its
    stage walls; the card-only keys null."""
    bench_torch_stds.main(["--cpu", "--accuracy-img", "12", "--accuracy-pts", "150",
                           "--scale-img", "12", "--scale-pts", "150", "--n-probe", "2"])
    got = _printed(capsys)
    assert got["backend"] == "cpu" and got["card"] is None
    for block, keys in STDS_KEYS.items():
        b = got[block]
        assert keys <= set(b) and b["peak_gib"] is None and b["launches"] == {}
        assert b["cg_solves"] == {"subspace": 32, "deflation": 16, "camera": 1, "point": 1}
        assert "stds point probes" in b["stage_s"] and b["cg_matvecs"] > 0
    assert 0 < got["accuracy_block"]["median_rel_err"] < 1
