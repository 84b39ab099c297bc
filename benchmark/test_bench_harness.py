"""The harness on the CPU, at a tiny block: every cell resolves to its
files, a run's last line has the contract's keys, the yardstick's counts
read only the problem's counts, nothing loads JAX or the JAX package, and
a run whose timed path is broken comes out not correct.

    python -m pytest -q benchmark/                  # from the repository root

The card's test (marked gpu) runs a short cell on the card; it skips
without one.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(HERE), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import counts  # noqa: E402
import faults  # noqa: E402
import harness  # noqa: E402
import port  # noqa: E402

TINY = dict(n_img=16, n_pts=300)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(workload: str, **sizes) -> harness.Cell:
    """The workload's cell, its block cut to a tiny one."""
    cell = harness.Cell.load(ROOT, workload)
    cell.config = dict(cell.config, **(sizes or TINY))
    return cell


def tiny_run(workload: str, seconds=0.0, trace=False, seed=2**31 + 7) -> dict:
    return harness.run(tiny_cell(workload), seed, seconds, trace, time.perf_counter(),
                       device="cpu")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_resolves():
    b = bench()
    names = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in b["workloads"]:
        assert w["config"] in names
        cell = harness.Cell.load(ROOT, w["name"])
        assert set(cell.cell["limits"]) and cell.cell["judge_sample"] >= 1
        assert "init_sigmas" in cell.traffic and "control" in cell.traffic
        assert cell.end_to_end and cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.load_reader(m["name"]))
    for p in b["paths"]:
        assert (ROOT / p).is_dir()


def test_result_line_has_the_contract_keys():
    out = tiny_run("selfcal_1k.f32")
    # the contract's five keys, then the numbers compared beside their limits, last
    assert list(out) == KEYS + ["checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"obs_per_s", "adjust_s", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)  # a plain JSON line


def test_traced_run_reports_the_per_layer_metrics_it_can_read_on_the_cpu():
    out = tiny_run("selfcal_1k.f64", trace=True)
    assert list(out) == KEYS + ["checks"]  # no breakdown: the CPU has no device trace
    # the device's metrics (times, rooflines, idle, captures) need the card
    assert set(out["metrics"]) == {"prepare_s", "gn_iters_per_adjust", "cg_iters_per_adjust"}
    assert out["correct"] is True, out["checks"]


def test_counts_read_only_the_problems_counts():
    cell = tiny_cell("selfcal_1k.f32")
    block = harness.blockgen.from_config(cell.config)
    # two preparations that pad and lay out the stream differently
    a = port.Prepared(block, cell.traffic, "cpu")
    b = port.Prepared(block, cell.traffic, "cpu", overrides=dict(band_M=64))
    assert a.band["n_pad"] != b.band["n_pad"] or a.band["G"] != b.band["G"]
    sa, sb = harness.sizes_of(a), harness.sizes_of(b)
    assert sa == sb
    assert counts.matvec(sa) == counts.matvec(sb)
    assert sa.n_obs == block.n_obs and sa.n_tie == block.n_tie and sa.n_img == block.n_img
    nbytes, flops = counts.matvec(sa)
    k = sa.ne + sa.ni
    assert nbytes == sa.n_obs * (2 * (k + 3) * 4 + 8) + sa.n_tie * 24 + 2 * sa.nc * 4
    assert flops == sa.n_obs * (8 * k + 28) + sa.n_tie * 15


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path
    # what a run loads, in a process of its own (this one's conftest may hold JAX)
    code = ("import sys, time; sys.path[:0] = [%r, %r]; import harness, port, refba, probe; "
            "import run; print(sorted({m.split('.')[0] for m in sys.modules} & set(harness.FORBIDDEN)))"
            % (str(HERE), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    # a top-level name is compared whole: the port's own name begins with JAX's package's
    sys.modules.setdefault("fish_eye_bundle_adjustment_tpu_torch", port)
    assert "fish_eye_bundle_adjustment_tpu_torch" not in harness.forbidden_modules()


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "selfcal_1k.f32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# -- the timed path broken underneath: each must come out not correct --------

@pytest.mark.parametrize("fault, workload, number", [
    ("unchanged", "selfcal_1k.f32", "cost_gap"),
    ("half", "selfcal_1k.f64", "sigma02_gap"),
    ("altered", "selfcal_1k.f64", "max_shift_m"),
])
def test_a_broken_timed_path_is_not_correct(fault, workload, number):
    with faults.planted(fault):
        out = tiny_run(workload)
    assert out["correct"] is False
    c = out["checks"][number]
    assert c["value"] is None or c["value"] > c["limit"], out["checks"]


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_short_cell_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "selfcal_1k.f32",
                          "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
