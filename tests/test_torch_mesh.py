"""The port's mesh on torch.distributed (parallel/mesh.py), its sharded
plans (ops/segment.DualAxisPlan.build_sharded, parallel/tieshard.py) and
the SPMD probe stds (solver/covariance.estimate_schur_stds(mesh=...))
against numpy and the JAX package.

One group of two gloo ranks on the CPU (tests/_torch_dist_worker.py,
which imports no jax) runs every case of this module; the JAX side runs
here, on the conftest's 8-device CPU mesh."""

import numpy as np
import pytest

from _torch_blocks import jax_block, one_torch_thread, to_port  # noqa: F401 (autouse)
from _torch_dist_worker import run_group

N = 2

# tie-sorted id streams (control and padding rows: n_tie) with ties that
# have no observation (tests/test_tieshard.py::test_zero_observation_tie_at_boundary)
ZERO_OBS = {
    "hole_at_boundary": (np.array([0, 0, 0, 1, 3, 3, 4, 4]), 5),
    "interior_hole": (np.array([0, 0, 2, 2, 3, 3, 4, 4]), 5),
    "two_holes_straddling": (np.array([0, 0, 0, 0, 1, 4, 4, 5]), 6),
}


def _block_stream(name="selfcal16"):
    """(tie ids, image ids, n_tie, n_img) of a block's tie-sorted stream,
    padded to a multiple of N as the JAX package pads it."""
    from fish_eye_bundle_adjustment_tpu.solver.schur import ObsData
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    p = jax_block(name)
    layout = ParamLayout(p)
    order = ObsData.sort_order_by_tie(p, layout)
    tie = p.target_tie_slot[p.obs_pt]
    tie = np.where(tie >= 0, tie, layout.n_tie)[order].astype(np.int64)
    img = p.obs_img[order].astype(np.int64)
    pad = -len(tie) % N
    return (np.concatenate([tie, np.full(pad, layout.n_tie)]),
            np.concatenate([img, np.zeros(pad, np.int64)]), layout.n_tie, p.n_img)


def _cases():
    rng = np.random.default_rng(0)
    tie, img, n_tie, n_img = _block_stream()
    cases = {"collectives": ("collectives", {})}
    vals = rng.standard_normal((len(tie), 6))
    cases["dual_axis"] = ("dual_axis_sums", dict(
        primary=tie, n_primary=n_tie + 1, secondary=img, n_secondary=n_img, vals=vals))
    streams = {**ZERO_OBS, "selfcal16": (tie, n_tie)}
    for name, (ids, nt) in streams.items():
        cases[f"tie:{name}"] = ("tie_sums", dict(
            tie_sorted=ids, n_tie=nt, vals=rng.standard_normal((len(ids), 3))))
    p = jax_block("eop12")
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    cases["stds"] = ("mesh_stds", dict(problem=to_port(p), x=ParamLayout(p).initial(),
                                       sigma02=1.0, n_probe=8))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def ranks():
    return run_group(N, CASES)


def test_collectives_and_counts(ranks):
    """psum, psum_scatter and all_gather against numpy on rank-dependent
    inputs (float64 and a 0-d float32), and the calls and bytes counted."""
    got = ranks["collectives"]
    assert (got["size"], got["index"]) == (N, 0)
    assert got["jax_loaded"] == []  # the ranks import the port and torch only
    xs = [np.arange(12, dtype=np.float64).reshape(6, 2) * (r + 1) + r for r in range(N)]
    total = sum(xs)
    np.testing.assert_array_equal(got["psum"], total)
    assert got["psum_0d"].shape == () and got["psum_0d"] == sum(0.5 * (r + 1) for r in range(N))
    # each rank sends N copies of its x: rank 0 keeps the sum's first copy
    np.testing.assert_array_equal(got["psum_scatter"], total)
    np.testing.assert_array_equal(got["all_gather"], np.concatenate([x[:2] for x in xs]))
    assert got["counts"] == {
        "all_reduce": {"calls": 2, "bytes": 12 * 8 + 4},
        "reduce_scatter": {"calls": 1, "bytes": 12 * N * 8},
        "all_gather": {"calls": 1, "bytes": 4 * 8},
    }


def test_build_sharded_sums_complete_by_psum(ranks):
    """Each rank's build_sharded plan over its slice of the selfcal16
    tie-sorted stream (local row offsets), completed by psum, gives the
    global segment sums by tie and by image (float64, 1e-12)."""
    _, kw = CASES["dual_axis"]
    prim, sec = ranks["dual_axis"]
    want_p = np.zeros((kw["n_primary"], 6))
    np.add.at(want_p, kw["primary"], kw["vals"])
    want_s = np.zeros((kw["n_secondary"], 6))
    np.add.at(want_s, kw["secondary"], kw["vals"])
    scale = np.abs(kw["vals"]).sum()
    assert np.abs(prim - want_p).max() <= 1e-12 * scale
    assert np.abs(sec - want_s).max() <= 1e-12 * scale


def test_sharded_plan_slices_match_jax():
    """build_sharded's shard d equals the JAX package's stacked plan's
    row d, layout for layout."""
    from fish_eye_bundle_adjustment_tpu.ops.segment import DualAxisPlan as JPlan
    from fish_eye_bundle_adjustment_tpu_torch.ops.segment import DualAxisPlan as TPlan

    tie, img, n_tie, n_img = _block_stream()
    want = JPlan.build_sharded(tie, n_tie + 1, img, n_img, N)
    for d in range(N):
        plan = TPlan.build_sharded(tie, n_tie + 1, img, n_img, N, d)
        for ours, theirs in ((plan.primary.begs, want.primary.begs),
                             (plan.primary.ends, want.primary.ends),
                             (plan.perm, want.perm),
                             (plan.secondary.begs, want.secondary.begs),
                             (plan.secondary.ends, want.secondary.ends)):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs)[d])


@pytest.mark.parametrize("stream", ["plan_geometry", *ZERO_OBS, "selfcal16"])
def test_build_tie_shard_matches_jax(stream):
    """The port's build_tie_shard is the JAX function, array for array:
    the random 997-tie stream of tests/test_tieshard.py at 8 shards, the
    zero-observation cases and a block's stream at 2."""
    from fish_eye_bundle_adjustment_tpu.parallel.tieshard import build_tie_shard as jbuild
    from fish_eye_bundle_adjustment_tpu_torch.parallel.tieshard import build_tie_shard

    if stream == "plan_geometry":
        rng = np.random.default_rng(0)
        n_tie, n = 997, 8
        ids = np.repeat(np.arange(n_tie), rng.integers(1, 12, n_tie))
        ids = np.concatenate([ids, np.full(-ids.size % n, n_tie)])
    elif stream == "selfcal16":
        ids, _, n_tie, _ = _block_stream()
        n = N
    else:
        (ids, n_tie), n = ZERO_OBS[stream], N
    want = jbuild(ids.astype(np.int64), n_tie, n)
    got = build_tie_shard(ids.astype(np.int64), n_tie, n)
    for field in ("tie_local", "begs", "ends", "bslot", "own_lo", "own_n",
                  "owner_of_tie", "pos_in_owner"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    for field in ("L", "Bp", "max_own", "n_tie", "n_shards"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("stream", [*ZERO_OBS, "selfcal16"])
def test_local_tie_segsum_matches_global(ranks, stream):
    """LocalTieOps.segsum on each rank's slice (the boundary ties
    completed by one psum), its owned rows gathered, equals the global
    tie sums; ties without observations come back 0; expand gives each
    row its tie's sum (float64, 1e-12)."""
    _, kw = CASES[f"tie:{stream}"]
    table, expanded = ranks[f"tie:{stream}"]
    ids, n_tie, vals = kw["tie_sorted"], kw["n_tie"], kw["vals"]
    live = ids < n_tie
    want = np.zeros((n_tie, 3))
    np.add.at(want, ids[live], vals[live])
    scale = np.abs(vals).sum()
    assert np.abs(table - want).max() <= 1e-12 * scale
    m = len(ids) // N
    rows0 = ids[:m]
    want_rows = np.where((rows0 < n_tie)[:, None], want[np.minimum(rows0, n_tie - 1)], 0.0)
    assert np.abs(expanded - want_rows).max() <= 1e-12 * scale


def test_mesh_stds_match_jax_mesh_estimate(ranks):
    """estimate_schur_stds(mesh=...) over two ranks against the JAX
    package's mesh estimate on two devices, same block (eop12 at its
    initial point), seed and probes (8): both float32 probe solves over
    the tie-sorted stream's two slices, the port's sums the prefix sums of
    K4 (here its plain version), its collectives all-reduces only.  Only
    float32 rounding differs, which the CG solves carry on: measured,
    median relative gap 2.6e-6 and largest 4.0e-5 of the stds; held to
    1e-4 (median) and 1e-3 (largest)."""
    from fish_eye_bundle_adjustment_tpu.parallel.mesh import make_mesh
    from fish_eye_bundle_adjustment_tpu.solver.covariance import estimate_schur_stds
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    p = jax_block("eop12")
    layout = ParamLayout(p)
    want = estimate_schur_stds(p, layout, layout.initial(), 1.0, n_probe=8,
                               mesh=make_mesh(N))
    got = ranks["stds"]
    rel = np.abs(got["std"] - want) / np.maximum(want, 1e-300)
    assert np.isfinite(got["std"]).all() and got["std"].shape == want.shape
    assert np.median(rel) <= 1e-4 and rel.max() <= 1e-3
    assert got["counts"]["all_reduce"]["calls"] > 0
    assert got["counts"]["reduce_scatter"]["calls"] == got["counts"]["all_gather"]["calls"] == 0
