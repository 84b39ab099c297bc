"""The port's mesh over several hosts (parallel/mesh.py: local and rail
groups, each collective in two levels) against the flat collectives and
the JAX package's 4-device distributed solver.

One group of four gloo ranks on the CPU, as two emulated hosts of two
ranks (parallel/mesh.run_ranks(..., hosts=2); tests/_torch_dist_worker.py),
runs every port case of this module, and a group of two ranks as two
hosts of one runs the collectives again (no local level); the local level is the peer
collectives' plain versions over the host's gloo group, the cross-host
level gloo's own collective over the rail: the decomposition the card runs
with the peer kernels and NCCL.  The JAX side runs here on four devices of
the conftest's CPU mesh, the host loop over its shard_map step
(tests/_torch_blocks.jax_dist_run), and, for the stream of three steps
and the solve, tests/test_multiprocess.py's block and options (that test
holds the JAX package's two processes to the same single-process run)."""

import numpy as np
import pytest

from _torch_blocks import (  # noqa: F401 (one_torch_thread: autouse)
    jax_block,
    jax_dist_run,
    one_torch_thread,
    rel_err,
    to_port,
)
from _torch_dist_worker import host_inputs, run_group

N, HOSTS = 4, 2
STEP_TOL = 1e-10  # tests/test_torch_dist_schur.py: one float64 step at the same x
X_ATOL = 1e-8  # tests/test_torch_dist_schur.py: a solve's x
STREAM_RTOL = 1e-6  # tests/test_multiprocess.py: the L1(delta) stream
CG_TOL = 1e-2
LAMS = (0.0, 0.3)

# tests/test_multiprocess.py's block, options and stream (3 steps, lam 0,
# CG tolerance 1e-8)
MP_BLOCK = dict(n_img=8, n_pts=200, model="fisheye", seed=11,
                settings_overrides={"inner_constraints": False}, control_frac=0.05)
MP_OPTS = dict(cg_maxiter=50, obs_order="tie")
MP_STEPS, MP_TOL = 3, 1e-8
STDS_PROBES = 8  # tests/test_torch_mesh.py's mesh stds

# host tables make_mesh refuses (4 ranks)
REFUSED = {
    "interleaved": ("a", "b", "a", "b"),
    "unequal": ("a", "a", "a", "b"),
}


def _mp_problem():
    from fish_eye_bundle_adjustment_tpu.synth import make_block

    return make_block(**MP_BLOCK).problem


def _x0(problem):
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    return ParamLayout(problem).initial()


def _cases():
    sc, mp, eop = jax_block("selfcal16"), _mp_problem(), jax_block("eop12")
    return {
        "table": ("host_table", dict(refused=REFUSED)),
        "collectives": ("host_collectives", {}),
        "step:selfcal16": ("step", dict(mode="distributed", problem=to_port(sc), opts={},
                                        xs=[_x0(sc)], lams=LAMS, cg_tol=CG_TOL)),
        "stream": ("step_stream", dict(problem=to_port(mp), opts=MP_OPTS, steps=MP_STEPS,
                                       cg_tol=MP_TOL)),
        "solve": ("host_solve", dict(mode="distributed", problem=to_port(mp), opts=MP_OPTS)),
        "dispatch": ("host_dispatch", dict(problem=to_port(mp))),
        "stds": ("mesh_stds", dict(problem=to_port(eop), x=_x0(eop), sigma02=1.0,
                                   n_probe=STDS_PROBES)),
    }


@pytest.fixture(scope="module")
def ranks():
    return run_group(N, _cases(), hosts=HOSTS)


@pytest.fixture(scope="module")
def one_a_host():
    """Two ranks as two hosts of one rank: no local level."""
    return run_group(HOSTS, {"collectives": ("host_collectives", {})}, hosts=HOSTS)


# -- (a) the host table and the groups ----------------------------------------

def test_host_table_and_groups(ranks):
    """Rank r on host r // 2 as local rank r % 2; the local groups are the
    hosts' ranks, the rails the ranks at one local index; the peer
    communicator is the host's; make_mesh makes the groups once."""
    got = ranks["table"]
    assert got["again"]
    for r, t in enumerate(got["ranks"]):
        h, i = divmod(r, N // HOSTS)
        assert (t["index"], t["size"], t["n_hosts"], t["per_host"]) == (r, N, HOSTS, N // HOSTS)
        assert (t["host"], t["local"], t["comm"]) == (h, i, (i, N // HOSTS))
        assert t["local_ranks"] == [h * 2, h * 2 + 1]
        assert t["rail_ranks"] == [i, 2 + i]
        assert len(set(t["names"])) == HOSTS and t["names"] == got["ranks"][0]["names"]


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_make_mesh_refuses_host_table(ranks, case):
    """Ranks of one host with other ranks between them, or hosts of
    unequal rank counts: make_mesh raises (on every rank, before any
    group)."""
    want = {"interleaved": "consecutive rank numbers", "unequal": "same number of ranks"}[case]
    assert want in ranks["table"]["errors"][case]


def test_host_layout_and_run_ranks_refusals():
    """host_layout's counts, its refusals, and run_ranks' refusal of
    hosts that do not divide the ranks (before any process starts)."""
    from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import host_layout, run_ranks

    assert host_layout(["a"] * 4) == (1, 4)
    assert host_layout(["a", "a", "b", "b", "c", "c"]) == (3, 2)
    assert host_layout(["a", "b", "c"]) == (3, 1)
    for names in REFUSED.values():
        with pytest.raises(ValueError):
            host_layout(names)
    with pytest.raises(ValueError, match="hosts of equal size"):
        run_ranks(print, 4, "cpu", hosts=3)


@pytest.mark.parametrize("local", ["agrees", "two machines of one name"])
def test_torchrun_local_rank_checks_host_names(local):
    """Under torchrun (no coordinator) the host names must agree with its
    LOCAL_RANK and LOCAL_WORLD_SIZE: two ranks of one host name that
    torchrun started on two machines (local rank 0 of 1 each) raise in
    init_distributed, before any device is picked; as one machine's two
    local ranks they make a one-host mesh."""
    from _torch_dist_worker import torchrun_rank

    from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import _free_port, spawn_each

    port = _free_port()
    if local == "agrees":
        assert spawn_each(torchrun_rank, [(r, 2, port, r, 2) for r in range(2)],
                          timeout_s=120) == [None, None]
    else:
        with pytest.raises(RuntimeError, match="share a host name"):
            spawn_each(torchrun_rank, [(r, 2, port, 0, 1) for r in range(2)], timeout_s=120)


# -- (b) the two levels against the flat collectives ---------------------------

def _flat_sum(xs):
    """The rank-ordered sum, as numpy adds it."""
    acc = xs[0].copy()
    for x in xs[1:]:
        acc = acc + x
    return acc


@pytest.mark.parametrize("per_host", [2, 1])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["scalar", "odd", "matrix", "blocks", "odd_rows", "rows",
                                  "odd_gather"])
def test_two_levels_match_flat(request, name, dtype, per_host):
    """psum, psum_scatter and all_gather in two levels, over two hosts of
    two ranks and of one, against the flat plain collectives (bitwise
    numpy's rank-ordered sums): gathers bitwise; sums within the roundoff
    of their other order (4 ulp of the sum of magnitudes), equal bits on
    every rank; inputs untouched; one call counted, and each level's calls
    (no local call at one rank a host)."""
    group = request.getfixturevalue("ranks" if per_host == 2 else "one_a_host")
    got = group["collectives"][(name, dtype)]
    n = HOSTS * per_host
    op, _ = host_inputs(0, n, dtype)[name]
    xs = [host_inputs(r, n, dtype)[name][1] for r in range(n)]
    eps = np.finfo(dtype).eps
    assert got["input_unchanged"]
    if op == "all_gather":
        want = np.concatenate(xs)
        for two, flat in zip(got["two"], got["flat"]):
            np.testing.assert_array_equal(flat, want)
            np.testing.assert_array_equal(two, want)
    else:
        total, mag = _flat_sum(xs), sum(np.abs(x) for x in xs)
        if op == "reduce_scatter":
            m = len(xs[0]) // n
            total, mag = total.reshape(n, m, -1), mag.reshape(n, m, -1)
        for r, (two, flat) in enumerate(zip(got["two"], got["flat"])):
            want = total[r].reshape(two.shape) if op == "reduce_scatter" else total
            bound = 4 * eps * (mag[r].reshape(two.shape) if op == "reduce_scatter" else mag)
            np.testing.assert_array_equal(flat, want)
            assert np.all(np.abs(two.astype(np.float64) - want) <= bound)
        if op == "all_reduce":
            assert all(np.array_equal(t, got["two"][0]) for t in got["two"])
    assert got["counts"][op]["calls"] == 1
    assert sum(c["calls"] for c in got["counts"].values()) == 1
    local, cross = got["levels"]["local"], got["levels"]["cross_host"]
    assert sum(c["calls"] for c in cross.values()) == 1
    if op == "all_reduce":
        assert cross["all_reduce"]["bytes"] == -(-xs[0].size // per_host) * xs[0].itemsize
    else:
        assert cross[op]["calls"] == 1
    if per_host == 1:
        assert sum(c["calls"] for c in local.values()) == 0
    elif op == "all_reduce":
        assert (local["reduce_scatter"]["calls"], local["all_gather"]["calls"]) == (1, 1)
    else:
        assert local[op]["calls"] == sum(c["calls"] for c in local.values()) == 1


# -- (c) and (d) against the JAX package's 4-device solver ----------------------

_JAX = {}


def _jax_steps(problem, opts):
    from fish_eye_bundle_adjustment_tpu.parallel.dist_schur import make_distributed_step
    from fish_eye_bundle_adjustment_tpu.solver.schur import SchurOptions

    return jax_dist_run(make_distributed_step, problem, N,
                        SchurOptions(**opts, device_loop=False), xs=[_x0(problem)],
                        lams=LAMS, cg_tol=CG_TOL, solve=False)[0]


def _jax_mp():
    """On tests/test_multiprocess.py's block, one JAX 4-device step
    (compiled once): that test's single-process stream -- the L1(delta)
    of MP_STEPS steps at lam 0 from x0 and the x reached -- and the
    solve's result (solve_schur_distributed's body at device_loop=False,
    as tests/_torch_blocks.jax_dist_run runs it)."""
    if "mp" in _JAX:
        return _JAX["mp"]
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fish_eye_bundle_adjustment_tpu.parallel.dist_schur import make_distributed_step
    from fish_eye_bundle_adjustment_tpu.parallel.mesh import make_mesh
    from fish_eye_bundle_adjustment_tpu.solver import schur as jschur

    problem = _mp_problem()
    opts = jschur.SchurOptions(**MP_OPTS, device_loop=False)
    mesh = make_mesh(N)
    step, obs, layout, order = make_distributed_step(problem, mesh, opts)
    x = jax.device_put(jnp.asarray(layout.initial()), NamedSharding(mesh, P()))
    tol = jnp.asarray(MP_TOL)
    deltas = []
    for _ in range(MP_STEPS):
        x, d, _, _, _ = step(x, obs, tol, jnp.asarray(0.0, x.dtype))
        deltas.append(float(d))
    (xs, history, delta_history, v_shard, stats, count, converged,
     elapsed, stopped_on) = jschur.run_gn_loop(
        step, obs, layout, problem, opts, x_sharding=NamedSharding(mesh, P()))
    res = jschur._finalize(problem, layout, xs, history, delta_history,
                           jschur.unpermute_v(v_shard, order, problem.n_obs),
                           np.asarray(stats), count, converged, elapsed, False, stopped_on)
    _JAX["mp"] = (deltas, np.asarray(x)), res
    return _JAX["mp"]


def test_step_matches_jax(ranks):
    """make_distributed_step on two hosts of two ranks at x0, lam 0 and
    0.3, against the JAX package's 4-device step: the correction, L1(delta),
    the stats and the residual rows within 1e-10, the CG count equal."""
    want = _jax_steps(jax_block("selfcal16"), {})
    x0 = _x0(jax_block("selfcal16"))
    got = ranks["step:selfcal16"]
    assert len(got) == len(want) == len(LAMS)
    for (x1, d, stats, cg, v), (jx1, jd, jstats, jcg, jv) in zip(got, want):
        assert rel_err(x1 - x0, jx1 - x0) <= STEP_TOL
        assert abs(d - jd) <= STEP_TOL * jd
        assert rel_err(stats, jstats) <= STEP_TOL
        assert cg == jcg
        assert rel_err(v, jv[: len(v)]) <= STEP_TOL


def test_stream_matches_jax(ranks):
    """tests/test_multiprocess.py's three steps on two hosts: the
    L1(delta) stream within its 1e-6 of the JAX 4-device stream, the x
    reached within 1e-8, equal bits on every rank."""
    (deltas, x), _ = _jax_mp()
    got = ranks["stream"]
    assert got["bitwise"]
    np.testing.assert_allclose(got["deltas"], deltas, rtol=STREAM_RTOL)
    np.testing.assert_allclose(got["x"], x, rtol=0, atol=X_ATOL)


def test_solve_matches_jax(ranks):
    """solve_schur_distributed on two hosts against the JAX package's
    4-device solve (its host loop): the same iterations and stop, x within
    1e-8 and bitwise on every rank, sigma0^2 within 1e-9 relative; the
    host loop drove it (the default on a mesh that spans hosts); every
    all-reduce crossed the hosts once, on a share of half its bytes."""
    _, want = _jax_mp()
    got = ranks["solve"]
    assert got["driver"] == "host loop" and got["bitwise"]
    assert (got["iterations"], got["converged"], got["stopped_on"]) == (
        want.iterations, want.converged, want.stopped_on)
    np.testing.assert_allclose(got["x"], want.x, rtol=0, atol=X_ATOL)
    assert abs(got["sigma02"] - want.sigma02) <= 1e-9 * want.sigma02
    np.testing.assert_allclose(got["v"], want.v, rtol=0, atol=1e-8)
    counts, cross = got["counts"], got["levels"]["cross_host"]
    assert counts["all_reduce"]["calls"] > 0 and counts["all_gather"]["calls"] == 1
    assert cross["all_reduce"]["calls"] == counts["all_reduce"]["calls"]
    assert cross["all_gather"]["calls"] == 1 and cross["reduce_scatter"]["calls"] == 0
    assert cross["all_reduce"]["bytes"] <= counts["all_reduce"]["bytes"] // 2 + 8 * (
        counts["all_reduce"]["calls"])


def test_mesh_stds_match_jax_mesh_estimate(ranks):
    """estimate_schur_stds(mesh=...) on two hosts of two ranks (the CLI's
    stds under its distributed mode) against the JAX package's mesh
    estimate on four devices: tests/test_torch_mesh.py's block (eop12 at
    its initial point), seed, probes (8) and bounds (float32 probe solves:
    median relative gap 1e-4, largest 1e-3); all-reduces only, every one
    crossing the hosts once."""
    from fish_eye_bundle_adjustment_tpu.parallel.mesh import make_mesh
    from fish_eye_bundle_adjustment_tpu.solver.covariance import estimate_schur_stds
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    p = jax_block("eop12")
    want = estimate_schur_stds(p, ParamLayout(p), _x0(p), 1.0, n_probe=STDS_PROBES,
                               mesh=make_mesh(N))
    got = ranks["stds"]
    rel = np.abs(got["std"] - want) / np.maximum(want, 1e-300)
    assert np.isfinite(got["std"]).all() and got["std"].shape == want.shape
    assert np.median(rel) <= 1e-4 and rel.max() <= 1e-3
    counts, cross = got["counts"], got["levels"]["cross_host"]
    assert counts["all_reduce"]["calls"] > 0
    assert counts["reduce_scatter"]["calls"] == counts["all_gather"]["calls"] == 0
    assert cross["all_reduce"]["calls"] == counts["all_reduce"]["calls"]


# -- (e) the device loop on a mesh that spans hosts ------------------------------

def test_device_loop_rule_on_hosts(ranks):
    """use_device_loop on a mesh that spans hosts: None takes the host
    loop; True raises with the reason, from the rule and from a solve."""
    got = ranks["dispatch"]
    assert got["default"] is False
    for how in ("rule", "solve"):
        assert "device_loop=True: a mesh that spans hosts runs the host loop" in got[how]

