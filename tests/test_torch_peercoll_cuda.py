"""The peer collectives (ops/csrc/peercoll.cu) on the card (marked gpu;
skipped without one).

This file imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_peercoll_cuda.py

Whether there is a card is decided inside each test.  Two ranks run as two
spawned processes on cuda:0 (parallel/mesh.run_ranks over a gloo group,
each rank opening its communicator on the card), which needs one card:

- each collective, float32 and float64, at the cases of
  tests/_torch_dist_worker.peer_inputs (all-reduces on either side of
  the two-shot threshold, lengths no multiple of the ranks times a
  16-byte group, calls past a 4 MiB half in one launch, and in
  chunks at halves of that size): bitwise equal to its plain version
  and to the numpy rank-ordered sum or concatenation, in the launches of
  `peercoll.plan`; every schedule each op takes, bitwise its plain
  version; the collectives (the all-reduce at both schedules) inside IF
  nodes of a captured graph, replayed five times with new inputs and
  flags, so the calls' halves alternate: each replay's results bitwise
  the plain versions', the launches counted on the card those of the IF
  nodes that were on;
- a rank that never arrives: the other's call gives up after its spin
  limit, `check` raises, and later calls return at once;
- with two cards or more, solve_schur_distributed at two NCCL ranks (a
  card each) under the device loop (captured, the peer collectives in its
  IF nodes) and the host loop: x bitwise equal;
- at one NCCL rank, and at two where there are two cards, a dozen
  device-loop solves in one process, each on a default mesh: every one
  captures and agrees with the first, the launch counts of each are its
  own, and the ranks share one peer communicator.
"""

import time

import numpy as np
import pytest
import torch

from _torch_dist_worker import PEER_CHUNKED_BYTES, peer_inputs
from fish_eye_bundle_adjustment_tpu_torch.ops.peercoll import WORKSPACE_BYTES, plan
from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import run_ranks

pytestmark = pytest.mark.gpu

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the peer collectives are CUDA kernels")
    return torch.device("cuda")


def _peer(mesh, spin_s=30.0, workspace_bytes=WORKSPACE_BYTES):
    """This rank's communicator on cuda:0 over the gloo group of `mesh`."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return peercoll.PeerComm(dev, mesh.index, mesh.size, spin_s=spin_s,
                             workspace_bytes=workspace_bytes)


def _rank_parity(mesh, workspace_bytes=WORKSPACE_BYTES):
    """Kernel and plain version of every case: {(name, dtype): (kernel,
    plain, launches)}."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll

    out = {}
    comm = _peer(mesh, workspace_bytes=workspace_bytes)
    for dtype in ("float32", "float64"):
        for name, (op, x) in peer_inputs(mesh.index, mesh.size, dtype).items():
            xt = torch.as_tensor(x, device=comm.device)
            peercoll.reset_counts()
            got = getattr(peercoll, op)(xt, comm)
            want = peercoll.plain(op, xt, comm)
            torch.cuda.synchronize()
            comm.check()
            out[(name, dtype)] = (got.cpu().numpy(), want.cpu().numpy(),
                                  peercoll.kernel_launches[f"peer_{op}"])
    comm.close()
    return out


def _rank_schedules(mesh):
    """Every schedule of every op at a one-group length and a ragged one,
    float32 and float64: {(op, schedule, n, dtype): (kernel, plain)}."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll

    out = {}
    comm = _peer(mesh)
    rng = np.random.default_rng([3, mesh.index])
    for dtype in (torch.float32, torch.float64):
        for n in (4, 100_003):
            for op, schedules in peercoll.TAKES.items():
                rows = mesh.size if op == "reduce_scatter" else 1
                x = torch.as_tensor(rng.standard_normal(rows * n), dtype=dtype,
                                    device=comm.device)
                for schedule in schedules:
                    got = peercoll.run(op, x, comm, schedule=schedule)
                    want = peercoll.plain(op, x, comm)
                    torch.cuda.synchronize()
                    comm.check()
                    out[(op, schedule, n, str(dtype))] = (got.cpu().numpy(), want.cpu().numpy())
    comm.close()
    return out


GRAPH_CASES = (("all_reduce", None), ("all_reduce", 5_000), ("reduce_scatter", None),
               ("all_gather", None))


def _rank_graph(mesh):
    """The collectives of GRAPH_CASES (op, columns of x or all of it)
    under IF nodes of one captured graph, replayed with new inputs and
    flags: per replay (kernel outputs, plain outputs), and the launches
    the replays ran."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll
    from fish_eye_bundle_adjustment_tpu_torch.utils.cudagraph import (
        StepGraph,
        run_if,
    )

    comm = _peer(mesh)
    dev = comm.device
    n = 350_000 * mesh.size  # past a 4 MiB half in float64, in one launch
    x = torch.zeros(n, dtype=torch.float64, device=dev)
    flags = torch.zeros(len(GRAPH_CASES), dtype=torch.bool, device=dev)
    outs = [torch.zeros(n * mesh.size, dtype=torch.float64, device=dev) for _ in GRAPH_CASES]

    def body(k):
        op, cols = GRAPH_CASES[k]
        got = getattr(peercoll, op)(x[:cols], comm)
        outs[k][: got.numel()].copy_(got)

    def step():
        for k in range(len(GRAPH_CASES)):
            run_if(flags[k].clone(), lambda k=k: body(k))

    flags.fill_(True)
    x.copy_(torch.arange(n, dtype=torch.float64, device=dev))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm-up: every collective once, eagerly
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = StepGraph()
    graph.capture(step)
    rng = np.random.default_rng([7, mesh.index])
    replays = []
    for on in ((True, True, True, True), (False, True, True, False), (True, False, False, True),
               (True, True, False, False), (False, False, True, True)):
        x.copy_(torch.as_tensor(rng.standard_normal(n), device=dev))
        for o in outs:
            o.zero_()
        flags.copy_(torch.tensor(on, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        comm.check()
        want = [peercoll.plain(op, x[:cols], comm).cpu().numpy() for op, cols in GRAPH_CASES]
        replays.append((on, [o.cpu().numpy() for o in outs], want))
    ran = graph.collect(add=False)
    comm.close()
    return replays, {k: v for k, v in ran.items() if str(k).startswith("peer_")}


def _rank_absent(mesh):
    """Rank 1 opens its communicator and never calls; rank 0 calls and
    must give up: (seconds to the raise, its message, seconds of a call
    on the dead communicator)."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll

    comm = _peer(mesh, spin_s=2.0)
    if mesh.index != 0:
        comm.close()
        return None
    x = torch.ones(10, device=comm.device)
    t0 = time.perf_counter()
    peercoll.all_reduce(x, comm)
    torch.cuda.synchronize()
    waited = time.perf_counter() - t0
    try:
        comm.check()
        msg = None
    except RuntimeError as e:
        msg = str(e)
    # the wrapper refuses a dead communicator; the kernel itself returns at once
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    out = torch.empty_like(x)
    t0 = time.perf_counter()
    _build.check(_build.load().peercoll_run(comm.handle, 0, 1, 0, x.data_ptr(), 10,
                                            out.data_ptr(), 10, 10, 1,
                                            torch.cuda.current_stream().cuda_stream),
                 "peer all_reduce")
    torch.cuda.synchronize()
    dead_call = time.perf_counter() - t0
    comm.close()
    return waited, msg, dead_call


def _want(op, xs, rank):
    if op == "all_gather":
        return np.concatenate(xs)
    acc = xs[0].copy()
    for x in xs[1:]:
        acc = acc + x
    if op == "reduce_scatter":
        m = acc.shape[0] // len(xs)
        return acc[rank * m : (rank + 1) * m]
    return acc


def _check_parity(got, half):
    inputs = [peer_inputs(r, 2, "float32") for r in range(2)]
    for (name, dtype), (kern, plain, launches) in got.items():
        op, x = inputs[0][name]
        xs = [peer_inputs(r, 2, dtype)[name][1] for r in range(2)]
        np.testing.assert_array_equal(kern, plain, err_msg=f"{name} {dtype}")
        np.testing.assert_array_equal(kern, _want(op, xs, 0), err_msg=f"{name} {dtype}")
        rows = 2 if op == "reduce_scatter" else 1
        chunks = plan(op, x.size // rows, np.dtype(dtype).itemsize, 2, half, 1)
        assert launches == len(chunks), (name, dtype)
        if name.startswith("big"):
            assert (launches > 1) == (half < WORKSPACE_BYTES), (name, dtype)


def test_collectives_match_plain_bitwise():
    _card()
    _check_parity(run_ranks(_rank_parity, 2, "cpu", timeout_s=300), WORKSPACE_BYTES)


def test_collectives_in_chunks_match_plain_bitwise():
    _card()
    got = run_ranks(_rank_parity, 2, "cpu", args=(PEER_CHUNKED_BYTES,), timeout_s=300)
    _check_parity(got, PEER_CHUNKED_BYTES)


def test_every_schedule_matches_plain_bitwise():
    _card()
    got = run_ranks(_rank_schedules, 2, "cpu", timeout_s=300)
    assert len(got) == 2 * 2 * 4  # dtypes, lengths, (op, schedule)
    for key, (kern, plain) in got.items():
        np.testing.assert_array_equal(kern, plain, err_msg=str(key))


def test_collectives_inside_if_nodes():
    _card()
    replays, ran = run_ranks(_rank_graph, 2, "cpu", timeout_s=300)
    want_ran = {}
    for on, got, want in replays:
        for k, (op, cols) in enumerate(GRAPH_CASES):
            if on[k]:
                n = want[k].size
                np.testing.assert_array_equal(got[k][:n], want[k], err_msg=str(GRAPH_CASES[k]))
                cols = n // 2 if op == "all_gather" else n
                chunks = plan(op, cols, 8, 2, WORKSPACE_BYTES, 1)
                want_ran[f"peer_{op}"] = want_ran.get(f"peer_{op}", 0) + len(chunks)
            else:
                assert not got[k].any(), GRAPH_CASES[k]
    assert ran == want_ran


def test_absent_rank_raises_and_does_not_hang():
    _card()
    waited, msg, dead_call = run_ranks(_rank_absent, 2, "cpu", timeout_s=120)
    assert msg is not None and "waited more than 2.0 s for rank 1" in msg
    assert 2.0 <= waited < 20.0
    assert dead_call < 1.0


def _rank_solves(mesh):
    from fish_eye_bundle_adjustment_tpu_torch.parallel.dist_schur import solve_schur_distributed
    from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop
    from fish_eye_bundle_adjustment_tpu_torch.solver.schur import SchurOptions
    from fish_eye_bundle_adjustment_tpu_torch.synth import make_block

    p = make_block(n_img=12, n_pts=150, seed=13).problem
    out = {}
    for name, dl in (("device", None), ("host", False)):
        device_loop.loop_counts.clear()
        r = solve_schur_distributed(p, mesh, SchurOptions(explicit_s=False, device_loop=dl))
        out[name] = dict(x=r.x, iterations=r.iterations, cg=r.cg_iterations,
                         graph=bool(device_loop.loop_counts.get("graph")),
                         peer=mesh.comm is not None)
    return out


def test_distributed_device_loop_on_two_cards():
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: NCCL takes one rank a card")
    got = run_ranks(_rank_solves, 2, "cuda", timeout_s=600)
    dev, host = got["device"], got["host"]
    assert dev["graph"] and not host["graph"] and dev["peer"]
    assert (dev["iterations"], dev["cg"]) == (host["iterations"], host["cg"])
    np.testing.assert_array_equal(dev["x"], host["x"])


N_DEFAULT_SOLVES = 12


def _rank_default_solves(mesh):
    """N_DEFAULT_SOLVES device-loop solves, each on the default mesh (a
    new Mesh a call): per solve (x, whether it captured, the peer launches
    and the kernel launches its replays ran, the group's communicator)."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import peercoll
    from fish_eye_bundle_adjustment_tpu_torch.parallel import mesh as pmesh
    from fish_eye_bundle_adjustment_tpu_torch.parallel.dist_schur import solve_schur_distributed
    from fish_eye_bundle_adjustment_tpu_torch.solver import device_loop
    from fish_eye_bundle_adjustment_tpu_torch.solver.schur import SchurOptions
    from fish_eye_bundle_adjustment_tpu_torch.synth import make_block

    p = make_block(n_img=12, n_pts=150, seed=13).problem
    out = []
    for _ in range(N_DEFAULT_SOLVES):
        peercoll.reset_counts()
        device_loop.loop_counts.clear()
        r = solve_schur_distributed(p, options=SchurOptions(explicit_s=False))
        lc = device_loop.loop_counts
        out.append((r.x, bool(lc.get("graph")), sum(peercoll.kernel_launches.values()),
                    dict(lc.get("replayed", {})), id(pmesh._STATE["comm"])))
    return out, mesh.comm is None or id(mesh.comm) == out[0][4]


@pytest.mark.parametrize("ranks", [1, 2])
def test_many_default_mesh_solves_in_one_process(ranks):
    _card()
    if torch.cuda.device_count() < ranks:
        pytest.skip(f"needs {ranks} CUDA cards: NCCL takes one rank a card")
    solves, shared = run_ranks(_rank_default_solves, ranks, "cuda", timeout_s=900)
    assert shared
    x0, _, launches0, replayed0, comm0 = solves[0]
    assert replayed0 and (launches0 > 0) == (ranks > 1)
    for x, graph, launches, replayed, comm in solves:
        assert graph and comm == comm0
        np.testing.assert_array_equal(x, x0)
        assert (launches, replayed) == (launches0, replayed0)
