"""Device-resident Gauss-Newton driver.

PyTorch port of fish_eye_bundle_adjustment_tpu/solver/device_loop.py.
`run_gn_loop` (solver/schur.py) reads the step's correction L1 and its
merit values back to the host every iteration.  This module runs the
same algorithm -- deferred trust-region LM validation (gain-ratio
accept/reject with Nielsen's lambda schedule), Eisenstat-Walker CG
forcing, convergence on the reference's L1-of-correction contract plus
the plateau stop, the iteration cap and both divergence detectors -- on
the device, and reads the host once per `chunk` iterations.  Per-iteration
events (accepted and rejected trials with their delta, lambda and forcing
tolerance) are written into a record buffer on the device and replayed on
the host after each chunk, so progress callbacks, delta_history and
checkpoints behave as in the host loop (checkpoints land on chunk
boundaries).

The chunk body is the JAX package's, step for step: branch-free state
updates (where-merges), a masked record write, one packed read a chunk.
Its two executions:

- on a CUDA device the body is captured once per solve as a CUDA graph
  over static tensors (the state, the record buffer and its cursors),
  after one warm-up of the body on a copy of the state, and each GN
  iteration is one replay.  The body sits under an IF node on ``status ==
  RUNNING`` (utils/cudagraph.py), the JAX while_loop's condition, so a
  replay after the stop runs nothing; that lets the host issue the next
  chunk before it reads this one, as the JAX loop does.  CG runs without
  host reads, each block of its masked iterations under an IF node on the
  flag the host loop reads (solver/schur.py `device_cg`).  Over several
  ranks the mesh's collectives are kernels over peer memory
  (ops/peercoll.py) inside the same IF nodes, where NCCL's would not
  capture; every rank captures and replays the same body in lockstep, and
  a rank that never arrives makes the others' collectives give up, which
  the read after each chunk raises;
- on the CPU (the tests) the same body runs eagerly, the conditions read
  from host memory.

The JAX records' five columns (kind, count, delta, lambda, forcing
tolerance) are kept and packed to float32 as the JAX package packs them,
so delta_history carries the same rounding; a sixth column holds each
step's CG iteration count (the port's results list them).  Divergence
raises SolverDivergence(count + 1, ...), as the JAX loop does.

The kernels' launch counters are Python integers that a wrapper moves
where it launches its kernel.  A capture launches nothing, so its moves
(the launches, CG matvecs and collectives captured in one body) go into
`loop_counts["per_body"]` and the counters are set back to where the
warm-up body left them; the launches the replays ran are counted on the
card (utils/cudagraph.count_launch) and added to the counters after the
loop (`loop_counts["replayed"]`).  So after a captured solve the launch
counters and a mesh's collective counts (Mesh.counts, counted the same
way) hold the warm-up's plus what the replays ran, an IF node that was
off counting nothing; the CG counters hold the warm-up's.  Solves in
other processes (the pose graph's block solves, a process a card) move
their own counters, which the caller adds (add_counter_moves).

Under a trace (utils/observe.trace) the loop's phases are host spans
(loop.setup, loop.warmup, loop.capture, loop.replays, loop.teardown) and
each step a device span (``gn.step``: a pair of stamps captured into the
step's IF body), read back in the teardown.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.utils import checkpoint as ckpt_mod
from fish_eye_bundle_adjustment_tpu_torch.utils.cudagraph import (
    StepGraph,
    capture_lock,
    run_if,
)
from fish_eye_bundle_adjustment_tpu_torch.utils import observe
from fish_eye_bundle_adjustment_tpu_torch.utils.observe import (
    IterationRecord,
    SolverDivergence,
    Stopwatch,
    collect_stamps,
    device_span,
    span,
)

# status codes carried on device
RUNNING = 0
CONV_THRESHOLD = 1
CONV_PLATEAU = 2
STOP_CAP = 3
DIVERGED = 4

# record kinds
REC_UNUSED = 0
REC_ACCEPT = 1
REC_REJECT = 2

# record columns: the JAX package's five, then the step's CG iterations
# (written by step, not by event; -1 where no step ran)
N_COLS = 6
CG_COL = 5

_STOPPED_ON = {CONV_THRESHOLD: "threshold", CONV_PLATEAU: "plateau",
               STOP_CAP: "cap"}

_STATE_KEYS = ("x", "v", "stats", "count", "status", "have_pend", "pend_x",
               "pend_cost", "pend_model", "pend_delta", "pend_v", "pend_stats",
               "lam", "nu", "cg_tol", "delta0", "run_min", "dbuf")

# What the last run_gn_loop_device did: whether it captured a graph, the
# seconds of warm-up and capture, the counters' moves in the warm-up body
# (`warmup`: launches that ran) and in one captured body (`per_body`:
# launches captured, whether or not a replay runs them), both keyed as
# _counters() keys them, replays issued, steps run (bodies whose condition
# held), packed reads, the seconds of the chunk loop (first replay to the
# last read, the queue drained), the bytes the capture reserved, and the
# kernel launches the replays ran (`replayed`, by counter key).
loop_counts: dict = {}


def _counters(mesh=None):
    """The launch and CG counters a captured body moves, by name, with a
    mesh's collective counts (Mesh.counts) when given."""
    from fish_eye_bundle_adjustment_tpu_torch.ops import (
        fusedmv, peercoll, prefix, probes, streamseg,
    )
    from fish_eye_bundle_adjustment_tpu_torch.solver import schur

    out = {"fusedmv": fusedmv.kernel_launches, "fusedmv_plain": fusedmv.plain_calls,
           "prefix": prefix.kernel_launches, "prefix_by_width": prefix.kernel_launches_by_width,
           "prefix_plain": prefix.plain_calls, "streamseg": streamseg.kernel_launches,
           "streamseg_plain": streamseg.plain_calls, "probes": probes.kernel_launches,
           "probes_plain": probes.plain_calls, "peercoll": peercoll.kernel_launches,
           "peercoll_plain": peercoll.plain_calls, "stamp": observe.stamp_launches,
           "cg": schur.cg_counts}
    if mesh is not None:
        out["mesh"] = mesh.counts
    return out


def _copy(d):
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in d.items()}


def _diff(after, before):
    return {k: _diff(v, before.get(k, {})) if isinstance(v, dict) else v - before.get(k, 0)
            for k, v in after.items()}


def snapshot_counters() -> dict:
    """A copy of every launch and CG counter of this process, keyed as
    _counters() keys them."""
    return {k: _copy(d) for k, d in _counters().items()}


def counter_moves(before: dict) -> dict:
    """What the counters moved since `before` (a snapshot_counters())."""
    return {k: _diff(d, before[k]) for k, d in _counters().items()}


def add_counter_moves(moves: dict) -> None:
    """Add `moves` (counter_moves of work done in another process) to this
    process's counters."""
    def add(d, m):
        for k, v in m.items():
            if isinstance(v, dict):
                add(d.setdefault(k, {}), v)
            else:
                d[k] = d.get(k, 0) + v

    counters = _counters()
    for k, m in moves.items():
        add(counters[k], m)


def _restore(d, saved):
    for k in list(d):
        if k not in saved:
            del d[k]
    for k, v in saved.items():
        if isinstance(v, dict):
            _restore(d[k], v)
        else:
            d[k] = v


def _make_body(raw_step, obs, opts, settings, dtype, st, recs, ri, si):
    """The chunk body: one GN step of the JAX package's chunk_fn, in place
    on the state tensors `st`, the record buffer `recs` and its cursors
    (`ri` by event, `si` by step).  Scalar state is in the solver dtype --
    the values the host loop reads back and rounds through float()."""
    sdt = st["x"].dtype
    thr = float(settings.threshold)
    cap = int(settings.iteration_cap)
    adaptive = bool(opts.adaptive_damping)
    forcing = bool(opts.adaptive_forcing)
    fmax = float(opts.forcing_max)
    tolmin = float(opts.cg_tol)
    kick = float(opts.damping_kick)
    max_damping = float(opts.max_damping)
    plateau = bool(opts.plateau_detection)
    slack_rel = float(np.finfo(np.dtype(dtype)).eps) ** (2.0 / 3.0)
    ev = recs[:, :CG_COL]  # the event columns
    no_step = torch.full((1,), -1.0, dtype=sdt, device=recs.device)

    def write_rec(do, kind, count, delta, lam, cg_tol):
        """Masked record write: the row lands at the cursor either way
        (kind UNUSED when masked -- overwritten by the next real event or
        left as the terminator), the cursor advances only on real events.
        Branch-free, as the JAX body is."""
        row = torch.stack([do.to(sdt) * kind, count.to(sdt), delta, lam, cg_tol])
        ev.index_copy_(0, ri.view(1), row.view(1, CG_COL))
        ri.add_(do.to(ri.dtype))

    def apply_accept(s, do):
        """accept_pending() as a where-merge: when `do` the pending trial
        becomes the iterate (count, forcing tol, plateau buffer, stopping
        checks all advance); otherwise the state passes through."""
        delta = s["pend_delta"]
        count1 = s["count"] + 1
        # non-adaptive divergence detector (check_divergence): NaN/Inf or a
        # 1e6x blow-up over the best previous correction
        finite = torch.isfinite(delta)
        blew_up = finite & (delta > 1e6 * s["run_min"])
        diverged = ((~finite | blew_up) & do) if not adaptive else torch.zeros_like(do)
        run_min = torch.where(do & finite, torch.minimum(s["run_min"], delta), s["run_min"])
        # Eisenstat-Walker forcing from relative progress
        delta0_new = torch.where(s["delta0"] > 0, s["delta0"], torch.clamp(delta, min=1e-30))
        delta0 = torch.where(do, delta0_new, s["delta0"])
        rel = delta / delta0_new
        cg_tol = (torch.where(do, torch.clamp(rel * rel, min=tolmin, max=fmax), s["cg_tol"])
                  if forcing else s["cg_tol"])
        dbuf_new = torch.cat([s["dbuf"][1:], delta.view(1)])
        dbuf = torch.where(do, dbuf_new, s["dbuf"])
        write_rec(do, REC_ACCEPT, count1, delta, s["lam"], cg_tol)
        # stopping decisions (at acceptance, as in accept_pending)
        lam_low = s["lam"] <= 1e-3
        conv_thr = (delta <= thr) & (lam_low if adaptive else torch.ones_like(do))
        last5, prev5 = dbuf_new[5:], dbuf_new[:5]
        m_last, m_prev = last5.mean(), prev5.mean()
        flat = (last5.max() - last5.min()) <= 0.02 * m_last.abs()
        improving = m_last < 0.98 * m_prev
        conv_plat = ((count1 >= 10) & lam_low & flat & ~improving
                     & torch.isfinite(dbuf_new).all()) if plateau else torch.zeros_like(do)
        status_acc = torch.where(
            diverged, DIVERGED, torch.where(
                conv_thr, CONV_THRESHOLD, torch.where(
                    conv_plat, CONV_PLATEAU, torch.where(count1 >= cap, STOP_CAP, RUNNING))))
        return dict(
            s,
            x=torch.where(do, s["pend_x"], s["x"]),
            v=torch.where(do, s["pend_v"], s["v"]),
            stats=torch.where(do, s["pend_stats"], s["stats"]),
            count=torch.where(do, count1, s["count"]),
            run_min=run_min, delta0=delta0, cg_tol=cg_tol, dbuf=dbuf,
            status=torch.where(do, status_acc.to(torch.int32), s["status"]),
            have_pend=s["have_pend"] & ~do,
        )

    def body():
        with device_span("gn.step", st["x"]):
            step()

    def step():
        s = dict(st)
        # a step ran (the JAX while_loop's condition held): every body is
        # masked by it, so a body past the stop leaves the state alone
        running = s["status"] == RUNNING
        x_in = torch.where(s["have_pend"], s["pend_x"], s["x"])
        x_trial, dsum, v_trial, stats_t, cg_iters = raw_step(x_in, obs, s["cg_tol"], s["lam"])
        cost_here = stats_t[3]
        rejected = torch.zeros_like(s["have_pend"])
        if adaptive:
            # validate the pending trial against the true cost its point
            # shows (this step's cost_old)
            validating = s["have_pend"]
            actual = s["pend_cost"] - cost_here
            pred = s["pend_cost"] - s["pend_model"]
            slack = slack_rel * torch.clamp(s["pend_cost"], min=1.0)
            finite = torch.isfinite(cost_here) & torch.isfinite(s["pend_delta"])
            tiny = finite & (s["pend_delta"] <= thr)
            ok = tiny | (finite & (actual >= -slack))
            rejected = validating & ~ok
            # Nielsen schedule on acceptance; raise-and-double on rejection
            rho = torch.where(pred > slack, actual / pred, 1.0)
            lam_acc = s["lam"] * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            lam_acc = torch.where(lam_acc < 1e-14, 0.0, lam_acc)
            lam_rej = torch.clamp(s["lam"] * s["nu"], min=kick)
            nu_rej = torch.clamp(s["nu"] * 2.0, max=64.0)
            lam = torch.where(rejected, lam_rej, torch.where(validating, lam_acc, s["lam"]))
            nu = torch.where(rejected, nu_rej, torch.where(validating, 2.0, s["nu"]))
            diverged = rejected & (lam > max_damping)
            write_rec(rejected, REC_REJECT, s["count"], s["pend_delta"], lam, s["cg_tol"])
            s.update(
                lam=lam, nu=nu,
                status=torch.where(diverged, DIVERGED, s["status"]).to(torch.int32),
                # a rejection discards the pending trial AND this step's
                # outputs (computed from the bad trial point)
                have_pend=s["have_pend"] & ~rejected,
            )

        # the surviving pending trial becomes the iterate
        s = apply_accept(s, s["have_pend"] & (s["status"] == RUNNING))

        # stage this step's trial as the new pending iterate
        stage = (s["status"] == RUNNING) & ~rejected
        s.update(
            pend_x=torch.where(stage, x_trial, s["pend_x"]),
            pend_cost=torch.where(stage, cost_here, s["pend_cost"]),
            pend_model=torch.where(stage, stats_t[0], s["pend_model"]),
            pend_delta=torch.where(stage, dsum, s["pend_delta"]),
            pend_v=torch.where(stage, v_trial, s["pend_v"]),
            pend_stats=torch.where(stage, stats_t, s["pend_stats"]),
            have_pend=s["have_pend"] | stage,
        )
        # immediate acceptance: pure-GN mode always, or a tiny trial (at the
        # fixed point damped and undamped corrections coincide)
        immediate = (stage & torch.isfinite(dsum) & (dsum <= thr)) if adaptive else stage
        s = apply_accept(s, immediate)
        for k in _STATE_KEYS:
            st[k].copy_(s[k])
        cg = torch.where(running, cg_iters.to(sdt).view(1), no_step)
        recs[:, CG_COL].index_copy_(0, si.view(1), cg)
        si.add_(running.to(si.dtype))

    return body


def _init_state(x, n_pad, count, cg_tol0, delta0, delta_history, opts, sdt, dev):
    dbuf0 = np.full(10, np.inf, np.dtype(opts.dtype))
    if delta_history:
        tail = delta_history[-10:]
        dbuf0[10 - len(tail):] = tail
    finite_hist = [d for d in delta_history if np.isfinite(d)]
    f = lambda v: torch.tensor(v, dtype=sdt, device=dev)
    return dict(
        x=x.clone(),
        v=torch.zeros((n_pad, 2), dtype=sdt, device=dev),
        stats=torch.zeros(4, dtype=sdt, device=dev),
        count=torch.tensor(count, dtype=torch.int32, device=dev),
        status=torch.tensor(RUNNING, dtype=torch.int32, device=dev),
        have_pend=torch.tensor(False, device=dev),
        pend_x=x.clone(),
        pend_cost=f(0.0),
        pend_model=f(0.0),
        pend_delta=f(0.0),
        pend_v=torch.zeros((n_pad, 2), dtype=sdt, device=dev),
        pend_stats=torch.zeros(4, dtype=sdt, device=dev),
        lam=f(opts.init_damping),
        nu=f(2.0),
        cg_tol=f(cg_tol0),
        delta0=f(delta0),
        run_min=f(min(finite_hist) if finite_hist else np.inf),
        dbuf=torch.as_tensor(dbuf0, device=dev),
    )


def run_gn_loop_device(
    raw_step, obs, layout, problem, opts, x0=None, progress_fn=None,
    checkpoint_path=None, checkpoint_every: int = 1, chunk: int = 16,
    n_pad: Optional[int] = None, device="cpu", writes_checkpoints: bool = True,
    cg_iterations: Optional[list] = None, capture: Optional[bool] = None,
    mesh=None,
):
    """Drop-in replacement for solver/schur.run_gn_loop running `chunk` GN
    iterations per host read.  Same return tuple: (x, history,
    delta_history, v_local, stats, count, converged, elapsed, stopped_on);
    keep_history is not supported (solve_schur runs the host loop for
    it).

    `n_pad` is the residual-row count of the step's v (default
    obs.W.shape[0]).  `device` holds the state; a CUDA device captures the
    body as a CUDA graph unless `capture` is False (the eager body, for
    comparing the two on the card).  Each step's CG iteration count is
    appended to `cg_iterations` when given.  Under a mesh every rank runs
    the loop in lockstep (the packed read is equal on every rank); only
    the rank with `writes_checkpoints` saves checkpoints, `mesh`'s
    collective counts (Mesh.counts) are kept like the launch counters, and
    its check runs after each chunk's read (a collective that gave up
    waiting for a rank raises there)."""
    settings = problem.settings
    dev = torch.device(device)
    capture = dev.type == "cuda" if capture is None else capture
    if capture and dev.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, not {dev}")
    from fish_eye_bundle_adjustment_tpu_torch.solver.schur import device_cg, torch_dtype

    sdt = torch_dtype(opts.dtype)
    t0 = time.perf_counter()
    # x0 on the device, the state, the record buffer and the host slots
    with span("loop.setup"):
        x = torch.as_tensor(
            (layout.initial() if x0 is None else np.asarray(x0)).astype(opts.dtype), device=dev)
        delta_history: list = []
        count = 0
        cg_tol0 = opts.forcing_max if opts.adaptive_forcing else opts.cg_tol
        delta0 = 0.0
        if checkpoint_path is not None:
            resumed = ckpt_mod.load_checkpoint(checkpoint_path, problem)
            if resumed is not None:
                x = torch.as_tensor(resumed.x.astype(opts.dtype), device=dev)
                count = resumed.iteration
                delta_history = list(resumed.delta_history)
                if delta_history:
                    delta0 = max(delta_history[0], 1e-300)
                    rel = delta_history[-1] / delta0
                    cg_tol0 = max(opts.cg_tol, min(opts.forcing_max, rel * rel))
        watch = Stopwatch()
        if n_pad is None:
            n_pad = obs.W.shape[0]
        st = _init_state(x, n_pad, count, cg_tol0, delta0, delta_history, opts, sdt, dev)
        nrec = 2 * chunk + 2
        recs = torch.zeros((nrec, N_COLS), dtype=sdt, device=dev)
        ri = torch.zeros((), dtype=torch.long, device=dev)
        si = torch.zeros((), dtype=torch.long, device=dev)
        body = _make_body(raw_step, obs, opts, settings, opts.dtype, st, recs, ri, si)

        def gated():
            # the JAX while_loop's condition (status == RUNNING): each body writes
            # at most 2 records, so the buffer's bound never binds within a chunk
            run_if(st["status"] == RUNNING, body)

        counters = _counters(mesh)
        info = dict(graph=capture, capture_s=0.0, warmup={}, per_body={}, replays=0, steps=0,
                    reads=0, loop_s=0.0, capture_reserved_bytes=0, replayed={})
        graph = None
        # two pinned host buffers for the packed reads and their events, taken
        # in turn: a chunk's read is in flight while the next chunk runs
        slots = ([(torch.empty(nrec * N_COLS + 3, pin_memory=True), torch.cuda.Event())
                  for _ in range(2)] if dev.type == "cuda" else [])
    with device_cg():
        if capture:
            # the bodies that count launches: the step and each CG block
            # (one CG a step), with room to spare
            bodies = 16 + 2 * -(-opts.cg_maxiter // 8)
            graph = _capture(gated, body, st, recs, ri, si, dev, counters, info, bodies)
        step_once = graph.replay if graph is not None else gated

        def issue():
            """One chunk of steps, then its packed records on their way to
            the host: (host tensor, event or None, x at the chunk's end for
            a checkpoint)."""
            recs.zero_()
            recs[:, CG_COL] = -1
            ri.zero_()
            si.zero_()
            for _ in range(chunk):
                step_once()
            info["replays"] += chunk
            # pack everything the host reads per chunk into one array
            packed = torch.cat([recs.reshape(-1).float(), st["status"].float().view(1),
                                st["count"].float().view(1), st["pend_delta"].float().view(1)])
            snap = st["x"].clone() if checkpoint_path is not None else None
            if dev.type != "cuda":
                return packed, None, snap
            host, done = slots[info["replays"] // chunk % 2]
            host.copy_(packed, non_blocking=True)
            done.record()
            return host, done, snap

        status = RUNNING
        t_loop = time.perf_counter()
        replays = span("loop.replays")
        try:
            with replays:
                pending = issue()
                while True:
                    # speculative: the next chunk is issued before this one is
                    # read; a chunk issued on a finished state runs no step
                    nxt = issue()
                    host, done, snap = pending
                    if done is not None:
                        done.synchronize()  # ONE host sync per chunk
                        if mesh is not None:
                            mesh.check()
                    info["reads"] += 1
                    arr = host.double().numpy()
                    recs_h = arr[: nrec * N_COLS].reshape(nrec, N_COLS)
                    status = int(arr[-3])
                    lap = watch.lap()
                    cgs = recs_h[:, CG_COL]
                    steps = [int(c) for c in cgs[cgs >= 0]]
                    info["steps"] += len(steps)
                    if cg_iterations is not None:
                        cg_iterations.extend(steps)
                    n_events = int(np.sum(recs_h[:, 0] != REC_UNUSED))
                    n_accepts = int(np.sum(recs_h[:, 0] == REC_ACCEPT))
                    per = lap / max(n_events, 1)
                    for kind, cnt, delta, lam, ctol in recs_h[:, :CG_COL]:
                        if kind == REC_UNUSED:
                            break
                        if kind == REC_ACCEPT:
                            delta_history.append(float(delta))
                        if progress_fn is not None:
                            progress_fn(IterationRecord(
                                int(cnt), float(delta), per, float(ctol),
                                accepted=kind == REC_ACCEPT, damping=float(lam),
                            ))
                    count = int(arr[-2])
                    if status == DIVERGED:
                        bad = float(recs_h[n_events - 1][2]) if n_events else float(arr[-1])
                        raise SolverDivergence(count + 1, bad, delta_history)
                    if checkpoint_path is not None and writes_checkpoints and n_accepts and (
                        count // checkpoint_every > (count - n_accepts) // checkpoint_every
                    ):
                        ckpt_mod.save_checkpoint(
                            checkpoint_path,
                            ckpt_mod.SolverCheckpoint(
                                x=snap.cpu().numpy(), iteration=count,
                                delta_history=delta_history,
                                meta={k: str(v) for k, v in
                                      ckpt_mod.problem_fingerprint(problem).items()},
                            ),
                        )
                    if status != RUNNING:
                        break
                    pending = nxt
        finally:
            with span("loop.teardown"):
                if dev.type == "cuda":
                    # the speculative chunk is still queued: let it finish before
                    # the graph and its pools go
                    torch.cuda.current_stream(dev).synchronize()
                info["loop_s"] = time.perf_counter() - t_loop
                if graph is not None:
                    info["replayed"] = graph.collect()
                # the graph and its pool go here, inside the teardown's span
                graph = step_once = None
                collect_stamps(dev, replays.id)
                loop_counts.clear()
                loop_counts.update(info)

    elapsed = time.perf_counter() - t0
    converged = status in (CONV_THRESHOLD, CONV_PLATEAU)
    stopped_on = _STOPPED_ON.get(status, "cap")
    return (st["x"], [], delta_history, st["v"], st["stats"], count,
            converged, elapsed, stopped_on)


def _capture(gated, body, st, recs, ri, si, dev, counters, info, bodies):
    """Warm the body up on a copy of the state (builds the kernels and the
    host caches, sets the kernels' attributes, warms the allocator), then
    capture `gated`; the seconds, the counters' moves in each and the
    bytes the capture reserved go into `info`.  The counters keep the
    warm-up's launches, which ran, and lose the capture's, which did not.
    Returns the StepGraph."""
    t0 = time.perf_counter()
    with capture_lock, torch.cuda.device(dev):
        with span("loop.warmup", stage="warm-up"):
            before = {k: _copy(d) for k, d in counters.items()}
            saved = {k: v.clone() for k, v in st.items()}
            saved_recs = (recs.clone(), ri.clone(), si.clone())
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                body()
            torch.cuda.current_stream(dev).wait_stream(side)
            for k, v in saved.items():
                st[k].copy_(v)
            for t, v in zip((recs, ri, si), saved_recs):
                t.copy_(v)
            torch.cuda.synchronize(dev)
        with span("loop.capture", stage="capture"):
            warmed = {k: _copy(d) for k, d in counters.items()}
            graph = StepGraph(bodies)
            # the capture empties the allocator's cache first: measure from there
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            graph.capture(gated)
            info["warmup"] = {k: _diff(warmed[k], before[k]) for k in counters}
            info["per_body"] = {k: _diff(d, warmed[k]) for k, d in counters.items()}
            for k, d in counters.items():
                _restore(d, warmed[k])
            info["capture_reserved_bytes"] = torch.cuda.memory_reserved(dev) - reserved
        # the loop.warmup and loop.capture spans, end to end
        info["capture_s"] = time.perf_counter() - t0
    return graph
