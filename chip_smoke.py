"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Drives the port's two matrix-free paths -- the float32 fused Schur
Gauss-Newton solve and the float64 unfused one -- on the 1k-image / 100k-point
self-calibrating fisheye block of bench.py, after building the CUDA
kernels from ops/csrc and holding each against its plain PyTorch version
at the block's shapes; then the paths of the JAX package's remaining
Pallas kernels, its bench scripts, through their twins
(bench_torch_streamseg.py, bench_torch_pallas_gather.py,
bench_torch_pallas_onehot.py) at those scripts' sizes; then the dense
CLI, the default solve_schur (the explicit dense S and the stds), the
stds at the bench block, the distributed solvers of parallel/ on an NCCL
group, the device loop (the step as a CUDA graph), the pose-graph merge
(its blocks a process a card over several cards), the mesh's collectives
as peer-memory kernels at two ranks, and BASELINE configs[5]'s
10k-image block.  Imports nothing of JAX.  Phases:

  1. environment   torch / CUDA / nvcc versions, card name and power limit
  2. build         nvcc of ops/csrc/*.cu (fusedmv, prefix, streamseg,
                   gather, scatter, graphcond: the device loop's IF
                   nodes, and peercoll: the mesh's collectives), one
                   process each, started together
                   (seconds, ptxas report; registers, spills and static
                   shared memory of K1's and K2's kernels in one line each)
  3. block         synth.make_block at the bench size, its band plan, and
                   the host time of the kernels' index (BandArrays.from_plan)
  4. kernels       K1 and K2 (three modes) against their plain versions on
                   one linearization, at the JAX package's default operand
                   precisions ("bf16x2"; the CG matvec also at "bf16"):
                   relative norm error <= 1e-5 on every
                   output the solver reads, bitwise repeatable, median
                   times of kernel and plain version (CUDA events), the
                   bound of each kernel and mode and the kernel's multiple
                   of it, the device time of the group kernel and of the
                   reduce (torch.profiler), the bytes of the kernels' host
                   index (beside the bound, not in it); each group kernel's
                   dynamic shared memory and resident CTAs per SM at these
                   shapes, as its wrapper launches it, and at the band
                   plan's caps (T = 16384, W = 2048, M = 128)
  5. reference     a 12-image block solved on the card and on the CPU
                   (plain versions): x within rtol=3e-5, atol=3e-4
  6. main path     solve_schur(..., SchurOptions(dtype=float32,
                   cg_maxiter=40, device_loop=False), compute_covariance=False,
                   device="cuda") for 5 GN iterations (the host loop; phase
                   17 runs the device loop) at the default
                   precisions; sigma0^2, CG counts, iteration walls, host
                   reads per CG call (one per block of 8 masked iterations
                   and one that stops), and the launch counts K1 = steps,
                   K2 = 2 * steps + the matvecs CG ran
  7. segment       K4 (chunk_prefix) against its plain version at the
                   block's stream length, D in {3, 6, 21, 36} (36: the
                   explicit dense S's pair and IOP sums), float32 and
                   float64: relative norm error <= 1e-5 / 1e-12, bitwise
                   repeatable, median times of kernel, plain version and
                   torch.cumsum, the byte bound and the kernel's multiple
                   of it; sorted_segment_sum on the
                   card against the CPU at the block's tie and image axes
  8. unfused ref   a 12-image float64 block and a 24-image 3-camera float32
                   block solved unfused on the card and on the CPU
  9. unfused main  solve_schur(problem, SchurOptions(cg_maxiter=40,
                   device_loop=False), compute_covariance=False,
                   device="cuda") in float64 (the host loop) for
                   3 GN iterations (depth cut from a converged solve);
                   the K4 launch count against 6 * steps + 2 * matvecs
                   (the matvecs CG ran, masked iterations included), and
                   per width: D = 3 matvecs + 2 * steps, D = 6 matvecs +
                   3 * steps, D = 21 steps
 10. streamseg     K3 (the span segment-sum kernel) at bench_streamseg.py's
                   defaults: sorted_segment_sum_streaming driven once
                   (launch counts), then the kernel against its plain
                   version (relative norm <= 1e-5, bitwise repeatable, the
                   strided and transposed reads bitwise equal) and against
                   segment.sorted_segment_sum (<= 1e-5); kernel, plain and
                   torch.segment_reduce times, the byte bound
 11. probes        every probe of bench_pallas_gather.py (A-F) and
                   bench_pallas_onehot.py (G, S, W, P) at its script's size,
                   each driven once through its twin (launch counts), then
                   against its plain version (gathers bitwise equal, the
                   rest <= 1e-5 relative norm), bitwise repeatable, against
                   the script's numpy reference where the script asserts;
                   kernel, plain and library times, the byte bound and
                   the kernel's multiple of it; for W
                   and P the largest id span of a chunk beside W
 12. unfused img   solve_schur(problem, SchurOptions(dtype=float32,
                   obs_order="img", cg_maxiter=40, device_loop=False),
                   compute_covariance=False,
                   device="cuda") on the bench block for 2 GN iterations:
                   direct tie and image sums, each one launch of the span
                   segment sum (6 * steps + 2 * matvecs) and nothing else,
                   no plain version; the same solve on the CPU (plain
                   versions): sigma0^2 within 1e-4 relative, CG counts
                   within 2 a step, and x no farther from the same solve
                   in float64 (card) than the CPU's x is, within a factor
                   2 in units of X_TOL (the card-vs-CPU distance is
                   printed: two float32 solves of this block drift past
                   X_TOL of each other); then
                   the span segment sum at the solve's shapes (the CG
                   matvec's image sum, D = 6, one image a CTA; its tie
                   sum, D = 3, gathered into tie order) against its plain
                   version, with kernel, plain and index_add_ times
 13. dense CLI     a self-calibrating free-network dataset (synth.write_block,
                   120 images / 700 points, u = 2,820: the largest the CLI's
                   auto gate still sends to the dense solver) through
                   cli.main(folder, plot=False) on the card: rc 0,
                   converged, sigma0^2 in [0.9, 1.1], .out/.rsd/.par
                   written; solve_dense on the card against the CPU (x within
                   rtol=1e-9, atol=1e-7, sigma0^2 within 1e-9 relative, the
                   same iterations); the wall per iteration, peak memory and
                   the device times (CUDA events) of the design assembly,
                   A'PA, the bordered solve and the covariance inverse
 14. explicit S    the default solve_schur(problem) -- float64, the
                   explicit dense S by the auto gate, compute_covariance=
                   True -- on three 12-image blocks (EOPs, a free network,
                   three self-calibrating cameras) on the card and on the
                   CPU (x within rtol=1e-9, atol=1e-7, the same iterations,
                   stds within 1e-9, both "exact"); then the largest block
                   the gate sends to explicit S (600 images / 60,000
                   points, self-calibrating) for 3 GN iterations (depth cut
                   from a converged solve): n_pairs = sum k(k-1)/2, K4
                   launches by width (D = 3: 2 * steps, 6: 3 * steps + 1,
                   18: steps + 1, 36: 3 * steps + 2) and nothing else; S at
                   the solution symmetric, bitwise repeatable, S v against
                   the matrix-free operator within 1e-10, ||S Cc - I|| /
                   sqrt(nc) <= 1e-8; device times of build_dense_S and
                   the CG's S @ v against their bounds; K4 against its
                   plain version (phase 7's checks and times) on the
                   values build_dense_S gives it at the solution: the
                   pair products (D = 36, the pair stream's length), the
                   self-pair image sums (D = 36) and the tie IOP sums
                   (D = 18); the covariance's pieces, its stds and Cc_q
                   bitwise equal to the solve's own; then a 40-image dataset
                   above the dense gate (u = 3,627) through cli.main: auto
                   picks schur, rc 0, sigma0^2 in [0.9, 1.1], numeric stds
 15. stds          compute_stds on the bench block at phase 6's x: exact at
                   max_images=1000 (float64 on the card; its pieces and the
                   GEMMs' rate), the Hutchinson estimate at 999 (64 probes,
                   float32, the fused operator): K1 once, K2 once per CG
                   matvec, no K4 and no plain version; clipped share < 2%,
                   log-correlation with the exact stds > 0.95; the span
                   segment sum at the estimator's image-sum shape
 16. distributed   an NCCL group of the visible cards (this process, at one
                   card) on the bench block: solve_schur_distributed
                   (float64, 3 iterations) and
                   solve_schur_sharded_state(point_mode="sharded") held to
                   phase 9's solve (the same iterations, x within
                   rtol=1e-9, atol=1e-7), solve_schur_fused_sharded
                   (float32, 5 iterations) to phase 6's (rtol=1e-3,
                   atol=2e-3; over several cards that x, at phase 6's CG
                   cut of 40, carries the ranks' order of summation on
                   and lands ~4.4 times that bound away, as it does at
                   as many ranks on one card -- bench_torch_parallel.py
                   order -- so there it is printed, and the bound is held
                   at the solver's default CG depth of 500, both sides
                   run again at it); the host time of one all-reduce of a CG
                   matvec's payload (fused and distributed); each solve's step
                   walls, peak memory, launches (K4 = 6 * steps + 2 *
                   matvecs; K1 = steps, K2 = 2 * steps + matvecs; nothing
                   else, no plain version) and collective calls and bytes
                   by operation; K1 and K2 on each window of the band plan
                   split over 4 (what 4 cards would run) against their
                   plain versions, and summed against the unsharded
                   kernels, with times and bounds; compute_stds(mesh=...)
                   past the gate on a 300-image block (the mesh estimate:
                   float32 unfused probe solves, K4 only) against its exact
                   stds by phase 15's measures; K4 at a 4-card slice
                   (float64) and the stds block's stream (float32).  The
                   three solves run the host loop, then the device loop
                   (each step a replay of a captured graph, the
                   collectives in its IF nodes: NCCL's at one rank, the
                   peer kernels over several cards; device_loop=None,
                   True for fused_sharded), held to their host-loop x
                   (over several cards bitwise, at one rank float64
                   rtol=1e-9, atol=1e-7, float32 rtol=3e-5, atol=3e-4),
                   the same iterations and CG counts, K1/K2 and K4 the
                   warm-up body's plus the CG counts' formula, the peer
                   launches and the Mesh's counts the host loop's plus
                   the warm-up's; over several cards each collective at
                   the solvers' shapes (below) bitwise its plain version,
                   timed against NCCL
 17. device loop   the cost of one device->host read (a 0-d flag, the
                   packed records); phase 6's solve under the device loop
                   (solver/device_loop.py: the step captured as a CUDA
                   graph, its CG blocks and the step itself under IF nodes):
                   the same iterations, accept/reject sequence and CG counts,
                   x within 1e-6 relative (norm) of phase 6's; phase 9's
                   (float64, K4) within rtol=1e-9, atol=1e-7 of phase 9's;
                   each with capture seconds, ms a replay against the host
                   loop's step walls, packed reads, replays after the stop,
                   no CG host read, launches (warm-up + steps x one body:
                   K1 1, K2 2 + 40; K4 6 + 2 * 40), the graph pools' bytes
                   and peak memory; the same solves' eager body on the card
                   (bitwise equal x); then one uncut float32 solve to
                   convergence by bench.py's definition (L1 <= 3e-4 u, at
                   most 60 iterations, 40 CG iterations to 1e-6): the
                   time to a converged solve, sigma0^2 in (0.8, 1.2)
 18. posegraph     solve_posegraph(bench block, n_blocks=4, refine=True) at
                   its default: over several cards a spawned process a card
                   (each process's start-up seconds), at one card the
                   blocks one after the other: block walls (each
                   DenseResult's elapsed_s) and iterations (each
                   converged), edges (>= 3), the stages' host seconds (the
                   merge's ms; the merge run again gives the same poses),
                   the refine's iterations and driver (the
                   device loop), its tie coordinates within 1e-5 and rms
                   within 1e-6 relative of a direct solve; the launch
                   counters after it equal to the blocks' (counted in their
                   processes) + the refine's loop (warm-up + replays) + its
                   stds (run again); over several cards each block's x
                   bitwise, and its launches equal, to the same block
                   solved on cuda:0 in this process; then
                   cli.main(<phase 13's dataset, copied>, solver="posegraph",
                   blocks=2): rc 0, the three reports, sigma0^2 in [0.9, 1.1]
 19. peer coll.    two spawned ranks on cuda:0 over a gloo group (NCCL
                   refuses two ranks on one card), each with its peer
                   communicator (ops/peercoll.py) and a CUDA Mesh on it:
                   phase 16's three solves on the stds block (2, 2 and 3
                   iterations, 40 CG) under both drivers by phase 16's
                   checks, x bitwise between the drivers; then each
                   collective in float64 and float32 at the bench block's
                   shapes on two ranks (the distributed matvec's tie sum,
                   the stats, the fused camera outputs, the Hcc blocks, the
                   sharded pose sums and pose vector, the residual rows and
                   the scattered tie sums; the tie sum and the scattered
                   tie sums of BASELINE configs[5]'s 10k block, 23.5 MB a
                   rank in float64; each one launch):
                   bitwise its plain version and itself, kernel, plain
                   and library times (the gloo group's own collective on
                   the same CUDA tensors, where gloo has one; the two
                   processes time-slice the card: no cross-card time),
                   the bound

 20. tenk          BASELINE configs[5]'s 10k-image block at its full size
                   (bench_tenk.py's make_block: 10,000 images, 1,000,000
                   points, seed 13): its observations (11,105,599) and band
                   plan (W 640, T 1792, G 7802, n_pad 11,106,048) equal to
                   the JAX package's (TENK_r05.json); K1 and K2 in the CG
                   matvec's mode at its shapes by phase 4's checks, times
                   and bounds; then solve_schur(float32, cg_maxiter=40) for
                   TENK_STEPS = 3 GN iterations (depth cut) under the device
                   loop: replay ms, capture seconds, peak memory, launches
                   warm-up + replays (K1 1 + steps, K2 by phase 17's
                   formula), sigma0^2 finite and falling (weighted SSR over
                   n - u at x0 and after)
 21. cli10k        the CLI's default route on phase 20's block, as a user
                   runs it: synth.write_block into a temporary folder with
                   the .cfg's Iteration_Cap cut to CLI10K_CAP = 3 (the only
                   cut: the widths, the 64 probes and the 400-iteration CG
                   budget stay), then cli.main(folder, plot=False) on the
                   card (bench_torch_cli.run_route): "schur" picked, the
                   matrix-free float64 solve under the device loop (K4
                   launches = warm-up + 6 * steps + 2 * matvecs, counted on
                   the card), the Hutchinson stds (3 k + 64 CG solves, K1
                   once, K2 a CG matvec), every std finite and
                   non-negative, .out/.par written and a .rsd row an
                   observation, no plain version called; each stage's wall
                   and peak device memory printed; K4 timed at its float64
                   D = 6 shape on this stream

Each phase prints its own lines; a failing check raises, so the script
exits non-zero.  Without a CUDA card it exits non-zero before printing
any result.  The last three lines: the card's name and power limit, the
kernel table as JSON, then {"ok": true, "device": {...}}.

Bounds in the kernel table (utils/cudatime.bound): the larger of the
bytes of every input and output tensor of the function (for K1 and K2 the
plan's geometry, not the index built for the CUDA kernels) over 3.35 TB/s and
the call's arithmetic over the peak rate of its type -- 67 TFLOP/s
float32 (outside the tensor cores), 34 TFLOP/s float64 (H100 SXM data
sheet) -- counted from the kernels' code per observation row (K1, K2,
K4) or from the function's own arithmetic (phases 10 and 11).  The
table has one entry per kernel of phases 4-9, one per probe of phases
10-11, one for the span segment sum on the solver path (phase 12), K4 on
the explicit S's pair products and tie IOP sums (phase 14), K1, K2
and the span segment sum on the estimator's path (phase 15), and K1, K2
and K4 on the distributed paths (phase 16), K1, K2 and K4 under the
device loop (phase 17: launches are the warm-up's plus those the
replays ran, counted on the card), K1 and K2 at the 10k-image block's
shapes (phase 20: its solve's launches; phase 21: K1 and K2 with the
launches of the CLI's estimate, K4 at the CLI's float64 solve's stream
with its launches), and the three peer
collectives (phase 19's solves' launches,
with phase 16's over several cards; times of phase 16 over several
cards, with NCCL's as the library time, else of phase 19, with gloo's
where it has the op for CUDA tensors and the reason in `library` where
not;
each bound the bytes its output needs, over the memory rate or, across
cards, the peers' share over NVLink at 450 GB/s each way); `replaces`
lists the pallas_call sites each stands for (for the peer collectives,
the JAX package's XLA collectives: no pallas_call).  Phase 13 adds no kernel:
the dense path's products, solve and inverse are torch.matmul and
torch.linalg, as the JAX package leaves them to XLA; so are the explicit
path's S @ v and the covariance's GEMMs and inverse.
"""

import contextlib
import dataclasses
import hashlib
import inspect
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import bench_torch_cli
import bench_torch_fusedmv
import bench_torch_pallas_gather
import bench_torch_pallas_onehot
import bench_torch_streamseg
from fish_eye_bundle_adjustment_tpu_torch.ops import (
    _build, fusedmv, peercoll, prefix, probes, segment, streamseg,
)
from fish_eye_bundle_adjustment_tpu_torch import cli
from fish_eye_bundle_adjustment_tpu_torch.io.problem import load_problem
from fish_eye_bundle_adjustment_tpu_torch.ops.bandplan import build_band_plan
from fish_eye_bundle_adjustment_tpu_torch.solver import (
    covariance, dense, device_loop, explicit, schur,
)
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block, write_block
from fish_eye_bundle_adjustment_tpu_torch.utils import cudatime
from fish_eye_bundle_adjustment_tpu_torch.utils.cudatime import (
    HBM_BYTES_PER_S, Probe, bound, cuda_ms, line, measure, rel_norm,
)
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

SELFCAL = dict(
    estimate_c=True, estimate_xp=True, estimate_yp=True,
    estimate_radial=True, estimate_decent=True,
)
KERNEL_TOL = 1e-5  # both f32; only the summation order differs
# K4 against its plain version: only the order of the additions differs
PREFIX_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
X_TOL = dict(rtol=3e-5, atol=3e-4)
X_TOL_F64 = dict(rtol=1e-9, atol=1e-7)  # tests/test_torch_schur_unfused.py
# phases 10-11: f32 kernels against their plain versions (only the order of
# the additions differs; the gathers must be bitwise equal)
PROBE_TOL = 1e-5
CSRC = "fish_eye_bundle_adjustment_tpu_torch/ops/csrc/"
SOURCES = {
    "fused_hpp_pass": CSRC + "fusedmv.cu",
    "fused_schur_apply": CSRC + "fusedmv.cu",
    "chunk_prefix": CSRC + "prefix.cu",
    "span_segment_sum": CSRC + "streamseg.cu",
    "gather_rows": CSRC + "gather.cu",
    "gather_contract": CSRC + "gather.cu",
    "scatter_rows": CSRC + "scatter.cu",
    "peer_all_reduce": CSRC + "peercoll.cu",
    "peer_reduce_scatter": CSRC + "peercoll.cu",
    "peer_all_gather": CSRC + "peercoll.cu",
}
# the pallas_call each kernel of phases 4-9 stands for
REPLACES = {
    "fused_hpp_pass": "fish_eye_bundle_adjustment_tpu/ops/fusedmv.py:490",
    "fused_schur_apply": "fish_eye_bundle_adjustment_tpu/ops/fusedmv.py:607",
    "chunk_prefix": "fish_eye_bundle_adjustment_tpu/ops/attic/prefix.py:61",
    # no pallas_call: the XLA collectives of the JAX package's parallel
    # solvers that the peer kernels stand for
    "peer_all_reduce": "fish_eye_bundle_adjustment_tpu/parallel/dist_schur.py:105",
    "peer_reduce_scatter": "fish_eye_bundle_adjustment_tpu/parallel/sharded_state.py:233",
    "peer_all_gather": "fish_eye_bundle_adjustment_tpu/parallel/sharded_state.py:326",
}
PEER_OPS = ("all_reduce", "reduce_scatter", "all_gather")
KERNEL_MODS = (fusedmv, prefix, streamseg, probes, peercoll)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()


def phase_environment():
    print(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("[1 env] FAIL: torch.cuda.is_available() is false")
    card = cudatime.card()
    print(f"[1 env] nvidia-smi: {card}")
    print(f"[1 env] nvcc: {_run([_build._nvcc(), '--version']).splitlines()[-1]}")
    print(f"[1 env] device 0: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[2 build] {so.name} in {secs:.2f} s")
    log = (_build.last_build_log or "").splitlines()
    for msg in log:
        if "registers" in msg or "bytes stack" in msg or "Compiling entry" in msg:
            print(f"[2 build] {msg.strip()}")
    # K1 and K2: registers, spills and static shared memory of each kernel
    # (their dynamic shared memory depends on the span: phase 4)
    name = None
    for msg in log:
        found = re.search(r"fusedmv_cu\w*?\d+(hpp_group_kernel|schur_group_kernelILb[01]E|"
                          r"reduce_kernel)", msg)
        if "Compiling entry" in msg:
            name = found and found.group(1).replace("ILb0E", "<false>").replace(
                "ILb1E", "<true> (preconditioner)")
            spill = ""
        elif name and "spill" in msg:
            spill = msg.strip()
        elif name and "registers" in msg:
            print(f"[2 build] fusedmv.cu {name}: {msg.split(':', 1)[1].strip()}; {spill}")
            name = None


def phase_block():
    t0 = time.perf_counter()
    blk = make_block(
        n_img=1000, n_pts=100_000, model="fisheye", seed=2, control_frac=0.01,
        settings_overrides={"inner_constraints": False, **SELFCAL},
    )
    p = blk.problem
    layout = ParamLayout(p)
    opts = schur.SchurOptions(dtype=np.float32, cg_maxiter=40)
    plan = schur.make_band_plan(p, layout, opts)
    if plan is None:
        raise RuntimeError("[3 block] FAIL: no band plan")
    print(f"[3 block] n_obs={p.n_obs} u={layout.u} G={plan.G} T={plan.T} "
          f"W={plan.W} n_pad={plan.n_pad} n_img_pad={plan.n_img_pad} "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    t0 = time.perf_counter()
    fusedmv.BandArrays.from_plan(plan, "cpu")
    print(f"[3 block] BandArrays.from_plan (the kernels' host index) "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms on the host")
    return p, layout, opts, plan


def phase_kernels(p, layout, opts, plan, dev):
    kern = schur.SchurKernel(layout, opts)
    obs = schur.ObsData.from_problem(p, layout, plan, dtype=np.float32, device=dev)
    x0 = torch.as_tensor(layout.initial().astype(np.float32), device=dev)
    fac = kern.linearize(x0 * layout.scale_like(x0), obs,
                         lam=torch.zeros((), device=dev))
    band, ne, ni = obs.band, kern.ne, kern.ni
    rng = np.random.default_rng(0)
    rnd = lambda *s: torch.as_tensor(
        rng.standard_normal(s).astype(np.float32), device=dev)
    inputs = dict(vpose=rnd(8, band.n_img_pad), vi=rnd(128), a_rows=rnd(8, band.n_pad))
    streams = (fac.acam_t, fac.apt_t)
    flops = bench_torch_fusedmv.kernel_flops(p.n_obs, plan.n_tie, ne, ni)
    band_in = bench_torch_fusedmv.band_inputs(band)

    # shared memory and resident CTAs per SM of each group kernel here and at
    # the band plan's caps, with the arguments its wrapper passes (matvec and
    # back-substitution: vpose)
    caps = inspect.signature(build_band_plan).parameters
    _print_smem("4 kernels", band.T, band.M, band.W, ne, "here")
    _print_smem("4 kernels", caps["max_T"].default, caps["M"].default, caps["max_W"].default,
                ne, "at the caps")
    idx_b = bench_torch_fusedmv.index_bytes(band)
    print(f"[4 kernels] the kernels' host index: {idx_b} bytes on the card, read beside "
          f"the function's inputs and not counted in its bound "
          f"({idx_b / HBM_BYTES_PER_S * 1e3:.4f} ms at the bound's memory rate)")

    cases = bench_torch_fusedmv.kernel_cases(fusedmv, band, fac, ne, ni, inputs)
    return {name: _check_fused("4 kernels", name, case, plan, ne, ni, streams + band_in,
                               flops[name])
            for name, case in cases.items()}


def _print_smem(tag, T, M, W, ne, where):
    """Each fused group kernel's dynamic shared memory and resident CTAs
    per SM at (T, M, W), with the arguments its wrapper passes (matvec and
    back-substitution: vpose); fail where one does not fit."""
    lib = _build.load()
    for which, label, smem in (
            (0, "K1 hpp_group_kernel", lib.fusedmv_hpp_smem_bytes(T, M)),
            (1, "K2 schur_group_kernel<false> (matvec, back-substitution)",
             lib.fusedmv_schur_smem_bytes(T, M, W, ne, 1, 0, _build.SMEM_LIMIT)),
            (2, "K2 schur_group_kernel<true> (rhs + preconditioner)",
             lib.fusedmv_schur_smem_bytes(T, M, W, ne, 0, 1, _build.SMEM_LIMIT))):
        occ = lib.fusedmv_occupancy(which, smem)
        print(f"[{tag}] {label} {where}: {smem} bytes of dynamic shared memory "
              f"at T={T}, M={M}, W={W}, ne={ne}, {occ} resident CTAs of 256 threads "
              f"per SM")
        if not (smem <= _build.SMEM_LIMIT and occ >= 1):
            raise RuntimeError(f"[{tag}] FAIL: {label} does not fit {where}")


def _check_fused(tag, name, case, plan, ne, ni, inputs, flops):
    """One K1 or K2 case of bench_torch_fusedmv.kernel_cases against its
    plain version: relative norm error <= KERNEL_TOL on every output the
    solver reads, bitwise repeatable; median times of kernel and plain
    version, the bound (`inputs`: the streams and the plan's arrays, with
    the case's own inputs and outputs), the group kernel's and the
    reduce's device times.  Returns the kernel table's numbers."""
    kind, kernel, plain, extra = case
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"[{tag}] FAIL: {name} is not bitwise repeatable")
    g = bench_torch_fusedmv.glue_reads(got, plan, ne, ni, kind)
    w = bench_torch_fusedmv.glue_reads(want, plan, ne, ni, kind)
    errs = {}
    max_abs = 0.0
    for key in w:
        d = (g[key].double() - w[key].double())
        errs[key] = float(d.norm() / w[key].double().norm().clamp_min(1e-30))
        max_abs = max(max_abs, float(d.abs().max()))
    del want, w, d
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    print(f"[{tag}] {name}: rel err "
          + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + f" max_abs={max_abs:.3e} bitwise-repeatable kernel {ms:.3f} ms"
          f" plain {plain_ms:.3f} ms")
    bad = {k: v for k, v in errs.items() if not v <= KERNEL_TOL}
    if bad:
        raise RuntimeError(f"[{tag}] FAIL: {name} off its plain version: {bad}")
    out = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    out["bound_ms"], out["bound_by"] = bound((*inputs, *extra, *got), flops, torch.float32)
    group, reduce = bench_torch_fusedmv.group_reduce_split(
        bench_torch_fusedmv.split_ms(kernel))
    print(f"[{tag}] {name}: bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}; kernel {ms / out['bound_ms']:.2f}x); "
          f"on the device: group kernel {group:.4f} ms + reduce {reduce:.4f} ms")
    return out


def phase_reference(dev):
    """A small block on the card (kernels) and on the CPU (plain versions)."""
    blk = make_block(n_img=12, n_pts=150, model="fisheye", seed=13,
                     control_frac=0.08,
                     settings_overrides={"inner_constraints": False})
    opts = schur.SchurOptions(dtype=np.float32)
    on_card = schur.solve_schur(blk.problem, opts, compute_covariance=False,
                                device=dev)
    on_cpu = schur.solve_schur(blk.problem, opts, compute_covariance=False,
                               device="cpu")
    diff = np.abs(on_card.x - on_cpu.x)
    viol = float(np.max(diff / (X_TOL["atol"] + X_TOL["rtol"] * np.abs(on_cpu.x))))
    print(f"[5 reference] 12-image block: card {on_card.iterations} it "
          f"sigma0^2={on_card.sigma02:.6f}, cpu {on_cpu.iterations} it "
          f"sigma0^2={on_cpu.sigma02:.6f}, max |dx|={diff.max():.3e} "
          f"(tolerance use {viol:.3f})")
    np.testing.assert_allclose(on_card.x, on_cpu.x, **X_TOL)
    if on_card.iterations != on_cpu.iterations:
        raise RuntimeError("[5 reference] FAIL: iteration counts differ")


def phase_main_path(p, layout, plan, dev):
    problem = dataclasses.replace(
        p, settings=dataclasses.replace(p.settings, iteration_cap=5))
    # the host loop: phase 17 runs the same solve under the device loop
    opts = schur.SchurOptions(dtype=np.float32, cg_maxiter=40, device_loop=False)
    records = []

    def progress(rec):
        records.append(rec)
        print(f"[6 main] iter {rec.iteration}: L1(delta)={rec.delta_l1:.6g} "
              f"lambda={rec.damping or 0.0:.3g} cg_tol={rec.cg_tol:.3g} "
              f"wall={rec.elapsed_s * 1e3:.1f} ms"
              + ("" if rec.accepted else " REJECTED"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fusedmv.reset_counts()
    prefix.reset_counts()
    schur.reset_cg_counts()
    t0 = time.perf_counter()
    res = schur.solve_schur(problem, opts, compute_covariance=False,
                            device=dev, progress_fn=progress)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fusedmv.kernel_launches)
    plain = dict(fusedmv.plain_calls)
    k4 = prefix.kernel_launches["chunk_prefix"] + prefix.plain_calls["chunk_prefix"]
    cgc = dict(schur.cg_counts)

    cg = res.cg_iterations
    kern = schur.SchurKernel(layout, opts)
    print(f"[6 main] precisions: fused_precision={opts.fused_precision} "
          f"CG matvec {kern.mv_precision} (u={layout.u})")
    print(f"[6 main] stopped_on={res.stopped_on} iterations={res.iterations} "
          f"steps={len(cg)} cg per step={cg} sigma0^2={res.sigma02:.6f} "
          f"rms={res.rms:.4f} wall={wall:.2f} s "
          f"peak mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[6 main] launches: K1 fused_hpp_pass={counts['fused_hpp_pass']} "
          f"K2 fused_schur_apply={counts['fused_schur_apply']}; "
          f"plain versions called {plain}")
    if not (np.isfinite(res.x).all() and np.isfinite(res.v).all()
            and np.isfinite(res.sigma02) and np.isfinite(res.delta_history).all()):
        raise RuntimeError("[6 main] FAIL: non-finite result")
    if res.iterations != 5:
        raise RuntimeError(f"[6 main] FAIL: {res.iterations} iterations, expected 5")
    # weighted SSR, true residuals, before and after
    obs = schur.ObsData.from_problem(p, layout, plan, dtype=np.float32, device=dev)

    def cost(x):
        x = torch.as_tensor(x.astype(np.float32), device=dev)
        return float(kern.residual_cost(x * layout.scale_like(x), obs))

    c0, c1 = cost(layout.initial()), cost(res.x)
    print(f"[6 main] weighted SSR {c0:.6g} -> {c1:.6g}")
    if not (np.isfinite(c1) and c1 < c0):
        raise RuntimeError("[6 main] FAIL: the weighted SSR did not fall")
    # one K1 pass per linearization (= GN step, rejected trials included);
    # K2: rhs + preconditioner, one per CG matvec, back-substitution.  CG
    # runs masked blocks of 8 iterations (cg_maxiter = 40 > 16), one host
    # read before each block and one that stops: 8 matvecs per read but the
    # last of each call
    steps = len(cg)
    matvecs = 8 * (cgc["host_reads"] - cgc["calls"])
    print(f"[6 main] CG: {cgc['calls']} calls, {cgc['host_reads']} host reads "
          f"({cgc['host_reads'] / max(cgc['calls'], 1):.2f} per call, at most "
          f"{-(-opts.cg_maxiter // 8) + 1}), {cgc['matvecs']} matvecs run for "
          f"{sum(cg)} iterations taken")
    if not (cgc["calls"] == steps and cgc["matvecs"] == matvecs
            and sum(cg) <= matvecs <= sum(cg) + 8 * steps
            and cgc["host_reads"] <= steps * (-(-opts.cg_maxiter // 8) + 1)):
        raise RuntimeError(f"[6 main] FAIL: CG counts {cgc} for {cg}")
    want_k1, want_k2 = steps, 2 * steps + matvecs
    print(f"[6 main] expected K1 = steps = {want_k1}, "
          f"K2 = 2 * steps + matvecs = {want_k2}")
    if counts != {"fused_hpp_pass": want_k1, "fused_schur_apply": want_k2}:
        raise RuntimeError(f"[6 main] FAIL: launch counts {counts}")
    if any(plain.values()):
        raise RuntimeError("[6 main] FAIL: a plain version ran on the main path")
    if k4:
        raise RuntimeError(f"[6 main] FAIL: the fused path ran the chunk prefix {k4} times")
    res.progress = records
    return counts, res


def _k4_check(tag, name, vals):
    """K4 on `vals` (N, D), N whole chunks, against its plain version:
    relative norm error of the local prefix and of the chunk totals
    within PREFIX_TOL, bitwise repeatable; median times of the kernel,
    the plain version and torch.cumsum on the same input, the bound."""
    n, d = vals.shape
    got, tot = prefix.chunk_prefix(vals)
    again, _ = prefix.chunk_prefix(vals)
    want, want_tot = prefix.chunk_prefix_ref(vals)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise RuntimeError(f"[{tag}] FAIL: K4 {name} is not bitwise repeatable")
    diff = (got - want).double()
    rel = float(diff.norm() / want.double().norm())
    rel_tot = float((tot - want_tot).double().norm() / want_tot.double().norm())
    max_abs = float(diff.abs().max())
    del got, again, want, diff
    ms = cuda_ms(lambda: prefix.chunk_prefix(vals))
    plain_ms = cuda_ms(lambda: prefix.chunk_prefix_ref(vals))
    library_ms = cuda_ms(lambda: torch.cumsum(vals.view(-1, prefix.CHUNK, d), dim=1))
    bound_ms, bound_by = bound((vals, vals), vals.numel(), vals.dtype)
    print(f"[{tag}] K4 {name}: N={n} D={d} {str(vals.dtype).split('.')[-1]} rel err {rel:.2e} "
          f"(totals {rel_tot:.2e}) max_abs={max_abs:.3e} bitwise-repeatable kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms torch.cumsum {library_ms:.4f} ms "
          f"bound {bound_ms:.4f} ms ({bound_by}; kernel {ms / bound_ms:.2f}x)")
    if not (rel <= PREFIX_TOL[vals.dtype] and rel_tot <= PREFIX_TOL[vals.dtype]):
        raise RuntimeError(f"[{tag}] FAIL: K4 {name} off its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_segment(p, layout, dev):
    """K4 at the block's stream length, then sorted_segment_sum on the
    card against the CPU along the block's tie and image axes."""
    n = -(-p.n_obs // prefix.CHUNK) * prefix.CHUNK
    rng = np.random.default_rng(1)
    results = {}
    for dtype in (torch.float32, torch.float64):
        for d in (3, 6, 21, 36):
            vals = torch.as_tensor(rng.standard_normal((n, d)), dtype=dtype, device=dev)
            name = f"{str(dtype).split('.')[-1]} D={d}"
            results[name] = _k4_check("7 segment", name, vals)
    order = schur.ObsData.sort_order_by_tie(p, layout)
    tie = p.target_tie_slot[p.obs_pt]
    tie = np.where(tie >= 0, tie, layout.n_tie)[order]
    img = p.obs_img[order]
    plans = {where: segment.DualAxisPlan.build(tie, layout.n_tie + 1, img, layout.n_img,
                                               device=where)
             for where in ("cpu", dev)}
    for axis, d in (("primary", 3), ("secondary", 6)):
        vals = torch.as_tensor(rng.standard_normal((p.n_obs, d)))
        sums = {where: getattr(plan, f"{axis}_sum")(vals.to(where)).cpu()
                for where, plan in plans.items()}
        scale = getattr(plans["cpu"], f"{axis}_sum")(vals.abs())
        rel = float((sums[dev] - sums["cpu"]).norm() / scale.norm())
        print(f"[7 segment] sorted_segment_sum {axis} axis (D={d}, float64), card vs "
              f"CPU: error / norm of the sums of |vals| = {rel:.2e}")
        if not rel <= 1e-12:
            raise RuntimeError(f"[7 segment] FAIL: the {axis} segment sum differs on the card")
    return results


def phase_unfused_reference(dev):
    """Small unfused solves on the card (K4) and on the CPU (plain)."""
    cases = {
        "12-image float64": (
            dict(n_img=12, n_pts=150, seed=13, control_frac=0.08,
                 settings_overrides={"inner_constraints": False}),
            schur.SchurOptions(explicit_s=False), X_TOL_F64),
        "24-image 3-camera float32": (
            dict(n_img=24, n_pts=300, n_cams=3, seed=41, control_frac=0.05,
                 settings_overrides={"inner_constraints": False, "estimate_c": True,
                                     "estimate_xp": True, "estimate_yp": True}),
            schur.SchurOptions(dtype=np.float32, explicit_s=False), X_TOL),
    }
    for name, (kw, opts, tol) in cases.items():
        blk = make_block(model="fisheye", **kw)
        on_card = schur.solve_schur(blk.problem, opts, compute_covariance=False, device=dev)
        on_cpu = schur.solve_schur(blk.problem, opts, compute_covariance=False, device="cpu")
        diff = np.abs(on_card.x - on_cpu.x)
        viol = float(np.max(diff / (tol["atol"] + tol["rtol"] * np.abs(on_cpu.x))))
        print(f"[8 unfused ref] {name}: card {on_card.iterations} it "
              f"({on_card.stopped_on}) sigma0^2={on_card.sigma02:.9f}, cpu "
              f"{on_cpu.iterations} it sigma0^2={on_cpu.sigma02:.9f}, max |dx|="
              f"{diff.max():.3e} (tolerance use {viol:.3f}); cg card "
              f"{on_card.cg_iterations} cpu {on_cpu.cg_iterations}")
        np.testing.assert_allclose(on_card.x, on_cpu.x, **tol)
        if on_card.iterations != on_cpu.iterations:
            raise RuntimeError(f"[8 unfused ref] FAIL: {name}: iteration counts differ")


def phase_unfused_main_path(p, layout, dev):
    problem = dataclasses.replace(
        p, settings=dataclasses.replace(p.settings, iteration_cap=3))
    # float64, explicit_s=None; the host loop (phase 17 runs the device loop)
    opts = schur.SchurOptions(cg_maxiter=40, device_loop=False)
    if problem.n_img <= opts.explicit_s_max_images:
        raise RuntimeError("[9 unfused] FAIL: the explicit-S gate would be on")
    records = []

    def progress(rec):
        records.append(rec)
        print(f"[9 unfused] iter {rec.iteration}: L1(delta)={rec.delta_l1:.9g} "
              f"lambda={rec.damping or 0.0:.3g} cg_tol={rec.cg_tol:.3g} "
              f"wall={rec.elapsed_s * 1e3:.1f} ms"
              + ("" if rec.accepted else " REJECTED"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fusedmv.reset_counts()
    prefix.reset_counts()
    schur.reset_cg_counts()
    t0 = time.perf_counter()
    res = schur.solve_schur(problem, opts, compute_covariance=False,
                            device=dev, progress_fn=progress)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4 = prefix.kernel_launches["chunk_prefix"]
    cgc = dict(schur.cg_counts)
    by_width = dict(sorted(prefix.kernel_launches_by_width.items()))
    plain = prefix.plain_calls["chunk_prefix"]
    fused = sum(fusedmv.kernel_launches.values()) + sum(fusedmv.plain_calls.values())

    cg = res.cg_iterations
    print(f"[9 unfused] float64 stopped_on={res.stopped_on} iterations={res.iterations} "
          f"steps={len(cg)} cg per step={cg} sigma0^2={res.sigma02:.9f} "
          f"rms={res.rms:.6f} wall={wall:.2f} s "
          f"peak mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # the matvecs CG ran: masked blocks of 8 (cg_maxiter = 40), one host
    # read before each block and one that stops
    mv = 8 * (cgc["host_reads"] - cgc["calls"])
    print(f"[9 unfused] CG: {cgc['calls']} calls, {cgc['host_reads']} host reads, "
          f"{cgc['matvecs']} matvecs run for {sum(cg)} iterations taken")
    if not (cgc["calls"] == len(cg) and cgc["matvecs"] == mv
            and sum(cg) <= mv <= sum(cg) + 8 * len(cg)):
        raise RuntimeError(f"[9 unfused] FAIL: CG counts {cgc} for {cg}")
    want = 6 * len(cg) + 2 * mv
    # D = 3: the tie sums of each matvec, the reduced rhs and back-substitution;
    # D = 6: the image sums of each matvec, the rhs and linearize's two; D = 21:
    # the pose preconditioner
    want_width = {3: mv + 2 * len(cg), 6: mv + 3 * len(cg), 21: len(cg)}
    print(f"[9 unfused] launches: K4 chunk_prefix={k4}, expected 6 * steps + "
          f"2 * matvecs = {want} (linearize 2, reduced rhs 2, pose preconditioner "
          f"1, back-substitution 1, 2 per CG matvec); by width D: {by_width}, "
          f"expected {want_width}; plain versions called {plain}; fused kernels {fused}")
    if not (np.isfinite(res.x).all() and np.isfinite(res.v).all()
            and np.isfinite(res.sigma02) and np.isfinite(res.delta_history).all()):
        raise RuntimeError("[9 unfused] FAIL: non-finite result")
    if res.iterations != 3:
        raise RuntimeError(f"[9 unfused] FAIL: {res.iterations} iterations, expected 3")
    if k4 != want or by_width != want_width or plain or fused:
        raise RuntimeError(f"[9 unfused] FAIL: launch counts K4 {k4} ({by_width}), "
                           f"plain {plain}, fused {fused}")
    kern = schur.SchurKernel(layout, opts)
    obs = schur.ObsData.from_problem(p, layout, dtype=np.float64, device=dev)

    def cost(x):
        x = torch.as_tensor(x, device=dev)
        return float(kern.residual_cost(x * layout.scale_like(x), obs))

    c0, c1 = cost(layout.initial()), cost(res.x)
    print(f"[9 unfused] weighted SSR {c0:.9g} -> {c1:.9g}")
    if not (np.isfinite(c1) and c1 < c0):
        raise RuntimeError("[9 unfused] FAIL: the weighted SSR did not fall")
    res.progress = records
    return {"chunk_prefix": k4}, res


def _reset_counts():
    for mod in KERNEL_MODS:
        mod.reset_counts()


def _read_counts():
    """(kernel launches by wrapper, the sum of the plain versions' calls)."""
    launches = {k: v for mod in KERNEL_MODS for k, v in mod.kernel_launches.items()}
    return launches, sum(sum(mod.plain_calls.values()) for mod in KERNEL_MODS)


def _body_launches(moves):
    """The kernel launches in device_loop.loop_counts' per_body or warmup
    moves, by kernel."""
    return {k: v for mod in ("fusedmv", "prefix", "streamseg", "probes", "peercoll")
            for k, v in moves.get(mod, {}).items() if v}


def _kernels(replayed):
    """device_loop.loop_counts["replayed"] by kernel (its other keys are
    K4's widths and a mesh's "calls" and "bytes")."""
    names = {k for mod in KERNEL_MODS for k in mod.kernel_launches}
    return {k: v for k, v in replayed.items() if k in names}


def _split_peer(launches):
    """(the launches of every kernel but the peer collectives, theirs)."""
    return ({k: v for k, v in launches.items() if not k.startswith("peer_")},
            {k: v for k, v in launches.items() if k.startswith("peer_")})


def _loop_launches(fused, cg, maxiter):
    """The launches a device-loop solve's replays must run, from its CG
    counts: per step K1 once and K2 twice (fused) or K4 six times
    (unfused), and one K2 or two K4 a CG matvec run (schur.cg_matvecs:
    the IF nodes skip the CG blocks past CG's stop)."""
    steps, mv = len(cg), sum(schur.cg_matvecs(c, maxiter) for c in cg)
    if fused:
        return {"fused_hpp_pass": steps, "fused_schur_apply": 2 * steps + mv}
    return {"chunk_prefix": 6 * steps + 2 * mv}


def _drive(tag, run, want):
    """Run one probe's path with every count set to 0 just before it; fail
    unless exactly the kernels `want` launched and no plain version ran.
    Returns the launch counts of the run."""
    torch.cuda.synchronize()
    _reset_counts()
    out = run()
    torch.cuda.synchronize()
    launches, plain = _read_counts()
    ran = {k: v for k, v in launches.items() if v}
    print(f"[{tag}] launches {ran}; plain versions called {plain}")
    if set(ran) != set(want) or plain:
        raise RuntimeError(f"[{tag}] FAIL: launches {ran} and {plain} plain calls, "
                           f"expected {sorted(want)} only")
    return out, ran


def phase_streamseg(dev):
    """K3 at bench_streamseg.py's defaults, through its twin."""
    t0 = time.perf_counter()
    probe, x, layout, plan = bench_torch_streamseg.make_probe(dev)
    print(f"[10 streamseg] N={x.shape[0]} n_seg={plan.n_seg} D={x.shape[1]} M={plan.M}: "
          f"G={plan.G} T={plan.T} ({time.perf_counter() - t0:.1f} s on the host)")
    driven, ran = _drive("10 streamseg",
                         lambda: streamseg.sorted_segment_sum_streaming(x, plan),
                         {"span_segment_sum"})
    r = measure(probe, PROBE_TOL)
    r["launches"] = ran["span_segment_sum"]
    # the (N, D) stream read through its strides against the (D, N) copy
    if not torch.equal(driven, probe.call().T):
        raise RuntimeError("[10 streamseg] FAIL: the strided and transposed reads differ")
    err_k4 = rel_norm(driven, segment.sorted_segment_sum(x, layout))
    print(f"[10 streamseg] {line(probe, r)}; bitwise repeatable, the strided read "
          f"bitwise equal; vs segment.sorted_segment_sum (K4) {err_k4:.2e}")
    if not err_k4 <= PROBE_TOL:
        raise RuntimeError(f"[10 streamseg] FAIL: K3 off sorted_segment_sum by {err_k4:.3e}")
    return [(probe, r)]


def phase_probes(dev):
    """Every probe of the two Pallas probe scripts, through their twins."""
    t0 = time.perf_counter()
    found = bench_torch_pallas_gather.make_probes(dev, "ABCDEF")
    onehot, spans = bench_torch_pallas_onehot.make_probes(dev, "GSWP")
    found += onehot
    print(f"[11 probes] inputs of probes {''.join(p.name for p in found)} at N="
          f"{bench_torch_pallas_gather.N} ({time.perf_counter() - t0:.1f} s on the host)")
    results = []
    for p in found:
        kernels = {p.kernel} | ({"chunk_prefix"} if p.name == "W" else set())
        if p.name in spans:
            print(f"[11 probes] {p.name}: max ids/chunk span = {spans[p.name]}, "
                  f"W = {bench_torch_pallas_onehot.W}")
        _, ran = _drive(f"11 probes {p.name}", p.result, kernels)
        r = measure(p, PROBE_TOL)
        r["launches"] = ran[p.kernel]
        print(f"[11 probes] {line(p, r)}; bitwise repeatable")
        results.append((p, r))
    return results


def _solver_sum_probe(name, vals, ids, plan, dev):
    """The span segment sum at one of the solver's shapes: vals (N, D)
    float32 on the card in the plan's sorted order, ids (N,) its segment
    ids."""
    arrays = plan.on(dev)
    ids_t = torch.as_tensor(ids, device=dev)
    n_seg, d = plan.n_seg, vals.shape[1]
    ref = np.zeros((n_seg, d))
    np.add.at(ref, ids, vals.double().cpu().numpy())
    return Probe(
        name=name, kernel="span_segment_sum", replaces=bench_torch_streamseg.REPLACES,
        call=lambda: streamseg.sorted_segment_sum_streaming(vals, plan),
        plain=lambda: streamseg.streaming_segment_sum_t_ref(vals.T, plan).T,
        library=lambda: vals.new_zeros((n_seg, d)).index_add_(0, ids_t, vals),
        inputs=(vals, arrays.rel[: plan.n_rows], arrays.first_row, arrays.end_row),
        flops=float(vals.numel()), exact=False, ref=ref, ref_err="rel_ref")


def phase_unfused_img(p, layout, dev):
    """The unfused float32 path at obs_order="img" on the bench block."""
    problem = dataclasses.replace(
        p, settings=dataclasses.replace(p.settings, iteration_cap=2))
    opts = schur.SchurOptions(dtype=np.float32, obs_order="img", cg_maxiter=40,
                              device_loop=False)
    if (schur.make_band_plan(p, layout, opts) is not None
            or schur.make_pair_plan(p, layout, opts) is not None):
        raise RuntimeError("[12 unfused img] FAIL: not the matrix-free unfused path")

    def progress(rec):
        print(f"[12 unfused img] iter {rec.iteration}: L1(delta)={rec.delta_l1:.6g} "
              f"lambda={rec.damping or 0.0:.3g} cg_tol={rec.cg_tol:.3g} "
              f"wall={rec.elapsed_s * 1e3:.1f} ms" + ("" if rec.accepted else " REJECTED"))

    def solve():
        return schur.solve_schur(problem, opts, compute_covariance=False, device=dev,
                                 progress_fn=progress)

    torch.cuda.reset_peak_memory_stats()
    schur.reset_cg_counts()
    t0 = time.perf_counter()
    res, ran = _drive("12 unfused img", solve, {"span_segment_sum"})
    wall = time.perf_counter() - t0
    cgc = dict(schur.cg_counts)
    cg = res.cg_iterations
    mv = 8 * (cgc["host_reads"] - cgc["calls"])
    want = 6 * len(cg) + 2 * mv
    print(f"[12 unfused img] float32 obs_order=img stopped_on={res.stopped_on} "
          f"iterations={res.iterations} steps={len(cg)} cg per step={cg} "
          f"sigma0^2={res.sigma02:.6f} wall={wall:.2f} s peak mem="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; CG {cgc}")
    print(f"[12 unfused img] span segment sum launches {ran['span_segment_sum']}, expected "
          f"6 * steps + 2 * matvecs = {want} (per step: linearize's tie and image "
          f"sums, the reduced rhs's two, the pose preconditioner, the "
          f"back-substitution; per CG matvec: one tie and one image sum)")
    if not (np.isfinite(res.x).all() and np.isfinite(res.sigma02)):
        raise RuntimeError("[12 unfused img] FAIL: non-finite result")
    if res.iterations != 2 or ran["span_segment_sum"] != want or cgc["matvecs"] != mv:
        raise RuntimeError(f"[12 unfused img] FAIL: {res.iterations} iterations, "
                           f"launches {ran}, CG {cgc}")
    t0 = time.perf_counter()
    on_cpu = schur.solve_schur(problem, opts, compute_covariance=False, device="cpu")
    cpu_s = time.perf_counter() - t0
    # the same solve in float64 on the card: the yardstick both float32
    # solves are held to (two float32 solves of this block at 40 CG
    # iterations a step are not held to X_TOL of each other: each CG
    # amplifies its own summation order's rounding)
    f64 = schur.solve_schur(problem, dataclasses.replace(opts, dtype=np.float64),
                            compute_covariance=False, device=dev)

    def use(x, ref):
        """max |x - ref| in units of X_TOL at ref; the share of entries past 1"""
        u = np.abs(x - ref) / (X_TOL["atol"] + X_TOL["rtol"] * np.abs(ref))
        return float(u.max()), float(np.mean(u > 1))

    (card_cpu, share), (card_64, _), (cpu_64, _) = (
        use(res.x, on_cpu.x), use(res.x, f64.x), use(on_cpu.x, f64.x))
    print(f"[12 unfused img] cpu (plain versions, {cpu_s:.1f} s): {on_cpu.iterations} it "
          f"sigma0^2={on_cpu.sigma02:.6f} cg {on_cpu.cg_iterations}; float64 on the card: "
          f"sigma0^2={f64.sigma02:.6f} cg {f64.cg_iterations}")
    print(f"[12 unfused img] x in units of X_TOL (rtol=3e-5, atol=3e-4): card vs cpu "
          f"{card_cpu:.3f} ({share:.3%} of entries past 1); from the float64 solve: card "
          f"{card_64:.3f}, cpu {cpu_64:.3f}")
    if not (card_64 <= 2 * cpu_64 and on_cpu.iterations == res.iterations
            and abs(res.sigma02 - on_cpu.sigma02) <= 1e-4 * on_cpu.sigma02
            and len(cg) == len(on_cpu.cg_iterations)
            and all(abs(a - b) <= 2 for a, b in zip(cg, on_cpu.cg_iterations))):
        raise RuntimeError("[12 unfused img] FAIL: the card's solve differs from the CPU's")

    # the kernel at the solve's shapes, on the stream's own plans
    obs = schur.ObsData.from_problem(p, layout, dtype=np.float32, device=dev, obs_order="img")
    n = obs.W.shape[0]
    rng = np.random.default_rng(2)
    img = obs.img.cpu().numpy()
    img = img[obs.by_img.perm.cpu().numpy()] if obs.by_img.perm is not None else img
    tie = obs.tie.cpu().numpy()[obs.by_tie.perm.cpu().numpy()]
    probes = []
    for name, d, ids, direct in (("solver img", 6, img, obs.by_img),
                                 ("solver tie", 3, tie, obs.by_tie)):
        vals = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=dev)
        if direct.perm is not None:  # as DirectPlan.sum gathers
            print(f"[12 unfused img] {name}: its gather into tie order "
                  f"{cuda_ms(lambda: vals[direct.perm]):.4f} ms, then:")
            vals = vals[direct.perm]
        rows = direct.plan.n_rows  # the rows of padding and of the dummy tie follow
        pr = _solver_sum_probe(name, vals[:rows], ids[:rows], direct.plan, dev)
        r = measure(pr, PROBE_TOL)
        print(f"[12 unfused img] M={direct.plan.M} G={direct.plan.G} N={n} strides "
              f"{tuple(vals.stride())}: {line(pr, r)}")
        probes.append((pr, r))
    probes[0][1]["launches"] = ran["span_segment_sum"]
    return probes[0]


def _dense_problem(folder):
    """The dense CLI's dataset: self-calibrating (c, xp, yp, k1, p1, p2),
    free network, written by synth.write_block into `folder`."""
    blk = make_block(n_img=120, n_pts=700, model="fisheye", seed=3, control_frac=0.0,
                     settings_overrides={"inner_constraints": True, **SELFCAL,
                                         "num_radial_distortions": 1})
    shutil.rmtree(folder, ignore_errors=True)
    write_block(blk, folder)
    return load_problem(folder)


def phase_dense_cli(dev, card):
    folder = Path("chiprun_out") / "smoke_dense_cli" / "ds"
    problem = _dense_problem(folder)
    layout = ParamLayout(problem)
    picked = cli.pick_solver(problem)
    print(f"[13 dense cli] {problem.n_img} images, {problem.n_obs} image points, "
          f"u={layout.u}, A {2 * problem.n_obs} x {layout.u} float64 "
          f"({2 * problem.n_obs * layout.u * 8 / 1e6:.0f} MB); auto picks {picked}")
    if not (2500 < layout.u <= 3000 and picked == "dense"):
        raise RuntimeError("[13 dense cli] FAIL: not the dense gate's largest block")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(folder, plot=False)
    wall = time.perf_counter() - t0
    text = out.getvalue()
    stem = folder.name
    written = [folder / f"{stem}.{ext}" for ext in ("out", "rsd", "par")]
    found = re.search(r"A-Posteriori\.+([-\d.eE+]+)", written[0].read_text()) if written[0].exists() else None
    sigma02 = float(found.group(1)) if found else float("nan")
    print(f"[13 dense cli] cli.main on the card: rc {rc} in {wall:.2f} s, "
          f"{text.count('Iteration ')} iterations, sigma0^2 {sigma02:.6f}, "
          f"wrote {[w.name for w in written if w.exists()]}")
    if rc != 0 or "Iteration Cap reached" in text or not all(w.exists() for w in written):
        raise RuntimeError(f"[13 dense cli] FAIL: cli.main: rc {rc}\n{text}")
    if not 0.9 <= sigma02 <= 1.1:
        raise RuntimeError(f"[13 dense cli] FAIL: sigma0^2 {sigma02} outside [0.9, 1.1]")

    steps = []
    step = dense.DenseSystem.step

    def counted(self, x, lam):
        steps.append(lam)
        return step(self, x, lam)

    dense.DenseSystem.step = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        on_card = dense.solve_dense(problem, device=dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        dense.DenseSystem.step = step
    t0 = time.perf_counter()
    on_cpu = dense.solve_dense(problem, device="cpu")
    cpu_s = time.perf_counter() - t0
    diff = np.abs(on_card.x - on_cpu.x)
    viol = float(np.max(diff / (X_TOL_F64["atol"] + X_TOL_F64["rtol"] * np.abs(on_cpu.x))))
    print(f"[13 dense cli] solve_dense card: {on_card.iterations} iterations "
          f"({len(steps)} steps, converged {on_card.converged}) in {on_card.elapsed_s:.3f} s, "
          f"{on_card.elapsed_s / len(steps) * 1e3:.1f} ms a step, sigma0^2 "
          f"{on_card.sigma02:.9f}, peak mem {peak / 2**30:.3f} GiB; cpu {on_cpu.iterations} "
          f"iterations in {cpu_s:.1f} s, sigma0^2 {on_cpu.sigma02:.9f}; max |dx| "
          f"{diff.max():.3e} (tolerance use {viol:.3f}) [{card}]")
    np.testing.assert_allclose(on_card.x, on_cpu.x, **X_TOL_F64)
    if not (on_card.converged and on_card.iterations == on_cpu.iterations
            and abs(on_card.sigma02 - on_cpu.sigma02) <= 1e-9 * on_cpu.sigma02):
        raise RuntimeError("[13 dense cli] FAIL: the card's dense solve differs from the CPU's")

    # one iteration's pieces at the solution, device times from CUDA events
    system = dense.DenseSystem(problem, layout, dev)
    x = torch.as_tensor(on_card.x, device=dev)
    q, A, w = system.design(x)
    N, uvec = system.normal(A, w)
    K = system.bordered(q, N)
    times = {
        "design assembly (Jacobians + placement)": cuda_ms(lambda: system.design(x), reps=5),
        "A'PA and A'Pw": cuda_ms(lambda: system.normal(A, w), reps=5),
        "bordered solve": cuda_ms(lambda: system.delta(q, N, uvec), reps=5),
        "covariance inverse (bordered)": cuda_ms(lambda: torch.linalg.inv(K), reps=5),
    }
    print("[13 dense cli] device ms: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f" [{card}]")


def _timed_solve(tag, problem, opts, dev, **kw):
    """solve_schur on the card with every count set to 0 just before it:
    (result, wall s, peak GiB, K4 launches by width, other kernels'
    launches, plain calls)."""
    def progress(rec):
        print(f"[{tag}] iter {rec.iteration}: L1(delta)={rec.delta_l1:.9g} "
              f"lambda={rec.damping or 0.0:.3g} cg_tol={rec.cg_tol:.3g} "
              f"wall={rec.elapsed_s * 1e3:.1f} ms" + ("" if rec.accepted else " REJECTED"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    schur.reset_cg_counts()
    t0 = time.perf_counter()
    res = schur.solve_schur(problem, opts, device=dev, progress_fn=progress, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = _read_counts()
    by_width = dict(sorted(prefix.kernel_launches_by_width.items()))
    others = {k: v for k, v in launches.items() if v and k != "chunk_prefix"}
    return res, wall, torch.cuda.max_memory_allocated() / 2**30, by_width, others, plain


def _small_blocks():
    """phase 14's reference blocks: EOPs only, a free network, three
    self-calibrating cameras (12 images each)."""
    return {
        "12-image EOP": dict(n_img=12, n_pts=150, seed=13, control_frac=0.08,
                             settings_overrides={"inner_constraints": False}),
        "12-image free network": dict(n_img=12, n_pts=150, seed=5, control_frac=0.0,
                                      settings_overrides={"inner_constraints": True}),
        "12-image 3-camera self-calibrating": dict(
            n_img=12, n_pts=150, n_cams=3, seed=41, control_frac=0.08,
            settings_overrides={"inner_constraints": False, **SELFCAL}),
    }


def phase_explicit(dev, card):
    """The default solve_schur (explicit dense S, exact stds): small
    blocks against the CPU, the 600-image block at full width, the CLI."""
    # -- 1. reference: the default options on the card and on the CPU
    for name, kw in _small_blocks().items():
        problem = make_block(model="fisheye", **kw).problem
        on_card = schur.solve_schur(problem, device=dev)
        on_cpu = schur.solve_schur(problem, device="cpu")
        diff = np.abs(on_card.x - on_cpu.x)
        viol = float(np.max(diff / (X_TOL_F64["atol"] + X_TOL_F64["rtol"] * np.abs(on_cpu.x))))
        std_rel = float(np.max(np.abs(on_card.std - on_cpu.std) / on_cpu.std))
        print(f"[14 explicit ref] {name}: card {on_card.iterations} it ({on_card.stopped_on}) "
              f"sigma0^2={on_card.sigma02:.9f}, cpu {on_cpu.iterations} it "
              f"sigma0^2={on_cpu.sigma02:.9f}; x tolerance use {viol:.3g}; std rel "
              f"{std_rel:.2e}; methods {on_card.std_method}/{on_cpu.std_method}")
        np.testing.assert_allclose(on_card.x, on_cpu.x, **X_TOL_F64)
        if not (on_card.iterations == on_cpu.iterations and std_rel <= 1e-9
                and on_card.std_method == on_cpu.std_method == "exact"):
            raise RuntimeError(f"[14 explicit ref] FAIL: {name}: the card differs from the CPU")

    # -- 2. full width: the largest block the auto gate sends to explicit S
    t0 = time.perf_counter()
    blk = make_block(n_img=600, n_pts=60_000, model="fisheye", seed=2, control_frac=0.01,
                     settings_overrides={"inner_constraints": False, **SELFCAL})
    p = blk.problem
    layout = ParamLayout(p)
    opts = schur.SchurOptions(cg_maxiter=40)  # float64, explicit_s=None
    print(f"[14 explicit] block: n_obs={p.n_obs} n_tie={layout.n_tie} u={layout.u} "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    if schur.make_band_plan(p, layout, opts) is not None or p.n_img > opts.explicit_s_max_images:
        raise RuntimeError("[14 explicit] FAIL: the auto gate would not pick explicit S")
    t0 = time.perf_counter()
    pairs = schur.make_pair_plan(p, layout, opts, dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    kern = schur.SchurKernel(layout, opts)
    nc, ne = kern.nc, kern.ne
    tie = p.target_tie_slot[p.obs_pt]
    k = np.bincount(tie[tie >= 0], minlength=layout.n_tie)
    want_pairs = int((k * (k - 1) // 2).sum())
    stream_b = (pairs.pa.numel() * (8 + 8) + pairs.pa.numel() * ne * ne * 8 * 2
                + 2 * pairs.pa.numel() * ne * 3 * 8)
    print(f"[14 explicit] PairPlan: {pairs.n_pairs} pairs (sum k(k-1)/2 = {want_pairs}), "
          f"padded to {pairs.pa.numel()}, {plan_s:.2f} s on the host; the pair stream on "
          f"the card: indices, two (P, {ne}, 3) gathers, the (P, {ne * ne}) products and "
          f"their K4 prefix = {stream_b / 1e6:.0f} MB (float64)")
    if pairs.n_pairs != want_pairs:
        raise RuntimeError("[14 explicit] FAIL: n_pairs != sum k(k-1)/2")

    problem = dataclasses.replace(p, settings=dataclasses.replace(p.settings, iteration_cap=3))
    res, wall, peak, by_width, others, plain = _timed_solve(
        "14 explicit", problem, opts, dev, compute_covariance=True)
    steps = len(res.cg_iterations)
    # per step: linearize (tie Hpp D=6, image diag(Hcc) D=6), the reduced
    # rhs (tie D=3, image D=6), back-substitution (tie D=3), build_dense_S
    # (self pairs, cross pairs, pose-IOP blocks: D=36; tie IOP sums: D=18);
    # the covariance once: linearize (D=6), Hcc ee and ei (D=36), the
    # (tie, camera) IOP sums (D=18).  CG's S @ v is a GEMV: no K4.
    ni = kern.ni
    want_width = {3: 2 * steps, 6: 3 * steps + 1, ni * 3: steps + 1, ne * ne: 3 * steps + 2}
    print(f"[14 explicit] default SchurOptions(cg_maxiter=40), compute_covariance=True: "
          f"{res.iterations} iterations ({res.stopped_on}), {steps} steps, cg {res.cg_iterations}, "
          f"sigma0^2={res.sigma02:.9f}, std {res.std_method}, wall {wall:.2f} s, peak mem "
          f"{peak:.2f} GiB [{card}]")
    print(f"[14 explicit] K4 launches by width {by_width}, expected {want_width}; other "
          f"kernels {others}; plain versions called {plain}")
    if not (res.iterations == 3 and np.isfinite(res.x).all() and np.isfinite(res.sigma02)):
        raise RuntimeError("[14 explicit] FAIL: not 3 finite iterations")
    if by_width != want_width or others or plain:
        raise RuntimeError("[14 explicit] FAIL: launch counts")
    if not (res.std_method == "exact" and np.isfinite(res.std).all() and (res.std > 0).all()):
        raise RuntimeError("[14 explicit] FAIL: stds not finite and positive")

    # S at the solution against the matrix-free operator, S Cc = I
    obs = schur.ObsData.from_problem(p, layout, dtype=np.float64, device=dev)
    x = torch.as_tensor(res.x, device=dev)
    fac = kern.linearize(x * layout.scale_like(x), obs)
    S = explicit.build_dense_S(fac, pairs)
    S2 = explicit.build_dense_S(fac, pairs)
    torch.cuda.synchronize()
    if not torch.equal(S, S2):
        raise RuntimeError("[14 explicit] FAIL: build_dense_S is not bitwise repeatable")
    del S2
    asym = float((S - S.T).norm() / S.norm())
    rng = np.random.default_rng(4)
    mv_err = []
    for _ in range(3):
        v = torch.as_tensor(rng.standard_normal(nc), device=dev)
        mv_err.append(rel_norm(S @ v, fac.schur_matvec(v)))
    Cc = torch.as_tensor(res.Cc_q, device=dev)
    inv_err = float((S @ Cc - torch.eye(nc, dtype=S.dtype, device=dev)).norm()) / nc ** 0.5
    del Cc
    print(f"[14 explicit] S ({nc} x {nc}) at the solution: ||S - S'|| / ||S|| = {asym:.2e}; "
          f"S v against the matrix-free schur_matvec {max(mv_err):.2e} (3 seeded v); "
          f"||S Cc - I||_F / sqrt(nc) = {inv_err:.2e}; bitwise repeatable")
    if not (asym <= 1e-12 and max(mv_err) <= 1e-10 and inv_err <= 1e-8):
        raise RuntimeError("[14 explicit] FAIL: S disagrees with the operator or Cc")

    # device times of the explicit step's pieces (CUDA events)
    inputs = (fac.Jex, fac.Jey, fac.Jix, fac.Jiy, fac.Jpx, fac.Jpy, obs.W, fac.Hpi_flat,
              obs.tie, obs.img, pairs.pa, pairs.pb, pairs.keys.begs, pairs.keys.ends)
    build_ms = cuda_ms(lambda: explicit.build_dense_S(fac, pairs), reps=5, warmup=1)
    build_bound, build_by = bound((*inputs, S), 0.0, torch.float64)
    v = torch.as_tensor(rng.standard_normal(nc), device=dev)
    gemv_ms = cuda_ms(lambda: S @ v)
    gemv_bound, gemv_by = bound((S, v, v), 2.0 * nc * nc, torch.float64)
    print(f"[14 explicit] device ms: build_dense_S {build_ms:.3f} (bound {build_bound:.4f}, "
          f"{build_by}: the factor streams, the pair indices and S once; "
          f"{build_ms / build_bound:.0f}x); the CG's S @ v {gemv_ms:.4f} (bound {gemv_bound:.4f}, "
          f"{gemv_by}: S's {S.numel() * 8 / 1e6:.0f} MB; {gemv_ms / gemv_bound:.2f}x) [{card}]")
    del S

    # K4 at this path's own shapes, on the values build_dense_S gives it:
    # the pair products (D = 36, the pair stream's length), the self-pair
    # image sums (D = 36, in image order) and the tie IOP sums (D = 3 ni)
    # at the observation stream's length, padded to whole chunks as
    # sorted_segment_sum pads them
    def padded(a):
        return torch.cat([a, a.new_zeros((-a.shape[0] % prefix.CHUNK, a.shape[1]))])

    Mt, _ = explicit.coupling_factors(fac)
    prod = explicit.abt(Mt[pairs.pa], Mt[pairs.pb]).reshape(-1, ne * ne)
    k4 = {ne * ne: _k4_check("14 explicit", "pair products", prod)}
    del prod
    hcc = explicit.weighted_outer(fac, fac.Jex, fac.Jey, fac.Jex, fac.Jey)
    _k4_check("14 explicit", "self-pair image sums",
              padded((hcc - explicit.abt(Mt, Mt)).reshape(-1, ne * ne)[obs.plan.perm]))
    del hcc
    Fi = explicit.weighted_outer(fac, fac.Jix, fac.Jiy, fac.Jpx, fac.Jpy)
    k4[ni * 3] = _k4_check("14 explicit", "tie IOP sums", padded(Fi.reshape(-1, ni * 3)))
    del Fi, Mt, fac
    for d, row in k4.items():
        row["launches"] = by_width[d]

    # covariance pieces at the solution (exact, float64, on the card)
    pieces = {}
    t0 = time.perf_counter()
    cov = covariance.schur_covariance(p, layout, res.x, res.sigma02, device=dev, pieces=pieces)
    cov_wall = time.perf_counter() - t0
    _print_pieces("14 explicit", cov_wall, pieces, card)
    # the solve's own covariance, at the same x and sigma0^2
    if not (np.array_equal(cov.std, res.std) and np.array_equal(cov.Cc_q, res.Cc_q)):
        raise RuntimeError("[14 explicit] FAIL: schur_covariance is not bitwise repeatable")
    print("[14 explicit] schur_covariance bitwise equal to the solve's own (std and Cc_q)")

    # -- 3. the CLI above the dense gate
    folder = Path("chiprun_out") / "smoke_schur_cli" / "ds"
    blk = make_block(n_img=40, n_pts=1200, model="fisheye", seed=6, control_frac=0.05,
                     settings_overrides={"inner_constraints": False, **SELFCAL})
    shutil.rmtree(folder, ignore_errors=True)
    write_block(blk, folder)
    problem = load_problem(folder)
    picked = cli.pick_solver(problem)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(folder, plot=False)
    cli_wall = time.perf_counter() - t0
    text = out.getvalue()
    report = folder / f"{folder.name}.out"
    body = report.read_text() if report.exists() else ""
    found = re.search(r"A-Posteriori\.+([-\d.eE+]+)", body)
    sigma02 = float(found.group(1)) if found else float("nan")
    print(f"[14 schur cli] {problem.n_img} images, u={ParamLayout(problem).u}: auto picks "
          f"{picked}; cli.main rc {rc} in {cli_wall:.2f} s, {text.count('Iteration ')} "
          f"iterations, sigma0^2 {sigma02:.6f}, stds numeric: {'n/a' not in body}")
    if not (picked == "schur" and rc == 0 and "Iteration Cap reached" not in text
            and 0.9 <= sigma02 <= 1.1 and body and "n/a" not in body):
        raise RuntimeError(f"[14 schur cli] FAIL: rc {rc}\n{text}")
    return k4


def _print_pieces(tag, wall, pieces, card):
    gemm = pieces.get("gemm", 0.0)
    rate = pieces.get("gemm_flops", 0.0) / max(gemm, 1e-12) / 1e12
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in pieces.items() if k != "gemm_flops")
    print(f"[{tag}] schur_covariance (float64 on the card) wall {wall:.2f} s: {parts}; "
          f"GEMMs {pieces.get('gemm_flops', 0.0) / 1e12:.2f} TFLOP at {rate:.1f} TFLOP/s [{card}]")


def phase_stds(p, layout, main_res, dev, card):
    """compute_stds at the bench block (1000 images) at phase 6's x and
    sigma0^2: the exact covariance at the gate's edge, then the Hutchinson
    estimate past it over K1/K2."""
    x, sigma02 = main_res.x, main_res.sigma02
    pieces = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exact, Cc, method = covariance.compute_stds(p, layout, x, sigma02, max_images=1000,
                                                device=dev, pieces=pieces)
    exact_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    _print_pieces("15 stds", exact_wall, pieces, card)
    print(f"[15 stds] exact: method {method}, nc={Cc.shape[0]}, peak mem {peak:.2f} GiB")
    if not (method == "exact" and np.isfinite(exact).all() and (exact > 0).all()):
        raise RuntimeError("[15 stds] FAIL: the exact stds")

    info = {}
    torch.cuda.synchronize()
    _reset_counts()
    schur.reset_cg_counts()
    t0 = time.perf_counter()
    est, Cc_est, method_est = covariance.compute_stds(p, layout, x, sigma02, max_images=999,
                                                      device=dev, info=info)
    torch.cuda.synchronize()
    est_wall = time.perf_counter() - t0
    launches, plain = _read_counts()
    cgc = dict(schur.cg_counts)
    its = info["cg_iterations"]
    live = exact > 0
    rel = np.abs(est[live] - exact[live]) / exact[live]
    pos = live & (est > 0)
    clipped = float((live.sum() - pos.sum()) / live.sum())
    corr = float(np.corrcoef(np.log(est[pos]), np.log(exact[pos]))[0, 1])
    print(f"[15 stds] hutchinson (64 probes, float32, fused): wall {est_wall:.2f} s; "
          f"{cgc['calls']} CG solves, {sum(its)} iterations (mean {np.mean(its):.1f}, "
          f"max {max(its)}; at the cap of 400: {sum(i >= 400 for i in its)}), "
          f"{cgc['matvecs']} matvecs; launches {dict((k, v) for k, v in launches.items() if v)}; "
          f"plain versions called {plain} [{card}]")
    print(f"[15 stds] against the exact stds: median rel err {np.median(rel):.4f}, q90 "
          f"{np.quantile(rel, 0.9):.4f} (the JAX test's bounds at 192 probes: 0.06 / 0.15; "
          f"here 64), clipped {clipped:.4%}, log-correlation {corr:.4f}")
    if not (method_est == "hutchinson" and Cc_est is None and np.isfinite(est).all()):
        raise RuntimeError("[15 stds] FAIL: the estimate")
    if plain or launches["fused_hpp_pass"] != 1 or launches["fused_schur_apply"] != cgc["matvecs"]:
        raise RuntimeError(f"[15 stds] FAIL: launches {launches}, plain {plain}, CG {cgc}")
    if launches["chunk_prefix"]:
        raise RuntimeError("[15 stds] FAIL: the fused estimator ran the chunk prefix")
    if not (clipped < 0.02 and corr > 0.95):
        raise RuntimeError(f"[15 stds] FAIL: clipped {clipped}, log-correlation {corr}")

    # the span segment sum at the estimator's shapes: the image sum (D = 6)
    # of C'b over the banded stream, gathered into image order
    plan = schur.make_band_plan(p, layout, schur.SchurOptions(dtype=np.float32))
    obs = schur.ObsData.from_problem(p, layout, plan, dtype=np.float32, device=dev)._band_sums()
    direct = obs.by_img
    n = obs.W.shape[0]
    live_rows = np.arange(n) < p.n_obs
    ids = np.where(live_rows, obs.img.cpu().numpy(), layout.n_img)
    vals = torch.as_tensor(np.random.default_rng(5).standard_normal((n, 6)).astype(np.float32),
                           device=dev)
    if direct.perm is not None:
        perm = direct.perm
        print(f"[15 stds] C'b image sum: its gather into image order "
              f"{cuda_ms(lambda: vals[perm]):.4f} ms, then:")
        vals, ids = vals[perm], ids[perm.cpu().numpy()]
    rows = direct.plan.n_rows
    pr = _solver_sum_probe("stds img", vals[:rows], ids[:rows], direct.plan, dev)
    r = measure(pr, PROBE_TOL)
    r["launches"] = launches["span_segment_sum"]
    print(f"[15 stds] M={direct.plan.M} G={direct.plan.G} N={n}: {line(pr, r)} [{card}]")
    return {k: v for k, v in launches.items() if v}, (pr, r)



# ---------------------------------------------------------------------------
# phase 16: the distributed solvers of parallel/ on an NCCL group
# ---------------------------------------------------------------------------

STDS_BLOCK = dict(n_img=300, n_pts=30_000, seed=2, control_frac=0.01)
FUSED_SHARD_TOL = dict(rtol=1e-3, atol=2e-3)  # tests/test_fusedshard.py
N_SHARDS = 4  # the per-shard kernels: a 4-card run's windows, on one card


def digest(x):
    """A short digest of an array's bytes: equal digests, equal bits."""
    return hashlib.sha1(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]


def _capped(p, cap):
    return dataclasses.replace(p, settings=dataclasses.replace(p.settings, iteration_cap=cap))


def _coll(counts):
    return "; ".join(f"{op} {c['calls']} calls {c['bytes'] / 1e6:.2f} MB"
                     for op, c in counts.items())


def stds_block(dev):
    """The reduced stds block, solved first (5 fused float32 iterations)
    for its x and sigma0^2: (problem, result)."""
    stds_p = make_block(model="fisheye", settings_overrides={
        "inner_constraints": False, **SELFCAL}, **STDS_BLOCK).problem
    stds_p = dataclasses.replace(
        stds_p, settings=dataclasses.replace(stds_p.settings, iteration_cap=5))
    pre = schur.solve_schur(stds_p, schur.SchurOptions(dtype=np.float32, cg_maxiter=40),
                            compute_covariance=False, device=dev)
    return stds_p, pre


def _mesh_solves(mesh, p, runs, tag):
    """The solves of `runs` ((name, solver, keywords, options, iteration
    cap)) on this rank of `mesh` (every rank alike): each under the host
    loop (device_loop=False: the checks of phases 6 and 9), then under the
    device loop (each step a replay of a captured graph, the collectives
    inside its IF nodes; device_loop=None, the default at every rank count,
    and True for fused_sharded).  Returns rank 0's numbers; raises on a
    count that is off: K1/K2 or K4 by the CG counts' formula, the peer
    collectives' launches and the Mesh's counts of the device loop equal to
    the host loop's plus the warm-up body's (the replays ran what the host
    loop ran), no plain version."""
    say = print if mesh.index == 0 else (lambda *a, **k: None)
    out = {}
    for name, solve, kw, opts, cap in runs:
        problem = dataclasses.replace(
            p, settings=dataclasses.replace(p.settings, iteration_cap=cap))
        walls = []

        def progress(rec, name=name, walls=walls):
            walls.append(rec.elapsed_s * 1e3)
            say(f"[{tag}] {name} iter {rec.iteration}: L1(delta)={rec.delta_l1:.9g} "
                f"lambda={rec.damping or 0.0:.3g} wall={rec.elapsed_s * 1e3:.1f} ms"
                + ("" if rec.accepted else " REJECTED"))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        schur.reset_cg_counts()
        mesh.reset_counts()
        t0 = time.perf_counter()
        res = solve(problem, mesh, dataclasses.replace(opts, device_loop=False),
                    progress_fn=progress, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = _read_counts()
        cgc = dict(schur.cg_counts)
        cg = res.cg_iterations
        steps, mv = len(cg), 8 * (cgc["host_reads"] - cgc["calls"])
        if name == "fused_sharded":
            want = {"fused_hpp_pass": steps, "fused_schur_apply": 2 * steps + mv}
        else:
            want = {"chunk_prefix": 6 * steps + 2 * mv}
        ran, peer = _split_peer({k: v for k, v in launches.items() if v})
        counts = {k: dict(v) for k, v in mesh.counts.items()}
        # over several ranks a peer launch a call, more for a call past the
        # workspace (chunks); none at one rank
        calls = {op: counts[op]["calls"] if mesh.comm is not None else 0 for op in PEER_OPS}
        peer_ok = all(peer.get(f"peer_{op}", 0) >= n and (f"peer_{op}" in peer) == (n > 0)
                      for op, n in calls.items())
        out[name] = dict(
            x=res.x, iterations=res.iterations, sigma02=res.sigma02, cg=cg, wall=wall,
            walls=walls, peak=torch.cuda.max_memory_allocated() / 2**30, launches=ran,
            peer=peer, plain=plain, counts=counts, cgc=cgc,
            finite=bool(np.isfinite(res.x).all() and np.isfinite(res.v).all()))
        say(f"[{tag}] {name}: {res.iterations} iterations ({res.stopped_on}), steps={steps} "
            f"cg per step={cg} sigma0^2={res.sigma02:.9f} wall={wall:.2f} s peak mem="
            f"{out[name]['peak']:.2f} GiB; launches {ran} (expected {want}), peer collectives "
            f"{peer}, plain versions called {plain}; collectives of rank {mesh.index}: "
            f"{_coll(counts)}")
        if ran != want or plain or cgc["matvecs"] != mv or not peer_ok:
            raise RuntimeError(f"[{tag}] FAIL: {name}: launches {ran}, expected {want}, "
                               f"peer {peer} for {counts}, plain {plain}, CG {cgc}")

    for name, solve, kw, opts, cap in runs:
        problem = dataclasses.replace(
            p, settings=dataclasses.replace(p.settings, iteration_cap=cap))
        asked = True if name == "fused_sharded" else None
        torch.cuda.synchronize()
        _reset_counts()
        schur.reset_cg_counts()
        mesh.reset_counts()
        t0 = time.perf_counter()
        res = solve(problem, mesh, dataclasses.replace(opts, device_loop=asked), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = _read_counts()
        lc = device_loop.loop_counts
        host = out[name]
        per, warm = _body_launches(lc["per_body"]), _body_launches(lc["warmup"])
        replayed = _loop_launches(name == "fused_sharded", res.cg_iterations, opts.cg_maxiter)
        want = {k: warm.get(k, 0) + n for k, n in replayed.items()}
        for k, n in host["peer"].items():
            want[k] = warm.get(k, 0) + n
        counts = {k: dict(v) for k, v in mesh.counts.items()}
        want_counts = {op: {k: host["counts"][op][k] + lc["warmup"]["mesh"][op][k]
                            for k in ("calls", "bytes")} for op in counts}
        ran = {k: v for k, v in launches.items() if v}
        bitwise = bool(np.array_equal(res.x, host["x"]))
        out[f"{name} device loop"] = dict(
            x=res.x, iterations=res.iterations, cg=res.cg_iterations, wall=wall,
            capture_s=lc["capture_s"], step_ms=lc["loop_s"] / lc["steps"] * 1e3,
            replays=lc["replays"], steps=lc["steps"], reads=lc["reads"], per_body=per,
            launches=ran, counts=counts, bitwise=bitwise, asked=asked,
            finite=bool(np.isfinite(res.x).all()))
        say(f"[{tag}] {name} under the device loop (device_loop={asked}): {res.iterations} "
            f"iterations ({res.stopped_on}), {lc['steps']} steps, cg per step="
            f"{res.cg_iterations}, wall {wall:.2f} s (capture {lc['capture_s']:.2f} s, chunk "
            f"loop {lc['loop_s'] * 1e3:.1f} ms: {lc['loop_s'] / lc['steps'] * 1e3:.1f} ms a "
            f"step, {lc['replays']} replays, {lc['reads']} packed reads); launches {ran} = "
            f"warm-up {warm} + replays {_kernels(lc['replayed'])} (counted on the card; want "
            f"{want}: K by the CG counts, peer collectives the host loop's; {per} captured a "
            f"body); plain {plain}; collectives {_coll(counts)} (want the host loop's plus the "
            f"warm-up's: {_coll(want_counts)}); x bitwise the host loop's: {bitwise}")
        if (ran != want or plain or not lc["graph"] or counts != want_counts
                or lc["per_body"]["cg"]["host_reads"] or schur.cg_counts["host_reads"]):
            raise RuntimeError(f"[{tag}] FAIL: {name} under the device loop: launches {ran}, "
                               f"expected {want}, plain {plain}, collectives {counts}, "
                               f"expected {want_counts}, loop {lc}")
    return out


def _distributed_rank(mesh, p, stds_p, stds_x, stds_sigma02):
    """Phase 16's solves on one rank (every rank of the group alike): the
    three distributed solvers on the bench block, then the mesh estimate of
    the stds block's stds.  Returns rank 0's numbers; raises on a count
    that is off."""
    import torch.distributed as dist

    from fish_eye_bundle_adjustment_tpu_torch.parallel import (
        dist_schur, fusedshard, sharded_state,
    )

    tag = "16 distributed"
    out = {"backend": dist.get_backend(), "size": mesh.size}
    runs = (
        ("distributed", dist_schur.solve_schur_distributed, {},
         schur.SchurOptions(cg_maxiter=40), 3),
        ("sharded", sharded_state.solve_schur_sharded_state, dict(point_mode="sharded"),
         schur.SchurOptions(cg_maxiter=40), 3),
        ("fused_sharded", fusedshard.solve_schur_fused_sharded, {},
         schur.SchurOptions(dtype=np.float32, cg_maxiter=40), 5),
    )
    out.update(_mesh_solves(mesh, p, runs, tag))
    if mesh.size > 1:
        # at CG's default depth: over several ranks the x at the cut of 40
        # carries the ranks' order of summation on, this one does not
        r = fusedshard.solve_schur_fused_sharded(
            _capped(p, 5), mesh, schur.SchurOptions(dtype=np.float32))
        out["fused_sharded full CG"] = dict(
            x=r.x, iterations=r.iterations, sigma02=r.sigma02, cg=r.cg_iterations, walls=[],
            finite=bool(np.isfinite(r.x).all()))
    if mesh.comm is not None:
        # the peer collectives at the solvers' shapes over the cards, NCCL beside
        out["coll"] = _coll_check(mesh.comm, _coll_shapes(p), nccl=True)

    # what one all-reduce costs a CG matvec: the fused operator's camera
    # outputs (float32) and the distributed matvec's tie sum (float64)
    kern = schur.SchurKernel(ParamLayout(p), schur.SchurOptions())
    payloads = {
        f"the fused matvec's camera outputs ({kern.ne * kern.n_img + kern.ni * 128} "
        f"float32)": torch.ones(kern.ne * kern.n_img + kern.ni * 128, device=mesh.device),
        f"the distributed matvec's tie sum ({3 * kern.n_tie} float64)": torch.ones(
            3 * kern.n_tie, dtype=torch.float64, device=mesh.device),
    }
    out["psum_us"] = {}
    for what, buf in payloads.items():
        for _ in range(10):
            mesh.psum(buf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            mesh.psum(buf)
        torch.cuda.synchronize()
        out["psum_us"][what] = (time.perf_counter() - t0) / 200 * 1e6

    # the SPMD probe stds (float32, unfused, the rank's slice: K4 under
    # every sum), past the gate on the stds block
    layout = ParamLayout(stds_p)
    info = {}
    torch.cuda.synchronize()
    _reset_counts()
    schur.reset_cg_counts()
    mesh.reset_counts()
    t0 = time.perf_counter()
    est, Cc, method = covariance.compute_stds(
        stds_p, layout, stds_x, stds_sigma02, max_images=stds_p.n_img - 1, mesh=mesh,
        device=mesh.device, info=info)
    torch.cuda.synchronize()
    launches, plain = _read_counts()
    ran, peer = _split_peer({k: v for k, v in launches.items() if v})
    out["stds"] = dict(est=est, method=method, wall=time.perf_counter() - t0, launches=ran,
                       peer=peer, plain=plain, cgc=dict(schur.cg_counts),
                       its=info["cg_iterations"],
                       counts={k: dict(v) for k, v in mesh.counts.items()})
    if (method != "hutchinson" or Cc is not None or set(ran) != {"chunk_prefix"} or plain
            or bool(peer) != (mesh.comm is not None)):
        raise RuntimeError(f"[{tag}] FAIL: the mesh estimate: {method}, launches {ran}, "
                           f"plain {plain}")
    return out


def _loop_against_host(tag, out, card, bitwise):
    """Each solve's device loop against its host loop on the same ranks:
    the same iterations and CG counts, x bitwise equal (`bitwise`: over
    several ranks, where every collective is a peer kernel in both), else
    within the tolerances of phases 6 and 9 (one NCCL rank)."""
    for name, tol in (("distributed", X_TOL_F64), ("sharded", X_TOL_F64),
                      ("fused_sharded", X_TOL)):
        r, host = out[f"{name} device loop"], out[name]
        diff = np.abs(r["x"] - host["x"])
        viol = float(np.max(diff / (tol["atol"] + tol["rtol"] * np.abs(host["x"]))))
        print(f"[{tag}] {name} device loop (device_loop={r['asked']}) against its host loop: "
              f"max |dx| {diff.max():.3e} (tolerance use {viol:.3f}; bitwise {r['bitwise']}), "
              f"iterations {r['iterations']} vs {host['iterations']}, cg {r['cg']} vs "
              f"{host['cg']}; capture {r['capture_s']:.2f} s, {r['step_ms']:.1f} ms a step "
              f"against host-loop step walls "
              f"{', '.join(f'{w:.1f}' for w in host['walls'][1:])} ms [{card}]")
        same = r["bitwise"] if bitwise else viol <= 1.0
        if not (r["finite"] and r["iterations"] == host["iterations"]
                and r["cg"] == host["cg"] and same):
            raise RuntimeError(f"[{tag}] FAIL: {name} under the device loop differs from "
                               "its host loop")


# ---------------------------------------------------------------------------
# the peer collectives (ops/csrc/peercoll.cu): phase 16 over several cards,
# phase 19 at two ranks on one card
# ---------------------------------------------------------------------------

NVLINK_BYTES_PER_S = 450e9  # H100 SXM, each way (900 GB/s all to all)
PEER_RANKS = 2
PEER_SOLVES = dict(cg_maxiter=40, caps=(2, 2, 3))  # phase 19's depth, cut for time


def _coll_shapes(p):
    """The sizes the solvers' collectives take on block p."""
    kern = schur.SchurKernel(ParamLayout(p), schur.SchurOptions())
    return dict(n_img=kern.n_img, n_tie=kern.n_tie, n_obs=p.n_obs,
                cam=kern.ne * kern.n_img + kern.ni * 128)


# tie points of BASELINE configs[5]'s block, bench_tenk.py's make_block(10_000,
# 1_000_000, seed=13): ParamLayout(problem).n_tie, counted on the block
TENK_N_TIE = 979_998


def _coll_cases(shapes, size):
    """[(what, op, shape)] on `size` ranks: the first of each op stands for
    it in the kernel table; the last three are the tie sums, the last two
    at BASELINE configs[5]'s 10k block (23.5 MB a rank in float64), each
    one launch (ops/peercoll.WORKSPACE_BYTES)."""
    n_img, n_tie = shapes["n_img"], shapes["n_tie"]
    m_img = -(-n_img // size)
    return [
        ("the distributed matvec's tie sum", "all_reduce", (3 * n_tie,)),
        ("the step's stats", "all_reduce", (4,)),
        ("the fused matvec's camera outputs", "all_reduce", (shapes["cam"],)),
        ("the Hcc blocks", "all_reduce", (n_img, 36)),
        ("the sharded pose sums", "reduce_scatter", (size * m_img, 6)),
        ("the sharded matvec's pose vector", "all_gather", (m_img, 6)),
        ("the residual rows", "all_gather", (-(-shapes["n_obs"] // size), 2)),
        ("the tie sums scattered", "reduce_scatter", (size * n_tie, 3)),
        ("configs[5]'s tie sum", "all_reduce", (3 * TENK_N_TIE,)),
        ("configs[5]'s tie sums scattered", "reduce_scatter", (size * TENK_N_TIE, 3)),
    ]


def _coll_bound(op, x, out, size, cards):
    """(bound_ms, "bytes"): what this rank's output needs read and
    written over the memory rate (every rank's share once, the output
    once), or, where the ranks hold several cards, the least any schedule
    must bring in over NVLink each way: the peers' shares for the
    reduce-scatter and the all-gather, 2 (size - 1) / size x the bytes
    for the all-reduce (each rank sums 1/size of the columns and gathers
    the rest; a one-shot schedule brings in (size - 1) x)."""
    b = x.element_size()
    share = out.numel() // size if op == "all_gather" else out.numel()
    hbm = (size * share + out.numel()) * b / HBM_BYTES_PER_S
    peers = 2 * (size - 1) / size if op == "all_reduce" else size - 1
    link = peers * share * b / NVLINK_BYTES_PER_S if cards > 1 else 0.0
    return max(hbm, link) * 1e3, "bytes"


def _library_call(op, x, out):
    """The process group's own collective computing what peer `op` does,
    on the same CUDA tensors: NCCL's, or gloo's (its CUDA path stages
    through the host)."""
    import torch.distributed as dist

    if op == "all_reduce":
        buf = x.clone()
        return lambda: dist.all_reduce(buf)
    if op == "reduce_scatter":
        return lambda: dist.reduce_scatter_tensor(out, x)
    return lambda: dist.all_gather_into_tensor(out, x)


def _coll_check(comm, shapes, nccl):
    """Each case of _coll_cases in float64 and float32 on this rank (every
    rank alike): the kernel twice and its plain version, bitwise equal or
    it raises; kernel, plain and library times (CUDA events, every rank
    timing together) and the bound.  The library is the group's own
    collective on the same tensors: NCCL's (`nccl`) or gloo's; where the
    group has none for an op on CUDA tensors, the record says why.
    Returns the records."""
    import torch.distributed as dist

    rng = np.random.default_rng([11, comm.rank])
    cards = torch.cuda.device_count() if nccl else 1
    rows = []
    for what, op, shape in _coll_cases(shapes, comm.size):
        for dt in (torch.float64, torch.float32):
            x = torch.as_tensor(rng.standard_normal(shape), dtype=dt, device=comm.device)
            fn = lambda op=op, x=x: getattr(peercoll, op)(x, comm)
            peercoll.reset_counts()
            got = fn()
            chunks = peercoll.kernel_launches[f"peer_{op}"]
            again, want = fn(), peercoll.plain(op, x, comm)
            torch.cuda.synchronize()
            comm.check()
            bitwise = torch.equal(got, again) and torch.equal(got, want)
            max_abs = float((got.double() - want.double()).abs().max())
            if not bitwise:
                raise RuntimeError(f"[peer collectives] FAIL: {op} of {what} {dt}: not bitwise "
                                   f"its plain version (max |d| {max_abs:.3e}) or itself")
            library = "NCCL" if nccl else "gloo"
            lib = _library_call(op, x, torch.empty_like(got))
            try:
                lib()
                torch.cuda.synchronize()
            except RuntimeError as e:  # the same refusal on every rank, before any exchange
                library, lib = f"none: {library} refuses {op} of CUDA tensors ({e})", None
            dist.barrier()
            ms = cuda_ms(fn, reps=10)
            plain_ms = cuda_ms(lambda op=op, x=x: peercoll.plain(op, x, comm), reps=10)
            lib_ms = None if lib is None else cuda_ms(lib, reps=10)
            comm.check()
            b_ms, b_by = _coll_bound(op, x, got, comm.size, cards)
            rows.append(dict(what=what, op=op, dtype=str(dt).split(".")[-1], shape=shape,
                             chunks=chunks, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, library=library, bound_ms=b_ms,
                             bound_by=b_by))
    return rows


def _print_coll(tag, rows, card):
    for r in rows:
        lib = (r["library"] if r["library_ms"] is None
               else f"{r['library']} {r['library_ms']:.4f} ms")
        print(f"[{tag}] peer {r['op']} of {r['what']} {r['shape']} {r['dtype']} "
              f"({r['chunks']} launch(es)): bitwise its plain version; kernel {r['ms']:.4f} ms "
              f"plain {r['plain_ms']:.4f} ms library {lib} bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; kernel {r['ms'] / r['bound_ms']:.1f}x) [{card}]")


def _peer_rank(mesh, stds_p, shapes):
    """Phase 19 on one of two ranks, both on cuda:0 over the gloo group of
    `mesh`: the rank's peer communicator and a CUDA Mesh on it (no NCCL:
    it refuses two ranks on one card); the three distributed solvers on
    the stds block under both drivers (_mesh_solves), then the collectives
    at the bench block's shapes (_coll_check)."""
    from fish_eye_bundle_adjustment_tpu_torch.parallel import (
        dist_schur, fusedshard, sharded_state,
    )
    from fish_eye_bundle_adjustment_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    comm = peercoll.PeerComm(dev, mesh.index, mesh.size)
    cmesh = Mesh(device=dev, size=mesh.size, index=mesh.index, comm=comm)
    maxiter, caps = PEER_SOLVES["cg_maxiter"], PEER_SOLVES["caps"]
    runs = (
        ("distributed", dist_schur.solve_schur_distributed, {},
         schur.SchurOptions(cg_maxiter=maxiter), caps[0]),
        ("sharded", sharded_state.solve_schur_sharded_state, dict(point_mode="sharded"),
         schur.SchurOptions(cg_maxiter=maxiter), caps[1]),
        ("fused_sharded", fusedshard.solve_schur_fused_sharded, {},
         schur.SchurOptions(dtype=np.float32, cg_maxiter=maxiter), caps[2]),
    )
    tag = "19 peer collectives"
    t0 = time.perf_counter()
    out = _mesh_solves(cmesh, stds_p, runs, tag)
    out["solves_s"] = time.perf_counter() - t0
    out["coll"] = _coll_check(comm, shapes, nccl=False)
    comm.close()
    return out


def phase_peer(p, stds_p, card):
    """The peer collectives at two ranks on cuda:0 (two spawned processes,
    a gloo group): the distributed solvers under the device loop with
    every collective a peer kernel inside its IF nodes, against the host
    loop (x bitwise); each collective bitwise its plain version at the
    solvers' shapes.  Returns (the kernel-table rows' records by op, the
    peer launches of the solves)."""
    from fish_eye_bundle_adjustment_tpu_torch.parallel import mesh as pmesh

    tag = "19 peer collectives"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = pmesh.run_ranks(_peer_rank, PEER_RANKS, "cpu", args=(stds_p, _coll_shapes(p)),
                          timeout_s=900)
    print(f"[{tag}] {PEER_RANKS} ranks on cuda:0 (gloo group, peer kernels for every "
          f"collective): {time.perf_counter() - t0:.1f} s, the solves {out['solves_s']:.1f} s "
          f"({stds_p.n_img} images, {stds_p.n_obs} observations; two processes time-slice "
          f"one card, so no time here is a cross-card time) [{card}]")
    _loop_against_host(tag, out, card, bitwise=True)
    _print_coll(tag, out["coll"], card)
    launches = {}
    for name in ("distributed", "sharded", "fused_sharded"):
        for k, v in out[name]["peer"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in out[f"{name} device loop"]["launches"].items():
            if k.startswith("peer_"):
                launches[k] = launches.get(k, 0) + v
    print(f"[{tag}] peer launches of the solves (host + device loop): {launches}")
    if set(launches) != {f"peer_{op}" for op in PEER_OPS}:
        raise RuntimeError(f"[{tag}] FAIL: a peer collective never launched: {launches}")
    return out["coll"], launches


def phase_shard_kernels(p, layout, plan, dev, card):
    """K1 and K2 on each window of the bench block's band plan split over
    N_SHARDS, on one card: each window folded from its own rows
    (fusedshard.window_streams) with the unsharded Hpp^-1 of its ranks, at
    x0.  Each held to its plain version (1e-5 relative norm, bitwise
    repeatable) and timed with its bound; the camera-side outputs summed
    over the windows held to the unsharded kernels' (1e-5)."""
    from types import SimpleNamespace

    from fish_eye_bundle_adjustment_tpu_torch.ops.bandplan import split_band_plan
    from fish_eye_bundle_adjustment_tpu_torch.parallel import fusedshard

    tag = "16 shard kernels"
    opts = schur.SchurOptions(dtype=np.float32)
    kern = schur.SchurKernel(layout, opts)
    ne, ni = kern.ne, kern.ni
    obs = schur.ObsData.from_problem(p, layout, plan, dtype=np.float32, device=dev)
    x0 = torch.as_tensor(layout.initial().astype(np.float32), device=dev)
    q = x0 * layout.scale_like(x0)
    fac = kern.linearize(q, obs, lam=torch.zeros((), device=dev))
    rng = np.random.default_rng(0)
    rnd = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32), device=dev)
    vpose, vi = rnd(8, plan.n_img_pad), rnd(128)
    names = ("fused_hpp_pass", "fused_schur_apply/matvec_bf16",
             "fused_schur_apply/rhs_precond", "fused_schur_apply/backsub")
    whole_cases = bench_torch_fusedmv.kernel_cases(
        fusedmv, obs.band, fac, ne, ni, dict(vpose=vpose, vi=vi, a_rows=fac._fused_arows()))
    camera = ("de", "di", "pose", "iop", "p21", "i55")
    whole = {}
    for name in names:
        kind, kernel, _, _ = whole_cases[name]
        for key, t in bench_torch_fusedmv.glue_reads(kernel(), plan, ne, ni, kind).items():
            if key in camera:
                whole[(name, key)] = t.double()
    t0 = time.perf_counter()
    sp = split_band_plan(plan, N_SHARDS)
    n_rank = sp.G_loc * sp.M
    hpi = torch.nn.functional.pad(fac.hpi_t, (0, sp.rank_pad - fac.hpi_t.shape[1]))
    print(f"[{tag}] split_band_plan over {N_SHARDS}: G_loc={sp.G_loc} slice_len={sp.slice_len} "
          f"(of n_pad={plan.n_pad}) ({time.perf_counter() - t0:.1f} s on the host)")
    summed, rows = {}, {}
    for d in range(N_SHARDS):
        data = fusedshard.build_fused_shard_data(p, layout, sp, d, dev)
        _, acam_t, apt_t, a_rows = fusedshard.window_streams(kern, q, data.obs)
        h = hpi[:, d * n_rank : (d + 1) * n_rank].contiguous()
        window = SimpleNamespace(acam_t=acam_t, apt_t=apt_t, hpi_t=h)
        cases = bench_torch_fusedmv.kernel_cases(
            fusedmv, data.band, window, ne, ni, dict(vpose=vpose, vi=vi, a_rows=a_rows))
        owned = int(sp.owned[d].sum())
        flops = bench_torch_fusedmv.kernel_flops(owned, n_rank, ne, ni)
        # the reads of a window's outputs: its ranks, every image
        reads = SimpleNamespace(n_tie=n_rank, n_img=plan.n_img)
        for name in names:
            kind, kernel, plain, extra = cases[name]
            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError(f"[{tag}] FAIL: shard {d} {name} is not bitwise repeatable")
            g = bench_torch_fusedmv.glue_reads(got, reads, ne, ni, kind)
            w = bench_torch_fusedmv.glue_reads(want, reads, ne, ni, kind)
            errs = {k: rel_norm(g[k], w[k]) for k in w}
            max_abs = max(float((g[k].double() - w[k].double()).abs().max()) for k in w)
            for key in g:
                if key in camera:
                    summed[(name, key)] = summed.get((name, key), 0) + g[key].double()
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            b_ms, b_by = bound((acam_t, apt_t, *bench_torch_fusedmv.band_inputs(data.band),
                                *extra, *got), flops[name], torch.float32)
            print(f"[{tag}] shard {d} ({owned} owned rows) {name}: rel err "
                  + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                  + f" max_abs={max_abs:.3e} bitwise-repeatable kernel {ms:.4f} ms plain "
                  f"{plain_ms:.3f} ms bound {b_ms:.4f} ms ({b_by}; kernel {ms / b_ms:.2f}x) "
                  f"[{card}]")
            if not all(v <= KERNEL_TOL for v in errs.values()):
                raise RuntimeError(f"[{tag}] FAIL: shard {d} {name} off its plain version: {errs}")
            r = rows.setdefault(name, dict(max_abs_err=0.0, ms=0.0))
            r["max_abs_err"] = max(r["max_abs_err"], max_abs)
            if ms >= r["ms"]:  # the slowest window sets a step's pace
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, shard=d)
    errs = {f"{n.split('/')[-1]} {k}": rel_norm(summed[(n, k)], whole[(n, k)])
            for n, k in whole}
    print(f"[{tag}] camera-side outputs summed over the {N_SHARDS} windows against the "
          f"unsharded kernels: " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    if not all(v <= KERNEL_TOL for v in errs.values()):
        raise RuntimeError(f"[{tag}] FAIL: the windows do not sum to the operator: {errs}")
    return rows


def phase_distributed(p, layout, res6, res9, dev, card):
    """The distributed solvers on an NCCL group of the visible cards (in
    this process at one card), held against phases 6 and 9; the per-shard
    kernels at 4 windows; the mesh estimate of the stds at a reduced
    block."""
    from fish_eye_bundle_adjustment_tpu_torch.parallel import mesh as pmesh

    tag = "16 distributed"
    stds_p, pre = stds_block(dev)
    n = torch.cuda.device_count()
    checks = [("distributed", res9, X_TOL_F64, True), ("sharded", res9, X_TOL_F64, True),
              ("fused_sharded", res6, FUSED_SHARD_TOL, n == 1)]
    if n > 1:
        # phase 6's solve at CG's default depth, for fused_sharded's at it
        full = schur.solve_schur(_capped(p, 5), schur.SchurOptions(dtype=np.float32),
                                 compute_covariance=False, device=dev)
        checks.append(("fused_sharded full CG", full, FUSED_SHARD_TOL, True))
    t0 = time.perf_counter()
    args = (p, stds_p, pre.x, pre.sigma02)
    if n == 1:
        pmesh.init_distributed(f"tcp://127.0.0.1:{pmesh._free_port()}", 1, 0, "cuda:0",
                               timeout_s=600)
        try:
            out = _distributed_rank(pmesh.make_mesh(), *args)
        finally:
            pmesh.shutdown()
    else:
        out = pmesh.run_ranks(_distributed_rank, n, "cuda", args=args, timeout_s=900)
    print(f"[{tag}] process group: backend {out['backend']}, {out['size']} rank(s) "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")
    if out["backend"] != "nccl" or out["size"] != n:
        raise RuntimeError(f"[{tag}] FAIL: group {out['backend']} of {out['size']}")

    for name, ref, tol, held in checks:
        r = out[name]
        diff = np.abs(r["x"] - ref.x)
        viol = float(np.max(diff / (tol["atol"] + tol["rtol"] * np.abs(ref.x))))
        walls = ", ".join(f"{w:.1f}" for w in r["walls"])
        against = {id(res9): "phase 9's solve", id(res6): "phase 6's solve"}.get(
            id(ref), "phase 6's solve at CG's default depth")
        print(f"[{tag}] {name}: step walls {walls} ms; max |dx| from {against} "
              f"{diff.max():.3e} (tolerance use {viol:.3f}"
              f"{'' if held else '; printed, not held: the CG cut carries the sum order on'}"
              f"); sigma0^2 {r['sigma02']:.9f} vs {ref.sigma02:.9f}; cg {r['cg']} vs "
              f"{ref.cg_iterations}; x digest {digest(r['x'])} [{card}]")
        if not (r["finite"] and r["iterations"] == ref.iterations and (viol <= 1.0 or not held)):
            raise RuntimeError(f"[{tag}] FAIL: {name} differs from {against}")
    _loop_against_host(tag, out, card, bitwise=n > 1)
    if n > 1:
        _print_coll(tag, out["coll"], card)
    for what, us in out["psum_us"].items():
        print(f"[{tag}] mesh.psum of {what}: {us:.1f} us a call (host wall over 200 "
              f"calls, the card synchronized at the end) [{card}]")

    rows = phase_shard_kernels(p, layout, schur.make_band_plan(
        p, layout, schur.SchurOptions(dtype=np.float32)), dev, card)

    # the stds block's exact stds against the mesh estimate, by phase 15's measures
    st = out["stds"]
    s_layout = ParamLayout(stds_p)
    exact, _, method = covariance.compute_stds(stds_p, s_layout, pre.x, pre.sigma02,
                                               max_images=1000, device=dev)
    live = exact > 0
    est = st["est"]
    rel = np.abs(est[live] - exact[live]) / exact[live]
    pos = live & (est > 0)
    clipped = float((live.sum() - pos.sum()) / live.sum())
    corr = float(np.corrcoef(np.log(est[pos]), np.log(exact[pos]))[0, 1])
    its = st["its"]
    print(f"[{tag}] stds block ({stds_p.n_img} images, {stds_p.n_obs} observations, "
          f"u={s_layout.u}): mesh estimate (64 probes, float32, unfused) wall "
          f"{st['wall']:.2f} s, {st['cgc']['calls']} CG solves, {sum(its)} iterations, "
          f"{st['cgc']['matvecs']} matvecs; launches {st['launches']}, plain {st['plain']}; "
          f"collectives {_coll(st['counts'])} [{card}]")
    print(f"[{tag}] against the exact stds ({method}): median rel err {np.median(rel):.4f}, "
          f"q90 {np.quantile(rel, 0.9):.4f}, clipped {clipped:.4%}, log-correlation {corr:.4f}")
    if not (method == "exact" and np.isfinite(est).all() and clipped < 0.02 and corr > 0.95):
        raise RuntimeError(f"[{tag}] FAIL: the mesh estimate: clipped {clipped}, "
                           f"log-correlation {corr}")

    # K4 at the distributed paths' shapes: a 4-card slice of the bench
    # block's float64 stream (D = 6), and the stds block's float32 stream
    n4 = schur.shard_rows(p.n_obs, N_SHARDS)[1]
    n1 = schur.shard_rows(stds_p.n_obs, 1)[1]
    g = np.random.default_rng(4)
    k4 = {
        "sharded": _k4_check(tag, f"float64 D=6 at a {N_SHARDS}-card slice", torch.as_tensor(
            g.standard_normal((n4, 6)), dtype=torch.float64, device=dev)),
        "stds mesh": _k4_check(tag, "float32 D=6 (stds block)", torch.as_tensor(
            g.standard_normal((n1, 6)), dtype=torch.float32, device=dev)),
    }
    k4["sharded"]["launches"] = (out["distributed"]["launches"]["chunk_prefix"]
                                 + out["sharded"]["launches"]["chunk_prefix"])
    k4["stds mesh"]["launches"] = st["launches"]["chunk_prefix"]
    for name in ("fused_hpp_pass", "fused_schur_apply"):
        rows_name = name if name in rows else f"{name}/matvec_bf16"
        rows[rows_name]["launches"] = out["fused_sharded"]["launches"][name]
    return rows, k4, stds_p, out


def _loop_solve(problem, opts, dev, capture):
    """solve_schur's device-loop path with `capture` passed on (False: the
    eager body on the card): (x, iterations, CG counts)."""
    layout = ParamLayout(problem)
    kern = schur.SchurKernel(layout, opts)
    plan = schur.make_band_plan(problem, layout, opts)
    obs = schur.ObsData.from_problem(problem, layout, plan, dtype=opts.dtype, device=dev,
                                     obs_order=opts.obs_order)
    step = schur.schur_step_fn(kern, layout, problem.settings.inner_constraints)
    cg = []
    out = device_loop.run_gn_loop_device(step, obs, layout, problem, opts, device=dev,
                                         chunk=opts.device_chunk, capture=capture,
                                         cg_iterations=cg)
    return out[0].cpu().numpy(), out[5], cg


def _read_us(dev, n):
    """Host microseconds of one read of n float32 from an idle card: a
    plain .cpu(), and the device loop's form (a pinned non-blocking copy,
    an event, its synchronize)."""
    t = torch.zeros(n, device=dev)
    host = torch.empty(n, pin_memory=True)
    done = torch.cuda.Event()

    def pinned():
        host.copy_(t, non_blocking=True)
        done.record()
        done.synchronize()

    out = {}
    for name, fn in (("cpu()", lambda: t.cpu()), ("pinned + event", pinned)):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        out[name] = (time.perf_counter() - t0) / 2000 * 1e6
    return out


def phase_device_loop(p, layout, res6, res9, dev, card):
    """The device loop on the bench block: phase 6's and phase 9's solves
    captured as CUDA graphs, against them; the graph against the eager
    body; an uncut float32 solve to convergence; the cost of a host read."""
    tag = "17 device loop"
    nrec = 2 * schur.SchurOptions().device_chunk + 2
    for n, what in ((1, "a 0-d flag"), (nrec * device_loop.N_COLS + 3, "the packed records")):
        us = _read_us(dev, n)
        print(f"[{tag}] one device->host read of {what} ({n} float32) on an idle card: "
              + ", ".join(f"{k} {v:.2f} us" for k, v in us.items()) + f" [{card}]")
    rows = {}
    cases = (
        ("fused float32", res6, schur.SchurOptions(dtype=np.float32, cg_maxiter=40), 5,
         {"fused_hpp_pass": 1, "fused_schur_apply": 2 + 40}),
        ("unfused float64", res9, schur.SchurOptions(cg_maxiter=40), 3,
         {"chunk_prefix": 6 + 2 * 40}),
    )
    for name, ref, opts, cap, want_per in cases:
        problem = dataclasses.replace(
            p, settings=dataclasses.replace(p.settings, iteration_cap=cap))
        records = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        schur.reset_cg_counts()
        t0 = time.perf_counter()
        res = schur.solve_schur(problem, opts, compute_covariance=False, device=dev,
                                progress_fn=records.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches, plain = _read_counts()
        lc = dict(device_loop.loop_counts)
        per, warm = _body_launches(lc["per_body"]), _body_launches(lc["warmup"])
        steps = lc["steps"]
        ran = {k: v for k, v in launches.items() if v}
        replayed = _loop_launches(name.startswith("fused"), res.cg_iterations, opts.cg_maxiter)
        want = {k: warm.get(k, 0) + n for k, n in replayed.items()}
        replay_ms = lc["loop_s"] / steps * 1e3
        ref_walls = [r.elapsed_s * 1e3 for r in ref.progress][1:]
        blocks = sum(-(-c // 8) for c in res.cg_iterations)
        print(f"[{tag}] {name}: {res.iterations} iterations ({res.stopped_on}), {steps} steps, "
              f"cg per step={res.cg_iterations}, wall {wall:.2f} s, peak mem {peak:.2f} GiB "
              f"[{card}]")
        print(f"[{tag}] {name}: capture (warm-up body + capture) {lc['capture_s']:.2f} s, "
              f"graph pools +{lc['capture_reserved_bytes'] / 2**30:.2f} GiB reserved; "
              f"{replay_ms:.1f} ms a replay (chunk loop {lc['loop_s'] * 1e3:.1f} ms over "
              f"{steps} steps) against the host loop's step walls "
              f"{', '.join(f'{w:.1f}' for w in ref_walls)} ms (phase "
              f"{6 if ref is res6 else 9}, first step left out) [{card}]")
        print(f"[{tag}] {name}: {lc['reads']} packed reads (ceil(steps / chunk) = "
              f"{-(-steps // opts.device_chunk)}; ceil(iterations / chunk) + 1 = "
              f"{-(-res.iterations // opts.device_chunk) + 1}), {lc['replays']} replays issued, "
              f"{lc['replays'] - steps} of them after the stop (IF node off: no step run); "
              f"CG host reads {schur.cg_counts['host_reads']}; CG blocks of 8 run "
              f"{blocks} of {steps * -(-opts.cg_maxiter // 8)} captured")
        print(f"[{tag}] {name}: launches {ran} = warm-up {warm} + replays "
              f"{_kernels(lc['replayed'])} (counted on the card; want {replayed} from the CG "
              f"counts); captured a body {per}, {steps} x that {({k: n * steps for k, n in per.items()})} "
              f"had every CG block run; plain versions {plain}")
        same = ([(r.iteration, r.accepted) for r in records]
                == [(r.iteration, r.accepted) for r in ref.progress])
        if name.startswith("fused"):
            rel = float(np.linalg.norm(res.x - ref.x) / np.linalg.norm(ref.x))
            ok_x = rel <= 1e-6
            print(f"[{tag}] {name} against phase 6: ||dx|| / ||x|| = {rel:.3e} (limit 1e-6), "
                  f"max |dx| {np.abs(res.x - ref.x).max():.3e}; accept/reject sequence "
                  f"{'equal' if same else 'DIFFERS'}; cg {res.cg_iterations} vs "
                  f"{ref.cg_iterations}")
            ok_x = ok_x and res.cg_iterations == ref.cg_iterations
        else:
            diff = np.abs(res.x - ref.x)
            viol = float(np.max(diff / (X_TOL_F64["atol"] + X_TOL_F64["rtol"] * np.abs(ref.x))))
            ok_x = viol <= 1.0
            print(f"[{tag}] {name} against phase 9: max |dx| {diff.max():.3e} (tolerance use "
                  f"{viol:.3f}); accept/reject sequence {'equal' if same else 'DIFFERS'}; cg "
                  f"{res.cg_iterations} vs {ref.cg_iterations}")
        if not (lc["graph"] and res.iterations == ref.iterations and same and ok_x
                and np.isfinite(res.x).all() and np.isfinite(res.v).all()):
            raise RuntimeError(f"[{tag}] FAIL: {name} differs from the host loop's solve")
        if (per != want_per or ran != want or plain or schur.cg_counts["host_reads"]
                or lc["per_body"]["cg"]["host_reads"]):
            raise RuntimeError(f"[{tag}] FAIL: {name}: launches {ran} (want {want}), a body "
                               f"{per} (want {want_per}), plain {plain}, loop {lc}")
        for k, n in ran.items():
            rows[k] = dict(launches=n)

        # the captured graph against the eager body, on the card
        t0 = time.perf_counter()
        x_eager, its, cg = _loop_solve(problem, opts, dev, capture=False)
        eager_s = time.perf_counter() - t0
        bitwise = np.array_equal(x_eager, res.x)
        print(f"[{tag}] {name}: the eager body on the card ({eager_s:.2f} s, every CG block's "
              f"flag read back): {its} iterations, cg {cg}; x "
              + ("bitwise equal to the graph's" if bitwise else
                 f"differs from the graph's by {np.abs(x_eager - res.x).max():.3e}"))
        if not bitwise or cg != res.cg_iterations:
            raise RuntimeError(f"[{tag}] FAIL: {name}: the graph and the eager body differ")

    # an uncut float32 solve to convergence, by bench.py's definition of it
    # (bench.py:349-357): the f32 delta floor L1 <= 3e-4 u as the
    # threshold, 60 iterations at most, 40 CG iterations to cg_tol 1e-6
    conv = dataclasses.replace(p, settings=dataclasses.replace(
        p.settings, threshold=3e-4 * layout.u, iteration_cap=60))
    opts = schur.SchurOptions(dtype=np.float32, cg_maxiter=40, cg_tol=1e-6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = schur.solve_schur(conv, opts, compute_covariance=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lc = device_loop.loop_counts
    print(f"[{tag}] time to a converged solve (fused float32, bench.py's convergence: "
          f"threshold 3e-4 u = {3e-4 * layout.u:.1f}, cap 60, cg_maxiter 40, cg_tol 1e-6): "
          f"{wall:.2f} s wall (capture {lc['capture_s']:.2f} s, chunk loop {lc['loop_s']:.2f} s, "
          f"{lc['reads']} packed reads); converged={res.converged} ({res.stopped_on}) after "
          f"{res.iterations} iterations, {lc['steps']} steps, {sum(res.cg_iterations)} CG "
          f"iterations; sigma0^2={res.sigma02:.6f} rms={res.rms:.4f}; last L1 "
          f"{', '.join(f'{d:.4g}' for d in res.delta_history[-4:])} [{card}]")
    if not (res.converged and np.isfinite(res.x).all() and 0.8 < res.sigma02 < 1.2):
        raise RuntimeError(f"[{tag}] FAIL: the float32 solve did not converge")
    return rows


def phase_posegraph(p, dev, card):
    """solve_posegraph on the bench block (4 blocks, the refine) at its
    default: over several cards a spawned process a card, the blocks' x
    bitwise the same blocks solved one after the other on cuda:0; at one
    card the blocks one after the other.  The launch counters after it:
    the blocks' plus the refine's.  Against a direct solve; then the
    CLI's posegraph on phase 13's dataset."""
    from fish_eye_bundle_adjustment_tpu_torch.parallel import posegraph

    tag = "18 posegraph"
    torch.cuda.synchronize()
    _reset_counts()
    schur.reset_cg_counts()
    t0 = time.perf_counter()
    pg = posegraph.solve_posegraph(p, n_blocks=4, refine=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = _read_counts()
    ran = {k: v for k, v in launches.items() if v}
    lc = dict(device_loop.loop_counts)
    runs, ref, st = pg.block_runs, pg.refined, pg.stage_s
    subs = [posegraph.extract_block(p, part) for part in posegraph.partition_images(p, 4)]
    eop = posegraph.merge_blocks(p, subs, pg.block_results)[0]
    print(f"[{tag}] solve_posegraph(n_blocks=4, refine=True) over "
          f"{torch.cuda.device_count()} card(s): wall {wall:.2f} s (partition "
          f"{st['partition']:.2f} s, blocks {st['blocks']:.2f} s, merge "
          f"{st['merge'] * 1e3:.1f} ms on the host, refine {st['refine']:.2f} s); blocks "
          + "; ".join(f"{r.problem.n_img} images on {d} {r.elapsed_s:.2f} s {r.iterations} it"
                      f"{'' if r.converged else ' NOT converged'}"
                      for r, d in zip(pg.block_results, runs.devices))
          + f"; {len(pg.edges)} edges [{card}]")
    if runs.startup_s:
        print(f"[{tag}] the block processes' start-up (spawn to ready: torch imported, "
              f"CUDA context, kernel library loaded): "
              f"{', '.join(f'{s:.2f}' for s in runs.startup_s)} s")
    print(f"[{tag}] refine: {ref.iterations} iterations ({ref.stopped_on}), driver "
          f"{'device loop (CUDA graph)' if lc.get('graph') else 'host loop'}, capture "
          f"{lc.get('capture_s', 0.0):.2f} s, {lc.get('steps')} steps, cg per step "
          f"{ref.cg_iterations}, GN loop {ref.elapsed_s:.2f} s, sigma0^2 {ref.sigma02:.9f}, "
          f"stds {ref.std_method} [{card}]")
    # the launches: each block's (moved in its process and added here), the
    # refine's device loop (warm-up + replays) and its stds (run again here)
    blocks = [_body_launches(m) for m in runs.moves]
    refine = _body_launches(lc.get("warmup", {}))
    for k, n in _kernels(lc.get("replayed", {})).items():
        refine[k] = refine.get(k, 0) + n
    _reset_counts()
    covariance.compute_stds(p, ref.layout, ref.x, ref.sigma02, device=dev)
    stds = {k: v for k, v in _read_counts()[0].items() if v}
    want = {}
    for part in (*blocks, refine, stds):
        for k, n in part.items():
            want[k] = want.get(k, 0) + n
    print(f"[{tag}] launches {ran} = the blocks' {blocks} + the refine's loop {refine} "
          f"+ its stds {stds}; plain versions {plain}")
    if ran != want or plain:
        raise RuntimeError(f"[{tag}] FAIL: launches {ran}, want {want}; plain {plain}")
    t0 = time.perf_counter()
    direct = schur.solve_schur(p, compute_covariance=False, device=dev)
    direct_s = time.perf_counter() - t0
    ties = np.abs(ref.x[ref.layout.tie_offset:] - direct.x[direct.layout.tie_offset:])
    print(f"[{tag}] direct solve (float64, device loop): {direct.iterations} iterations "
          f"({direct.stopped_on}) in {direct_s:.2f} s; the refine's tie coordinates within "
          f"{ties.max():.3e} of it (limit 1e-5), rms {ref.rms:.9f} vs {direct.rms:.9f} [{card}]")
    if not (all(r.converged for r in pg.block_results) and len(pg.edges) >= 3
            and np.array_equal(eop, pg.eop)
            and ref.converged and lc.get("graph") and ties.max() <= 1e-5
            and abs(ref.rms - direct.rms) <= 1e-6 * direct.rms
            and ref.std is not None and np.isfinite(ref.std).all()):
        raise RuntimeError(f"[{tag}] FAIL: the pose graph or its refine")
    if len(set(runs.devices)) > 1:
        # the same blocks one after the other on cuda:0, in this process
        serial, sruns = posegraph._solve_blocks(subs, None, schur.solve_schur,
                                                [torch.device("cuda", 0)])
        for i, (a, b) in enumerate(zip(pg.block_results, serial)):
            same = np.array_equal(a.x, b.x)
            print(f"[{tag}] block {i} on {runs.devices[i]} against cuda:0 in this process: x "
                  + ("bitwise equal" if same else
                     f"differs by {np.abs(a.x - b.x).max():.3e}")
                  + f"; {a.iterations} / {b.iterations} iterations; launches "
                  f"{blocks[i]} / {_body_launches(sruns.moves[i])}")
            if not (same and blocks[i] == _body_launches(sruns.moves[i])):
                raise RuntimeError(f"[{tag}] FAIL: block {i} differs across processes")

    # the CLI's posegraph on a copy of phase 13's dataset
    src = Path("chiprun_out") / "smoke_dense_cli" / "ds"
    folder = Path("chiprun_out") / "smoke_posegraph_cli" / "ds"
    shutil.rmtree(folder.parent, ignore_errors=True)
    folder.mkdir(parents=True)
    for f in src.iterdir():
        if f.suffix not in (".out", ".rsd", ".par"):
            shutil.copy(f, folder / f.name)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(folder, plot=False, solver="posegraph", blocks=2)
    cli_s = time.perf_counter() - t0
    written = [folder / f"{folder.name}.{ext}" for ext in ("out", "rsd", "par")]
    found = (re.search(r"A-Posteriori\.+([-\d.eE+]+)", written[0].read_text())
             if written[0].exists() else None)
    s02 = float(found.group(1)) if found else float("nan")
    print(f"[{tag}] cli.main({folder}, solver='posegraph', blocks=2): rc {rc} in {cli_s:.2f} s, "
          f"sigma0^2 {s02:.6f}, wrote {[w.name for w in written if w.exists()]} [{card}]")
    if rc != 0 or not all(w.exists() for w in written) or not 0.9 <= s02 <= 1.1:
        raise RuntimeError(f"[{tag}] FAIL: the posegraph CLI:\n{out.getvalue()[-2000:]}")


# BASELINE configs[5]: bench_tenk.py's block, and the JAX package's band plan
# of it and its observations (TENK_r05.json)
TENK_BLOCK = dict(n_img=10_000, n_pts=1_000_000, model="fisheye", seed=13, control_frac=0.01,
                  settings_overrides={"inner_constraints": False, "iteration_cap": 60})
TENK_N_OBS = 11_105_599
TENK_PLAN = dict(W=640, T=1792, G=7802, n_pad=11_106_048)
TENK_STEPS = 3


def phase_tenk(dev, card):
    """BASELINE configs[5]'s 10k-image block at its full size: the band
    plan against the JAX package's, K1 and K2 (matvec) at its shapes, then
    TENK_STEPS GN iterations of the fused float32 solve at 40 CG under the
    device loop.  Returns the kernel table's numbers and the solve's
    launches."""
    tag = "20 tenk"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p = make_block(**TENK_BLOCK).problem
    layout = ParamLayout(p)
    build_s = time.perf_counter() - t0
    opts = schur.SchurOptions(dtype=np.float32, cg_maxiter=40)
    t0 = time.perf_counter()
    plan = schur.make_band_plan(p, layout, opts)
    plan_s = time.perf_counter() - t0
    if plan is None:
        raise RuntimeError(f"[{tag}] FAIL: no band plan")
    got = {k: getattr(plan, k) for k in TENK_PLAN}
    print(f"[{tag}] make_block(10,000 images, 1,000,000 points, seed 13): {build_s:.1f} s on the "
          f"host; n_obs={p.n_obs} u={layout.u} n_tie={p.n_tie}; band plan {got} M={plan.M} "
          f"read amplification {plan.read_amplification:.3f} ({plan_s:.1f} s on the host); "
          f"TENK_r05.json: n_obs={TENK_N_OBS} {TENK_PLAN}")
    if p.n_obs != TENK_N_OBS or got != TENK_PLAN:
        raise RuntimeError(f"[{tag}] FAIL: the block or its band plan differs from the JAX "
                           f"package's")

    # K1 and K2 in matvec mode (the CG matvec's precision at this u) at these shapes
    t0 = time.perf_counter()
    kern = schur.SchurKernel(layout, opts)
    obs = schur.ObsData.from_problem(p, layout, plan, dtype=np.float32, device=dev)
    print(f"[{tag}] ObsData.from_problem (band plan, streams, the kernels' host index): "
          f"{time.perf_counter() - t0:.1f} s")
    x0 = torch.as_tensor(layout.initial().astype(np.float32), device=dev)
    fac = kern.linearize(x0 * layout.scale_like(x0), obs, lam=torch.zeros((), device=dev))
    band, ne, ni = obs.band, kern.ne, kern.ni
    _print_smem(tag, band.T, band.M, band.W, ne, "here")
    rng = np.random.default_rng(0)
    rnd = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32), device=dev)
    inputs = dict(vpose=rnd(8, band.n_img_pad), vi=rnd(128), a_rows=rnd(8, band.n_pad))
    cases = bench_torch_fusedmv.kernel_cases(fusedmv, band, fac, ne, ni, inputs)
    flops = bench_torch_fusedmv.kernel_flops(p.n_obs, plan.n_tie, ne, ni)
    inp = (fac.acam_t, fac.apt_t) + bench_torch_fusedmv.band_inputs(band)
    matvec = "fused_schur_apply/" + ("matvec_bf16" if kern.mv_precision == "bf16" else "matvec")
    print(f"[{tag}] the CG matvec's precision at u={layout.u}: {kern.mv_precision}")
    rows = {name: _check_fused(tag, name, cases[name], plan, ne, ni, inp, flops[name])
            for name in ("fused_hpp_pass", matvec)}
    del fac, cases, inputs, inp
    torch.cuda.empty_cache()

    def cost(x):
        x = torch.as_tensor(x.astype(np.float32), device=dev)
        return float(kern.residual_cost(x * layout.scale_like(x), obs))

    dof = p.n - layout.u
    c0 = cost(layout.initial())

    problem = dataclasses.replace(
        p, settings=dataclasses.replace(p.settings, iteration_cap=TENK_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    schur.reset_cg_counts()
    t0 = time.perf_counter()
    res = schur.solve_schur(problem, opts, compute_covariance=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, plain = _read_counts()
    ran = {k: v for k, v in launches.items() if v}
    lc = dict(device_loop.loop_counts)
    warm = _body_launches(lc.get("warmup", {}))
    replayed = _loop_launches(True, res.cg_iterations, opts.cg_maxiter)
    want = {k: warm.get(k, 0) + n for k, n in replayed.items()}
    steps = lc.get("steps", 0)
    c1 = cost(res.x)
    print(f"[{tag}] solve_schur(float32, cg_maxiter=40, {TENK_STEPS} iterations): "
          f"{res.iterations} iterations ({res.stopped_on}), {steps} steps, cg per step "
          f"{res.cg_iterations}, wall {wall:.2f} s (with the host's band plan and streams), "
          f"capture {lc.get('capture_s', 0.0):.2f} s, {lc.get('loop_s', 0.0) / max(steps, 1) * 1e3:.1f} "
          f"ms a replay (chunk loop {lc.get('loop_s', 0.0) * 1e3:.1f} ms), graph pools "
          f"+{lc.get('capture_reserved_bytes', 0) / 2**30:.2f} GiB reserved, peak mem "
          f"{peak:.2f} GiB [{card}]")
    print(f"[{tag}] sigma0^2 {c0 / dof:.6g} at x0 -> {c1 / dof:.6g} after {res.iterations} "
          f"iterations (weighted SSR / (n - u), n - u = {dof}); the solve's sigma0^2 "
          f"{res.sigma02:.6g}")
    print(f"[{tag}] launches {ran} = warm-up {warm} + replays {_kernels(lc.get('replayed', {}))} "
          f"(want {replayed} from the CG counts); plain versions {plain}")
    if not (lc.get("graph") and res.iterations == TENK_STEPS and np.isfinite(res.x).all()
            and np.isfinite(res.sigma02) and np.isfinite(c1) and c1 < c0):
        raise RuntimeError(f"[{tag}] FAIL: the solve, or sigma0^2 did not fall")
    if ran != want or plain:
        raise RuntimeError(f"[{tag}] FAIL: launches {ran}, want {want}; plain {plain}")
    return rows, ran, p


CLI10K_CAP = 3  # the .cfg's Iteration_Cap of phase 21's dataset (depth cut)


def phase_cli10k(p, dev, card):
    """The CLI's default route on BASELINE configs[5]'s block (phase 20's
    problem), the .cfg's cap cut to CLI10K_CAP: cli.main on the card with
    every default (bench_torch_cli.run_route and its checks), then K4 at
    the float64 solve's D = 6 shape on its stream.  Returns the K4 row
    and the route's launches."""
    from fish_eye_bundle_adjustment_tpu_torch.io import native

    tag = "21 cli10k"
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cli10k-") as root:
        folder = Path(root) / "ds"
        write_s = bench_torch_cli.write_dataset(p, folder, cap=CLI10K_CAP)
        print(f"[{tag}] synth.write_block of the 10k block ({p.n_obs} observations, "
              f"Iteration_Cap {CLI10K_CAP}): {write_s:.1f} s, .pho "
              f"{(folder / 'synth.pho').stat().st_size / 1e6:.0f} MB; the C++ .pho parser "
              f"{'built' if native.available() else 'NOT available'}")
        if not native.available():
            raise RuntimeError(f"[{tag}] FAIL: no native .pho parser (the Python reader "
                               f"would take its place)")
        torch.cuda.synchronize()
        _reset_counts()
        schur.reset_cg_counts()
        t0 = time.perf_counter()
        route = bench_torch_cli.run_route(folder)
        wall = time.perf_counter() - t0
        for st in route["stages"]:
            print(f"[{tag}] stage {st.name}: {st.seconds:.3f} s, peak "
                  f"{st.peak_bytes / 2**30:.2f} GiB, held at its end "
                  f"{st.held_bytes / 2**30:.2f} GiB")
        if route["result"] is None:
            raise RuntimeError(f"[{tag}] FAIL: cli.main returned {route['rc']}:\n"
                               f"{route['text'][-3000:]}")
        sm = bench_torch_cli.summarize(route)
        bad = bench_torch_cli.check(route, sm, folder)
        reports = {ext: (folder / f"ds.{ext}").stat().st_size / 1e6
                   for ext in ("out", "rsd", "par") if (folder / f"ds.{ext}").exists()}
    print(f"[{tag}] cli.main(plot=False) on the card: rc {sm['rc']} in {wall:.1f} s; "
          f"{sm['block']}; solver {sm['solver']}, {sm['driver']}: {sm['iterations']} "
          f"iterations ({sm['stopped_on']}), cg per step {sm['cg_per_step']}, sigma0^2 "
          f"{sm['sigma02']:.6f}, sum|delta| {sm['delta_history']}; capture "
          f"{sm['capture_s'] or 0.0:.2f} s, {sm['replay_ms'] or float('nan'):.1f} ms a "
          f"replay, graph pools "
          f"+{sm['capture_reserved_gib']:.2f} GiB; peak {sm['peak_gib']:.2f} GiB [{card}]")
    print(f"[{tag}] stds {sm['std_method']}: CG solves {sm['stds_cg_solves']} (want "
          f"{sm['stds_cg_solves_want']} in all), iterations {sm['stds_cg_iterations']}, "
          f"{sm['stds_cg_at_cap']} at the cap of 400, {sm['stds_cg_matvecs']} matvecs; "
          f"stds {sm['stds']}")
    print(f"[{tag}] launches {sm['launches']} (want {sm['launches_want']}); plain versions "
          f"{sm['plain_calls']}; reports {reports} MB, .rsd rows {sm.get('rsd_rows')}")
    if bad:
        raise RuntimeError(f"[{tag}] FAIL: " + "; ".join(bad))
    n = -(-p.n_obs // prefix.CHUNK) * prefix.CHUNK
    vals = torch.as_tensor(np.random.default_rng(21).standard_normal((n, 6)),
                           dtype=torch.float64, device=dev)
    k4 = _k4_check(tag, "float64 D=6", vals)
    k4["launches"] = sm["launches"]["chunk_prefix (solve)"]
    del vals
    torch.cuda.empty_cache()
    return k4, sm["launches"]


def main():
    card = phase_environment()
    dev = torch.device("cuda")
    phase_build()
    p, layout, opts, plan = phase_block()
    timings = phase_kernels(p, layout, opts, plan, dev)
    phase_reference(dev)
    counts, main_res = phase_main_path(p, layout, plan, dev)
    seg = phase_segment(p, layout, dev)
    phase_unfused_reference(dev)
    k4_count, res9 = phase_unfused_main_path(p, layout, dev)
    counts.update(k4_count)
    t0 = time.perf_counter()
    measured = phase_streamseg(dev) + phase_probes(dev)
    print(f"[11 probes] phases 10-11 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    measured.append(phase_unfused_img(p, layout, dev))
    print(f"[12 unfused img] phase 12 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_dense_cli(dev, card)
    print(f"[13 dense cli] phase 13 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    explicit_k4 = phase_explicit(dev, card)
    print(f"[14 explicit] phase 14 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stds_launches, stds_probe = phase_stds(p, layout, main_res, dev, card)
    measured.append(stds_probe)
    print(f"[15 stds] phase 15 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    shard_rows, shard_k4, stds_p, dist_out = phase_distributed(p, layout, main_res, res9, dev,
                                                               card)
    print(f"[16 distributed] phase 16 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    loop_rows = phase_device_loop(p, layout, main_res, res9, dev, card)
    print(f"[17 device loop] phase 17 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_posegraph(p, dev, card)
    print(f"[18 posegraph] phase 18 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    peer_coll, peer_launches = phase_peer(p, stds_p, card)
    print(f"[19 peer collectives] phase 19 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tenk_rows, tenk_launches, tenk_p = phase_tenk(dev, card)
    print(f"[20 tenk] phase 20 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli_k4, cli_launches = phase_cli10k(tenk_p, dev, card)
    del tenk_p
    print(f"[21 cli10k] phase 21 took {time.perf_counter() - t0:.1f} s")
    # K2 is timed in its hot mode (one launch per CG iteration, at the main
    # path's "bf16"), K4 at the width and type of the unfused path's CG image
    # sum (float64, D = 6);
    # each error is the largest over the kernel's modes or widths
    timings["chunk_prefix"] = seg["float64 D=6"]
    errs = {
        "fused_hpp_pass": [timings["fused_hpp_pass"]["max_abs_err"]],
        "fused_schur_apply": [v["max_abs_err"] for k, v in timings.items()
                              if k.startswith("fused_schur_apply")],
        "chunk_prefix": [v["max_abs_err"] for v in seg.values()],
    }
    table = []
    for name in ("fused_hpp_pass", "fused_schur_apply", "chunk_prefix"):
        t = timings[name if name in timings else f"{name}/matvec_bf16"]
        table.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=[REPLACES[name]],
            launches=counts[name], max_abs_err=max(errs[name]), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t.get("library_ms"),
        ))
    # the kernels of phases 14-15's paths: K4 on the explicit dense S's
    # pair products (D = 36) and tie IOP sums (D = 3 ni), float64, each
    # checked and timed at its own shape in phase 14, with the launches of
    # phase 14's solve at that width; K1 and K2 on the estimator's probe
    # solves (times of phase 4, the same
    # kernels at the same block's shapes; launches of phase 15)
    for d, r in sorted(explicit_k4.items(), reverse=True):
        table.append(dict(
            name=f"chunk_prefix/explicit D={d}", route="cuda", source=SOURCES["chunk_prefix"],
            replaces=[REPLACES["chunk_prefix"]], launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    for name in ("fused_hpp_pass", "fused_schur_apply"):
        t = timings[name if name in timings else f"{name}/matvec_bf16"]
        table.append(dict(
            name=f"{name}/stds", route="cuda", source=SOURCES[name], replaces=[REPLACES[name]],
            launches=stds_launches[name], max_abs_err=max(errs[name]), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t.get("library_ms"),
        ))
    # the kernels on phase 16's paths: K1 and K2 on a 4-card window of the
    # split band plan (the slowest window's times and bound; the errors the
    # largest over the windows and K2's modes; launches of the
    # fused_sharded solve), K4 under the distributed and sharded solves'
    # sums and the mesh estimator's (float32)
    k2_err = max(v["max_abs_err"] for k, v in shard_rows.items()
                 if k.startswith("fused_schur_apply"))
    for name, key in (("fused_hpp_pass", "fused_hpp_pass"),
                      ("fused_schur_apply", "fused_schur_apply/matvec_bf16")):
        r = shard_rows[key]
        table.append(dict(
            name=f"{name}/sharded", route="cuda", source=SOURCES[name],
            replaces=[REPLACES[name]], launches=r["launches"],
            max_abs_err=k2_err if name == "fused_schur_apply" else r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
        ))
    for label, r in shard_k4.items():
        table.append(dict(
            name=f"chunk_prefix/{label}", route="cuda", source=SOURCES["chunk_prefix"],
            replaces=[REPLACES["chunk_prefix"]], launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    # K1, K2 (the fused float32 solve) and K4 (the unfused float64 one)
    # under the device loop (phase 17): the launches of its solve, the
    # warm-up body's and those the replays ran (counted on the card); times
    # and errors of phases 4 and 7, the same kernels at the same block's
    # shapes
    for name in ("fused_hpp_pass", "fused_schur_apply", "chunk_prefix"):
        t = timings[name if name in timings else f"{name}/matvec_bf16"]
        table.append(dict(
            name=f"{name}/device_loop", route="cuda", source=SOURCES[name],
            replaces=[REPLACES[name]], launches=loop_rows[name]["launches"],
            max_abs_err=max(errs[name]), ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t.get("library_ms"),
        ))
    # the peer collectives: launches of phase 19's solves (and phase 16's over
    # several cards); times, bound and NCCL of phase 16 over several cards,
    # else of phase 19 (two ranks time-slicing one card: no NCCL), at the
    # float64 shape that stands for each (_coll_cases); the error the
    # largest over every case (0: bitwise)
    coll = dist_out.get("coll", peer_coll)
    for name in ("distributed", "sharded", "fused_sharded"):
        for key in (name, f"{name} device loop"):
            for k, v in dist_out[key]["launches"].items():
                if k.startswith("peer_"):
                    peer_launches[k] += v
            for k, v in dist_out[key].get("peer", {}).items():
                peer_launches[k] += v
    for k, v in dist_out["stds"]["peer"].items():
        peer_launches[k] += v
    for op in PEER_OPS:
        name = f"peer_{op}"
        r = next(r for r in coll if r["op"] == op and r["dtype"] == "float64")
        table.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=[REPLACES[name]],
            launches=peer_launches[name],
            max_abs_err=max(c["max_abs_err"] for c in coll + peer_coll if c["op"] == op),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], library=r["library"],
        ))
    # K1 and K2 on BASELINE configs[5]'s 10k-image block (phase 20): times,
    # bound and error at its shapes (K2 in the CG matvec's mode), launches of
    # its solve
    for name, r in tenk_rows.items():
        kernel = name.split("/")[0]
        table.append(dict(
            name=f"{kernel}/tenk", route="cuda", source=SOURCES[kernel],
            replaces=[REPLACES[kernel]], launches=tenk_launches[kernel],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        ))
    # the CLI's default route on the same block (phase 21): K4 under its
    # float64 solve (timed at D = 6 on its stream), K1 and K2 under its
    # Hutchinson estimate (the times of phase 20's shapes), launches of its run
    table.append(dict(
        name="chunk_prefix/cli10k", route="cuda", source=SOURCES["chunk_prefix"],
        replaces=[REPLACES["chunk_prefix"]], launches=cli_k4["launches"],
        max_abs_err=cli_k4["max_abs_err"], ms=cli_k4["ms"], plain_ms=cli_k4["plain_ms"],
        bound_ms=cli_k4["bound_ms"], bound_by=cli_k4["bound_by"],
        library_ms=cli_k4["library_ms"],
    ))
    for name, r in tenk_rows.items():
        kernel = name.split("/")[0]
        table.append(dict(
            name=f"{kernel}/stds10k", route="cuda", source=SOURCES[kernel],
            replaces=[REPLACES[kernel]], launches=cli_launches[f"{kernel} (stds)"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        ))
    for probe, r in measured:
        table.append(dict(
            name=f"{probe.kernel}/{probe.name}", route="cuda", source=SOURCES[probe.kernel],
            replaces=[probe.replaces], launches=r["launches"], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
