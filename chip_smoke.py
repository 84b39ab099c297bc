"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Drives the port's two paths -- the float32 fused Schur Gauss-Newton
solve and the float64 unfused one -- on the 1k-image / 100k-point
self-calibrating fisheye block of bench.py, after building the CUDA
kernels from ops/csrc and holding each against its plain PyTorch version
at the block's shapes; then the paths of the JAX package's remaining
Pallas kernels, its bench scripts, through their twins
(bench_torch_streamseg.py, bench_torch_pallas_gather.py,
bench_torch_pallas_onehot.py) at those scripts' sizes.  Imports nothing
of JAX.  Phases:

  1. environment   torch / CUDA / nvcc versions, card name and power limit
  2. build         nvcc of ops/csrc/*.cu (fusedmv, prefix, streamseg,
                   gather, scatter), one process each, started together
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
                   cg_maxiter=40), compute_covariance=False,
                   device="cuda") for 5 GN iterations at the default
                   precisions; sigma0^2, CG counts, iteration walls, host
                   reads per CG call (one per block of 8 masked iterations
                   and one that stops), and the launch counts K1 = steps,
                   K2 = 2 * steps + the matvecs CG ran
  7. segment       K4 (chunk_prefix) against its plain version at the
                   block's stream length, D in {3, 6, 21}, float32 and
                   float64: relative norm error <= 1e-5 / 1e-12, bitwise
                   repeatable, median times of kernel, plain version and
                   torch.cumsum, the byte bound and the kernel's multiple
                   of it; sorted_segment_sum on the
                   card against the CPU at the block's tie and image axes
  8. unfused ref   a 12-image float64 block and a 24-image 3-camera float32
                   block solved unfused on the card and on the CPU
  9. unfused main  solve_schur(problem, SchurOptions(cg_maxiter=40),
                   compute_covariance=False, device="cuda") in float64 for
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
table has one entry per kernel of phases 4-9 and one per probe of
phases 10-11; `replaces` lists the pallas_call sites each stands for.
"""

import dataclasses
import inspect
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

import bench_torch_fusedmv
import bench_torch_pallas_gather
import bench_torch_pallas_onehot
import bench_torch_streamseg
from fish_eye_bundle_adjustment_tpu_torch.ops import (
    _build, fusedmv, prefix, probes, segment, streamseg,
)
from fish_eye_bundle_adjustment_tpu_torch.ops.bandplan import build_band_plan
from fish_eye_bundle_adjustment_tpu_torch.solver import schur
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
from fish_eye_bundle_adjustment_tpu_torch.utils.cudatime import (
    HBM_BYTES_PER_S, bound, cuda_ms, line, measure, rel_norm,
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
}
# the pallas_call each kernel of phases 4-9 stands for
REPLACES = {
    "fused_hpp_pass": "fish_eye_bundle_adjustment_tpu/ops/fusedmv.py:490",
    "fused_schur_apply": "fish_eye_bundle_adjustment_tpu/ops/fusedmv.py:607",
    "chunk_prefix": "fish_eye_bundle_adjustment_tpu/ops/attic/prefix.py:61",
}


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()


def phase_environment():
    print(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("[1 env] FAIL: torch.cuda.is_available() is false")
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"])
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
    lib = _build.load()
    caps = inspect.signature(build_band_plan).parameters
    cap_T, cap_W = caps["max_T"].default, caps["max_W"].default
    for T, M, W, where in ((band.T, band.M, band.W, "here"),
                           (cap_T, caps["M"].default, cap_W, "at the caps")):
        for which, label, smem in (
                (0, "K1 hpp_group_kernel", lib.fusedmv_hpp_smem_bytes(T, M)),
                (1, "K2 schur_group_kernel<false> (matvec, back-substitution)",
                 lib.fusedmv_schur_smem_bytes(T, M, W, ne, 1, 0, _build.SMEM_LIMIT)),
                (2, "K2 schur_group_kernel<true> (rhs + preconditioner)",
                 lib.fusedmv_schur_smem_bytes(T, M, W, ne, 0, 1, _build.SMEM_LIMIT))):
            occ = lib.fusedmv_occupancy(which, smem)
            print(f"[4 kernels] {label} {where}: {smem} bytes of dynamic shared memory "
                  f"at T={T}, M={M}, W={W}, ne={ne}, {occ} resident CTAs of 256 threads "
                  f"per SM")
            if not (smem <= _build.SMEM_LIMIT and occ >= 1):
                raise RuntimeError(f"[4 kernels] FAIL: {label} does not fit {where}")
    idx_b = bench_torch_fusedmv.index_bytes(band)
    print(f"[4 kernels] the kernels' host index: {idx_b} bytes on the card, read beside "
          f"the function's inputs and not counted in its bound "
          f"({idx_b / HBM_BYTES_PER_S * 1e3:.4f} ms at the bound's memory rate)")

    results = {}
    cases = bench_torch_fusedmv.kernel_cases(fusedmv, band, fac, ne, ni, inputs)
    for name, (kind, kernel, plain, extra) in cases.items():
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"[4 kernels] FAIL: {name} is not bitwise repeatable")
        g = bench_torch_fusedmv.glue_reads(got, plan, ne, ni, kind)
        w = bench_torch_fusedmv.glue_reads(want, plan, ne, ni, kind)
        errs = {}
        max_abs = 0.0
        for key in w:
            d = (g[key].double() - w[key].double())
            errs[key] = float(d.norm() / w[key].double().norm().clamp_min(1e-30))
            max_abs = max(max_abs, float(d.abs().max()))
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        print(f"[4 kernels] {name}: rel err "
              + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
              + f" max_abs={max_abs:.3e} bitwise-repeatable kernel {ms:.3f} ms"
              f" plain {plain_ms:.3f} ms")
        bad = {k: v for k, v in errs.items() if not v <= KERNEL_TOL}
        if bad:
            raise RuntimeError(f"[4 kernels] FAIL: {name} off its plain version: {bad}")
        results[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        results[name]["bound_ms"], results[name]["bound_by"] = bound(
            (*streams, *band_in, *extra, *got), flops[name], torch.float32)
        group, reduce = bench_torch_fusedmv.group_reduce_split(
            bench_torch_fusedmv.split_ms(kernel))
        print(f"[4 kernels] {name}: bound {results[name]['bound_ms']:.4f} ms "
              f"({results[name]['bound_by']}; kernel {ms / results[name]['bound_ms']:.2f}x); "
              f"on the device: group kernel {group:.4f} ms + reduce {reduce:.4f} ms")
    return results


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
    opts = schur.SchurOptions(dtype=np.float32, cg_maxiter=40)

    def progress(rec):
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
    return counts


def phase_segment(p, layout, dev):
    """K4 at the block's stream length, then sorted_segment_sum on the
    card against the CPU along the block's tie and image axes."""
    n = -(-p.n_obs // prefix.CHUNK) * prefix.CHUNK
    rng = np.random.default_rng(1)
    results = {}
    for dtype in (torch.float32, torch.float64):
        for d in (3, 6, 21):
            vals = torch.as_tensor(rng.standard_normal((n, d)), dtype=dtype, device=dev)
            got, tot = prefix.chunk_prefix(vals)
            again, _ = prefix.chunk_prefix(vals)
            want, want_tot = prefix.chunk_prefix_ref(vals)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise RuntimeError(f"[7 segment] FAIL: K4 {dtype} D={d} is not bitwise repeatable")
            diff = (got - want).double()
            rel = float(diff.norm() / want.double().norm())
            rel_tot = float((tot - want_tot).double().norm() / want_tot.double().norm())
            max_abs = float(diff.abs().max())
            ms = cuda_ms(lambda: prefix.chunk_prefix(vals))
            plain_ms = cuda_ms(lambda: prefix.chunk_prefix_ref(vals))
            library_ms = cuda_ms(lambda: torch.cumsum(vals.view(-1, prefix.CHUNK, d), dim=1))
            bound_ms, bound_by = bound((vals, got), vals.numel(), dtype)
            name = f"{str(dtype).split('.')[-1]} D={d}"
            print(f"[7 segment] K4 {name}: N={n} rel err {rel:.2e} (totals {rel_tot:.2e}) "
                  f"max_abs={max_abs:.3e} bitwise-repeatable kernel {ms:.4f} ms "
                  f"plain {plain_ms:.4f} ms torch.cumsum {library_ms:.4f} ms "
                  f"bound {bound_ms:.4f} ms ({bound_by}; kernel {ms / bound_ms:.2f}x)")
            if not (rel <= PREFIX_TOL[dtype] and rel_tot <= PREFIX_TOL[dtype]):
                raise RuntimeError(f"[7 segment] FAIL: K4 {name} off its plain version")
            results[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                 library_ms=library_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)
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
    opts = schur.SchurOptions(cg_maxiter=40)  # float64, explicit_s=None
    if problem.n_img <= opts.explicit_s_max_images:
        raise RuntimeError("[9 unfused] FAIL: the explicit-S gate would be on")

    def progress(rec):
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
    return {"chunk_prefix": k4}


def _reset_counts():
    for mod in (fusedmv, prefix, streamseg, probes):
        mod.reset_counts()


def _read_counts():
    """(kernel launches by wrapper, the sum of the plain versions' calls)."""
    mods = (fusedmv, prefix, streamseg, probes)
    launches = {k: v for mod in mods for k, v in mod.kernel_launches.items()}
    return launches, sum(sum(mod.plain_calls.values()) for mod in mods)


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


def main():
    card = phase_environment()
    dev = torch.device("cuda")
    phase_build()
    p, layout, opts, plan = phase_block()
    timings = phase_kernels(p, layout, opts, plan, dev)
    phase_reference(dev)
    counts = phase_main_path(p, layout, plan, dev)
    seg = phase_segment(p, layout, dev)
    phase_unfused_reference(dev)
    counts.update(phase_unfused_main_path(p, layout, dev))
    t0 = time.perf_counter()
    measured = phase_streamseg(dev) + phase_probes(dev)
    print(f"[11 probes] phases 10-11 took {time.perf_counter() - t0:.1f} s")
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
