"""Times the fused Schur kernels of the PyTorch port on a CUDA card -- K1
(fused_hpp_pass) and K2 (fused_schur_apply: matvec, rhs + preconditioner,
back-substitution) -- on the 1k-image self-calibrating fisheye block of
bench.py, then drives the float32 fused solve for a few Gauss-Newton
iterations.

    python3 bench_torch_fusedmv.py [--root DIR] [--n-img 1000] [--n-pts 100000]
                                   [--iters 5] [--reps 20]

--root imports the package from another checkout (an unpacked `git
archive` of an earlier commit, say), so that two versions are timed in
one run on one card.  Imports nothing of JAX.  Per kernel and mode:
the relative error against the plain version, the median time
(utils/cudatime.cuda_ms), the device time per call of each CUDA kernel
the call launches (torch.profiler: the group kernel and the reduce), the
bound and the kernel's multiple of it, and the bytes of the kernels' host
index, which the bound leaves out: it counts only the function's own
inputs and outputs.  Then the wall of each GN iteration at 40 CG iterations.  The last line is
one JSON object with every number.  chip_smoke.py phase 4 uses the
functions here.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

SELFCAL = dict(
    estimate_c=True, estimate_xp=True, estimate_yp=True,
    estimate_radial=True, estimate_decent=True,
)
MODES = ("matvec", "rhs_precond", "backsub")


def kernel_cases(fusedmv, band, fac, ne, ni, inputs):
    """name -> (kind, kernel call, plain call, extra input tensors) for K1
    and the three K2 modes on one linearization, at the wrappers' default
    precision ("bf16x2"), and the K2 matvec at "bf16", the solver's CG
    matvec at u <= 600,000."""
    streams = (fac.acam_t, fac.apt_t)
    cases = {
        "fused_hpp_pass": (
            "hpp",
            lambda: fusedmv.fused_hpp_pass(band, *streams, ne, ni),
            lambda: fusedmv.fused_hpp_pass_ref(band, *streams, ne, ni),
            (),
        ),
    }
    modes = {
        "matvec": dict(vpose=inputs["vpose"], vi=inputs["vi"]),
        "matvec_bf16": dict(vpose=inputs["vpose"], vi=inputs["vi"], precision="bf16"),
        "rhs_precond": dict(a_rows=inputs["a_rows"], with_precond=True),
        "backsub": dict(vpose=inputs["vpose"], vi=inputs["vi"], a_rows=inputs["a_rows"]),
    }
    for mode, mkw in modes.items():
        cases[f"fused_schur_apply/{mode}"] = (
            "schur",
            lambda mkw=mkw: fusedmv.fused_schur_apply(
                band, *streams, fac.hpi_t, ne, ni, **mkw),
            lambda mkw=mkw: fusedmv.fused_schur_apply_ref(
                band, *streams, fac.hpi_t, ne, ni, **mkw),
            (fac.hpi_t, *(v for v in mkw.values() if hasattr(v, "data_ptr"))),
        )
    return cases


def kernel_flops(n_obs, n_tie, ne, ni):
    """Arithmetic of each case, per owned row from the kernels' code: K1 6
    Hpp sym columns + ne pose and ni IOP squares (4 flops each); K2 matvec
    the expansion a (4(ne + ni)), t and b (12 each), the pose and IOP rows
    of C'b (4(ne + ni)), and 18 per tie for y = Hpp^-1 t.  The injected
    residual rows add 2; rhs + preconditioner has no expansion but per row
    the pose block's B (9 ne), C (15 ne) and 10 per symmetric pair, and 4
    per IOP pair."""
    rows, nt = n_obs, n_tie
    npair, ipair = ne * (ne + 1) // 2, ni * (ni + 1) // 2
    matvec = rows * (24 + 8 * (ne + ni)) + 18 * nt
    return {
        "fused_hpp_pass": rows * (24 + 4 * ne + 4 * ni),
        "fused_schur_apply/matvec": matvec,
        "fused_schur_apply/matvec_bf16": matvec,
        "fused_schur_apply/rhs_precond": rows * (26 + 4 * (ne + ni) + 24 * ne
                                                 + 10 * npair + 4 * ipair) + 18 * nt,
        "fused_schur_apply/backsub": rows * (26 + 8 * (ne + ni)) + 18 * nt,
    }


def band_inputs(band):
    """The plan's tensors that are inputs of the function itself (the TPU
    kernel's too): the stream's tie and image ranks, each group's span,
    owned rows and image band."""
    return tuple(getattr(band, n) for n in ("rel", "imgrow", "sb", "fr", "er", "ib"))


def index_bytes(band):
    """Bytes of the host index that this package's kernels read beside the
    function's inputs (0 for a package without one)."""
    names = ("tie_off", "col_perm", "col_off", "cover_off", "cover_ids")
    return sum(t.numel() * t.element_size()
               for t in (getattr(band, n, None) for n in names) if t is not None)


def glue_reads(outs, plan, ne, ni, kind):
    """The slices of each output the solver glue reads, lanes summed."""
    nt, n_img = plan.n_tie, plan.n_img
    if kind == "hpp":
        hs, de, di = outs
        read = {"hs": hs[:6, :nt], "de": de[:ne, :n_img]}
        if ni:
            read["di"] = di[:ni].sum(1)
        return read
    read = {"pose": outs[0][:ne, :n_img], "y": outs[2][:3, :nt]}
    if ni:
        read["iop"] = outs[1][:ni].sum(1)
    if len(outs) == 5:
        read["p21"] = outs[3][: ne * (ne + 1) // 2, :n_img]
        if ni:
            read["i55"] = outs[4][: ni * (ni + 1) // 2].sum(1)
    return read


def split_ms(fn, reps=20):
    """{CUDA kernel name: device ms per call of fn()}, from torch.profiler
    over `reps` calls after one warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def group_reduce_split(times):
    """(group kernel ms, reduce ms) of a split_ms result."""
    group = sum(v for k, v in times.items() if "group_kernel" in k)
    reduce = sum(v for k, v in times.items() if "reduce_kernel" in k)
    return group, reduce


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None, help="checkout whose package to time")
    ap.add_argument("--n-img", type=int, default=1000)
    ap.add_argument("--n-pts", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from fish_eye_bundle_adjustment_tpu_torch.ops import _build, fusedmv
    from fish_eye_bundle_adjustment_tpu_torch.solver import schur
    from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
    from fish_eye_bundle_adjustment_tpu_torch.utils.cudatime import (
        HBM_BYTES_PER_S, bound, cuda_ms, rel_norm,
    )
    from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    root = os.path.dirname(os.path.dirname(fusedmv.__file__))
    print(f"[env] package {root}; torch {torch.__version__}; {card}")
    _build.load()
    print(f"[env] kernels {_build.library_path().name}")

    blk = make_block(
        n_img=args.n_img, n_pts=args.n_pts, model="fisheye", seed=2, control_frac=0.01,
        settings_overrides={"inner_constraints": False, **SELFCAL},
    )
    p = blk.problem
    layout = ParamLayout(p)
    opts = schur.SchurOptions(dtype=np.float32, cg_maxiter=40)
    plan = schur.make_band_plan(p, layout, opts)
    t0 = time.perf_counter()
    fusedmv.BandArrays.from_plan(plan, "cpu")
    host_s = time.perf_counter() - t0
    print(f"[block] n_obs={p.n_obs} G={plan.G} T={plan.T} W={plan.W} "
          f"BandArrays.from_plan {host_s * 1e3:.1f} ms on the host")
    kern = schur.SchurKernel(layout, opts)
    obs = schur.ObsData.from_problem(p, layout, plan, dtype=np.float32, device=dev)
    x0 = torch.as_tensor(layout.initial().astype(np.float32), device=dev)
    fac = kern.linearize(x0 * layout.scale_like(x0), obs, lam=torch.zeros((), device=dev))
    band, ne, ni = obs.band, kern.ne, kern.ni
    rng = np.random.default_rng(0)
    rnd = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32), device=dev)
    inputs = dict(vpose=rnd(8, band.n_img_pad), vi=rnd(128), a_rows=rnd(8, band.n_pad))
    flops = kernel_flops(p.n_obs, plan.n_tie, ne, ni)
    idx_b = index_bytes(band)
    print(f"[block] the kernels' host index: {idx_b / 1e6:.3f} MB on the card "
          f"({idx_b / HBM_BYTES_PER_S * 1e3:.4f} ms at the bound's memory rate; "
          f"not in the bound)")
    result = dict(card=card, package=root, n_obs=p.n_obs, host_index_ms=host_s * 1e3,
                  index_bytes=idx_b, kernels={})
    for name, (kind, kernel, plain, extra) in kernel_cases(
            fusedmv, band, fac, ne, ni, inputs).items():
        got = kernel()
        want = plain()
        g, w = glue_reads(got, plan, ne, ni, kind), glue_reads(want, plan, ne, ni, kind)
        err = max(rel_norm(g[k], w[k]) for k in w)
        ms = cuda_ms(kernel, args.reps)
        group, reduce = group_reduce_split(split_ms(kernel, args.reps))
        bound_ms, bound_by = bound((fac.acam_t, fac.apt_t, *band_inputs(band), *extra, *got),
                                   flops[name], torch.float32)
        r = dict(ms=ms, group_ms=group, reduce_ms=reduce, bound_ms=bound_ms,
                 bound_by=bound_by, x_bound=ms / bound_ms, rel_err=err)
        print(f"[kernels] {name}: {ms:.4f} ms (group kernel {group:.4f} + reduce "
              f"{reduce:.4f} ms on the device), bound {bound_ms:.4f} ms ({bound_by}; "
              f"{ms / bound_ms:.2f}x), rel err vs plain {err:.2e}")
        result["kernels"][name] = r
    del fac

    problem = dataclasses.replace(p, settings=dataclasses.replace(
        p.settings, iteration_cap=args.iters))
    walls = []

    def progress(rec):
        walls.append(rec.elapsed_s * 1e3)
        print(f"[gn] iter {rec.iteration}: wall={rec.elapsed_s * 1e3:.1f} ms"
              + ("" if rec.accepted else " REJECTED"))

    torch.cuda.synchronize()
    res = schur.solve_schur(problem, opts, compute_covariance=False, device=dev,
                            progress_fn=progress)
    torch.cuda.synchronize()
    print(f"[gn] iterations={res.iterations} cg per step={res.cg_iterations} "
          f"sigma0^2={res.sigma02:.6f}")
    result.update(iteration_walls_ms=walls, sigma02=res.sigma02,
                  cg_iterations=list(res.cg_iterations))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
