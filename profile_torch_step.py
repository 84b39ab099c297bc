"""Where one Gauss-Newton step of the PyTorch port spends its time on a
CUDA card, on the 1k-image self-calibrating fisheye block of bench.py.

    python3 profile_torch_step.py          # from the repository root

Imports nothing of JAX.  Three parts, each printing its own lines:

  dtype     the dtype of the raw forward-mode Jacobian blocks for float32
            inputs on the card: float64 would mean the tangents of the
            Jacobian pass run in f64
  chunks    an A/B of models.projection.JACOBIAN_CHUNK, 2^18 rows against
            its value, in the order A, B, B, A: per round, the median wall
            of the Jacobian pass (SchurKernel.blocks) and of a whole step
            over STEPS runs each, and peak device memory
  profile   torch.profiler over one step at the default chunk: the step's
            wall, the device's busy time (sum of the device kernels' time)
            and the top kernels by device time; the flags CG read back to
            the host and the matvecs it ran in that step

Each step starts from the same point with CG run to CG_ITERS iterations
(cg_tol 0, as chip_smoke.py's cg_maxiter), so every step does the same
work.  The last line is one JSON object with every number; the full
profiler table goes to chiprun_out/profile_torch_step.txt.
"""

import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.models import projection
from fish_eye_bundle_adjustment_tpu_torch.solver import schur
from fish_eye_bundle_adjustment_tpu_torch.synth import make_block
from fish_eye_bundle_adjustment_tpu_torch.utils.layout import ParamLayout

SELFCAL = dict(
    estimate_c=True, estimate_xp=True, estimate_yp=True,
    estimate_radial=True, estimate_decent=True,
)
STEPS = 10
CG_ITERS = 40
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


def _sync_wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def tangent_dtypes(kern, obs, q, rows=4096):
    """dtypes of the raw jacfwd blocks over the first `rows` observations,
    mapped as SchurKernel.blocks maps them."""
    eop, iop, pts = kern.layout.unpack_scaled(q)

    def raw(e, x, oxy):
        fn = lambda e_, i_, x_: projection.residual_obs(
            e_, i_, x_, oxy, obs.ydir_cam[0], kern.model_id, kern.nk)
        return torch.func.jacfwd(fn, argnums=(0, 1, 2))(e, iop[0], x)

    J = torch.func.vmap(raw)(eop[obs.img[:rows]], pts[obs.pt[:rows]], obs.xy[:rows])
    return [str(j.dtype) for j in J]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    blk = make_block(
        n_img=1000, n_pts=100_000, model="fisheye", seed=2, control_frac=0.01,
        settings_overrides={"inner_constraints": False, **SELFCAL},
    )
    p = blk.problem
    layout = ParamLayout(p)
    opts = schur.SchurOptions(dtype=np.float32, cg_maxiter=CG_ITERS)
    plan = schur.make_band_plan(p, layout, opts)
    kern = schur.SchurKernel(layout, opts)
    obs = schur.ObsData.from_problem(p, layout, plan, dtype=np.float32, device=dev)
    step = schur.schur_step_fn(kern, layout, p.settings.inner_constraints)
    x0 = torch.as_tensor(layout.initial().astype(np.float32), device=dev)
    q0 = x0 * layout.scale_like(x0)
    print(f"[block] n_obs={p.n_obs} u={layout.u} G={plan.G} T={plan.T} W={plan.W}")
    result = dict(card=card, torch=torch.__version__, n_obs=p.n_obs,
                  cg_iters=CG_ITERS)

    dtypes = tangent_dtypes(kern, obs, q0)
    print(f"[dtype] raw jacfwd blocks (J_eop, J_iop, J_pt) for float32 inputs: {dtypes}")
    result["jacfwd_dtypes"] = dtypes

    cg_counts = []

    def one_step():
        cg_counts.append(int(step(x0, obs, 0.0, 0.0)[4]))

    default_chunk = projection.JACOBIAN_CHUNK
    a, b = 1 << 18, default_chunk
    rounds = []
    for chunk in (a, b, b, a):
        projection.JACOBIAN_CHUNK = chunk
        one_step()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        jac = [_sync_wall_ms(lambda: kern.blocks(q0, obs)) for _ in range(STEPS)]
        steps = [_sync_wall_ms(one_step) for _ in range(STEPS)]
        r = dict(chunk=chunk, jacobian_ms=statistics.median(jac),
                 step_ms=statistics.median(steps),
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"[chunks] JACOBIAN_CHUNK={chunk}: Jacobian pass {r['jacobian_ms']:.1f} ms, "
              f"step {r['step_ms']:.1f} ms, peak {r['peak_gib']:.2f} GiB "
              f"(medians of {STEPS})")
        rounds.append(r)
    projection.JACOBIAN_CHUNK = default_chunk
    result["chunk_rounds"] = rounds
    print(f"[chunks] CG iterations per step: {sorted(set(cg_counts))}")
    result["cg_iterations_seen"] = sorted(set(cg_counts))

    one_step()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    schur.reset_cg_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _sync_wall_ms(one_step)
    cgc = dict(schur.cg_counts)
    events = prof.key_averages()
    # the device's own entries only: an aten:: operator also carries the
    # device time of the kernels it launched, which would count it twice
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_self = lambda e: e.self_device_time_total
    busy_ms = sum(dev_self(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_self, reverse=True)[:12]
    print(f"[profile] step wall {wall:.1f} ms (profiled), device busy {busy_ms:.1f} ms "
          f"in {sum(e.count for e in kernels)} kernel launches; CG read {cgc['host_reads']} "
          f"flags back to the host and ran {cgc['matvecs']} matvecs")
    for e in top:
        print(f"[profile] {dev_self(e) / 1e3:9.2f} ms {e.count:5d} calls  {e.key[:90]}")
    result["profile"] = dict(
        chunk=default_chunk, step_ms=wall, device_busy_ms=busy_ms,
        launches=sum(e.count for e in kernels), cg_host_reads=cgc["host_reads"],
        cg_matvecs=cgc["matvecs"],
        top=[dict(name=e.key, device_ms=dev_self(e) / 1e3, calls=e.count) for e in top])
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "profile_torch_step.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
