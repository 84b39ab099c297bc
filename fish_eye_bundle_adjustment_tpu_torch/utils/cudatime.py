"""Kernel times on a CUDA card, their bounds, and the check of a kernel
against its plain version: shared by chip_smoke.py and the bench twins
(bench_torch_*.py).  Nothing here runs at import.

Bounds: the larger of the bytes of every input and output tensor once over
the memory rate and the arithmetic over the peak rate of its type -- 67
TFLOP/s float32 outside the tensor cores, 34 TFLOP/s float64, 3.35 TB/s
(H100 SXM data sheet).
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def bound(tensors, flops, dtype):
    """(bound_ms, bound_by): bytes of every input and output tensor once
    over the memory rate, against the arithmetic over the peak rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


SPIN_CYCLES = 40_000_000  # ~20 ms of the card's clock


def cuda_ms(fn, reps=20, warmup=3):
    """Median device time of fn() in ms, from CUDA events around each of
    `reps` calls.  The card first spins for SPIN_CYCLES, so the host
    queues every call (and its events) before the first one runs: the
    events then time the card's work, not the host's time to launch it,
    unless fn() itself waits for the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def rel_norm(got, want) -> float:
    """||got - want|| / ||want|| in float64 (0 for an empty or zero want)."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


@dataclasses.dataclass
class Probe:
    """One probe of a bench script: a kernel's wrapper on card tensors,
    what to hold it against, and what to time beside it."""

    name: str  # the JAX script's probe letter ("A" .. "F", "G", "S", "W", "P") or "K3"
    kernel: str  # the name of the kernel's entry in chip_smoke's kernel table
    replaces: str  # file:line of the pallas_call it stands for
    call: Callable[[], torch.Tensor]  # the kernel's wrapper
    plain: Callable[[], torch.Tensor]  # its plain version on the same tensors
    library: Optional[Callable[[], torch.Tensor]]  # one PyTorch call, same function
    inputs: tuple  # the kernel's input tensors, for the byte bound
    flops: float  # arithmetic of the function on these inputs
    exact: bool  # bitwise equal to the plain version (the gathers)
    ref: np.ndarray  # the JAX script's numpy reference of the probe's result
    # how the script prints its error: "max_abs"; "rel_max", over the
    # larger of max |ref| and 1; "rel_ref", over max |ref|
    ref_err: str
    ref_tol: Optional[dict] = None  # assert_allclose arguments where the script asserts
    finish: Optional[Callable] = None  # kernel output -> the probe's result

    def result(self, out=None):
        """The probe's result, as the JAX script's jitted function returns it."""
        out = self.call() if out is None else out
        return out if self.finish is None else self.finish(out)


def ref_error(p: Probe, got: np.ndarray) -> float:
    """The error the JAX script prints for its probe."""
    diff = np.abs(got.astype(np.float64) - p.ref.astype(np.float64))
    worst = float(diff.max()) if diff.size else 0.0
    if p.ref_err == "max_abs":
        return worst
    scale = float(np.abs(p.ref).max()) if p.ref.size else 0.0
    return worst / max(scale, 1.0 if p.ref_err == "rel_max" else 1e-30)


def measure(p: Probe, tol: float, reps: int = 20) -> dict:
    """Hold the kernel against its plain version (bitwise for an exact
    probe, else relative norm <= tol) and itself (bitwise, a second launch),
    the probe's result against the script's reference, then time kernel,
    plain version, library call and the whole probe.  Raises on any
    disagreement."""
    got, again, want = p.call(), p.call(), p.plain()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise RuntimeError(f"probe {p.name}: the kernel is not bitwise repeatable")
    if got.shape != want.shape:
        raise RuntimeError(f"probe {p.name}: shape {tuple(got.shape)} vs plain {tuple(want.shape)}")
    err = rel_norm(got, want)
    max_abs = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if p.exact and not torch.equal(got, want):
        raise RuntimeError(f"probe {p.name}: the gather is not bitwise equal to its plain version")
    if not err <= tol:
        raise RuntimeError(f"probe {p.name}: relative error {err:.3e} against its plain version > {tol}")
    out = p.result(got).cpu().numpy()
    if p.ref_tol is not None:
        np.testing.assert_allclose(out, p.ref, **p.ref_tol)
    res = dict(rel_err=err, max_abs_err=max_abs, ref_err=ref_error(p, out),
               ms=cuda_ms(p.call, reps), plain_ms=cuda_ms(p.plain, reps),
               library_ms=None if p.library is None else cuda_ms(p.library, reps),
               probe_ms=None if p.finish is None else cuda_ms(p.result, reps))
    res["bound_ms"], res["bound_by"] = bound((*p.inputs, got), p.flops, torch.float32)
    return res


def line(p: Probe, r: dict) -> str:
    """One printed line for a measured probe."""
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    whole = "" if r["probe_ms"] is None else f" whole probe {r['probe_ms']:.4f} ms"
    return (f"{p.name} {p.kernel}: kernel {r['ms']:.4f} ms{whole} plain {r['plain_ms']:.4f} ms "
            f"library {lib} bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"vs plain rel {r['rel_err']:.2e} max_abs {r['max_abs_err']:.2e}"
            f"{' (bitwise)' if p.exact else ''}; {p.ref_err} err vs the script's "
            f"numpy reference {r['ref_err']:.2e}")
