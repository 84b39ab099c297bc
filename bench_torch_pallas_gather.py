"""Twin of bench_pallas_gather.py on a CUDA card: the gather / scatter probes
A-F, each through the port's CUDA kernel (ops/probes.py).

    python3 bench_torch_pallas_gather.py [ABCDEF]     # from the repository root

The probe letters, sizes and the argument are the JAX script's (default
ABDF).  The TPU needed a separate strategy per probe; on Hopper A, B and C
(jnp.take, advanced indexing, a per-row loop) are one row-gather kernel, D
the gather-contract kernel, E and F the scatter kernels (F with its values
rounded to bf16, as the TPU kernel casts them).  Ids come from
np.random.default_rng(0) as in the JAX script; tables and values from
``normal``, which stands in for jax.random.normal with its one PRNGKey(0).

One line per probe: the kernel's time (median of CUDA events), its error
against the script's own numpy reference, the plain PyTorch version's time
and the time of one PyTorch call computing the same function
(torch.index_select for the gathers, Tensor.index_add_ for the scatters;
none for D).  Each kernel is also held against its plain version (the
gathers bitwise) and against itself on a second launch; a mismatch raises.
Runs on "cuda" and raises without a card.  Imports nothing of JAX.
"""

import sys

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import probes
from fish_eye_bundle_adjustment_tpu_torch.utils import cudatime

N = 1_048_576
N_IMG = 1024
CHUNK = 4096
SCRIPT = "bench_pallas_gather.py"
PALLAS_CALL = {"A": 58, "B": 83, "C": 111, "D": 144, "E": 189, "F": 232}
TOL = 1e-5  # kernel against its plain version, relative norm: only the order of sums differs


def normal(shape):
    """Standard normal float32 values from one fixed seed: the same shape
    gives the same values, as jax.random.normal(PRNGKey(0), shape) does."""
    return np.random.default_rng(0).standard_normal(shape).astype(np.float32)


def make_probes(dev, sel="ABDF", n=N):
    """The selected probes on `dev`, at the script's size (n rows)."""
    rng = np.random.default_rng(0)
    img_np = rng.integers(0, N_IMG, n).astype(np.int32)
    tab_np = normal((N_IMG, 8))
    ref = tab_np[img_np]
    img = torch.as_tensor(img_np, device=dev)
    tab = torch.as_tensor(tab_np, device=dev)
    where = lambda p: f"{SCRIPT}:{PALLAS_CALL[p]}"
    out = []
    for p in "ABC":
        if p in sel:
            out.append(cudatime.Probe(
                name=p, kernel="gather_rows", replaces=where(p),
                call=lambda: probes.gather_rows(img, tab),
                plain=lambda: probes.gather_rows_ref(img, tab),
                library=lambda: torch.index_select(tab, 0, img),
                inputs=(img, tab), flops=0, exact=True,
                ref=ref, ref_err="max_abs", ref_tol={},
            ))
    if "D" in sel:
        m_np = normal((n, 24))  # [e*4 + p] layout, e < 6, p < 4
        m = torch.as_tensor(m_np, device=dev)
        want = np.einsum("nep,ne->np", m_np.reshape(n, 6, 4), ref[:, :6])
        out.append(cudatime.Probe(
            name="D", kernel="gather_contract", replaces=where("D"),
            call=lambda: probes.gather_contract(img, m, tab),
            plain=lambda: probes.gather_contract_ref(img, m, tab),
            library=None, inputs=(img, m, tab), flops=2 * 24 * n, exact=False,
            ref=want, ref_err="max_abs", ref_tol=dict(rtol=1e-5, atol=1e-5),
        ))
    if "E" in sel or "F" in sel:
        vals_np = normal((n, 8))
        vals = torch.as_tensor(vals_np, device=dev)
        want = np.zeros((N_IMG, 8), np.float32)
        np.add.at(want, img_np, vals_np)
    if "E" in sel:
        out.append(cudatime.Probe(
            name="E", kernel="scatter_rows", replaces=where("E"),
            call=lambda: probes.scatter_rows(img, vals, N_IMG, CHUNK),
            plain=lambda: probes.scatter_rows_ref(img, vals, N_IMG, CHUNK),
            library=lambda: vals.new_zeros((N_IMG, 8)).index_add_(0, img, vals),
            inputs=(img, vals), flops=8 * n, exact=False,
            ref=want, ref_err="max_abs", ref_tol=dict(rtol=1e-4, atol=1e-4),
        ))
    if "F" in sel:
        out.append(cudatime.Probe(
            name="F", kernel="scatter_rows", replaces=where("F"),
            call=lambda: probes.scatter_rows(img, vals, N_IMG, CHUNK, round_bf16=True),
            plain=lambda: probes.scatter_rows_ref(img, vals, N_IMG, CHUNK, round_bf16=True),
            library=lambda: vals.new_zeros((N_IMG, 8)).index_add_(
                0, img, vals.to(torch.bfloat16).float()),
            inputs=(img, vals), flops=8 * n, exact=False,
            ref=want, ref_err="rel_max",
        ))
    return out


def main(sel="ABDF"):
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_pallas_gather.py needs a CUDA card")
    print(f"{torch.cuda.get_device_name(0)}: N={N} n_img={N_IMG} CHUNK={CHUNK}")
    for p in make_probes(torch.device("cuda"), sel):
        print(cudatime.line(p, cudatime.measure(p, TOL)))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "ABDF")
