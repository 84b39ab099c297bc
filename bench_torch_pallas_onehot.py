"""Twin of bench_pallas_onehot.py on a CUDA card: the one-hot probes G, S, W
and P, each through the port's CUDA kernel (ops/probes.py).

    python3 bench_torch_pallas_onehot.py [GSWP]     # from the repository root

The probe letters, sizes and the argument are the JAX script's (default
GSWP).  The TPU built a one-hot matrix per chunk and multiplied on the MXU;
Hopper indexes per row, so G (gather) and P (windowed gather over a sorted
id stream) are the row-gather kernel, S (per-chunk scatter partials) the
scatter kernel, and W (per-chunk windowed segment sums of a sorted stream)
the span segment-sum kernel of ops/streamseg.py.  As in the JAX script, S's
sum over chunks and W's combine run outside the kernel: S's in plain torch,
W's through a static sort plan and the K4 segment sum (no scatter), so both
repeat bit for bit.  Ids come from np.random.default_rng(0) in the JAX
script's order; tables and values from ``normal``, which stands in for
jax.random.normal with its one PRNGKey(0).

One line per probe: the kernel's time (median of CUDA events), with the
whole probe's (kernel and what runs outside it) for S and W, its error
against the script's own numpy reference, the plain PyTorch version's time
and the time of one PyTorch call computing the kernel's function
(torch.index_select, Tensor.index_add_, torch.segment_reduce).  W and P
first print the largest id span of a chunk beside W.  Each kernel is also
held against its plain version and against itself; a mismatch raises.
Runs on "cuda" and raises without a card.  Imports nothing of JAX.
"""

import sys

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import probes
from fish_eye_bundle_adjustment_tpu_torch.utils import cudatime

from bench_torch_pallas_gather import TOL, normal

N = 1_048_576
N_IMG = 1024
CHUNK = 2048
W = 256  # tie window per chunk (sorted stream; span/chunk ~207 at 2048)
N_TIE = 100_000
SCRIPT = "bench_pallas_onehot.py"
PALLAS_CALL = {"G": 67, "S": 105, "W": 174, "P": 244}


def _span(ids, chunk):
    """Largest id minus first id, plus one, over the chunks of a sorted stream."""
    ids = ids.astype(np.int64)
    first, last = ids[::chunk], ids[np.minimum(np.arange(chunk, len(ids) + chunk, chunk), len(ids)) - 1]
    return int((last - first).max()) + 1


def make_probes(dev, sel="GSWP", n=N):
    """The selected probes on `dev`, at the script's size (n rows), and the
    largest id span of a chunk for W and P ({letter: span})."""
    rng = np.random.default_rng(0)
    img_np = rng.integers(0, N_IMG, n).astype(np.int32)
    tab_np = normal((N_IMG, 8))
    img = torch.as_tensor(img_np, device=dev)
    tab = torch.as_tensor(tab_np, device=dev)
    where = lambda p: f"{SCRIPT}:{PALLAS_CALL[p]}"
    n_chunks = -(-n // CHUNK)
    out, spans = [], {}
    if "G" in sel:
        out.append(cudatime.Probe(
            name="G", kernel="gather_rows", replaces=where("G"),
            call=lambda: probes.gather_rows(img, tab),
            plain=lambda: probes.gather_rows_ref(img, tab),
            library=lambda: torch.index_select(tab, 0, img),
            inputs=(img, tab), flops=0, exact=True,
            ref=tab_np[img_np], ref_err="max_abs",
        ))
    if "S" in sel:
        vals_np = normal((n, 8))
        vals = torch.as_tensor(vals_np, device=dev)
        want = np.zeros((N_IMG, 8), np.float32)
        np.add.at(want, img_np, vals_np)
        key = torch.as_tensor(np.arange(n) // CHUNK * N_IMG + img_np, device=dev)
        out.append(cudatime.Probe(
            name="S", kernel="scatter_rows", replaces=where("S"),
            call=lambda: probes.scatter_rows(img, vals, N_IMG, CHUNK, partials=True),
            plain=lambda: probes.scatter_rows_ref(img, vals, N_IMG, CHUNK, partials=True),
            library=lambda: vals.new_zeros((n_chunks * N_IMG, 8)).index_add_(0, key, vals),
            inputs=(img, vals), flops=8 * n, exact=False,
            ref=want, ref_err="rel_max", finish=lambda parts: parts.sum(0),
        ))
    if "W" in sel:
        tie_np = np.sort(rng.integers(0, N_TIE, n).astype(np.int32))
        vals_np = normal((n, 8))
        vals_w = torch.as_tensor(vals_np, device=dev)
        want = np.zeros((N_TIE, 8), np.float32)
        np.add.at(want, tie_np, vals_np)
        plan = probes.WindowPlan.build(tie_np, N_TIE, CHUNK, W, dev)
        spans["W"] = _span(tie_np, CHUNK)
        # one segment per (chunk, window slot), in stream order; the library
        # call computes the partials only when no row falls past its window
        local = tie_np - np.repeat(tie_np[::CHUNK], CHUNK)[:n]
        lengths = np.bincount(np.arange(n) // CHUNK * W + local, minlength=n_chunks * W)
        library = None
        if spans["W"] <= W:
            lengths_t = torch.as_tensor(lengths, device=dev)
            library = lambda: torch.segment_reduce(vals_w, "sum", lengths=lengths_t, axis=0)
        out.append(cudatime.Probe(
            name="W", kernel="span_segment_sum", replaces=where("W"),
            call=lambda: probes.window_segment_partials(vals_w, plan),
            plain=lambda: probes.window_segment_partials_ref(vals_w, plan),
            library=library, inputs=(plan.base, plan.ids, vals_w), flops=8 * n, exact=False,
            ref=want, ref_err="rel_max", finish=lambda parts: probes.window_combine(parts, plan),
        ))
    if "P" in sel:
        tie_np = np.sort(rng.integers(0, N_TIE, n).astype(np.int32))
        # table padded so the last aligned 2-block window exists
        big_np = normal((N_TIE + 2 * W, 8))
        tie = torch.as_tensor(tie_np, device=dev)
        big = torch.as_tensor(big_np, device=dev)
        blk = torch.as_tensor((tie_np[::CHUNK] // W).astype(np.int32), device=dev)
        spans["P"] = _span(tie_np, CHUNK)
        out.append(cudatime.Probe(
            name="P", kernel="gather_rows", replaces=where("P"),
            call=lambda: probes.gather_rows(tie, big, (blk, W)),
            plain=lambda: probes.gather_rows_ref(tie, big, (blk, W)),
            library=lambda: torch.index_select(big, 0, tie),
            inputs=(blk, tie, big), flops=0, exact=True,
            ref=big_np[tie_np], ref_err="max_abs",
        ))
    return out, spans


def main(sel="GSWP"):
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_pallas_onehot.py needs a CUDA card")
    print(f"{torch.cuda.get_device_name(0)}: N={N} n_img={N_IMG} CHUNK={CHUNK} W={W}")
    found, spans = make_probes(torch.device("cuda"), sel)
    for p in found:
        if p.name in spans:
            print(f"  ({p.name} probe: max ids/chunk span = {spans[p.name]}, W = {W})")
        print(cudatime.line(p, cudatime.measure(p, TOL)))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "GSWP")
