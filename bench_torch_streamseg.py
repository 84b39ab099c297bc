"""Twin of bench_streamseg.py on a CUDA card: the streaming segment sum (K3,
ops/streamseg.py) against the port's prefix-sum segment sum
(ops/segment.sorted_segment_sum, whose chunk prefix is K4), at the matvec's
shapes.

    python3 bench_torch_streamseg.py [--n 1048576] [--n-seg 100000] [--d 8] [--m 128]

Sizes, arguments and data are the JAX script's: ids and values from
np.random.default_rng(0) in its order.  Prints the plan's geometry, the
error of both segment sums against the script's numpy reference, then one
line for K3 -- the kernel's time on the transposed (D, N) stream (median of
CUDA events), its plain PyTorch version's, torch.segment_reduce's on the
same stream, the byte bound -- and the time of sorted_segment_sum on the
(N, D) stream.  K3 is also held against its plain version (relative norm
<= 1e-5) and against itself on a second launch; a mismatch raises.  Runs on
"cuda" and raises without a card.  Imports nothing of JAX.
"""

import argparse

import numpy as np
import torch

from fish_eye_bundle_adjustment_tpu_torch.ops import segment, streamseg
from fish_eye_bundle_adjustment_tpu_torch.utils import cudatime

TOL = 1e-5  # K3 against its plain version, relative norm: only the order of sums differs
REPLACES = "fish_eye_bundle_adjustment_tpu/ops/attic/streamseg.py:220"


def make_probe(dev, n=1_048_576, n_seg=100_000, d=8, m=128):
    """K3 at the script's shapes on `dev`: (probe, the (N, D) stream, its
    SegmentLayout, the plan)."""
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, n_seg, n)).astype(np.int32)
    starts = np.searchsorted(ids, np.arange(n_seg + 1)).astype(np.int32)
    layout = segment.SegmentLayout.from_sorted_ids(ids, n_seg, dev)
    plan = streamseg.GroupedSegPlan.build(starts[:-1], starts[1:], M=m)
    x_np = rng.standard_normal((n, d)).astype(np.float32)
    x = torch.as_tensor(x_np, device=dev)
    xt = x.T.contiguous()
    ref = np.zeros((n_seg, d), np.float32)
    np.add.at(ref, ids, x_np)
    lengths = torch.as_tensor(np.diff(starts).astype(np.int64), device=dev).expand(d, n_seg).contiguous()
    arrays = plan.on(dev)
    probe = cudatime.Probe(
        name="K3", kernel="span_segment_sum", replaces=REPLACES,
        call=lambda: streamseg.streaming_segment_sum_t(xt, plan),
        plain=lambda: streamseg.streaming_segment_sum_t_ref(xt, plan),
        library=lambda: torch.segment_reduce(xt, "sum", lengths=lengths, axis=1),
        inputs=(xt, arrays.rel, arrays.first_row, arrays.end_row), flops=n * d,
        exact=False, ref=ref.T, ref_err="rel_ref",
    )
    return probe, x, layout, plan


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--n-seg", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--m", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_streamseg.py needs a CUDA card")
    dev = torch.device("cuda")
    probe, x, layout, plan = make_probe(dev, args.n, args.n_seg, args.d, args.m)
    print(f"{torch.cuda.get_device_name(0)}: N={args.n} n_seg={args.n_seg} D={args.d}: "
          f"G={plan.G} T={plan.T} read_amplification={plan.read_amplification:.2f}")
    scale = max(float(np.abs(probe.ref).max()), 1e-30)
    for name, got in (("streaming kernel", streamseg.sorted_segment_sum_streaming(x, plan)),
                      ("K4 prefix segsum", segment.sorted_segment_sum(x, layout))):
        err = np.abs(got.cpu().numpy() - probe.ref.T).max() / scale
        print(f"{name} rel err vs numpy: {err:.2e}")
    t_k4 = cudatime.cuda_ms(lambda: segment.sorted_segment_sum(x, layout))
    print(f"K4 prefix segsum    (N,{args.d})  {t_k4:8.4f} ms")
    res = cudatime.measure(probe, TOL)
    print(f"K3 streaming kernel ({args.d},N)  {res['ms']:8.4f} ms ({t_k4 / res['ms']:.2f}x)")
    print(cudatime.line(probe, res))


if __name__ == "__main__":
    main()
