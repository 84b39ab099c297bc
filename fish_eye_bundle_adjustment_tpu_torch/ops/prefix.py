"""Chunk prefix of a sorted stream (K4): a CUDA kernel and its plain version.

PyTorch port of fish_eye_bundle_adjustment_tpu/ops/attic/prefix.py.  The
JAX package keeps that Pallas kernel in attic/, off every path, because
XLA's cumsum beat it on a TPU v5e.  In the port it lies on the unfused
Schur path: every ``sorted_segment_sum`` (ops/segment.py) takes its
per-chunk prefix here, once.

    chunk_prefix(vals): vals (N, D), N % CHUNK == 0 ->
        (per-chunk inclusive prefix (N, D), chunk totals (N // CHUNK, D))

The chunk totals are the last row of each chunk, ``prefix[CHUNK-1::CHUNK]``
(a strided view).  Keeping per-chunk rather than global prefixes bounds
float32 cancellation by the chunk length, as in the JAX package.

``chunk_prefix`` dispatches on the device of its input: a CPU tensor runs
the plain PyTorch version (``chunk_prefix_ref``); any other goes to
``chunk_prefix_kernel``, which launches the hand-written kernel of
ops/csrc/prefix.cu (float32 or float64) and raises on anything it does
not take.  The kernel sums in a fixed order without atomics, so its
output repeats bit for bit.
"""

from __future__ import annotations

import torch

CHUNK = 4096

# Launch counts: the wrapper adds one where it launches the kernel
# (`kernel_launches`, and `kernel_launches_by_width` under the width D) or
# runs the plain version on the CPU (`plain_calls`).
kernel_launches = {"chunk_prefix": 0}
kernel_launches_by_width: dict = {}
plain_calls = {"chunk_prefix": 0}

_ENTRY = {torch.float32: "prefix_chunk_f32", torch.float64: "prefix_chunk_f64"}


def reset_counts() -> None:
    kernel_launches["chunk_prefix"] = 0
    kernel_launches_by_width.clear()
    plain_calls["chunk_prefix"] = 0


def chunk_prefix_ref(vals):
    """Plain version of the K4 kernel (see chunk_prefix)."""
    n, d = vals.shape
    prefix = vals.reshape(-1, CHUNK, d).cumsum(1).reshape(n, d)
    return prefix, prefix[CHUNK - 1 :: CHUNK]


def chunk_prefix_kernel(vals):
    """The K4 kernel on a CUDA tensor: (N, D) contiguous, N % CHUNK == 0,
    D >= 1, float32 or float64."""
    if vals.device.type != "cuda":
        raise ValueError(f"the chunk-prefix kernel takes a CUDA tensor, got {vals.device}")
    if vals.dim() != 2 or vals.shape[1] < 1:
        raise ValueError(
            f"the chunk-prefix kernel takes (N, D) with D >= 1, got {tuple(vals.shape)}"
        )
    if vals.dtype not in _ENTRY:
        raise ValueError(
            f"the chunk-prefix kernel takes float32 or float64, got dtype {vals.dtype}"
        )
    if not vals.is_contiguous():
        raise ValueError("the chunk-prefix kernel takes a contiguous tensor")
    n, d = vals.shape
    if n % CHUNK:
        raise ValueError(f"the chunk-prefix kernel takes N % {CHUNK} == 0, got N = {n}")
    from fish_eye_bundle_adjustment_tpu_torch.ops import _build

    lib = _build.load()
    smem = lib.prefix_smem_bytes(d, vals.element_size())
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"the chunk-prefix kernel stages its pieces of at least 4 rows of D = {d} "
            f"columns in {smem} bytes of shared memory; a block has {_build.SMEM_LIMIT}"
        )
    out = torch.empty_like(vals)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    code = getattr(lib, _ENTRY[vals.dtype])(
        vals.data_ptr(), out.data_ptr(), n // CHUNK, d, stream
    )
    _build.check(code, "chunk_prefix")
    kernel_launches["chunk_prefix"] += 1
    kernel_launches_by_width[d] = kernel_launches_by_width.get(d, 0) + 1
    return out, out[CHUNK - 1 :: CHUNK]


def chunk_prefix(vals):
    """(per-chunk inclusive prefix, chunk totals) of vals (N, D) with N a
    multiple of CHUNK: the plain version on the CPU, the kernel on a card."""
    if vals.device.type == "cpu":
        plain_calls["chunk_prefix"] += 1
        return chunk_prefix_ref(vals)
    return chunk_prefix_kernel(vals)
