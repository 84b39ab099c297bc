// Span segment sum (K3 and probe W), for Hopper (sm_90a), bound to PyTorch with
// ctypes.
//
// Replaces two Pallas TPU kernels that compute one function:
//   * fish_eye_bundle_adjustment_tpu/ops/attic/streamseg.py `_kernel` (launched
//     by streaming_segment_sum_t): group g owns the rows [first_row, end_row) of
//     a sorted stream held transposed (D, N) and sums each row into the slot
//     rel = seg_id % M of its (D, M) output block;
//   * bench_pallas_onehot.py `wseg_kernel` (probe W): chunk c owns the rows
//     [c * CHUNK, (c + 1) * CHUNK) of a sorted (N, 8) stream and sums each row
//     into the slot id - base[c] of its (W, 8) partial, dropping rows whose slot
//     falls outside [0, W).
// Both are: block b owns the row span [r0[b], r1[b]) and S slots; slot(row) =
// ids[row] - s0[b] (s0 null: 0); rows whose slot is outside [0, S) add nothing.
// The TPU kernels build an (S, span) one-hot mask and contract it on the MXU;
// that shape is not carried over.  The stream's strides (row, column) and the
// output's strides (block, slot, column) are arguments, so one kernel reads
// K3's transposed stream and W's row-major one.
//
// Precondition: ids are non-decreasing inside each span (a sorted stream; K3's
// GroupedSegPlan and W's sorted ids guarantee it), so each slot's rows are one
// contiguous run.
//
// What bounds it on the H100: bytes.  One read of the span's ids and values and
// one write of the output: K3 at bench_streamseg.py's defaults (N = 1,048,576,
// D = 8, 100,000 segments) moves ~41 MB, ~12 us at 3.35 TB/s, against 8.4M adds.
//
// Design, the simple one: one CTA of 256 threads per block.  First the slot
// boundaries: lo[s] = the first row of the span whose slot is >= s, written in
// shared memory by the one row where the slot steps past s (a sorted stream
// has exactly one), so each slot's run is [lo[s], lo[s + 1]).  Then the span
// [lo[0], lo[S]) is streamed through shared memory in tiles of kTile rows,
// loaded with neighbouring threads on neighbouring addresses (rows of one
// column in the transposed layout, columns of one row in the row-major one),
// and each (slot, column) pair, owned by one thread, adds its run's rows of
// the tile in row order to its sum in shared memory.  No atomics and a fixed
// order of every addition (0 + the rows in stream order), so a run repeats bit
// for bit.  The span never has to fit in shared memory: K3's spans may reach
// 64K rows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // stream rows staged in shared memory per step

__device__ __forceinline__ int clamp_slot(int v, int S) { return min(max(v, -1), S); }

// shared memory: lo (S + 1) ints, tile (D, kTile) floats, acc (D, S) floats
__global__ void __launch_bounds__(kThreads)
span_sum_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                const int* __restrict__ r0s, const int* __restrict__ r1s,
                const int* __restrict__ s0s, int S, int D, long long row_stride,
                long long col_stride, long long out_block, long long out_slot,
                long long out_col, float* __restrict__ out) {
  extern __shared__ float smem[];
  int* lo = reinterpret_cast<int*>(smem);
  float* tile = smem + (S + 1);
  float* acc = tile + static_cast<size_t>(D) * kTile;
  const int b = blockIdx.x;
  const int r0 = r0s[b];
  const int r1 = r1s[b];
  const int s0 = s0s ? s0s[b] : 0;
  const int pairs = S * D;

  for (int s = threadIdx.x; s <= S; s += kThreads) lo[s] = r1;
  for (int p = threadIdx.x; p < pairs; p += kThreads) acc[p] = 0.f;
  __syncthreads();
  // slot boundaries (slots clamped to [-1, S], so lo[S] ends the last run)
  for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const int cur = clamp_slot(ids[r] - s0, S);
    const int prev = r == r0 ? -1 : clamp_slot(ids[r - 1] - s0, S);
    for (int s = max(prev + 1, 0); s <= cur; ++s) lo[s] = r;
  }
  __syncthreads();

  const int first = lo[0];
  const int last = lo[S];
  for (int t0 = first; t0 < last; t0 += kTile) {
    const int n = min(kTile, last - t0);
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      int r, d;
      if (row_stride == 1) {
        r = i % n;
        d = i / n;
      } else {
        d = i % D;
        r = i / D;
      }
      tile[d * kTile + r] = vals[static_cast<long long>(t0 + r) * row_stride + d * col_stride];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < pairs; p += kThreads) {
      const int s = p % S;
      const int d = p / S;
      const int a = max(lo[s], t0);
      const int e = min(lo[s + 1], t0 + n);
      float v = acc[p];
      for (int r = a; r < e; ++r) v += tile[d * kTile + (r - t0)];
      acc[p] = v;
    }
    __syncthreads();  // the next tile overwrites this one
  }

  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int s = p % S;
    const int d = p / S;
    out[b * out_block + s * out_slot + d * out_col] = acc[p];
  }
}

}  // namespace

extern "C" {

int streamseg_abi_version() { return 1; }

size_t streamseg_smem_bytes(int S, int D) {
  return (static_cast<size_t>(S) + 1) * sizeof(int) +
         (static_cast<size_t>(D) * kTile + static_cast<size_t>(S) * D) * sizeof(float);
}

// vals: the stream, element (row, column) at row * row_stride + column *
// col_stride; ids (rows,) int32; r0, r1, s0 (n_blocks,) int32 (s0 may be null);
// out: element (block, slot, column) at block * out_block + slot * out_slot +
// column * out_col, every element written.
int streamseg_span_sum(const float* vals, const int* ids, const int* r0, const int* r1,
                       const int* s0, int n_blocks, int S, int D, long long row_stride,
                       long long col_stride, long long out_block, long long out_slot,
                       long long out_col, float* out, void* stream) {
  if (n_blocks < 0 || S < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const size_t smem = streamseg_smem_bytes(S, D);
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        span_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (err) return err;
  }
  span_sum_kernel<<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      vals, ids, r0, r1, s0, S, D, row_stride, col_stride, out_block, out_slot, out_col, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
