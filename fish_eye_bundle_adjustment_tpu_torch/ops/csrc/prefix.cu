// Chunk prefix for the scatter-free segment sums (K4), for Hopper (sm_90a),
// bound to PyTorch with ctypes.
//
// Replaces the Pallas TPU kernel fish_eye_bundle_adjustment_tpu/ops/attic/prefix.py
// `_kernel` (launched by chunk_prefix_pallas).  It computes what that kernel
// computes: for vals (N, D) row-major with N a multiple of 4096, the inclusive
// prefix of every column within each chunk of 4096 rows.  The chunk totals are
// the last row of each chunk, read by the caller as a strided view; the scan of
// the totals and the boundary gathers of the segment sum stay in PyTorch
// (ops/segment.py in this package).  The TPU kernel is a Hillis-Steele loop of
// log2(4096) shifted adds over a VMEM tile; that shape is not carried over.
//
// What bounds it on the H100: bytes.  One read and one write of N x D values and
// one add per value: at the 1k-image bench block (N = 1,032,192) a float64 call
// at D = 6 moves 99 MB, ~30 us at 3.35 TB/s, against 6.2M adds.
//
// Design, the simple one: one CTA per chunk, 256 threads, each owning 16
// consecutive rows.  Columns go in tiles of 16 bytes (4 floats or 2 doubles), so
// each thread holds its 16 x tile values in registers and reads and writes every
// value once.  Per tile: a serial sum of the thread's rows, a block-wide
// exclusive scan of the thread totals (warp shuffles, then the warp totals from
// shared memory), then the thread's running sums from its offset are written.
// No atomics and a fixed order of every addition, so a run repeats bit for bit.
// Later work: coalesced or TMA staging of the chunk (a warp's loads are 16 rows
// apart here) and more CTAs in flight (252 chunks fill the card's 132 SMs twice).

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 4096;
constexpr int kThreads = 256;
constexpr int kRows = kChunk / kThreads;  // consecutive rows per thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_prefix_kernel(const T* __restrict__ x, T* __restrict__ out, int d) {
  constexpr int kCols = 16 / sizeof(T);  // columns per tile
  __shared__ T warp_tot[kCols][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kChunk +
                      static_cast<size_t>(threadIdx.x) * kRows;
  const T* xs = x + row0 * d;
  T* os = out + row0 * d;

  for (int c0 = 0; c0 < d; c0 += kCols) {
    const int nc = min(kCols, d - c0);
    T v[kRows][kCols];
    T run[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) run[j] = T(0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        v[i][j] = j < nc ? xs[static_cast<size_t>(i) * d + c0 + j] : T(0);
        run[j] += v[i][j];
      }
    }

    // exclusive scan of the thread totals over the block, in thread order
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const T incl = warp_inclusive_scan(run[j], lane);
      T excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = T(0);
      if (lane == 31) warp_tot[j][warp] = incl;
      run[j] = excl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      T before = T(0);
      for (int w = 0; w < warp; ++w) before += warp_tot[j][w];
      run[j] = before + run[j];
    }
    __syncthreads();  // warp_tot is rewritten by the next tile

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        run[j] += v[i][j];
        if (j < nc) os[static_cast<size_t>(i) * d + c0 + j] = run[j];
      }
    }
  }
}

template <typename T>
int launch(const T* x, T* out, int n_chunks, int d, void* stream) {
  if (n_chunks < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return 0;
  chunk_prefix_kernel<T><<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int prefix_abi_version() { return 1; }

// x, out: (n_chunks * 4096, d) row-major, contiguous, distinct.
int prefix_chunk_f32(const float* x, float* out, int n_chunks, int d, void* stream) {
  return launch<float>(x, out, n_chunks, d, stream);
}

int prefix_chunk_f64(const double* x, double* out, int n_chunks, int d, void* stream) {
  return launch<double>(x, out, n_chunks, d, stream);
}

}  // extern "C"
