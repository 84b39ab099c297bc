// Row scatter-add of the P1/P2 probes, for Hopper (sm_90a), bound to PyTorch
// with ctypes.  acc[idx[i]] += vals[i], exact float32, without atomics.
//
// Replaces three Pallas TPU kernels:
//   * bench_pallas_gather.py `scat_kernel` (E): a per-row loop adding each row
//     into a (n_tab, 8) table carried in VMEM across the sequential grid;
//   * bench_pallas_gather.py `onehot_scat_kernel` (F): the same through a bf16
//     one-hot MXU product, with the values cast to bf16 and f32 accumulation
//     (round_bf16 = 1 here: each value rounded to bf16, nearest even, first);
//   * bench_pallas_onehot.py `scatter_kernel` (S): per-chunk partial tables
//     (N / CHUNK, n_tab, 8) from a one-hot product; the sum over chunks runs
//     outside the kernel.
// The TPU's sequential grid carried one table from step to step; CTAs run in
// no order, so here each chunk of rows gets its own partial table
// (scatter_partials_kernel, serving S as it is) and a second kernel sums the
// partials over the chunks in chunk order (scatter_reduce_kernel, for E and F).
//
// What bounds it on the H100.  The function reads idx and vals once and writes
// the table: at the scripts' size (N = 1,048,576 rows of 8, n_tab = 1024)
// ~37.8 MB, ~11.3 us at 3.35 TB/s; with S's partials written out ~54.6 MB.
// This design, an ownership scan, compares every row's id with every table
// row: N * n_tab = 1.07e9 integer compares, which bound the kernel by
// operations, not bytes.
//
// Design, the simple one: one CTA of 1024 threads per chunk.  The chunk's ids
// go to shared memory (padded with -1 to a multiple of 4); each thread owns one
// table row j (and j + 1024, ... for larger tables), reads the ids four at a
// time as a broadcast, and adds the values of the rows whose id is j, in row
// order, to registers.  Every row has one owner, so vals are read once.  No
// atomics, and every sum is taken in a fixed order (rows in order inside a
// chunk, then the chunks in order), so a run repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kReduceThreads = 256;
constexpr int kMaxCols = 8;

__device__ __forceinline__ void add_row(float (&acc)[kMaxCols], const float* __restrict__ vals,
                                        long long row, int c, int round_bf16) {
#pragma unroll
  for (int d = 0; d < kMaxCols; ++d) {
    if (d < c) {
      float v = vals[row * c + d];
      if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
      acc[d] += v;
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
scatter_partials_kernel(const int* __restrict__ idx, const float* __restrict__ vals, int n,
                        int n_tab, int c, int chunk, int round_bf16,
                        float* __restrict__ partials) {
  extern __shared__ int4 sid4[];
  int* sid = reinterpret_cast<int*>(sid4);
  const int ch = blockIdx.x;
  const long long row0 = static_cast<long long>(ch) * chunk;
  const int rows = static_cast<int>(min(static_cast<long long>(chunk), n - row0));
  const int quads = (rows + 3) / 4;
  for (int r = threadIdx.x; r < 4 * quads; r += kScanThreads)
    sid[r] = r < rows ? idx[row0 + r] : -1;
  __syncthreads();

  for (int j = threadIdx.x; j < n_tab; j += kScanThreads) {
    float acc[kMaxCols];
#pragma unroll
    for (int d = 0; d < kMaxCols; ++d) acc[d] = 0.f;
    for (int q = 0; q < quads; ++q) {
      const int4 k = sid4[q];
      const long long r = row0 + 4 * q;
      if (k.x == j) add_row(acc, vals, r, c, round_bf16);
      if (k.y == j) add_row(acc, vals, r + 1, c, round_bf16);
      if (k.z == j) add_row(acc, vals, r + 2, c, round_bf16);
      if (k.w == j) add_row(acc, vals, r + 3, c, round_bf16);
    }
    float* dst = partials + (static_cast<long long>(ch) * n_tab + j) * c;
#pragma unroll
    for (int d = 0; d < kMaxCols; ++d)
      if (d < c) dst[d] = acc[d];
  }
}

// out[i] = sum over k of partials[k, i], k in order; i < width = n_tab * c
__global__ void __launch_bounds__(kReduceThreads)
scatter_reduce_kernel(const float* __restrict__ partials, int n_chunks, int width,
                      float* __restrict__ out) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= width) return;
  float s = 0.f;
  int k = 0;
  for (; k + 8 <= n_chunks; k += 8) {
    float v[8];  // eight loads in flight, added in order
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = partials[static_cast<long long>(k + u) * width + i];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; k < n_chunks; ++k) s += partials[static_cast<long long>(k) * width + i];
  out[i] = s;
}

}  // namespace

extern "C" {

int scatter_abi_version() { return 1; }

size_t scatter_smem_bytes(int chunk) { return static_cast<size_t>((chunk + 3) / 4) * 16; }

// idx (n,) int32; vals (n, c) row-major, 1 <= c <= 8; partials
// (ceil(n / chunk), n_tab, c) row-major, every element written.  Ids outside
// [0, n_tab) have no owner and add nothing.
int scatter_partials_f32(const int* idx, const float* vals, int n, int n_tab, int c, int chunk,
                         int round_bf16, float* partials, void* stream) {
  if (n < 0 || n_tab < 1 || c < 1 || c > kMaxCols || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const size_t smem = scatter_smem_bytes(chunk);
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        scatter_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
  }
  const int n_chunks = static_cast<int>((static_cast<long long>(n) + chunk - 1) / chunk);
  scatter_partials_kernel<<<n_chunks, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, vals, n, n_tab, c, chunk, round_bf16, partials);
  return static_cast<int>(cudaGetLastError());
}

// partials (n_chunks, width) row-major -> out (width,), n_chunks >= 0.
int scatter_reduce_f32(const float* partials, int n_chunks, int width, float* out, void* stream) {
  if (n_chunks < 0 || width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (width + kReduceThreads - 1) / kReduceThreads;
  scatter_reduce_kernel<<<blocks, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n_chunks, width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
