// Row gathers of the P1/P2 probes, for Hopper (sm_90a), bound to PyTorch with
// ctypes.  Two kernels:
//
// gather_rows_kernel: out[n] = tab[idx[n]], the function of five Pallas TPU
// kernels, each a different way around the TPU's lack of per-row dynamic
// indexing: bench_pallas_gather.py `take_kernel` (A, jnp.take), `adv_kernel`
// (B, advanced indexing), `loop_kernel` (C, a per-row loop) and
// bench_pallas_onehot.py `gather_kernel` (G, a one-hot MXU product) and
// `bcast_kernel` (P, a one-hot product over a window of table rows).  With a
// window (blk, W, chunk), row n of chunk c = n / chunk keeps P's semantics: an
// id outside [blk[c] * W, blk[c] * W + 2W) gives a zero row, as it matches no
// column of P's one-hot.  An id outside the table gives a zero row too (the
// kernel never reads out of bounds).  Hopper indexes per row natively, so the
// kernel only copies: its output is bitwise the table's rows.
//
// gather_contract_kernel: out[n, p] = sum_{e<6} M[n, 4e + p] * tab[idx[n], e],
// p < 4 -- bench_pallas_gather.py `fused_kernel` (D), a gather fused with the
// contraction of the real matvec's shape; M is (N, 24) in its [e * 4 + p]
// layout.  The sum runs over e in order, each product rounded before its add,
// as the TPU kernel's `acc = acc + m * vg` does.
//
// What bounds them on the H100: bytes.  A gather reads idx (4 B a row) and
// writes the row (32 B at 8 columns): at the scripts' size (N = 1,048,576,
// a (1024, 8) table) ~37.8 MB, ~11.3 us at 3.35 TB/s; the table stays in L2.
// D reads 96 B of M a row and writes 16 B: ~121.7 MB, ~36.3 us, against 50M
// flops.  Design: one thread per 16-byte quad of an output row (float4 loads
// and stores when the width is a multiple of 4, else one float a thread), and
// one thread per output row of D, reading M as six float4.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool row_ok(const int* __restrict__ idx, const int* __restrict__ blk,
                                       long long row, int n_tab, int win, int chunk, int* id) {
  *id = idx[row];
  bool ok = *id >= 0 && *id < n_tab;
  if (blk) {
    const long long lo = static_cast<long long>(blk[row / chunk]) * win;
    ok = ok && *id >= lo && *id < lo + 2LL * win;
  }
  return ok;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int* __restrict__ idx, const float* __restrict__ tab,
                   const int* __restrict__ blk, int n, int n_tab, int c, int win, int chunk,
                   float* __restrict__ out) {
  const int per_row = c / V;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(n) * per_row) return;
  const long long row = i / per_row;
  const int q = static_cast<int>(i % per_row) * V;
  int id;
  const bool ok = row_ok(idx, blk, row, n_tab, win, chunk, &id);
  if constexpr (V == 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) v = *reinterpret_cast<const float4*>(tab + static_cast<long long>(id) * c + q);
    *reinterpret_cast<float4*>(out + row * c + q) = v;
  } else {
    out[row * c + q] = ok ? tab[static_cast<long long>(id) * c + q] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
gather_contract_kernel(const int* __restrict__ idx, const float* __restrict__ m,
                       const float* __restrict__ tab, int n, int n_tab, int c,
                       float* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  int id;
  const bool ok = row_ok(idx, nullptr, row, n_tab, 0, 1, &id);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok) {
    const float4* mr = reinterpret_cast<const float4*>(m + row * 24);
    const float* t = tab + static_cast<long long>(id) * c;
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const float v = t[e];
      const float4 w = mr[e];
      acc.x = __fadd_rn(acc.x, __fmul_rn(w.x, v));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w.y, v));
      acc.z = __fadd_rn(acc.z, __fmul_rn(w.z, v));
      acc.w = __fadd_rn(acc.w, __fmul_rn(w.w, v));
    }
  }
  reinterpret_cast<float4*>(out)[row] = acc;
}

int blocks_for(long long threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

}  // namespace

extern "C" {

int gather_abi_version() { return 1; }

// idx (n,) int32; tab (n_tab, c) row-major; blk (n / chunk,) int32 or null;
// out (n, c) row-major.  Rows go as float4 when c % 4 == 0 and tab and out
// are 16-byte aligned, else one float a thread.
int gather_rows_f32(const int* idx, const float* tab, const int* blk, int n, int n_tab, int c,
                    int win, int chunk, float* out, void* stream) {
  if (n < 0 || n_tab < 1 || c < 1 || (blk && (win < 1 || chunk < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 4 == 0 && aligned16(tab) && aligned16(out)) {
    gather_rows_kernel<4><<<blocks_for(static_cast<long long>(n) * (c / 4)), kThreads, 0, s>>>(
        idx, tab, blk, n, n_tab, c, win, chunk, out);
  } else {
    gather_rows_kernel<1><<<blocks_for(static_cast<long long>(n) * c), kThreads, 0, s>>>(
        idx, tab, blk, n, n_tab, c, win, chunk, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// idx (n,) int32; m (n, 24) row-major, 16-byte aligned; tab (n_tab, c), c >= 6;
// out (n, 4), 16-byte aligned.
int gather_contract_f32(const int* idx, const float* m, const float* tab, int n, int n_tab, int c,
                        float* out, void* stream) {
  if (n < 0 || n_tab < 1 || c < 6 || !aligned16(m) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  gather_contract_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, m, tab, n, n_tab, c, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
