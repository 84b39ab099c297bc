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
// moves 49.5 MB at D = 3, 99 MB at D = 6 and 347 MB at D = 21, 14.8 / 29.6 /
// 103.5 us at 3.35 TB/s, against 3.1M / 6.2M / 21.7M adds.
//
// Design.  One CTA of 256 threads per chunk; a chunk is one contiguous run of
// 4096 * D values, streamed through shared memory in pieces of P rows, in a
// ring of two stages.  One thread fills a stage with a single 1-D bulk
// asynchronous copy (cp.async.bulk, completing on an mbarrier), so the loads
// are whole contiguous spans and no sector is fetched twice; the next piece is
// in flight while the current one is scanned.  P is q * 256 rows with q odd and
// a stage of at most 48 KB (P = 768 at f64 D = 6, 256 at D = 21), so two CTAs
// fit an SM with ~40-90 KB in flight on it.  Each thread owns q consecutive
// rows of the piece; an odd q makes the lanes' row stride q * D odd for odd D
// (no bank conflicts) and keeps it at two ways for D = 6.  Per tile of 8
// columns: the thread's column sums over its rows (shared memory), a block-wide
// exclusive scan of them (warp shuffles, then the warp totals in order), and
// the running sums written back in place, offset by the column's carry from the
// previous pieces; the piece is then stored coalesced (consecutive threads on
// consecutive values) and the carry becomes its last row.  No atomics, and the
// order of every addition is fixed by D alone, so a run repeats bit for bit.
// A base address that is not 16-byte aligned is copied from the aligned
// 16-byte block below it, one block more, and read at its offset.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 4096;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;  // columns per block-wide scan
constexpr size_t kStageBudget = 48 * 1024;
constexpr size_t kStageMax = 100 * 1024;  // for D too wide for 256 rows in the budget
constexpr unsigned kFull = 0xffffffffu;

struct Plan {
  int rows;  // rows per piece: q * kThreads (q odd), or fewer than kThreads
  int q;     // consecutive rows per thread
  size_t stage_bytes;
  size_t smem;
};

size_t align16(size_t b) { return (b + 15) / 16 * 16; }

Plan make_plan(int d, int elem) {
  const size_t row = static_cast<size_t>(d) * elem;
  Plan p;
  int q = static_cast<int>(kStageBudget / (row * kThreads));
  if (q >= 1) {
    q = q > 15 ? 15 : q - (q % 2 == 0);  // odd, and P < kChunk
    p.q = q;
    p.rows = q * kThreads;
  } else {
    p.q = 1;
    p.rows = kThreads;
    while (p.rows > 4 && p.rows * row > kStageMax) p.rows /= 2;
  }
  p.stage_bytes = align16(p.rows * row + 16);  // + 16: room for a misaligned base
  p.smem = 16 + 2 * p.stage_bytes + static_cast<size_t>(d) * elem + 2 * kTile * kWarps * elem;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// smem: [2 mbarriers | stage 0 | stage 1 | carry (d) | warp totals (2 x kTile x kWarps)]
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_prefix_kernel(const T* __restrict__ x, T* __restrict__ out, int d, int rows, int q,
                    int stage_bytes, int mis) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + 16;
  T* carry = reinterpret_cast<T*>(stages + 2 * static_cast<size_t>(stage_bytes));
  T* wtot = carry + d;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * kChunk * d;
  const int n_pieces = (kChunk + rows - 1) / rows;
  const int row_bytes = d * static_cast<int>(sizeof(T));

  auto fetch = [&](int k) {  // piece k into stage k % 2
    const int r = min(rows, kChunk - k * rows);
    const char* src =
        reinterpret_cast<const char*>(x + base + static_cast<size_t>(k) * rows * d) - mis;
    bulk_load(stages + (k & 1) * static_cast<size_t>(stage_bytes), src,
              r * row_bytes + (mis ? 16 : 0), &bar[k & 1]);
  };

  if (t == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&bar[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = t; c < d; c += kThreads) carry[c] = T(0);
  __syncthreads();
  if (t == 0) {
    fetch(0);
    if (n_pieces > 1) fetch(1);
  }

  int buf = 0;  // warp-total buffer: alternates, so one barrier per tile suffices
  for (int k = 0; k < n_pieces; ++k) {
    const int r = min(rows, kChunk - k * rows);
    wait_parity(&bar[k & 1], (k >> 1) & 1);
    T* st = reinterpret_cast<T*>(stages + (k & 1) * static_cast<size_t>(stage_bytes) + mis);
    const int r0 = min(t * q, r), r1 = min(r0 + q, r);

    for (int c0 = 0; c0 < d; c0 += kTile) {
      const int nc = min(kTile, d - c0);
      T run[kTile], excl[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) run[j] = T(0);
#pragma unroll 3
      for (int i = r0; i < r1; ++i) {
        const T* row = st + static_cast<size_t>(i) * d + c0;
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          if (j < nc) run[j] += row[j];
      }
      T* wt = wtot + buf * kTile * kWarps;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (j < nc) {  // nc is the same in every thread
          const T incl = warp_inclusive_scan(run[j], lane);
          const T e = __shfl_up_sync(kFull, incl, 1);
          excl[j] = lane ? e : T(0);
          if (lane == 31) wt[j * kWarps + warp] = incl;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (j < nc) {
          T before = T(0);  // the warps before this one, in order
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            const T v = wt[j * kWarps + w];
            if (w < warp) before += v;
          }
          run[j] = carry[c0 + j] + (before + excl[j]);
        }
      }
#pragma unroll 3
      for (int i = r0; i < r1; ++i) {
        T* row = st + static_cast<size_t>(i) * d + c0;
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          if (j < nc) {
            run[j] += row[j];
            row[j] = run[j];
          }
        }
      }
      buf ^= 1;
    }
    __syncthreads();

    T* dst = out + base + static_cast<size_t>(k) * rows * d;
    const int n = r * d;
#pragma unroll 4
    for (int e = t; e < n; e += kThreads) dst[e] = st[e];
    for (int c = t; c < d; c += kThreads) carry[c] = st[static_cast<size_t>(r - 1) * d + c];
    __syncthreads();
    if (t == 0 && k + 2 < n_pieces) {
      // the stage was read and written by the threads; order that before the copy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(k + 2);
    }
  }
}

template <typename T>
int launch(const T* x, T* out, int n_chunks, int d, void* stream) {
  if (n_chunks < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return 0;
  const Plan p = make_plan(d, sizeof(T));
  if (p.smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        chunk_prefix_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem)));
    if (err) return err;
  }
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(x) % 16);
  chunk_prefix_kernel<T><<<n_chunks, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, d, p.rows, p.q, static_cast<int>(p.stage_bytes), mis);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int prefix_abi_version() { return 2; }

// Dynamic shared memory of a launch at width d and element size elem_size.
size_t prefix_smem_bytes(int d, int elem_size) { return make_plan(d, elem_size).smem; }

// x, out: (n_chunks * 4096, d) row-major, contiguous, distinct, aligned to
// their element.
int prefix_chunk_f32(const float* x, float* out, int n_chunks, int d, void* stream) {
  return launch<float>(x, out, n_chunks, d, stream);
}

int prefix_chunk_f64(const double* x, double* out, int n_chunks, int d, void* stream) {
  return launch<double>(x, out, n_chunks, d, stream);
}

}  // extern "C"
