// Row scatter-add of the P1/P2 probes, for Hopper (sm_90a), bound to PyTorch
// with ctypes.  acc[idx[i]] += vals[i], float32, without atomics.
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
// What bounds it on the H100: bytes.  The function reads idx and vals once and
// writes the table: at the scripts' size (N = 1,048,576 rows of 8, n_tab =
// 1024) 37.8 MB, 11.3 us at 3.35 TB/s; with S's partials written out 54.6 MB,
// 16.3 us.  E and F also write their 256 partial tables (8.4 MB) and read them
// back in the reduce, ~5 us more.
//
// Design: O(rows) per chunk, one CTA of 512 threads per chunk of at most 8192
// rows.  (A thread per table row comparing it with every id of the chunk
// would do N * n_tab = 1.07e9 compares at the scripts' size and be bound by
// them; sorting the chunk's ids costs a few passes over its rows.)
//   1. Each thread reads its run of the chunk's ids and packs (id, row) into
//      one 32-bit key, the row in the low 13 bits and bit 13 set for a row that
//      adds nothing: an id outside [0, n_tab) (filed under id 0) or the
//      padding past the chunk's rows (filed under n_tab - 1, after every row).
//   2. cub::BlockRadixSort, stable, orders the keys on the id bits only (two
//      5-bit passes at n_tab = 1024), so the rows of one id stay in row order;
//      the sorted keys go to shared memory.
//   3. The sorted positions are cut into 256 even slices, one per pair of
//      lanes; lane h reads columns [4h, 4h + 4) of each position's row (one
//      16-byte load when c is 4 or 8: the pair reads the row's 32 bytes, one
//      sector, once), 4 rows in flight a lane, and adds the run of each id in
//      row order.  At 64 registers two CTAs share an SM; more rows in flight
//      cost that, and measured slower.  A run that ends in its slice is written; one that goes on
//      leaves its partial sum in shared memory, and the slice where it ends
//      adds the slices' partials in slice order, then its own: a run of a whole
//      chunk is summed in a fixed order by all the pairs.
//   4. The ids the chunk does not hold (a binary search of the sorted keys)
//      get zero rows, so every element of the partial table is written once.
// The reduce reads a tile of 256 chunks x 32 columns with one load round (32
// loads a thread in flight) into shared memory, and one warp adds it in chunk
// order.  Integer-only sorting, no atomics, and every sum in an order fixed by
// the data (rows in order within a slice, slices in order, then chunks in
// order), so a run repeats bit for bit.

#include <cub/block/block_radix_sort.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kQuads = 2;                    // lanes per position: columns 0-3 and 4-7
constexpr int kCols = 4 * kQuads;
constexpr int kSlices = kThreads / kQuads;   // slices of the sorted positions
constexpr int kRowBits = 13;                 // a chunk has at most 1 << 13 rows
constexpr int kMaxChunk = 1 << kRowBits;
constexpr unsigned kIdle = 1u << kRowBits;   // the row adds nothing
constexpr int kIdShift = kRowBits + 1;
constexpr int kMaxTable = 1 << (32 - kIdShift);  // ids fit the 18 bits above
constexpr int kRadixBits = 5;
constexpr int kBatch = 4;  // positions whose rows a lane has in flight
constexpr int kReduceCols = 32;
constexpr int kReduceWarps = 8;
constexpr int kReduceTile = 256;  // chunks per load round

template <int kItems>
struct Sorter {
  using Block = cub::BlockRadixSort<unsigned, kThreads, kItems, cub::NullType, kRadixBits>;
  // the sort's scratch, then the sorted keys in the same bytes
  static constexpr size_t kKeys = sizeof(typename Block::TempStorage) > kThreads * kItems * 4
                                      ? sizeof(typename Block::TempStorage)
                                      : kThreads * kItems * 4;
  static constexpr size_t kTails = (kKeys + 15) / 16 * 16;
  static constexpr size_t kSmem = kTails + kThreads * sizeof(float4);
};

// Columns [4h, 4h + 4) of a row (those below c; the rest 0): one 16-byte
// access when `vec` (c a multiple of 4, both arrays 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c, int h, bool vec) {
  if (vec) return h * 4 < c ? __ldg(reinterpret_cast<const float4*>(row) + h) : float4{};
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = 4 * h + j < c ? __ldg(row + 4 * h + j) : 0.f;
  return float4{x[0], x[1], x[2], x[3]};
}

__device__ __forceinline__ void store4(float* row, float4 v, int c, int h, bool vec) {
  if (vec) {
    if (h * 4 < c) reinterpret_cast<float4*>(row)[h] = v;
    return;
  }
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (4 * h + j < c) row[4 * h + j] = x[j];
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return float4{a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
}

// The first of keys[0, n) that is >= want (keys sorted).
__device__ __forceinline__ int lower_bound(const unsigned* keys, int n, unsigned want) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (keys[mid] < want) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int kItems>
__global__ void __launch_bounds__(kThreads, 2)
scatter_partials_kernel(const int* __restrict__ idx, const float* __restrict__ vals, int n,
                        int n_tab, int c, int chunk, int round_bf16, int vec,
                        float* __restrict__ partials) {
  using S = Sorter<kItems>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& temp = *reinterpret_cast<typename S::Block::TempStorage*>(smem);
  unsigned* skeys = reinterpret_cast<unsigned*>(smem);
  float4* tails = reinterpret_cast<float4*>(smem + S::kTails);  // [kSlices][kQuads]

  const int ch = blockIdx.x;
  const long long row0 = static_cast<long long>(ch) * chunk;
  const int rows = static_cast<int>(min(static_cast<long long>(chunk), n - row0));

  // 1. keys (id, idle, row), blocked: thread t holds rows t * kItems .. + kItems - 1
  unsigned keys[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int r = threadIdx.x * kItems + i;
    unsigned key = (static_cast<unsigned>(n_tab - 1) << kIdShift) | kIdle;  // padding: last
    if (r < rows) {
      const int v = idx[row0 + r];
      key = v >= 0 && v < n_tab ? static_cast<unsigned>(v) << kIdShift : kIdle;
    }
    keys[i] = key | static_cast<unsigned>(r);
  }
  // 2. stable sort on the id bits
  const int id_bits = n_tab > 1 ? 32 - __clz(n_tab - 1) : 1;
  typename S::Block sorter(temp);
  sorter.Sort(keys, kIdShift, kIdShift + id_bits);
  __syncthreads();  // the scratch becomes the sorted keys
#pragma unroll
  for (int i = 0; i < kItems; ++i) skeys[threadIdx.x * kItems + i] = keys[i];
  __syncthreads();

  // 3. runs of equal ids, per slice of sorted positions (all < rows: the
  // padding sorts last); lane h of the slice's pair takes columns [4h, 4h + 4)
  const int g = threadIdx.x / kQuads, h = threadIdx.x % kQuads;
  const int span = (rows + kSlices - 1) / kSlices;
  const int k0 = min(g * span, rows), k1 = min(k0 + span, rows);
  const float* src = vals + row0 * c;
  float* part = partials + static_cast<long long>(ch) * n_tab * c;
  unsigned prev = k0 > 0 ? skeys[k0 - 1] >> kIdShift : ~0u;  // ~0u: no row before
  bool from_before = k0 < k1 && k0 > 0 && prev == (skeys[k0] >> kIdShift);
  bool open = false;
  float4 acc{}, head{};
  unsigned head_key = ~0u;
  for (int kb = k0; kb < k1; kb += kBatch) {
    unsigned pk[kBatch];
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = kb + u;
      pk[u] = k < k1 ? skeys[k] : kIdle;
      const int row = static_cast<int>(pk[u] & (kMaxChunk - 1));
      v[u] = pk[u] & kIdle ? float4{} : load4(src + row * c, c, h, vec);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = kb + u;
      if (k >= k1) break;
      const unsigned key = pk[u] >> kIdShift;
      float4 x = v[u];
      if (round_bf16) x = float4{bf16_round(x.x), bf16_round(x.y), bf16_round(x.z), bf16_round(x.w)};
      const bool starts = key != prev;
      if (starts) from_before = false;
      acc = starts ? x : add4(acc, x);
      const bool ends = k + 1 == rows || (skeys[k + 1] >> kIdShift) != key;
      if (ends && from_before) {  // began in an earlier slice: finished below
        head = acc;
        head_key = key;
        from_before = false;
      } else if (ends) {
        store4(part + static_cast<int>(key) * c, acc, c, h, vec);
      }
      open = !ends;
      prev = key;
    }
  }
  if (open) tails[g * kQuads + h] = acc;
  __syncthreads();

  // 4. a run that began in an earlier slice: the slices' partials in order
  if (head_key != ~0u) {
    const int lo = lower_bound(skeys, k0, head_key << kIdShift);  // the run's first position
    float4 s = tails[(lo / span) * kQuads + h];
    for (int sl = lo / span + 1; sl < g; ++sl) s = add4(s, tails[sl * kQuads + h]);
    store4(part + static_cast<int>(head_key) * c, add4(s, head), c, h, vec);
  }
  // 5. zero rows for the ids the chunk does not hold
  for (int j = g; j < n_tab; j += kSlices) {
    const int at = lower_bound(skeys, rows, static_cast<unsigned>(j) << kIdShift);
    if (at == rows || (skeys[at] >> kIdShift) != static_cast<unsigned>(j))
      store4(part + j * c, float4{}, c, h, vec);
  }
}

// out[i] = sum over k of partials[k, i], k in order; i < width = n_tab * c.
// A CTA takes 32 columns; per tile of 256 chunks every warp loads 32 rows of
// them, then warp 0 adds the tile's rows in order.
__global__ void __launch_bounds__(kReduceCols * kReduceWarps)
scatter_reduce_kernel(const float* __restrict__ partials, int n_chunks, int width,
                      float* __restrict__ out) {
  __shared__ float tile[kReduceTile][kReduceCols];
  constexpr int kPer = kReduceTile / kReduceWarps;
  const int lane = threadIdx.x % kReduceCols, w = threadIdx.x / kReduceCols;
  const int i = blockIdx.x * kReduceCols + lane;
  float s = 0.f;
  for (int k0 = 0; k0 < n_chunks; k0 += kReduceTile) {
    const int nk = min(kReduceTile, n_chunks - k0);
    float v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = w + u * kReduceWarps;
      v[u] = k < nk && i < width ? partials[static_cast<long long>(k0 + k) * width + i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) tile[w + u * kReduceWarps][lane] = v[u];
    __syncthreads();
    if (w == 0) {
#pragma unroll 16
      for (int k = 0; k < nk; ++k) s += tile[k][lane];
    }
    __syncthreads();
  }
  if (w == 0 && i < width) out[i] = s;
}

template <int kItems>
int launch_partials(const int* idx, const float* vals, int n, int n_tab, int c, int chunk,
                    int round_bf16, float* partials, cudaStream_t stream) {
  const int vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(partials) % 16 == 0;
  constexpr size_t smem = Sorter<kItems>::kSmem;
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        scatter_partials_kernel<kItems>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
  }
  const int n_chunks = static_cast<int>((static_cast<long long>(n) + chunk - 1) / chunk);
  scatter_partials_kernel<kItems><<<n_chunks, kThreads, smem, stream>>>(
      idx, vals, n, n_tab, c, chunk, round_bf16, vec, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int scatter_abi_version() { return 2; }

int scatter_max_chunk() { return kMaxChunk; }

int scatter_max_table() { return kMaxTable; }

// idx (n,) int32; vals (n, c) row-major, 1 <= c <= 8; partials
// (ceil(n / chunk), n_tab, c) row-major, every element written.  Ids outside
// [0, n_tab) add nothing.  chunk <= scatter_max_chunk(), n_tab <=
// scatter_max_table().
int scatter_partials_f32(const int* idx, const float* vals, int n, int n_tab, int c, int chunk,
                         int round_bf16, float* partials, void* stream) {
  if (n < 0 || n_tab < 1 || n_tab > kMaxTable || c < 1 || c > kCols || chunk < 1 ||
      chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (chunk <= kThreads * 2)
    return launch_partials<2>(idx, vals, n, n_tab, c, chunk, round_bf16, partials, s);
  if (chunk <= kThreads * 4)
    return launch_partials<4>(idx, vals, n, n_tab, c, chunk, round_bf16, partials, s);
  if (chunk <= kThreads * 8)
    return launch_partials<8>(idx, vals, n, n_tab, c, chunk, round_bf16, partials, s);
  return launch_partials<16>(idx, vals, n, n_tab, c, chunk, round_bf16, partials, s);
}

// partials (n_chunks, width) row-major -> out (width,), n_chunks >= 0.
int scatter_reduce_f32(const float* partials, int n_chunks, int width, float* out, void* stream) {
  if (n_chunks < 0 || width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (width + kReduceCols - 1) / kReduceCols;
  scatter_reduce_kernel<<<blocks, kReduceCols * kReduceWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(partials, n_chunks, width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
