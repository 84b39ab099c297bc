// The mesh's three collectives over peer memory, for Hopper (sm_90a), bound
// to PyTorch with ctypes (ops/peercoll.py).
//
// No TPU kernel stands behind this file.  The JAX package's parallel solvers
// sum and gather over its device mesh with XLA's psum, psum_scatter and
// all_gather (fish_eye_bundle_adjustment_tpu/parallel/mesh.py), inside the
// lax.while_loops of its device loop.  The port captures a GN step as a CUDA
// graph whose CG blocks and step sit under IF nodes (graphcond.cu), and a
// conditional body graph may hold kernel nodes but not the event and host
// nodes that NCCL adds between ranks.  So the collectives are kernels of the
// port's own, over the other ranks' memory (NVLink between cards, the same
// memory between two processes on one card):
//
//   all-reduce      x (n) on every rank -> the sum over the ranks, n
//   reduce-scatter  x (size, m) on every rank -> row `rank` of the sum, m
//   all-gather      x (m) on every rank -> (size, m), row q rank q's x
//
// for float32 and float64.  Every column is summed in rank order 0, 1, ...,
// size - 1 by one CTA of one rank (no atomics), and every rank copies that
// one result, so every rank holds the same bits, and so does the plain
// version (a gather, then the sum in that order).
//
// Memory.  Each rank owns one cudaMalloc'd region: a flag array (kMaxBlocks
// x kMaxRanks u64) and two halves of `half_bytes` each, exported with
// cudaIpcGetMemHandle and opened by every other rank (cudaIpcOpenMemHandle,
// lazy peer access); the handles travel over the process group
// (ops/peercoll.py).  The half is what bounds one launch: the wrapper sizes
// it (96 MiB, so that BASELINE configs[5]'s tie sums, 23.5 MB a rank in
// float64, reduce-scatter over 4 ranks in one launch: 2 x 96 MiB of the
// card's 80 GB a rank) and cuts a larger call into chunks, a launch each.
//
// Three schedules, picked by the wrapper for each call:
//   pull      (the all-gather; one shot) each CTA copies its share
//             of x into this rank's half, meets, then reads that share from
//             every rank's half (remote loads) and places it.  For the sums
//             remote loads lost to remote stores at every size measured
//             over 4 H100s (PERF.md), so they push.
//   push      (the reduce-scatter; the all-reduce below the two-shot
//             threshold, where row q of x is x itself) rank r stores row q
//             of x straight into slot r of rank q's inbox (remote stores:
//             each byte crosses the link once, and the sender does not wait
//             for it), the flags, then every rank sums its slots in rank
//             order from local memory (its own row from x).
//   two-shot  (the all-reduce above it) shot 1 pushes column slice q of x
//             into slot r of rank q's inbox; rank q sums its slice in rank
//             order, writes it out and pushes it into every rank's result
//             area; shot 2's flags; every rank copies the other slices out
//             of its result area.  A rank sends 2 (size - 1) / size x the
//             bytes, where one-shot sends (size - 1) x.
// A CTA takes the same 16-byte aligned share of every range on every rank
// (16-byte loads and stores where the pointers allow, a scalar tail), and
// meets CTA b of every rank: after a barrier of the CTA, thread q < size
// releases the shot's flag value into rank q's flag [b][rank]
// (st.release.sys: the CTA's stores before the barrier are visible to whoever
// acquires the flag), then acquires its own flag [b][q] (ld.acquire.sys)
// until it reaches the value.  CTA b waits for CTA b of
// every peer, so the wrapper keeps the whole grid resident in one wave
// (peercoll_max_grid: at most two CTAs an SM).
//
// Epochs.  Replays of a captured launch repeat its arguments, so the call's
// number cannot be one: each rank keeps kMaxBlocks counters in device
// memory, all equal, and every launch advances all of them by one (CTA b
// the slots b, b + grid, ...), so a CTA reads the call's number e from its
// own slot whatever the grid.  Shot 1 meets at flag value 2e - 1, shot 2 at
// 2e.  The half a call uses is e's parity.  A rank writes into a half only
// two calls later: to start call e + 2 it must have met every rank in call
// e + 1, whose launch began after their launch of call e had ended (the
// calls of one communicator are stream-ordered), so nobody reads the half
// any more.  The wait is bounded by %globaltimer: past `limit_ns` the CTA
// marks the communicator dead (a word in device memory, which the other
// CTAs and every later launch read, and return at once) and sets the error
// word (host-mapped memory, 1 + the rank it waited for).  The wrapper reads
// the error word and raises; it never hangs.
//
// What bounds a call on the H100: for the solvers' small calls (the step's
// stats, camera vectors of ~7k values, 36 x n_img Hcc blocks) the launch and
// one flag round trip over NVLink, ~10 us over 4 cards, which a second shot
// would lengthen by ~5 us: so the all-reduce stays one-shot up to the
// wrapper's threshold (768 KiB), past which the bytes two-shot saves pay for
// it.  For the tie sums (2.4 MB at the bench block, 23.5 MB at configs[5])
// the bytes a rank must send over its links at 450 GB/s each way: 2 (size -
// 1) / size x the bytes for the all-reduce, (size - 1) / size x the input for
// the reduce-scatter; the kernels carry ~270-310 GB/s (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kMaxBlocks = 264;  // two CTAs on each of the H100's 132 SMs
constexpr int kMaxPerSm = 2;
constexpr int kThreads = 512;
constexpr size_t kFlagBytes = 32768;  // kMaxBlocks * kMaxRanks * 8 = 16,896, padded
constexpr size_t kHandleBytes = sizeof(cudaIpcMemHandle_t);

static_assert(kMaxBlocks * kMaxRanks * sizeof(unsigned long long) <= kFlagBytes, "flags");
static_assert(kHandleBytes == 64, "a CUDA IPC handle is 64 bytes");

enum Op { kAllReduce = 0, kReduceScatter = 1, kAllGather = 2 };
enum Schedule { kPull = 0, kPush = 1, kTwoShot = 2 };

struct Comm {
  int device;
  int rank;
  int size;
  int max_grid;
  size_t half_bytes;
  long long limit_ns;
  char* base;                   // this rank's region: flags, then two halves
  char* peer[kMaxRanks];        // every rank's region as mapped here
  unsigned long long* epochs;   // kMaxBlocks counters, then the dead word
  int* err_host;                // the error word (host-mapped)
  int* err_dev;
};

struct Params {
  char* peer[kMaxRanks];
  unsigned long long* epochs;  // kMaxBlocks counters, then the dead word
  int* err;                    // the error word (host-mapped)
  const void* x;
  void* out;
  long long n;           // columns of this call
  long long x_stride;    // elements between the rows of x (0: one row for every rank)
  long long out_stride;  // all-gather: elements between out's rows
  long long slot;        // elements between a half's rows (inbox slots, pull rows)
  unsigned long long half_bytes;
  long long limit_ns;
  int rank;
  int size;
  int vec;  // 16-byte accesses: x, out and every row start 16-byte aligned
};

// 16 bytes of T (kVec values), or one value
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T, int N>
struct Pack {
  T v[N];
};

template <int N, typename T>
__device__ __forceinline__ Pack<T, N> load(const T* p) {
  Pack<T, N> r;
  if constexpr (N == 1) {
    r.v[0] = *p;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(&r, &u, 16);
  }
  return r;
}

// a load that skips L1: what the peers stored into this rank's half
template <int N, typename T>
__device__ __forceinline__ Pack<T, N> load_cg(const T* p) {
  Pack<T, N> r;
  if constexpr (N == 1) {
    r.v[0] = __ldcg(p);
  } else {
    const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  }
  return r;
}

template <int N, typename T>
__device__ __forceinline__ void store(T* p, const Pack<T, N>& r) {
  if constexpr (N == 1) {
    *p = r.v[0];
  } else {
    uint4 u;
    memcpy(&u, &r, 16);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

template <int N, typename T>
__device__ __forceinline__ void add(Pack<T, N>& a, const Pack<T, N>& b) {
#pragma unroll
  for (int k = 0; k < N; ++k) a.v[k] = a.v[k] + b.v[k];
}

// CTA b's share [lo, hi) of a range of `len` columns starting at `base`:
// pieces of whole 16-byte groups, the same on every rank
template <typename T>
__device__ __forceinline__ void cta_range(long long base, long long len, long long* lo,
                                          long long* hi) {
  const long long groups = (len + kVec<T> - 1) / kVec<T>;
  const long long per = (groups + gridDim.x - 1) / gridDim.x * kVec<T>;
  const long long a = min(len, static_cast<long long>(blockIdx.x) * per);
  *lo = base + a;
  *hi = base + min(len, a + per);
}

// f(i, N) over the columns [lo, hi) of the CTA: 16-byte groups (N = kVec)
// where `vec`, then single values (N = 1)
template <typename T, typename F>
__device__ __forceinline__ void each(long long lo, long long hi, bool vec, F f) {
  long long i0 = lo;
  if (vec) {
    const long long groups = (hi - lo) / kVec<T>;
#pragma unroll 4
    for (long long g = threadIdx.x; g < groups; g += blockDim.x) {
      f(lo + g * kVec<T>, std::integral_constant<int, kVec<T>>{});
    }
    i0 = lo + groups * kVec<T>;
  }
  for (long long i = i0 + threadIdx.x; i < hi; i += blockDim.x) {
    f(i, std::integral_constant<int, 1>{});
  }
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// CTA b meets CTA b of every rank at flag value `value`; false if the
// communicator died (the CTA returns).  The barrier orders the CTA's stores
// (local and remote) before thread q's release at system scope, which the
// peer's acquire of the flag pairs with, so the peer then reads them: no
// fence of every thread (they cost more than the round trip, PERF.md)
__device__ bool meet(const Params& p, unsigned long long value, int* s_fail) {
  const int b = blockIdx.x;
  volatile unsigned long long* dead = p.epochs + kMaxBlocks;
  __syncthreads();
  if (threadIdx.x < p.size) {
    const int q = threadIdx.x;
    unsigned long long* theirs = reinterpret_cast<unsigned long long*>(p.peer[q]);
    const unsigned long long* own = reinterpret_cast<const unsigned long long*>(p.peer[p.rank]);
    st_release(theirs + b * kMaxRanks + p.rank, value);
    const unsigned long long t0 = global_ns();
    unsigned spins = 0;
    while (ld_acquire(own + b * kMaxRanks + q) < value) {
      if ((++spins & 255u) == 0) {
        if (*dead) {
          *s_fail = 1;
          break;
        }
        if (static_cast<long long>(global_ns() - t0) > p.limit_ns) {
          *dead = 1;
          *static_cast<volatile int*>(p.err) = 1 + q;
          __threadfence_system();
          *s_fail = 1;
          break;
        }
      }
    }
  }
  __syncthreads();
  return !*s_fail;
}

template <typename T, int SCHED>
__global__ void __launch_bounds__(kThreads) coll_kernel(Params p) {
  __shared__ unsigned long long s_epoch;
  __shared__ int s_fail;
  const int b = blockIdx.x;
  const int G = gridDim.x;
  if (threadIdx.x == 0) {
    s_epoch = *static_cast<volatile unsigned long long*>(p.epochs + b) + 1;
    s_fail = *static_cast<volatile unsigned long long*>(p.epochs + kMaxBlocks) != 0;
  }
  __syncthreads();
  if (s_fail) return;  // the communicator is dead: no wait
  const unsigned long long epoch = s_epoch;
  for (int s = b + threadIdx.x * G; s < kMaxBlocks; s += kThreads * G) p.epochs[s] = epoch;

  const size_t off = kFlagBytes + (epoch & 1ull) * p.half_bytes;
  auto half = [&](int q) { return reinterpret_cast<T*>(p.peer[q] + off); };
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const bool vec = p.vec != 0;
  const int size = p.size;
  const int rank = p.rank;
  long long lo, hi;

  if constexpr (SCHED == kPull) {
    // the all-gather: this rank's share into its half, then every rank's
    // share read from theirs
    cta_range<T>(0, p.n, &lo, &hi);
    T* mine = half(rank);
    each<T>(lo, hi, vec, [&](long long i, auto w) {
      constexpr int N = decltype(w)::value;
      store<N>(mine + i, load<N>(x + i));
    });
    if (!meet(p, 2 * epoch - 1, &s_fail)) return;
    each<T>(lo, hi, vec, [&](long long i, auto w) {
      constexpr int N = decltype(w)::value;
      Pack<T, N> v[kMaxRanks];
#pragma unroll
      for (int q = 0; q < kMaxRanks; ++q) {
        if (q < size) v[q] = load_cg<N>(half(q) + i);
      }
#pragma unroll
      for (int q = 0; q < kMaxRanks; ++q) {
        if (q < size) store<N>(out + q * p.out_stride + i, v[q]);
      }
    });
  } else if constexpr (SCHED == kPush) {
    // row q of x into slot `rank` of rank q's inbox, the peers in turn from
    // rank + 1; then this rank's slots summed in rank order
    cta_range<T>(0, p.n, &lo, &hi);
    for (int k = 1; k < size; ++k) {
      const int q = (rank + k) % size;
      T* dst = half(q) + rank * p.slot;
      const T* src = x + q * p.x_stride;
      each<T>(lo, hi, vec, [&](long long i, auto w) {
        constexpr int N = decltype(w)::value;
        store<N>(dst + i, load<N>(src + i));
      });
    }
    if (!meet(p, 2 * epoch - 1, &s_fail)) return;
    const T* inbox = half(rank);
    const T* own = x + rank * p.x_stride;
    each<T>(lo, hi, vec, [&](long long i, auto w) {
      constexpr int N = decltype(w)::value;
      Pack<T, N> v[kMaxRanks];
#pragma unroll
      for (int q = 0; q < kMaxRanks; ++q) {
        if (q < size) v[q] = q == rank ? load<N>(own + i) : load_cg<N>(inbox + q * p.slot + i);
      }
#pragma unroll
      for (int q = 1; q < kMaxRanks; ++q) {
        if (q < size) add<N>(v[0], v[q]);
      }
      store<N>(out + i, v[0]);
    });
  } else {
    // two-shot all-reduce: slice q (p.slot columns from q * p.slot) is rank q's
    auto slice = [&](int q, long long* a, long long* e) {
      const long long s0 = min(p.n, q * p.slot);
      cta_range<T>(s0, min(p.n, s0 + p.slot) - s0, a, e);
    };
    for (int k = 1; k < size; ++k) {
      const int q = (rank + k) % size;
      slice(q, &lo, &hi);
      T* dst = half(q) + rank * p.slot - q * p.slot;  // indexed by column
      each<T>(lo, hi, vec, [&](long long i, auto w) {
        constexpr int N = decltype(w)::value;
        store<N>(dst + i, load<N>(x + i));
      });
    }
    if (!meet(p, 2 * epoch - 1, &s_fail)) return;
    // this rank's slice, summed in rank order, out here and into every peer's result area
    const long long results = size * p.slot;
    slice(rank, &lo, &hi);
    const T* inbox = half(rank) - rank * p.slot;
    each<T>(lo, hi, vec, [&](long long i, auto w) {
      constexpr int N = decltype(w)::value;
      Pack<T, N> v[kMaxRanks];
#pragma unroll
      for (int q = 0; q < kMaxRanks; ++q) {
        if (q < size) v[q] = q == rank ? load<N>(x + i) : load_cg<N>(inbox + q * p.slot + i);
      }
#pragma unroll
      for (int q = 1; q < kMaxRanks; ++q) {
        if (q < size) add<N>(v[0], v[q]);
      }
      store<N>(out + i, v[0]);
      for (int k = 1; k < size; ++k) store<N>(half((rank + k) % size) + results + i, v[0]);
    });
    if (!meet(p, 2 * epoch, &s_fail)) return;
    const T* summed = half(rank) + results;
    for (int k = 1; k < size; ++k) {
      slice((rank + k) % size, &lo, &hi);
      each<T>(lo, hi, vec, [&](long long i, auto w) {
        constexpr int N = decltype(w)::value;
        store<N>(out + i, load_cg<N>(summed + i));
      });
    }
  }
}

template <typename T>
void* kernel_of(int sched, int op) {
  if (sched == kPull && op == kAllGather) return (void*)coll_kernel<T, kPull>;
  if (sched == kPush && op != kAllGather) return (void*)coll_kernel<T, kPush>;
  if (sched == kTwoShot && op == kAllReduce) return (void*)coll_kernel<T, kTwoShot>;
  return nullptr;
}

// the most CTAs of every kernel that one wave of the card holds, at most
// kMaxPerSm an SM and kMaxBlocks in all
cudaError_t max_grid(int device, int* out) {
  int sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int per_sm = kMaxPerSm;
  for (int dtype = 0; dtype < 2 && e == cudaSuccess; ++dtype) {
    for (int sched = 0; sched < 3 && e == cudaSuccess; ++sched) {
      for (int op = 0; op < 3 && e == cudaSuccess; ++op) {
        void* k = dtype == 0 ? kernel_of<float>(sched, op) : kernel_of<double>(sched, op);
        if (k == nullptr) continue;
        int blocks = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, 0);
        if (blocks < per_sm) per_sm = blocks;
      }
    }
  }
  *out = per_sm * sms < kMaxBlocks ? per_sm * sms : kMaxBlocks;
  return e == cudaSuccess && *out < 1 ? cudaErrorInvalidConfiguration : e;
}

void release(Comm* c) {
  for (int q = 0; q < c->size; ++q) {
    if (q != c->rank && c->peer[q] != nullptr) cudaIpcCloseMemHandle(c->peer[q]);
  }
  if (c->base != nullptr) cudaFree(c->base);
  if (c->epochs != nullptr) cudaFree(c->epochs);
  if (c->err_host != nullptr) cudaFreeHost(c->err_host);
  delete c;
}

}  // namespace

extern "C" {

int peercoll_abi_version() { return 2; }

int peercoll_max_ranks() { return kMaxRanks; }

// Allocate this rank's region, counters and error word on `device` (zeroed,
// the device synchronized), and write the region's IPC handle (64 bytes) to
// `handle_out`.  *comm_out is the communicator until peercoll_destroy.
int peercoll_create(int device, int rank, int size, size_t half_bytes, double limit_s,
                    void** comm_out, void* handle_out) {
  *comm_out = nullptr;
  if (size < 1 || size > kMaxRanks || rank < 0 || rank >= size || half_bytes % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Comm* c = new Comm();
  c->device = device;
  c->rank = rank;
  c->size = size;
  c->half_bytes = half_bytes;
  c->limit_ns = static_cast<long long>(limit_s * 1e9);
  e = max_grid(device, &c->max_grid);
  const size_t bytes = kFlagBytes + 2 * half_bytes;
  if (e == cudaSuccess) e = cudaMalloc(&c->base, bytes);
  if (e == cudaSuccess) e = cudaMemset(c->base, 0, kFlagBytes);
  const size_t counters = (kMaxBlocks + 1) * sizeof(unsigned long long);
  if (e == cudaSuccess) e = cudaMalloc(&c->epochs, counters);
  if (e == cudaSuccess) e = cudaMemset(c->epochs, 0, counters);
  if (e == cudaSuccess) {
    e = cudaHostAlloc(reinterpret_cast<void**>(&c->err_host), sizeof(int), cudaHostAllocMapped);
  }
  if (e == cudaSuccess) {
    *c->err_host = 0;
    e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&c->err_dev), c->err_host, 0);
  }
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(&h, c->base);
  if (e != cudaSuccess) {
    release(c);
    return static_cast<int>(e);
  }
  std::memcpy(handle_out, &h, kHandleBytes);
  c->peer[rank] = c->base;
  *comm_out = c;
  return 0;
}

// Map every other rank's region from `handles` (size x 64 bytes, rank order).
int peercoll_open(void* comm, const void* handles) {
  Comm* c = static_cast<Comm*>(comm);
  cudaError_t e = cudaSetDevice(c->device);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int q = 0; q < c->size; ++q) {
    if (q == c->rank) continue;
    cudaIpcMemHandle_t h;
    std::memcpy(&h, static_cast<const char*>(handles) + q * kHandleBytes, kHandleBytes);
    void* ptr = nullptr;
    e = cudaIpcOpenMemHandle(&ptr, h, cudaIpcMemLazyEnablePeerAccess);
    if (e != cudaSuccess) return static_cast<int>(e);
    c->peer[q] = static_cast<char*>(ptr);
  }
  return 0;
}

// The most CTAs a launch may take: every CTA of a launch must be resident
// at once (CTA b waits for CTA b of every rank).
int peercoll_max_grid(void* comm) { return static_cast<Comm*>(comm)->max_grid; }

// One launch of `grid` CTAs: op 0 all-reduce, 1 reduce-scatter, 2
// all-gather; schedule 0 pull (all-gather), 1 push (all-reduce,
// reduce-scatter), 2 two-shot (all-reduce); dtype 0 float32, 1 float64.  n columns; x_stride
// (reduce-scatter) and out_stride (all-gather) in elements.  Every rank
// makes the same call.  The caller keeps the call within one half.
int peercoll_run(void* comm, int op, int schedule, int dtype, const void* x,
                 long long x_stride, void* out, long long out_stride, long long n, int grid,
                 void* stream) {
  Comm* c = static_cast<Comm*>(comm);
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(double);
  const long long vec = 16 / static_cast<long long>(elem);
  void* k = dtype == 0 ? kernel_of<float>(schedule, op)
                       : dtype == 1 ? kernel_of<double>(schedule, op) : nullptr;
  if (k == nullptr || n < 0 || grid < 1 || grid > c->max_grid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  for (int q = 0; q < kMaxRanks; ++q) p.peer[q] = q < c->size ? c->peer[q] : nullptr;
  p.epochs = c->epochs;
  p.err = c->err_dev;
  p.x = x;
  p.out = out;
  p.n = n;
  p.x_stride = op == kReduceScatter ? x_stride : 0;
  p.out_stride = out_stride;
  p.half_bytes = c->half_bytes;
  p.limit_ns = c->limit_ns;
  p.rank = c->rank;
  p.size = c->size;
  // a half's rows start on 16 bytes; the elements this call needs of a half
  long long need;
  if (schedule == kTwoShot) {
    p.slot = ((n + c->size - 1) / c->size + vec - 1) / vec * vec;
    need = c->size * p.slot + n;
  } else {
    p.slot = (n + vec - 1) / vec * vec;
    const long long rows = schedule == kPush ? c->size : 1;
    need = rows * p.slot;
  }
  if (static_cast<size_t>(need) * elem > c->half_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](uintptr_t v) { return v % 16 == 0; };
  p.vec = aligned(reinterpret_cast<uintptr_t>(x)) && aligned(reinterpret_cast<uintptr_t>(out)) &&
          aligned(static_cast<uintptr_t>(p.x_stride) * elem) &&
          aligned(static_cast<uintptr_t>(out_stride) * elem);
  void* args[] = {&p};
  cudaError_t e = cudaLaunchKernel(k, dim3(grid), dim3(kThreads), args, 0,
                                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(e == cudaSuccess ? cudaGetLastError() : e);
}

// The error word: 0, or 1 + the rank a CTA waited for past the limit.  A
// read of host memory; it holds what the launches that have ended wrote.
int peercoll_error(void* comm) {
  return *static_cast<volatile int*>(static_cast<Comm*>(comm)->err_host);
}

// Unmap the peers' regions and free this rank's.  Every rank must have
// ended its launches first (the wrapper synchronizes and meets the others).
int peercoll_destroy(void* comm) {
  Comm* c = static_cast<Comm*>(comm);
  cudaError_t e = cudaSetDevice(c->device);
  release(c);
  return static_cast<int>(e);
}

}  // extern "C"
