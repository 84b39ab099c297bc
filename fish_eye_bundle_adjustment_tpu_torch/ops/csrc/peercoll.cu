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
// for float32 and float64.  Every rank sums the ranks' values in rank order
// 0, 1, ..., size - 1 (no atomics), so every rank holds the same bits, and so
// does the plain version (a gather, then the sum in that order).
//
// Memory.  Each rank owns one cudaMalloc'd region: a flag array (kBlocks x
// kMaxRanks u64) and two halves of `half_bytes` each, exported with
// cudaIpcGetMemHandle and opened by every other rank (cudaIpcOpenMemHandle,
// lazy peer access); the handles travel over the process group
// (ops/peercoll.py).  A call moves at most one half per rank; the wrapper cuts
// larger calls into chunks, one launch each.
//
// One launch: kBlocks CTAs (fixed: every CTA takes part in every call), each
// owning the same grid-stride share of the columns on every rank.
//   1. CTA b copies its share of this rank's x into this rank's half.
//   2. CTA b meets CTA b of every rank: thread q < size releases the call's
//      epoch into rank q's flag [b][rank] (st.release.sys, after a system
//      fence, so the CTA's copies are visible first), then acquires its own
//      flag [b][q] (ld.acquire.sys) until it reaches the epoch.
//   3. CTA b reads its share from every rank's half (L2, not L1), sums in
//      rank order or places the rows, and writes the output.
// Replays of a captured launch repeat its arguments, so the epoch is not one:
// each CTA keeps a counter in device memory and advances it itself.  The half
// a call uses is the epoch's parity.  A rank overwrites a half only two calls
// later, and to start that call CTA b must have met every rank's CTA b in the
// call between, whose launch began after the rank's earlier launch had ended
// (the calls of one communicator are stream-ordered): nobody reads the half
// any more.  The wait is bounded by %globaltimer: past `limit_ns` the CTA
// marks the communicator dead (a word in device memory, which the other CTAs
// and every later launch read, and return at once) and sets the error word
// (host-mapped memory, 1 + the rank it waited for).  The wrapper reads the
// error word and raises; it never hangs.
//
// What bounds it on the H100: the peers' bytes over NVLink (450 GB/s each
// way) for large calls, and the latency of one flag round trip for the
// solvers' calls (camera vectors of ~6k values, 36 x n_img float64 blocks,
// scalars).  A one-shot kernel, simple before fast: every rank reads every
// peer's share once.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kBlocks = 32;
constexpr int kThreads = 512;
constexpr size_t kFlagBytes = 4096;  // kBlocks * kMaxRanks * 8 = 2048, padded
constexpr size_t kHandleBytes = sizeof(cudaIpcMemHandle_t);

static_assert(kBlocks * kMaxRanks * sizeof(unsigned long long) <= kFlagBytes, "flags");
static_assert(kHandleBytes == 64, "a CUDA IPC handle is 64 bytes");

enum Op { kAllReduce = 0, kReduceScatter = 1, kAllGather = 2 };

struct Comm {
  int device;
  int rank;
  int size;
  size_t half_bytes;
  long long limit_ns;
  char* base;                   // this rank's region: flags, then two halves
  char* peer[kMaxRanks];        // every rank's region as mapped here
  unsigned long long* epochs;   // kBlocks counters, then the dead word
  int* err_host;                // the error word (host-mapped)
  int* err_dev;
};

struct Params {
  char* peer[kMaxRanks];
  unsigned long long* epochs;  // kBlocks counters, then the dead word
  int* err;                    // the error word (host-mapped)
  const void* x;
  void* out;
  long long m;           // columns of this call
  long long x_stride;    // reduce-scatter: elements between x's rows
  long long out_stride;  // all-gather: elements between out's rows
  unsigned long long half_bytes;
  long long limit_ns;
  int rank;
  int size;
};

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

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) coll_kernel(Params p) {
  __shared__ unsigned long long s_epoch;
  __shared__ int s_fail;
  const int b = blockIdx.x;
  volatile unsigned long long* dead = p.epochs + kBlocks;
  if (threadIdx.x == 0) {
    s_epoch = p.epochs[b] + 1;
    p.epochs[b] = s_epoch;
    s_fail = *dead != 0;
  }
  __syncthreads();
  if (s_fail) return;  // the communicator is dead: no wait
  const unsigned long long epoch = s_epoch;
  const size_t half = kFlagBytes + (epoch & 1ull) * p.half_bytes;
  const long long stride = static_cast<long long>(kBlocks) * kThreads;
  const long long first = static_cast<long long>(b) * kThreads + threadIdx.x;
  const T* x = static_cast<const T*>(p.x);
  T* mine = reinterpret_cast<T*>(p.peer[p.rank] + half);

  // 1. this rank's share into its half
  const int rows_in = OP == kReduceScatter ? p.size : 1;
  for (long long i = first; i < p.m; i += stride) {
    for (int q = 0; q < rows_in; ++q) mine[q * p.m + i] = x[q * p.x_stride + i];
  }

  // 2. meet CTA b of every rank
  __syncthreads();
  if (threadIdx.x < p.size) {
    const int q = threadIdx.x;
    unsigned long long* theirs = reinterpret_cast<unsigned long long*>(p.peer[q]);
    const unsigned long long* own = reinterpret_cast<const unsigned long long*>(p.peer[p.rank]);
    __threadfence_system();
    st_release(theirs + b * kMaxRanks + p.rank, epoch);
    const unsigned long long t0 = global_ns();
    unsigned spins = 0;
    while (ld_acquire(own + b * kMaxRanks + q) < epoch) {
      if ((++spins & 255u) == 0) {
        if (*dead) {
          s_fail = 1;
          break;
        }
        if (static_cast<long long>(global_ns() - t0) > p.limit_ns) {
          *dead = 1;
          *static_cast<volatile int*>(p.err) = 1 + q;
          __threadfence_system();
          s_fail = 1;
          break;
        }
      }
    }
  }
  __syncthreads();
  if (s_fail) return;

  // 3. every rank's share, summed in rank order or placed
  T* out = static_cast<T*>(p.out);
  const long long offset = OP == kReduceScatter ? p.rank * p.m : 0;
  for (long long i = first; i < p.m; i += stride) {
    T v[kMaxRanks];
#pragma unroll
    for (int q = 0; q < kMaxRanks; ++q) {
      if (q < p.size) v[q] = __ldcg(reinterpret_cast<const T*>(p.peer[q] + half) + offset + i);
    }
    if (OP == kAllGather) {
#pragma unroll
      for (int q = 0; q < kMaxRanks; ++q) {
        if (q < p.size) out[q * p.out_stride + i] = v[q];
      }
    } else {
      T acc = v[0];
#pragma unroll
      for (int q = 1; q < kMaxRanks; ++q) {
        if (q < p.size) acc = acc + v[q];
      }
      out[i] = acc;
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int op, cudaStream_t s) {
  switch (op) {
    case kAllReduce:
      coll_kernel<T, kAllReduce><<<kBlocks, kThreads, 0, s>>>(p);
      break;
    case kReduceScatter:
      coll_kernel<T, kReduceScatter><<<kBlocks, kThreads, 0, s>>>(p);
      break;
    case kAllGather:
      coll_kernel<T, kAllGather><<<kBlocks, kThreads, 0, s>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

int peercoll_abi_version() { return 1; }

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
  const size_t bytes = kFlagBytes + 2 * half_bytes;
  e = cudaMalloc(&c->base, bytes);
  if (e == cudaSuccess) e = cudaMemset(c->base, 0, kFlagBytes);
  const size_t counters = (kBlocks + 1) * sizeof(unsigned long long);
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

// One launch: op 0 all-reduce, 1 reduce-scatter, 2 all-gather; dtype 0
// float32, 1 float64.  m columns; x_stride (reduce-scatter) and out_stride
// (all-gather) in elements.  The caller keeps m (x rows for reduce-scatter)
// within one half.
int peercoll_run(void* comm, int op, int dtype, const void* x, long long x_stride, void* out,
                 long long out_stride, long long m, void* stream) {
  Comm* c = static_cast<Comm*>(comm);
  Params p;
  for (int q = 0; q < kMaxRanks; ++q) p.peer[q] = q < c->size ? c->peer[q] : nullptr;
  p.epochs = c->epochs;
  p.err = c->err_dev;
  p.x = x;
  p.out = out;
  p.m = m;
  p.x_stride = x_stride;
  p.out_stride = out_stride;
  p.half_bytes = c->half_bytes;
  p.limit_ns = c->limit_ns;
  p.rank = c->rank;
  p.size = c->size;
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(double);
  const long long rows = op == kReduceScatter ? c->size : 1;
  if (m < 0 || static_cast<size_t>(rows * m) * elem > c->half_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, op, s));
  if (dtype == 1) return static_cast<int>(launch<double>(p, op, s));
  return static_cast<int>(cudaErrorInvalidValue);
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
