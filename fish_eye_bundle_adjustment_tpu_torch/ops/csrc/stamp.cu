// Device stamps for the port's tracing (utils/observe.py), bound to PyTorch
// with ctypes.
//
// No TPU kernel stands behind this file.  The device loop replays one GN
// step as a CUDA graph whose steps and CG blocks sit in IF nodes
// (graphcond.cu), and torch.profiler does not see the kernels launched
// inside them.  A stamp is a kernel of one thread, captured into such a body
// like any other kernel: it runs where its body runs, reads the device's
// nanosecond timer (%globaltimer) and writes (tag, time) into a ring at an
// atomic cursor.  A pair of stamps around a stretch of work is a span of the
// device's own time, whether the stretch ran eagerly or in a replay.  Its
// cost is one launch (a graph node), one atomic and 16 bytes written.
//
//   stamp_record(ring, head, capacity, tag, stream): ring is (capacity, 2)
//     int64, head (2,) int64: head[0] the cursor, head[1] the records that
//     found the ring full (counted, not wrapped over the records there).
//   stamp_ticks(out, n, stream): one thread reads %globaltimer until it has
//     changed n times and writes each change's step in ns to out[0..n): the
//     timer's resolution.  A timer that does not move within SPIN_LIMIT
//     reads writes -1 and stops, so the kernel always ends.

#include <cuda_runtime.h>

namespace {

constexpr long long SPIN_LIMIT = 1LL << 26;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void stamp_kernel(long long* ring, unsigned long long* head, long long capacity,
                             long long tag) {
  const unsigned long long t = global_ns();
  const unsigned long long i = atomicAdd(&head[0], 1ULL);
  if (i < static_cast<unsigned long long>(capacity)) {
    ring[2 * i] = tag;
    ring[2 * i + 1] = static_cast<long long>(t);
  } else {
    atomicAdd(&head[1], 1ULL);
  }
}

__global__ void ticks_kernel(long long* out, int n) {
  unsigned long long last = global_ns();
  for (int k = 0; k < n; ++k) {
    unsigned long long now = global_ns();
    long long spins = 0;
    while (now == last && spins < SPIN_LIMIT) {
      now = global_ns();
      ++spins;
    }
    if (now == last) {
      out[k] = -1;
      return;
    }
    out[k] = static_cast<long long>(now - last);
    last = now;
  }
}

}  // namespace

extern "C" {

int stamp_abi_version() { return 1; }

int stamp_record(void* ring, void* head, long long capacity, long long tag, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<unsigned long long*>(head), capacity, tag);
  return static_cast<int>(cudaGetLastError());
}

int stamp_ticks(void* out, int n, void* stream) {
  ticks_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
