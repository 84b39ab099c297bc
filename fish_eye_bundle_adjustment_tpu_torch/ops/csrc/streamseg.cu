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
// contiguous run, and the row where a run starts (its head) is unique.
//
// What bounds it on the H100: bytes.  One read of the span's ids and values and
// one write of the output: K3 at bench_streamseg.py's defaults (N = 1,048,576,
// D = 8, 100,000 segments) moves ~41 MB, ~12 us at 3.35 TB/s, against 8.4M adds.
//
// Design.  One CTA of 128 threads per span, in tiles of 512 rows: each thread
// takes 4 consecutive rows and up to 8 columns (wider streams take further
// passes of 8 columns), loaded with 16-byte loads where the layout allows --
// one float4 of 4 rows per column in K3's transposed stream (row stride 1),
// two float4 of 4 columns per row in W's row-major one -- and the 4 ids with
// one int4; other bases and strides take scalar loads in the same kernel.
// Slot boundaries come from the same ids: a row is a head when its slot
// differs from the previous row's (a shuffle from the lane before; lane 0
// reads the previous row's id with its tile).  Each thread sums its own rows
// run by run and leaves the sum of the run it ends on in shared memory; a
// ballot of the lanes that hold a head tells the lane where a run ends which
// lane the run began in, and that lane adds the sums of the lanes between, in
// lane order.  A run whose head lies in the warp is stored as its slot's sum
// by that lane -- the head is unique, so no other lane writes that slot -- and
// the piece of the warp's first run, which began before the warp, goes to the
// warp's entry for the tile.  So tiles need no barrier: after a column pass
// (or 8 tiles) one thread per column adds the entries in tile and warp order.
// Each slot's sum is its pieces in row order: no atomics, no integer division
// in the row loop, and a run repeats bit for bit.
//
// The time goes to the chain of rounds to memory that each CTA waits for in
// turn (its span's bounds, then each tile), not to the adds: the kernel keeps
// as many CTAs on an SM as it can.  At 6 CTAs an SM (85 registers) all of
// K3's 782 spans run at once; when every span's CTA fits at 4 an SM, the
// kernel also loads the next tile into a second set of registers before it
// sums the current one, which shortens W's chain of 4 tiles a span.
// Persistent CTAs walking several spans, and a cp.async ring of tiles in
// fewer CTAs, measured slower on the H100 (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // consecutive rows per thread
constexpr int kTile = kThreads * kRows;  // rows per tile
constexpr int kCols = 8;                 // columns per pass
constexpr int kEntryTiles = 8;           // tiles whose warp entries wait for a flush
constexpr unsigned kFull = 0xffffffffu;

// how a thread loads its 4 rows of up to 8 columns
enum Load {
  kScalar = 0,  // one float per element, any strides
  kRowVec = 1,  // row stride 1: a float4 of 4 rows per column
  kColVec = 2,  // column stride 1, D and the row stride multiples of 4: float4s along a row
};

struct Span {
  const float* vals;
  const int* ids;
  long long rs, cs;  // row and column strides of vals
  int r0, r1, s0, S, D;
  bool ids_vec;      // ids 16-byte aligned: int4 loads
};

// Slot of `row`: -1 before the span or below slot 0, S past the span or past
// the last slot, so the slots stay non-decreasing along the rows.
__device__ __forceinline__ int clamp_slot(int id, const Span& sp) {
  const long long v = static_cast<long long>(id) - sp.s0;
  return v < 0 ? -1 : v >= sp.S ? sp.S : static_cast<int>(v);
}

__device__ __forceinline__ int slot_at(const Span& sp, int row) {
  if (row < sp.r0) return -1;
  if (row >= sp.r1) return sp.S;
  return clamp_slot(sp.ids[row], sp);
}

struct Rows {
  float v[kRows][kCols];
  int slot[kRows];
  int prev;  // lane 0: slot of the row before its first
};

// The thread's rows [row, row + 4), columns [c0, c0 + 8).
template <int kLoad>
__device__ __forceinline__ void load_rows(const Span& sp, int row, int c0, Rows& t) {
  const bool full = row >= sp.r0 && row + kRows <= sp.r1;
  t.prev = (threadIdx.x % 32 == 0) ? slot_at(sp, row - 1) : 0;
  if (full && sp.ids_vec) {
    const int4 q = *reinterpret_cast<const int4*>(sp.ids + row);
    t.slot[0] = clamp_slot(q.x, sp);
    t.slot[1] = clamp_slot(q.y, sp);
    t.slot[2] = clamp_slot(q.z, sp);
    t.slot[3] = clamp_slot(q.w, sp);
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) t.slot[i] = slot_at(sp, row + i);
  }
  if (kLoad == kRowVec && full) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + c < sp.D)
        q = *reinterpret_cast<const float4*>(sp.vals + (c0 + c) * sp.cs + row);
      t.v[0][c] = q.x;
      t.v[1][c] = q.y;
      t.v[2][c] = q.z;
      t.v[3][c] = q.w;
    }
  } else if (kLoad == kColVec && full) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + c < sp.D)
          q = *reinterpret_cast<const float4*>(sp.vals + (row + i) * sp.rs + c0 + c);
        t.v[i][c] = q.x;
        t.v[i][c + 1] = q.y;
        t.v[i][c + 2] = q.z;
        t.v[i][c + 3] = q.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const bool in = row + i >= sp.r0 && row + i < sp.r1;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        t.v[i][c] = (in && c0 + c < sp.D) ? sp.vals[(row + i) * sp.rs + (c0 + c) * sp.cs] : 0.f;
    }
  }
}

// A finished piece of slot `slot` over this warp: if the run's head lies in
// the warp, it is the run's first piece and becomes the slot's sum (stored:
// nothing was added to the slot before it); else it goes to the warp's entry
// for this tile (the piece of the warp's first run, which began before it),
// added to the sum at the next flush.
__device__ __forceinline__ void emit(const float (&val)[kCols], int slot, bool started,
                                     const Span& sp, int c0, float* acc, int* entry_slot,
                                     float* entry_val) {
  if (slot < 0 || slot >= sp.S) return;
  if (started) {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c0 + c < sp.D) acc[(c0 + c) * sp.S + slot] = val[c];
  } else {
    *entry_slot = slot;
#pragma unroll
    for (int c = 0; c < kCols; ++c) entry_val[c] = val[c];
  }
}

// Sums one tile's rows into acc (column-major, (D, S)); the warp's entry for
// the tile gets its first run's piece if that run began before the warp, else
// slot -1.  No barrier: each slot has one head, so the lane that adds a run's
// first piece is the only writer of that slot in acc until the entries are
// added.  `last_s` is the warp's (32, kCols) buffer of each lane's last-run sum.
__device__ __forceinline__ void sum_rows(const Rows& t, const Span& sp, int c0, float* acc,
                                         float* last_s, int* entry_slot, float* entry_val) {
  const int lane = threadIdx.x % 32;
  int prev = __shfl_up_sync(kFull, t.slot[kRows - 1], 1);
  if (lane == 0) {
    prev = t.prev;
    *entry_slot = -1;
  }
  const int next = __shfl_down_sync(kFull, t.slot[0], 1);

  // the thread's runs: the first (before any head at rows 1..3), the runs that
  // start and end inside the thread (finished here), and the last
  const bool row0_head = t.slot[0] != prev;
  float first[kCols], cur[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) cur[c] = first[c] = t.v[0][c];
  int cur_slot = t.slot[0];
  bool inner_head = false;
#pragma unroll
  for (int i = 1; i < kRows; ++i) {
    if (t.slot[i] != cur_slot) {
      if (inner_head) {
        emit(cur, cur_slot, true, sp, c0, acc, entry_slot, entry_val);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) first[c] = cur[c];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) cur[c] = t.v[i][c];
      cur_slot = t.slot[i];
      inner_head = true;
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) cur[c] += t.v[i][c];
    }
  }
  if (!inner_head) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) first[c] = cur[c];
  }

  // each lane's last-run sum to shared memory, and which lanes hold a head
  float4* mine = reinterpret_cast<float4*>(last_s + lane * kCols);
  mine[0] = make_float4(cur[0], cur[1], cur[2], cur[3]);
  mine[1] = make_float4(cur[4], cur[5], cur[6], cur[7]);
  const unsigned heads = __ballot_sync(kFull, row0_head || inner_head);
  __syncwarp();

  // a run ends in this lane if a head follows it here, or the next row (the
  // next lane's first) starts another, or the warp ends
  const bool ends_last = lane == 31 || next != t.slot[kRows - 1];
  if (inner_head || ends_last) {
    // the first run's piece: if it began in an earlier lane, the last-run
    // sums of the lanes from its head's lane (or the warp's first) on, in
    // lane order, then this lane's part
    const unsigned before = heads & ((1u << lane) - 1u);
    if (!row0_head && lane > 0) {
      const int h = before ? 31 - __clz(before) : 0;
      float carry[kCols];
      const float4* p = reinterpret_cast<const float4*>(last_s + h * kCols);
      float4 a = p[0], b = p[1];
      carry[0] = a.x, carry[1] = a.y, carry[2] = a.z, carry[3] = a.w;
      carry[4] = b.x, carry[5] = b.y, carry[6] = b.z, carry[7] = b.w;
      for (int j = h + 1; j < lane; ++j) {
        p = reinterpret_cast<const float4*>(last_s + j * kCols);
        a = p[0], b = p[1];
        carry[0] += a.x, carry[1] += a.y, carry[2] += a.z, carry[3] += a.w;
        carry[4] += b.x, carry[5] += b.y, carry[6] += b.z, carry[7] += b.w;
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) first[c] = carry[c] + first[c];
    }
    emit(first, t.slot[0], row0_head || before != 0, sp, c0, acc, entry_slot, entry_val);
  }
  if (inner_head && ends_last) emit(cur, cur_slot, true, sp, c0, acc, entry_slot, entry_val);
  __syncwarp();  // last_s is rewritten by the warp's next tile
}

// Adds the warps' entries of the tiles summed since the last flush, tile by
// tile and warp by warp (one thread per column), after every warp is done.
__device__ __forceinline__ void flush(const Span& sp, int c0, int n_entries, float* acc,
                                      const int* entry_slot, const float* entry_val) {
  __syncthreads();
  if (threadIdx.x < kCols && c0 + static_cast<int>(threadIdx.x) < sp.D) {
    float* col = acc + (c0 + threadIdx.x) * sp.S;
    for (int k = 0; k < n_entries; ++k) {
      const int hs = entry_slot[k];
      if (hs >= 0) col[hs] += entry_val[k * kCols + threadIdx.x];
    }
  }
  __syncthreads();
}

// One CTA per span, in column passes of kCols and tiles of kTile rows from
// the span's first 4-row boundary.  kPrefetch: the next tile's loads (the
// next pass's first tile's too) are issued into a second set of registers
// before the current tile is summed; the register cost leaves 4 CTAs an SM
// instead of 6, so the host takes it only when every span's CTA still fits on
// the card at once.
// Shared memory: the lanes' last-run sums, acc (D, S) floats, then
// kEntryTiles * kWarps entries (a slot and kCols values each).
template <int kLoad, bool kPrefetch>
__global__ void __launch_bounds__(kThreads, kPrefetch ? 4 : 6)
span_sum_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                const int* __restrict__ r0s, const int* __restrict__ r1s,
                const int* __restrict__ s0s, int S, int D, long long row_stride,
                long long col_stride, bool ids_vec, long long out_block, long long out_slot,
                long long out_col, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* last_s = reinterpret_cast<float*>(smem4);  // (kWarps, 32, kCols)
  float* acc = last_s + kThreads * kCols;
  float* entry_val = acc + static_cast<size_t>(S) * D;
  int* entry_slot = reinterpret_cast<int*>(entry_val + kEntryTiles * kWarps * kCols);
  const int b = blockIdx.x;
  const int w = threadIdx.x / 32;
  const Span sp{vals, ids, row_stride, col_stride, r0s[b], r1s[b], s0s ? s0s[b] : 0, S, D,
                ids_vec};
  const int base = sp.r0 & ~(kRows - 1);  // tiles start on 4-row boundaries
  Rows cur, nxt;
  load_rows<kLoad>(sp, base + kRows * threadIdx.x, 0, cur);
  for (int p = threadIdx.x; p < S * D; p += kThreads) acc[p] = 0.f;
  __syncthreads();

  int n_entries = 0;
  for (int c0 = 0; c0 < D; c0 += kCols) {
    for (int t0 = base; t0 < sp.r1; t0 += kTile) {
      // the next tile: in this pass, or the next pass's first
      int nt0 = t0 + kTile, nc0 = c0;
      if (nt0 >= sp.r1) {
        nt0 = base;
        nc0 = c0 + kCols;
      }
      const bool more = nc0 < D;
      if (kPrefetch && more) load_rows<kLoad>(sp, nt0 + kRows * threadIdx.x, nc0, nxt);
      const int e = n_entries * kWarps + w;
      sum_rows(cur, sp, c0, acc, last_s + w * 32 * kCols, entry_slot + e,
               entry_val + e * kCols);
      if (++n_entries == kEntryTiles) {
        flush(sp, c0, n_entries * kWarps, acc, entry_slot, entry_val);
        n_entries = 0;
      }
      if (more) {
        if (kPrefetch)
          cur = nxt;
        else
          load_rows<kLoad>(sp, nt0 + kRows * threadIdx.x, nc0, cur);
      }
    }
    flush(sp, c0, n_entries * kWarps, acc, entry_slot, entry_val);
    n_entries = 0;
  }

  float* o = out + b * out_block;
  if (out_slot == 1) {  // K3: slots adjacent in memory
    for (int d = 0; d < D; ++d)
      for (int s = threadIdx.x; s < S; s += kThreads) o[s + d * out_col] = acc[d * S + s];
  } else {
    for (int s = threadIdx.x; s < S; s += kThreads)
      for (int d = 0; d < D; ++d) o[s * out_slot + d * out_col] = acc[d * S + s];
  }
}

template <bool kPrefetch>
const void* kernel_of(int load) {
  return load == kRowVec   ? reinterpret_cast<const void*>(span_sum_kernel<kRowVec, kPrefetch>)
         : load == kColVec ? reinterpret_cast<const void*>(span_sum_kernel<kColVec, kPrefetch>)
                           : reinterpret_cast<const void*>(span_sum_kernel<kScalar, kPrefetch>);
}

// What a launch needs to know of the card for one (device, load, shared
// memory): the shared-memory attribute is set and the room counted once, at
// the first launch, and kept.
struct Room {
  int sms = 0, per_sm = 0, err = 0;
};

Room room_for(int load, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, size_t>, Room> cache;
  int device = 0;
  const int derr = static_cast<int>(cudaGetDevice(&device));
  if (derr) return Room{0, 0, derr};
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, load, smem);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  Room r;
  if (smem > 48 * 1024) {
    r.err = static_cast<int>(cudaFuncSetAttribute(
        kernel_of<true>(load), cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (!r.err)
      r.err = static_cast<int>(cudaFuncSetAttribute(kernel_of<false>(load),
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(smem)));
  }
  if (!r.err)
    r.err = static_cast<int>(
        cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, device));
  if (!r.err)
    r.err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &r.per_sm, kernel_of<true>(load), kThreads, smem));
  if (!r.err) cache[key] = r;
  return r;
}

template <bool kPrefetch>
void launch(int load, int n_blocks, size_t smem, cudaStream_t st, const float* vals,
            const int* ids, const int* r0, const int* r1, const int* s0, int S, int D,
            long long rs, long long cs, bool ids_vec, long long ob, long long os, long long oc,
            float* out) {
  if (load == kRowVec)
    span_sum_kernel<kRowVec, kPrefetch><<<n_blocks, kThreads, smem, st>>>(
        vals, ids, r0, r1, s0, S, D, rs, cs, ids_vec, ob, os, oc, out);
  else if (load == kColVec)
    span_sum_kernel<kColVec, kPrefetch><<<n_blocks, kThreads, smem, st>>>(
        vals, ids, r0, r1, s0, S, D, rs, cs, ids_vec, ob, os, oc, out);
  else
    span_sum_kernel<kScalar, kPrefetch><<<n_blocks, kThreads, smem, st>>>(
        vals, ids, r0, r1, s0, S, D, rs, cs, ids_vec, ob, os, oc, out);
}

}  // namespace

extern "C" {

int streamseg_abi_version() { return 2; }

size_t streamseg_smem_bytes(int S, int D) {
  return (kThreads * kCols + static_cast<size_t>(S) * D + kEntryTiles * kWarps * kCols) *
             sizeof(float) +
         kEntryTiles * kWarps * sizeof(int);
}

// vals: the stream, element (row, column) at row * row_stride + column *
// col_stride; ids (rows,) int32; r0, r1, s0 (n_blocks,) int32 (s0 may be null);
// out: element (block, slot, column) at block * out_block + slot * out_slot +
// column * out_col, every element written.  16-byte loads where the base and
// the strides allow them (see Load), scalar loads otherwise.
int streamseg_span_sum(const float* vals, const int* ids, const int* r0, const int* r1,
                       const int* s0, int n_blocks, int S, int D, long long row_stride,
                       long long col_stride, long long out_block, long long out_slot,
                       long long out_col, float* out, void* stream) {
  if (n_blocks < 0 || S < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const bool aligned = reinterpret_cast<std::uintptr_t>(vals) % 16 == 0;
  const int load = (aligned && row_stride == 1 && (D == 1 || col_stride % 4 == 0)) ? kRowVec
                   : (aligned && col_stride == 1 && row_stride % 4 == 0 && D % 4 == 0)
                       ? kColVec
                       : kScalar;
  const bool ids_vec = reinterpret_cast<std::uintptr_t>(ids) % 16 == 0;
  const size_t smem = streamseg_smem_bytes(S, D);
  // prefetch when every span's CTA fits on the card at once with it
  const Room room = room_for(load, smem);
  if (room.err) return room.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blocks <= room.sms * room.per_sm)
    launch<true>(load, n_blocks, smem, st, vals, ids, r0, r1, s0, S, D, row_stride, col_stride,
                 ids_vec, out_block, out_slot, out_col, out);
  else
    launch<false>(load, n_blocks, smem, st, vals, ids, r0, r1, s0, S, D, row_stride,
                  col_stride, ids_vec, out_block, out_slot, out_col, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
