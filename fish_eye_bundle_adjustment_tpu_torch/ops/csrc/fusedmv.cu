// Fused banded Schur kernels for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Replaces the two Pallas TPU kernels of fish_eye_bundle_adjustment_tpu/ops/fusedmv.py:
//   K1  _hpp_kernel (launched by fused_hpp_pass)    -> fusedmv_hpp_pass below
//   K2  _kernel     (launched by fused_schur_apply) -> fusedmv_schur_apply below
// The semantics (per group of M tie ranks over the tie-rank-sorted, sqrt(w)-folded
// streams; see ops/fusedmv.py in this package) are the TPU kernels'; the block
// structure is not.  On the TPU the per-tie and per-image couplings are one-hot
// mask contractions on the MXU; here they are sums over runs that the host lays
// out once per problem (ops/fusedmv.py group_index):
//   tie_off   each tie slot's rows are one run of the tie-rank-sorted stream;
//   col_perm  the group's in-band rows ordered by band column, then by row, so
//   col_off   each image column's rows are one run;
//   cover_*   for each 128-image block, the groups whose band covers it.
// Every pass is O(T) per group: no loop visits all rows for each tie slot or
// each image column.
//
// What bounds them on the H100: bytes, and the rounds of loads a group waits
// for.  Every call streams the folded observation streams acam_t (CA x n_pad)
// and apt_t (8 x n_pad): about 130 MB per K2 call at the 1k-image /
// 1M-observation bench block, ~40 us at 3.35 TB/s, against ~200 flops per
// observation -- far below the card's ridge point, so no tensor cores.  One CTA
// per group, 256 threads.
//   K2 takes the group's rows in tiles of 256, one row a thread, the row's
//      streams loaded once into registers (coalesced): a = C v and P = Ap'a
//      per row; the tile's part of each tie run summed by the tie's thread
//      (running sums in shared memory); then b = a - Ap y and the IOP lane
//      terms for each row whose tie ended in the tile, b kept in shared
//      memory.  Rows whose tie runs on into a later tile are finished after
//      the last tile, from a second read of their streams.  Then one thread
//      per band column sums the pose terms of C'b over the column's run.
//      What every tile would otherwise fetch at random -- Hpp^-1 of the
//      group's ties, the band's slice of the camera vector, col_perm -- is put
//      in shared memory once per group, because under the full card's load
//      each dependent round to device memory costs microseconds.  Tiles staged
//      in shared memory by bulk copies (one cp.async.bulk per stream row, the
//      next tile's in flight during this one's tie runs) measured slower on
//      the H100 than these register loads.
//   K1 takes the rows in tiles of 256 as K2 does: each row's thread forms its
//      IOP lane terms, its rounded pose diagonal terms (written to a scratch
//      stream) and its six rounded Hpp terms, and each tie's thread adds the
//      tile's part of its run from shared memory; then each column's thread
//      sums the pose diagonal terms of its run from the scratch stream.
//   K2's column runs read each in-band row's pose columns a second time, by
//      col_perm, from L2 (K1's its pose diagonal terms).  Shared memory per
//      CTA is 10 bytes a span row (K2; 2 in K1) plus ~60 a tie slot (~100
//      with the preconditioner's rounded Hpp^-1), so T up to the band plan's
//      16384 fits, and the band's camera vector (ne * W floats, up to
//      kMaxStagedV) beside it while that fits too: at the plan's caps
//      (T = 16384, W = 2048, M = 128, ne = 6) the matvec takes 228,356 of the
//      232,448 bytes a CTA may have.
//      Past that the camera vector is read from global memory instead.

// K2's column runs are unrolled (4 rows; 2 with the preconditioner's larger
// body) so that the loads of several rows are in flight at once: a run is summed
// by one thread, and each row's loads would otherwise wait a full round to
// memory.
//
// Determinism: CUDA blocks run in no set order, so each CTA writes its own
// partials -- (G, rows, W) for the image band, (G, rows, 128) for lane partials --
// and a second kernel sums them: each image-band output over only the groups whose
// band covers it, in ascending group order; each lane output over all groups in a
// fixed two-level order.  Inside a group every sum is taken in row order by the
// one thread that owns the output.  No float atomics are used anywhere, so a run
// repeats bit for bit; the deferred LM accept/reject of the solver compares cost
// differences against a tiny slack and needs that.
//
// Precision: where the TPU kernels contract a one-hot mask with an operand on
// the MXU, the JAX package's _dot first rounds that operand to bf16 ("bf16") or
// to a bf16 hi + lo pair ("bf16x2"); these kernels round the same values the same
// way (round_operand) and sum in f32.  The arithmetic before each rounding is
// written with __fmul_rn / __fadd_rn, which the compiler never contracts into a
// fused multiply-add, in the order of the plain version in ops/fusedmv.py: both
// then round bit-identical values, and a value near a bf16 rounding boundary goes
// the same way in both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kMaxNE = 6;   // pose unknowns per image
constexpr int kMaxNI = 8;   // IOP unknowns of the shared camera (8 lane-partial rows)
constexpr int kPosePairs = kMaxNE * (kMaxNE + 1) / 2;
constexpr int kIopPairs = kMaxNI * (kMaxNI + 1) / 2;
constexpr int kMaxStagedV = 12288;  // K2 stages vpose's band slice up to ne * W floats

// Products and sums rounded one at a time (never fused), for the values that
// round_operand rounds.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot2(float a, float b, float c, float d) {
  return add(mul(a, b), mul(c, d));
}

// The JAX package's _dot operand: bf16 (nearest even), or for bf16x2 the hi/lo
// pair hi = bf16(x), lo = bf16(x - hi), whose f32 sum is exact.
__device__ __forceinline__ float round_operand(float x, int bf16x2) {
  const float hi = __bfloat162float(__float2bfloat16_rn(x));
  return bf16x2 ? hi + __bfloat162float(__float2bfloat16_rn(x - hi)) : hi;
}

// Rows the group owns inside its span: [max(fr, sb*128), min(er, sb*128 + T)).
__device__ __forceinline__ void group_rows(const int* sb, const int* fr, const int* er,
                                           int g, int T, int* r0, int* n) {
  const int start = sb[g] * 128;
  const int lo = max(fr[g], start);
  const int hi = min(er[g], start + T);
  *r0 = lo;
  *n = max(hi - lo, 0);
}

// Column of image rank `im` inside the band [base, base + W), or -1.
__device__ __forceinline__ int band_col(float imf, int base, int W) {
  const int im = static_cast<int>(imf);
  const int c = im - base;
  return (im >= 0 && c >= 0 && c < W) ? c : -1;
}

// Index of the pair (e, f), e <= f < k, in row-major upper-triangle order.
__host__ __device__ __forceinline__ int sym_index(int e, int f, int k) {
  return e * k - e * (e - 1) / 2 + (f - e);
}

// Per group: the plan's geometry and the host-built index.
struct Plan {
  const float* rel;       // (n_pad) tie slot of each row, -1 for none
  const float* imgrow;    // (n_pad) image rank of each row, -1 for padding
  const int* sb;          // (G) span start / 128
  const int* fr;          // (G) first owned row
  const int* er;          // (G) one past the last owned row
  const int* ib;          // (G) band start / 128
  const int* tie_off;     // (G, M+1)
  const short* col_perm;  // (G, T)
  const int* col_off;     // (G, W+1)
  const int* cover_off;   // (n_img_pad/128 + 1)
  const int* cover_ids;   // (G * W/128)
  int G, M, T, W, n_pad, n_img_pad, ne, ni;
  int bf16x2;             // operand rounding: 0 bf16, 1 bf16 hi + lo
};

// Threads t and t + 128 take rows of the same lane (r % 128): t + 128 leaves its
// k values in lane_s, t adds them after its own.  Returns the lane of t < 128.
template <int K>
__device__ __forceinline__ int combine_lanes(float (&v)[K], int k_live, float* lane_s, int r0) {
  const int t = threadIdx.x;
  if (t >= kLanes) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < k_live) lane_s[k * kLanes + t - kLanes] = v[k];
  }
  __syncthreads();
  if (t < kLanes) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < k_live) v[k] += lane_s[k * kLanes + t];
  }
  return (r0 + t) % kLanes;
}

// ---------------------------------------------------------------------------
// K1: per-tie Hpp sym columns, per-group raw diag(Hcc) band and IOP lanes.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 4)
hpp_group_kernel(const float* __restrict__ acam, const float* __restrict__ apt, const Plan p,
                 float* __restrict__ hs, float* __restrict__ de_part,
                 float* __restrict__ di_part, float* __restrict__ de_terms) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int T = p.T, M = p.M, W = p.W, ne = p.ne, ni = p.ni;
  float* lane_s = smem;                                           // (8, 128)
  float* q_s = lane_s + 8 * kLanes;                               // (6, kThreads) tile terms
  float* h_s = q_s + 6 * kThreads;                                // (6, M) running tie sums
  int* toff_s = reinterpret_cast<int*>(h_s + 6 * M);              // (M + 1)
  short* perm_s = reinterpret_cast<short*>(toff_s + M + 1);       // (T) col_perm
  const size_t n_pad = p.n_pad;
  int r0, n;
  group_rows(p.sb, p.fr, p.er, g, T, &r0, &n);
  const short* perm = p.col_perm + static_cast<size_t>(g) * T;
  for (int k = threadIdx.x; k < T; k += kThreads) perm_s[k] = perm[k];
  const int* toff = p.tie_off + static_cast<size_t>(g) * (M + 1);
  for (int m = threadIdx.x; m <= M; m += kThreads) toff_s[m] = toff[m];
  for (int k = threadIdx.x; k < 6 * M; k += kThreads) h_s[k] = 0.f;
  __syncthreads();

  // rows in tiles of kThreads, one a thread: the IOP lane terms, the row's
  // rounded pose diagonal terms Aex_e^2 + Aey_e^2 into de_terms (read back
  // by the column runs), and its six rounded Hpp terms Apx_a Apx_b +
  // Apy_a Apy_b into q_s; then each tie's thread adds the tile's part of its
  // run in row order (h_s carries the sums across tiles).  So every rounding
  // is done by the rows' threads, none in the runs.
  float li[kMaxNI];
#pragma unroll
  for (int k = 0; k < kMaxNI; ++k) li[k] = 0.f;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int t1 = min(n, t0 + kThreads);
    const int i = t0 + threadIdx.x;
    if (i < t1) {
      const size_t r = r0 + i;
#pragma unroll
      for (int k = 0; k < kMaxNI; ++k) {
        if (k < ni) {
          const float x = acam[(2 * ne + k) * n_pad + r];
          const float y = acam[(2 * ne + ni + k) * n_pad + r];
          li[k] += x * x + y * y;
        }
      }
#pragma unroll
      for (int e = 0; e < kMaxNE; ++e) {
        if (e < ne) {
          const float x = acam[e * n_pad + r];
          const float y = acam[(ne + e) * n_pad + r];
          de_terms[e * n_pad + r] = round_operand(dot2(x, x, y, y), p.bf16x2);
        }
      }
      float px[3], py[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        px[q] = apt[q * n_pad + r];
        py[q] = apt[(3 + q) * n_pad + r];
      }
      int k = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = a; b < 3; ++b, ++k)
          q_s[k * kThreads + threadIdx.x] = round_operand(dot2(px[a], px[b], py[a], py[b]), p.bf16x2);
    }
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += kThreads) {
      const int s = max(toff_s[m], t0), e = min(toff_s[m + 1], t1);
      if (s < e) {
        float h[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) h[k] = h_s[k * M + m];
        for (int j = s; j < e; ++j) {
#pragma unroll
          for (int k = 0; k < 6; ++k) h[k] += q_s[k * kThreads + j - t0];
        }
#pragma unroll
        for (int k = 0; k < 6; ++k) h_s[k * M + m] = h[k];
      }
    }
    __syncthreads();
  }

  // hs[:6, g*M + m] = the tie's sums (0 for a slot without rows)
  const size_t n_cols = static_cast<size_t>(p.G) * M;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const size_t col = static_cast<size_t>(g) * M + m;
#pragma unroll
    for (int k = 0; k < 8; ++k) hs[k * n_cols + col] = k < 6 ? h_s[k * M + m] : 0.f;
  }

  // lanes: di_part[g, k, lane] = sum over owned rows r with r % 128 == lane
  const int lane = combine_lanes(li, ni, lane_s, r0);
  if (threadIdx.x < kLanes) {
    float* out = di_part + static_cast<size_t>(g) * 8 * kLanes + lane;
#pragma unroll
    for (int k = 0; k < kMaxNI; ++k)
      if (k < ni) out[k * kLanes] = li[k];
  }

  // column runs: de_part[g, e, c] = sum over the rows of image column c of
  // their de_terms (this CTA's own writes, published by the barriers above)
  const int* coff = p.col_off + static_cast<size_t>(g) * (W + 1);
  for (int c = threadIdx.x; c < W; c += kThreads) {
    float d[kMaxNE];
#pragma unroll
    for (int e = 0; e < kMaxNE; ++e) d[e] = 0.f;
    const int end = coff[c + 1];
#pragma unroll 4
    for (int k = coff[c]; k < end; ++k) {
      const size_t r = r0 + perm_s[k];
#pragma unroll
      for (int e = 0; e < kMaxNE; ++e)
        if (e < ne) d[e] += de_terms[e * n_pad + r];
    }
    float* out = de_part + static_cast<size_t>(g) * 8 * W + c;
#pragma unroll
    for (int e = 0; e < kMaxNE; ++e)
      if (e < ne) out[e * W] = d[e];
  }
}

// ---------------------------------------------------------------------------
// K2: the fused Schur operator (matvec / rhs + preconditioner / back-substitution).
// ---------------------------------------------------------------------------
struct SchurIO {
  const float* arows;  // (8, n_pad) injected rows, or null
  const float* vpose;  // (8, n_img_pad), or null
  const float* vi;     // (128), or null
  const float* hpi;    // (16, G*M) Hpp^-1 per tie slot, rows 3p+q
  int with_v, with_a, p_rows, i_rows;
  int stage_v;         // vpose's band slice staged in shared memory
  float* pose_part;  // (G, 8, W)
  float* iop_part;   // (G, 8, 128)
  float* out_y;      // (8, G*M)
  float* p21_part;   // (G, p_rows, W)
  float* i55_part;   // (G, i_rows, 128)
};

template <bool kPrecond>
struct RowPass2 {
  // IOP lane terms of C'b (with the preconditioner also the IOP diagonal
  // blocks), accumulated per thread in its rows' order
  float li[kMaxNI + (kPrecond ? kIopPairs : 0)];
};

// A row's streams, as the tile loop keeps them in registers (every index
// known at compile time, so nothing goes to local memory).
struct RowData {
  float ex[kMaxNE], ey[kMaxNE];  // acam rows e and ne + e
  float ix[kMaxNI], iy[kMaxNI];  // acam rows 2 ne + k and 2 ne + ni + k
  float px[3], py[3];            // apt rows q and 3 + q
};

__device__ __forceinline__ void load_row(const float* __restrict__ acam,
                                         const float* __restrict__ apt, size_t n_pad, size_t r,
                                         int ne, int ni, RowData* d) {
#pragma unroll
  for (int e = 0; e < kMaxNE; ++e) {
    d->ex[e] = e < ne ? acam[e * n_pad + r] : 0.f;
    d->ey[e] = e < ne ? acam[(ne + e) * n_pad + r] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kMaxNI; ++k) {
    d->ix[k] = k < ni ? acam[(2 * ne + k) * n_pad + r] : 0.f;
    d->iy[k] = k < ni ? acam[(2 * ne + ni + k) * n_pad + r] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    d->px[q] = apt[q * n_pad + r];
    d->py[q] = apt[(3 + q) * n_pad + r];
  }
}

// The second half of a row, once its tie's y is known (y_s holds it rounded):
// b = a - Ap y, the IOP lane terms, and b kept for the column runs.
template <bool kPrecond>
__device__ __forceinline__ void finish_row(const RowData& d, int i, int m, const Plan& p,
                                           float* ab_s, const float* y_s,
                                           RowPass2<kPrecond>* acc) {
  const int T = p.T, M = p.M, ni = p.ni;
  float bx = ab_s[i], by = ab_s[T + i];
  if (m >= 0 && m < M) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float y = y_s[q * M + m];
      bx = sub(bx, mul(d.px[q], y));
      by = sub(by, mul(d.py[q], y));
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxNI; ++k) acc->li[k] += d.ix[k] * bx + d.iy[k] * by;
  if (kPrecond) {
    int k = kMaxNI;
#pragma unroll
    for (int a = 0; a < kMaxNI; ++a)
#pragma unroll
      for (int b = a; b < kMaxNI; ++b, ++k)
        if (b < ni) acc->li[k] += d.ix[a] * d.ix[b] + d.iy[a] * d.iy[b];
  }
  ab_s[i] = bx;
  ab_s[T + i] = by;
}

// One CTA per group.  The owned rows are taken in tiles of kThreads, one row
// a thread, each row's streams loaded once into registers: a = C v and
// P = Ap'a per row, then the tie runs' sums over the tile (carried across
// tiles in t_s), and, for every row whose tie ends inside the tile, the
// second half at once.  Rows whose tie runs on past the tile are finished
// after the last tile from a second read of their streams (L2).
template <bool kPrecond>
__global__ void __launch_bounds__(kThreads, kPrecond ? 2 : 3)
schur_group_kernel(const float* __restrict__ acam, const float* __restrict__ apt, const Plan p,
                   const SchurIO io) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int T = p.T, M = p.M, W = p.W, ne = p.ne, ni = p.ni;
  float* ab_s = smem;                                // (2, T) a, then b, of each row
  float* p_s = ab_s + 2 * T;                         // (3, kThreads) P of the tile's rows
  float* t_s = p_s + 3 * kThreads;                   // (3, M) running tie sums
  float* y_s = t_s + 3 * M;                          // (3, M) Hpp^-1 t
  float* lane_s = y_s + 3 * M;                       // (lane values, 128)
  float* hpi_s = lane_s + (kMaxNI + (kPrecond ? kIopPairs : 0)) * kLanes;  // (9, M)
  float* hpr_s = hpi_s + 9 * M;                      // (9, M) rounded, preconditioner only
  const bool stage_v = io.stage_v;
  float* v_s = hpr_s + (kPrecond ? 9 * M : 0);       // (ne, W) the band's slice of vpose
  int* toff_s = reinterpret_cast<int*>(v_s + (stage_v ? ne * W : 0));  // (M + 1)
  short* perm_s = reinterpret_cast<short*>(toff_s + M + 1);          // (T) col_perm
  const size_t n_pad = p.n_pad;
  int r0, n;
  group_rows(p.sb, p.fr, p.er, g, T, &r0, &n);
  const int base = p.ib[g] * 128;
  const size_t col0 = static_cast<size_t>(g) * M;
  const size_t n_cols = static_cast<size_t>(p.G) * M;
  // what every tile reads at random -- the tie runs, Hpp^-1 of the group's
  // ties, the band's camera vector -- into shared memory, in one round
  const int* toff = p.tie_off + static_cast<size_t>(g) * (M + 1);
  for (int m = threadIdx.x; m <= M; m += kThreads) toff_s[m] = toff[m];
  for (int k = threadIdx.x; k < 3 * M; k += kThreads) t_s[k] = 0.f;
  for (int k = threadIdx.x; k < 9 * M; k += kThreads) {
    hpi_s[k] = io.hpi[(k / M) * n_cols + col0 + k % M];
    if (kPrecond) hpr_s[k] = round_operand(hpi_s[k], p.bf16x2);
  }
  if (stage_v)
    for (int k = threadIdx.x; k < ne * W; k += kThreads)
      v_s[k] = io.vpose[static_cast<size_t>(k / W) * p.n_img_pad + base + k % W];
  const short* perm = p.col_perm + static_cast<size_t>(g) * T;
  for (int k = threadIdx.x; k < T; k += kThreads) perm_s[k] = perm[k];

  // y = Hpp^-1 t of tie slot m, once its run is summed; the rows take it
  // rounded
  auto finish_tie = [&](int m) {
    const size_t col = col0 + m;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float y = 0.f;
#pragma unroll
      for (int s = 0; s < 3; ++s) y = add(y, mul(hpi_s[(3 * q + s) * M + m], t_s[s * M + m]));
      y_s[q * M + m] = round_operand(y, p.bf16x2);
      io.out_y[q * n_cols + col] = y;
    }
#pragma unroll
    for (int k = 3; k < 8; ++k) io.out_y[k * n_cols + col] = 0.f;
  };

  RowPass2<kPrecond> lt;
#pragma unroll
  for (int k = 0; k < kMaxNI + (kPrecond ? kIopPairs : 0); ++k) lt.li[k] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int t1 = min(n, t0 + kThreads);
    const int i = t0 + threadIdx.x;
    RowData d;
    int m = -1;
    if (i < t1) {
      // a = C v (+ injected rows) and P = Ap'a
      const size_t r = r0 + i;
      load_row(acam, apt, n_pad, r, ne, ni, &d);
      m = static_cast<int>(p.rel[r]);
      float ax = 0.f, ay = 0.f;
      if (io.with_v) {
        const int c = band_col(p.imgrow[r], base, W);
        const float* v = io.vpose + base + max(c, 0);
#pragma unroll
        for (int e = 0; e < kMaxNE; ++e) {
          if (e < ne) {
            const float ve =
                c < 0 ? 0.f
                      : round_operand(stage_v ? v_s[e * W + c]
                                              : v[static_cast<size_t>(e) * p.n_img_pad],
                                      p.bf16x2);
            ax = add(ax, mul(d.ex[e], ve));
            ay = add(ay, mul(d.ey[e], ve));
          }
        }
#pragma unroll
        for (int k = 0; k < kMaxNI; ++k) {
          if (k < ni) {
            const float vk = io.vi[k];
            ax = add(ax, mul(vk, d.ix[k]));
            ay = add(ay, mul(vk, d.iy[k]));
          }
        }
      }
      if (io.with_a) {
        ax = add(ax, io.arows[r]);
        ay = add(ay, io.arows[n_pad + r]);
      }
      ab_s[i] = ax;
      ab_s[T + i] = ay;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        p_s[q * kThreads + threadIdx.x] = round_operand(dot2(d.px[q], ax, d.py[q], ay), p.bf16x2);
    }
    __syncthreads();

    // tie runs: add the tile's part of each run in row order; finish the
    // ties whose run ends in this tile
    for (int mm = threadIdx.x; mm < M; mm += kThreads) {
      const int s = max(toff_s[mm], t0), e = min(toff_s[mm + 1], t1);
      if (s < e) {
        float t[3] = {t_s[mm], t_s[M + mm], t_s[2 * M + mm]};
        for (int k = s; k < e; ++k) {
#pragma unroll
          for (int q = 0; q < 3; ++q) t[q] += p_s[q * kThreads + k - t0];
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) t_s[q * M + mm] = t[q];
        if (toff_s[mm + 1] <= t1) finish_tie(mm);
      }
    }
    __syncthreads();

    const bool tie = m >= 0 && m < M;
    if (i < t1 && (!tie || toff_s[m + 1] <= t1))
      finish_row<kPrecond>(d, i, m, p, ab_s, y_s, &lt);
  }
  // tie slots without rows
  for (int mm = threadIdx.x; mm < M; mm += kThreads)
    if (toff_s[mm] == toff_s[mm + 1]) finish_tie(mm);
  __syncthreads();

  // rows whose tie ran on past their tile, in the same thread's row order
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const size_t r = r0 + i;
    const int m = static_cast<int>(p.rel[r]);
    const int t1 = min(n, i - static_cast<int>(threadIdx.x) + kThreads);  // the row's tile end
    if (m >= 0 && m < M && toff_s[m + 1] > t1) {
      RowData d;
      load_row(acam, apt, n_pad, r, ne, ni, &d);
      finish_row<kPrecond>(d, i, m, p, ab_s, y_s, &lt);
    }
  }

  // lanes: IOP rows of C'b (and the IOP diagonal blocks); the barrier inside
  // also publishes ab_s to the column runs
  const int n_lane_vals = kPrecond ? kMaxNI + kIopPairs : ni;
  const int lane = combine_lanes(lt.li, n_lane_vals, lane_s, r0);
  if (threadIdx.x < kLanes) {
    float* out = io.iop_part + static_cast<size_t>(g) * 8 * kLanes + lane;
#pragma unroll
    for (int k = 0; k < kMaxNI; ++k)
      if (k < ni) out[k * kLanes] = lt.li[k];
    if (kPrecond) {
      float* outi = io.i55_part + static_cast<size_t>(g) * io.i_rows * kLanes + lane;
      int k = kMaxNI;
#pragma unroll
      for (int a = 0; a < kMaxNI; ++a)
#pragma unroll
        for (int b = a; b < kMaxNI; ++b, ++k)
          if (b < ni) outi[sym_index(a, b, ni) * kLanes] = lt.li[k];
    }
  }

  // column runs: pose rows of C'b and the Schur-Jacobi pose blocks per column
  const int* coff = p.col_off + static_cast<size_t>(g) * (W + 1);
  for (int c = threadIdx.x; c < W; c += kThreads) {
    float acc[kMaxNE];
    float sym[kPrecond ? kPosePairs : 1];
#pragma unroll
    for (int e = 0; e < kMaxNE; ++e) acc[e] = 0.f;
#pragma unroll
    for (int k = 0; k < (kPrecond ? kPosePairs : 1); ++k) sym[k] = 0.f;
    const int end = coff[c + 1];
#pragma unroll(kPrecond ? 2 : 4)
    for (int k = coff[c]; k < end; ++k) {
      const int i = perm_s[k];
      const size_t r = r0 + i;
      const float bx = ab_s[i], by = ab_s[T + i];
      float ex[kMaxNE], ey[kMaxNE];
#pragma unroll
      for (int e = 0; e < kMaxNE; ++e) {
        ex[e] = e < ne ? acam[e * n_pad + r] : 0.f;
        ey[e] = e < ne ? acam[(ne + e) * n_pad + r] : 0.f;
        acc[e] += round_operand(dot2(ex[e], bx, ey[e], by), p.bf16x2);
      }
      if (kPrecond) {
        // diag(S) block of the row's image: Hcc - (Ae'Ap) Hpp^-1 (Ap'Ae)
        const int m = static_cast<int>(p.rel[r]);
        const bool tie = m >= 0 && m < M;
        float H[9], px[3], py[3];
#pragma unroll
        for (int q = 0; q < 9; ++q) H[q] = tie ? hpr_s[q * M + m] : 0.f;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          px[q] = apt[q * n_pad + r];
          py[q] = apt[(3 + q) * n_pad + r];
        }
        float B[kMaxNE][3], C[kMaxNE][3];
#pragma unroll
        for (int e = 0; e < kMaxNE; ++e)
#pragma unroll
          for (int q = 0; q < 3; ++q) B[e][q] = dot2(ex[e], px[q], ey[e], py[q]);
#pragma unroll
        for (int e = 0; e < kMaxNE; ++e)
#pragma unroll
          for (int q = 0; q < 3; ++q)
            C[e][q] = add(dot2(B[e][0], H[q], B[e][1], H[3 + q]), mul(B[e][2], H[6 + q]));
        int k2 = 0;
#pragma unroll
        for (int e = 0; e < kMaxNE; ++e) {
#pragma unroll
          for (int f = e; f < kMaxNE; ++f, ++k2) {
            const float corr = add(dot2(C[e][0], B[f][0], C[e][1], B[f][1]), mul(C[e][2], B[f][2]));
            sym[k2] += round_operand(sub(dot2(ex[e], ex[f], ey[e], ey[f]), corr), p.bf16x2);
          }
        }
      }
    }
    float* out = io.pose_part + static_cast<size_t>(g) * 8 * W + c;
#pragma unroll
    for (int e = 0; e < kMaxNE; ++e)
      if (e < ne) out[e * W] = acc[e];
    if (kPrecond) {
      float* outp = io.p21_part + static_cast<size_t>(g) * io.p_rows * W + c;
      int k2 = 0;
#pragma unroll
      for (int e = 0; e < kMaxNE; ++e)
#pragma unroll
        for (int f = e; f < kMaxNE; ++f, ++k2)
          if (f < ne) outp[sym_index(e, f, ne) * W] = sym[k2];
    }
  }
}

// ---------------------------------------------------------------------------
// Second pass: per-group partials -> outputs.  One launch serves up to four
// jobs; a job's rows past `live` are written as zeros without reading the
// partials.
// ---------------------------------------------------------------------------
struct ReduceJob {
  const float* part;  // (G, rows, W) band job, (G, rows, 128) lane job
  float* out;         // (rows, n_img_pad) band job, (rows, 128) lane job
  int rows, live, lanes, blocks;
};
constexpr int kMaxJobs = 4;
struct ReduceArgs {
  ReduceJob job[kMaxJobs];
  int n_jobs;
  const int* ib;
  const int* cover_off;
  const int* cover_ids;
  int G, W, n_img_pad;
};
// Each output is a sum over up to G groups; a serial sum per output would be G
// dependent rounds of L2 latency.  So every output is summed in two levels:
// slices of its groups, each in ascending group order by one thread, then the
// slices in slice order.  Band outputs: 8 slices, contiguous ranges of the
// ascending covering list; lane outputs: 32 slices, g = s (mod 32).
constexpr int kBandSlices = kThreads / 32;  // band blocks: 32 columns x 8 slices
constexpr int kLaneSlices = 32;             // lane blocks: 8 lanes x 32 slices
constexpr int kLaneCols = kThreads / kLaneSlices;
constexpr int kCoverChunk = 1024;  // covering-list entries staged per round
constexpr int kUnroll = 16;        // loads in flight per thread

__host__ __device__ inline int job_blocks(const ReduceJob& j, int n_img_pad) {
  return j.rows * (j.lanes ? kLanes / kLaneCols : n_img_pad / 32);
}

// out[v, j] = sum_g part[g, v, j - 128 ib[g]] over the groups whose band covers
// j's 128-image block: warp w sums the w-th eighth of the ascending covering
// list, then the eight are added in order.
__device__ void band_block(const ReduceJob& job, int b, const ReduceArgs& a) {
  __shared__ int gid_s[kCoverChunk];
  __shared__ int off_s[kCoverChunk];
  __shared__ float slice_s[kBandSlices][32];
  const int n_chunks = a.n_img_pad / 32;
  const int v = b / n_chunks;
  const int j = (b % n_chunks) * 32 + threadIdx.x % 32;
  const int blk = j / kLanes;
  const int w = threadIdx.x / 32;
  const bool live = v < job.live;
  const size_t gstride = static_cast<size_t>(job.rows) * a.W;
  const float* col = job.part + static_cast<size_t>(v) * a.W + j % kLanes;
  const int k0 = a.cover_off[blk], k1 = a.cover_off[blk + 1];
  const int lo = k0 + w * (k1 - k0) / kBandSlices;
  const int hi = k0 + (w + 1) * (k1 - k0) / kBandSlices;
  float s = 0.f;
  for (int c0 = k0; c0 < k1 && live; c0 += kCoverChunk) {
    const int cnt = min(kCoverChunk, k1 - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      const int g = a.cover_ids[c0 + t];
      gid_s[t] = g;
      off_s[t] = (blk - a.ib[g]) * kLanes;
    }
    __syncthreads();
    int k = max(lo, c0) - c0;
    const int end = min(hi, c0 + cnt) - c0;
    for (; k + kUnroll <= end; k += kUnroll) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = col[gid_s[k + u] * gstride + off_s[k + u]];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s += x[u];
    }
    for (; k < end; ++k) s += col[gid_s[k] * gstride + off_s[k]];
  }
  slice_s[w][threadIdx.x % 32] = s;
  __syncthreads();
  if (w == 0) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kBandSlices; ++k) t += slice_s[k][threadIdx.x];
    job.out[static_cast<size_t>(v) * a.n_img_pad + j] = t;
  }
}

// out[v, l] = sum_g part[g, v, l]: thread slice s sums the groups g = s
// (mod 32) in ascending order, then the 32 slices are added in order.
__device__ void lane_block(const ReduceJob& job, int b, const ReduceArgs& a) {
  __shared__ float slice_s[kLaneSlices][kLaneCols];
  const int per_row = kLanes / kLaneCols;
  const int v = b / per_row;
  const int c = threadIdx.x % kLaneCols;
  const int l = (b % per_row) * kLaneCols + c;
  const int w = threadIdx.x / kLaneCols;
  float s = 0.f;
  if (v < job.live) {
    const size_t gstride = static_cast<size_t>(job.rows) * kLanes;
    const float* col = job.part + static_cast<size_t>(v) * kLanes + l;
    int g = w;
    for (; g + (kUnroll - 1) * kLaneSlices < a.G; g += kUnroll * kLaneSlices) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = col[(g + u * kLaneSlices) * gstride];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s += x[u];
    }
    for (; g < a.G; g += kLaneSlices) s += col[g * gstride];
  }
  slice_s[w][c] = s;
  __syncthreads();
  if (w == 0) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kLaneSlices; ++k) t += slice_s[k][c];
    job.out[static_cast<size_t>(v) * kLanes + l] = t;
  }
}

__global__ void __launch_bounds__(kThreads) reduce_kernel(const ReduceArgs a) {
  int b = blockIdx.x;
  int j = 0;
  while (j + 1 < a.n_jobs && b >= a.job[j].blocks) b -= a.job[j++].blocks;
  if (a.job[j].lanes)
    lane_block(a.job[j], b, a);
  else
    band_block(a.job[j], b, a);
}

int launch_reduce(ReduceArgs a, cudaStream_t s) {
  int blocks = 0;
  for (int j = 0; j < a.n_jobs; ++j) {
    a.job[j].blocks = job_blocks(a.job[j], a.n_img_pad);
    blocks += a.job[j].blocks;
  }
  reduce_kernel<<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

ReduceArgs reduce_args(const Plan& p) {
  ReduceArgs a{};
  a.ib = p.ib;
  a.cover_off = p.cover_off;
  a.cover_ids = p.cover_ids;
  a.G = p.G;
  a.W = p.W;
  a.n_img_pad = p.n_img_pad;
  return a;
}

void add_job(ReduceArgs* a, const float* part, float* out, int rows, int live, int lanes) {
  a->job[a->n_jobs++] = ReduceJob{part, out, rows, live, lanes, 0};
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

Plan make_plan(const float* rel, const float* imgrow, const int* sb, const int* fr,
               const int* er, const int* ib, const int* tie_off, const short* col_perm,
               const int* col_off, const int* cover_off, const int* cover_ids, int G, int M,
               int T, int W, int n_pad, int n_img_pad, int ne, int ni, int bf16x2) {
  return Plan{rel,       imgrow,    sb, fr, er, ib,    tie_off,   col_perm, col_off,
              cover_off, cover_ids, G,  M,  T,  W,  n_pad, n_img_pad, ne,       ni, bf16x2};
}

// K2 without the camera vector; it stages vpose's band slice (ne * W floats)
// when it has one, ne * W <= kMaxStagedV and the whole still fits in
// `smem_limit`, the bytes one CTA may have (the caller's ops/_build.SMEM_LIMIT).
size_t schur_smem_unstaged(int T, int M, int with_precond) {
  const size_t lane_vals = kMaxNI + (with_precond ? kIopPairs : 0);
  const size_t tie_vals = with_precond ? 24 : 15;
  return (2 * static_cast<size_t>(T) + 3 * kThreads + tie_vals * M +
          lane_vals * kLanes) * sizeof(float) +
         (M + 1) * sizeof(int) + static_cast<size_t>(T) * sizeof(short);
}

bool schur_stage_v(int T, int M, int W, int ne, int with_v, int with_precond,
                   size_t smem_limit) {
  const size_t v = static_cast<size_t>(ne) * W;
  return with_v && v <= kMaxStagedV &&
         schur_smem_unstaged(T, M, with_precond) + v * sizeof(float) <= smem_limit;
}

}  // namespace

extern "C" {

int fusedmv_abi_version() { return 5; }

const char* fusedmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of one CTA.
size_t fusedmv_hpp_smem_bytes(int T, int M) {
  return (8 * kLanes + 6 * kThreads + 6 * static_cast<size_t>(M)) * sizeof(float) +
         (M + 1) * sizeof(int) + static_cast<size_t>(T) * sizeof(short);
}

size_t fusedmv_schur_smem_bytes(int T, int M, int W, int ne, int with_v, int with_precond,
                                size_t smem_limit) {
  const bool v = schur_stage_v(T, M, W, ne, with_v, with_precond, smem_limit);
  return schur_smem_unstaged(T, M, with_precond) + (v ? static_cast<size_t>(ne) * W : 0) * sizeof(float);
}

// K1.  hs (8, G*M); de_part (G, 8, W), di_part (G, 8, 128) and de_terms
// (ne, n_pad) are scratch;
// de (8, n_img_pad) and di (8, 128) the reduced outputs.
int fusedmv_hpp_pass(const float* acam, const float* apt, const float* rel,
                     const float* imgrow, const int* sb, const int* fr, const int* er,
                     const int* ib, const int* tie_off, const short* col_perm,
                     const int* col_off, const int* cover_off, const int* cover_ids, int G,
                     int M, int T, int W, int n_pad, int n_img_pad, int ne, int ni,
                     int bf16x2, float* hs, float* de_part, float* di_part,
                     float* de_terms, float* de, float* di, void* stream) {
  if (ne > kMaxNE || ni > kMaxNI) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(rel, imgrow, sb, fr, er, ib, tie_off, col_perm, col_off, cover_off,
                           cover_ids, G, M, T, W, n_pad, n_img_pad, ne, ni, bf16x2);
  const size_t smem = fusedmv_hpp_smem_bytes(T, M);
  const void* fn = reinterpret_cast<const void*>(hpp_group_kernel);
  int err = set_smem(fn, smem);
  if (err) return err;
  if (G > 0) {
    hpp_group_kernel<<<G, kThreads, smem, s>>>(acam, apt, p, hs, de_part, di_part, de_terms);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  ReduceArgs a = reduce_args(p);
  add_job(&a, de_part, de, 8, ne, 0);
  add_job(&a, di_part, di, 8, ni, 1);
  return launch_reduce(a, s);
}

// K2.  out_y (8, G*M); pose_part (G, 8, W), iop_part (G, 8, 128), p21_part
// (G, p_rows, W) and i55_part (G, i_rows, 128) are scratch; out_pose
// (8, n_img_pad), out_iop (8, 128), out_p21 (p_rows, n_img_pad) and out_i55
// (i_rows, 128) the reduced outputs.  arows / vpose+vi / the precond buffers
// may be null when with_a / with_v / with_precond is 0.
int fusedmv_schur_apply(const float* acam, const float* apt, const float* rel,
                        const float* imgrow, const float* arows, const float* vpose,
                        const float* vi, const float* hpi, const int* sb, const int* fr,
                        const int* er, const int* ib, const int* tie_off, const short* col_perm,
                        const int* col_off, const int* cover_off, const int* cover_ids, int G,
                        int M, int T, int W, int n_pad, int n_img_pad, int ne, int ni,
                        int with_v, int with_a, int with_precond, int p_rows, int i_rows,
                        int bf16x2, size_t smem_limit, float* pose_part, float* iop_part,
                        float* out_y,
                        float* p21_part, float* i55_part, float* out_pose, float* out_iop,
                        float* out_p21, float* out_i55, void* stream) {
  if (ne > kMaxNE || ni > kMaxNI) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(rel, imgrow, sb, fr, er, ib, tie_off, col_perm, col_off, cover_off,
                           cover_ids, G, M, T, W, n_pad, n_img_pad, ne, ni, bf16x2);
  const int stage_v = schur_stage_v(T, M, W, ne, with_v, with_precond, smem_limit);
  const SchurIO io{arows,  vpose,  vi,      hpi,       with_v,   with_a, p_rows,
                   i_rows, stage_v, pose_part, iop_part, out_y,   p21_part, i55_part};
  const size_t smem = fusedmv_schur_smem_bytes(T, M, W, ne, with_v, with_precond, smem_limit);
  const void* fn = with_precond ? reinterpret_cast<const void*>(schur_group_kernel<true>)
                                : reinterpret_cast<const void*>(schur_group_kernel<false>);
  int err = set_smem(fn, smem);
  if (err) return err;
  if (G > 0) {
    if (with_precond)
      schur_group_kernel<true><<<G, kThreads, smem, s>>>(acam, apt, p, io);
    else
      schur_group_kernel<false><<<G, kThreads, smem, s>>>(acam, apt, p, io);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  ReduceArgs a = reduce_args(p);
  add_job(&a, pose_part, out_pose, 8, ne, 0);
  add_job(&a, iop_part, out_iop, 8, ni, 1);
  if (with_precond) {
    add_job(&a, p21_part, out_p21, p_rows, ne * (ne + 1) / 2, 0);
    add_job(&a, i55_part, out_i55, i_rows, ni * (ni + 1) / 2, 1);
  }
  return launch_reduce(a, s);
}

// Resident CTAs per SM of a group kernel (0: K1, 1: K2, 2: K2 with the
// preconditioner) at `smem` bytes of dynamic shared memory; -1 on error.
int fusedmv_occupancy(int kernel, size_t smem) {
  const void* fn = kernel == 0   ? reinterpret_cast<const void*>(hpp_group_kernel)
                   : kernel == 1 ? reinterpret_cast<const void*>(schur_group_kernel<false>)
                                 : reinterpret_cast<const void*>(schur_group_kernel<true>);
  int n = 0;
  if (set_smem(fn, smem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

// The reduce alone, on given partials (one band and one lane job), for tests.
int fusedmv_reduce(const float* band_part, const float* lane_part, const int* ib,
                   const int* cover_off, const int* cover_ids, int G, int W, int n_img_pad,
                   int band_rows, int band_live, int lane_rows, int lane_live, float* band_out,
                   float* lane_out, void* stream) {
  ReduceArgs a{};
  a.ib = ib;
  a.cover_off = cover_off;
  a.cover_ids = cover_ids;
  a.G = G;
  a.W = W;
  a.n_img_pad = n_img_pad;
  add_job(&a, band_part, band_out, band_rows, band_live, 0);
  add_job(&a, lane_part, lane_out, lane_rows, lane_live, 1);
  return launch_reduce(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
