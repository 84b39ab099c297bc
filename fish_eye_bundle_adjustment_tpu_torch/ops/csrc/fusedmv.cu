// Fused banded Schur kernels for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Replaces the two Pallas TPU kernels of fish_eye_bundle_adjustment_tpu/ops/fusedmv.py:
//   K1  _hpp_kernel (launched by fused_hpp_pass)    -> fusedmv_hpp_pass below
//   K2  _kernel     (launched by fused_schur_apply) -> fusedmv_schur_apply below
// The semantics (per group of M tie ranks over the tie-rank-sorted, sqrt(w)-folded
// streams; see ops/fusedmv.py in this package) are the TPU kernels'; the block
// structure is not.
//
// What bounds them on the H100: bytes.  Every call streams the folded observation
// streams acam_t (CA x n_pad) and apt_t (8 x n_pad): about 130 MB per K2 call at
// the 1k-image / 1M-observation bench block, i.e. ~40 us at 3.35 TB/s, against a
// few hundred FLOPs per observation.  This first version is the simple, correct
// one: one CTA per group; the group's rows are read coalesced once into shared
// memory state (a = C v per row, image column, tie slot), and the rest runs on
// shared memory and L2.  Making it reach the byte bound (TMA staging of the
// spans, persistent CTAs, fewer scattered re-reads in the image-band pass) is
// later work.
//
// Determinism: the TPU kernels accumulate the image-band and lane outputs in
// VMEM group after group in grid order.  CUDA blocks run in no set order, so
// each CTA writes its own partials -- (G, rows, W) for the image band, (G, rows,
// 128) for lane partials -- and a second pass sums them per column in group
// order.  Inside a group every sum is taken in row order by the one thread that
// owns the output (tie slot, image column or lane).  No float atomics are used
// anywhere, so a run repeats bit for bit; the deferred LM accept/reject of the
// solver compares cost differences against a tiny slack and needs that.
//
// Precision: everything is f32 with f32 accumulation.  The TPU kernels split
// operands into bf16 hi/lo only because the MXU truncates f32; there is no such
// split here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kMaxNE = 6;   // pose unknowns per image
constexpr int kMaxNI = 8;   // IOP unknowns of the shared camera (8 lane-partial rows)

// Rows the group owns inside its DMA window: [max(fr, sb*128), min(er, sb*128 + T)).
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

// ---------------------------------------------------------------------------
// K1: per-tie Hpp sym columns, per-group raw diag(Hcc) band and IOP lanes.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
hpp_group_kernel(const float* __restrict__ acam, const float* __restrict__ apt,
                 const float* __restrict__ rel, const float* __restrict__ imgrow,
                 const int* __restrict__ sb, const int* __restrict__ fr,
                 const int* __restrict__ er, const int* __restrict__ ib,
                 int n_pad, int M, int T, int W, int ne, int ni, int n_cols,
                 float* __restrict__ hs, float* __restrict__ de_part,
                 float* __restrict__ di_part) {
  extern __shared__ short smem_s[];
  short* img_s = smem_s;      // (T) band column of each owned row, -1 outside
  short* rel_s = smem_s + T;  // (T) tie slot in the group, -1 for control rows
  const int g = blockIdx.x;
  int r0, n;
  group_rows(sb, fr, er, g, T, &r0, &n);
  const int base = ib[g] * 128;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    img_s[i] = static_cast<short>(band_col(imgrow[r0 + i], base, W));
    rel_s[i] = static_cast<short>(rel[r0 + i]);
  }
  __syncthreads();

  // hs[:6, g*M + m] = sum over the tie's rows of Apx_a Apx_b + Apy_a Apy_b
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < n; ++i) {
      if (rel_s[i] != m) continue;
      const int r = r0 + i;
      float px[3], py[3];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        px[p] = apt[p * n_pad + r];
        py[p] = apt[(3 + p) * n_pad + r];
      }
      int k = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = a; b < 3; ++b) h[k++] += px[a] * px[b] + py[a] * py[b];
    }
    const size_t col = static_cast<size_t>(g) * M + m;
#pragma unroll
    for (int k = 0; k < 8; ++k) hs[k * static_cast<size_t>(n_cols) + col] = k < 6 ? h[k] : 0.f;
  }

  // de_part[g, e, c] = sum over rows of image column c of Aex_e^2 + Aey_e^2
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    float d[kMaxNE];
#pragma unroll
    for (int e = 0; e < kMaxNE; ++e) d[e] = 0.f;
    for (int i = 0; i < n; ++i) {
      if (img_s[i] != c) continue;
      const int r = r0 + i;
#pragma unroll
      for (int e = 0; e < kMaxNE; ++e) {
        if (e < ne) {
          const float x = acam[e * n_pad + r];
          const float y = acam[(ne + e) * n_pad + r];
          d[e] += x * x + y * y;
        }
      }
    }
    float* out = de_part + static_cast<size_t>(g) * 8 * W + c;
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e * W] = e < ne ? d[e] : 0.f;
  }

  // di_part[g, k, lane] = sum over owned rows r with r % 128 == lane
  for (int l = threadIdx.x; l < kLanes; l += blockDim.x) {
    const int first = r0 + ((l - r0 % kLanes) + kLanes) % kLanes;
    float* out = di_part + static_cast<size_t>(g) * 8 * kLanes + l;
    for (int k = 0; k < 8; ++k) {
      float s = 0.f;
      if (k < ni) {
        for (int r = first; r < r0 + n; r += kLanes) {
          const float x = acam[(2 * ne + k) * n_pad + r];
          const float y = acam[(2 * ne + ni + k) * n_pad + r];
          s += x * x + y * y;
        }
      }
      out[k * kLanes] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// K2: the fused Schur operator (matvec / rhs + preconditioner / back-substitution).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
schur_group_kernel(const float* __restrict__ acam, const float* __restrict__ apt,
                   const float* __restrict__ rel, const float* __restrict__ imgrow,
                   const float* __restrict__ arows, const float* __restrict__ vpose,
                   const float* __restrict__ vi, const float* __restrict__ hpi,
                   const int* __restrict__ sb, const int* __restrict__ fr,
                   const int* __restrict__ er, const int* __restrict__ ib,
                   int n_pad, int n_img_pad, int M, int T, int W, int ne, int ni,
                   int n_cols, int with_v, int with_a, int with_precond,
                   int p_rows, int i_rows,
                   float* __restrict__ pose_part, float* __restrict__ iop_part,
                   float* __restrict__ out_y, float* __restrict__ p21_part,
                   float* __restrict__ i55_part) {
  extern __shared__ float smem_f[];
  float* bx_s = smem_f;                                 // (T) a, then b, x rows
  float* by_s = smem_f + T;                             // (T) a, then b, y rows
  float* y_s = smem_f + 2 * T;                          // (3, M) Hpp^-1 t per tie
  short* img_s = reinterpret_cast<short*>(y_s + 3 * M); // (T) band column or -1
  short* rel_s = img_s + T;                             // (T) tie slot or -1
  const int g = blockIdx.x;
  int r0, n;
  group_rows(sb, fr, er, g, T, &r0, &n);
  const int base = ib[g] * 128;
  const size_t col0 = static_cast<size_t>(g) * M;

  // a = C v (+ injected rows), on the group's own rows
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = r0 + i;
    const int c = band_col(imgrow[r], base, W);
    float ax = 0.f, ay = 0.f;
    if (with_v) {
      if (c >= 0) {
        const int im = base + c;
#pragma unroll
        for (int e = 0; e < kMaxNE; ++e) {
          if (e < ne) {
            const float v = vpose[e * n_img_pad + im];
            ax += acam[e * n_pad + r] * v;
            ay += acam[(ne + e) * n_pad + r] * v;
          }
        }
      }
      for (int k = 0; k < ni; ++k) {
        ax += vi[k] * acam[(2 * ne + k) * n_pad + r];
        ay += vi[k] * acam[(2 * ne + ni + k) * n_pad + r];
      }
    }
    if (with_a) {
      ax += arows[r];
      ay += arows[n_pad + r];
    }
    bx_s[i] = ax;
    by_s[i] = ay;
    img_s[i] = static_cast<short>(c);
    rel_s[i] = static_cast<short>(rel[r]);
  }
  __syncthreads();

  // t = per-tie sum of Ap' a;  y = Hpp^-1 t
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float t[3] = {0.f, 0.f, 0.f};
    for (int i = 0; i < n; ++i) {
      if (rel_s[i] != m) continue;
      const int r = r0 + i;
      const float ax = bx_s[i], ay = by_s[i];
#pragma unroll
      for (int p = 0; p < 3; ++p) t[p] += apt[p * n_pad + r] * ax + apt[(3 + p) * n_pad + r] * ay;
    }
    const size_t col = col0 + m;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float y = 0.f;
#pragma unroll
      for (int q = 0; q < 3; ++q) y += hpi[(3 * p + q) * static_cast<size_t>(n_cols) + col] * t[q];
      y_s[p * M + m] = y;
      out_y[p * static_cast<size_t>(n_cols) + col] = y;
    }
#pragma unroll
    for (int k = 3; k < 8; ++k) out_y[k * static_cast<size_t>(n_cols) + col] = 0.f;
  }
  __syncthreads();

  // b = a - Ap Y
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int m = rel_s[i];
    if (m < 0 || m >= M) continue;
    const int r = r0 + i;
    float bx = bx_s[i], by = by_s[i];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const float y = y_s[p * M + m];
      bx -= apt[p * n_pad + r] * y;
      by -= apt[(3 + p) * n_pad + r] * y;
    }
    bx_s[i] = bx;
    by_s[i] = by;
  }
  __syncthreads();

  // image-band outputs: pose rows of C' b, and the Schur-Jacobi pose blocks
  constexpr int kPairs = kMaxNE * (kMaxNE + 1) / 2;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    float acc[kMaxNE];
    float sym[kPairs];
#pragma unroll
    for (int e = 0; e < kMaxNE; ++e) acc[e] = 0.f;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) sym[k] = 0.f;
    for (int i = 0; i < n; ++i) {
      if (img_s[i] != c) continue;
      const int r = r0 + i;
      const float bx = bx_s[i], by = by_s[i];
      float ex[kMaxNE], ey[kMaxNE];
#pragma unroll
      for (int e = 0; e < kMaxNE; ++e) {
        ex[e] = e < ne ? acam[e * n_pad + r] : 0.f;
        ey[e] = e < ne ? acam[(ne + e) * n_pad + r] : 0.f;
        acc[e] += ex[e] * bx + ey[e] * by;
      }
      if (with_precond) {
        // diag(S) block of the row's image: Hcc - (Ae'Ap) Hpp^-1 (Ap'Ae)
        const int m = rel_s[i];
        float H[9], px[3], py[3];
#pragma unroll
        for (int k = 0; k < 9; ++k)
          H[k] = (m >= 0 && m < M) ? hpi[k * static_cast<size_t>(n_cols) + col0 + m] : 0.f;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          px[p] = apt[p * n_pad + r];
          py[p] = apt[(3 + p) * n_pad + r];
        }
        float B[kMaxNE][3], C[kMaxNE][3];
#pragma unroll
        for (int e = 0; e < kMaxNE; ++e)
#pragma unroll
          for (int p = 0; p < 3; ++p) B[e][p] = ex[e] * px[p] + ey[e] * py[p];
#pragma unroll
        for (int e = 0; e < kMaxNE; ++e)
#pragma unroll
          for (int q = 0; q < 3; ++q)
            C[e][q] = B[e][0] * H[q] + B[e][1] * H[3 + q] + B[e][2] * H[6 + q];
        int k = 0;
#pragma unroll
        for (int e = 0; e < kMaxNE; ++e) {
#pragma unroll
          for (int f = e; f < kMaxNE; ++f) {
            const float corr = C[e][0] * B[f][0] + C[e][1] * B[f][1] + C[e][2] * B[f][2];
            sym[k++] += (ex[e] * ex[f] + ey[e] * ey[f]) - corr;
          }
        }
      }
    }
    float* out = pose_part + static_cast<size_t>(g) * 8 * W + c;
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e * W] = e < ne ? acc[e] : 0.f;
    if (with_precond) {
      float* outp = p21_part + static_cast<size_t>(g) * p_rows * W + c;
      const int npair = ne * (ne + 1) / 2;
      for (int k = npair; k < p_rows; ++k) outp[k * W] = 0.f;
      int k = 0;
#pragma unroll
      for (int e = 0; e < kMaxNE; ++e)
#pragma unroll
        for (int f = e; f < kMaxNE; ++f, ++k)
          if (f < ne) outp[sym_index(e, f, ne) * W] = sym[k];
    }
  }

  // lane partials: IOP rows of C' b, and the IOP diagonal blocks
  for (int l = threadIdx.x; l < kLanes; l += blockDim.x) {
    const int first = r0 + ((l - r0 % kLanes) + kLanes) % kLanes;
    float* out = iop_part + static_cast<size_t>(g) * 8 * kLanes + l;
    for (int k = 0; k < 8; ++k) {
      float s = 0.f;
      if (k < ni) {
        for (int r = first; r < r0 + n; r += kLanes) {
          const int i = r - r0;
          s += acam[(2 * ne + k) * n_pad + r] * bx_s[i] +
               acam[(2 * ne + ni + k) * n_pad + r] * by_s[i];
        }
      }
      out[k * kLanes] = s;
    }
    if (with_precond) {
      float* outi = i55_part + static_cast<size_t>(g) * i_rows * kLanes + l;
      int k = 0;
      for (int a = 0; a < ni; ++a) {
        for (int b = a; b < ni; ++b, ++k) {
          float s = 0.f;
          for (int r = first; r < r0 + n; r += kLanes) {
            s += acam[(2 * ne + a) * n_pad + r] * acam[(2 * ne + b) * n_pad + r] +
                 acam[(2 * ne + ni + a) * n_pad + r] * acam[(2 * ne + ni + b) * n_pad + r];
          }
          outi[k * kLanes] = s;
        }
      }
      for (; k < i_rows; ++k) outi[k * kLanes] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// Second pass: per-group partials -> outputs, summed in group order.
// ---------------------------------------------------------------------------
// out[v, j] = sum_g part[g, v, j - 128 ib[g]] over the groups whose band holds j
__global__ void band_reduce_kernel(const float* __restrict__ part, const int* __restrict__ ib,
                                   int G, int rows, int W, int n_img_pad,
                                   float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y;
  if (j >= n_img_pad) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) {
    const int c = j - ib[g] * 128;
    if (c >= 0 && c < W) s += part[(static_cast<size_t>(g) * rows + v) * W + c];
  }
  out[static_cast<size_t>(v) * n_img_pad + j] = s;
}

// out[v, lane] = sum_g part[g, v, lane]
__global__ void lane_reduce_kernel(const float* __restrict__ part, int G, int rows,
                                   float* __restrict__ out) {
  const int l = threadIdx.x;
  const int v = blockIdx.x;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += part[(static_cast<size_t>(g) * rows + v) * kLanes + l];
  out[v * kLanes + l] = s;
}

int launch_reduce(const float* band_part, const float* lane_part, const int* ib,
                  int G, int band_rows, int lane_rows, int W, int n_img_pad,
                  float* band_out, float* lane_out, cudaStream_t s) {
  dim3 grid((n_img_pad + kThreads - 1) / kThreads, band_rows);
  band_reduce_kernel<<<grid, kThreads, 0, s>>>(band_part, ib, G, band_rows, W, n_img_pad,
                                                band_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_reduce_kernel<<<lane_rows, kLanes, 0, s>>>(lane_part, G, lane_rows, lane_out);
  return static_cast<int>(cudaGetLastError());
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

int fusedmv_abi_version() { return 1; }

const char* fusedmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

size_t fusedmv_hpp_smem_bytes(int T) { return 2 * static_cast<size_t>(T) * sizeof(short); }

size_t fusedmv_schur_smem_bytes(int T, int M) {
  return (2 * static_cast<size_t>(T) + 3 * static_cast<size_t>(M)) * sizeof(float) +
         2 * static_cast<size_t>(T) * sizeof(short);
}

// K1.  hs (8, G*M); de_part (G, 8, W) and di_part (G, 8, 128) are scratch;
// de (8, n_img_pad) and di (8, 128) the reduced outputs.
int fusedmv_hpp_pass(const float* acam, const float* apt, const float* rel,
                     const float* imgrow, const int* sb, const int* fr, const int* er,
                     const int* ib, int G, int M, int T, int W, int n_pad, int n_img_pad,
                     int ne, int ni, float* hs, float* de_part, float* di_part, float* de,
                     float* di, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fusedmv_hpp_smem_bytes(T);
  int err = set_smem(reinterpret_cast<const void*>(hpp_group_kernel), smem);
  if (err) return err;
  hpp_group_kernel<<<G, kThreads, smem, s>>>(acam, apt, rel, imgrow, sb, fr, er, ib, n_pad, M,
                                             T, W, ne, ni, G * M, hs, de_part, di_part);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(de_part, di_part, ib, G, 8, 8, W, n_img_pad, de, di, s);
}

// K2.  out_y (8, G*M); pose_part (G, 8, W), iop_part (G, 8, 128), p21_part
// (G, p_rows, W) and i55_part (G, i_rows, 128) are scratch; out_pose
// (8, n_img_pad), out_iop (8, 128), out_p21 (p_rows, n_img_pad) and out_i55
// (i_rows, 128) the reduced outputs.  arows / vpose+vi / the precond buffers
// may be null when with_a / with_v / with_precond is 0.
int fusedmv_schur_apply(const float* acam, const float* apt, const float* rel,
                        const float* imgrow, const float* arows, const float* vpose,
                        const float* vi, const float* hpi, const int* sb, const int* fr,
                        const int* er, const int* ib, int G, int M, int T, int W, int n_pad,
                        int n_img_pad, int ne, int ni, int with_v, int with_a,
                        int with_precond, int p_rows, int i_rows, float* pose_part,
                        float* iop_part, float* out_y, float* p21_part, float* i55_part,
                        float* out_pose, float* out_iop, float* out_p21, float* out_i55,
                        void* stream) {
  if (ne > kMaxNE || ni > kMaxNI) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fusedmv_schur_smem_bytes(T, M);
  int err = set_smem(reinterpret_cast<const void*>(schur_group_kernel), smem);
  if (err) return err;
  schur_group_kernel<<<G, kThreads, smem, s>>>(
      acam, apt, rel, imgrow, arows, vpose, vi, hpi, sb, fr, er, ib, n_pad, n_img_pad, M, T, W,
      ne, ni, G * M, with_v, with_a, with_precond, p_rows, i_rows, pose_part, iop_part, out_y,
      p21_part, i55_part);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = launch_reduce(pose_part, iop_part, ib, G, 8, 8, W, n_img_pad, out_pose, out_iop, s);
  if (err || !with_precond) return err;
  return launch_reduce(p21_part, i55_part, ib, G, p_rows, i_rows, W, n_img_pad, out_p21,
                       out_i55, s);
}

}  // extern "C"
