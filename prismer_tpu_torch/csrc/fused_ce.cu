// Fused tied LM head + label-smoothed cross-entropy, forward and backward,
// for Hopper (sm_90a). The (N, V) logits and their gradient never reach
// device memory.
//
// Replaces prismer_tpu/ops/fused_ce.py:
//   * _ce_stats (the pallas_call at :165): per row n of h (N, D) against the
//     tied embedding emb (V, D) plus the fp32 bias, with
//     x = h . emb_v + bias_v (fp32 sums of compute-dtype products):
//       lse[n] = log sum_v exp(x), sumx[n] = sum_v x, xlab[n] = x[lab[n]];
//   * _ce_grads_kernel (the pallas_call at :255): with the saved lse, the
//     per-row weight gv = g * valid and smoothing s, recompute x and
//       dx = gv * (exp(x - lse) - s / V) - (1 - s) * gv * onehot(lab)
//     then dh = dx . emb (fp32, out in h's dtype), demb = dx^T . h (fp32,
//     out in emb's dtype) and dbias = sum_n dx (fp32).
// JAX's materialising _ce_grads_xla (:297) exists only for the TPU's
// resident-row cap; these kernels take any N.
//
// What bounds it on the H100: at the caption fine-tune shape (N = 116,
// V = 50265, D = 768, bf16) the forward is ~9 GFLOP and the backward ~27
// against a 77 MB embedding, so tensor-core rate and re-reads of emb both
// matter. Every kernel works on one tile shape, 32 rows x 64 vocab rows:
// the 32 feature rows sit in shared memory and the 64 emb rows are streamed
// once per tile (bf16: mma.sync m16n8k16 with fp32 accumulation through
// prismer::mma_rows, one n8 tile of vocab per warp; fp32: FMA, one warp per
// vocab row, prismer::warp_rows_dot). The ragged last vocab tile is masked
// by index; emb rows at or past V are never read, so no 0 * garbage can
// reach dh.
//   * forward: grid (vocab tiles, row chunks) writes per (row, tile) the
//     max, the sum of exp(x - max), the sum of x and the label's logit; a
//     second kernel combines them per row in a fixed order.
//   * dh: one block per (vocab group, row chunk) recomputes its tiles' x,
//     forms dx in shared memory and accumulates its rows' dh over the group
//     in registers; a second kernel sums the groups' partials in a fixed
//     order.
//   * demb / dbias: one block owns a 64-row vocab tile and a 384-column
//     slice of D and walks every row chunk (recomputing x), accumulating
//     demb in registers; the slice-0 block also sums dbias.
// No float atomics anywhere: repeated runs are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using prismer::Vec;
using prismer::warp_max;
using prismer::warp_sum;

constexpr int kRows = 32;      // feature rows per chunk
constexpr int kTileV = 64;     // vocab rows per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLdX = kTileV + 4;   // row stride of the dx tile
constexpr int kDhCols = 768;   // D columns per dh block (4 x 32 x 6)
constexpr int kDembCols = 384; // D columns per demb block (4 x 16 x 6)
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// row stride (elements) of the feature rows in shared memory
template <typename T>
__host__ __device__ inline int ld_h(int D) {
  return std::is_same<T, bf16>::value ? prismer::mma_ldx(D) : D;
}

template <typename T>
size_t smem_bytes(int D) {
  return static_cast<size_t>(kRows) * ld_h<T>(D) * sizeof(T) +
         sizeof(float) * (kRows * kTileV + kRows * kLdX + 3 * kRows);
}

struct Smem {
  float* lg;      // [kRows][kTileV] logits
  float* dx;      // [kRows][kLdX]
  float* lse;     // [kRows]
  float* gv;      // [kRows]
  int* lab;       // [kRows]
};

template <typename T>
__device__ __forceinline__ Smem carve(unsigned char* raw, int D, T** hs) {
  *hs = reinterpret_cast<T*>(raw);
  Smem s;
  s.lg = reinterpret_cast<float*>(*hs + kRows * ld_h<T>(D));
  s.dx = s.lg + kRows * kTileV;
  s.lse = s.dx + kRows * kLdX;
  s.gv = s.lse + kRows;
  s.lab = reinterpret_cast<int*>(s.gv + kRows);
  return s;
}

// lg[r][c] = h[row0 + r] . emb[v0 + c] + bias[v0 + c] for c < min(64, V - v0)
// (rows past N hold zero features); fp32 accumulation
__device__ __forceinline__ void logits_tile(const bf16* hs, int D,
                                            const bf16* __restrict__ emb,
                                            const float* __restrict__ bias,
                                            int V, int v0, float* lg) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[2][1][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) acc[m][0][0] = acc[m][0][1] = acc[m][0][2] =
      acc[m][0][3] = 0.f;
  prismer::mma_rows<2, 1, 1, 2>(hs, prismer::mma_ldx(D), emb, D, 0, D,
                                v0 + warp * 8, V, 0, lane, acc);
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m * 16 + gid + (e >> 1) * 8;
      const int c = warp * 8 + tig * 2 + (e & 1);
      lg[r * kTileV + c] = v0 + c < V ? acc[m][0][e] + bias[v0 + c] : 0.f;
    }
  }
}

__device__ __forceinline__ void logits_tile(const float* hs, int D,
                                            const float* __restrict__ emb,
                                            const float* __restrict__ bias,
                                            int V, int v0, float* lg) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tv = min(kTileV, V - v0);
  for (int vi = warp; vi < tv; vi += kWarps) {
    float acc[kRows];
#pragma unroll
    for (int n = 0; n < kRows; ++n) acc[n] = 0.f;
    prismer::warp_rows_dot<float, kRows>(
        emb + static_cast<size_t>(v0 + vi) * D, hs, D, D, lane, acc);
    const float bv = bias[v0 + vi];
#pragma unroll
    for (int n = 0; n < kRows; ++n) {
      const float x = warp_sum(acc[n]) + bv;
      if (lane == n) lg[n * kTileV + vi] = x;
    }
  }
}

// the chunk's feature rows and their per-row stats; rows past N get zero
// features and gv = 0
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ h, int N,
                                           int D, int row0, T* hs,
                                           const Smem& s, const int* labels,
                                           const float* gv, const float* lse) {
  const int rows = min(kRows, N - row0);
  prismer::load_rows<T, kRows>(h, D, row0, rows, 0, D, hs, ld_h<T>(D));
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const bool in = r < rows;
    s.lab[r] = in ? labels[row0 + r] : -1;
    if (gv != nullptr) {
      s.gv[r] = in ? gv[row0 + r] : 0.f;
      s.lse[r] = in ? lse[row0 + r] : 0.f;
    }
  }
}

// dx of the tile (rows past N and vocab past V are 0)
__device__ __forceinline__ void dx_tile(const Smem& s, int rows, int v0,
                                        int tv, float s_over_v,
                                        float one_minus_s) {
  for (int e = threadIdx.x; e < kRows * kTileV; e += kThreads) {
    const int r = e / kTileV;
    const int c = e - r * kTileV;
    float dx = 0.f;
    if (r < rows && c < tv) {
      const float pr = expf(s.lg[r * kTileV + c] - s.lse[r]);
      dx = s.gv[r] * (pr - s_over_v);
      if (v0 + c == s.lab[r]) dx -= one_minus_s * s.gv[r];
    }
    s.dx[r * kLdX + c] = dx;
  }
}

// ---------------------------------------------------------------------------
// forward: grid (ntiles, ceil(N / 32)); partials (N, ntiles) x 4
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_stats_kernel(const T* __restrict__ h, const T* __restrict__ emb,
                const float* __restrict__ bias, const int* __restrict__ labels,
                float* __restrict__ pmax, float* __restrict__ psum,
                float* __restrict__ psumx, float* __restrict__ pxlab, int N,
                int D, int V, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs;
  const Smem s = carve<T>(smem_raw, D, &hs);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, N - row0);
  const int v0 = blockIdx.x * kTileV;
  const int tv = min(kTileV, V - v0);

  load_chunk<T>(h, N, D, row0, hs, s, labels, nullptr, nullptr);
  __syncthreads();
  logits_tile(hs, D, emb, bias, V, v0, s.lg);
  __syncthreads();

  for (int n = warp; n < rows; n += kWarps) {
    const float* r = s.lg + n * kTileV;
    const bool in0 = lane < tv, in1 = lane + 32 < tv;
    const float x0 = in0 ? r[lane] : -INFINITY;
    const float x1 = in1 ? r[lane + 32] : -INFINITY;
    const float m = warp_max(fmaxf(x0, x1));
    const float e = (in0 ? expf(x0 - m) : 0.f) + (in1 ? expf(x1 - m) : 0.f);
    const float sum = warp_sum(e);
    const float sx = warp_sum((in0 ? x0 : 0.f) + (in1 ? x1 : 0.f));
    if (lane == 0) {
      const int lab = s.lab[n];
      const size_t o = static_cast<size_t>(row0 + n) * ntiles + blockIdx.x;
      pmax[o] = m;
      psum[o] = sum;
      psumx[o] = sx;
      pxlab[o] = (lab >= v0 && lab < v0 + tv) ? r[lab - v0] : 0.f;
    }
  }
}

// one warp per row, tiles combined lane-strided then by the butterfly
__global__ void __launch_bounds__(kThreads)
ce_stats_reduce_kernel(const float* __restrict__ pmax,
                       const float* __restrict__ psum,
                       const float* __restrict__ psumx,
                       const float* __restrict__ pxlab,
                       float* __restrict__ xlab, float* __restrict__ sumx,
                       float* __restrict__ lse, int N, int ntiles) {
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  if (n >= N) return;
  const size_t base = static_cast<size_t>(n) * ntiles;
  float m = -INFINITY;
  for (int t = lane; t < ntiles; t += 32) m = fmaxf(m, pmax[base + t]);
  m = warp_max(m);
  float sum = 0.f, sx = 0.f, xl = 0.f;
  for (int t = lane; t < ntiles; t += 32) {
    sum += psum[base + t] * expf(pmax[base + t] - m);
    sx += psumx[base + t];
    xl += pxlab[base + t];
  }
  sum = warp_sum(sum);
  sx = warp_sum(sx);
  xl = warp_sum(xl);
  if (lane == 0) {
    lse[n] = m + logf(sum);
    sumx[n] = sx;
    xlab[n] = xl;
  }
}

// ---------------------------------------------------------------------------
// dh: grid (groups, ceil(N / 32), ceil(D / 768)); partials (groups, N, D)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dh_kernel(const T* __restrict__ h, const T* __restrict__ emb,
             const float* __restrict__ bias, const int* __restrict__ labels,
             const float* __restrict__ gv, const float* __restrict__ lse,
             float* __restrict__ dh_part, int N, int D, int V, int ntiles,
             int groups, float s_over_v, float one_minus_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs;
  const Smem s = carve<T>(smem_raw, D, &hs);
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;   // rows 4 ty + i, cols 4 tx + 128 c
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, N - row0);
  const int dz = blockIdx.z * kDhCols;
  const int per = (ntiles + groups - 1) / groups;
  const int t0 = blockIdx.x * per;
  const int t1 = min(ntiles, t0 + per);

  load_chunk<T>(h, N, D, row0, hs, s, labels, gv, lse);
  float acc[4][6][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    }
  }

  for (int t = t0; t < t1; ++t) {
    const int v0 = t * kTileV;
    const int tv = min(kTileV, V - v0);
    __syncthreads();  // the chunk is loaded / the previous tile consumed
    logits_tile(hs, D, emb, bias, V, v0, s.lg);
    __syncthreads();
    dx_tile(s, rows, v0, tv, s_over_v, one_minus_s);
    __syncthreads();
    for (int c = 0; c < tv; ++c) {
      const T* erow = emb + static_cast<size_t>(v0 + c) * D;
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = s.dx[(4 * ty + i) * kLdX + c];
#pragma unroll
      for (int cc = 0; cc < 6; ++cc) {
        const int d = dz + 4 * tx + 128 * cc;
        if (d < D) {
          const float4 e4 = load4(erow + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][cc][0] = fmaf(dr[i], e4.x, acc[i][cc][0]);
            acc[i][cc][1] = fmaf(dr[i], e4.y, acc[i][cc][1]);
            acc[i][cc][2] = fmaf(dr[i], e4.z, acc[i][cc][2]);
            acc[i][cc][3] = fmaf(dr[i], e4.w, acc[i][cc][3]);
          }
        }
      }
    }
  }

  float* out = dh_part + static_cast<size_t>(blockIdx.x) * N * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int cc = 0; cc < 6; ++cc) {
      const int d = dz + 4 * tx + 128 * cc;
      if (d < D) {
        store4(out + static_cast<size_t>(row0 + r) * D + d,
               make_float4(acc[i][cc][0], acc[i][cc][1], acc[i][cc][2],
                           acc[i][cc][3]));
      }
    }
  }
}

// dh[n][d] = sum over groups, in order, cast to T
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dh_reduce_kernel(const float* __restrict__ dh_part, T* __restrict__ dh,
                    int groups, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int g = 0; g < groups; ++g) acc += dh_part[g * total + i];
  dh[i] = prismer::from_f<T>(acc);
}

// ---------------------------------------------------------------------------
// demb / dbias: grid (ntiles, ceil(D / 384))
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_demb_kernel(const T* __restrict__ h, const T* __restrict__ emb,
               const float* __restrict__ bias, const int* __restrict__ labels,
               const float* __restrict__ gv, const float* __restrict__ lse,
               T* __restrict__ demb, float* __restrict__ dbias, int N, int D,
               int V, float s_over_v, float one_minus_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs;
  const Smem s = carve<T>(smem_raw, D, &hs);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // vocab 4 ty + i, cols 4 tx + 64 c
  const int v0 = blockIdx.x * kTileV;
  const int tv = min(kTileV, V - v0);
  const int dz = blockIdx.y * kDembCols;
  const int dend = min(D, dz + kDembCols);
  const int ldh = ld_h<T>(D);
  const bool bias_block = blockIdx.y == 0;

  float acc[4][6][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    }
  }
  float db = 0.f;

  for (int row0 = 0; row0 < N; row0 += kRows) {
    const int rows = min(kRows, N - row0);
    __syncthreads();  // the previous chunk is consumed
    load_chunk<T>(h, N, D, row0, hs, s, labels, gv, lse);
    __syncthreads();
    logits_tile(hs, D, emb, bias, V, v0, s.lg);
    __syncthreads();
    dx_tile(s, rows, v0, tv, s_over_v, one_minus_s);
    __syncthreads();
    if (bias_block && tid < kTileV) {
      for (int r = 0; r < rows; ++r) db += s.dx[r * kLdX + tid];
    }
    for (int r = 0; r < rows; ++r) {
      const float4 d4 = load4(s.dx + r * kLdX + 4 * ty);
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
      const T* hrow = hs + r * ldh;
#pragma unroll
      for (int cc = 0; cc < 6; ++cc) {
        const int d = dz + 4 * tx + 64 * cc;
        if (d < dend) {
          const float4 h4 = load4(hrow + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][cc][0] = fmaf(dr[i], h4.x, acc[i][cc][0]);
            acc[i][cc][1] = fmaf(dr[i], h4.y, acc[i][cc][1]);
            acc[i][cc][2] = fmaf(dr[i], h4.z, acc[i][cc][2]);
            acc[i][cc][3] = fmaf(dr[i], h4.w, acc[i][cc][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * ty + i;
    if (c >= tv) continue;
    T* out = demb + static_cast<size_t>(v0 + c) * D;
#pragma unroll
    for (int cc = 0; cc < 6; ++cc) {
      const int d = dz + 4 * tx + 64 * cc;
      if (d < dend) {
        store4(out + d, make_float4(acc[i][cc][0], acc[i][cc][1],
                                    acc[i][cc][2], acc[i][cc][3]));
      }
    }
  }
  if (bias_block && tid < tv) dbias[v0 + tid] = db;
}

template <typename K>
cudaError_t grant(K kernel, size_t bytes, size_t* granted) {
  if (bytes <= *granted) return cudaSuccess;
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

template <typename T>
cudaError_t run_stats(const void* h, const void* emb, const float* bias,
                      const int* labels, float* work, float* xlab,
                      float* sumx, float* lse, int N, int D, int V,
                      int ntiles, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes<T>(D);
  cudaError_t err = grant(ce_stats_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  const size_t np = static_cast<size_t>(N) * ntiles;
  float* pmax = work;
  float* psum = pmax + np;
  float* psumx = psum + np;
  float* pxlab = psumx + np;
  const dim3 grid(ntiles, (N + kRows - 1) / kRows);
  ce_stats_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(emb), bias, labels,
      pmax, psum, psumx, pxlab, N, D, V, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_stats_reduce_kernel<<<(N + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      pmax, psum, psumx, pxlab, xlab, sumx, lse, N, ntiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_grads(const void* h, const void* emb, const float* bias,
                      const int* labels, const float* gv, const float* lse,
                      float* work, void* dh, void* demb, float* dbias, int N,
                      int D, int V, int ntiles, int groups, float s_over_v,
                      float one_minus_s, cudaStream_t st) {
  static size_t granted_dh = 48 * 1024;
  static size_t granted_demb = 48 * 1024;
  const size_t smem = smem_bytes<T>(D);
  const T* ht = static_cast<const T*>(h);
  const T* et = static_cast<const T*>(emb);
  cudaError_t err = grant(ce_dh_kernel<T>, smem, &granted_dh);
  if (err != cudaSuccess) return err;
  err = grant(ce_demb_kernel<T>, smem, &granted_demb);
  if (err != cudaSuccess) return err;
  const dim3 g_dh(groups, (N + kRows - 1) / kRows,
                  (D + kDhCols - 1) / kDhCols);
  ce_dh_kernel<T><<<g_dh, kThreads, smem, st>>>(
      ht, et, bias, labels, gv, lse, work, N, D, V, ntiles, groups, s_over_v,
      one_minus_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(N) * D;
  ce_dh_reduce_kernel<T><<<(total + kThreads - 1) / kThreads, kThreads, 0,
                           st>>>(work, static_cast<T*>(dh), groups, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g_demb(ntiles, (D + kDembCols - 1) / kDembCols);
  ce_demb_kernel<T><<<g_demb, kThreads, smem, st>>>(
      ht, et, bias, labels, gv, lse, static_cast<T*>(demb), dbias, N, D, V,
      s_over_v, one_minus_s);
  return cudaGetLastError();
}

bool shapes_ok(int N, int D, int V, int ntiles, int dtype) {
  return N > 0 && V > 0 && D > 0 && D % 32 == 0 &&
         ntiles == (V + kTileV - 1) / kTileV && (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (h and emb); bias fp32; labels int32 in [0, V).
// work holds 4 * N * ntiles floats, ntiles = ceil(V / 64). Outputs (N,)
// fp32. Returns a cudaError_t (0 on success).
extern "C" int prismer_ce_stats(const void* h, const void* emb,
                                const float* bias, const int* labels,
                                float* work, float* xlab, float* sumx,
                                float* lse, int N, int D, int V, int ntiles,
                                int dtype, void* stream) {
  if (!shapes_ok(N, D, V, ntiles, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? run_stats<float>(h, emb, bias, labels, work, xlab, sumx,
                                       lse, N, D, V, ntiles, st)
                    : run_stats<bf16>(h, emb, bias, labels, work, xlab, sumx,
                                      lse, N, D, V, ntiles, st);
}

// gv, lse (N,) fp32; work holds groups * N * D floats (dh partials). dh
// (N, D) in h's dtype, demb (V, D) in emb's dtype, dbias (V,) fp32.
extern "C" int prismer_ce_grads(const void* h, const void* emb,
                                const float* bias, const int* labels,
                                const float* gv, const float* lse,
                                float* work, void* dh, void* demb,
                                float* dbias, int N, int D, int V, int ntiles,
                                int groups, float s_over_v, float one_minus_s,
                                int dtype, void* stream) {
  if (!shapes_ok(N, D, V, ntiles, dtype) || groups <= 0 || groups > ntiles) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? run_grads<float>(h, emb, bias, labels, gv, lse, work, dh, demb,
                                dbias, N, D, V, ntiles, groups, s_over_v,
                                one_minus_s, st)
             : run_grads<bf16>(h, emb, bias, labels, gv, lse, work, dh, demb,
                               dbias, N, D, V, ntiles, groups, s_over_v,
                               one_minus_s, st);
}
