// Fused tied LM head + label-smoothed cross-entropy, forward and backward,
// for Hopper (sm_90a). The (N, V) fp32 logits never reach device memory.
//
// Replaces prismer_tpu/ops/fused_ce.py:
//   * _ce_stats (the pallas_call at :165): per row n of h (N, D) against the
//     tied embedding emb (V, D) plus the fp32 bias, with
//     x = h . emb_v + bias_v (fp32 sums of compute-dtype products):
//       lse[n] = log sum_v exp(x), sumx[n] = sum_v x, xlab[n] = x[lab[n]];
//   * _ce_grads_kernel (the pallas_call at :255): with the saved lse, the
//     per-row weight gv = g * valid and smoothing s, recompute x and
//       dx = gv * (exp(x - lse) - s / V) - (1 - s) * gv * onehot(lab)
//     then dh = dx . emb (out in h's dtype), demb = dx^T . h (out in emb's
//     dtype) and dbias = sum_n dx (fp32).
// JAX's materialising _ce_grads_xla (:297) and the TPU kernel's resident-row
// cap (_bwd_resident_rows, :106) and 8-row padding exist only for the TPU's
// VMEM; these kernels take any N.
//
// What bounds it on the H100: at the caption fine-tune shape (N = 116,
// V = 50265, D = 768, bf16) each product is 2 N V D = 9 GFLOP against a 77 MB
// embedding, so the forward is bound by the embedding's bytes; at batch 16
// (N = 464) the products are bound by the tensor cores. The bf16 design:
//   * one mainloop for the logits (ce_logits_kernel): a block owns 64 x WG
//     feature rows (one consumer warpgroup per 64 rows, the wgmma M; WG 1, 2
//     or 4 by N) and 128 vocab rows (the N of one m64n128k16 wgmma).
//     Thread 0 feeds a ring of 64-column K chunks by TMA (128-byte
//     swizzle, zero fill past N, V and D): the rows' boxes and the
//     embedding's two 64-row boxes. The embedding's tensor map is encoded
//     once per pointer; its first boxes go out before the programmatic-
//     dependent-launch wait (it is constant during the call) and, in the
//     statistics kernel, carry an L2 evict-first policy (G1 leaves its
//     lines for G3, which streams the embedding next). The feature rows are K-chunked too (at N 116 x
//     D 768 they are 178 KB) and stay in the L2 between vocab tiles. At
//     N <= 256 one block covers every row, so each vocab tile's embedding
//     comes from HBM once; at N 464 the two row tiles of a vocab tile are
//     adjacent in the grid, so the second reads the first's lines from L2.
//   * ce_stats: the mainloop with a statistics epilogue, per (row, vocab
//     tile) the max, the sum of exp(x - max), the sum of x and the label's
//     logit; ce_stats_reduce_kernel combines them per row in a fixed order.
//   * ce_grads: G1 is the mainloop with a gradient epilogue: dx in fp32,
//     rounded once to bf16 into an (N, Vp) scratch (Vp = V rounded up to
//     128; 11.7 MB at N 116), and per (row tile, vocab column) the sum of
//     the unrounded fp32 dx (dbias). G3 (ce_dh_mma_kernel): dh^T = emb^T .
//     dx^T on wgmma, 64 columns of D a warpgroup as M (the embedding read
//     MN-major), the rows as N (64, 128 or 256), K = vocab split over about
//     one block per SM, fp32 partials summed in a fixed order by
//     ce_dh_reduce_kernel. G2 (ce_demb_mma_kernel): demb = dx^T . h, 128
//     vocab rows (two warpgroups) x 128 columns of D a step, K = rows, dx
//     and h both read MN-major, about one block an SM walking (vocab tile,
//     D slice) steps on one ring; it also sums the dbias partials in
//     order. G1's dx and G2's demb go out by TMA stores from swizzled
//     staging boxes, as whole 128-byte lines. Rounding dx to bf16 before
//     the two products is what the TPU kernel's default-precision fp32
//     dot_general does on the MXU; dbias stays fp32 as jnp.sum(dx) does
//     there.
//   * every bf16 kernel launches with programmatic stream serialization and
//     waits for its predecessor in every block before it reads what that
//     wrote and before any write.
// fp32 (the card-side parity runs) keeps the FMA kernels: 32 rows x 64
// vocab tiles, the feature rows in shared memory, one warp per vocab row.
// No float atomics anywhere: repeated runs are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::grid_dep_wait;
using prismer::warp_max;
using prismer::warp_sum;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// ---------------------------------------------------------------------------
// fp32: FMA kernels on 32-row x 64-vocab tiles
// ---------------------------------------------------------------------------

constexpr int kRows = 32;        // feature rows per chunk
constexpr int kFmaTileV = 64;    // vocab rows per tile
constexpr int kLdX = kFmaTileV + 4;   // row stride of the dx tile
constexpr int kDhCols = 768;     // D columns per dh block (4 x 32 x 6)
constexpr int kDembCols = 384;   // D columns per demb block (4 x 16 x 6)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

size_t fma_smem_bytes(int D) {
  return sizeof(float) *
         (static_cast<size_t>(kRows) * D + kRows * kFmaTileV + kRows * kLdX +
          3 * kRows);
}

struct Smem {
  float* lg;      // [kRows][kFmaTileV] logits
  float* dx;      // [kRows][kLdX]
  float* lse;     // [kRows]
  float* gv;      // [kRows]
  int* lab;       // [kRows]
};

__device__ __forceinline__ Smem carve(unsigned char* raw, int D, float** hs) {
  *hs = reinterpret_cast<float*>(raw);
  Smem s;
  s.lg = *hs + kRows * D;
  s.dx = s.lg + kRows * kFmaTileV;
  s.lse = s.dx + kRows * kLdX;
  s.gv = s.lse + kRows;
  s.lab = reinterpret_cast<int*>(s.gv + kRows);
  return s;
}

// lg[r][c] = h[row0 + r] . emb[v0 + c] + bias[v0 + c] for c < min(64, V - v0)
__device__ __forceinline__ void logits_tile(const float* hs, int D,
                                            const float* __restrict__ emb,
                                            const float* __restrict__ bias,
                                            int V, int v0, float* lg) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tv = min(kFmaTileV, V - v0);
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
      if (lane == n) lg[n * kFmaTileV + vi] = x;
    }
  }
}

// the chunk's feature rows and their per-row stats; rows past N get zero
// features and gv = 0
__device__ __forceinline__ void load_chunk(const float* __restrict__ h, int N,
                                           int D, int row0, float* hs,
                                           const Smem& s, const int* labels,
                                           const float* gv, const float* lse) {
  const int rows = min(kRows, N - row0);
  prismer::load_rows<float, kRows>(h, D, row0, rows, 0, D, hs, D);
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
  for (int e = threadIdx.x; e < kRows * kFmaTileV; e += kThreads) {
    const int r = e / kFmaTileV;
    const int c = e - r * kFmaTileV;
    float dx = 0.f;
    if (r < rows && c < tv) {
      const float pr = expf(s.lg[r * kFmaTileV + c] - s.lse[r]);
      dx = s.gv[r] * (pr - s_over_v);
      if (v0 + c == s.lab[r]) dx -= one_minus_s * s.gv[r];
    }
    s.dx[r * kLdX + c] = dx;
  }
}

// forward: grid (ntiles, ceil(N / 32)); partials (N, ntiles) x 4
__global__ void __launch_bounds__(kThreads)
ce_stats_kernel(const float* __restrict__ h, const float* __restrict__ emb,
                const float* __restrict__ bias, const int* __restrict__ labels,
                float* __restrict__ pmax, float* __restrict__ psum,
                float* __restrict__ psumx, float* __restrict__ pxlab, int N,
                int D, int V, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs;
  const Smem s = carve(smem_raw, D, &hs);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, N - row0);
  const int v0 = blockIdx.x * kFmaTileV;
  const int tv = min(kFmaTileV, V - v0);

  load_chunk(h, N, D, row0, hs, s, labels, nullptr, nullptr);
  __syncthreads();
  logits_tile(hs, D, emb, bias, V, v0, s.lg);
  __syncthreads();

  for (int n = warp; n < rows; n += kWarps) {
    const float* r = s.lg + n * kFmaTileV;
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

// dh: grid (groups, ceil(N / 32), ceil(D / 768)); partials (groups, N, D)
__global__ void __launch_bounds__(kThreads)
ce_dh_kernel(const float* __restrict__ h, const float* __restrict__ emb,
             const float* __restrict__ bias, const int* __restrict__ labels,
             const float* __restrict__ gv, const float* __restrict__ lse,
             float* __restrict__ dh_part, int N, int D, int V, int ntiles,
             int groups, float s_over_v, float one_minus_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs;
  const Smem s = carve(smem_raw, D, &hs);
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;   // rows 4 ty + i, cols 4 tx + 128 c
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, N - row0);
  const int dz = blockIdx.z * kDhCols;
  const int per = (ntiles + groups - 1) / groups;
  const int t0 = blockIdx.x * per;
  const int t1 = min(ntiles, t0 + per);

  load_chunk(h, N, D, row0, hs, s, labels, gv, lse);
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
    const int v0 = t * kFmaTileV;
    const int tv = min(kFmaTileV, V - v0);
    __syncthreads();  // the chunk is loaded / the previous tile consumed
    logits_tile(hs, D, emb, bias, V, v0, s.lg);
    __syncthreads();
    dx_tile(s, rows, v0, tv, s_over_v, one_minus_s);
    __syncthreads();
    for (int c = 0; c < tv; ++c) {
      const float* erow = emb + static_cast<size_t>(v0 + c) * D;
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

// demb / dbias: grid (ntiles, ceil(D / 384))
__global__ void __launch_bounds__(kThreads)
ce_demb_kernel(const float* __restrict__ h, const float* __restrict__ emb,
               const float* __restrict__ bias, const int* __restrict__ labels,
               const float* __restrict__ gv, const float* __restrict__ lse,
               float* __restrict__ demb, float* __restrict__ dbias, int N,
               int D, int V, float s_over_v, float one_minus_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs;
  const Smem s = carve(smem_raw, D, &hs);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // vocab 4 ty + i, cols 4 tx + 64 c
  const int v0 = blockIdx.x * kFmaTileV;
  const int tv = min(kFmaTileV, V - v0);
  const int dz = blockIdx.y * kDembCols;
  const int dend = min(D, dz + kDembCols);
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
    load_chunk(h, N, D, row0, hs, s, labels, gv, lse);
    __syncthreads();
    logits_tile(hs, D, emb, bias, V, v0, s.lg);
    __syncthreads();
    dx_tile(s, rows, v0, tv, s_over_v, one_minus_s);
    __syncthreads();
    if (bias_block && tid < kFmaTileV) {
      for (int r = 0; r < rows; ++r) db += s.dx[r * kLdX + tid];
    }
    for (int r = 0; r < rows; ++r) {
      const float4 d4 = load4(s.dx + r * kLdX + 4 * ty);
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
      const float* hrow = hs + r * D;
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
    float* out = demb + static_cast<size_t>(v0 + c) * D;
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

// ---------------------------------------------------------------------------
// both dtypes: the fixed-order reductions
// ---------------------------------------------------------------------------

// one warp per row, tiles combined lane-strided then by the butterfly
__global__ void __launch_bounds__(kThreads)
ce_stats_reduce_kernel(const float* __restrict__ pmax,
                       const float* __restrict__ psum,
                       const float* __restrict__ psumx,
                       const float* __restrict__ pxlab,
                       float* __restrict__ xlab, float* __restrict__ sumx,
                       float* __restrict__ lse, int N, int ntiles) {
  grid_dep_wait();
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

// dh[n][d] = sum over groups, in order, cast to T
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dh_reduce_kernel(const float* __restrict__ dh_part, T* __restrict__ dh,
                    int groups, size_t total) {
  grid_dep_wait();
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int g = 0; g < groups; ++g) acc += dh_part[g * total + i];
  dh[i] = prismer::from_f<T>(acc);
}

// ---------------------------------------------------------------------------
// bf16: TMA rings and wgmma
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;           // K elements per TMA box (128 bytes)
constexpr int kBox = 64 * 128;       // bytes of a 64-row box
constexpr int kTileV = 128;          // vocab rows per logits tile (wgmma N)
constexpr int kWg = 128;             // threads of a consumer warpgroup
constexpr int kDembWg = 2;           // G2: consumer warpgroups, 64 vocab each
constexpr int kDembD = 128;          // G2: D columns per block
constexpr int kDembBlocks = kDembD / 64;

// The launch plan of the bf16 kernels: `make_plan` here and
// ops/fused_ce.ce_plan in Python compute it the same way.
struct Plan {
  // logits (stats and G1): 64 * wg rows x 128 vocab a block; grid
  // (row_tiles, vtiles)
  int wg, row_tiles, vtiles, chunks, stages, smem_stats, smem_dx;
  // G2 (demb): 128 vocab x 128 D a step of e_kchunks row chunks; e_blocks
  // blocks walk the vocab tiles
  int e_blocks, e_dslices, e_kchunks, e_stages, e_smem;
  // G3 (dh^T): 64 * h_wg D x h_nt rows a block, K = vocab split h_ksplit
  // ways, h_per 64-vocab chunks each
  int h_wg, h_nt, h_row_tiles, h_dslices, h_chunks, h_per, h_ksplit,
      h_stages, h_smem;
  // the scratch: dx (N, vp) bf16, dbias partials (row_tiles, vp) fp32, dh
  // partials (h_ksplit, N, D) fp32, in this order
  int64_t vp, dx_bytes, dbias_bytes, dh_bytes;
};

inline int logits_smem(int wg, int stages, bool grad) {
  return 1024 + stages * (wg + 2) * kBox + kTileV * 4 +
         (grad ? wg * 4 * kTileV * 4 : 0) + 2 * stages * 8;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline Plan make_plan(int N, int D, int V, int sms) {
  Plan p;
  p.wg = N <= 64 ? 1 : (N <= 128 ? 2 : 4);
  p.row_tiles = cdiv(N, 64 * p.wg);
  p.vtiles = cdiv(V, kTileV);
  p.chunks = cdiv(D, kChunk);
  p.stages = std::min(p.chunks, p.wg == 2 ? 3 : 4);
  p.smem_stats = logits_smem(p.wg, p.stages, false);
  p.smem_dx = logits_smem(p.wg, p.stages, true);
  p.e_blocks = std::min(p.vtiles, sms);
  p.e_dslices = cdiv(D, kDembD);
  p.e_kchunks = cdiv(N, 64);
  p.e_stages = 4;
  p.e_smem = 1024 + (p.e_stages + 2) * (kDembWg + kDembBlocks) * kBox +
             2 * p.e_stages * 8;
  p.h_nt = N <= 64 ? 64 : (N <= 128 ? 128 : 256);
  p.h_wg = p.h_nt == 256 ? 2 : 4;
  p.h_row_tiles = cdiv(N, p.h_nt);
  p.h_dslices = cdiv(D, 64 * p.h_wg);
  p.vp = static_cast<int64_t>(p.vtiles) * kTileV;
  p.h_chunks = static_cast<int>(p.vp / kChunk);
  const int split = std::max(
      1, std::min(p.h_chunks, sms / (p.h_row_tiles * p.h_dslices)));
  p.h_per = cdiv(p.h_chunks, split);
  p.h_ksplit = cdiv(p.h_chunks, p.h_per);
  p.h_stages = std::min(p.h_per, 4);
  p.h_smem = 1024 + p.h_stages * (p.h_wg * kBox + p.h_nt * 128) +
             2 * p.h_stages * 8;
  p.dx_bytes = static_cast<int64_t>(N) * p.vp * 2;
  p.dbias_bytes = static_cast<int64_t>(p.row_tiles) * p.vp * 4;
  p.dh_bytes = static_cast<int64_t>(p.h_ksplit) * N * D * 4;
  return p;
}

struct LogitsArgs {
  const float* bias;      // (V,)
  const int* labels;      // (N,)
  const float* gv;        // (N,) G1
  const float* lse;       // (N,) G1
  float* pmax;            // (N, vtiles) x 4, stats
  float* psum;
  float* psumx;
  float* pxlab;
  bf16* dx;               // (N, vp), G1
  float* dbias_part;      // (row_tiles, vp), G1
  int N, V, vtiles, chunks, stages;
  int64_t vp;
  float s_over_v, one_minus_s;
};

// The epilogue of a logits tile (see ce_logits_kernel); every thread of
// the block calls it once, after the tile's last product. acc[4j + 2h + e]:
// feature row r0 + 64 w + 16 warp + lane / 4 + 8 h, vocab row v0 + 8 j +
// 2 (lane % 4) + e. The statistics rewrite acc in place (+ bias, -inf past
// V), which costs fewer registers than a second copy. G1 stages dx in
// `stg` (the drained ring) and writes it with TMA stores: full 128-byte
// lines, where the fragment's own stores are 4 bytes.
template <int WG, bool GRAD>
__device__ __forceinline__ void logits_epilogue(float* acc,
                                                const LogitsArgs& a,
                                                const float* bias_s,
                                                float* red, uint8_t* stg,
                                                const CUtensorMap* dxmap,
                                                int r0, int tile) {
  const int tid = threadIdx.x;
  const int w = tid / kWg;
  const int warp = (tid % kWg) / 32;
  const int lane = tid % 32;
  const int q = lane % 4;
  const int v0 = tile * kTileV;
  if constexpr (!GRAD) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 64 * w + 16 * warp + lane / 4 + 8 * h;
      const int lab = row < a.N ? a.labels[row] : -1;
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTileV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * q + e;
          float& x = acc[4 * j + 2 * h + e];
          x = v0 + c < a.V ? x + bias_s[c] : -INFINITY;
          m = fmaxf(m, x);
        }
      }
      m = fmaxf(m, __shfl_xor_sync(kAll, m, 1));
      m = fmaxf(m, __shfl_xor_sync(kAll, m, 2));
      float sum = 0.f, sx = 0.f, xl = 0.f;
#pragma unroll
      for (int j = 0; j < kTileV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * q + e;
          const float x = acc[4 * j + 2 * h + e];
          if (v0 + c < a.V) {
            sum += expf(x - m);
            sx += x;
            if (v0 + c == lab) xl = x;
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sum += __shfl_xor_sync(kAll, sum, o);
        sx += __shfl_xor_sync(kAll, sx, o);
        xl += __shfl_xor_sync(kAll, xl, o);
      }
      if (q == 0 && row < a.N) {
        const size_t o = static_cast<size_t>(row) * a.vtiles + tile;
        a.pmax[o] = m;
        a.psum[o] = sum;
        a.psumx[o] = sx;
        a.pxlab[o] = xl;
      }
    }
  } else {
    int row[2], lab[2];
    float gw[2], ls[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = r0 + 64 * w + 16 * warp + lane / 4 + 8 * h;
      const bool in = row[h] < a.N;
      lab[h] = in ? a.labels[row[h]] : -1;
      gw[h] = in ? a.gv[row[h]] : 0.f;
      ls[h] = in ? a.lse[row[h]] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kTileV / 8; ++j) {
      float d[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * q + e;
          d[h][e] = 0.f;
          if (row[h] < a.N && v0 + c < a.V) {
            d[h][e] = gw[h] * (expf((acc[4 * j + 2 * h + e] + bias_s[c]) -
                                    ls[h]) -
                               a.s_over_v);
            if (v0 + c == lab[h]) d[h][e] -= a.one_minus_s * gw[h];
          }
        }
        // dx rounded once to bf16 into the staging boxes [w][vocab half]
        // [64 rows][64 vocab] (columns V .. vp get zeros)
        *reinterpret_cast<__nv_bfloat162*>(
            stg + (2 * w + j / 8) * kBox +
            hopper::sw128_offset(row[h] - r0 - 64 * w, 8 * (j % 8) + 2 * q)) =
            __floats2bfloat162_rn(d[h][0], d[h][1]);
      }
      // dbias partial of the tile from the unrounded dx: the thread's two
      // rows, the warp's 16 (butterfly over lane / 4), then the warps in
      // order
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float cs = d[0][e] + d[1][e];
        cs += __shfl_xor_sync(kAll, cs, 4);
        cs += __shfl_xor_sync(kAll, cs, 8);
        cs += __shfl_xor_sync(kAll, cs, 16);
        if (lane < 4) red[(w * 4 + warp) * kTileV + 8 * j + 2 * lane + e] = cs;
      }
    }
    hopper::fence_proxy_async();   // the staging boxes, for the TMA store
    __syncthreads();
    if (tid < kTileV) {
      float sum = 0.f;
      for (int i = 0; i < WG * 4; ++i) sum += red[i * kTileV + tid];
      a.dbias_part[blockIdx.x * a.vp + v0 + tid] = sum;
    }
    if (tid == 0) {   // rows past N are not written
      for (int b = 0; b < 2 * WG; ++b) {
        hopper::tma_store_4d(dxmap, stg + b * kBox, v0 + 64 * (b % 2),
                             r0 + 64 * (b / 2), 0, 0);
      }
      hopper::bulk_commit();
      hopper::bulk_wait_read<0>();   // the ring is read; the grid's end
                                     // makes the writes visible
    }
  }
}

// Logits tiles S = h . emb^T + bias, 64 * WG feature rows (consumer
// warpgroup w: rows 64 w ..) x 128 vocab rows; grid (row tiles, vocab
// tiles), the row tiles of a vocab tile adjacent, two blocks an SM but at
// WG 4, so one block's epilogue runs beside the other's loads. Stage c of
// the ring holds K chunk c: WG boxes of 64 feature rows, then the
// embedding's two 64-row boxes. Thread 0 feeds the ring: it refills a
// stage once every warp has released it (no producer warp, so a block is
// whole warpgroups and the consumers keep 128 registers). GRAD false
// writes the per-(row, tile) statistics, true dx (bf16) and the tile's
// dbias partial.
template <int WG, bool GRAD>
__global__ void __launch_bounds__(WG * kWg, WG == 4 ? 1 : 2)
ce_logits_kernel(const __grid_constant__ CUtensorMap hmap,
                 const __grid_constant__ CUtensorMap emap,
                 const __grid_constant__ CUtensorMap dxmap,
                 const LogitsArgs a) {
  constexpr int kStage = (WG + 2) * kBox;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stages = a.stages;
  uint8_t* ring = hopper::align_1024(smem_raw);
  float* bias_s = reinterpret_cast<float*>(ring + stages * kStage);  // [128]
  float* red = bias_s + kTileV;                       // [WG * 4][128], G1
  uint64_t* full = reinterpret_cast<uint64_t*>(
      red + (GRAD ? WG * 4 * kTileV : 0));
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * WG * 64;
  const int tile = blockIdx.y;
  const int v0 = tile * kTileV;
  const int chunks = a.chunks;
  const int first = min(stages, chunks);

  // the statistics read the embedding once a call: its lines go first.
  // G3 streams it right after G1, so G1 leaves them in the L2
  auto issue_emb = [&](int c, uint64_t policy) {
    uint8_t* dst = ring + (c % stages) * kStage + WG * kBox;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (GRAD) {
        hopper::tma_load_4d(dst + i * kBox, &emap, full + c % stages,
                            c * kChunk, v0 + 64 * i, 0, 0);
      } else {
        hopper::tma_load_4d_hint(dst + i * kBox, &emap, full + c % stages,
                                 c * kChunk, v0 + 64 * i, 0, 0, policy);
      }
    }
  };
  auto issue_rows = [&](int c) {
    uint8_t* dst = ring + (c % stages) * kStage;
#pragma unroll
    for (int w = 0; w < WG; ++w) {
      hopper::tma_load_4d(dst + w * kBox, &hmap, full + c % stages,
                          c * kChunk, r0 + 64 * w, 0, 0);
    }
  };
  const uint64_t policy = hopper::l2_evict_first();
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, WG * 4);
    }
    hopper::mbar_init_fence();
    // the embedding is constant during the call: its first boxes go out
    // before the wait
    for (int c = 0; c < first; ++c) {
      hopper::mbar_arrive_expect_tx(full + c, kStage);
      issue_emb(c, policy);
    }
  }
  grid_dep_wait();
  if (tid == 0) {
    for (int c = 0; c < first; ++c) issue_rows(c);
  }
  if (tid < kTileV) bias_s[tid] = v0 + tid < a.V ? a.bias[v0 + tid] : 0.f;
  __syncthreads();   // barriers initialised, bias staged

  const int w = tid / kWg;
  const int lane = tid % 32;
  const uint32_t ring_a = hopper::smem_addr(ring);
  float acc[kTileV / 2];
#pragma unroll
  for (int i = 0; i < kTileV / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % stages;
    hopper::mbar_wait(full + s, (c / stages) & 1);
    hopper::wgmma_fence();
    const uint32_t st = ring_a + s * kStage;
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {
      hopper::wgmma_sst<kTileV, 0, 0>(
          acc, hopper::kmajor_desc(st + w * kBox + k * 32),
          hopper::kmajor_desc(st + WG * kBox + k * 32), 1);
    }
    hopper::wgmma_commit();
    if (c > 0) {   // the chunk before has been read: free its stage
      const int freed = (c - 1) % stages;
      hopper::wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + freed);
      if (tid == 0 && c - 1 + stages < chunks) {   // and refill it
        hopper::mbar_wait(empty + freed, ((c - 1) / stages) & 1);
        hopper::mbar_arrive_expect_tx(full + freed, kStage);
        issue_emb(c - 1 + stages, policy);
        issue_rows(c - 1 + stages);
      }
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs<kTileV / 2>(acc);
  __syncthreads();   // every product has read the ring: it stages dx now
  logits_epilogue<WG, GRAD>(acc, a, bias_s, red, ring, &dxmap, r0, tile);
}

struct DhArgs {
  float* part;    // (ksplit, N, D)
  int N, D, chunks, per, stages;
};

// G3: dh^T = emb^T . dx^T. Consumer warpgroup w owns D columns d0 + 64 w ..
// (the wgmma M; the embedding box [64 vocab][64 D] read MN-major), the
// block's NT rows are the N (the dx box [NT rows][64 vocab], K-major), and
// K runs over the block's share of the vocab (chunks k0 .. k0 + per - 1).
// grid (row tiles, D slices, ksplit).
template <int WG, int NT>
__global__ void __launch_bounds__(WG * kWg + 32, 1)
ce_dh_mma_kernel(const __grid_constant__ CUtensorMap emap,
                 const __grid_constant__ CUtensorMap dxmap, const DhArgs a) {
  constexpr int kCons = WG * kWg;
  constexpr int kStage = WG * kBox + NT * 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stages = a.stages;
  uint8_t* ring = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kStage);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * NT;
  const int d0 = blockIdx.y * WG * 64;
  const int k0 = blockIdx.z * a.per;
  const int n = min(a.chunks - k0, a.per);
  const int first = min(stages, n);

  auto issue_emb = [&](int i, uint64_t policy) {
    uint8_t* dst = ring + (i % stages) * kStage;
#pragma unroll
    for (int w = 0; w < WG; ++w) {
      hopper::tma_load_4d_hint(dst + w * kBox, &emap, full + i % stages,
                               d0 + 64 * w, (k0 + i) * kChunk, 0, 0, policy);
    }
  };
  auto issue_dx = [&](int i) {
    hopper::tma_load_4d(ring + (i % stages) * kStage + WG * kBox, &dxmap,
                        full + i % stages, (k0 + i) * kChunk, r0, 0, 0);
  };
  if (tid == kCons) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, WG * 4);
    }
    hopper::mbar_init_fence();
    const uint64_t policy = hopper::l2_evict_first();
    for (int i = 0; i < first; ++i) {
      hopper::mbar_arrive_expect_tx(full + i, kStage);
      issue_emb(i, policy);
    }
  }
  grid_dep_wait();
  __syncthreads();

  if (tid >= kCons) {
    if (tid == kCons) {
      const uint64_t policy = hopper::l2_evict_first();
      for (int i = 0; i < first; ++i) issue_dx(i);
      for (int i = stages; i < n; ++i) {
        const int s = i % stages;
        hopper::mbar_wait(empty + s, ((i / stages) - 1) & 1);
        hopper::mbar_arrive_expect_tx(full + s, kStage);
        issue_emb(i, policy);
        issue_dx(i);
      }
    }
    return;
  }

  const int w = tid / kWg;
  const int warp = (tid % kWg) / 32;
  const int lane = tid % 32;
  const uint32_t ring_a = hopper::smem_addr(ring);
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    hopper::mbar_wait(full + s, (i / stages) & 1);
    hopper::wgmma_fence();
    const uint32_t st = ring_a + s * kStage;
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {
      hopper::wgmma_sst<NT, 1, 0>(
          acc, hopper::mnmajor_desc(st + w * kBox + k * 2048),
          hopper::kmajor_desc(st + WG * kBox + k * 32), 1);
    }
    hopper::wgmma_commit();
    if (i > 0) {
      hopper::wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + (i - 1) % stages);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs<NT / 2>(acc);

  // acc[4j + 2h + e]: D column d0 + 64 w + 16 warp + lane / 4 + 8 h, row
  // r0 + 8 j + 2 (lane % 4) + e
  float* out = a.part + static_cast<size_t>(blockIdx.z) * a.N * a.D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = d0 + 64 * w + 16 * warp + lane / 4 + 8 * h;
    if (d >= a.D) continue;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + 8 * j + 2 * (lane % 4) + e;
        if (row < a.N) {
          out[static_cast<size_t>(row) * a.D + d] = acc[4 * j + 2 * h + e];
        }
      }
    }
  }
}

struct DembArgs {
  bf16* demb;                // (V, D)
  float* dbias;              // (V,)
  const float* dbias_part;   // (row_tiles, vp)
  int N, D, V, vtiles, row_tiles, dslices, kchunks, stages;
  int64_t vp;
};

// G2: demb = dx^T . h. About one block an SM walks the 128-row vocab tiles
// blockIdx.x, + gridDim.x, ..., each tile's D slices of 128 columns in
// turn, each slice over the row chunks (K): one flat sequence of steps fed
// through a ring (stage: the dx boxes [64 rows][64 vocab] of the two
// consumer warpgroups, read MN-major as the wgmma A, then the h boxes [64
// rows][64 D] of the slice, MN-major as two n64 B operands), refilled by
// thread 0, so a slice's stores overlap the next slice's loads. Consumer
// warpgroup w owns vocab rows v0 + 64 w ... The block also sums each of its
// tiles' dbias partials in order.
__global__ void __launch_bounds__(kDembWg * kWg, 1)
ce_demb_mma_kernel(const __grid_constant__ CUtensorMap dxmap,
                   const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap dembmap,
                   const DembArgs a) {
  constexpr int kStage = (kDembWg + kDembBlocks) * kBox;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stages = a.stages;
  uint8_t* ring = hopper::align_1024(smem_raw);
  // [slice parity][warpgroup][D block][64 vocab rows][64 D]: a slice's
  // output, double-buffered so its stores drain during the next slice
  uint8_t* stg = ring + stages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + 2 * kDembWg *
                                               kDembBlocks * kBox);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int my_tiles = (a.vtiles - blockIdx.x + nblk - 1) / nblk;
  const int kc = a.kchunks;
  const int per_tile = a.dslices * kc;
  const int total = my_tiles * per_tile;   // the block's steps, in order
  const int first = min(stages, total);

  // step g: row chunk g % kc of D slice (g % per_tile) / kc of local tile
  // g / per_tile
  auto issue_h = [&](int g) {
    uint8_t* dst = ring + (g % stages) * kStage + kDembWg * kBox;
    const int d0 = (g % per_tile) / kc * kDembD;
#pragma unroll
    for (int b = 0; b < kDembBlocks; ++b) {
      hopper::tma_load_4d(dst + b * kBox, &hmap, full + g % stages,
                          d0 + 64 * b, (g % kc) * 64, 0, 0);
    }
  };
  auto issue_dx = [&](int g) {
    uint8_t* dst = ring + (g % stages) * kStage;
    const int v0 = (blockIdx.x + g / per_tile * nblk) * kDembWg * 64;
#pragma unroll
    for (int w = 0; w < kDembWg; ++w) {
      hopper::tma_load_4d(dst + w * kBox, &dxmap, full + g % stages,
                          v0 + 64 * w, (g % kc) * 64, 0, 0);
    }
  };
  auto refill = [&](int g) {   // thread 0, once step g is released
    if (g + stages >= total) return;
    hopper::mbar_wait(empty + g % stages, (g / stages) & 1);
    hopper::mbar_arrive_expect_tx(full + g % stages, kStage);
    issue_h(g + stages);
    issue_dx(g + stages);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kDembWg * 4);
    }
    hopper::mbar_init_fence();
    // the feature rows are not written by the kernels before: before the
    // wait
    for (int g = 0; g < first; ++g) {
      hopper::mbar_arrive_expect_tx(full + g, kStage);
      issue_h(g);
    }
  }
  grid_dep_wait();
  if (tid == 0) {
    for (int g = 0; g < first; ++g) issue_dx(g);
  }
  __syncthreads();   // barriers initialised

  const int w = tid / kWg;
  const int warp = (tid % kWg) / 32;
  const int lane = tid % 32;
  const uint32_t ring_a = hopper::smem_addr(ring);
  // zeroed once; each slice's first product overwrites it (scale-d 0)
  float acc[kDembBlocks * 32];
#pragma unroll
  for (int i = 0; i < kDembBlocks * 32; ++i) acc[i] = 0.f;
  for (int t = 0; t < my_tiles; ++t) {
    const int v0 = (blockIdx.x + t * nblk) * kDembWg * 64;
    if (tid < kDembWg * 64 && v0 + tid < a.V) {
      float sum = 0.f;
      for (int r = 0; r < a.row_tiles; ++r) {
        sum += a.dbias_part[r * a.vp + v0 + tid];
      }
      a.dbias[v0 + tid] = sum;
    }
    for (int j = 0; j < a.dslices; ++j) {
      const int d0 = j * kDembD;
      for (int c = 0; c < kc; ++c) {
        const int g = (t * a.dslices + j) * kc + c;
        const int s = g % stages;
        hopper::mbar_wait(full + s, (g / stages) & 1);
        hopper::wgmma_fence();
        const uint32_t st = ring_a + s * kStage;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int b = 0; b < kDembBlocks; ++b) {
            hopper::wgmma_sst<64, 1, 1>(
                acc + 32 * b, hopper::mnmajor_desc(st + w * kBox + k * 2048),
                hopper::mnmajor_desc(st + (kDembWg + b) * kBox + k * 2048),
                c > 0 || k > 0);
          }
        }
        hopper::wgmma_commit();
        if (c > 0) {
          hopper::wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(empty + (g - 1) % stages);
          if (tid == 0) refill(g - 1);
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs<kDembBlocks * 32>(acc);
      const int last = (t * a.dslices + j) * kc + kc - 1;
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + last % stages);
      if (tid == 0) refill(last);

      // acc[32b + 4i + 2h + e]: vocab row v0 + 64 w + 16 warp + lane / 4 +
      // 8 h, D column d0 + 64 b + 8 i + 2 (lane % 4) + e. The warpgroup
      // stages its 64 rows in the swizzle and its first thread writes them
      // with TMA stores (rows past V are not written), once the stores of
      // two slices ago have read that buffer.
      uint8_t* mine =
          stg + (((t * a.dslices + j) & 1) * kDembWg + w) * kDembBlocks * kBox;
      if (tid % kWg == 0) hopper::bulk_wait_read<1>();
      hopper::named_sync(1 + w, kWg);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + lane / 4 + 8 * h;
#pragma unroll
        for (int b = 0; b < kDembBlocks; ++b) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            *reinterpret_cast<__nv_bfloat162*>(
                mine + b * kBox +
                hopper::sw128_offset(r, 8 * i + 2 * (lane % 4))) =
                __floats2bfloat162_rn(acc[32 * b + 4 * i + 2 * h],
                                      acc[32 * b + 4 * i + 2 * h + 1]);
          }
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + w, kWg);
      if (tid % kWg == 0) {
        for (int b = 0; b < kDembBlocks; ++b) {
          if (d0 + 64 * b < a.D) {
            hopper::tma_store_4d(&dembmap, mine + b * kBox, d0 + 64 * b,
                                 v0 + 64 * w, 0, 0);
          }
        }
        hopper::bulk_commit();
      }
    }
  }
  if (tid % kWg == 0) hopper::bulk_wait_read<0>();
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

using hopper::sm_count;

template <int WG, bool GRAD>
cudaError_t launch_logits_wg(const CUtensorMap& hm, const CUtensorMap& em,
                             const CUtensorMap& dxm, const LogitsArgs& a,
                             const Plan& p, cudaStream_t st) {
  static hopper::SmemGrant granted;
  const size_t smem = GRAD ? p.smem_dx : p.smem_stats;
  const cudaError_t err = granted.ensure(ce_logits_kernel<WG, GRAD>, smem);
  if (err != cudaSuccess) return err;
  return hopper::launch_pdl(ce_logits_kernel<WG, GRAD>,
                            dim3(p.row_tiles, p.vtiles), WG * kWg, smem, st,
                            hm, em, dxm, a);
}

// dxm: the dx scratch's map (G1); the stats kernels take any map there
template <bool GRAD>
cudaError_t launch_logits(const CUtensorMap& hm, const CUtensorMap& em,
                          const CUtensorMap& dxm, const LogitsArgs& a,
                          const Plan& p, cudaStream_t st) {
  switch (p.wg) {
    case 1: return launch_logits_wg<1, GRAD>(hm, em, dxm, a, p, st);
    case 2: return launch_logits_wg<2, GRAD>(hm, em, dxm, a, p, st);
    default: return launch_logits_wg<4, GRAD>(hm, em, dxm, a, p, st);
  }
}

template <int WG, int NT>
cudaError_t launch_dh_wg(const CUtensorMap& em, const CUtensorMap& dxm,
                         const DhArgs& a, const Plan& p, cudaStream_t st) {
  static hopper::SmemGrant granted;
  const cudaError_t err = granted.ensure(ce_dh_mma_kernel<WG, NT>, p.h_smem);
  if (err != cudaSuccess) return err;
  return hopper::launch_pdl(ce_dh_mma_kernel<WG, NT>,
                            dim3(p.h_row_tiles, p.h_dslices, p.h_ksplit),
                            WG * kWg + 32, p.h_smem, st, em, dxm, a);
}

cudaError_t launch_dh(const CUtensorMap& em, const CUtensorMap& dxm,
                      const DhArgs& a, const Plan& p, cudaStream_t st) {
  switch (p.h_nt) {
    case 64: return launch_dh_wg<4, 64>(em, dxm, a, p, st);
    case 128: return launch_dh_wg<4, 128>(em, dxm, a, p, st);
    default: return launch_dh_wg<2, 256>(em, dxm, a, p, st);
  }
}

cudaError_t run_stats_bf16(const void* h, const void* emb, const float* bias,
                           const int* labels, float* work, float* xlab,
                           float* sumx, float* lse, int N, int D, int V,
                           int ntiles, cudaStream_t st) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const Plan p = make_plan(N, D, V, sms);
  if (ntiles != p.vtiles) return cudaErrorInvalidValue;
  CUtensorMap hmap, emap;
  if (!hopper::cached_bf16_map(&hmap, h, N, D, 64) || !hopper::cached_bf16_map(&emap, emb, V, D, 64)) {
    return cudaErrorInvalidValue;
  }
  const size_t np = static_cast<size_t>(N) * ntiles;
  LogitsArgs a = {};
  a.bias = bias;
  a.labels = labels;
  a.pmax = work;
  a.psum = work + np;
  a.psumx = work + 2 * np;
  a.pxlab = work + 3 * np;
  a.N = N;
  a.V = V;
  a.vtiles = p.vtiles;
  a.chunks = p.chunks;
  a.stages = p.stages;
  a.vp = p.vp;
  cudaError_t err = launch_logits<false>(hmap, emap, hmap, a, p, st);
  if (err != cudaSuccess) return err;
  return hopper::launch_pdl(ce_stats_reduce_kernel,
                            dim3((N + kWarps - 1) / kWarps), kThreads, 0, st,
                            a.pmax, a.psum, a.psumx, a.pxlab, xlab, sumx,
                            lse, N, ntiles);
}

cudaError_t run_grads_bf16(const void* h, const void* emb, const float* bias,
                           const int* labels, const float* gv,
                           const float* lse, void* work, void* dh, void* demb,
                           float* dbias, int N, int D, int V, int ntiles,
                           int groups, float s_over_v, float one_minus_s,
                           cudaStream_t st) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const Plan p = make_plan(N, D, V, sms);
  if (ntiles != p.vtiles || groups != p.h_ksplit) return cudaErrorInvalidValue;
  uint8_t* base = static_cast<uint8_t*>(work);
  bf16* dx = reinterpret_cast<bf16*>(base);
  float* dbias_part = reinterpret_cast<float*>(base + p.dx_bytes);
  float* dh_part =
      reinterpret_cast<float*>(base + p.dx_bytes + p.dbias_bytes);
  CUtensorMap hmap, emap, dx64, dxnt, dembmap;
  if (!hopper::cached_bf16_map(&hmap, h, N, D, 64) || !hopper::cached_bf16_map(&emap, emb, V, D, 64) ||
      !hopper::cached_bf16_map(&dx64, dx, N, p.vp, 64) || !hopper::cached_bf16_map(&dxnt, dx, N, p.vp, p.h_nt) ||
      !hopper::cached_bf16_map(&dembmap, demb, V, D, 64)) {
    return cudaErrorInvalidValue;
  }

  LogitsArgs a = {};
  a.bias = bias;
  a.labels = labels;
  a.gv = gv;
  a.lse = lse;
  a.dx = dx;
  a.dbias_part = dbias_part;
  a.N = N;
  a.V = V;
  a.vtiles = p.vtiles;
  a.chunks = p.chunks;
  a.stages = p.stages;
  a.vp = p.vp;
  a.s_over_v = s_over_v;
  a.one_minus_s = one_minus_s;
  cudaError_t err = launch_logits<true>(hmap, emap, dx64, a, p, st);
  if (err != cudaSuccess) return err;

  const DhArgs ha = {dh_part, N, D, p.h_chunks, p.h_per, p.h_stages};
  err = launch_dh(emap, dxnt, ha, p, st);
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(N) * D;
  err = hopper::launch_pdl(
      ce_dh_reduce_kernel<bf16>,
      dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads)),
      kThreads, 0, st, static_cast<const float*>(dh_part),
      static_cast<bf16*>(dh), p.h_ksplit, total);
  if (err != cudaSuccess) return err;

  static hopper::SmemGrant granted;
  err = granted.ensure(ce_demb_mma_kernel, p.e_smem);
  if (err != cudaSuccess) return err;
  const DembArgs ea = {static_cast<bf16*>(demb), dbias, dbias_part, N, D,
                       V, p.vtiles, p.row_tiles, p.e_dslices, p.e_kchunks,
                       p.e_stages, p.vp};
  return hopper::launch_pdl(ce_demb_mma_kernel, dim3(p.e_blocks),
                            kDembWg * kWg, p.e_smem, st, dx64, hmap, dembmap,
                            ea);
}

cudaError_t run_stats_f32(const float* h, const float* emb, const float* bias,
                          const int* labels, float* work, float* xlab,
                          float* sumx, float* lse, int N, int D, int V,
                          int ntiles, cudaStream_t st) {
  static hopper::SmemGrant granted;
  const size_t smem = fma_smem_bytes(D);
  cudaError_t err = granted.ensure(ce_stats_kernel, smem);
  if (err != cudaSuccess) return err;
  const size_t np = static_cast<size_t>(N) * ntiles;
  float* pmax = work;
  float* psum = pmax + np;
  float* psumx = psum + np;
  float* pxlab = psumx + np;
  const dim3 grid(ntiles, (N + kRows - 1) / kRows);
  ce_stats_kernel<<<grid, kThreads, smem, st>>>(h, emb, bias, labels, pmax,
                                                psum, psumx, pxlab, N, D, V,
                                                ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_stats_reduce_kernel<<<(N + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      pmax, psum, psumx, pxlab, xlab, sumx, lse, N, ntiles);
  return cudaGetLastError();
}

cudaError_t run_grads_f32(const float* h, const float* emb, const float* bias,
                          const int* labels, const float* gv,
                          const float* lse, float* work, float* dh,
                          float* demb, float* dbias, int N, int D, int V,
                          int ntiles, int groups, float s_over_v,
                          float one_minus_s, cudaStream_t st) {
  static hopper::SmemGrant granted_dh, granted_demb;
  const size_t smem = fma_smem_bytes(D);
  cudaError_t err = granted_dh.ensure(ce_dh_kernel, smem);
  if (err != cudaSuccess) return err;
  err = granted_demb.ensure(ce_demb_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 g_dh(groups, (N + kRows - 1) / kRows,
                  (D + kDhCols - 1) / kDhCols);
  ce_dh_kernel<<<g_dh, kThreads, smem, st>>>(h, emb, bias, labels, gv, lse,
                                             work, N, D, V, ntiles, groups,
                                             s_over_v, one_minus_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(N) * D;
  ce_dh_reduce_kernel<float><<<(total + kThreads - 1) / kThreads, kThreads,
                               0, st>>>(work, dh, groups, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g_demb(ntiles, (D + kDembCols - 1) / kDembCols);
  ce_demb_kernel<<<g_demb, kThreads, smem, st>>>(h, emb, bias, labels, gv,
                                                 lse, demb, dbias, N, D, V,
                                                 s_over_v, one_minus_s);
  return cudaGetLastError();
}

// dtype 0 (fp32): D a multiple of 32, ntiles = ceil(V / 64); dtype 1
// (bf16): D a multiple of 64, ntiles = ceil(V / 128)
bool shapes_ok(int N, int D, int V, int ntiles, int dtype) {
  if (N <= 0 || V <= 0 || D <= 0) return false;
  if (dtype == 0) {
    return D % 32 == 0 && ntiles == (V + kFmaTileV - 1) / kFmaTileV;
  }
  return dtype == 1 && D % 64 == 0 && ntiles == cdiv(V, kTileV);
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (h and emb); bias fp32; labels int32 in [0, V).
// work holds 4 * N * ntiles floats (see shapes_ok for ntiles). Outputs (N,)
// fp32. Returns a cudaError_t (0 on success).
extern "C" int prismer_ce_stats(const void* h, const void* emb,
                                const float* bias, const int* labels,
                                float* work, float* xlab, float* sumx,
                                float* lse, int N, int D, int V, int ntiles,
                                int dtype, void* stream) {
  if (!shapes_ok(N, D, V, ntiles, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? run_stats_f32(static_cast<const float*>(h),
                             static_cast<const float*>(emb), bias, labels,
                             work, xlab, sumx, lse, N, D, V, ntiles, st)
             : run_stats_bf16(h, emb, bias, labels, work, xlab, sumx, lse, N,
                              D, V, ntiles, st);
}

// gv, lse (N,) fp32. dh (N, D) in h's dtype, demb (V, D) in emb's dtype,
// dbias (V,) fp32. fp32: work holds groups * N * D floats (dh partials,
// groups <= ntiles). bf16: groups is the plan's K split of dh (h_ksplit)
// and work the plan's scratch (ops/fused_ce.ce_plan).
extern "C" int prismer_ce_grads(const void* h, const void* emb,
                                const float* bias, const int* labels,
                                const float* gv, const float* lse,
                                float* work, void* dh, void* demb,
                                float* dbias, int N, int D, int V, int ntiles,
                                int groups, float s_over_v, float one_minus_s,
                                int dtype, void* stream) {
  if (!shapes_ok(N, D, V, ntiles, dtype) || groups <= 0 ||
      (dtype == 0 && groups > ntiles)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? run_grads_f32(static_cast<const float*>(h),
                             static_cast<const float*>(emb), bias, labels, gv,
                             lse, work, static_cast<float*>(dh),
                             static_cast<float*>(demb), dbias, N, D, V,
                             ntiles, groups, s_over_v, one_minus_s, st)
             : run_grads_bf16(h, emb, bias, labels, gv, lse, work, dh, demb,
                              dbias, N, D, V, ntiles, groups, s_over_v,
                              one_minus_s, st);
}
