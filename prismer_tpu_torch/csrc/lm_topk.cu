// Tied LM head + log-softmax + exact top-2K beam candidates, for Hopper
// (sm_90a).
//
// Replaces prismer_tpu/ops/lm_topk.py lm_topk (_kernel, the pallas_call at
// :263). Its spec is h @ emb^T + bias (fp32 accumulation from compute-dtype
// operands) followed by prismer_tpu/models/generation.py
// lazy_top_candidates:
//   cand[b, k, v] = alive[b, k] + ((x - m) - lse)     (same op order)
// with the EOS lane exactly alive + NEG_INF (-1e7) while mask_eos, and the
// top kk taken over the flat (K * V) axis, equal values lowest flat index
// first (k-major). Outputs (vals fp32, beam int32, token int32), (B, kk).
//
// What bounds it on the H100: bytes. The (V, D) embedding is 77 MB in bf16
// at V = 50265, D = 768 (~23 us at 3.35 TB/s); the N x V fp32 logits
// (4.8 MB at N = 24) fit in the 50 MB L2. The design:
//   * pass 1, vocab tiles: each block holds the N feature rows in shared
//     memory and its warps stream rows of the natural (V, D) embedding once
//     (16-byte loads; bf16 on tensor cores, mma.sync m16n8k16 with fp32
//     accumulation, fp32 on FMA); the tile's logits go to an (N, V)
//     scratch, and per tile and row the block writes its max and the sum of
//     exp(x - max): the partials of the log-sum-exp. The ragged last tile
//     (50265 is no multiple of the tile) is masked by index.
//   * pass 2, one block per sample: the sample's rows combine their partials
//     in a fixed order (no atomics, so repeated runs agree bit for bit). The
//     kk-th best of the tiles' maxima bounds the kk-th best candidate from
//     below, so each thread scans its strided share of the K * V candidates
//     (eight loads in flight) and keeps only those at or above the bound in
//     a top-16 list under the order (value desc, flat index asc); kk rounds
//     of a block arg-max merge the lists.
// The TPU kernel's 128-lane vocab padding, row chunking and 0/1 selector
// matmuls (lm_topk.py:54-61, :143-166) are not carried over: a block reads
// any row it needs, and a pass boundary replaces the VMEM-resident scratch.

#include <algorithm>
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

using prismer::round_up;
using prismer::to_f;
using prismer::Vec;
using prismer::warp_max;
using prismer::warp_rows_dot;
using prismer::warp_sum;

constexpr float kNegInf = -1.0e7f;  // generation.py:38 NEG_INF
constexpr int kTileV = 256;         // vocab rows per pass-1 block
constexpr int kP1Warps = 8;
constexpr int kMaxRows = 32;
constexpr int kP2Threads = 512;
constexpr int kP2Unroll = 8;        // candidate loads in flight per thread
constexpr int kMaxBeams = 8;
constexpr int kMaxKK = 16;
constexpr size_t kMaxSmem = 227 * 1024;

// Copy a block's (rows, tv) tile of logits out of shared memory (row stride
// kTileV) and write its per-row max and sum of exp(x - max), one warp per
// row, in a fixed order.
__device__ __forceinline__ void tile_partials(const float* lg, float* logits,
                                              float* pmax, float* psum,
                                              int row0, int rows, int v0,
                                              int tv, int V, int ntiles) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int n = warp; n < rows; n += kP1Warps) {
    const float* r = lg + n * kTileV;
    float* out = logits + static_cast<size_t>(row0 + n) * V + v0;
    float m = -INFINITY;
    for (int vi = lane; vi < tv; vi += 32) {
      m = fmaxf(m, r[vi]);
      out[vi] = r[vi];
    }
    m = warp_max(m);
    float s = 0.f;
    for (int vi = lane; vi < tv; vi += 32) s += expf(r[vi] - m);
    s = warp_sum(s);
    if (lane == 0) {
      const size_t p = static_cast<size_t>(row0 + n) * ntiles + blockIdx.x;
      pmax[p] = m;
      psum[p] = s;
    }
  }
}

template <typename T, int NR>
__global__ void __launch_bounds__(kP1Warps * 32)
lm_logits_kernel(const T* __restrict__ h, const T* __restrict__ emb,
                 const float* __restrict__ bias, float* __restrict__ logits,
                 float* __restrict__ pmax, float* __restrict__ psum, int N,
                 int D, int V, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);             // (NR, D)
  float* lg = reinterpret_cast<float*>(hs + NR * D);  // (NR, kTileV)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * NR;
  const int rows = min(NR, N - row0);
  const int v0 = blockIdx.x * kTileV;
  const int tv = min(kTileV, V - v0);

  prismer::load_rows<T, NR>(h, D, row0, rows, 0, D, hs, D);
  __syncthreads();

  for (int vi = warp; vi < tv; vi += kP1Warps) {
    const int v = v0 + vi;
    float acc[NR];
#pragma unroll
    for (int n = 0; n < NR; ++n) acc[n] = 0.f;
    warp_rows_dot<T, NR>(emb + static_cast<size_t>(v) * D, hs, D, D, lane,
                         acc);
    const float bv = bias[v];
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      const float x = warp_sum(acc[n]) + bv;
      if (lane == n) lg[n * kTileV + vi] = x;
    }
  }
  __syncthreads();

  tile_partials(lg, logits, pmax, psum, row0, rows, v0, tv, V, ntiles);
}

// The same pass for bf16 on tensor cores: each warp takes 32 vocab rows
// (four n8 tiles) over the whole of D (prismer::mma_rows).
template <int MT>
__global__ void __launch_bounds__(kP1Warps * 32)
lm_logits_mma_kernel(const __nv_bfloat16* __restrict__ h,
                     const __nv_bfloat16* __restrict__ emb,
                     const float* __restrict__ bias, float* __restrict__ logits,
                     float* __restrict__ pmax, float* __restrict__ psum, int N,
                     int D, int V, int ntiles) {
  using bf16 = __nv_bfloat16;
  constexpr int R = MT * 16;
  constexpr int NT = kTileV / (kP1Warps * 8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = prismer::mma_ldx(D);
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);             // (R, ldx)
  float* lg = reinterpret_cast<float*>(hs + R * ldx);        // (R, kTileV)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * R;
  const int rows = min(R, N - row0);
  const int v0 = blockIdx.x * kTileV;

  prismer::load_rows<bf16, R>(h, D, row0, rows, 0, D, hs, ldx);
  __syncthreads();
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      acc[m][t][0] = acc[m][t][1] = acc[m][t][2] = acc[m][t][3] = 0.f;
    }
  }
  prismer::mma_rows<MT, NT, 1, 2>(hs, ldx, emb, D, 0, D, v0 + warp * NT * 8,
                                  V, 0, lane, acc);
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m * 16 + gid + (e >> 1) * 8;
        const int c = warp * NT * 8 + t * 8 + tig * 2 + (e & 1);
        if (v0 + c < V) lg[r * kTileV + c] = acc[m][t][e] + bias[v0 + c];
      }
    }
  }
  __syncthreads();
  tile_partials(lg, logits, pmax, psum, row0, rows, v0, min(kTileV, V - v0),
                V, ntiles);
}

// (value desc, flat index asc)
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// insert into a sorted top-kMaxKK list held in registers
__device__ __forceinline__ void insert(float (&tv)[kMaxKK], int (&ti)[kMaxKK],
                                       float f, int idx) {
  if (!better(f, idx, tv[kMaxKK - 1], ti[kMaxKK - 1])) return;
  tv[kMaxKK - 1] = f;
  ti[kMaxKK - 1] = idx;
#pragma unroll
  for (int i = kMaxKK - 1; i > 0; --i) {
    if (better(tv[i], ti[i], tv[i - 1], ti[i - 1])) {
      const float fv = tv[i];
      tv[i] = tv[i - 1];
      tv[i - 1] = fv;
      const int iv = ti[i];
      ti[i] = ti[i - 1];
      ti[i - 1] = iv;
    }
  }
}

// One round of the block merge: every thread offers the head of its list,
// the best (value desc, index asc) is popped from its owner's list and
// returned to every thread. s_* are shared scratch.
__device__ __forceinline__ void pop_best(float (&tv)[kMaxKK],
                                         int (&ti)[kMaxKK], float* w_val,
                                         int* w_idx, float* s_val, int* s_idx,
                                         float* out_v, int* out_i) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float bv = tv[0];
  int bi = ti[0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    w_val[warp] = bv;
    w_idx[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kP2Threads / 32; ++w) {
      if (better(w_val[w], w_idx[w], bv, bi)) {
        bv = w_val[w];
        bi = w_idx[w];
      }
    }
    *s_val = bv;
    *s_idx = bi;
  }
  __syncthreads();
  *out_v = *s_val;
  *out_i = *s_idx;
  if (ti[0] == *out_i) {
#pragma unroll
    for (int i = 0; i < kMaxKK - 1; ++i) {
      tv[i] = tv[i + 1];
      ti[i] = ti[i + 1];
    }
    tv[kMaxKK - 1] = -INFINITY;
    ti[kMaxKK - 1] = INT_MAX;
  }
}

__device__ __forceinline__ void clear(float (&tv)[kMaxKK], int (&ti)[kMaxKK]) {
#pragma unroll
  for (int i = 0; i < kMaxKK; ++i) {
    tv[i] = -INFINITY;
    ti[i] = INT_MAX;
  }
}

// grid (B): one block per sample
__global__ void __launch_bounds__(kP2Threads)
lm_select_kernel(const float* __restrict__ logits,
                 const float* __restrict__ pmax,
                 const float* __restrict__ psum,
                 const float* __restrict__ alive, float* __restrict__ out_vals,
                 int* __restrict__ out_beam, int* __restrict__ out_tok, int K,
                 int V, int ntiles, int kk, int mask_eos, int eos_id) {
  __shared__ float s_m[kMaxBeams];
  __shared__ float s_ls[kMaxBeams];
  __shared__ float s_a[kMaxBeams];
  __shared__ float w_val[kP2Threads / 32];
  __shared__ int w_idx[kP2Threads / 32];
  __shared__ float s_val;
  __shared__ int s_idx;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // row statistics from the tile partials, one warp per beam row, in a
  // fixed order (lane-strided, then the butterfly)
  if (warp < K) {
    const size_t n = static_cast<size_t>(b) * K + warp;
    const float* pm = pmax + n * ntiles;
    const float* ps = psum + n * ntiles;
    float m = -INFINITY;
    for (int j = lane; j < ntiles; j += 32) m = fmaxf(m, pm[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < ntiles; j += 32) s += ps[j] * expf(pm[j] - m);
    s = warp_sum(s);
    if (lane == 0) {
      s_m[warp] = m;
      s_ls[warp] = logf(s);
      s_a[warp] = alive[n];
    }
  }
  __syncthreads();

  // a lower bound on the kk-th best candidate: the kk-th best of the tiles'
  // maxima, each an actual candidate value (the tile of a masked EOS lane is
  // left out: its maximum may be the masked logit)
  float tv[kMaxKK];
  int ti[kMaxKK];
  clear(tv, ti);
  const int eos_tile = mask_eos ? eos_id / kTileV : -1;
  for (int e = tid; e < K * ntiles; e += kP2Threads) {
    const int k = e / ntiles;
    const int j = e - k * ntiles;
    if (j != eos_tile) {
      const float x = pmax[(static_cast<size_t>(b) * K + k) * ntiles + j];
      insert(tv, ti, s_a[k] + ((x - s_m[k]) - s_ls[k]), e);
    }
  }
  float tau = -INFINITY;
  for (int r = 0; r < kk; ++r) {
    int idx;
    pop_best(tv, ti, w_val, w_idx, &s_val, &s_idx, &tau, &idx);
  }

  // every candidate at or above the bound enters the thread's list
  clear(tv, ti);
  for (int k = 0; k < K; ++k) {
    const float* row = logits + (static_cast<size_t>(b) * K + k) * V;
    const float a = s_a[k];
    const float m = s_m[k];
    const float ls = s_ls[k];
    for (int v0 = tid; v0 < V; v0 += kP2Threads * kP2Unroll) {
      float x[kP2Unroll];
#pragma unroll
      for (int u = 0; u < kP2Unroll; ++u) {
        const int v = v0 + u * kP2Threads;
        if (v < V) x[u] = row[v];
      }
#pragma unroll
      for (int u = 0; u < kP2Unroll; ++u) {
        const int v = v0 + u * kP2Threads;
        if (v < V) {
          float f = a + ((x[u] - m) - ls);
          if (mask_eos && v == eos_id) f = a + kNegInf;
          if (f >= tau) insert(tv, ti, f, k * V + v);
        }
      }
    }
  }

  for (int r = 0; r < kk; ++r) {
    float v;
    int idx;
    pop_best(tv, ti, w_val, w_idx, &s_val, &s_idx, &v, &idx);
    if (tid == 0) {
      const size_t o = static_cast<size_t>(b) * kk + r;
      out_vals[o] = v;
      out_beam[o] = idx / V;
      out_tok[o] = idx % V;
    }
  }
}

template <typename T, int NR>
cudaError_t launch_logits(const T* h, const T* emb, const float* bias,
                          float* logits, float* pmax, float* psum, int N,
                          int D, int V, int ntiles, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = static_cast<size_t>(NR) * D * sizeof(T) +
                      static_cast<size_t>(NR) * kTileV * sizeof(float);
  if (smem > granted) {
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        lm_logits_kernel<T, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  const dim3 grid(ntiles, (N + NR - 1) / NR);
  lm_logits_kernel<T, NR><<<grid, kP1Warps * 32, smem, st>>>(
      h, emb, bias, logits, pmax, psum, N, D, V, ntiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_logits_fma(const T* ht, const T* et, const float* bias,
                              float* logits, float* pmax, float* psum, int N,
                              int D, int V, int ntiles, cudaStream_t st) {
  switch (std::min(kMaxRows, round_up(N, 8))) {
    case 8:
      return launch_logits<T, 8>(ht, et, bias, logits, pmax, psum, N, D, V,
                                 ntiles, st);
    case 16:
      return launch_logits<T, 16>(ht, et, bias, logits, pmax, psum, N, D, V,
                                  ntiles, st);
    case 24:
      return launch_logits<T, 24>(ht, et, bias, logits, pmax, psum, N, D, V,
                                  ntiles, st);
    default:
      return launch_logits<T, 32>(ht, et, bias, logits, pmax, psum, N, D, V,
                                  ntiles, st);
  }
}

template <int MT>
cudaError_t launch_logits_mma(const __nv_bfloat16* h,
                              const __nv_bfloat16* emb, const float* bias,
                              float* logits, float* pmax, float* psum, int N,
                              int D, int V, int ntiles, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  constexpr int R = MT * 16;
  const size_t smem = static_cast<size_t>(R) * prismer::mma_ldx(D) * 2 +
                      static_cast<size_t>(R) * kTileV * sizeof(float);
  if (smem > granted) {
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        lm_logits_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  const dim3 grid(ntiles, (N + R - 1) / R);
  lm_logits_mma_kernel<MT><<<grid, kP1Warps * 32, smem, st>>>(
      h, emb, bias, logits, pmax, psum, N, D, V, ntiles);
  return cudaGetLastError();
}

// fp32 (the card-side parity runs): FMA tiles; bf16: tensor-core tiles
template <typename T>
cudaError_t run(const void* h, const void* emb, const float* bias,
                const float* alive, float* work, float* out_vals,
                int* out_beam, int* out_tok, int N, int B, int D, int V,
                int ntiles, int kk, int mask_eos, int eos_id,
                cudaStream_t st) {
  float* logits = work;                                  // (N, V)
  float* pmax = logits + static_cast<size_t>(N) * V;     // (N, ntiles)
  float* psum = pmax + static_cast<size_t>(N) * ntiles;  // (N, ntiles)
  const T* ht = static_cast<const T*>(h);
  const T* et = static_cast<const T*>(emb);
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    err = N <= 16 ? launch_logits_mma<1>(ht, et, bias, logits, pmax, psum, N,
                                         D, V, ntiles, st)
                  : launch_logits_mma<2>(ht, et, bias, logits, pmax, psum, N,
                                         D, V, ntiles, st);
  } else {
    err = launch_logits_fma<T>(ht, et, bias, logits, pmax, psum, N, D, V,
                               ntiles, st);
  }
  if (err != cudaSuccess) return err;
  lm_select_kernel<<<B, kP2Threads, 0, st>>>(logits, pmax, psum, alive,
                                              out_vals, out_beam, out_tok,
                                              N / B, V, ntiles, kk, mask_eos,
                                              eos_id);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). dtype: 0 fp32, 1 bf16 (h and emb).
// work holds N * V + 2 * N * ntiles floats, ntiles = ceil(V / 256).
extern "C" int prismer_lm_topk(const void* h, const void* emb,
                               const float* bias, const float* alive,
                               float* work, float* out_vals, int* out_beam,
                               int* out_tok, int N, int B, int D, int V,
                               int ntiles, int kk, int mask_eos, int eos_id,
                               int dtype, void* stream) {
  if (N <= 0 || B <= 0 || N % B != 0 || N / B > kMaxBeams || D <= 0 ||
      D % 8 != 0 || V <= 0 || ntiles != (V + kTileV - 1) / kTileV ||
      kk <= 0 || kk > kMaxKK || kk > (N / B) * V || eos_id < 0 ||
      eos_id >= V || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && D % 32 != 0)) {  // 32-wide mma chunks
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? run<float>(h, emb, bias, alive, work, out_vals, out_beam,
                          out_tok, N, B, D, V, ntiles, kk, mask_eos, eos_id,
                          st)
             : run<__nv_bfloat16>(h, emb, bias, alive, work, out_vals,
                                  out_beam, out_tok, N, B, D, V, ntiles, kk,
                                  mask_eos, eos_id, st);
}
