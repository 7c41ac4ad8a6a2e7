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
// at V = 50265, D = 768 (~23 us at 3.35 TB/s; 103 MB, ~31 us at D 1024);
// the N x V fp32 logits (4.8 MB at N = 24) stay in the 50 MB L2 for the
// selection, as the embedding's loads carry an L2 evict-first policy. The
// design:
//   * logits, bf16 (logits_kernel): about one block per SM walks 64-row
//     vocab tiles (786 at V 50265, the last one 25 rows, masked by index).
//     The block's tiles alternate between two consumer warpgroups, so one
//     runs a tile's epilogue while the other's products go on; each has a
//     producer warp that keeps TMA loads of the natural (V, D) embedding in
//     flight in its own mbarrier ring of 64 x 64 boxes (128-byte swizzle),
//     from a tensor map encoded once per embedding; the first boxes are
//     issued before the programmatic-dependent-launch wait (the embedding
//     is constant). The N <= 64 feature rows are staged once, after the
//     wait, in shared memory as the K-major B operand; a warpgroup runs
//     wgmma.m64nNk16 with the embedding box as A and N the row count
//     rounded up to 8 (24 at N 24, 48 at batch 16), fp32 sums. Epilogue:
//     + the fp32 bias; the tile's logits to an (N, V) scratch; per (row,
//     tile) the max and the sum of exp(x - max), each reduced in a fixed
//     order. fp32 (the card-side parity runs) keeps FMA (fma_logits_kernel)
//     on the same tiles.
//   * selection, one block of 8 warps per sample (select_kernel, the beam
//     count a template argument): the sample's rows combine their partials
//     in a fixed order (no atomics, so repeats agree bit for bit). f = a +
//     ((x - m) - ls) is non-decreasing in x under IEEE rounding, so a tile
//     whose maximum logit gives f < tau holds no candidate >= tau. tau is
//     the kk-th best of one actual candidate per thread (its best tile
//     maximum; the EOS tile left out while mask_eos, as its maximum may be
//     the masked logit): kk distinct candidates reach it, so it bounds the
//     kk-th best candidate from below. Each warp scans only those of its
//     tiles that clear tau (typically kk plus ties, 64 logits each; the EOS
//     tile when its raw maximum or its masked lane does), keeps per lane a
//     sorted list under (value desc, flat index asc) and merges the lists
//     in kk rounds of a warp arg-max (redux.sync on order-preserving
//     integer keys); warp 0 merges the warps' lists. Its time is a chain
//     of dependent steps, not bytes, so the row statistics are a max pass
//     and a sum pass of independent exponentials and tau needs no sorted
//     list per thread.
// Both kernels launch with programmatic stream serialization and trigger
// their successor after their own wait: the selection becomes resident
// while the logits kernel runs and reads before its wait only `alive`,
// which the logits kernel does not write (every earlier writer completed
// before the logits kernel's wait); beam_update follows.
// The TPU kernel's 128-lane vocab padding, row chunking and 0/1 selector
// matmuls (lm_topk.py:54-61, :143-166) are not carried over.

#include <algorithm>
#include <climits>
#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using hopper::grid_dep_launch;
using hopper::grid_dep_wait;
using prismer::round_up;
using prismer::warp_max;
using prismer::warp_rows_dot;
using prismer::warp_sum;

constexpr float kNegInf = -1.0e7f;  // generation.py:38 NEG_INF
constexpr int kTileV = 64;          // vocab rows per tile (the wgmma M)
constexpr int kChunk = 64;          // D columns per TMA box (128 bytes)
constexpr int kBoxBytes = kTileV * kChunk * 2;
constexpr int kMmaThreads = 128;    // a consumer warpgroup
constexpr int kRings = 2;           // consumer warpgroups, alternate tiles
constexpr int kLogitsThreads = kRings * (kMmaThreads + 32);   // + producers
constexpr int kMaxStages = 8;       // boxes per ring
constexpr int kMaxTileRows = 64;
constexpr int kFmaWarps = 8;
constexpr int kMaxFmaRows = 32;
constexpr int kMaxBeams = 8;
constexpr int kMaxKK = 16;
constexpr int kUnroll = 4;          // partials a thread loads at once
constexpr int kSelWarps = 8;        // selection warps per sample
constexpr int kSelThreads = 32 * kSelWarps;
constexpr size_t kMaxSmem = hopper::kMaxSmem;

// The bf16 logits launch: `logits_plan` here and ops/lm_topk.lm_topk_plan
// in Python compute it the same way.
struct LogitsPlan {
  int rows;        // feature rows per row tile: N rounded up to 8..32, 48, 64
  int row_tiles;   // row tiles of N
  int chunks;      // 64-column chunks of D
  int tiles;       // 64-row vocab tiles
  int blocks;      // blocks per row tile, each walking tiles blocks apart
  int stages;      // embedding boxes in flight per ring (two a block)
  int smem;        // dynamic shared memory bytes per block
};

inline int logits_smem(int rows, int chunks, int stages) {
  return kRings * stages * kBoxBytes + chunks * rows * 128 +  // rings, rows
         kRings * 2 * 4 * rows * 4 +         // cross-warp max and sum
         kRings * 2 * stages * 8 + 1024;     // barriers, alignment slack
}

inline LogitsPlan logits_plan(int N, int D, int V, int sms) {
  LogitsPlan p;
  const int r8 = (std::min(N, kMaxTileRows) + 7) / 8 * 8;
  p.rows = r8 <= 32 ? r8 : (r8 <= 48 ? 48 : 64);
  p.row_tiles = (N + p.rows - 1) / p.rows;
  p.chunks = (D + kChunk - 1) / kChunk;
  p.tiles = (V + kTileV - 1) / kTileV;
  p.blocks = std::min(p.tiles, std::max(1, sms / p.row_tiles));
  const int per_ring =
      ((p.tiles + p.blocks - 1) / p.blocks + kRings - 1) / kRings * p.chunks;
  p.stages = std::min(kMaxStages, per_ring);
  while (p.stages > 2 && logits_smem(p.rows, p.chunks, p.stages) >
                             static_cast<int>(kMaxSmem)) {
    --p.stages;
  }
  p.smem = logits_smem(p.rows, p.chunks, p.stages);
  return p;
}

struct LogitsArgs {
  const __nv_bfloat16* h;   // (N, D)
  const float* bias;        // (V,)
  float* logits;            // (N, V)
  float* pmax;              // (N, tiles)
  float* psum;              // (N, tiles)
  int N, D, V, tiles, chunks, stages;
};

// One block per SM (per row tile) walks the tiles blockIdx.x, + gridDim.x,
// ...; its local tiles alternate between two consumer warpgroups, so one
// runs its tile's epilogue while the other's products go on. Each
// warpgroup has its own ring, fed by its own producer warp (lane 0); a
// ring with one consumer keeps the mbarrier phases in order.
template <int NT>
__global__ void __launch_bounds__(kLogitsThreads)
logits_kernel(const __grid_constant__ CUtensorMap emap, const LogitsArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int stages = a.stages;
  const int kc = a.chunks;
  uint8_t* rings = hopper::align_1024(smem_raw);     // [kRings][stages]
  uint8_t* hs = rings + kRings * stages * kBoxBytes;      // [kc][NT][64]
  // [kRings][max, sum][4 warps][NT]
  float* red = reinterpret_cast<float*>(hs + kc * NT * 128);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kRings * 2 * 4 * NT);
  uint64_t* empty = full + kRings * stages;          // [kRings][stages]
  const int n0 = blockIdx.y * NT;
  const int rows = min(NT, a.N - n0);
  const int my_tiles = (a.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

  // ring w holds the boxes of local tiles w, w + kRings, ...: box i is
  // chunk i % kc of local tile w + kRings (i / kc)
  auto boxes = [&](int w) {
    return (my_tiles - w + kRings - 1) / kRings * kc;
  };
  // the embedding is read once a call and is larger than the L2: its
  // lines go first, so the logits and partials stay for the selection
  const uint64_t policy = hopper::l2_evict_first();
  auto issue = [&](int w, int i) {
    const int s = w * stages + i % stages;
    const int tile = blockIdx.x + (w + kRings * (i / kc)) * gridDim.x;
    hopper::mbar_arrive_expect_tx(full + s, kBoxBytes);
    hopper::tma_load_4d_hint(rings + s * kBoxBytes, &emap, full + s,
                             (i % kc) * kChunk, tile * kTileV, 0, 0, policy);
  };
  if (tid == kRings * kMmaThreads) {
    for (int s = 0; s < kRings * stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kMmaThreads / 32);
    }
    hopper::mbar_init_fence();
    // the embedding is constant during the step: the first boxes go out
    // before the wait
    for (int w = 0; w < kRings; ++w) {
      for (int i = 0; i < min(stages, boxes(w)); ++i) issue(w, i);
    }
  }
  grid_dep_wait();
  grid_dep_launch();

  // the feature rows in the 128-byte swizzle: 16-byte chunk j of row n of
  // column block c at c * NT * 128 + n * 128 + (j ^ (n % 8)) * 16; rows past
  // N and columns past D as zeros
  for (int e = tid; e < kc * NT * 8; e += kLogitsThreads) {
    const int c = e / (NT * 8);
    const int n = (e / 8) % NT;
    const int j = e % 8;
    const int k = c * kChunk + j * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < rows && k < a.D) {
      v = *reinterpret_cast<const uint4*>(
          a.h + static_cast<size_t>(n0 + n) * a.D + k);
    }
    *reinterpret_cast<uint4*>(hs + c * NT * 128 + n * 128 +
                              ((j ^ (n & 7)) * 16)) = v;
  }
  hopper::fence_proxy_async();
  __syncthreads();   // the rows are staged; the barriers are initialised

  if (tid >= kRings * kMmaThreads) {   // producer w: refill each freed stage
    const int w = (tid - kRings * kMmaThreads) / 32;
    if (lane == 0) {
      for (int i = stages; i < boxes(w); ++i) {
        hopper::mbar_wait(empty + w * stages + i % stages,
                          ((i / stages) - 1) & 1);
        issue(w, i);
      }
    }
    return;
  }

  const int w = tid / kMmaThreads;           // consumer warpgroup, ring
  const int warp = (tid % kMmaThreads) / 32;
  float* red_m = red + w * 2 * 4 * NT;       // [4][NT]
  float* red_s = red_m + 4 * NT;             // [4][NT]
  const uint32_t ring_a = hopper::smem_addr(rings + w * stages * kBoxBytes);
  const uint32_t hs_a = hopper::smem_addr(hs);
  uint64_t* my_full = full + w * stages;
  uint64_t* my_empty = empty + w * stages;
  float acc[NT / 2];
  int i = 0;   // boxes of the ring consumed
  for (int t = w; t < my_tiles; t += kRings) {
    const int tile = blockIdx.x + t * gridDim.x;
    const int v0 = tile * kTileV;
    // the bias of the thread's two vocab rows, read while the products run
    bool ok[2];
    float bv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + 16 * warp + lane / 4 + 8 * h;
      ok[h] = v < a.V;
      bv[h] = ok[h] ? a.bias[v] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < NT / 2; ++q) acc[q] = 0.f;
    for (int c = 0; c < kc; ++c, ++i) {
      const int s = i % stages;
      hopper::mbar_wait(my_full + s, (i / stages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kChunk / 16; ++k) {
        hopper::wgmma_ss<NT>(
            acc, hopper::kmajor_desc(ring_a + s * kBoxBytes + k * 32),
            hopper::kmajor_desc(hs_a + c * NT * 128 + k * 32), 1);
      }
      hopper::wgmma_commit();
      if (c > 0) {   // the box before has been read: free its stage
        hopper::wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(my_empty + (i - 1) % stages);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<NT / 2>(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(my_empty + (i - 1) % stages);

    // acc[4j + 2h + e]: vocab row v0 + 16 warp + lane / 4 + 8h, feature row
    // n0 + 8j + 2 (lane % 4) + e
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * (lane % 4) + e;
        float mx = -INFINITY;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = acc[4 * j + 2 * h + e];
          x = ok[h] ? x + bv[h] : -INFINITY;
          mx = fmaxf(mx, x);
          if (ok[h] && n < rows) {
            a.logits[static_cast<size_t>(n0 + n) * a.V + v0 + 16 * warp +
                     lane / 4 + 8 * h] = x;
          }
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        if (lane < 4) red_m[warp * NT + n] = mx;
      }
    }
    hopper::named_sync(1 + w, kMmaThreads);
    float tmax[NT / 4];   // the tile's max of each of the lane's rows
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * (lane % 4) + e;
        const float m = fmaxf(fmaxf(red_m[n], red_m[NT + n]),
                              fmaxf(red_m[2 * NT + n], red_m[3 * NT + n]));
        tmax[2 * j + e] = m;
        float sx = expf(acc[4 * j + e] - m) + expf(acc[4 * j + 2 + e] - m);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          sx += __shfl_xor_sync(0xffffffffu, sx, o);
        }
        if (lane < 4) red_s[warp * NT + n] = sx;
      }
    }
    hopper::named_sync(1 + w, kMmaThreads);
    if (warp == 0 && lane < 4) {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * lane + e;
          if (n < rows) {
            const size_t p = static_cast<size_t>(n0 + n) * a.tiles + tile;
            a.pmax[p] = tmax[2 * j + e];
            a.psum[p] = ((red_s[n] + red_s[NT + n]) + red_s[2 * NT + n]) +
                        red_s[3 * NT + n];
          }
        }
      }
    }
  }
}

// fp32 (the card-side parity runs): FMA, one block per (vocab tile, row
// tile), each warp a strided share of the tile's vocab rows.
template <typename T, int NR>
__global__ void __launch_bounds__(kFmaWarps * 32)
fma_logits_kernel(const T* __restrict__ h, const T* __restrict__ emb,
                  const float* __restrict__ bias, float* __restrict__ logits,
                  float* __restrict__ pmax, float* __restrict__ psum, int N,
                  int D, int V, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);             // (NR, D)
  float* lg = reinterpret_cast<float*>(hs + NR * D);  // (NR, kTileV)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * NR;
  const int rows = min(NR, N - row0);
  const int v0 = blockIdx.x * kTileV;
  const int tv = min(kTileV, V - v0);

  grid_dep_wait();
  grid_dep_launch();
  prismer::load_rows<T, NR>(h, D, row0, rows, 0, D, hs, D);
  __syncthreads();

  for (int vi = warp; vi < tv; vi += kFmaWarps) {
    const int v = v0 + vi;
    float acc[NR];
#pragma unroll
    for (int n = 0; n < NR; ++n) acc[n] = 0.f;
    warp_rows_dot<T, NR>(emb + static_cast<size_t>(v) * D, hs, D, D, lane,
                         acc);
    const float b = bias[v];
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      const float x = warp_sum(acc[n]) + b;
      if (lane == n) lg[n * kTileV + vi] = x;
    }
  }
  __syncthreads();

  // the tile's logits out, and per row its max and sum of exp(x - max), one
  // warp per row, in a fixed order
  for (int n = warp; n < rows; n += kFmaWarps) {
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
      const size_t p = static_cast<size_t>(row0 + n) * tiles + blockIdx.x;
      pmax[p] = m;
      psum[p] = s;
    }
  }
}

// (value desc, flat index asc)
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// a lane's LIST best (value, flat index) pairs, sorted under `better`
template <int LIST>
__device__ __forceinline__ void insert(float (&tv)[LIST], int (&ti)[LIST],
                                       float f, int idx) {
  if (!better(f, idx, tv[LIST - 1], ti[LIST - 1])) return;
  tv[LIST - 1] = f;
  ti[LIST - 1] = idx;
#pragma unroll
  for (int i = LIST - 1; i > 0; --i) {
    if (better(tv[i], ti[i], tv[i - 1], ti[i - 1])) {
      const float x = tv[i];
      tv[i] = tv[i - 1];
      tv[i - 1] = x;
      const int y = ti[i];
      ti[i] = ti[i - 1];
      ti[i - 1] = y;
    }
  }
}

// A float's bits as an int that orders as the floats do (-0 as +0; no NaN
// reaches here), so a warp's max is one redux.sync; and back.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f + 0.f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ float warp_max_f(float f) {
  return from_key(__reduce_max_sync(0xffffffffu, order_key(f)));
}

// pop the warp's best (value desc, index asc) head of the lanes' sorted
// lists (indices are distinct); every lane gets it
template <int LIST>
__device__ __forceinline__ void pop_pair(float (&tv)[LIST], int (&ti)[LIST],
                                         float* out_v, int* out_i) {
  const int key = order_key(tv[0]);
  const int best = __reduce_max_sync(0xffffffffu, key);
  const int bi = static_cast<int>(__reduce_min_sync(
      0xffffffffu, key == best ? static_cast<unsigned>(ti[0]) : UINT_MAX));
  if (ti[0] == bi) {
#pragma unroll
    for (int i = 0; i < LIST - 1; ++i) {
      tv[i] = tv[i + 1];
      ti[i] = ti[i + 1];
    }
    tv[LIST - 1] = -INFINITY;
    ti[LIST - 1] = INT_MAX;
  }
  *out_v = from_key(best);
  *out_i = bi;
}

// grid (B), one block of kSelWarps warps per sample, K beam rows (a
// template argument, so a thread's per-row values stay in registers).
// Thread t owns the tiles t + kSelThreads * u (u < kUnroll: one batch at
// V <= 65536) of every row and reloads them (from L1) in each phase. Each
// step that needs the whole sample is one block barrier: the rows' maxima,
// their sums, the warps' best thread candidates, the warps' best
// candidates. tau is the kk-th best of one candidate per thread (its best
// tile maximum over its rows, the EOS tile left out while mask_eos): kk
// distinct candidates at or above it exist, so it bounds the kk-th best
// candidate from below, as the kk-th best of all the tiles' maxima would,
// without a sorted list per thread.
template <int K, int LIST>
__global__ void __launch_bounds__(kSelThreads, 1)
select_kernel(const float* __restrict__ logits,
              const float* __restrict__ pmax, const float* __restrict__ psum,
              const float* __restrict__ alive, float* __restrict__ out_vals,
              int* __restrict__ out_beam, int* __restrict__ out_tok, int V,
              int tiles, int kk, int mask_eos, int eos_id) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kStep = kSelThreads * kUnroll;
  __shared__ float w_m[kSelWarps][K], w_s[kSelWarps][K];
  __shared__ float w_top[kSelWarps][kMaxKK];
  __shared__ float w_tv[kSelWarps][kMaxKK];
  __shared__ int w_ti[kSelWarps][kMaxKK];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // alive is not written by the logits kernel, and this kernel becomes
  // resident only after that one's own wait, so every earlier writer has
  // completed: read before the wait
  float a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = alive[b * K + k];
  grid_dep_wait();
  grid_dep_launch();
  const float* pm = pmax + static_cast<size_t>(b) * K * tiles;
  const float* ps = psum + static_cast<size_t>(b) * K * tiles;
  const int eos_tile = mask_eos ? eos_id / kTileV : -1;

  // the rows' maxima (the thread's, the warp's by redux, the warps'); the
  // thread's maxima without the EOS tile, for tau
  float m[K], mt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) m[k] = mt[k] = -INFINITY;
  for (int j0 = tid; j0 < tiles; j0 += kStep) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + kSelThreads * u;
        const float x = j < tiles ? pm[k * tiles + j] : -INFINITY;
        m[k] = fmaxf(m[k], x);
        if (j != eos_tile) mt[k] = fmaxf(mt[k], x);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float wm = warp_max_f(m[k]);
    if (lane == 0) w_m[warp][k] = wm;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    m[k] = w_m[0][k];
    for (int w = 1; w < kSelWarps; ++w) m[k] = fmaxf(m[k], w_m[w][k]);
  }

  // their sums of exp(x - max) over the tiles' partials: the thread's in
  // tile order, the warp's butterfly, then the warps in order
  float ls[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ls[k] = 0.f;
  for (int j0 = tid; j0 < tiles; j0 += kStep) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + kSelThreads * u;
        if (j < tiles) {
          ls[k] += ps[k * tiles + j] * __expf(pm[k * tiles + j] - m[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float ws = warp_sum(ls[k]);
    if (lane == 0) w_s[warp][k] = ws;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float sum = w_s[0][k];
    for (int w = 1; w < kSelWarps; ++w) sum += w_s[w][k];
    ls[k] = logf(sum);
  }

  // tau: each warp's kk best thread candidates, then every warp merges the
  // warps' lists
  float cand = -INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cand = fmaxf(cand, a[k] + ((mt[k] - m[k]) - ls[k]));
  }
  for (int r = 0; r < kk; ++r) {
    const float best = warp_max_f(cand);
    const unsigned owner = __ballot_sync(kAll, cand == best);
    if (lane == __ffs(owner) - 1) cand = -INFINITY;
    if (lane == 0) w_top[warp][r] = best;
  }
  __syncthreads();
  float tau = -INFINITY;
  {
    // lane w < kSelWarps walks warp w's sorted list
    int pos = 0;
    float head = lane < kSelWarps ? w_top[lane][0] : -INFINITY;
    for (int r = 0; r < kk; ++r) {
      tau = warp_max_f(head);
      const unsigned owner = __ballot_sync(kAll, head == tau);
      if (lane == __ffs(owner) - 1) {
        ++pos;
        head = pos < kk ? w_top[lane][pos] : -INFINITY;
      }
    }
  }

  // each warp scans those of its tiles that clear tau (every candidate >=
  // tau lies in one) into its lanes' lists
  float tv[LIST];
  int ti[LIST];
#pragma unroll
  for (int i = 0; i < LIST; ++i) {
    tv[i] = -INFINITY;
    ti[i] = INT_MAX;
  }
  for (int j0 = warp * 32; j0 < tiles; j0 += kStep) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool eos_in = a[k] + kNegInf >= tau;   // the masked lane clears
      const float* row = logits + (static_cast<size_t>(b) * K + k) * V;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + kSelThreads * u + lane;
        const bool hit =
            j < tiles && (a[k] + ((pm[k * tiles + j] - m[k]) - ls[k]) >= tau ||
                          (j == eos_tile && eos_in));
        for (unsigned hits = __ballot_sync(kAll, hit); hits != 0u;
             hits &= hits - 1u) {
          const int v_base =
              (j0 + kSelThreads * u + __ffs(hits) - 1) * kTileV;
          float xs[kTileV / 32];
#pragma unroll
          for (int q = 0; q < kTileV / 32; ++q) {
            const int v = v_base + q * 32 + lane;
            xs[q] = v < V ? row[v] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < kTileV / 32; ++q) {
            const int v = v_base + q * 32 + lane;
            if (v < V) {
              float f = a[k] + ((xs[q] - m[k]) - ls[k]);
              if (mask_eos && v == eos_id) f = a[k] + kNegInf;
              if (f >= tau) insert(tv, ti, f, k * V + v);
            }
          }
        }
      }
    }
  }
  for (int r = 0; r < kk; ++r) {
    float v;
    int i;
    pop_pair(tv, ti, &v, &i);
    if (lane == 0) {
      w_tv[warp][r] = v;
      w_ti[warp][r] = i;
    }
  }
  __syncthreads();
  if (warp == 0) {
    // lane w < kSelWarps offers warp w's list, one entry at a time
    float hv[1] = {lane < kSelWarps ? w_tv[lane][0] : -INFINITY};
    int hi[1] = {lane < kSelWarps ? w_ti[lane][0] : INT_MAX};
    int pos = 0;
    for (int r = 0; r < kk; ++r) {
      float v;
      int i;
      const int mine = hi[0];
      pop_pair(hv, hi, &v, &i);
      if (mine == i) {
        ++pos;
        hv[0] = pos < kk ? w_tv[lane][pos] : -INFINITY;
        hi[0] = pos < kk ? w_ti[lane][pos] : INT_MAX;
      }
      if (lane == r) {
        const size_t o = static_cast<size_t>(b) * kk + r;
        out_vals[o] = v;
        out_beam[o] = i / V;
        out_tok[o] = i % V;
      }
    }
  }
}

template <int K>
cudaError_t launch_select_rows(const float* logits, const float* pmax,
                               const float* psum, const float* alive,
                               float* out_vals, int* out_beam, int* out_tok,
                               int B, int V, int tiles, int kk, int mask_eos,
                               int eos_id, cudaStream_t st) {
  auto kernel = kk <= 8 ? select_kernel<K, 8> : select_kernel<K, 16>;
  return hopper::launch_pdl(kernel, dim3(B), kSelThreads, 0, st, logits,
                            pmax, psum, alive, out_vals, out_beam, out_tok,
                            V, tiles, kk, mask_eos, eos_id);
}

cudaError_t launch_select(int K, const float* logits, const float* pmax,
                          const float* psum, const float* alive,
                          float* out_vals, int* out_beam, int* out_tok, int B,
                          int V, int tiles, int kk, int mask_eos, int eos_id,
                          cudaStream_t st) {
#define PRISMER_SELECT_ROWS(R)                                              \
  case R:                                                                  \
    return launch_select_rows<R>(logits, pmax, psum, alive, out_vals,      \
                                 out_beam, out_tok, B, V, tiles, kk,       \
                                 mask_eos, eos_id, st);
  switch (K) {
    PRISMER_SELECT_ROWS(1)
    PRISMER_SELECT_ROWS(2)
    PRISMER_SELECT_ROWS(3)
    PRISMER_SELECT_ROWS(4)
    PRISMER_SELECT_ROWS(5)
    PRISMER_SELECT_ROWS(6)
    PRISMER_SELECT_ROWS(7)
    PRISMER_SELECT_ROWS(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PRISMER_SELECT_ROWS
}

using hopper::sm_count;

// The embedding's tensor map (64 x 64 boxes, 128-byte swizzle), encoded
// once per (pointer, V, D): the weights do not move between steps. A few
// embeddings (the models a process serves) keep their maps. The caller
// gets a copy, made under the cache's lock: another thread's miss may
// reuse the entry.
bool embedding_map(CUtensorMap* out, const void* emb, int V, int D) {
  struct Entry {
    const void* emb = nullptr;
    int V = 0, D = 0;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[4];
  static int next = 0;
  const std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.emb == emb && e.V == V && e.D == D) {
      *out = e.map;
      return true;
    }
  }
  Entry& e = cache[next];
  next = (next + 1) % 4;
  e.emb = nullptr;
  if (!hopper::encode_bf16_rows(&e.map, emb, 1, 1, V, D, 0, 0, D, kTileV)) {
    return false;
  }
  e.emb = emb;
  e.V = V;
  e.D = D;
  *out = e.map;
  return true;
}

template <int NT>
cudaError_t launch_logits_rows(const CUtensorMap& map, const LogitsArgs& a,
                               const LogitsPlan& p, cudaStream_t st) {
  static hopper::SmemGrant granted;
  const cudaError_t err = granted.ensure(logits_kernel<NT>, p.smem);
  if (err != cudaSuccess) return err;
  return hopper::launch_pdl(logits_kernel<NT>, dim3(p.blocks, p.row_tiles),
                            kLogitsThreads, p.smem, st, map, a);
}

cudaError_t launch_logits(const __nv_bfloat16* h, const void* emb,
                          const float* bias, float* logits, float* pmax,
                          float* psum, int N, int D, int V, cudaStream_t st) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const LogitsPlan p = logits_plan(N, D, V, sms);
  if (static_cast<size_t>(p.smem) > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap map;
  if (!embedding_map(&map, emb, V, D)) return cudaErrorInvalidValue;
  const LogitsArgs a{h, bias, logits, pmax, psum, N, D, V, p.tiles,
                     p.chunks, p.stages};
  switch (p.rows) {
    case 8: return launch_logits_rows<8>(map, a, p, st);
    case 16: return launch_logits_rows<16>(map, a, p, st);
    case 24: return launch_logits_rows<24>(map, a, p, st);
    case 32: return launch_logits_rows<32>(map, a, p, st);
    case 48: return launch_logits_rows<48>(map, a, p, st);
    default: return launch_logits_rows<64>(map, a, p, st);
  }
}

template <int NR>
cudaError_t launch_fma_rows(const float* h, const float* emb,
                            const float* bias, float* logits, float* pmax,
                            float* psum, int N, int D, int V, int tiles,
                            cudaStream_t st) {
  static hopper::SmemGrant granted;
  const size_t smem = static_cast<size_t>(NR) * D * sizeof(float) +
                      static_cast<size_t>(NR) * kTileV * sizeof(float);
  const cudaError_t err = granted.ensure(fma_logits_kernel<float, NR>, smem);
  if (err != cudaSuccess) return err;
  return hopper::launch_pdl(fma_logits_kernel<float, NR>,
                            dim3(tiles, (N + NR - 1) / NR), kFmaWarps * 32,
                            smem, st, h, emb, bias, logits, pmax, psum, N, D,
                            V, tiles);
}

cudaError_t launch_fma(const float* h, const float* emb, const float* bias,
                       float* logits, float* pmax, float* psum, int N, int D,
                       int V, int tiles, cudaStream_t st) {
  switch (std::min(kMaxFmaRows, round_up(N, 8))) {
    case 8:
      return launch_fma_rows<8>(h, emb, bias, logits, pmax, psum, N, D, V,
                                tiles, st);
    case 16:
      return launch_fma_rows<16>(h, emb, bias, logits, pmax, psum, N, D, V,
                                 tiles, st);
    case 24:
      return launch_fma_rows<24>(h, emb, bias, logits, pmax, psum, N, D, V,
                                 tiles, st);
    default:
      return launch_fma_rows<32>(h, emb, bias, logits, pmax, psum, N, D, V,
                                 tiles, st);
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). dtype: 0 fp32, 1 bf16 (h and emb).
// work holds N * V + 2 * N * tiles floats, tiles = ceil(V / 64).
extern "C" int prismer_lm_topk(const void* h, const void* emb,
                               const float* bias, const float* alive,
                               float* work, float* out_vals, int* out_beam,
                               int* out_tok, int N, int B, int D, int V,
                               int tiles, int kk, int mask_eos, int eos_id,
                               int dtype, void* stream) {
  if (N <= 0 || B <= 0 || N % B != 0 || N / B > kMaxBeams || D <= 0 ||
      D % 8 != 0 || V <= 0 || tiles != (V + kTileV - 1) / kTileV ||
      kk <= 0 || kk > kMaxKK || kk > (N / B) * V || eos_id < 0 ||
      eos_id >= V || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* logits = work;                                 // (N, V)
  float* pmax = logits + static_cast<size_t>(N) * V;    // (N, tiles)
  float* psum = pmax + static_cast<size_t>(N) * tiles;  // (N, tiles)
  cudaError_t err =
      dtype == 1
          ? launch_logits(static_cast<const __nv_bfloat16*>(h), emb, bias,
                          logits, pmax, psum, N, D, V, st)
          : launch_fma(static_cast<const float*>(h),
                       static_cast<const float*>(emb), bias, logits, pmax,
                       psum, N, D, V, tiles, st);
  if (err != cudaSuccess) return err;
  err = launch_select(N / B, logits, pmax, psum, alive, out_vals, out_beam,
                      out_tok, B, V, tiles, kk, mask_eos, eos_id, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}
