// One whole decoder step over all layers, for Hopper (sm_90a).
//
// Replaces prismer_tpu/ops/fused_decode.py fused_decode_step (_kernel, the
// pallas_call at :637): the 13 decoder layer bodies of one beam-search step,
// with the beam reorder of the self caches folded in (flat_beam). The
// numerical spec is the XLA cached decode path (prismer_tpu/models/
// roberta.py:701-751), written out in ops/fused_decode.py
// fused_decode_step_reference:
//   * dense: fp32 accumulation, rounded to the compute dtype, then the bias
//     (held in fp32) cast to the compute dtype, added, and rounded again;
//   * LayerNorm in fp32 on x + residual (two-pass mean/variance), rounded;
//   * softmax in fp32, normalised, then rounded before the PV product, whose
//     sum runs in fp32; attention masks add the finite -1e9;
//   * adaptor: squared ReLU; MLP: exact-erf GELU (erff) in fp32.
//
// What bounds it on the H100: bytes. At Prismer-BASE batch 8 (N = 24 rows)
// one step reads ~240 MB of decoder weights, ~284 MB of cross K/V and ~19 MB
// of self cache against ~6 GFLOP, ~90 us at 3.35 TB/s; at HUGE 830 MB of
// weights. What the design does about it:
//   * bf16 projections (proj_kernel): every weight byte is read once per
//     step for all N rows. A block owns 64 output columns; one warpgroup
//     computes out^T = W x^T on wgmma, the 64 x 64 weight box as the A
//     operand and the rows of x (N rounded up to 8..32, 48 or 64) as B,
//     both K-major in the 128-byte swizzle, the sums in fp32 registers;
//     all three warpgroups of the block stage the input. The weights
//     stream through a ring of 8 KB boxes by TMA, each stage on an
//     mbarrier, from tensor maps over the packed weights encoded once per
//     (w_all, D, F, NLc), issued before the PDL wait; the block's slice of
//     x is staged once. Projections with few column tiles split K over a
//     thread-block cluster of up to 8 blocks (dense_plan, mirrored by
//     ops/fused_decode.dense_plan): each rank stores its partial's
//     fragments into the slots of the rank that sums them (distributed
//     shared memory), one cluster barrier, and each rank adds its share in
//     rank order and runs the epilogue on it, so repeats are bit-identical.
//     No atomics;
//   * fp32 projections (the card-side parity runs): FMA, one warp per
//     output column (dense_kernel);
//   * each LayerNorm but the last is folded into the projection that reads
//     it (the next layer's qkv, cross-q, adaptor down, W1), with the
//     two-pass statistics of LnRow, the code of the final LN's ln_row, so
//     the LN'd values are the ones an LN kernel writes. The projection
//     applies the LN to its K slice as it stages it, and the blocks of
//     column tile 0 also write their slices to the residual buffer the
//     later kernels read. bf16: each row's statistics are computed by one
//     block of the cluster and read by the others through distributed
//     shared memory (every block reading every row made ~100 readers of
//     the same L2 lines at once); fp32: every block computes its rows';
//   * cross-attention runs one block per (sample, head) and reads that
//     sample's K/V slice once for all its beams (the TPU kernel's beam
//     grouping, without its 8-row padding and 0/1 selector matmuls);
//   * int8 cross K/V (the JAX package's set_kv_quant("int8"), kernel 4b)
//     halve the largest stream of the step: the cross kernel reads 8 int8
//     values per 8-byte lane load (so a lane holds as many values of a row,
//     and as many registers, as in bf16, where 16 per lane spilled at
//     4 beams and up), widens them (exact: |x| <= 127), and folds
//     the fp32 per-(sample, head) scales in at the TPU kernel's two
//     rounding points (fused_decode.py:444-479): q * k_scale in fp32,
//     rounded to the compute dtype, before the scores; the normalised
//     probabilities * v_scale in fp32, rounded, before the PV sum. The
//     streamed tensor is never rescaled element by element;
//   * the beam reorder rides on the self-attention read: block (row, head)
//     reads its row's source row from the old cache, writes it to the second
//     buffer, writes the fresh K/V column at `index`, and attends. It cannot
//     permute in place (row n reads row flat_beam[n]).
// Layer i+1 depends on all of layer i across blocks, so the entry launches a
// fixed sequence of kernels per layer on the caller's stream: 10 for a layer
// with cross-attention, 5 for the output layer and one final LayerNorm (126
// at 12 + 1 layers, 246 at 24 + 1; ops/fused_decode.step_launches), one
// host call per step, no grid-wide barrier. Every launch carries
// programmatic stream serialization (PDL, `launch`), so a kernel's blocks
// become resident while the kernel before it runs, and the rule is:
//   * every block of every kernel of the step executes grid_dep_wait
//     (griddepcontrol.wait), unconditionally and before it exits: a kernel
//     that skipped it could complete before the kernel it follows, and the
//     next one, whose wait only covers its own predecessor, could then read
//     that kernel's output early;
//   * before the wait a kernel reads only what is constant during the step
//     (packed weights, by TMA into the projection's ring; fp32 biases and
//     LN parameters; tensor maps passed as __grid_constant__ parameters) and
//     writes nothing, so every write to xbuf, qkv, att, o and act follows
//     the completion of every earlier kernel;
//   * the trigger (grid_dep_launch) follows the wait, so at most the next
//     launch waits resident beside a running one; a trigger before the wait
//     would let the whole step's launches pile up on the SMs. A projection
//     block stays within half an SM's shared memory (dense_plan) so that
//     one block of the next launch fits beside it;
//   * the first launch of a step follows PyTorch's kernels (lm_topk,
//     beam_update, the cache swap), which never trigger early: its wait
//     ends at their completion.
// A persistent kernel or one CUDA graph per step would also remove the
// host's issue of each launch; that is later work, as are the cross,
// int8-cross and self phases on the card's newer instructions.
//
// Layouts (ops/fused_decode.py says the same):
//   hidden (N, D); self caches (NL, T, N, D), so a step's column is one
//   contiguous (N, D) slab; cross K/V natural and unpadded, (NLc, B, L, D),
//   in the compute dtype or int8 with fp32 scales (NLc, B, H);
//   weights packed per layer, each matrix (out, in) row-major:
//     cross layer:  Wqkv (3D, D) | Wso | Wcq | Wco | Wad | Wau (D, D) |
//                   W1 (F, D) | W2 (D, F)
//     output layer: Wqkv | Wso | W1 | W2
//   biases and LN parameters fp32 per layer:
//     cross layer:  bqkv 3D | bso | ln1 s, b | bcq | bco | ln2 s, b | bad |
//                   bau | lnad s, b | b1 F | b2 | ln3 s, b
//     output layer: bqkv 3D | bso | ln1 s, b | b1 F | b2 | ln3 s, b

#include <cooperative_groups.h>

#include <algorithm>
#include <mutex>
#include <type_traits>
#include <utility>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

using prismer::from_f;
using prismer::round_to;
using prismer::to_f;
using prismer::Vec;
using prismer::warp_max;
using prismer::warp_rows_dot;
using prismer::warp_sum;

constexpr float kMaskFill = -1.0e9f;   // layers.py NEG_INF (attention masks)
constexpr int kDenseWarps = 8;
constexpr int kDenseThreads = 32 * kDenseWarps;
constexpr int kMaxRows = 32;           // rows per block; more rows, more blocks
constexpr int kChunkBytes = 48 * 1024; // input tile of an FMA projection
constexpr int kSelfThreads = 128;
constexpr int kCrossThreads = 512;
constexpr int kCrossWarps = kCrossThreads / 32;
constexpr int kMaxBeams = 8;
constexpr int kMaxLnDim = 1024;        // LayerNorm rows live in registers

enum Act { kActNone = 0, kActSqRelu = 1, kActGelu = 2 };

using hopper::grid_dep_launch;
using hopper::grid_dep_wait;

// kernels the calling thread's last step launched
thread_local int g_launches = 0;

// Every kernel of the step goes through here: programmatic stream
// serialization lets it launch while the kernel before it still runs (it
// waits in grid_dep_wait), and `cluster` > 1 groups its blocks along x into
// thread-block clusters of that size.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads,
                   size_t smem, int cluster, cudaStream_t st,
                   Args&&... args) {
  cudaLaunchAttribute attrs[2] = {};
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = cluster;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
  ++g_launches;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// x = o + res over one row of D <= kMaxLnDim, read by one warp (16 bytes
// per lane per load, every load in flight together) and kept in registers,
// with the two-pass statistics of the spec: the row's mean and
// 1 / sqrt(var + eps). The final LayerNorm (ln_row) and every LayerNorm
// folded into a projection take them from here, so a folded LN'd value is
// the one ln_row writes.
template <typename T>
struct LnRow {
  static constexpr int V = Vec<T>::kN;
  static constexpr int NV = kMaxLnDim / (32 * V);
  float x[NV][V];
  float mean, rstd;

  __device__ __forceinline__ void load(const T* o, const T* res, int D,
                                       float eps, int lane) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = (lane + 32 * i) * V;
      if (k < D) {
        float r[V];
        Vec<T>::load(o + k, x[i]);
        Vec<T>::load(res + k, r);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          x[i][j] += r[j];
          sum += x[i][j];
        }
      }
    }
    mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((lane + 32 * i) * V < D) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = x[i][j] - mean;
          sq += d * d;
        }
      }
    }
    rstd = rsqrtf(warp_sum(sq) / D + eps);
  }
};

// (x - mean) * rstd * s + b, each step rounded as written (no contraction
// but the last fma), wherever a LayerNorm is applied
__device__ __forceinline__ float ln_apply(float x, float mean, float rstd,
                                          float s, float b) {
  return __fmaf_rn(__fmul_rn(__fsub_rn(x, mean), rstd), s, b);
}

// dst = LN(o + res) over one row, by one warp
template <typename T>
__device__ void ln_row(const T* o, const T* res, const float* s,
                       const float* b, int D, float eps, int lane, T* dst) {
  LnRow<T> r;
  r.load(o, res, D, eps, lane);
#pragma unroll
  for (int i = 0; i < LnRow<T>::NV; ++i) {
    const int k = (lane + 32 * i) * LnRow<T>::V;
    if (k < D) {
#pragma unroll
      for (int j = 0; j < LnRow<T>::V; ++j) {
        dst[k + j] = from_f<T>(ln_apply(r.x[i][j], r.mean, r.rstd, s[k + j],
                                        b[k + j]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// projection: out = act(round(x @ W^T) + b), x (N, K), W (M, K)
// ---------------------------------------------------------------------------

// With ln_s given, the input is x = LN(ln_o + ln_res) (K = D), computed by
// the projection itself (the LayerNorm folded into the projection that
// reads it), and the blocks of column tile 0 also write it to res_out, the
// residual the later kernels read.
template <typename T>
struct DenseParams {
  const T* x;          // (N, K), or null with ln_s
  const T* w;          // (M, K)
  const float* bias;   // (M,)
  T* out;              // (N, M)
  const T* ln_o;       // (N, K)
  const T* ln_res;     // (N, K)
  const float* ln_s;   // LN scale (K), then bias (K); null: no LN
  T* res_out;          // (N, K)
  float eps;
  int N, K, M, kc, act;
  // bf16: the weight tensor map that holds W (host memory, read by the
  // launcher) and W's layer and first row in it
  const CUtensorMap* map;
  int layer, row;
};

// the (mean, rstd) of rows row0 + n of LN(ln_o + ln_res), n = first,
// first + step, .. < rows, one warp per row, into stats[n]
template <typename T>
__device__ void ln_stats_rows(const DenseParams<T>& p, int row0, int rows,
                              float2* stats, int first, int step, int lane) {
  for (int n = first; n < rows; n += step) {
    const size_t off = static_cast<size_t>(row0 + n) * p.K;
    LnRow<T> r;
    r.load(p.ln_o + off, p.ln_res + off, p.K, p.eps, lane);
    if (lane == 0) stats[n] = make_float2(r.mean, r.rstd);
  }
}

// 16 bytes (Vec<T>::kN values) of LN(ln_o + ln_res), row n, columns k ..,
// rounded to T, with the LN scale and bias of those columns at sc and bs;
// with `res` also written to res_out
template <typename T>
__device__ __forceinline__ uint4 ln_vec(const DenseParams<T>& p, int n,
                                        int k, float2 st, const float* sc,
                                        const float* bs, bool res) {
  constexpr int V = Vec<T>::kN;
  const size_t off = static_cast<size_t>(n) * p.K + k;
  float o[V], r[V];
  Vec<T>::load(p.ln_o + off, o);
  Vec<T>::load(p.ln_res + off, r);
  uint4 v;
  T* y = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    y[j] = from_f<T>(ln_apply(o[j] + r[j], st.x, st.y, sc[j], bs[j]));
  }
  if (res) *reinterpret_cast<uint4*>(p.res_out + off) = v;
  return v;
}

// load_rows for an LN'd input: rows [row0, row0 + NR) x columns [k0, k0 +
// len) of LN(ln_o + ln_res) into xs (row stride ldx), rows past `rows` as
// zeros
template <typename T, int NR>
__device__ void load_rows_ln(const DenseParams<T>& p, int row0, int rows,
                             int k0, int len, const float2* stats, bool res,
                             T* xs, int ldx) {
  constexpr int V = Vec<T>::kN;
  const int segs = len / V;
  for (int e = threadIdx.x; e < NR * segs; e += blockDim.x) {
    const int n = e / segs;
    const int c = (e - n * segs) * V;
    const uint4 v =
        n < rows ? ln_vec(p, row0 + n, k0 + c, stats[n], p.ln_s + k0 + c,
                          p.ln_s + p.K + k0 + c, res)
                 : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(xs + n * ldx + c) = v;
  }
}

// the projection's epilogue: round the fp32 sum to T, add the bias cast to
// T, round, then the activation in fp32, rounded
template <typename T>
__device__ __forceinline__ T dense_out(float s, float bias, int act) {
  float y = round_to<T>(round_to<T>(s) + round_to<T>(bias));
  if (act == kActSqRelu) {
    const float r = fmaxf(y, 0.f);
    y = r * r;
  } else if (act == kActGelu) {
    y = 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
  }
  return from_f<T>(y);
}

template <typename T, int NR>
__global__ void __launch_bounds__(kDenseThreads)
dense_kernel(const DenseParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (NR, kc)
  float2* stats = reinterpret_cast<float2*>(xs + NR * p.kc);   // (NR)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * NR;
  const int rows = min(NR, p.N - row0);
  const int col = blockIdx.x * kDenseWarps + warp;

  float acc[NR];
#pragma unroll
  for (int n = 0; n < NR; ++n) acc[n] = 0.f;

  // the warp's weight row heads for L2 while the input tile loads
  if (col < p.M) {
    prismer::prefetch_l2(p.w + static_cast<size_t>(col) * p.K,
                         p.K * static_cast<int>(sizeof(T)), lane);
  }
  grid_dep_wait();
  grid_dep_launch();
  const bool ln = p.ln_s != nullptr;
  if (ln) {
    ln_stats_rows(p, row0, rows, stats, warp, kDenseWarps, lane);
    __syncthreads();
  }
  for (int k0 = 0; k0 < p.K; k0 += p.kc) {
    const int len = min(p.kc, p.K - k0);
    if (k0 > 0) __syncthreads();
    if (ln) {
      load_rows_ln<T, NR>(p, row0, rows, k0, len, stats, blockIdx.x == 0, xs,
                          p.kc);
    } else {
      prismer::load_rows<T, NR>(p.x, p.K, row0, rows, k0, len, xs, p.kc);
    }
    __syncthreads();
    if (col < p.M) {
      warp_rows_dot<T, NR>(p.w + static_cast<size_t>(col) * p.K + k0, xs,
                           p.kc, len, lane, acc);
    }
  }
  if (col >= p.M) return;

  const float bias = p.bias[col];
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    const float s = warp_sum(acc[n]);
    if (lane == n && n < rows) {
      p.out[static_cast<size_t>(row0 + n) * p.M + col] =
          dense_out<T>(s, bias, p.act);
    }
  }
}

template <typename T, int NR>
cudaError_t launch_dense_nr(DenseParams<T> p, cudaStream_t st) {
  static hopper::SmemGrant granted;
  constexpr int esz = sizeof(T);
  p.kc = std::min(p.K, std::max(8, kChunkBytes / (NR * esz) / 8 * 8));
  const size_t smem = static_cast<size_t>(NR) * p.kc * esz +
                      NR * sizeof(float2);
  cudaError_t err = granted.ensure(dense_kernel<T, NR>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + kDenseWarps - 1) / kDenseWarps,
                  (p.N + NR - 1) / NR);
  return launch(dense_kernel<T, NR>, grid, kDenseThreads, smem, 1, st, p);
}

template <typename T>
cudaError_t launch_dense_fma(const DenseParams<T>& p, cudaStream_t st) {
  switch (std::min(kMaxRows, prismer::round_up(p.N, 8))) {
    case 8: return launch_dense_nr<T, 8>(p, st);
    case 16: return launch_dense_nr<T, 16>(p, st);
    case 24: return launch_dense_nr<T, 24>(p, st);
    default: return launch_dense_nr<T, 32>(p, st);
  }
}

// ---------------------------------------------------------------------------
// bf16 projection: wgmma on a TMA weight ring, split-K over a cluster
// ---------------------------------------------------------------------------

// A block owns 64 output columns; its first warpgroup computes out^T (64 x
// NT) = W (64 x K slice) . x^T (K slice x NT) with wgmma. The weights
// stream through a ring of 64 x 64 boxes (8 KB) by TMA, each stage on its
// own mbarrier; thread 0 fills the ring before the PDL wait (the weights
// do not depend on the kernels before), and refills a stage once the
// warpgroup's products on it have retired. The input slice is staged once,
// after the wait, by all three warpgroups (LN'd where an LN precedes). The
// `split` blocks of a cluster take K slices and exchange their partials
// once (the reduce-scatter below); each rank runs dense_out's epilogue on
// its share.

constexpr int kProjThreads = 384;   // three warpgroups: all stage, one wgmma
constexpr int kMmaThreads = 128;    // the warpgroup that runs wgmma
constexpr int kTile = 64;                // output columns per block; k per box
constexpr int kBoxBytes = kTile * kTile * 2;   // one 64 x 64 bf16 weight box
constexpr int kMaxStages = 8;
constexpr int kMaxSplit = 8;             // the portable cluster size
constexpr int kMinBlocks = 128;          // split until a launch has this many
constexpr int kMaxTileRows = 64;
// two projection blocks fit an SM's 228 KB (1 KB each reserved): one of the
// running launch and one of the next, resident early under PDL
constexpr int kProjSmemBudget = (228 - 2) / 2 * 1024;

// The launch shape of one projection: `dense_plan` here and
// ops/fused_decode.dense_plan in Python compute it the same way.
struct DensePlan {
  int col_tiles;   // 64-column tiles of the M outputs
  int rows;        // rows per row tile: N rounded up to 8, 16, 24, 32, 48, 64
  int row_tiles;   // row tiles of N
  int k_tiles;     // 64-wide tiles of K
  int split;       // blocks per cluster, each a K slice
  int slice;       // k tiles of the largest slice
  int stages;      // weight boxes in flight per block
  int smem;        // dynamic shared memory bytes per block
};

inline int proj_smem(int rows, int slice, int stages, int split) {
  return stages * kBoxBytes + slice * rows * 128 +            // ring, x
         (split > 1 ? kTile * rows * 4 : 0) +                  // partials
         kTile * 4 + 2 * slice * kTile * 4 +           // bias, LN parameters
         rows * 8 + stages * 8 + 1024;              // LN stats, bars, align
}

inline DensePlan dense_plan(int M, int K, int N) {
  DensePlan q;
  q.col_tiles = (M + kTile - 1) / kTile;
  const int r8 = (std::min(N, kMaxTileRows) + 7) / 8 * 8;
  q.rows = r8 <= 32 ? r8 : (r8 <= 48 ? 48 : 64);
  q.row_tiles = (N + q.rows - 1) / q.rows;
  q.k_tiles = (K + kTile - 1) / kTile;
  q.split = 1;
  while (q.split < kMaxSplit && 2 * q.split <= q.k_tiles &&
         q.col_tiles * q.row_tiles * q.split < kMinBlocks) {
    q.split *= 2;
  }
  q.slice = (q.k_tiles + q.split - 1) / q.split;
  q.stages = std::min(q.slice, kMaxStages);
  while (q.stages > 2 &&
         proj_smem(q.rows, q.slice, q.stages, q.split) > kProjSmemBudget) {
    --q.stages;
  }
  q.smem = proj_smem(q.rows, q.slice, q.stages, q.split);
  return q;
}

struct ProjParams {
  DenseParams<__nv_bfloat16> d;
  int k_tiles, split, stages;   // from dense_plan
};

template <int NT>
__global__ void __launch_bounds__(kProjThreads)
proj_kernel(const __grid_constant__ CUtensorMap wmap, const ProjParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DenseParams<bf16>& d = p.d;
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;                 // K slice = rank in cluster
  const int m0 = blockIdx.y * kTile;           // output columns
  const int n0 = blockIdx.z * NT;              // input rows
  const int rows = min(NT, d.N - n0);
  const int kt0 = rank * p.k_tiles / p.split;
  const int tiles = (rank + 1) * p.k_tiles / p.split - kt0;
  const int slice = (p.k_tiles + p.split - 1) / p.split;
  const int stages = p.stages;
  uint8_t* ring = hopper::align_1024(smem_raw);
  uint8_t* xs = ring + stages * kBoxBytes;                 // [slice][NT][64]
  float* part = reinterpret_cast<float*>(xs + slice * NT * 128);
  float* bias = part + (p.split > 1 ? kTile * NT : 0);   // [64]
  float* lnp = bias + kTile;        // LN scale, then bias, of the K slice
  float2* stats = reinterpret_cast<float2*>(lnp + 2 * slice * kTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + NT);

  auto issue = [&](int i) {   // weight box i of the slice into its stage
    uint64_t* bar = bars + i % stages;
    hopper::mbar_arrive_expect_tx(bar, kBoxBytes);
    hopper::tma_load_4d(ring + (i % stages) * kBoxBytes, &wmap, bar,
                        (kt0 + i) * kTile, d.row + m0, d.layer, 0);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(bars + s, 1);
    hopper::mbar_init_fence();
    for (int i = 0; i < min(stages, tiles); ++i) issue(i);
  }
  // the bias of the block's columns and the LN parameters of its K slice
  // are constant during the step: read before the wait
  const bool ln = d.ln_s != nullptr;
  for (int t = tid; t < kTile; t += kProjThreads) {
    bias[t] = m0 + t < d.M ? d.bias[m0 + t] : 0.f;
  }
  if (ln) {
    for (int t = tid; t < tiles * kTile; t += kProjThreads) {
      const int k = kt0 * kTile + t;
      lnp[t] = k < d.K ? d.ln_s[k] : 0.f;
      lnp[slice * kTile + t] = k < d.K ? d.ln_s[d.K + k] : 0.f;
    }
  }
  grid_dep_wait();
  grid_dep_launch();

  // the input slice, in the 128-byte swizzle: 16-byte chunk j of row n of
  // column block c at c * NT * 128 + n * 128 + (j ^ (n % 8)) * 16; rows
  // past N and columns past K as zeros. With an LN, the blocks of column
  // tile 0 also write the LN'd slice to the residual.
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (ln) {
    // each row's statistics are computed by one block of the cluster (rows
    // n = rank, rank + split, ..) and read by the others through
    // distributed shared memory: every block of the launch reading every
    // row from L2 would read the same lines ~100 times over at once
    constexpr int kWarps = kProjThreads / 32;
    ln_stats_rows(d, n0, rows, stats, rank + p.split * warp,
                  p.split * kWarps, lane);
    if (p.split > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      for (int n = tid; n < rows; n += kProjThreads) {
        if (n % p.split != rank) {
          stats[n] = cluster.map_shared_rank(stats, n % p.split)[n];
        }
      }
    }
    hopper::named_sync(1, kProjThreads);
  }
  const bool res = ln && blockIdx.y == 0;
  for (int e = tid; e < tiles * NT * 8; e += kProjThreads) {
    const int c = e / (NT * 8);
    const int n = (e / 8) % NT;
    const int j = e % 8;
    const int k = (kt0 + c) * kTile + j * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < rows && k < d.K) {
      const int kl = k - kt0 * kTile;
      v = ln ? ln_vec(d, n0 + n, k, stats[n], lnp + kl,
                      lnp + slice * kTile + kl, res)
             : *reinterpret_cast<const uint4*>(
                   d.x + static_cast<size_t>(n0 + n) * d.K + k);
    }
    *reinterpret_cast<uint4*>(xs + c * NT * 128 + n * 128 +
                              ((j ^ (n & 7)) * 16)) = v;
  }
  hopper::fence_proxy_async();
  __syncthreads();   // the slice is staged; the barriers are initialised

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  const uint32_t ring_a = hopper::smem_addr(ring);
  const uint32_t xs_a = hopper::smem_addr(xs);
  if (tid < kMmaThreads) {
    for (int i = 0; i < tiles; ++i) {
      hopper::mbar_wait(bars + i % stages, (i / stages) & 1);
      const uint32_t a = ring_a + (i % stages) * kBoxBytes;
      const uint32_t b = xs_a + i * NT * 128;
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kTile / 16; ++k) {
        hopper::wgmma_ss<NT>(acc, hopper::kmajor_desc(a + k * 32),
                             hopper::kmajor_desc(b + k * 32), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<NT / 2>(acc);
      if (i + stages < tiles) {   // the stage is free once every warp retired
        hopper::named_sync(2, kMmaThreads);
        if (tid == 0) issue(i + stages);
      }
    }
  }

  // acc[4j + 2h + e] of thread t: output column m0 + 16 (t / 32) + (t % 32)
  // / 4 + 8h, input row n0 + 8j + 2 (t % 4) + e
  auto store = [&](int t, int i, float sum) {
    const int m = 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
    const int n = 8 * (i / 4) + 2 * (t % 4) + i % 2;
    if (m0 + m < d.M && n < rows) {
      d.out[static_cast<size_t>(n0 + n) * d.M + m0 + m] =
          dense_out<bf16>(sum, bias[m], d.act);
    }
  };
  if (p.split == 1) {
    if (tid < kMmaThreads) {
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) store(tid, i, acc[i]);
    }
    return;
  }
  // split K: rank s sums and stores the fragments of threads [s * T /
  // split, (s + 1) T / split) of the wgmma warpgroup (T = 128). Every rank
  // stores those fragments of its partial into rank s's slots (part,
  // [rank][thread][fragment]), the cluster synchronises once, and rank s
  // adds the slots in rank order, so the sums are bit-identical from run to
  // run and equal to a sequential rank 0 + 1 + ... Nothing is read from a
  // peer after the barrier.
  cg::cluster_group cluster = cg::this_cluster();
  const int per = kMmaThreads / p.split;             // threads a rank sums
  if (tid < kMmaThreads) {
    float4* slot = reinterpret_cast<float4*>(
        cluster.map_shared_rank(part, tid / per) +
        (rank * per + tid % per) * (NT / 2));
#pragma unroll
    for (int q = 0; q < NT / 8; ++q) {
      slot[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                            acc[4 * q + 3]);
    }
  }
  cluster.sync();   // every rank's slots are full
  for (int e = tid; e < per * (NT / 2); e += kProjThreads) {
    float sum = part[e];
    for (int r = 1; r < p.split; ++r) sum += part[r * per * (NT / 2) + e];
    store(rank * per + e / (NT / 2), e % (NT / 2), sum);
  }
}

template <int NT>
cudaError_t launch_proj_rows(const ProjParams& p, const CUtensorMap& map,
                             const DensePlan& q, cudaStream_t st) {
  static hopper::SmemGrant granted;
  const cudaError_t err = granted.ensure(proj_kernel<NT>, q.smem);
  if (err != cudaSuccess) return err;
  return launch(proj_kernel<NT>, dim3(q.split, q.col_tiles, q.row_tiles),
                kProjThreads, q.smem, q.split, st, map, p);
}

cudaError_t launch_proj(const DenseParams<__nv_bfloat16>& d,
                        cudaStream_t st) {
  const DensePlan q = dense_plan(d.M, d.K, d.N);
  const ProjParams p{d, q.k_tiles, q.split, q.stages};
  switch (q.rows) {
    case 8: return launch_proj_rows<8>(p, *d.map, q, st);
    case 16: return launch_proj_rows<16>(p, *d.map, q, st);
    case 24: return launch_proj_rows<24>(p, *d.map, q, st);
    case 32: return launch_proj_rows<32>(p, *d.map, q, st);
    case 48: return launch_proj_rows<48>(p, *d.map, q, st);
    default: return launch_proj_rows<64>(p, *d.map, q, st);
  }
}

// fp32 (the card-side parity runs): FMA tiles; bf16: the wgmma kernel
template <typename T>
cudaError_t launch_dense(const DenseParams<T>& p, cudaStream_t st) {
  return launch_dense_fma<T>(p, st);
}

template <>
cudaError_t launch_dense<__nv_bfloat16>(const DenseParams<__nv_bfloat16>& p,
                                        cudaStream_t st) {
  return launch_proj(p, st);
}

// The bf16 weights as TMA tensor maps (64 x 64 boxes, 128-byte swizzle),
// [0] over the cross layers, [1] over the output layer: dmap the rows of
// the matrices with K = D (qkv, self-out, cross-q, cross-out, adaptor down
// and up, W1, one after the other), one layer after the other; fmap W2
// (K = F). Encoded once per (w_all, D, F, NLc): the weights do not move
// between steps. A few packings (the models a process serves) keep their
// maps; the caller gets a copy, made under the cache's lock, since another
// thread's miss may reuse the entry.
struct WeightMaps {
  const void* w = nullptr;
  int D = 0, F = 0, NLc = 0;
  CUtensorMap dmap[2], fmap[2];
};

constexpr int kWeightMapCache = 4;

bool encode_weight_maps(WeightMaps* m, const void* w_all, int D, int F,
                        int NLc) {
  const int64_t dd = static_cast<int64_t>(D) * D;
  const int64_t fd = static_cast<int64_t>(F) * D;
  const int64_t layer = 8 * dd + 2 * fd;
  const auto* w = static_cast<const __nv_bfloat16*>(w_all);
  const auto* wo = w + NLc * layer;
  bool ok = hopper::encode_bf16_rows(&m->dmap[1], wo, 1, 1, 4 * D + F, D, 0,
                                     0, D, kTile) &&
            hopper::encode_bf16_rows(&m->fmap[1], wo + 4 * dd + fd, 1, 1, D,
                                     F, 0, 0, F, kTile);
  if (NLc > 0) {
    ok = ok &&
         hopper::encode_bf16_rows(&m->dmap[0], w, 1, NLc, 8 * D + F, D, 0,
                                  layer, D, kTile) &&
         hopper::encode_bf16_rows(&m->fmap[0], w + 8 * dd + fd, 1, NLc, D,
                                  F, 0, layer, F, kTile);
  }
  m->w = ok ? w_all : nullptr;
  m->D = D;
  m->F = F;
  m->NLc = NLc;
  return ok;
}

bool weight_maps(WeightMaps* out, const void* w_all, int D, int F, int NLc) {
  static std::mutex mu;
  static WeightMaps cache[kWeightMapCache];
  static int next = 0;
  const std::lock_guard<std::mutex> lock(mu);
  for (const WeightMaps& m : cache) {
    if (m.w == w_all && m.D == D && m.F == F && m.NLc == NLc) {
      *out = m;
      return true;
    }
  }
  WeightMaps& m = cache[next];
  next = (next + 1) % kWeightMapCache;
  if (!encode_weight_maps(&m, w_all, D, F, NLc)) return false;
  *out = m;
  return true;
}

// ---------------------------------------------------------------------------
// self-attention over the cache, with the beam reorder and the column write
// ---------------------------------------------------------------------------

template <typename T>
struct SelfParams {
  const T* qkv;        // (N, 3D): q | k_new | v_new
  const T* ck_in;      // this layer's (T, N, D) caches, read
  const T* cv_in;
  T* ck_out;           // written: permuted caches (== ck_in without perm)
  T* cv_out;
  const int* flat_beam;  // (N,), or null for no reorder
  const int* key_mask;   // (N, T) {0, 1}, valid after this column is written
  T* k_new;            // this layer's (N, D)
  T* v_new;
  T* att;              // (N, D)
  int N, D, Dh, Tn, index;
  float scale;
};

// grid (H, N): one block per (head, row)
template <typename T>
__global__ void __launch_bounds__(kSelfThreads)
self_attn_kernel(const SelfParams<T> p) {
  extern __shared__ float sm[];
  const int ld = p.Dh + 1;        // padded against bank conflicts
  float* ks = sm;                 // (T, Dh + 1)
  float* vs = ks + p.Tn * ld;     // (T, Dh + 1)
  float* qs = vs + p.Tn * ld;     // (Dh)
  float* ps = qs + p.Dh;          // (T)
  grid_dep_wait();
  grid_dep_launch();
  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int D = p.D;
  const bool perm = p.flat_beam != nullptr;
  const int src = perm ? p.flat_beam[n] : n;
  const T* row = p.qkv + static_cast<size_t>(n) * 3 * D;

  // permute, write the fresh column, stage K/V for the read (16 bytes per
  // thread and load)
  constexpr int V = Vec<T>::kN;
  const int vpr = p.Dh / V;        // vectors per head row
  for (int e = threadIdx.x; e < p.Tn * vpr; e += blockDim.x) {
    const int t = e / vpr;
    const int dv = (e - t * vpr) * V;
    const int c = h * p.Dh + dv;
    uint4 kr, vr;
    if (t == p.index) {
      kr = *reinterpret_cast<const uint4*>(row + D + c);
      vr = *reinterpret_cast<const uint4*>(row + 2 * D + c);
    } else {
      const size_t off = (static_cast<size_t>(t) * p.N + src) * D + c;
      kr = *reinterpret_cast<const uint4*>(p.ck_in + off);
      vr = *reinterpret_cast<const uint4*>(p.cv_in + off);
    }
    if (perm || t == p.index) {
      const size_t off = (static_cast<size_t>(t) * p.N + n) * D + c;
      *reinterpret_cast<uint4*>(p.ck_out + off) = kr;
      *reinterpret_cast<uint4*>(p.cv_out + off) = vr;
    }
    float kf[V], vf[V];
    Vec<T>::unpack(kr, kf);
    Vec<T>::unpack(vr, vf);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ks[t * ld + dv + i] = kf[i];
      vs[t * ld + dv + i] = vf[i];
    }
  }
  for (int e = threadIdx.x; e < vpr; e += blockDim.x) {
    const int c = h * p.Dh + e * V;
    float qf[V];
    Vec<T>::load(row + c, qf);
#pragma unroll
    for (int i = 0; i < V; ++i) qs[e * V + i] = qf[i];
    const size_t o = static_cast<size_t>(n) * D + c;
    *reinterpret_cast<uint4*>(p.k_new + o) =
        *reinterpret_cast<const uint4*>(row + D + c);
    *reinterpret_cast<uint4*>(p.v_new + o) =
        *reinterpret_cast<const uint4*>(row + 2 * D + c);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < p.Tn; t += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < p.Dh; ++d) s = fmaf(qs[d], ks[t * ld + d], s);
    const float keep =
        static_cast<float>(p.key_mask[static_cast<size_t>(n) * p.Tn + t]);
    ps[t] = s * p.scale + (1.0f - keep) * kMaskFill;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = -INFINITY;
    for (int t = lane; t < p.Tn; t += 32) m = fmaxf(m, ps[t]);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < p.Tn; t += 32) {
      const float e = expf(ps[t] - m);
      ps[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < p.Tn; t += 32) ps[t] = round_to<T>(ps[t] / sum);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < p.Dh; d += blockDim.x) {
    float a = 0.f;
    for (int t = 0; t < p.Tn; ++t) a = fmaf(ps[t], vs[t * ld + d], a);
    p.att[static_cast<size_t>(n) * D + h * p.Dh + d] = from_f<T>(a);
  }
}

// ---------------------------------------------------------------------------
// beam-grouped cross-attention: one block per (head, sample)
// ---------------------------------------------------------------------------

// One lane load of cross K/V (Raw) widened to fp32: 16 bytes of the compute
// dtype (its Vec), or 8 int8 values (byte i of word w is element 4 w + i)
template <typename KV>
struct KvVec : Vec<KV> {
  using Raw = uint4;
};

template <>
struct KvVec<int8_t> {
  using Raw = uint2;
  static constexpr int kN = 8;
  __device__ static void unpack(const uint2& v, float* out) {
    const uint32_t w[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[4 * i + j] = static_cast<float>(
            static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
      }
    }
  }
};

template <typename T, typename KV>
struct CrossParams {
  const T* q;          // (N, D), N = B * beams
  const KV* k;         // this layer's (B, L, D)
  const KV* v;
  const float* ks;     // int8 K/V: this layer's (B, H) scales, else null
  const float* vs;
  T* out;              // (N, D)
  int B, H, L, D, Dh;
  float scale;
};

// A key/value row of the head (Dh values, 16 bytes per lane; 8 in int8) is
// read by a group of LPR = Dh / KvVec<KV>::kN lanes, so a warp reads 32 /
// LPR whole rows per load, coalesced, and each lane keeps U loads in
// flight. K and V are read once for all BEAMS beams of the sample. LPR must
// be a power of two (the shuffle sums below halve it): Dh 64 in every
// registry decoder gives 8 (bf16 and int8) and 16 (fp32); the wrapper
// checks.
template <typename T, typename KV, int BEAMS>
__global__ void __launch_bounds__(kCrossThreads)
cross_attn_kernel(const CrossParams<T, KV> p) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int V = KvVec<KV>::kN;
  constexpr int U = 8;
  extern __shared__ float sm[];
  const int L = p.L;
  const int Dh = p.Dh;
  const int D = p.D;
  const int lpr = Dh / V;            // lanes per row, a power of two <= 32
  const int rpw = 32 / lpr;          // rows per warp and load
  float* ss = sm;                    // (BEAMS, L) scores, then probabilities
  float* red = ss + BEAMS * L;       // (warps, BEAMS, Dh)
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % lpr;        // which slice of the row
  const int grp = lane / lpr;        // which row of the warp's load
  const size_t kv0 = static_cast<size_t>(b) * L * D + h * Dh + sub * V;
  const int stride = kCrossWarps * rpw;
  grid_dep_wait();
  grid_dep_launch();

  // the lane's V query values of each beam; with int8 K the K scale folds
  // into them in fp32, rounded to the compute dtype
  float qv[BEAMS][V];
#pragma unroll
  for (int j = 0; j < BEAMS; ++j) {
#pragma unroll
    for (int i = 0; i < V; i += Vec<T>::kN) {
      Vec<T>::load(p.q + static_cast<size_t>(b * BEAMS + j) * D + h * Dh +
                   sub * V + i, qv[j] + i);
    }
    if constexpr (kQuant) {
      const float ks = p.ks[b * p.H + h];
#pragma unroll
      for (int i = 0; i < V; ++i) qv[j][i] = round_to<T>(qv[j][i] * ks);
    }
  }

  // scores (the loop bound is warp-uniform: every lane takes part in the
  // shuffles)
  using Raw = typename KvVec<KV>::Raw;
  for (int lw = warp * rpw; lw < L; lw += stride * U) {
    const int l0 = lw + grp;
    Raw raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = l0 + u * stride;
      if (l < L) raw[u] = *reinterpret_cast<const Raw*>(
          p.k + kv0 + static_cast<size_t>(l) * D);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = l0 + u * stride;
      float kv[V];
      KvVec<KV>::unpack(raw[u], kv);
      float part[BEAMS];
#pragma unroll
      for (int j = 0; j < BEAMS; ++j) {
        part[j] = 0.f;
        if (l < L) {
#pragma unroll
          for (int i = 0; i < V; ++i) part[j] = fmaf(qv[j][i], kv[i],
                                                     part[j]);
        }
      }
      // sum over the lpr lanes of the row (all lanes take part)
#pragma unroll
      for (int j = 0; j < BEAMS; ++j) {
        for (int o = lpr / 2; o > 0; o >>= 1) {
          part[j] += __shfl_xor_sync(0xffffffffu, part[j], o);
        }
      }
      if (sub == 0 && l < L) {
#pragma unroll
        for (int j = 0; j < BEAMS; ++j) ss[j * L + l] = part[j] * p.scale;
      }
    }
  }
  __syncthreads();

  // softmax of each beam row, one warp per row; with int8 V the V scale
  // folds into the normalised probabilities before their rounding
  const float vsc = kQuant ? p.vs[b * p.H + h] : 1.f;
  for (int j = warp; j < BEAMS; j += kCrossWarps) {
    float* r = ss + j * L;
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, r[l]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float e = expf(r[l] - m);
      r[l] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int l = lane; l < L; l += 32) {
      r[l] = kQuant ? round_to<T>(r[l] / sum * vsc) : round_to<T>(r[l] / sum);
    }
  }
  __syncthreads();

  // PV: each lane accumulates its slice of the rows its group reads
  float acc[BEAMS][V];
#pragma unroll
  for (int j = 0; j < BEAMS; ++j) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
  }
  for (int lw = warp * rpw; lw < L; lw += stride * U) {
    const int l0 = lw + grp;
    Raw raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = l0 + u * stride;
      if (l < L) raw[u] = *reinterpret_cast<const Raw*>(
          p.v + kv0 + static_cast<size_t>(l) * D);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = l0 + u * stride;
      if (l < L) {
        float vv[V];
        KvVec<KV>::unpack(raw[u], vv);
#pragma unroll
        for (int j = 0; j < BEAMS; ++j) {
          const float pj = ss[j * L + l];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[j][i] = fmaf(pj, vv[i], acc[j][i]);
        }
      }
    }
  }
  // reduce over the warp's row groups, then over the warps in order
#pragma unroll
  for (int j = 0; j < BEAMS; ++j) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      for (int o = lpr; o < 32; o <<= 1) {
        acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], o);
      }
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < BEAMS; ++j) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[(warp * BEAMS + j) * Dh + sub * V + i] = acc[j][i];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BEAMS * Dh; e += kCrossThreads) {
    const int j = e / Dh;
    const int d = e - j * Dh;
    float a = 0.f;
    for (int w = 0; w < kCrossWarps; ++w) a += red[(w * BEAMS + j) * Dh + d];
    p.out[static_cast<size_t>(b * BEAMS + j) * D + h * Dh + d] =
        from_f<T>(a);
  }
}

template <typename T, typename KV, int BEAMS>
cudaError_t launch_cross_beams(const CrossParams<T, KV>& p, cudaStream_t st) {
  static hopper::SmemGrant granted;
  const size_t smem = (static_cast<size_t>(BEAMS) * p.L +
                       static_cast<size_t>(kCrossWarps) * BEAMS * p.Dh) *
                      sizeof(float);
  const cudaError_t err = granted.ensure(cross_attn_kernel<T, KV, BEAMS>, smem);
  if (err != cudaSuccess) return err;
  return launch(cross_attn_kernel<T, KV, BEAMS>, dim3(p.H, p.B),
                kCrossThreads, smem, 1, st, p);
}

template <typename T, typename KV>
cudaError_t launch_cross(const CrossParams<T, KV>& p, int beams,
                         cudaStream_t st) {
  switch (beams) {
    case 1: return launch_cross_beams<T, KV, 1>(p, st);
    case 2: return launch_cross_beams<T, KV, 2>(p, st);
    case 3: return launch_cross_beams<T, KV, 3>(p, st);
    case 4: return launch_cross_beams<T, KV, 4>(p, st);
    case 5: return launch_cross_beams<T, KV, 5>(p, st);
    case 6: return launch_cross_beams<T, KV, 6>(p, st);
    case 7: return launch_cross_beams<T, KV, 7>(p, st);
    case 8: return launch_cross_beams<T, KV, 8>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

// layer i's cross-attention, with K/V in the compute dtype or int8
template <typename T, typename KV>
cudaError_t run_cross(const T* q, const void* cross_k, const void* cross_v,
                      const float* cross_ks, const float* cross_vs, T* out,
                      int i, int B, int H, int L, int D, int beams,
                      float scale, cudaStream_t st) {
  const size_t ckv = static_cast<size_t>(B) * L * D;   // one layer
  CrossParams<T, KV> cp{};
  cp.q = q;
  cp.k = static_cast<const KV*>(cross_k) + i * ckv;
  cp.v = static_cast<const KV*>(cross_v) + i * ckv;
  if (cross_ks != nullptr) {
    cp.ks = cross_ks + static_cast<size_t>(i) * B * H;
    cp.vs = cross_vs + static_cast<size_t>(i) * B * H;
  }
  cp.out = out;
  cp.B = B;
  cp.H = H;
  cp.L = L;
  cp.D = D;
  cp.Dh = D / H;
  cp.scale = scale;
  return launch_cross<T, KV>(cp, beams, st);
}

// out = LN(o + res), one warp per row
template <typename T>
__global__ void __launch_bounds__(256)
ln_kernel(const T* o, const T* res, const float* s, const float* b, T* out,
          int N, int D, float eps) {
  grid_dep_wait();
  grid_dep_launch();
  const int n = blockIdx.x * 8 + threadIdx.x / 32;
  if (n >= N) return;
  const size_t r = static_cast<size_t>(n) * D;
  ln_row<T>(o + r, res + r, s, b, D, eps, threadIdx.x % 32, out + r);
}

// ---------------------------------------------------------------------------
// the step
// ---------------------------------------------------------------------------

struct StepArgs {
  const void* hidden0;
  const void* w_all;
  const float* b_all;
  const void* self_k;
  const void* self_v;
  void* out_k;
  void* out_v;
  const int* flat_beam;
  const int* key_mask;
  const void* cross_k;
  const void* cross_v;
  const float* cross_ks;   // int8 cross K/V: (NLc, B, H) scales, else null
  const float* cross_vs;
  void* hidden_out;
  void* k_new;
  void* v_new;
  void* work;
  int N, B, D, H, F, NL, NLc, T, L, index;
  float eps, scale;
};

#define RETURN_IF_ERR(expr)                 \
  do {                                      \
    const cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_;       \
  } while (0)

template <typename T>
cudaError_t run_step(const StepArgs& a, cudaStream_t st) {
  static hopper::SmemGrant self_granted;
  const int N = a.N, D = a.D, F = a.F, Dh = D / a.H;
  const size_t nd = static_cast<size_t>(N) * D;
  const size_t slab = static_cast<size_t>(a.T) * nd;       // one layer cache
  const size_t dd = static_cast<size_t>(D) * D;
  const size_t fd = static_cast<size_t>(F) * D;
  g_launches = 0;

  T* qkv = static_cast<T*>(a.work);        // (N, 3D); cross-q reuses it
  T* att = qkv + 3 * nd;                   // (N, D)
  T* o = att + nd;                         // (N, D)
  T* xbuf[2] = {o + nd, o + 2 * nd};       // residual stream, ping-pong
  T* act = o + 3 * nd;                     // (N, max(D, F))
  int xi = 0;
  auto next_x = [&]() {
    T* r = xbuf[xi];
    xi ^= 1;
    return r;
  };

  const size_t self_smem = (2 * static_cast<size_t>(a.T) * (Dh + 1) + Dh +
                            a.T) * sizeof(float);
  const int beams = N / a.B;
  RETURN_IF_ERR(self_granted.ensure(self_attn_kernel<T>, self_smem));

  // bf16: the weights' tensor maps, and where each W lies in them
  WeightMaps wmaps;
  const WeightMaps* maps = nullptr;
  if (std::is_same<T, __nv_bfloat16>::value) {
    if (!weight_maps(&wmaps, a.w_all, D, F, a.NLc)) {
      return cudaErrorInvalidValue;
    }
    maps = &wmaps;
  }
  const T* const w0 = static_cast<const T*>(a.w_all);
  const size_t wl = 8 * dd + 2 * fd;       // one cross layer's weights
  auto params = [&](const T* w, const float* bias, T* out, int K, int M,
                    int act_kind) {
    DenseParams<T> p{};
    p.w = w;
    p.bias = bias;
    p.out = out;
    p.eps = a.eps;
    p.N = N;
    p.K = K;
    p.M = M;
    p.act = act_kind;
    if (maps != nullptr) {
      const size_t off = static_cast<size_t>(w - w0);
      const int li = static_cast<int>(off / wl);   // a.NLc: the output layer
      const int o = li < a.NLc ? 0 : 1;
      const size_t in = off - li * wl;
      const size_t w2 = (o == 0 ? 8 : 4) * dd + fd;   // W2 in the layer
      p.map = in < w2 ? &maps->dmap[o] : &maps->fmap[o];
      p.row = static_cast<int>(in < w2 ? in / D : (in - w2) / F);
      p.layer = o == 0 ? li : 0;
    }
    return p;
  };
  auto dense = [&](const T* x, const T* w, const float* bias, T* out, int K,
                   int M, int act_kind) {
    DenseParams<T> p = params(w, bias, out, K, M, act_kind);
    p.x = x;
    return launch_dense<T>(p, st);
  };
  // x = LN(o + res) (written to x), and out = act(x @ W^T + b), by one
  // launch
  auto dense_ln = [&](const T* ln_o, const T* ln_res, const float* ln_s,
                      T* x, const T* w, const float* bias, T* out, int M,
                      int act_kind) {
    DenseParams<T> p = params(w, bias, out, D, M, act_kind);
    p.ln_o = ln_o;
    p.ln_res = ln_res;
    p.ln_s = ln_s;
    p.res_out = x;
    return launch_dense<T>(p, st);
  };

  const T* w = static_cast<const T*>(a.w_all);
  const float* bb = a.b_all;
  const T* res = static_cast<const T*>(a.hidden0);  // residual into layer i
  const float* prev_ln = nullptr;                     // LN closing layer i-1
  for (int i = 0; i < a.NL; ++i) {
    const bool cross = i < a.NLc;
    // self-attention block
    if (i == 0) {
      RETURN_IF_ERR(dense(res, w, bb, qkv, D, 3 * D, kActNone));
    } else {
      T* x = next_x();
      RETURN_IF_ERR(dense_ln(o, res, prev_ln, x, w, bb, qkv, 3 * D,
                             kActNone));
      res = x;
    }
    SelfParams<T> sp{};
    sp.qkv = qkv;
    sp.ck_in = static_cast<const T*>(a.self_k) + i * slab;
    sp.cv_in = static_cast<const T*>(a.self_v) + i * slab;
    sp.ck_out = static_cast<T*>(a.out_k) + i * slab;
    sp.cv_out = static_cast<T*>(a.out_v) + i * slab;
    sp.flat_beam = a.flat_beam;
    sp.key_mask = a.key_mask;
    sp.k_new = static_cast<T*>(a.k_new) + i * nd;
    sp.v_new = static_cast<T*>(a.v_new) + i * nd;
    sp.att = att;
    sp.N = N;
    sp.D = D;
    sp.Dh = Dh;
    sp.Tn = a.T;
    sp.index = a.index;
    sp.scale = a.scale;
    RETURN_IF_ERR(launch(self_attn_kernel<T>, dim3(a.H, N), kSelfThreads,
                         self_smem, 1, st, sp));
    RETURN_IF_ERR(dense(att, w + 3 * dd, bb + 3 * D, o, D, D, kActNone));
    const float* ln1 = bb + 4 * D;
    if (cross) {
      // cross-attention block
      T* x1 = next_x();
      RETURN_IF_ERR(dense_ln(o, res, ln1, x1, w + 4 * dd, bb + 6 * D, qkv, D,
                             kActNone));
      const cudaError_t cross_err =
          a.cross_ks != nullptr
              ? run_cross<T, int8_t>(qkv, a.cross_k, a.cross_v, a.cross_ks,
                                     a.cross_vs, att, i, a.B, a.H, a.L, D,
                                     beams, a.scale, st)
              : run_cross<T, T>(qkv, a.cross_k, a.cross_v, nullptr, nullptr,
                                att, i, a.B, a.H, a.L, D, beams, a.scale, st);
      RETURN_IF_ERR(cross_err);
      RETURN_IF_ERR(dense(att, w + 5 * dd, bb + 7 * D, o, D, D, kActNone));
      // adaptor
      T* x2 = next_x();
      RETURN_IF_ERR(dense_ln(o, x1, bb + 8 * D, x2, w + 6 * dd, bb + 10 * D,
                             act, D, kActSqRelu));
      RETURN_IF_ERR(dense(act, w + 7 * dd, bb + 11 * D, o, D, D, kActNone));
      // MLP
      T* x3 = next_x();
      RETURN_IF_ERR(dense_ln(o, x2, bb + 12 * D, x3, w + 8 * dd, bb + 14 * D,
                             act, F, kActGelu));
      RETURN_IF_ERR(dense(act, w + 8 * dd + fd, bb + 14 * D + F, o, F, D,
                          kActNone));
      res = x3;
      prev_ln = bb + 15 * D + F;
      w += 8 * dd + 2 * fd;
      bb += 17 * D + F;
    } else {
      // output layer: MLP only
      T* x1 = next_x();
      RETURN_IF_ERR(dense_ln(o, res, ln1, x1, w + 4 * dd, bb + 6 * D, act, F,
                             kActGelu));
      RETURN_IF_ERR(dense(act, w + 4 * dd + fd, bb + 6 * D + F, o, F, D,
                          kActNone));
      res = x1;
      prev_ln = bb + 7 * D + F;
      w += 4 * dd + 2 * fd;
      bb += 9 * D + F;
    }
  }
  return launch(ln_kernel<T>, dim3((N + 7) / 8), 256, 0, 1, st, o, res,
                prev_ln, prev_ln + D, static_cast<T*>(a.hidden_out), N, D,
                a.eps);
}

}  // namespace

// Returns a cudaError_t (0 on success). dtype: 0 fp32, 1 bf16. Without
// flat_beam, out_k/out_v must equal self_k/self_v (the column is written in
// place); with it, they must be other buffers. cross_ks / cross_vs null:
// cross K/V in the compute dtype; given: int8 cross K/V with those fp32
// (NLc, B, H) scales. work holds N * (7 D + max(D, F)) elements of the
// compute dtype.
extern "C" int prismer_fused_decode_step(
    const void* hidden0, const void* w_all, const float* b_all,
    const void* self_k, const void* self_v, void* out_k, void* out_v,
    const int* flat_beam, const int* key_mask, const void* cross_k,
    const void* cross_v, const float* cross_ks, const float* cross_vs,
    void* hidden_out, void* k_new, void* v_new, void* work, int N, int B,
    int D, int H, int F, int NL, int NLc, int T, int L, int index, int dtype,
    float eps, float scale, void* stream) {
  const bool quant = cross_ks != nullptr;
  if (quant != (cross_vs != nullptr)) return cudaErrorInvalidValue;
  // lanes per K/V row of the cross kernel: 16 bytes each (8 in int8)
  const int lpr = H > 0 ? D / H / (dtype == 0 && !quant ? 4 : 8) : 0;
  if (N <= 0 || B <= 0 || N % B != 0 || N / B > kMaxBeams || H <= 0 ||
      D % H != 0 || D % 8 != 0 || D > kMaxLnDim || F % 8 != 0 ||
      (D / H) % 8 != 0 || lpr <= 0 || lpr > 32 || (lpr & (lpr - 1)) != 0 ||
      NLc < 0 || NL != NLc + 1 || T <= 0 || L <= 0 || index < 0 ||
      index >= T || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  const bool in_place = out_k == self_k && out_v == self_v;
  const bool aliased = out_k == self_k || out_v == self_v;
  if (flat_beam == nullptr ? !in_place : aliased) {
    return cudaErrorInvalidValue;
  }
  StepArgs a{hidden0, w_all, b_all, self_k, self_v, out_k, out_v,
             flat_beam, key_mask, cross_k, cross_v, cross_ks, cross_vs,
             hidden_out, k_new, v_new, work, N, B, D, H, F, NL, NLc, T, L,
             index, eps, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? run_step<float>(a, st) : run_step<__nv_bfloat16>(a, st);
}

// The kernels the last step launched.
extern "C" int prismer_fused_decode_launches() { return g_launches; }
