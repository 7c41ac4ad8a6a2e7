// LayerNorm fused into its consumers, for Hopper (sm_90a): the encoder
// block's q/k/v projections, its MLP's first projection + quick_gelu, and
// its whole norm-early Adaptor.
//
// Replaces prismer_tpu/ops/ln_proj.py
//   * ln_proj (_ln_proj_kernel, pallas_call at :127):
//       out_i = act(LN(x) @ W_i + b_i) for one to three weights;
//   * adaptor_fused (_adaptor_kernel, pallas_call at :242):
//       out = x + up(sq_relu(down(LN(x)))).
// Weights are in the port's nn.Linear layout (F, D). The rounding points
// are the Pallas bodies' (ln_proj.py:84-105, 210-223): the fp32 LayerNorm
// (layer_norm.cuh) is rounded to the compute dtype T before the product;
// each product sums in fp32 and is rounded to T, then T's bias is added in
// T; ln_proj's activation runs in fp32 on that rounded value and is rounded
// once; the adaptor's relu and square are in T, its second product is
// taken the same way, and the residual add is in T.
//
// What bounds them on the H100: operations. At the encoder's R = 8 x 964
// rows and D = 768 (bf16): q/k/v 27.3 GFLOP (27.6 us at 989 TFLOP/s)
// against 50.9 MB of traffic (15.2 us at 3.35 TB/s); c_fc + quick_gelu
// (F = 3072) 36.4 GFLOP (36.8 us) against 64 MB; the adaptor 18.2 GFLOP
// (18.4 us) against 26 MB.
//
// bf16 design (the TPU kernel held whole weights in VMEM beside a 512-row
// block; here the tensor cores are fed by TMA and the normalised rows never
// reach device memory):
//   * row_stats_kernel: one warp a row computes its mean and rstd
//     (LnRow, the two-pass fp32 definition) into an (R, 2) fp32 scratch,
//     once for all of the row's outputs; the products then apply the
//     normalisation to their A operand, and x is still in the L2 when
//     they read it.
//   * ln_proj_kernel: output tiles of 128 rows x 256 columns, a tile never
//     spanning two outputs; about one block an SM walks the tiles (q/k/v
//     or c_fc of every row tile, column tiles fastest). A producer
//     warpgroup (one thread) keeps TMA loads of 64-column K chunks in a
//     3-stage mbarrier ring: x (128 rows) and W_i (256 rows, K-major),
//     128-byte swizzle, zeros past R, F and D. Two consumer warpgroups own
//     64 rows each: each normalises its rows of the stage's x box in place
//     (ldmatrix, (x - mean) * rstd * scale + bias in fp32, stmatrix of the
//     bf16 pairs), then issues m64n256k16 wgmma with both operands in
//     shared memory; a chunk's pass overlaps the chunk before's products.
//     The epilogue rounds the accumulator pairs to bf16, adds the tile's
//     bias in bf16 (prefetched into shared memory by cp.async when the
//     tile starts), applies quick_gelu in fp32, stages the tile in shared
//     memory (128-byte swizzle) and writes it with TMA stores, which clip
//     R and F; a tile's stores drain while the next tile's loads run.
//     setmaxnreg gives the producer 24 registers and the consumers 240.
//   * adaptor_kernel: a block owns 64 rows (one consumer warpgroup, one
//     producer warp). Product 1 runs over 128-column tiles of down with
//     the LayerNorm applied to its A fragments in registers (ldmatrix,
//     fp32, m64n128k16 wgmma with A from registers); its epilogue writes
//     h = sq_relu(round(acc) + b_down) in bf16 into shared memory as a
//     K-major swizzled tile (64 x D bf16: 96 KB at D 768, 160 KB at 1280).
//     Product 2 reads h as the shared A operand against up's slices; the
//     residual x of each output tile arrives by TMA in the staging box
//     that the result leaves from by TMA store.
//   * both launch with programmatic stream serialization: the statistics
//     wait for the kernel before them, the main kernel for the statistics.
//   Tensor maps are encoded once per pointer and shape (hopper.cuh
//   cached_bf16_map). Every sum runs over k in one fixed order and no
//   float atomics are used, so two launches give the same bits.
// What holds them (tools/probe_ln_proj.py, PERF.md): ln_proj's chunk is
// bound by shared-memory traffic (the pass over x, both warpgroups' wgmma
// operands and the TMA writes: ~160 KB a chunk) and its ring's round trip
// with three stages; the adaptor's by its ring (two to four stages beside
// h) and the weight bytes each 64-row block streams.
// An output whose width is not a multiple of 8 cannot be a TMA target (its
// rows are not 16-byte aligned): its tiles leave the staging box by plain
// stores instead.
//
// fp32 (the card-side parity checks) keeps the FMA kernels: a block
// normalises 32 rows (ln_proj; 16 in the adaptor) into shared memory, and
// weights stream through three cp.async stages of 128 rows x 32 columns;
// warp w owns rows w, w + 8, ..., lane l columns l + 32 j. Rows past R are
// neither read nor written.

#include "hopper.cuh"
#include "layer_norm.cuh"

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;
using hopper::grid_dep_wait;

constexpr int kMaxOut = 3;
enum Act { kActNone = 0, kActQuickGelu = 1 };

__device__ __forceinline__ float quick_gelu(float x) {
  return x * (1.f / (1.f + expf(-1.702f * x)));
}

// quick_gelu of a bf16 pair in fp32 (fast exp and division: within 2 fp32
// ulp, far below the bf16 rounding that follows), rounded once to bf16
__device__ __forceinline__ __nv_bfloat162 quick_gelu2(__nv_bfloat162 v) {
  const float2 f = __bfloat1622float2(v);
  return __floats2bfloat162_rn(__fdividef(f.x, 1.f + __expf(-1.702f * f.x)),
                               __fdividef(f.y, 1.f + __expf(-1.702f * f.y)));
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// fp32: FMA kernels
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBn = 128;             // output columns per tile
constexpr int kGroup = 6;            // ln_proj column tiles per block
constexpr int kSub = 32;             // k width of a staged weight slice
constexpr int kStages = 3;
constexpr int kWld = kSub + 4;       // row stride of a slice (144 bytes)
constexpr int kStageElems = kBn * kWld;
constexpr int kF32ProjRows = 32;
constexpr int kF32AdaptorRows = 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [col0, col0 + kBn) x columns [k0, k0 + kSub) of W (F, D) into the
// slice ws, rows at or past F as zeros (nothing is read for them)
__device__ __forceinline__ void load_w_slice(const float* __restrict__ W,
                                             int F, int D, int col0, int k0,
                                             float* ws) {
  constexpr int kSegs = kSub / 4;
  for (int c = threadIdx.x; c < kBn * kSegs; c += kThreads) {
    const int r = c / kSegs;
    const int s = c - r * kSegs;
    const bool valid = col0 + r < F;
    const float* src =
        valid ? W + static_cast<size_t>(col0 + r) * D + k0 + s * 4 : W;
    cp_async16(ws + r * kWld + s * 4, src, valid);
  }
}

// LN of rows [row0, row0 + rows) of x (R, D) into xs (row stride D + 4),
// one warp per row; rows at or past R are zeros and x is not read for them
__device__ void ln_tile(const float* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, int R, int D,
                        float eps, int row0, int rows, float* xs) {
  const int lane = threadIdx.x & 31;
  const int ldx = D + 4;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    float* dst = xs + r * ldx;
    if (row0 + r < R) {
      prismer::ln_row<float>(x + static_cast<size_t>(row0 + r) * D, scale,
                             bias, D, eps, lane, [&](int k, const float* y) {
                               prismer::store_vec<float>(dst + k, y);
                             });
    } else {
      const float zero[4] = {};
      for (int k = lane * 4; k < D; k += 32 * 4) {
        prismer::store_vec<float>(dst + k, zero);
      }
    }
  }
}

// One kBn-column output tile of BM rows: acc = A[0:BM, 0:D] .
// W[col0 : col0 + kBn, 0:D]^T with A in shared memory (row stride D + 4)
// and W (F, D) streamed through kStages slices of ws. `product` starts with
// a barrier, so A and ws may have been written just before it. `for_each`
// calls f(r, c, sum) for row r < BM and column c < kBn of the tile.
template <int BM>
struct FmaTile {
  static constexpr int RM = BM / kWarps;  // rows per warp
  static constexpr int CN = kBn / 32;     // columns per lane
  float acc[RM][CN];

  __device__ void product(const float* A, const float* __restrict__ W, int F,
                          int D, int col0, float* ws) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int lda = D + 4;
    const int nk = D / kSub;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load_w_slice(W, F, D, col0, s * kSub, ws + s * kStageElems);
      cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int nxt = i + kStages - 1;
      if (nxt < nk) {
        load_w_slice(W, F, D, col0, nxt * kSub,
                     ws + (nxt % kStages) * kStageElems);
      }
      cp_async_commit();
      const float* wsl = ws + (i % kStages) * kStageElems;
      const int k0 = i * kSub;
#pragma unroll
      for (int k = 0; k < kSub; k += 4) {
        float4 b[CN];
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          b[j] = *reinterpret_cast<const float4*>(
              wsl + (lane + 32 * j) * kWld + k);
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(
              A + (warp + kWarps * r) * lda + k0 + k);
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            acc[r][j] = fmaf(a.x, b[j].x, acc[r][j]);
            acc[r][j] = fmaf(a.y, b[j].y, acc[r][j]);
            acc[r][j] = fmaf(a.z, b[j].z, acc[r][j]);
            acc[r][j] = fmaf(a.w, b[j].w, acc[r][j]);
          }
        }
      }
    }
  }

  template <typename Fn>
  __device__ void for_each(Fn f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) f(warp + kWarps * i, lane + 32 * j, acc[i][j]);
  }
};

// the outputs of one fp32 ln_proj call; output i owns the grid's column
// groups [first[i], first[i] + ceil(f[i] / (kGroup * kBn)))
struct Proj {
  const float* w[kMaxOut];
  const float* b[kMaxOut];
  float* o[kMaxOut];
  int f[kMaxOut];
  int first[kMaxOut];
  int n;
};

__global__ void __launch_bounds__(kThreads)
ln_proj_f32_kernel(const float* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, Proj p, int R, int D,
                   float eps, int act) {
  constexpr int BM = kF32ProjRows;
  extern __shared__ uint4 smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ws = xs + BM * (D + 4);
  // this block's output, selected with unrolled compares so that `p` stays
  // in the parameter bank
  int sel = 0;
#pragma unroll
  for (int i = 1; i < kMaxOut; ++i) {
    if (i < p.n && static_cast<int>(blockIdx.x) >= p.first[i]) sel = i;
  }
  const float* W = nullptr;
  const float* b = nullptr;
  float* o = nullptr;
  int F = 0, first = 0;
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    if (i == sel) {
      W = p.w[i];
      b = p.b[i];
      o = p.o[i];
      F = p.f[i];
      first = p.first[i];
    }
  }
  const int row0 = blockIdx.y * BM;
  const int group = static_cast<int>(blockIdx.x) - first;
  const int col_end = min(F, (group + 1) * kGroup * kBn);

  ln_tile(x, scale, bias, R, D, eps, row0, BM, xs);
  FmaTile<BM> tile;
  for (int col0 = group * kGroup * kBn; col0 < col_end; col0 += kBn) {
    tile.product(xs, W, F, D, col0, ws);
    tile.for_each([&](int r, int c, float v) {
      const int row = row0 + r, col = col0 + c;
      if (row < R && col < F) {
        const float y = v + b[col];
        o[static_cast<size_t>(row) * F + col] =
            act == kActQuickGelu ? quick_gelu(y) : y;
      }
    });
  }
}

__global__ void __launch_bounds__(kThreads)
adaptor_f32_kernel(const float* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ wd, const float* __restrict__ bd,
                   const float* __restrict__ wu, const float* __restrict__ bu,
                   float* __restrict__ out, int R, int D, float eps) {
  constexpr int BM = kF32AdaptorRows;
  extern __shared__ uint4 smem[];
  const int ldx = D + 4;
  float* ys = reinterpret_cast<float*>(smem);  // LN(x), then read-only
  float* hs = ys + BM * ldx;                   // sq_relu(down(LN(x)))
  float* ws = hs + BM * ldx;
  const int row0 = blockIdx.x * BM;

  ln_tile(x, scale, bias, R, D, eps, row0, BM, ys);
  FmaTile<BM> tile;
  for (int col0 = 0; col0 < D; col0 += kBn) {
    tile.product(ys, wd, D, D, col0, ws);
    tile.for_each([&](int r, int c, float v) {
      const int col = col0 + c;
      if (col < D) {
        const float h = fmaxf(v + bd[col], 0.f);
        hs[r * ldx + col] = h * h;
      }
    });
  }
  for (int col0 = 0; col0 < D; col0 += kBn) {
    tile.product(hs, wu, D, D, col0, ws);
    tile.for_each([&](int r, int c, float v) {
      const int row = row0 + r, col = col0 + c;
      if (row < R && col < D) {
        const size_t i = static_cast<size_t>(row) * D + col;
        out[i] = x[i] + (v + bu[col]);
      }
    });
  }
}

// ---------------------------------------------------------------------------
// bf16: row statistics, then TMA-fed wgmma with the LayerNorm on A
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;                 // K columns of a TMA box
constexpr int kBox = 64 * 128;             // bytes of a 64-row box
constexpr int kWg = 128;                   // threads of a warpgroup
constexpr int kStatsWarps = 8;
constexpr int kSmemLimit = static_cast<int>(hopper::kMaxSmem);
// ln_proj: 128 x 256 tiles, two consumer warpgroups and a producer one
constexpr int kProjRows = 128;
constexpr int kProjBn = 256;
constexpr int kProjBoxes = kProjBn / 64;   // output boxes of a warpgroup
constexpr int kProjStages = 3;
constexpr int kProjStage = (kProjRows + kProjBn) * 128;
constexpr int kProjThreads = 3 * kWg;
// adaptor: 64 rows a block, 128-column tiles, one consumer warpgroup and a
// producer warp
constexpr int kAdRows = 64;
constexpr int kAdBn = 128;             // the register-A wgmma's N
constexpr int kAdStage = kBox + kAdBn * 128;
constexpr int kAdThreads = kWg + 32;

// The launch plans of the bf16 kernels: here and in ops/ln_proj.py
// (ln_proj_plan, adaptor_plan) computed the same way.
struct ProjPlan {
  int row_tiles, col_tiles, tiles, blocks, chunks, smem;
};

inline ProjPlan proj_plan(int R, int D, const int* f, int n, int sms) {
  ProjPlan p;
  p.row_tiles = cdiv(R, kProjRows);
  p.col_tiles = 0;
  for (int i = 0; i < n; ++i) p.col_tiles += cdiv(f[i], kProjBn);
  p.tiles = p.row_tiles * p.col_tiles;
  p.blocks = std::min(p.tiles, sms);
  p.chunks = D / kChunk;
  // alignment slack, ring, two warpgroups' output boxes, the affine as
  // float4 {scale[2i], scale[2i + 1], bias[2i], bias[2i + 1]}, the two
  // warpgroups' tile biases, barriers
  p.smem = 1024 + kProjStages * kProjStage + 2 * kProjBoxes * kBox + D * 8 +
           2 * kProjBn * 2 + 2 * kProjStages * 8;
  return p;
}

struct AdPlan {
  int blocks, col_tiles, chunks, stages, smem;
};

inline AdPlan ad_plan(int R, int D) {
  AdPlan p;
  p.blocks = cdiv(R, kAdRows);
  p.col_tiles = cdiv(D, kAdBn);
  p.chunks = D / kChunk;
  // alignment slack, h, two staging boxes (the affine before product 2),
  // two tiles' biases; then as many stages as fit, at most 4, and their
  // 2 stages + 1 barriers
  const int fixed = 1024 + D * 128 + 2 * kBox + 2 * kAdBn * 2;
  p.stages = std::min(4, (kSmemLimit - fixed - 9 * 8) / kAdStage);
  p.smem = fixed + p.stages * kAdStage + (2 * p.stages + 1) * 8;
  return p;
}

// mean and rstd of every row of x (R, D), one warp a row
__global__ void __launch_bounds__(kStatsWarps * 32)
row_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats,
                 int R, int D, float eps) {
  grid_dep_wait();
  hopper::grid_dep_launch();
  const int row = blockIdx.x * kStatsWarps + threadIdx.x / 32;
  if (row >= R) return;
  const prismer::LnRow<bf16> r(x + static_cast<size_t>(row) * D, D, eps,
                               threadIdx.x % 32);
  if (threadIdx.x % 32 == 0) stats[row] = make_float2(r.mean, r.rstd);
}

// two normalised columns of one row from a bf16 pair v (low half first):
// (x - mean) * rstd * scale + bias in fp32, as layer_norm.cuh computes it,
// rounded to a bf16 pair
__device__ __forceinline__ uint32_t ln_pair(uint32_t v, float2 st, float s0,
                                            float s1, float b0, float b1) {
  const float lo = (__uint_as_float(v << 16) - st.x) * st.y * s0 + b0;
  const float hi = (__uint_as_float(v & 0xffff0000u) - st.x) * st.y * s1 + b1;
  return hopper::pack_bf16(lo, hi);
}

// The A fragments (four k steps of 16) of K chunk c for the calling warp's
// 16 rows of a warpgroup's 64-row x box (128-byte swizzle), normalised:
// sa / sb the (mean, rstd) of rows gid and gid + 8, af the affine pairs.
// The four ldmatrix go out together, then the arithmetic.
__device__ __forceinline__ void ln_fragments(uint32_t box, int c, int wi,
                                             int lane, float2 sa, float2 sb,
                                             const float4* af,
                                             uint32_t (&a)[4][4]) {
  constexpr int K = kChunk / 16;
  const int r = 16 * wi + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int q = lane & 3;
  float4 p[K], p8[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    hopper::ldsm_x4(box + r * 128 + ((((2 * k + (lane >> 4)) ^ r) & 7) << 4),
                    a[k]);
    p[k] = af[c * 32 + 8 * k + q];
    p8[k] = af[c * 32 + 8 * k + 4 + q];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a[k][0] = ln_pair(a[k][0], sa, p[k].x, p[k].y, p[k].z, p[k].w);
    a[k][1] = ln_pair(a[k][1], sb, p[k].x, p[k].y, p[k].z, p[k].w);
    a[k][2] = ln_pair(a[k][2], sa, p8[k].x, p8[k].y, p8[k].z, p8[k].w);
    a[k][3] = ln_pair(a[k][3], sb, p8[k].x, p8[k].y, p8[k].z, p8[k].w);
  }
}

// K chunk c (64 columns) of the calling warp's 16 rows of a warpgroup's
// 64-row x box (128-byte swizzle) normalised in place: each 8 x 8 block is
// read with ldmatrix, normalised in fp32 and written back with stmatrix to
// where it came from. sa / sb: the (mean, rstd) of rows gid and gid + 8;
// af: the affine pairs. The warp touches only its own rows.
__device__ __forceinline__ void ln_in_place(uint32_t box, int c, int wi,
                                            int lane, float2 sa, float2 sb,
                                            const float4* af) {
  const int r = 16 * wi + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int q = lane & 3;
#pragma unroll
  for (int k = 0; k < kChunk / 16; ++k) {
    const uint32_t addr =
        box + r * 128 + ((((2 * k + (lane >> 4)) ^ r) & 7) << 4);
    uint32_t x[4];
    hopper::ldsm_x4(addr, x);
    const float4 p = af[c * 32 + 8 * k + q];
    const float4 p8 = af[c * 32 + 8 * k + 4 + q];
    x[0] = ln_pair(x[0], sa, p.x, p.y, p.z, p.w);
    x[1] = ln_pair(x[1], sb, p.x, p.y, p.z, p.w);
    x[2] = ln_pair(x[2], sa, p8.x, p8.y, p8.z, p8.w);
    x[3] = ln_pair(x[3], sb, p8.x, p8.y, p8.z, p8.w);
    hopper::stsm_x4(addr, x);
  }
}

// A tile's bias columns [col0, col0 + cols) of a width-F output into
// shared memory (zeros past F) by cp.async, 16 bytes a thread, issued when
// the tile starts so that its latency hides under the mainloop; the
// epilogue waits for it (cp_async_wait<0>, then a barrier). Loaded inside
// the epilogue, each load would wait for the staging stores before it,
// which the compiler cannot move it past.
__device__ __forceinline__ void prefetch_bias(const bf16* __restrict__ b,
                                              int col0, int F, int cols,
                                              bf16* dst, int thread) {
  if (thread < cols / 8) {
    const int col = col0 + 8 * thread;
    const int bytes = min(16, max(0, 2 * (F - col)));
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(
        dst + 8 * thread));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(bytes > 0 ? b + col : b), "r"(bytes)
                 : "memory");
  }
  cp_async_commit();
}

// round(acc) of two accumulator columns, + their bias in bf16: the
// product rounded once to bf16, then one bf16 add (correctly rounded, as
// rounding the fp32 sum of two bf16 values is)
__device__ __forceinline__ __nv_bfloat162 biased(float a0, float a1,
                                                 __nv_bfloat162 b) {
  return __hadd2(__floats2bfloat162_rn(a0, a1), b);
}

// the affine (scale, bias) into shared memory as float4 pairs
__device__ __forceinline__ void stage_affine(const float* __restrict__ scale,
                                             const float* __restrict__ bias,
                                             int D, float4* af) {
  for (int i = threadIdx.x; i < D / 2; i += blockDim.x) {
    af[i] = make_float4(scale[2 * i], scale[2 * i + 1], bias[2 * i],
                        bias[2 * i + 1]);
  }
}

struct ProjMaps {
  CUtensorMap x;              // (R, D), 128-row boxes
  CUtensorMap w[kMaxOut];     // (F_i, D), 256-row boxes
  CUtensorMap o[kMaxOut];     // (R, F_i), 64-row boxes (F_i % 8 == 0)
};

struct ProjArgs {
  const bf16* bias[kMaxOut];
  bf16* out[kMaxOut];
  const float2* stats;
  int f[kMaxOut];
  int first[kMaxOut];         // the first column tile of each output
  int n, R, D, act;
  int direct;                 // bit i: output i leaves by plain stores
  int col_tiles, tiles, chunks;
};

struct ProjTile {
  int sel, row0, col0, F;
};

// tile t: row tile t / col_tiles, column tile t % col_tiles of the outputs
// side by side (selected with unrolled compares, so `a` stays in the
// parameter bank)
__device__ __forceinline__ ProjTile proj_tile(const ProjArgs& a, int t) {
  const int g = t % a.col_tiles;
  ProjTile tl;
  tl.sel = 0;
#pragma unroll
  for (int i = 1; i < kMaxOut; ++i) {
    if (i < a.n && g >= a.first[i]) tl.sel = i;
  }
  int first = 0;
  tl.F = a.f[0];
#pragma unroll
  for (int i = 1; i < kMaxOut; ++i) {
    if (i == tl.sel) {
      first = a.first[i];
      tl.F = a.f[i];
    }
  }
  tl.row0 = (t / a.col_tiles) * kProjRows;
  tl.col0 = (g - first) * kProjBn;
  return tl;
}

template <typename T>
__device__ __forceinline__ T pick(int sel, T v0, T v1, T v2) {
  return sel == 0 ? v0 : (sel == 1 ? v1 : v2);
}

__global__ void __launch_bounds__(kProjThreads, 1)
ln_proj_kernel(const __grid_constant__ ProjMaps maps, const ProjArgs a,
               const float* __restrict__ scale,
               const float* __restrict__ bias) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* ring = hopper::align_1024(smem_raw);
  uint8_t* staging = ring + kProjStages * kProjStage;
  float4* af = reinterpret_cast<float4*>(staging + 2 * kProjBoxes * kBox);
  bf16* bias_s = reinterpret_cast<bf16*>(af + a.D / 2);   // [2][kProjBn]
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + 2 * kProjBn);
  uint64_t* empty = full + kProjStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kProjStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 8);   // the consumers' eight warps
    }
    hopper::mbar_init_fence();
  }
  grid_dep_wait();
  stage_affine(scale, bias, a.D, af);
  __syncthreads();

  if (tid >= 2 * kWg) {   // the producer warpgroup: one thread feeds the ring
    hopper::setmaxnreg_dec<24>();
    if (tid != 2 * kWg) return;
    int it = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const ProjTile tl = proj_tile(a, t);
      const CUtensorMap* wmap =
          pick<const CUtensorMap*>(tl.sel, &maps.w[0], &maps.w[1], &maps.w[2]);
      for (int c = 0; c < a.chunks; ++c, ++it) {
        const int s = it % kProjStages;
        if (it >= kProjStages) {
          hopper::mbar_wait(empty + s, ((it / kProjStages) - 1) & 1);
        }
        uint8_t* st = ring + s * kProjStage;
        hopper::mbar_arrive_expect_tx(full + s, kProjStage);
        hopper::tma_load_4d(st, &maps.x, full + s, c * kChunk, tl.row0, 0, 0);
        hopper::tma_load_4d(st + kProjRows * 128, wmap, full + s, c * kChunk,
                            tl.col0, 0, 0);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<240>();

  // consumer warpgroup w: rows 64 w .. 64 w + 63 of each tile
  const int w = tid / kWg;
  const int wi = (tid % kWg) / 32;
  const int lane = tid % 32;
  const int gid = lane / 4, q = lane % 4;
  const uint32_t ring_a = hopper::smem_addr(ring);
  uint8_t* stg = staging + w * kProjBoxes * kBox;
  float acc[kProjBn / 2];
  int it = 0;
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + stage);
  };
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const ProjTile tl = proj_tile(a, t);
    const int ra = tl.row0 + 64 * w + 16 * wi + gid;
    const float2 sa = ra < a.R ? a.stats[ra] : make_float2(0.f, 0.f);
    const float2 sb = ra + 8 < a.R ? a.stats[ra + 8] : make_float2(0.f, 0.f);
    prefetch_bias(pick(tl.sel, a.bias[0], a.bias[1], a.bias[2]), tl.col0,
                  tl.F, kProjBn, bias_s + w * kProjBn, tid % kWg);
    for (int c = 0; c < a.chunks; ++c, ++it) {
      // K chunk c: the warpgroup's x box normalised in place, then its
      // products issued; then the chunk before is done: its stage is freed
      const int s = it % kProjStages;
      hopper::mbar_wait(full + s, (it / kProjStages) & 1);
      const uint32_t st = ring_a + s * kProjStage;
      ln_in_place(st + w * kBox, c, wi, lane, sa, sb, af);
      hopper::fence_proxy_async();
      hopper::named_sync(1 + w, kWg);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kChunk / 16; ++k) {
        hopper::wgmma_sst<kProjBn, 0, 0>(
            acc, hopper::kmajor_desc(st + w * kBox + k * 32),
            hopper::kmajor_desc(st + kProjRows * 128 + k * 32),
            c > 0 || k > 0);
      }
      hopper::wgmma_commit();
      if (c > 0) {
        hopper::wgmma_wait<1>();
        release((it - 1) % kProjStages);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<kProjBn / 2>(acc);
    release((it - 1) % kProjStages);

    // epilogue: the last tile's stores have read the staging boxes, and
    // this tile's biases have arrived
    if (tid % kWg == 0) hopper::bulk_wait_read<0>();
    cp_async_wait<0>();
    hopper::named_sync(1 + w, kWg);
    const __nv_bfloat162* bias_w =
        reinterpret_cast<const __nv_bfloat162*>(bias_s + w * kProjBn);
#pragma unroll
    for (int j = 0; j < kProjBn / 8; ++j) {
      const int cl = 8 * j + 2 * q;
      const __nv_bfloat162 bv = bias_w[4 * j + q];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162 y = biased(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                                  bv);
        if (a.act == kActQuickGelu) y = quick_gelu2(y);
        *reinterpret_cast<__nv_bfloat162*>(
            stg + (cl / 64) * kBox +
            hopper::sw128_offset(16 * wi + gid + 8 * h, cl % 64)) = y;
      }
    }
    hopper::fence_proxy_async();   // the staging boxes, for the TMA store
    hopper::named_sync(1 + w, kWg);
    const int rows0 = tl.row0 + 64 * w;
    if (rows0 >= a.R) continue;
    if (!((a.direct >> tl.sel) & 1)) {
      if (tid % kWg == 0) {
        const CUtensorMap* omap = pick<const CUtensorMap*>(
            tl.sel, &maps.o[0], &maps.o[1], &maps.o[2]);
        for (int bx = 0; bx < kProjBoxes && tl.col0 + 64 * bx < tl.F; ++bx) {
          hopper::tma_store_4d(omap, stg + bx * kBox, tl.col0 + 64 * bx,
                               rows0, 0, 0);
        }
        hopper::bulk_commit();
      }
    } else {   // a width that is no multiple of 8: plain stores
      bf16* o = pick(tl.sel, a.out[0], a.out[1], a.out[2]);
      for (int e = tid % kWg; e < 64 * kProjBn; e += kWg) {
        const int r = e / kProjBn, cl = e % kProjBn;
        const int row = rows0 + r, col = tl.col0 + cl;
        if (row < a.R && col < tl.F) {
          o[static_cast<size_t>(row) * tl.F + col] =
              *reinterpret_cast<const bf16*>(
                  stg + (cl / 64) * kBox +
                  hopper::sw128_offset(r, cl % 64 & ~1) + (cl & 1) * 2);
        }
      }
    }
  }
  if (tid % kWg == 0) hopper::bulk_wait_read<0>();
}

struct AdMaps {
  CUtensorMap x;    // (R, D), 64-row boxes
  CUtensorMap wd;   // (D, D), 128-row boxes
  CUtensorMap wu;
  CUtensorMap o;    // (R, D), 64-row boxes
};

struct AdArgs {
  const bf16* bd;
  const bf16* bu;
  const float2* stats;
  int R, D, col_tiles, chunks, stages;
};

__global__ void __launch_bounds__(kAdThreads, 1)
adaptor_kernel(const __grid_constant__ AdMaps maps, const AdArgs a,
               const float* __restrict__ scale,
               const float* __restrict__ bias) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* hs = hopper::align_1024(smem_raw);   // [D / 64][64 rows][128 B]
  uint8_t* ring = hs + a.D * 128;
  uint8_t* stg = ring + a.stages * kAdStage;    // [2][64 rows][128 B]
  float4* af = reinterpret_cast<float4*>(stg);  // until product 2
  bf16* bias_s = reinterpret_cast<bf16*>(stg + 2 * kBox);   // [2][kAdBn]
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + 2 * kAdBn);
  uint64_t* empty = full + a.stages;
  uint64_t* res = empty + a.stages;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kAdRows;
  const int S = a.stages;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4);   // the consumers' four warps
    }
    hopper::mbar_init(res, 1);
    hopper::mbar_init_fence();
  }
  grid_dep_wait();
  stage_affine(scale, bias, a.D, af);
  hopper::fence_proxy_async();   // the boxes a TMA load fills after it
  __syncthreads();

  if (tid >= kWg) {   // the producer warp: one thread feeds the ring
    if (tid != kWg) return;
    int it = 0;
    for (int p = 0; p < 2; ++p) {
      for (int n = 0; n < a.col_tiles; ++n) {
        for (int c = 0; c < a.chunks; ++c, ++it) {
          const int s = it % S;
          if (it >= S) hopper::mbar_wait(empty + s, ((it / S) - 1) & 1);
          uint8_t* st = ring + s * kAdStage;
          hopper::mbar_arrive_expect_tx(full + s, p == 0 ? kAdStage
                                                         : kAdStage - kBox);
          if (p == 0) {
            hopper::tma_load_4d(st, &maps.x, full + s, c * kChunk, row0, 0,
                                0);
          }
          hopper::tma_load_4d(st + kBox, p == 0 ? &maps.wd : &maps.wu,
                              full + s, c * kChunk, n * kAdBn, 0, 0);
        }
      }
    }
    return;
  }

  const int wi = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4, q = lane % 4;
  const uint32_t ring_a = hopper::smem_addr(ring);
  const uint32_t hs_a = hopper::smem_addr(hs);
  const int ra = row0 + 16 * wi + gid;
  const float2 sa = ra < a.R ? a.stats[ra] : make_float2(0.f, 0.f);
  const float2 sb = ra + 8 < a.R ? a.stats[ra + 8] : make_float2(0.f, 0.f);
  float acc[kAdBn / 2];
  uint32_t a0[4][4], a1[4][4];   // product 1's A fragments, two chunks
  int it = 0;

  auto release = [&]() {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + (it - 1) % S);
  };
  // product 1, K chunk c: the normalised A fragments (`cur`) against
  // down's slice; then the chunk before (fragments `prev`) is done
  auto step1 = [&](int c, uint32_t(&cur)[4][4], uint32_t(&prev)[4][4]) {
    const int s = it % S;
    hopper::mbar_wait(full + s, (it / S) & 1);
    const uint32_t st = ring_a + s * kAdStage;
    ln_fragments(st, c, wi, lane, sa, sb, af, cur);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {
      hopper::wgmma_rsk_n128(acc, cur[k],
                               hopper::kmajor_desc(st + kBox + k * 32),
                               c > 0 || k > 0);
    }
    hopper::wgmma_commit();
    if (c > 0) {
      hopper::wgmma_wait<1>();
      hopper::fence_regs<16>(&prev[0][0]);
      release();
    }
    ++it;
  };
  // product 2, K chunk c: h (shared) against up's slice
  auto step2 = [&](int c) {
    const int s = it % S;
    hopper::mbar_wait(full + s, (it / S) & 1);
    const uint32_t st = ring_a + s * kAdStage;
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {
      hopper::wgmma_sst<kAdBn, 0, 0>(
          acc, hopper::kmajor_desc(hs_a + c * kBox + k * 32),
          hopper::kmajor_desc(st + kBox + k * 32), c > 0 || k > 0);
    }
    hopper::wgmma_commit();
    if (c > 0) {
      hopper::wgmma_wait<1>();
      release();
    }
    ++it;
  };

  // a column tile's biases, by tile parity (a tile's reads end before the
  // barriers of the tile after next)
  int tiles = 0;
  auto tile_bias = [&](const bf16* b, int col0) {
    bf16* dst = bias_s + (tiles % 2) * kAdBn;
    prefetch_bias(b, col0, a.D, kAdBn, dst, tid);
    ++tiles;
    return reinterpret_cast<const __nv_bfloat162*>(dst);
  };
  auto bias_ready = [&]() {
    cp_async_wait<0>();
    hopper::named_sync(1, kWg);
  };
  for (int n = 0; n < a.col_tiles; ++n) {
    const __nv_bfloat162* bias_w = tile_bias(a.bd, n * kAdBn);
    for (int c = 0; c < a.chunks; c += 2) {
      step1(c, a0, a1);
      if (c + 1 < a.chunks) step1(c + 1, a1, a0);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<kAdBn / 2>(acc);
    hopper::fence_regs<16>(&a0[0][0]);
    hopper::fence_regs<16>(&a1[0][0]);
    release();
    bias_ready();
    // h = sq_relu(round(round(acc) + b_down)), K-major into its blocks
#pragma unroll
    for (int j = 0; j < kAdBn / 8; ++j) {
      const int col = n * kAdBn + 8 * j + 2 * q;
      if (col >= a.D) continue;
      const __nv_bfloat162 bv = bias_w[4 * j + q];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // relu and square in bf16
        const __nv_bfloat162 r = __hmax2(
            biased(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], bv),
            __float2bfloat162_rn(0.f));
        *reinterpret_cast<__nv_bfloat162*>(
            hs + (col / 64) * kBox +
            hopper::sw128_offset(16 * wi + gid + 8 * h, col % 64)) =
            __hmul2(r, r);
      }
    }
  }
  hopper::fence_proxy_async();   // h, for the products that read it
  hopper::named_sync(1, kWg);    // every row of h written, the affine read

  for (int n = 0; n < a.col_tiles; ++n) {
    const int col0 = n * kAdBn;
    const int boxes = col0 + 64 < a.D ? 2 : 1;
    if (tid == 0) {   // the residual x, once the last store read the boxes
      hopper::bulk_wait_read<0>();
      hopper::mbar_arrive_expect_tx(res, boxes * kBox);
      for (int bx = 0; bx < boxes; ++bx) {
        hopper::tma_load_4d(stg + bx * kBox, &maps.x, res, col0 + 64 * bx,
                            row0, 0, 0);
      }
    }
    const __nv_bfloat162* bias_w = tile_bias(a.bu, col0);
    for (int c = 0; c < a.chunks; ++c) step2(c);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<kAdBn / 2>(acc);
    release();
    hopper::mbar_wait(res, n & 1);
    bias_ready();
    // out = x + round(round(acc) + b_up), in place of x in the boxes
#pragma unroll
    for (int j = 0; j < kAdBn / 8; ++j) {
      const int cl = 8 * j + 2 * q;
      if (col0 + cl >= a.D) continue;
      const __nv_bfloat162 bv = bias_w[4 * j + q];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            stg + (cl / 64) * kBox +
            hopper::sw128_offset(16 * wi + gid + 8 * h, cl % 64));
        // the residual add in bf16
        *p = __hadd2(*p, biased(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                                bv));
      }
    }
    hopper::fence_proxy_async();
    hopper::named_sync(1, kWg);
    if (tid == 0 && row0 < a.R) {
      for (int bx = 0; bx < boxes; ++bx) {
        hopper::tma_store_4d(&maps.o, stg + bx * kBox, col0 + 64 * bx, row0,
                             0, 0);
      }
      hopper::bulk_commit();
    }
  }
  if (tid == 0) hopper::bulk_wait_read<0>();
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

using hopper::sm_count;

cudaError_t launch_stats(const bf16* x, float2* stats, int R, int D,
                         float eps, cudaStream_t st) {
  return hopper::launch_pdl(row_stats_kernel, dim3(cdiv(R, kStatsWarps)),
                            kStatsWarps * 32, 0, st, x, stats, R, D, eps);
}

// the fp32 FMA kernels' launch shapes (ops/ln_proj.py's plans, "fma")
int f32_groups(const int* f, int n) {
  int groups = 0;
  for (int i = 0; i < n; ++i) groups += cdiv(f[i], kGroup * kBn);
  return groups;
}

int f32_smem(int rows, int tiles, int D) {
  return (tiles * rows * (D + 4) + kStages * kStageElems) * 4;
}

cudaError_t run_ln_proj_f32(const void* x, const float* scale,
                            const float* bias, const void* const* w,
                            const void* const* b, void* const* o,
                            const int* f, int n, int R, int D, float eps,
                            int act, int blocks, int smem, cudaStream_t st) {
  const int groups = f32_groups(f, n);
  const int row_tiles = cdiv(R, kF32ProjRows);
  if (blocks != groups * row_tiles || smem != f32_smem(kF32ProjRows, 1, D) ||
      row_tiles > 65535) {
    return cudaErrorInvalidValue;
  }
  Proj p = {};
  p.n = n;
  for (int i = 0, first = 0; i < kMaxOut; ++i) {
    p.w[i] = static_cast<const float*>(w[i]);
    p.b[i] = static_cast<const float*>(b[i]);
    p.o[i] = static_cast<float*>(o[i]);
    p.f[i] = f[i];
    p.first[i] = first;
    if (i < n) first += cdiv(f[i], kGroup * kBn);
  }
  static hopper::SmemGrant granted;
  const cudaError_t err = granted.ensure(ln_proj_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  ln_proj_f32_kernel<<<dim3(groups, row_tiles), kThreads, smem, st>>>(
      static_cast<const float*>(x), scale, bias, p, R, D, eps, act);
  return cudaGetLastError();
}

cudaError_t run_ln_proj_bf16(const void* x, const float* scale,
                             const float* bias, const void* const* w,
                             const void* const* b, void* const* o,
                             const int* f, int n, int R, int D, float eps,
                             int act, float2* stats, int blocks, int smem,
                             cudaStream_t st) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const ProjPlan p = proj_plan(R, D, f, n, sms);
  if (blocks != p.blocks || smem != p.smem || stats == nullptr ||
      p.smem > kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  ProjMaps maps;
  ProjArgs a = {};
  if (!hopper::cached_bf16_map(&maps.x, x, R, D, kProjRows)) {
    return cudaErrorInvalidValue;
  }
  for (int i = 0, first = 0; i < kMaxOut; ++i) {
    const int k = i < n ? i : 0;   // unused outputs repeat the first
    if (!hopper::cached_bf16_map(&maps.w[i], w[k], f[k], D, kProjBn)) {
      return cudaErrorInvalidValue;
    }
    if (f[k] % 8 == 0) {
      if (!hopper::cached_bf16_map(&maps.o[i], o[k], R, f[k], 64)) {
        return cudaErrorInvalidValue;
      }
    } else {
      maps.o[i] = maps.x;
      a.direct |= 1 << i;
    }
    a.bias[i] = static_cast<const bf16*>(b[k]);
    a.out[i] = static_cast<bf16*>(o[k]);
    a.f[i] = f[k];
    a.first[i] = first;
    if (i < n) first += cdiv(f[i], kProjBn);
  }
  a.stats = stats;
  a.n = n;
  a.R = R;
  a.D = D;
  a.act = act;
  a.col_tiles = p.col_tiles;
  a.tiles = p.tiles;
  a.chunks = p.chunks;
  cudaError_t err =
      launch_stats(static_cast<const bf16*>(x), stats, R, D, eps, st);
  if (err != cudaSuccess) return err;
  static hopper::SmemGrant granted;
  err = granted.ensure(ln_proj_kernel, p.smem);
  if (err != cudaSuccess) return err;
  return hopper::launch_pdl(ln_proj_kernel, dim3(p.blocks), kProjThreads,
                            p.smem, st, maps, a, scale, bias);
}

cudaError_t run_adaptor_f32(const void* x, const float* scale,
                            const float* bias, const void* wd, const void* bd,
                            const void* wu, const void* bu, void* out, int R,
                            int D, float eps, int blocks, int smem,
                            cudaStream_t st) {
  if (blocks != cdiv(R, kF32AdaptorRows) ||
      smem != f32_smem(kF32AdaptorRows, 2, D)) {
    return cudaErrorInvalidValue;
  }
  static hopper::SmemGrant granted;
  const cudaError_t err = granted.ensure(adaptor_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  adaptor_f32_kernel<<<blocks, kThreads, smem, st>>>(
      static_cast<const float*>(x), scale, bias,
      static_cast<const float*>(wd), static_cast<const float*>(bd),
      static_cast<const float*>(wu), static_cast<const float*>(bu),
      static_cast<float*>(out), R, D, eps);
  return cudaGetLastError();
}

cudaError_t run_adaptor_bf16(const void* x, const float* scale,
                             const float* bias, const void* wd,
                             const void* bd, const void* wu, const void* bu,
                             void* out, int R, int D, float eps,
                             float2* stats, int blocks, int smem,
                             cudaStream_t st) {
  const AdPlan p = ad_plan(R, D);
  if (blocks != p.blocks || smem != p.smem || stats == nullptr ||
      p.stages < 2 || p.smem > kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  AdMaps maps;
  if (!hopper::cached_bf16_map(&maps.x, x, R, D, kAdRows) ||
      !hopper::cached_bf16_map(&maps.wd, wd, D, D, kAdBn) ||
      !hopper::cached_bf16_map(&maps.wu, wu, D, D, kAdBn) ||
      !hopper::cached_bf16_map(&maps.o, out, R, D, kAdRows)) {
    return cudaErrorInvalidValue;
  }
  const AdArgs a = {static_cast<const bf16*>(bd), static_cast<const bf16*>(bu),
                    stats, R, D, p.col_tiles, p.chunks, p.stages};
  cudaError_t err =
      launch_stats(static_cast<const bf16*>(x), stats, R, D, eps, st);
  if (err != cudaSuccess) return err;
  static hopper::SmemGrant granted;
  err = granted.ensure(adaptor_kernel, p.smem);
  if (err != cudaSuccess) return err;
  return hopper::launch_pdl(adaptor_kernel, dim3(p.blocks), kAdThreads,
                            p.smem, st, maps, a, scale, bias);
}

bool dims_ok(int R, int D, int dtype) {
  return R > 0 && D > 0 && D % kChunk == 0 && D <= prismer::kLnMaxDim &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// x (R, D) in the compute dtype (0 fp32, 1 bf16); scale and bias (D,) fp32;
// for i < n (1 to 3): w_i (f_i, D), b_i (f_i,) and out_i (R, f_i) in the
// compute dtype (unused pointers may be null); act 0 none, 1 quick_gelu.
// D a multiple of 64 and at most 1280, every pointer 16-byte aligned.
// stats: bf16, an (R, 2) fp32 scratch; blocks and smem: the launch plan's
// (ops/ln_proj.ln_proj_plan), refused if they differ. Returns a
// cudaError_t (0 on success).
extern "C" int prismer_ln_proj(const void* x, const float* scale,
                               const float* bias, const void* w0,
                               const void* w1, const void* w2, const void* b0,
                               const void* b1, const void* b2, void* o0,
                               void* o1, void* o2, int f0, int f1, int f2,
                               int n, int R, int D, float eps, int act,
                               int dtype, void* stats, int blocks, int smem,
                               void* stream) {
  if (!dims_ok(R, D, dtype) || n < 1 || n > kMaxOut ||
      (act != kActNone && act != kActQuickGelu)) {
    return cudaErrorInvalidValue;
  }
  const void* w[kMaxOut] = {w0, w1, w2};
  const void* b[kMaxOut] = {b0, b1, b2};
  void* o[kMaxOut] = {o0, o1, o2};
  const int f[kMaxOut] = {f0, f1, f2};
  for (int i = 0; i < n; ++i) {
    if (f[i] <= 0) return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? run_ln_proj_f32(x, scale, bias, w, b, o, f, n, R, D, eps, act,
                               blocks, smem, st)
             : run_ln_proj_bf16(x, scale, bias, w, b, o, f, n, R, D, eps, act,
                                static_cast<float2*>(stats), blocks, smem,
                                st);
}

// x and out (R, D), w_down and w_up (D, D), b_down and b_up (D,), all in
// the compute dtype (0 fp32, 1 bf16); scale and bias (D,) fp32. D a
// multiple of 64 and at most 1280, every pointer 16-byte aligned. stats,
// blocks and smem as for prismer_ln_proj (ops/ln_proj.adaptor_plan).
// Returns a cudaError_t (0 on success).
extern "C" int prismer_adaptor_fused(const void* x, const float* scale,
                                     const float* bias, const void* wd,
                                     const void* bd, const void* wu,
                                     const void* bu, void* out, int R, int D,
                                     float eps, int dtype, void* stats,
                                     int blocks, int smem, void* stream) {
  if (!dims_ok(R, D, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? run_adaptor_f32(x, scale, bias, wd, bd, wu, bu, out, R, D,
                               eps, blocks, smem, st)
             : run_adaptor_bf16(x, scale, bias, wd, bd, wu, bu, out, R, D,
                                eps, static_cast<float2*>(stats), blocks,
                                smem, st);
}
