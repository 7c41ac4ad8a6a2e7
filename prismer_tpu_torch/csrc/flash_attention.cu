// Flash attention forward for Hopper (sm_90a), one kernel for two TPU kernels.
//
// Replaces prismer_tpu/ops/flash_attention.py:
//   * flash_attention_packed (_packed_forward / _packed_kernel): mask-free,
//     non-causal attention on packed (B, L, H*Dh) operands;
//   * flash_attention (_flash_forward / _flash_kernel, _maskfree_kernel):
//     head-split (B, H, L, Dh) attention with an optional key-padding mask
//     and causal masking.
// A packed (B, L, H*Dh) tensor is a strided view of (B, H, L, Dh), so one
// kernel that takes per-tensor (batch, head, row) strides serves both. The
// TPU kernel's head-on-lanes grouping and whole-K VMEM blocks are not carried
// over: they worked around the TPU's (8, 128) tiling.
//
// What bounds it on the H100: at the encoder shape (B=8, L=964, H=12, Dh=64)
// the two products are ~23 GFLOP per layer, against ~18 MB of q/k/v/o, so it
// is compute-bound (0.023 ms at 989 TFLOP/s), and only the tensor cores
// reach that rate; the (L, L) scores never reach device memory. The
// resamplers' few queries (Lq 64 against Lk 1240-1600) are the exception:
// there reading K and V once bounds the call. Both dtypes keep the one
// contract:
//   * bf16 (the serving and training path): wgmma products on TMA-fed
//     tiles (csrc/hopper.cuh), in two kernels that share the per-tile work
//     (attend_tile). A warpgroup owns 64 query rows of one (batch, head).
//     It computes S = Q K^T as a shared-memory product (both operands
//     K-major over Dh), scales, masks and runs the online softmax on S in
//     registers (accumulator layout, hopper.cuh), rounds P to bf16 and
//     re-packs it as the register A operand of O += P V, whose B is the V
//     tile read MN-major (no transpose). O stays in registers (Dh / 2 fp32
//     per thread) for the whole stream. Tiles without masked or past-Lk
//     keys (all but the last, mask-free) skip the per-key tests.
//     - The ring kernel: two consumer warpgroups and a producer warp per
//       block. The producer's lane 0 loads the Q tiles once and keeps the K
//       and V tiles (64 keys; 32 at Dh 160, for registers) in flight in a
//       ring of 4 stages, by TMA on rank-4 (Dh, L, H, B) tensor maps built
//       in the C entry point from the strides, as bf16 in the 128-byte
//       swizzle; TMA's zero fill covers rows past L and, at Dh 80, 96 and
//       160, the columns of the last 64-column block past Dh. With a key
//       mask its lanes stage the tile's key flags beside it. A block whose
//       rows fit in one warpgroup (the resamplers, the decoder's
//       cross-attention) splits the key tiles over both (by stage, each
//       warpgroup the stages of its parity), and the second hands its
//       (m, l, O) to the first through shared memory, which combines them
//       in that fixed order: no float atomics, repeat launches
//       bit-identical.
//     - The single-tile kernel (Lk <= one tile: the decoder's prefill and
//       self-attention): one warpgroup whose thread 0 loads Q, K and V in
//       one TMA round, no producer warp, so that several of these short
//       blocks share an SM instead of running in waves.
//     What bounds this design: a warpgroup serialises its products and its
//     softmax, and only the two warpgroups of a ring block overlap one's
//     softmax with the other's products. On an NVIDIA H100 80GB HBM3 at
//     700 W (chip_smoke.py check_attention, graph replay): the encoder
//     shape 0.107-0.114 ms, ~200 TFLOP/s, 4.6-4.9x its bound (the
//     mma.sync kernel this replaced 0.33 ms, SDPA 0.077 ms); the HUGE trunk
//     (B8 L1220 H16 Dh80) 0.25 ms (0.86 before); the resamplers 1.5-2x their
//     byte bounds. The other
//     shapes are in PERF.md section 6.
//   * fp32 (the card-vs-CPU parity checks): FMA tiles, since the tensor
//     cores have no full-fp32 product. One thread owns one query row (no
//     cross-thread softmax reduction); K/V tiles sit in shared memory as
//     fp32 and are read as broadcasts, four values per load. Above Dh 96 a
//     thread's query row moves from registers to shared memory (row stride
//     Dh + 1, so the 32 rows a warp reads at once sit in distinct banks), a
//     block takes 32 rows and a key tile 8 keys, so that the thread's Dh
//     accumulators stay in registers and the unrolled tile loops index them
//     with constants. ptxas -v still reports spills at Dh 96, 128 and 160
//     (64, 232 and 2072 bytes of stores and loads, the same as before the
//     bf16 redesign): this kernel serves the parity checks only.
// Head dims: every one of the model registry's, 64 and 96 (Prismer-BASE),
// 80 (ViT-H/14's trunk), 128 and 160 (the LARGE and HUGE resamplers).
//
// Numerics follow the JAX reference (mha_reference, flash_attention.py:57):
// scores and softmax statistics in fp32 from input-dtype operands; masked
// scores replaced by the finite -1e9 fill; causal keeps col <= row + (Lk-Lq);
// keys past Lk take no part; probabilities rounded to the input dtype
// before the PV product, which accumulates in fp32; out = o / max(l, 1e-30)
// in the input dtype, lse = m + log(l) in fp32, (B, H, Lq) contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kMaskFill = -1.0e9f;   // flash_attention.py:54 NEG_INF
constexpr float kMInit = -1.0e30f;     // below any score, finite
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;            // (B, H, Lq) contiguous
  const int* key_mask;   // (B, Lk) with row stride mask_sb, or null
  int B, H, Lq, Lk;
  int64_t q_sb, q_sh, q_sl;
  int64_t k_sb, k_sh, k_sl;
  int64_t v_sb, v_sh, v_sl;
  int64_t o_sb, o_sh, o_sl;
  int64_t mask_sb;
  int causal;
  float scale;
};

// ---------------------------------------------------------------------------
// fp32 FMA kernel
// ---------------------------------------------------------------------------

// BQ query rows (= threads) per block; a row's q in registers up to Dh 96,
// in shared memory above
template <int DH, int BK, int BQ>
__global__ void __launch_bounds__(BQ)
flash_fwd_f32_kernel(const Params p) {
  static_assert(DH % 4 == 0, "head dim must be a multiple of 4");
  constexpr bool kQShared = DH > 96;
  constexpr int QR = kQShared ? BQ : 1;       // rows of the shared q tile
  constexpr int QC = kQShared ? DH + 1 : 1;
  __shared__ __align__(16) float ks[BK][DH];
  __shared__ __align__(16) float vs[BK][DH];
  __shared__ float qsm[QR][QC];
  __shared__ int valid[BK];   // 1 keep, 0 masked (-1e9), -1 past Lk (skip)

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool active = row < p.Lq;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  float q[kQShared ? 1 : DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    const float x = active ? qb[row * p.q_sl + d] : 0.0f;
    if constexpr (kQShared) {
      qsm[threadIdx.x][d] = x;   // read back by this thread only
    } else {
      q[d] = x;
    }
    acc[d] = 0.0f;
  }
  float m = kMInit;
  float l = 0.0f;
  const int causal_off = p.Lk - p.Lq;

  for (int k0 = 0; k0 < p.Lk; k0 += BK) {
    __syncthreads();   // previous tile fully consumed
    for (int e = threadIdx.x; e < BK * DH; e += BQ) {
      const int r = e / DH;
      const int c = e - r * DH;
      const int col = k0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (col < p.Lk) {
        kv = kb[col * p.k_sl + c];
        vv = vb[col * p.v_sl + c];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    for (int r = threadIdx.x; r < BK; r += BQ) {
      const int col = k0 + r;
      int f = -1;
      if (col < p.Lk) {
        f = 1;
        if (p.key_mask != nullptr && p.key_mask[b * p.mask_sb + col] == 0) {
          f = 0;
        }
      }
      valid[r] = f;
    }
    __syncthreads();
    if (!active) continue;

    // s = q . k_j for BK keys: BK independent accumulators, each summed
    // over d in order
    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) s[j] = 0.0f;
    if constexpr (kQShared) {
      // one key at a time, q re-read from shared memory for each (volatile:
      // held in registers across the keys it would take Dh more of them)
      const volatile float* qrow = qsm[threadIdx.x];
#pragma unroll
      for (int j = 0; j < BK; ++j) {
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
          s[j] = fmaf(qrow[d], kk.x, s[j]);
          s[j] = fmaf(qrow[d + 1], kk.y, s[j]);
          s[j] = fmaf(qrow[d + 2], kk.z, s[j]);
          s[j] = fmaf(qrow[d + 3], kk.w, s[j]);
        }
      }
    } else {
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
#pragma unroll
        for (int j = 0; j < BK; ++j) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
          s[j] = fmaf(q[d], kk.x, s[j]);
          s[j] = fmaf(q[d + 1], kk.y, s[j]);
          s[j] = fmaf(q[d + 2], kk.z, s[j]);
          s[j] = fmaf(q[d + 3], kk.w, s[j]);
        }
      }
    }
    float tile_max = kMInit;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int f = valid[j];
      float x = s[j] * p.scale;
      if (f == 0 || (p.causal && k0 + j > row + causal_off)) x = kMaskFill;
      s[j] = x;
      if (f >= 0) tile_max = fmaxf(tile_max, x);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f((m - m_new) * kLog2e);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
    m = m_new;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float pj = valid[j] >= 0 ? exp2f((s[j] - m_new) * kLog2e) : 0.0f;
      l += pj;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(pj, vv.x, acc[d]);
        acc[d + 1] = fmaf(pj, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(pj, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(pj, vv.w, acc[d + 3]);
      }
    }
  }

  if (!active) return;
  const float denom = fmaxf(l, 1e-30f);
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_sl;
#pragma unroll
  for (int d = 0; d < DH; ++d) ob[d] = acc[d] / denom;
  p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Lq + row] = m + logf(denom);
}

// ---------------------------------------------------------------------------
// bf16: wgmma products on TMA-fed tiles
// ---------------------------------------------------------------------------

using hopper::acc_to_a;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_wait;
using hopper::pack_bf16;
using hopper::smem_addr;
using hopper::tma_load_4d;

constexpr int kRows = 64;    // query rows of a consumer warpgroup (wgmma M)

__host__ __device__ constexpr int col_blocks(int dh) {
  return (dh + 63) / 64;
}

// keys per streamed tile: 64, and 32 at Dh 160, where O's 80 fp32 per
// thread leave too few of the 168 registers that ptxas grants a thread of
// a three-warpgroup block for 64-key scores
__host__ __device__ constexpr int tile_keys(int dh) {
  return dh > 128 ? 32 : 64;
}

struct TcParams {
  CUtensorMap q, k, v;   // rank 4 (Dh, L, H, B); boxes of 64 / BK rows
  void* o;
  int64_t o_sb, o_sh, o_sl;
  float* lse;            // (B, H, Lq) contiguous
  const int* key_mask;   // (B, Lk) with row stride mask_sb, or null
  int64_t mask_sb;
  int H, Lq, Lk;
  int causal;
  float scale;
};

// Shared memory of one block, in bytes from a 1024-aligned base: GROUPS Q
// tiles, STAGES x (K tile, V tile), STAGES x BK key flags and the barriers
// (Q loaded; stage full; stage free). Tiles are column blocks of 64 bf16
// ([block][row][64], 128-byte swizzle). The ring kernel: two warpgroups and
// four stages, at most 160 KB (Dh 96 and 128), an even count as its split
// needs; the single-tile kernel: one warpgroup, one stage.
template <int DH, int GROUPS, int STAGES>
struct FwdLayout {
  static constexpr int kKeys = tile_keys(DH);
  static constexpr int kQTile = col_blocks(DH) * kRows * 128;
  static constexpr int kKvTile = col_blocks(DH) * kKeys * 128;
  static constexpr int kQ = 0;
  static constexpr int kK = GROUPS * kQTile;
  static constexpr int kV = kK + STAGES * kKvTile;
  static constexpr int kFlags = kV + STAGES * kKvTile;
  static constexpr int kBars = kFlags + STAGES * kKeys * 4;
  static constexpr size_t kBytes = kBars + (1 + 2 * STAGES) * 8 + 1024;
};

// The consumer warpgroup's state: O (64 rows x DH, fp32, accumulator
// layout: o[4n + 2hh + e] is row r0 + 8hh, column 8n + 2tig + e), the
// running row max m (natural units) and this thread's part of the row
// sum l, for its rows r0 and r0 + 8.
template <int DH>
struct Rows {
  float o[DH / 2];
  float m[2];
  float l[2];
  int r0, tig;
};

// One key tile of a warpgroup's stream (keys k0 .. k0 + BK - 1; flags null
// without a key mask): S = Q K^T from shared memory into sc, the scale, the
// masks and the online softmax in registers, then O += P V with P rounded
// to bf16 as the register A operand and V read MN-major. sc is the
// caller's, live across tiles: 5 % faster at Dh 64 than scores local to
// the tile (same card, one call; PERF.md section 6).
template <int DH, int BK>
__device__ __forceinline__ void attend_tile(const TcParams& p, Rows<DH>& w,
                                            uint32_t q_tile, uint32_t k_tile,
                                            uint32_t v_tile, const int* flags,
                                            int k0, float* sc) {
  const float neg_inf = -__int_as_float(0x7f800000);
  fence_regs<BK / 2>(sc);
  hopper::wgmma_fence();
  hopper::wgmma_ss_rows<DH, BK>(sc, q_tile, k_tile);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_regs<BK / 2>(sc);

  // the tile's row max: sc[4j + 2hh + e] is row r0 + 8hh, key
  // k0 + 8j + 2tig + e. A tile with no masked or past-Lk key keeps the
  // unscaled q.k (its max times scale is the max of the scores, exactly);
  // the others hold scores, -1e9 where masked (in max and sum, as in the
  // reference) and -inf past Lk (in neither)
  const bool edge = k0 + BK > p.Lk || flags != nullptr || p.causal;
  float tmax[2] = {neg_inf, neg_inf};
  if (edge) {
    const int causal_off = p.Lk - p.Lq;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * w.tig + e;
        const int col = k0 + c;
        const bool keep = flags == nullptr || flags[c] != 0;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          float v = sc[x] * p.scale;
          if (!keep || (p.causal && col > w.r0 + 8 * hh + causal_off)) {
            v = kMaskFill;
          }
          if (col >= p.Lk) v = neg_inf;
          sc[x] = v;
          tmax[hh] = fmaxf(tmax[hh], v);
        }
      }
    }
  } else {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      tmax[(x >> 1) & 1] = fmaxf(tmax[(x >> 1) & 1], sc[x]);
    }
    tmax[0] *= p.scale;
    tmax[1] *= p.scale;
  }

  // online softmax: rescale the row's sum and O, then p = exp(s - m)
  float alpha[2], ml[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
    tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
    const float m_new = fmaxf(w.m[hh], tmax[hh]);
    alpha[hh] = exp2f((w.m[hh] - m_new) * kLog2e);
    w.m[hh] = m_new;
    w.l[hh] *= alpha[hh];
    ml[hh] = m_new * kLog2e;
  }
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) w.o[x] *= alpha[(x >> 1) & 1];
  const float to_log2 = edge ? kLog2e : p.scale * kLog2e;
#pragma unroll
  for (int x = 0; x < BK / 2; ++x) {
    const int hh = (x >> 1) & 1;
    sc[x] = exp2f(fmaf(sc[x], to_log2, -ml[hh]));
    w.l[hh] += sc[x];
  }

  // O += P V
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) acc_to_a(sc, t, pa[t]);
  fence_regs<DH / 2>(w.o);
  hopper::wgmma_fence();
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) {
    hopper::wgmma_rs_wide<DH, BK>(w.o, pa[t], v_tile, t);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_regs<DH / 2>(w.o);
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) fence_regs<4>(pa[t]);
}

// A warpgroup's rows before the stream: O = 0, no max, no sum
template <int DH>
__device__ __forceinline__ void start_rows(Rows<DH>& w, int row0) {
  const int tid = threadIdx.x % 128;
  w.r0 = row0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  w.tig = tid & 3;
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) w.o[i] = 0.f;
  w.m[0] = w.m[1] = kMInit;
  w.l[0] = w.l[1] = 0.f;
}

// the quad's row sums
template <int DH>
__device__ __forceinline__ void sum_rows(Rows<DH>& w) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    w.l[hh] += __shfl_xor_sync(0xffffffffu, w.l[hh], 1);
    w.l[hh] += __shfl_xor_sync(0xffffffffu, w.l[hh], 2);
  }
}

// out = o / max(l, 1e-30) in bf16 and lse = m + log(l) for the rows < Lq
template <int DH>
__device__ __forceinline__ void store_rows(const TcParams& p, const Rows<DH>& w,
                                           int b, int h) {
  using bf16 = __nv_bfloat16;
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = w.r0 + 8 * hh;
    if (row >= p.Lq) continue;
    const float denom = fmaxf(w.l[hh], 1e-30f);
    bf16* orow = ob + row * p.o_sl + 2 * w.tig;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int x = 4 * n + 2 * hh;
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(w.o[x] / denom, w.o[x + 1] / denom);
    }
    if (w.tig == 0) {
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Lq + row] =
          w.m[hh] + logf(denom);
    }
  }
}

// the key flags of keys k0 .. k0 + BK - 1 (1 keep, 0 masked) into `flags`,
// thread i of n writing keys i, i + n, ...
template <int BK>
__device__ __forceinline__ void stage_flags(const TcParams& p, int b, int k0,
                                            int i, int n, int* flags) {
  for (int r = i; r < BK; r += n) {
    const int col = k0 + r;
    flags[r] = col < p.Lk && p.key_mask[b * p.mask_sb + col] != 0;
  }
}

constexpr int kRingGroups = 2;                        // consumer warpgroups
constexpr int kRingConsumers = 128 * kRingGroups;
constexpr int kRingThreads = kRingConsumers + 32;     // and a producer warp
constexpr int kRingStages = 4;

// grid (ceil(Lq / 128), H, B): two consumer warpgroups, then the producer
// warp
template <int DH>
__global__ void __launch_bounds__(kRingThreads, 1)
flash_fwd_ring_kernel(const __grid_constant__ TcParams p) {
  using L = FwdLayout<DH, kRingGroups, kRingStages>;
  constexpr int CB = col_blocks(DH);
  constexpr int STAGES = kRingStages;
  constexpr int BK = L::kKeys;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kRingGroups * kRows;
  const int n_tiles = (p.Lk + BK - 1) / BK;
  // warpgroups with query rows of their own; where only the first has any,
  // both take its rows and split the key tiles: warpgroup w takes those
  // of the stages s with s % 2 == w, so that it waits on every phase of
  // their barriers (a parity wait that skipped one could pass a phase
  // early)
  const int owners = min(kRingGroups, (p.Lq - q0 + kRows - 1) / kRows);
  const bool split = owners == 1;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], split ? 128 : kRingConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kRingConsumers) {
    // the producer: Q once, then K and V tile by tile (lane 0), the key
    // flags beside them (all lanes), each stage after its last reader
    // freed it
    const int lane = threadIdx.x - kRingConsumers;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(q_full, owners * L::kQTile);
      for (int g = 0; g < owners; ++g) {
        for (int c = 0; c < CB; ++c) {
          tma_load_4d(smem + L::kQ + g * L::kQTile + c * kRows * 128, &p.q,
                      q_full, 64 * c, q0 + g * kRows, h, b);
        }
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      if (p.key_mask != nullptr) {
        stage_flags<BK>(p, b, it * BK, lane, 32,
                        reinterpret_cast<int*>(smem + L::kFlags) + s * BK);
      }
      if (lane != 0) {
        mbar_arrive(&full[s]);
        continue;
      }
      hopper::mbar_arrive_expect_tx(&full[s], 2 * L::kKvTile);
      for (int c = 0; c < CB; ++c) {
        tma_load_4d(smem + L::kK + s * L::kKvTile + c * BK * 128, &p.k,
                    &full[s], 64 * c, it * BK, h, b);
        tma_load_4d(smem + L::kV + s * L::kKvTile + c * BK * 128, &p.v,
                    &full[s], 64 * c, it * BK, h, b);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int own = split ? 0 : wg;   // whose Q rows
  const uint32_t base = smem_addr(smem);
  const uint32_t q_tile = base + L::kQ + own * L::kQTile;
  Rows<DH> w;
  start_rows(w, q0 + own * kRows);
  // this warpgroup's first tile after `it`
  auto next = [&](int it) {
    do {
      ++it;
    } while (split && it < n_tiles && (it % STAGES) % 2 != wg);
    return it;
  };

  float sc[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  mbar_wait(q_full, 0);
  for (int it = next(-1); it < n_tiles; it = next(it)) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const int* flags = p.key_mask == nullptr
        ? nullptr
        : reinterpret_cast<const int*>(smem + L::kFlags) + s * BK;
    attend_tile<DH, BK>(p, w, q_tile, base + L::kK + s * L::kKvTile,
                        base + L::kV + s * L::kKvTile, flags, it * BK, sc);
    mbar_arrive(&empty[s]);
  }
  sum_rows(w);

  if (split) {
    // the second warpgroup's (m, l, O) into the first's, in that order,
    // through the tiles' shared memory ([DH / 2 + 4][128] fp32)
    static_assert((DH / 2 + 4) * 128 * 4 <= L::kFlags, "exchange");
    const int tid = threadIdx.x % 128;
    float* xs = reinterpret_cast<float*>(smem);
    hopper::named_sync(1, kRingConsumers);   // both are done with the tiles
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) xs[i * 128 + tid] = w.o[i];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        xs[(DH / 2 + hh) * 128 + tid] = w.m[hh];
        xs[(DH / 2 + 2 + hh) * 128 + tid] = w.l[hh];
      }
    }
    hopper::named_sync(1, kRingConsumers);
    if (wg == 1) return;
    float a[2], c[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m1 = xs[(DH / 2 + hh) * 128 + tid];
      const float l1 = xs[(DH / 2 + 2 + hh) * 128 + tid];
      const float m_new = fmaxf(w.m[hh], m1);
      a[hh] = exp2f((w.m[hh] - m_new) * kLog2e);
      c[hh] = exp2f((m1 - m_new) * kLog2e);
      w.l[hh] = w.l[hh] * a[hh] + l1 * c[hh];
      w.m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      w.o[i] = w.o[i] * a[(i >> 1) & 1] + xs[i * 128 + tid] * c[(i >> 1) & 1];
    }
  }
  store_rows(p, w, b, h);
}

// grid (ceil(Lq / 64), H, B), Lk <= BK: one warpgroup and one key tile,
// loaded with Q in one TMA round by thread 0; no producer warp, so that
// several of these small blocks share an SM (the decoder's prefill and
// self-attention)
template <int DH>
__global__ void __launch_bounds__(128)
flash_fwd_tile_kernel(const __grid_constant__ TcParams p) {
  using L = FwdLayout<DH, 1, 1>;
  constexpr int CB = col_blocks(DH);
  constexpr int BK = L::kKeys;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBars);
  int* flags = p.key_mask == nullptr
      ? nullptr
      : reinterpret_cast<int*>(smem + L::kFlags);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_init_fence();
  }
  if (flags != nullptr) stage_flags<BK>(p, b, 0, threadIdx.x, 128, flags);
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(bar, L::kQTile + 2 * L::kKvTile);
    for (int c = 0; c < CB; ++c) {
      tma_load_4d(smem + L::kQ + c * kRows * 128, &p.q, bar, 64 * c, q0, h,
                  b);
      tma_load_4d(smem + L::kK + c * BK * 128, &p.k, bar, 64 * c, 0, h, b);
      tma_load_4d(smem + L::kV + c * BK * 128, &p.v, bar, 64 * c, 0, h, b);
    }
  }
  Rows<DH> w;
  start_rows(w, q0);
  const uint32_t base = smem_addr(smem);
  mbar_wait(bar, 0);
  float sc[BK / 2];
  attend_tile<DH, BK>(p, w, base + L::kQ, base + L::kK, base + L::kV, flags,
                      0, sc);
  sum_rows(w);
  store_rows(p, w, b, h);
}

template <int DH>
cudaError_t launch_tc(const TcParams& p, int B, cudaStream_t stream) {
  if (p.Lk <= tile_keys(DH)) {
    static hopper::SmemGrant granted;
    constexpr size_t smem = FwdLayout<DH, 1, 1>::kBytes;
    const cudaError_t err = granted.ensure(flash_fwd_tile_kernel<DH>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Lq + kRows - 1) / kRows, p.H, B);
    flash_fwd_tile_kernel<DH><<<grid, 128, smem, stream>>>(p);
    return cudaGetLastError();
  }
  static hopper::SmemGrant granted;
  constexpr size_t smem = FwdLayout<DH, kRingGroups, kRingStages>::kBytes;
  const cudaError_t err = granted.ensure(flash_fwd_ring_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const int rows = kRingGroups * kRows;
  const dim3 grid((p.Lq + rows - 1) / rows, p.H, B);
  flash_fwd_ring_kernel<DH><<<grid, kRingThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH, int BK, int BQ>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Lq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_f32_kernel<DH, BK, BQ><<<grid, BQ, 0, stream>>>(p);
  return cudaGetLastError();
}


}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
// bf16 needs 16-byte aligned bases and every stride a multiple of 8
// elements; the call builds the TMA tensor maps from them.
extern "C" int prismer_flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* key_mask, int B, int H, int Lq, int Lk, int Dh,
    int64_t q_sb, int64_t q_sh, int64_t q_sl,
    int64_t k_sb, int64_t k_sh, int64_t k_sl,
    int64_t v_sb, int64_t v_sh, int64_t v_sl,
    int64_t o_sb, int64_t o_sh, int64_t o_sl,
    int64_t mask_sb, int causal, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Params p{q, k, v, o, lse, key_mask, B, H, Lq, Lk,
             q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl,
             o_sb, o_sh, o_sl, mask_sb, causal, scale};
    switch (Dh) {
      case 64: return launch_f32<64, 32, 64>(p, s);
      case 80: return launch_f32<80, 16, 64>(p, s);
      case 96: return launch_f32<96, 16, 64>(p, s);
      case 128: return launch_f32<128, 8, 32>(p, s);
      case 160: return launch_f32<160, 8, 32>(p, s);
      default: return cudaErrorInvalidValue;
    }
  }
  const void* ptrs[] = {q, k, v, o};
  const int64_t strides[] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                             v_sb, v_sh, v_sl, o_sb, o_sh, o_sl};
  if (dtype != 1 || !hopper::aligned(ptrs, 4, strides, 12, 8)) {
    return cudaErrorInvalidValue;
  }
  TcParams p{};
  if (!hopper::encode_bf16_rows(&p.q, q, B, H, Lq, Dh, q_sb, q_sh, q_sl,
                                kRows) ||
      !hopper::encode_bf16_rows(&p.k, k, B, H, Lk, Dh, k_sb, k_sh, k_sl,
                                tile_keys(Dh)) ||
      !hopper::encode_bf16_rows(&p.v, v, B, H, Lk, Dh, v_sb, v_sh, v_sl,
                                tile_keys(Dh))) {
    return cudaErrorInvalidValue;
  }
  p.o = o;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_sl = o_sl;
  p.lse = lse;
  p.key_mask = key_mask;
  p.mask_sb = mask_sb;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.scale = scale;
  switch (Dh) {
    case 64: return launch_tc<64>(p, B, s);
    case 80: return launch_tc<80>(p, B, s);
    case 96: return launch_tc<96>(p, B, s);
    case 128: return launch_tc<128>(p, B, s);
    case 160: return launch_tc<160>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
