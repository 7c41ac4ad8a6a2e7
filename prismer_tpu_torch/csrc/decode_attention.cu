// Beam-grouped decode cross-attention for Hopper (sm_90a): one kernel for
// two TPU kernels.
//
// Replaces prismer_tpu/ops/decode_attention.py:
//   * grouped_cross_attention_t (_grouped_t_kernel, the pallas_call at :210):
//     mode 0, "cross_t". Scores in fp32 from compute-dtype operands, times
//     1/sqrt(Dh); p = exp2((s - m) * log2(e)) against the row max m over all
//     L keys, l = the fp32 sum of the unrounded p; p rounded to the compute
//     dtype before an fp32-accumulated PV; then o / max(l, 1e-30), rounded.
//     The probabilities are NOT normalised before their rounding.
//   * grouped_decode_attention (_grouped_kernel, the pallas_call at :134):
//     mode 1, "decode". exp, fp32 p and an fp32 PV, the same division.
// The TPU kernel read K pre-transposed (B, H, Dh, L) and padded L to 128
// lanes with -1e9 keys; both were TPU workarounds. Here K and V are
// (B, H, L, Dh) views with any (batch, head, row) strides that TMA takes
// (the per-layer cache, or the prefill's head-split projections, uncopied)
// and L is unpadded, so no key is masked.
//
// What bounds it on the H100: bytes. A decode step's Q = beams (3) query
// rows, or the prefill's beams x prompt tokens (12), meet a sample's whole
// K/V: at Prismer-BASE batch 8 (H 12, L 964, Dh 64, bf16) 23.7 MB per call
// against 0.2 GFLOP, 7.1 us at 3.35 TB/s. The decode loop reads another
// layer's K/V on every call, so they come from HBM. Design:
//   * the keys of a (sample, head) are split over a thread-block cluster of
//     kSplit = 4 blocks: 384 blocks at BASE batch 8, 512 at LARGE and HUGE,
//     all resident at once. Block r owns keys [r * per, min(L, (r + 1) *
//     per)), per = ceil(L / kSplit); a block with no keys (L < kSplit)
//     takes part in every exchange with m = -inf, l = 0 and O = 0. Why 4
//     and not 8 (the portable maximum): each cluster barrier costs ~1 us
//     when ~100 clusters wait on theirs at once, and an earlier version of
//     this kernel ran 0-14 % slower with 8 at every model shape;
//   * loads: thread 0 issues TMA loads of the block's whole K slice in
//     tiles of 64 keys (128-byte swizzle), each tile on its own mbarrier,
//     all in flight at once. With one pass of 16 query rows (Q <= 16, every
//     model shape) V's tiles are loaded into K's room as soon as the scores
//     are taken, while the maxima are exchanged: half the shared memory, so
//     HUGE's 512 blocks run in one wave, and K arrives in half the time.
//     With several passes V is loaded beside K at the start and every pass
//     reuses both slices. Either way K and V are read from device memory
//     once. Keys of a tile past the block's range (the next block's, or
//     TMA's zero fill past L) get no score and p = 0;
//   * an exact global row max: each block reduces its rows' local maxima
//     into its own shared memory, the cluster synchronises, and every block
//     takes the max of the kSplit blocks' maxima through distributed shared
//     memory, so m is the single-block row max before any exponent and p
//     rounds at the same values as in the TPU kernel (a split that rounded
//     against a local max and rescaled after would round other values:
//     bf16(p) c != bf16(p c)). Nothing rescales a rounded p;
//   * products: bf16 S = Q K^T and, for cross_t, O += P V on tensor cores
//     (mma.sync m16n8k16, fp32 accumulation): Q padded to 16 rows, K read by
//     ldmatrix, P re-packed from the score accumulators as bf16 A fragments,
//     V read by ldmatrix.trans; each warp owns 16 keys of every tile, and
//     the kernel is instantiated for each tile count (1-8), whose scores
//     stay in registers (they bound the blocks per SM). Not wgmma: its
//     64-row minimum pads Q = 3 to 64 rows, 21x the products, in a kernel
//     that bytes bound. fp32 runs its products on FMA (no TF32:
//     the card-vs-CPU checks hold fp32 parity), and so does decode's PV,
//     whose p stays fp32 (each warp a quarter of the keys, each lane two
//     columns, four rows a sweep); decode's bf16 scores use the tensor cores
//     (bf16 products are exact in fp32);
//   * a deterministic combine, no atomics, no global scratch: each warp
//     stores column slice r of its partial O (kCols = 16 of the 64 columns)
//     and its row sums l into block r's shared memory (distributed shared
//     memory), the cluster synchronises, and block r sums the kSplit x 4
//     partials in (rank, warp) order, divides and writes its columns. Two
//     launches give the same bits. (Rank 0 combining all 64 columns cost a
//     third cluster barrier, to keep the peers resident while it read
//     them.)
// A pass waits on two cluster barriers. Stores into a peer precede the
// second, and reads of a peer follow the first and precede the second, so
// after the second no block's shared memory is touched by another and
// each block may exit (or start the next pass) on its own.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using hopper::smem_addr;
using prismer::from_f;
using prismer::mma_bf16;
using prismer::round_to;
using prismer::to_f;
using prismer::warp_max;
using prismer::warp_sum;

constexpr int kSplit = 4;        // blocks per cluster, each a key range
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;        // query rows per pass (one m16 tile)
constexpr int kTileKeys = 64;    // keys per TMA tile
constexpr int kDh = 64;
constexpr int kCols = kDh / kSplit;   // output columns each block combines
constexpr int kMaxTiles = 8;     // tiles per block
constexpr int kBlockBytes = kTileKeys * 128;   // one 128-byte column block
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kCols % 8 == 0, "a block's column slice is whole n8 tiles");

enum Mode { kCrossT = 0, kDecode = 1 };

// Byte offsets into a block's dynamic shared memory (after its 1024-byte
// alignment), for nt key tiles and `rows` = min(Q, 16) query rows per pass
// (rows4: rounded up to 4). ops/decode_attention.split_plan computes the
// same sizes.
//   k, v     nt tiles of 64 keys x 64 columns each (128-byte swizzle); with
//            one pass (Q <= 16) V takes K's place once the scores are in
//            registers or ss, so that a block needs half the room (one
//            wave of blocks at HUGE); with several passes both stay
//   qs       fp32 only: the pass's queries (rows x 64 fp32)
//   ss       FMA PV only: scores, then p (rows x nt*64 fp32)
//   small    per-warp row maxima ([4][16]); the block's maxima ([16]) and
//            sums ([16])
//   oslot    the cluster's partial O of this block's columns, by rank and
//            warp ([kSplit][4][rows][kCols])
//   lslot    the cluster's row sums, by rank and warp ([kSplit][4][rows4])
//   bars     one mbarrier per K tile, then one per V tile
struct Layout {
  int nt, rows, rows4;
  uint32_t k, v, qs, ss, small, oslot, lslot, bars, bytes;
};

Layout make_layout(int nt, int Q, int elt, bool tc_pv) {
  Layout s{};
  const bool one_pass = Q <= kRows;
  const int rows = one_pass ? Q : kRows;
  s.nt = nt;
  s.rows = rows;
  s.rows4 = (rows + 3) / 4 * 4;
  const uint32_t tile = kTileKeys * kDh * elt;
  s.k = 0;
  s.v = one_pass ? 0 : nt * tile;
  s.qs = (one_pass ? 1 : 2) * nt * tile;
  s.ss = s.qs + (elt == 4 ? rows * kDh * 4 : 0);
  s.small = s.ss + (tc_pv ? 0 : rows * nt * kTileKeys * 4);
  s.oslot = s.small + (kWarps * kRows + 2 * kRows) * 4;
  s.lslot = s.oslot + kSplit * kWarps * rows * kCols * 4;
  s.bars = s.lslot + kSplit * kWarps * s.rows4 * 4;
  s.bytes = s.bars + 2 * nt * 8 + 1024;   // + the alignment slack
  return s;
}

struct Params {
  CUtensorMap k, v;   // rank 4 (Dh, L, H, B); boxes of 128 bytes x 64 rows
  const void* q;      // (B, H, Q, Dh), contiguous
  void* out;          // (B, H, Q, Dh), contiguous
  int H, Q, L, per;   // per: keys per block, ceil(L / kSplit)
  float scale;
  Layout lay;
};

// a block's view of its shared memory
struct Smem {
  uint8_t* base;
  float* wred;      // [4][16] per-warp maxima
  float* bmax;      // [16]
  float* bl;        // [16]
  float* oslot;     // [kSplit][4][rows][kCols]
  float* lslot;     // [kSplit][4][rows4]
  uint64_t* ktiles;  // [nt]
  uint64_t* vtiles;  // [nt]
};

__device__ __forceinline__ Smem carve(uint8_t* sm, const Layout& lay) {
  Smem s;
  s.base = sm;
  s.wred = reinterpret_cast<float*>(sm + lay.small);
  s.bmax = s.wred + kWarps * kRows;
  s.bl = s.bmax + kRows;
  s.oslot = reinterpret_cast<float*>(sm + lay.oslot);
  s.lslot = reinterpret_cast<float*>(sm + lay.lslot);
  s.ktiles = reinterpret_cast<uint64_t*>(sm + lay.bars);
  s.vtiles = s.ktiles + lay.nt;
  return s;
}

// element (r, c) of a 64-row tile of T, stored as column blocks of 128
// bytes ([block][row][128 bytes]) in the 128-byte swizzle
template <typename T>
__device__ __forceinline__ const T* tile_at(const uint8_t* tile, int r,
                                            int c) {
  constexpr int kPerChunk = 16 / sizeof(T);
  constexpr int kPerBlock = 128 / sizeof(T);
  const int chunk = (c % kPerBlock) / kPerChunk;
  return reinterpret_cast<const T*>(
      tile + (c / kPerBlock) * kBlockBytes + r * 128 +
      ((chunk ^ (r & 7)) << 4) + (c % kPerChunk) * sizeof(T));
}

// Thread 0: TMA loads of this block's K (kv 0) or V (kv 1) tiles, each
// tile of 64 keys on its own mbarrier.
template <typename T>
__device__ __forceinline__ void issue_tiles(const Params& p, const Smem& sm,
                                            int kv, int ntb) {
  constexpr int kTile = kTileKeys * kDh * sizeof(T);
  const int start = min(p.L, static_cast<int>(blockIdx.x) * p.per);
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  for (int t = 0; t < ntb; ++t) {
    uint64_t* bar = (kv == 0 ? sm.ktiles : sm.vtiles) + t;
    uint8_t* dst = sm.base + (kv == 0 ? p.lay.k : p.lay.v) + t * kTile;
    hopper::mbar_arrive_expect_tx(bar, kTile);
    for (int cb = 0; cb < kTile / kBlockBytes; ++cb) {
      hopper::tma_load_4d(dst + cb * kBlockBytes, kv == 0 ? &p.k : &p.v, bar,
                          cb * (128 / static_cast<int>(sizeof(T))),
                          start + t * kTileKeys, h, b);
    }
  }
}

// the A fragments of query rows q0 + gid and q0 + gid + 8 (zero past Q)
// for the four 16-column k-steps over Dh, read from device memory
__device__ __forceinline__ void load_q_frags(const __nv_bfloat16* qb, int q0,
                                             int nq, int lane,
                                             uint32_t (&qa)[4][4]) {
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(
      qb + static_cast<size_t>(q0 + gid) * kDh);
  const uint32_t* r8 = r0 + 8 * kDh / 2;
  const bool lo = gid < nq, hi = gid + 8 < nq;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qa[kk][0] = lo ? r0[8 * kk + tig] : 0u;
    qa[kk][1] = hi ? r8[8 * kk + tig] : 0u;
    qa[kk][2] = lo ? r0[8 * kk + 4 + tig] : 0u;
    qa[kk][3] = hi ? r8[8 * kk + 4 + tig] : 0u;
  }
}

// this warp's scores against keys 16w .. 16w + 15 of a bf16 K tile:
// acc[j] is the m16n8 accumulator of keys 16w + 8j .. + 7 (unscaled)
__device__ __forceinline__ void score_tile(uint32_t ktile, int warp, int lane,
                                           const uint32_t (&qa)[4][4],
                                           float (&acc)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const int row = 16 * warp + 8 * j + (lane & 7);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int chunk = 4 * half + (lane >> 3);
      uint32_t b[4];
      hopper::ldsm_x4(ktile + row * 128 + ((chunk ^ (row & 7)) << 4), b);
      const uint32_t* a0 = qa[2 * half];
      const uint32_t* a1 = qa[2 * half + 1];
      mma_bf16(acc[j], a0[0], a0[1], a0[2], a0[3], b[0], b[1]);
      mma_bf16(acc[j], a1[0], a1[1], a1[2], a1[3], b[2], b[3]);
    }
  }
}

// The exact row max of the cluster: every block's maxima (bmax) are
// complete in its shared memory; the cluster synchronises and each block
// takes the max of the kSplit blocks' maxima through distributed shared
// memory (rows < nq are meaningful).
__device__ __forceinline__ float cluster_max(cg::cluster_group& cluster,
                                             float* bmax, int row) {
  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < kSplit; ++r) {
    m = fmaxf(m, cluster.map_shared_rank(bmax, r)[row]);
  }
  return m;
}

// A warp's partial O in mma.sync accumulator layout (o[j]: columns 8j ..
// 8j + 7, rows gid and gid + 8) and its row sums l (rows gid, gid + 8):
// column slice r goes into block r's oslot, the sums into every block's
// lslot (distributed shared memory), at this block's rank and this warp.
__device__ __forceinline__ void send_slices(cg::cluster_group& cluster,
                                            const Layout& lay, const Smem& s,
                                            int rank, int nq, int warp,
                                            int lane, const float (&o)[8][4],
                                            const float (&l)[2]) {
  const int gid = lane >> 2, tig = lane & 3;
  constexpr int kTilesPer = kCols / 8;   // n8 tiles per slice
  const int from = rank * kWarps + warp;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int dst = j / kTilesPer;
    const int col = (j % kTilesPer) * 8 + 2 * tig;
    float* oslot = cluster.map_shared_rank(s.oslot, dst);
    float* lslot = cluster.map_shared_rank(s.lslot, dst);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = gid + 8 * half;
      if (r < nq) {
        *reinterpret_cast<float2*>(oslot + (from * lay.rows + r) * kCols +
                                   col) =
            make_float2(o[j][2 * half], o[j][2 * half + 1]);
        if (tig == 0 && j % kTilesPer == 0) {
          lslot[from * lay.rows4 + r] = l[half];
        }
      }
    }
  }
}

// One pass of bf16 cross_t, all on tensor cores: S for the block's tiles
// kept in registers (KT >= the block's tiles), the exact cluster max, p
// rounded into A fragments, O += P V; each warp sends its partial. Tiles
// past the block's own are computed on tile 0 and masked (p = 0), so that
// the unrolled products of all KT tiles interleave.
template <int KT>
__device__ __forceinline__ void pass_tc(cg::cluster_group& cluster,
                                        const Params& p, const Smem& sm,
                                        int rank, const __nv_bfloat16* qb,
                                        int q0, int nq, int cnt, int ntb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const Layout& lay = p.lay;
  const uint32_t base = smem_addr(sm.base);

  uint32_t qa[4][4];
  load_q_frags(qb, q0, nq, lane, qa);
  float s[KT][2][4];
  float mx[2] = {-INFINITY, -INFINITY};
  for (int t = 0; t < ntb; ++t) hopper::mbar_wait(sm.ktiles + t, 0);
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    score_tile(base + lay.k + (t < ntb ? t : 0) * kTileKeys * kDh * 2, warp,
               lane, qa, s[t]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * kTileKeys + 16 * warp + 8 * j + 2 * tig + (e & 1);
        s[t][j][e] = key < cnt ? s[t][j][e] * p.scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[t][j][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  if (tig == 0) {
    sm.wred[warp * kRows + gid] = mx[0];
    sm.wred[warp * kRows + gid + 8] = mx[1];
  }
  __syncthreads();   // K is read: with one pass, V may take its place
  if (threadIdx.x == 0 && p.Q <= kRows) {
    issue_tiles<__nv_bfloat16>(p, sm, 1, ntb);
  }
  if (threadIdx.x < kRows) {
    float m = sm.wred[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      m = fmaxf(m, sm.wred[w * kRows + threadIdx.x]);
    }
    sm.bmax[threadIdx.x] = m;
  }
  cluster.sync();   // every block's maxima are in its shared memory

  // rows past Q (zero queries) take m = 0: finite, and never written
  const float m[2] = {gid < nq ? cluster_max(cluster, sm.bmax, gid) : 0.f,
                      gid + 8 < nq ? cluster_max(cluster, sm.bmax, gid + 8)
                                   : 0.f};
  float l[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
  // an empty block's tile 0 holds no data: it sends zeros
  if (ntb > 0) {
    for (int t = 0; t < ntb; ++t) hopper::mbar_wait(sm.vtiles + t, 0);
    const int key = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      float pr[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pr[j][e] = exp2f((s[t][j][e] - m[e >> 1]) * kLog2e);  // -inf: 0
          l[e >> 1] += pr[j][e];
        }
      }
      // A fragment of this warp's 16 keys: p rounded to bf16
      const uint32_t pa[4] = {hopper::pack_bf16(pr[0][0], pr[0][1]),
                              hopper::pack_bf16(pr[0][2], pr[0][3]),
                              hopper::pack_bf16(pr[1][0], pr[1][1]),
                              hopper::pack_bf16(pr[1][2], pr[1][3])};
      const uint32_t vtile =
          base + lay.v + (t < ntb ? t : 0) * kTileKeys * kDh * 2;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int chunk = 2 * jj + (lane >> 4);
        uint32_t b[4];
        hopper::ldsm_x4_trans(vtile + key * 128 + ((chunk ^ (key & 7)) << 4),
                              b);
        mma_bf16(o[2 * jj], pa[0], pa[1], pa[2], pa[3], b[0], b[1]);
        mma_bf16(o[2 * jj + 1], pa[0], pa[1], pa[2], pa[3], b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  send_slices(cluster, lay, sm, rank, nq, warp, lane, o, l);
}

// One pass with an FMA PV (fp32 both modes, bf16 decode): scaled scores
// into ss (bf16 on tensor cores, fp32 on FMA), the exact cluster max, p in
// place (rounded to T for cross_t), then O = P V by FMA, each warp a
// quarter of the keys and each lane two columns; each warp sends its
// partial, and warp 0 the row sums.
template <typename T, int MODE>
__device__ __forceinline__ void pass_fma(cg::cluster_group& cluster,
                                         const Params& p, const Smem& sm,
                                         int rank, const T* qb, int q0,
                                         int nq, int cnt, int ntb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Layout& lay = p.lay;
  const int ld = lay.nt * kTileKeys;   // ss row stride
  float* ss = reinterpret_cast<float*>(sm.base + lay.ss);
  constexpr int kTile = kTileKeys * kDh * sizeof(T);

  if constexpr (sizeof(T) == 2) {
    const int gid = lane >> 2, tig = lane & 3;
    uint32_t qa[4][4];
    load_q_frags(qb, q0, nq, lane, qa);
    const uint32_t base = smem_addr(sm.base);
    for (int t = 0; t < ntb; ++t) {
      hopper::mbar_wait(sm.ktiles + t, 0);
      float acc[2][4];
      score_tile(base + lay.k + t * kTile, warp, lane, qa, acc);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = t * kTileKeys + 16 * warp + 8 * j + 2 * tig;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = gid + 8 * half;
          if (r < nq) {
            *reinterpret_cast<float2*>(ss + r * ld + key) =
                make_float2(acc[j][2 * half] * p.scale,
                            acc[j][2 * half + 1] * p.scale);
          }
        }
      }
    }
  } else {
    float* qs = reinterpret_cast<float*>(sm.base + lay.qs);
    for (int e = threadIdx.x; e < nq * kDh / 4; e += kThreads) {
      reinterpret_cast<float4*>(qs)[e] = reinterpret_cast<const float4*>(
          qb + static_cast<size_t>(q0) * kDh)[e];
    }
    __syncthreads();
    for (int t = 0; t < ntb; ++t) hopper::mbar_wait(sm.ktiles + t, 0);
    for (int key = threadIdx.x; key < cnt; key += kThreads) {
      const uint8_t* tile = sm.base + lay.k + (key / kTileKeys) * kTile;
      const int r = key % kTileKeys;
      float kr[kDh];
#pragma unroll
      for (int c = 0; c < kDh; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(
            tile_at<float>(tile, r, c));
        kr[c] = x.x;
        kr[c + 1] = x.y;
        kr[c + 2] = x.z;
        kr[c + 3] = x.w;
      }
      for (int row = 0; row < nq; ++row) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < kDh; c += 4) {
          const float4 qq =
              *reinterpret_cast<const float4*>(qs + row * kDh + c);
          acc = fmaf(qq.x, kr[c], acc);
          acc = fmaf(qq.y, kr[c + 1], acc);
          acc = fmaf(qq.z, kr[c + 2], acc);
          acc = fmaf(qq.w, kr[c + 3], acc);
        }
        ss[row * ld + key] = acc * p.scale;
      }
    }
  }
  __syncthreads();   // K is read: with one pass, V may take its place
  if (threadIdx.x == 0 && p.Q <= kRows) issue_tiles<T>(p, sm, 1, ntb);

  // the block's row maxima, one warp per row
  for (int r = warp; r < nq; r += kWarps) {
    float m = -INFINITY;
    for (int key = lane; key < cnt; key += 32) m = fmaxf(m, ss[r * ld + key]);
    m = warp_max(m);
    if (lane == 0) sm.bmax[r] = m;
  }
  cluster.sync();   // every block's maxima are in its shared memory

  for (int r = warp; r < nq; r += kWarps) {
    const float m = cluster_max(cluster, sm.bmax, r);
    float sum = 0.f;
    for (int key = lane; key < cnt; key += 32) {
      const float x = ss[r * ld + key];
      const float e = MODE == kCrossT ? exp2f((x - m) * kLog2e) : expf(x - m);
      sum += e;
      ss[r * ld + key] = MODE == kCrossT ? round_to<T>(e) : e;
    }
    sum = warp_sum(sum);
    if (lane == 0) sm.bl[r] = sum;
  }
  __syncthreads();

  // warp w: keys w, w + 4, ... in order; lane: columns 2 lane, 2 lane + 1
  for (int t = 0; t < ntb; ++t) hopper::mbar_wait(sm.vtiles + t, 0);
  const int c = 2 * lane;
  float* oslot = cluster.map_shared_rank(sm.oslot, c / kCols);
  const int from = rank * kWarps + warp;
  constexpr int kGroup = 4;   // rows per sweep over the keys
  for (int r0 = 0; r0 < nq; r0 += kGroup) {
    float2 acc[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc[i] = make_float2(0.f, 0.f);
    for (int key = warp; key < cnt; key += kWarps) {
      const T* vp = tile_at<T>(sm.base + lay.v + (key / kTileKeys) * kTile,
                               key % kTileKeys, c);
      const float v0 = to_f(vp[0]), v1 = to_f(vp[1]);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (r0 + i < nq) {
          const float pr = ss[(r0 + i) * ld + key];
          acc[i].x = fmaf(pr, v0, acc[i].x);
          acc[i].y = fmaf(pr, v1, acc[i].y);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (r0 + i < nq) {
        *reinterpret_cast<float2*>(oslot + (from * lay.rows + r0 + i) *
                                   kCols + c % kCols) = acc[i];
      }
    }
  }
  // the row sums, to every block (warp 0's slot; the others' stay unread)
  if (warp == 0) {
    for (int e = lane; e < kSplit * nq; e += 32) {
      const int to = e / nq, r = e % nq;
      cluster.map_shared_rank(sm.lslot, to)[rank * kWarps * lay.rows4 + r] =
          sm.bl[r];
    }
  }
}

// grid (kSplit, B * H), clusters of kSplit blocks along x: block r of the
// cluster of (sample, head) bh owns keys [r * per, min(L, (r + 1) * per))
// and writes output columns [r * kCols, (r + 1) * kCols)
template <typename T, int MODE, int KT>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
grouped_attn_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Layout& lay = p.lay;
  const Smem sm = carve(hopper::align_1024(smem_raw), lay);
  const int rank = blockIdx.x;   // the block's rank in its cluster
  const int bh = blockIdx.y;
  const int start = min(p.L, rank * p.per);
  const int cnt = min(p.L, start + p.per) - start;
  const int ntb = (cnt + kTileKeys - 1) / kTileKeys;

  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    for (int t = 0; t < ntb; ++t) {
      hopper::mbar_init(sm.ktiles + t, 1);
      hopper::mbar_init(sm.vtiles + t, 1);
    }
    hopper::mbar_init_fence();
    issue_tiles<T>(p, sm, 0, ntb);   // every K tile, then (several passes)
    if (p.Q > kRows) issue_tiles<T>(p, sm, 1, ntb);   // every V tile
  }
  __syncthreads();

  const T* qb = static_cast<const T*>(p.q) +
                static_cast<size_t>(bh) * p.Q * kDh;
  T* ob = static_cast<T*>(p.out) + static_cast<size_t>(bh) * p.Q * kDh;
  for (int q0 = 0; q0 < p.Q; q0 += kRows) {
    const int nq = min(kRows, p.Q - q0);
    if constexpr (sizeof(T) == 2 && MODE == kCrossT) {
      pass_tc<KT>(cluster, p, sm, rank, qb, q0, nq, cnt, ntb);
    } else {
      pass_fma<T, MODE>(cluster, p, sm, rank, qb, q0, nq, cnt, ntb);
    }
    // every block's slices and sums are in place, and every read of a
    // peer's maxima is done: no block's shared memory is touched by
    // another after this, so a block may go once it has combined
    cluster.sync();
    // this block's columns: the kSplit blocks' warps' partials in (rank,
    // warp) order; the row sums of every warp (tensor-core PV) or warp 0
    constexpr int kSums = sizeof(T) == 2 && MODE == kCrossT ? kWarps : 1;
    for (int e = threadIdx.x; e < nq * kCols; e += kThreads) {
      const int r = e / kCols, c = e % kCols;
      float o = 0.f, l = 0.f;
#pragma unroll
      for (int s = 0; s < kSplit; ++s) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          o += sm.oslot[((s * kWarps + w) * lay.rows + r) * kCols + c];
          if (w < kSums) l += sm.lslot[(s * kWarps + w) * lay.rows4 + r];
        }
      }
      ob[static_cast<size_t>(q0 + r) * kDh + rank * kCols + c] =
          from_f<T>(o / fmaxf(l, 1e-30f));
    }
  }
}

template <typename T, int MODE, int KT>
cudaError_t launch(const Params& p, int BH, cudaStream_t st) {
  static hopper::SmemGrant granted;
  const cudaError_t err =
      granted.ensure(grouped_attn_kernel<T, MODE, KT>, hopper::kMaxSmem);
  if (err != cudaSuccess) return err;
  grouped_attn_kernel<T, MODE, KT>
      <<<dim3(kSplit, BH), kThreads, p.lay.bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q and out (B, H, Q, Dh) contiguous; k and v (B, H, L, Dh) with element
// strides (sb, sh, sl, 1); all of dtype 0 (fp32) or 1 (bf16), 16-byte
// aligned, every stride a multiple of 16 bytes (TMA); Dh 64, 1 <= Q <= 64,
// B * H <= 65535, L <= 8 * kMaxTiles * 64 and the block's shared memory
// within 227 KB; mode 0 "cross_t" (kernel 11's rounding) or 1 "decode"
// (kernel 12's). Returns a cudaError_t (0 on success).
extern "C" int prismer_grouped_attention(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Q, int L, int Dh, int64_t k_sb, int64_t k_sh, int64_t k_sl,
    int64_t v_sb, int64_t v_sh, int64_t v_sl, int mode, int dtype,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || B * H > 65535 || Q <= 0 || Q > 64 || L <= 0 ||
      Dh != kDh || (mode != kCrossT && mode != kDecode) ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  const int elt = dtype == 1 ? 2 : 4;
  const void* ptrs[] = {q, k, v, out};
  const int64_t strides[] = {k_sb, k_sh, k_sl, v_sb, v_sh, v_sl};
  if (!hopper::aligned(ptrs, 4, strides, 6, 16 / elt)) {
    return cudaErrorInvalidValue;
  }
  Params p{};
  p.per = (L + kSplit - 1) / kSplit;
  const int nt = (p.per + kTileKeys - 1) / kTileKeys;
  const bool tc_pv = dtype == 1 && mode == kCrossT;
  p.lay = make_layout(nt, Q, elt, tc_pv);
  if (nt > kMaxTiles || p.lay.bytes > hopper::kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  const auto encode = dtype == 1 ? hopper::encode_bf16_rows
                                 : hopper::encode_f32_rows;
  if (!encode(&p.k, k, B, H, L, Dh, k_sb, k_sh, k_sl, kTileKeys) ||
      !encode(&p.v, v, B, H, L, Dh, v_sb, v_sh, v_sl, kTileKeys)) {
    return cudaErrorInvalidValue;
  }
  p.q = q;
  p.out = out;
  p.H = H;
  p.Q = Q;
  p.L = L;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = B * H;
  if (dtype == 0) {
    return mode == kCrossT ? launch<float, kCrossT, 1>(p, bh, st)
                           : launch<float, kDecode, 1>(p, bh, st);
  }
  using bf16 = __nv_bfloat16;
  if (mode == kDecode) return launch<bf16, kDecode, 1>(p, bh, st);
  // the block's tiles exactly: registers (the scores of KT tiles) bound
  // the blocks per SM
  switch (nt) {
    case 1: return launch<bf16, kCrossT, 1>(p, bh, st);
    case 2: return launch<bf16, kCrossT, 2>(p, bh, st);
    case 3: return launch<bf16, kCrossT, 3>(p, bh, st);
    case 4: return launch<bf16, kCrossT, 4>(p, bh, st);
    case 5: return launch<bf16, kCrossT, 5>(p, bh, st);
    case 6: return launch<bf16, kCrossT, 6>(p, bh, st);
    case 7: return launch<bf16, kCrossT, 7>(p, bh, st);
    default: return launch<bf16, kCrossT, 8>(p, bh, st);
  }
}
