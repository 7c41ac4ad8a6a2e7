// Flash attention backward for Hopper (sm_90a): a dq kernel and a dk/dv
// kernel, each in a bf16 tensor-core version and an fp32 FMA version.
//
// Replaces prismer_tpu/ops/flash_attention.py _flash_backward: the dq
// pallas_call (_bwd_dq_kernel, :457) and the dk/dv pallas_call
// (_bwd_dkv_kernel, :483). Both the head-split (B, H, L, Dh) attention and
// the packed (B, L, H*Dh) one reach them: a packed tensor is a strided view
// of (B, H, L, Dh), so the kernels take per-tensor (batch, head, row)
// strides and JAX's transposes in _packed_bwd (:709) are not carried over,
// nor are the padding of L to block multiples and the 8-lane lse / delta
// broadcast (:440-454).
//
// Math (Dao et al., as the TPU kernels do it), with the forward's lse and
// delta = rowsum(dO * O) in fp32:
//   s  = (q . k) * scale, masked keys and keys above the bottom-right causal
//        diagonal (col > row + Lk - Lq) replaced by the finite -1e9 fill
//   p  = exp(s - lse)                  (a fully masked row gets the same p
//                                       for every key, as in the forward)
//   dp = dO . v,   ds = p * (dp - delta)
//   dv = sum_q round(p) dO,  dk = sum_q round(ds) q * scale,
//   dq = sum_k round(ds) k * scale
// where round() casts to the input dtype (the identity in fp32) and every
// product accumulates in fp32; outputs are cast to the input dtype.
//
// Ownership (no float atomics, so two runs are bit-identical): a dk/dv
// block owns 64 keys of one (batch, head) and streams query tiles; a dq
// block owns 64 queries and streams key tiles. Every tile is visited, also
// above the causal diagonal (at the decoder's L <= 30 there is one tile
// anyway), which keeps a fully masked row's gradient equal to the formula.
//
// What bounds it on the H100: at the ViT trunk's shape (B=4, L=964, H=12,
// Dh=64) the pair does 14 x B*H*L*L*Dh = 40 GFLOP against ~10 MB of
// operands, so it is compute-bound (0.040 ms at 989 TFLOP/s), and only the
// tensor cores reach that rate.
//
// bf16 (the training path): wgmma products on TMA-fed tiles. A block is one
// consumer warpgroup (128 threads) and one producer warp.
//   * The producer's lane 0 loads the owned tile once (k, v for dk/dv; q,
//     dO for dq) and keeps the streamed tiles (q, dO; or k, v) in flight in
//     a ring of 2-3 stages, by TMA (cp.async.bulk.tensor) on rank-4 tensor
//     maps (Dh, L, H, B) built on the host from the wrapper's strides, as
//     bf16 in the 128-byte swizzle the wgmma descriptors read (hopper.cuh).
//     TMA's zero fill covers rows past L and, at Dh 80, 96 and 160, the
//     columns of the last 64-column block past Dh. The warp's lanes stage
//     the tile's per-row values (lse and delta by query, or the keys' mask
//     flags) beside it; an mbarrier per stage completes on the bytes and
//     the 32 arrivals, and another per stage hands the stage back.
//   * dk/dv: with keys as the 64 rows, S^T = K Q^T and dP^T = V dO^T come
//     out of two shared-memory products (K-major operands) in the
//     accumulator layout, so P^T and dS^T are formed, rounded to bf16 and
//     re-packed in registers as the A operand of dV += P^T dO and
//     dK += dS^T Q, whose B (dO, Q) is read MN-major from the same stage.
//     lse and delta are per query: they index columns here.
//   * dq: S = Q K^T and dP = dO V^T, then dQ += dS K with dS from
//     registers and K read MN-major.
//   * dk, dv and dq accumulate in registers for the whole stream: DH fp32
//     values per thread for dk/dv, so above Dh 96 the query stream is 32
//     rows wide (the scores take BQ more); the key stream of dq is 64.
// What bounds this design: one consumer warpgroup per block serialises
// each tile's products and its exp / mask work (two blocks per SM overlap
// them); every score is exponentiated twice, once per kernel. At the trunk
// shape on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// check_flash_backward): dq 0.138 ms, dk/dv 0.154 ms, 137 TFLOP/s for the
// pair, against bounds of 0.017 / 0.023 ms and 0.733 / 0.886 ms for the
// FMA kernels these replaced; the other shapes are in PERF.md section 6.
//
// fp32 (the card-vs-CPU parity checks): FMA tiles, since the tensor cores
// have no full-fp32 product. Tiles sit in shared memory as fp32 rows padded
// by 4 floats, so 16-byte reads of eight consecutive rows hit distinct
// banks; each thread keeps a 4 x 4 block of scores (and of dp) or a 4-row
// slice of its block's dq / dk / dv in registers. A dk/dv block owns 64
// keys (32 above Dh 128, so that the 2 x rows x Dh / 8 accumulators stay in
// registers) and streams 32-row query tiles; a dq block owns 64 queries and
// streams 32-key tiles. A thread's output columns are 4-wide slices 32
// apart; where Dh is not a multiple of 32 (80) the last slice of some
// threads lies past Dh and is skipped.
//
// Head dims: 64, 80, 96, 128 and 160 (every one of the model registry's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kMaskFill = -1.0e9f;   // flash_attention.py:54 NEG_INF
constexpr float kLog2e = 1.4426950408889634f;


// ---------------------------------------------------------------------------
// fp32: FMA tiles
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kOwn = 64;      // rows a block owns (keys for dk/dv, queries for dq)
constexpr int kStream = 32;   // rows streamed per step

// tensors: 0 q, 1 k, 2 v, 3 dout, 4 dq, 5 dk, 6 dv; strides (batch, head, row)
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, H, Lq) contiguous
  const float* delta;   // (B, H, Lq) contiguous
  const int* key_mask;  // (B, Lk) with row stride mask_sb, or null
  void* dq;
  void* dk;
  void* dv;
  int B, H, Lq, Lk;
  int64_t st[7][3];
  int64_t mask_sb;
  int causal;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [row0, row0 + ROWS) of a (L, DH) slab with row stride sl into shared
// memory (row stride DH + 4); rows past L are zeros
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(const float* base, int64_t sl,
                                          int row0, int L, float* dst) {
  constexpr int C4 = DH / 4;
  for (int e = threadIdx.x; e < ROWS * C4; e += kThreads) {
    const int r = e / C4;
    const int c = (e - r * C4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L) val = load4(base + static_cast<int64_t>(row0 + r) * sl + c);
    store4(dst + r * (DH + 4) + c, val);
  }
}

// 1 keep, 0 masked (-1e9), -1 past Lk (no part in anything)
__device__ __forceinline__ int key_flag(const int* key_mask, int64_t mask_sb,
                                        int Lk, int b, int col) {
  if (col >= Lk) return -1;
  if (key_mask != nullptr && key_mask[b * mask_sb + col] == 0) return 0;
  return 1;
}

__device__ __forceinline__ void load_valid(const Params& p, int b, int k0,
                                           int n, int* valid) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    valid[r] = key_flag(p.key_mask, p.mask_sb, p.Lk, b, k0 + r);
  }
}

// s[r][c] = q_i . k_j and dp[r][c] = dO_i . v_j for the query rows
// i = 4 * ty + r of qs / dos and the key rows j = tx + (C / NCOL) * c of
// ks / vs (all fp32, row stride DH + 4). Eight consecutive tx read eight
// consecutive key rows: distinct banks.
template <int DH, int C, int NCOL>
__device__ __forceinline__ void score_tile(const float* qs, const float* dos,
                                           const float* ks, const float* vs,
                                           int ty, int tx,
                                           float (&s)[4][NCOL],
                                           float (&dp)[4][NCOL]) {
  constexpr int LD = DH + 4;
  constexpr int CS = C / NCOL;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < NCOL; ++c) s[r][c] = dp[r][c] = 0.f;
  }
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], b[NCOL];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = load4(qs + (4 * ty + r) * LD + d);
#pragma unroll
    for (int c = 0; c < NCOL; ++c) b[c] = load4(ks + (tx + CS * c) * LD + d);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < NCOL; ++c) s[r][c] = dot4(a[r], b[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = load4(dos + (4 * ty + r) * LD + d);
#pragma unroll
    for (int c = 0; c < NCOL; ++c) b[c] = load4(vs + (tx + CS * c) * LD + d);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < NCOL; ++c) dp[r][c] = dot4(a[r], b[c], dp[r][c]);
    }
  }
}

// whether a thread's 4-wide output slice at column d lies inside the head
template <int DH>
__device__ __forceinline__ bool in_head(int d) {
  return DH % 32 == 0 || d < DH;
}

// p and ds of one score: s the unscaled q . k, i / j global row / column,
// f the key's flag; zero for rows past Lq and keys past Lk
__device__ __forceinline__ void prob_grad(float s, float dp, int i, int j,
                                          int f, float lse, float delta,
                                          int Lq, int Lk, int causal,
                                          float scale, float* pr, float* ds) {
  *pr = 0.f;
  *ds = 0.f;
  if (i >= Lq || f < 0) return;
  float x = s * scale;
  if (f == 0 || (causal && j > i + (Lk - Lq))) x = kMaskFill;
  const float e = exp2f((x - lse) * kLog2e);
  *pr = e;
  *ds = e * (dp - delta);
}

__device__ __forceinline__ const float* slab(const void* base,
                                             const Params& p, int t, int b,
                                             int h) {
  return static_cast<const float*>(base) + b * p.st[t][0] + h * p.st[t][1];
}

// dk / dv: grid (ceil(Lk / OWN), H, B), OWN = 64 keys per block (32 above
// Dh 128)
template <int DH, int OWN>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const Params p) {
  constexpr int LD = DH + 4;
  constexpr int BK = OWN, BQ = kStream;
  constexpr int LP = BK + 4;   // row stride of the p / ds tiles
  constexpr int NC = (DH + 31) / 32;  // 4-column chunks per thread in dk / dv
  constexpr int RPT = BK / 16;        // key rows per thread in dk / dv
  constexpr int NCOL = BK / 16;       // key columns per thread in the scores
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;              // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* qs = vs + BK * LD;      // [BQ][LD]
  float* dos = qs + BQ * LD;     // [BQ][LD]
  float* ps = dos + BQ * LD;     // [BQ][LP] p
  float* dss = ps + BQ * LP;     // [BQ][LP] ds
  float* lse_s = dss + BQ * LP;  // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]
  int* valid = reinterpret_cast<int*>(delta_s + BQ);  // [BK]

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const float* qb = slab(p.q, p, 0, b, h);
  const float* kb = slab(p.k, p, 1, b, h);
  const float* vb = slab(p.v, p, 2, b, h);
  const float* db = slab(p.dout, p, 3, b, h);
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.Lq;

  load_tile<DH, BK>(kb, p.st[1][2], k0, p.Lk, ks);
  load_tile<DH, BK>(vb, p.st[2][2], k0, p.Lk, vs);
  load_valid(p, b, k0, BK, valid);

  // scores: 32 x BK tile, 8 x 16 threads; dk / dv: BK x DH, 16 x 8 threads
  const int a_ty = tid / 16, a_tx = tid % 16;
  const int b_ty = tid / 8, b_tx = tid % 8;
  float dk[RPT][NC][4], dv[RPT][NC][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[r][c][e] = dv[r][c][e] = 0.f;
    }
  }

  for (int q0 = 0; q0 < p.Lq; q0 += BQ) {
    __syncthreads();  // the previous query tile is consumed
    load_tile<DH, BQ>(qb, p.st[0][2], q0, p.Lq, qs);
    load_tile<DH, BQ>(db, p.st[3][2], q0, p.Lq, dos);
    for (int r = tid; r < BQ; r += kThreads) {
      const bool in = q0 + r < p.Lq;
      lse_s[r] = in ? p.lse[row_stats + q0 + r] : 0.f;
      delta_s[r] = in ? p.delta[row_stats + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[4][NCOL], dp[4][NCOL];
    score_tile<DH, BK, NCOL>(qs, dos, ks, vs, a_ty, a_tx, s, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = 4 * a_ty + r;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int jl = a_tx + 16 * c;
        prob_grad(s[r][c], dp[r][c], q0 + il, k0 + jl, valid[jl], lse_s[il],
                  delta_s[il], p.Lq, p.Lk, p.causal, p.scale,
                  &ps[il * LP + jl], &dss[il * LP + jl]);
      }
    }
    __syncthreads();

    // dv[j] += p[i][j] dO[i], dk[j] += ds[i][j] q[i] for this thread's rows
    // j = RPT * b_ty + r and columns 4 * b_tx + 32 * c
    for (int il = 0; il < BQ; ++il) {
      float pr[RPT], dr[RPT];
#pragma unroll
      for (int r = 0; r < RPT; r += 2) {
        const float2 pv = *reinterpret_cast<const float2*>(
            ps + il * LP + RPT * b_ty + r);
        const float2 dsv = *reinterpret_cast<const float2*>(
            dss + il * LP + RPT * b_ty + r);
        pr[r] = pv.x;
        pr[r + 1] = pv.y;
        dr[r] = dsv.x;
        dr[r + 1] = dsv.y;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (!in_head<DH>(4 * b_tx + 32 * c)) continue;
        const float4 o4 = load4(dos + il * LD + 4 * b_tx + 32 * c);
        const float4 q4 = load4(qs + il * LD + 4 * b_tx + 32 * c);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          dv[r][c][0] = fmaf(pr[r], o4.x, dv[r][c][0]);
          dv[r][c][1] = fmaf(pr[r], o4.y, dv[r][c][1]);
          dv[r][c][2] = fmaf(pr[r], o4.z, dv[r][c][2]);
          dv[r][c][3] = fmaf(pr[r], o4.w, dv[r][c][3]);
          dk[r][c][0] = fmaf(dr[r], q4.x, dk[r][c][0]);
          dk[r][c][1] = fmaf(dr[r], q4.y, dk[r][c][1]);
          dk[r][c][2] = fmaf(dr[r], q4.z, dk[r][c][2]);
          dk[r][c][3] = fmaf(dr[r], q4.w, dk[r][c][3]);
        }
      }
    }
  }

  float* dkb = static_cast<float*>(p.dk) + b * p.st[5][0] + h * p.st[5][1];
  float* dvb = static_cast<float*>(p.dv) + b * p.st[6][0] + h * p.st[6][1];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int j = k0 + RPT * b_ty + r;
    if (j >= p.Lk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * b_tx + 32 * c;
      if (!in_head<DH>(d)) continue;
      store4(dkb + j * p.st[5][2] + d,
             make_float4(dk[r][c][0] * p.scale, dk[r][c][1] * p.scale,
                         dk[r][c][2] * p.scale, dk[r][c][3] * p.scale));
      store4(dvb + j * p.st[6][2] + d,
             make_float4(dv[r][c][0], dv[r][c][1], dv[r][c][2], dv[r][c][3]));
    }
  }
}

// dq: grid (ceil(Lq / 64), H, B)
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const Params p) {
  constexpr int LD = DH + 4;
  constexpr int BQ = kOwn, BK = kStream;
  constexpr int LS = BK + 4;   // row stride of the ds tile
  constexpr int NC = (DH + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [BQ][LD]
  float* dos = qs + BQ * LD;     // [BQ][LD]
  float* ks = dos + BQ * LD;     // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* dss = vs + BK * LD;     // [BQ][LS] ds
  float* lse_s = dss + BQ * LS;  // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]
  int* valid = reinterpret_cast<int*>(delta_s + BQ);  // [BK]

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* qb = slab(p.q, p, 0, b, h);
  const float* kb = slab(p.k, p, 1, b, h);
  const float* vb = slab(p.v, p, 2, b, h);
  const float* db = slab(p.dout, p, 3, b, h);
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.Lq;

  load_tile<DH, BQ>(qb, p.st[0][2], q0, p.Lq, qs);
  load_tile<DH, BQ>(db, p.st[3][2], q0, p.Lq, dos);
  for (int r = tid; r < BQ; r += kThreads) {
    const bool in = q0 + r < p.Lq;
    lse_s[r] = in ? p.lse[row_stats + q0 + r] : 0.f;
    delta_s[r] = in ? p.delta[row_stats + q0 + r] : 0.f;
  }

  // scores: 64 x 32 tile, 16 x 8 threads; dq: 64 x DH, 16 x 8 threads
  const int a_ty = tid / 8, a_tx = tid % 8;
  const int c_ty = tid / 8, c_tx = tid % 8;
  float dq[4][NC][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[r][c][e] = 0.f;
    }
  }

  for (int k0 = 0; k0 < p.Lk; k0 += BK) {
    __syncthreads();  // the previous key tile is consumed
    load_tile<DH, BK>(kb, p.st[1][2], k0, p.Lk, ks);
    load_tile<DH, BK>(vb, p.st[2][2], k0, p.Lk, vs);
    load_valid(p, b, k0, BK, valid);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tile<DH, BK, 4>(qs, dos, ks, vs, a_ty, a_tx, s, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = 4 * a_ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = a_tx + 8 * c;
        float pr;
        prob_grad(s[r][c], dp[r][c], q0 + il, k0 + jl, valid[jl], lse_s[il],
                  delta_s[il], p.Lq, p.Lk, p.causal, p.scale, &pr,
                  &dss[il * LS + jl]);
      }
    }
    __syncthreads();

    // dq[i] += ds[i][j] k[j] for this thread's rows i = 4 * c_ty + r and
    // columns 4 * c_tx + 32 * c
    for (int jl = 0; jl < BK; ++jl) {
      float dr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dr[r] = dss[(4 * c_ty + r) * LS + jl];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (!in_head<DH>(4 * c_tx + 32 * c)) continue;
        const float4 k4 = load4(ks + jl * LD + 4 * c_tx + 32 * c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          dq[r][c][0] = fmaf(dr[r], k4.x, dq[r][c][0]);
          dq[r][c][1] = fmaf(dr[r], k4.y, dq[r][c][1]);
          dq[r][c][2] = fmaf(dr[r], k4.z, dq[r][c][2]);
          dq[r][c][3] = fmaf(dr[r], k4.w, dq[r][c][3]);
        }
      }
    }
  }

  float* dqb = static_cast<float*>(p.dq) + b * p.st[4][0] + h * p.st[4][1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * c_ty + r;
    if (i >= p.Lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!in_head<DH>(4 * c_tx + 32 * c)) continue;
      store4(dqb + i * p.st[4][2] + 4 * c_tx + 32 * c,
             make_float4(dq[r][c][0] * p.scale, dq[r][c][1] * p.scale,
                         dq[r][c][2] * p.scale, dq[r][c][3] * p.scale));
    }
  }
}

template <int DH, int OWN>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * OWN * (DH + 4) + 2 * kStream * (DH + 4) +
                          2 * kStream * (OWN + 4) + 2 * kStream + OWN);
}

// keys a dk/dv block owns
template <int DH>
constexpr int dkv_own() { return DH > 128 ? 32 : kOwn; }

template <int DH>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kOwn * (DH + 4) + 2 * kStream * (DH + 4) +
                          kOwn * (kStream + 4) + 2 * kOwn + kStream);
}

template <int DH>
cudaError_t launch_dkv_f32(const Params& p, cudaStream_t stream) {
  static hopper::SmemGrant granted;
  constexpr int own = dkv_own<DH>();
  constexpr size_t smem = dkv_smem<DH, own>();
  const cudaError_t err = granted.ensure(flash_bwd_dkv_f32<DH, own>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lk + own - 1) / own, p.H, p.B);
  flash_bwd_dkv_f32<DH, own><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_f32(const Params& p, cudaStream_t stream) {
  static hopper::SmemGrant granted;
  constexpr size_t smem = dq_smem<DH>();
  const cudaError_t err = granted.ensure(flash_bwd_dq_f32<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kOwn - 1) / kOwn, p.H, p.B);
  flash_bwd_dq_f32<DH><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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

constexpr int kOwnRows = 64;                 // rows a block owns: one wgmma M
constexpr int kConsumers = 128;              // one consumer warpgroup
constexpr int kTcThreads = kConsumers + 32;  // and one producer warp
constexpr int kDqStream = 64;                // keys per dq step

__host__ __device__ constexpr int col_blocks(int dh) {
  return (dh + 63) / 64;
}

// queries per dk/dv step: dk and dv take DH fp32 registers per thread and
// the two score tiles BQ more, so above Dh 96 the stream is 32 rows
__host__ __device__ constexpr int dkv_stream(int dh) {
  return dh > 96 ? 32 : 64;
}

// ring depth: three stages while a tile is one 64-column block, else two
// (two blocks per SM stay under 227 KB of shared memory up to Dh 128)
__host__ __device__ constexpr int tc_stages(int dh) {
  return col_blocks(dh) == 1 ? 3 : 2;
}

// dk/dv: own = k, v (64-row boxes), stream = q, dout; dq: own = q, dout,
// stream = k, v
struct TcParams {
  CUtensorMap own0, own1, str0, str1;
  const float* lse;     // (B, H, Lq) contiguous
  const float* delta;   // (B, H, Lq) contiguous
  const int* key_mask;  // (B, Lk) with row stride mask_sb, or null
  void* out0;           // dk or dq
  void* out1;           // dv (dk/dv only)
  int64_t st0[3], st1[3];   // their (batch, head, row) strides
  int B, H, Lq, Lk;
  int64_t mask_sb;
  int causal;
  float scale;
};

// Shared memory of one block, in bytes from a 1024-aligned base: the two
// owned tiles, STAGES x two streamed tiles of ROWS rows, STAGES x 2 x ROWS
// per-row words (lse and delta, or key flags) and the barriers (owned tile
// loaded; stage full; stage free). Tiles are column blocks of 64 bf16.
template <int DH, int ROWS, int STAGES>
struct TcLayout {
  static constexpr int kOwnTile = col_blocks(DH) * kOwnRows * 128;
  static constexpr int kStrTile = col_blocks(DH) * ROWS * 128;
  static constexpr int kOwn0 = 0;
  static constexpr int kOwn1 = kOwnTile;
  static constexpr int kStr0 = 2 * kOwnTile;
  static constexpr int kStr1 = kStr0 + STAGES * kStrTile;
  static constexpr int kStats = kStr1 + STAGES * kStrTile;
  static constexpr int kBars = kStats + STAGES * 2 * ROWS * 4;
  static constexpr size_t kBytes = kBars + (1 + 2 * STAGES) * 8 + 1024;
};

using hopper::align_1024;

// Barrier setup, then the producer warp's whole life: the owned tiles once
// (rows own_row), then for each streamed tile (rows it * ROWS) the two
// streamed tensors by TMA, issued by lane 0, and the tile's per-row words,
// written into the stage by stats(row, r, words) for its rows r. Returns
// false in the consumer warpgroup.
template <int DH, int ROWS, int STAGES, typename Stats>
__device__ __forceinline__ bool produce(const TcParams& p, uint8_t* smem,
                                        int own_row, int n_tiles,
                                        Stats stats) {
  using L = TcLayout<DH, ROWS, STAGES>;
  constexpr int CB = col_blocks(DH);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  const int b = blockIdx.z, h = blockIdx.y;
  if (threadIdx.x == 0) {
    hopper::mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < kConsumers) return false;

  const int lane = threadIdx.x - kConsumers;
  if (lane == 0) {
    hopper::mbar_arrive_expect_tx(own_full, 2 * L::kOwnTile);
    for (int c = 0; c < CB; ++c) {
      tma_load_4d(smem + L::kOwn0 + c * kOwnRows * 128, &p.own0, own_full,
                  64 * c, own_row, h, b);
      tma_load_4d(smem + L::kOwn1 + c * kOwnRows * 128, &p.own1, own_full,
                  64 * c, own_row, h, b);
    }
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    uint32_t* words =
        reinterpret_cast<uint32_t*>(smem + L::kStats) + s * 2 * ROWS;
    for (int r = lane; r < ROWS; r += 32) stats(it * ROWS + r, r, words);
    if (lane != 0) {
      mbar_arrive(&full[s]);
      continue;
    }
    hopper::mbar_arrive_expect_tx(&full[s], 2 * L::kStrTile);
    for (int c = 0; c < CB; ++c) {
      tma_load_4d(smem + L::kStr0 + s * L::kStrTile + c * ROWS * 128,
                  &p.str0, &full[s], 64 * c, it * ROWS, h, b);
      tma_load_4d(smem + L::kStr1 + s * L::kStrTile + c * ROWS * 128,
                  &p.str1, &full[s], 64 * c, it * ROWS, h, b);
    }
  }
  return true;
}

// dk / dv: grid (ceil(Lk / 64), H, B)
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc(const __grid_constant__ TcParams p) {
  constexpr int BQ = dkv_stream(DH);
  constexpr int STAGES = tc_stages(DH);
  using L = TcLayout<DH, BQ, STAGES>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kOwnRows;
  const int n_tiles = (p.Lq + BQ - 1) / BQ;
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.Lq;

  // per query: lse, delta (zeros past Lq)
  auto stats = [&](int i, int r, uint32_t* words) {
    const bool in = i < p.Lq;
    words[r] = __float_as_uint(in ? p.lse[row_stats + i] : 0.f);
    words[BQ + r] = __float_as_uint(in ? p.delta[row_stats + i] : 0.f);
  };
  if (produce<DH, BQ, STAGES>(p, smem, k0, n_tiles, stats)) return;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 16 * warp + gid;   // this thread's keys: k0 + r0 (+ 8)
  int kf[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    kf[hh] = key_flag(p.key_mask, p.mask_sb, p.Lk, b, k0 + r0 + 8 * hh);
  }
  const uint32_t base = smem_addr(smem);

  float dk[DH / 2], dv[DH / 2], sc[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;

  mbar_wait(bars, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    __syncwarp();
    const uint32_t q_tile = base + L::kStr0 + s * L::kStrTile;
    const uint32_t do_tile = base + L::kStr1 + s * L::kStrTile;

    // S^T = K Q^T, dP^T = V dO^T: 64 keys x BQ queries
    fence_regs<BQ / 2>(sc);
    fence_regs<BQ / 2>(dp);
    hopper::wgmma_fence();
    hopper::wgmma_ss_rows<DH, BQ>(sc, base + L::kOwn0, q_tile);
    hopper::wgmma_ss_rows<DH, BQ>(dp, base + L::kOwn1, do_tile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs<BQ / 2>(sc);
    fence_regs<BQ / 2>(dp);

    // P^T and dS^T in place; lse and delta index the columns (queries)
    const float* lse_s = reinterpret_cast<const float*>(smem + L::kStats) +
                         s * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    const int q0 = it * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tig + e;
        const float lse = lse_s[c], delta = delta_s[c];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          float pr, ds;
          prob_grad(sc[x], dp[x], q0 + c, k0 + r0 + 8 * hh, kf[hh], lse,
                    delta, p.Lq, p.Lk, p.causal, p.scale, &pr, &ds);
          sc[x] = pr;
          dp[x] = ds;
        }
      }
    }

    // dV += P^T dO, dK += dS^T Q: p and ds rounded to bf16 as A operands
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      acc_to_a(sc, t, pa[t]);
      acc_to_a(dp, t, da[t]);
    }
    fence_regs<DH / 2>(dv);
    fence_regs<DH / 2>(dk);
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      hopper::wgmma_rs_wide<DH, BQ>(dv, pa[t], do_tile, t);
      hopper::wgmma_rs_wide<DH, BQ>(dk, da[t], q_tile, t);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs<DH / 2>(dv);
    fence_regs<DH / 2>(dk);
    mbar_arrive(&empty[s]);
  }

  using bf16 = __nv_bfloat16;
  bf16* dkb = static_cast<bf16*>(p.out0) + b * p.st0[0] + h * p.st0[1];
  bf16* dvb = static_cast<bf16*>(p.out1) + b * p.st1[0] + h * p.st1[1];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = k0 + r0 + 8 * hh;
    if (j >= p.Lk) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = 8 * n + 2 * tig;
      const int x = 4 * n + 2 * hh;
      *reinterpret_cast<uint32_t*>(dkb + j * p.st0[2] + col) =
          pack_bf16(dk[x] * p.scale, dk[x + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvb + j * p.st1[2] + col) =
          pack_bf16(dv[x], dv[x + 1]);
    }
  }
}

// dq: grid (ceil(Lq / 64), H, B)
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc(const __grid_constant__ TcParams p) {
  constexpr int BK = kDqStream;
  constexpr int STAGES = tc_stages(DH);
  using L = TcLayout<DH, BK, STAGES>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kOwnRows;
  const int n_tiles = (p.Lk + BK - 1) / BK;

  // per key: its flag
  auto stats = [&](int j, int r, uint32_t* words) {
    words[r] = static_cast<uint32_t>(
        key_flag(p.key_mask, p.mask_sb, p.Lk, b, j));
  };
  if (produce<DH, BK, STAGES>(p, smem, q0, n_tiles, stats)) return;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 16 * warp + gid;   // this thread's queries: q0 + r0 (+ 8)
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.Lq;
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + r0 + 8 * hh;
    lse[hh] = i < p.Lq ? p.lse[row_stats + i] : 0.f;
    delta[hh] = i < p.Lq ? p.delta[row_stats + i] : 0.f;
  }
  const uint32_t base = smem_addr(smem);

  float dq[DH / 2], sc[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;

  mbar_wait(bars, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    __syncwarp();
    const uint32_t k_tile = base + L::kStr0 + s * L::kStrTile;
    const uint32_t v_tile = base + L::kStr1 + s * L::kStrTile;

    // S = Q K^T, dP = dO V^T: 64 queries x BK keys
    fence_regs<BK / 2>(sc);
    fence_regs<BK / 2>(dp);
    hopper::wgmma_fence();
    hopper::wgmma_ss_rows<DH, BK>(sc, base + L::kOwn0, k_tile);
    hopper::wgmma_ss_rows<DH, BK>(dp, base + L::kOwn1, v_tile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs<BK / 2>(sc);
    fence_regs<BK / 2>(dp);

    // dS in place of dP; the keys' flags index the columns
    const int* flags = reinterpret_cast<const int*>(smem + L::kStats) +
                       s * 2 * BK;
    const int k0 = it * BK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tig + e;
        const int f = flags[c];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          float pr, ds;
          prob_grad(sc[x], dp[x], q0 + r0 + 8 * hh, k0 + c, f, lse[hh],
                    delta[hh], p.Lq, p.Lk, p.causal, p.scale, &pr, &ds);
          dp[x] = ds;
        }
      }
    }

    // dQ += dS K: ds rounded to bf16 as the A operand, K read MN-major
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) acc_to_a(dp, t, da[t]);
    fence_regs<DH / 2>(dq);
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      hopper::wgmma_rs_wide<DH, BK>(dq, da[t], k_tile, t);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs<DH / 2>(dq);
    mbar_arrive(&empty[s]);
  }

  using bf16 = __nv_bfloat16;
  bf16* dqb = static_cast<bf16*>(p.out0) + b * p.st0[0] + h * p.st0[1];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + r0 + 8 * hh;
    if (i >= p.Lq) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int x = 4 * n + 2 * hh;
      *reinterpret_cast<uint32_t*>(dqb + i * p.st0[2] + 8 * n + 2 * tig) =
          pack_bf16(dq[x] * p.scale, dq[x + 1] * p.scale);
    }
  }
}

template <int DH>
cudaError_t launch_dkv_tc(const TcParams& p, cudaStream_t stream) {
  static hopper::SmemGrant granted;
  constexpr size_t smem =
      TcLayout<DH, dkv_stream(DH), tc_stages(DH)>::kBytes;
  const cudaError_t err = granted.ensure(flash_bwd_dkv_tc<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lk + kOwnRows - 1) / kOwnRows, p.H, p.B);
  flash_bwd_dkv_tc<DH><<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_tc(const TcParams& p, cudaStream_t stream) {
  static hopper::SmemGrant granted;
  constexpr size_t smem = TcLayout<DH, kDqStream, tc_stages(DH)>::kBytes;
  const cudaError_t err = granted.ensure(flash_bwd_dq_tc<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kOwnRows - 1) / kOwnRows, p.H, p.B);
  flash_bwd_dq_tc<DH><<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// host entry
// ---------------------------------------------------------------------------

template <typename F>
int by_head_dim(int Dh, F&& f) {
  switch (Dh) {
    case 64: return f(std::integral_constant<int, 64>());
    case 80: return f(std::integral_constant<int, 80>());
    case 96: return f(std::integral_constant<int, 96>());
    case 128: return f(std::integral_constant<int, 128>());
    case 160: return f(std::integral_constant<int, 160>());
    default: return cudaErrorInvalidValue;
  }
}

int launch(bool dkv, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta,
           const int* key_mask, void* dq, void* dk, void* dv, int B, int H,
           int Lq, int Lk, int Dh, const int64_t* strides, int64_t mask_sb,
           int causal, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  if (dtype == 0) {
    if (!hopper::aligned(ptrs, 7, strides, 21, 4)) {
      return cudaErrorInvalidValue;
    }
    Params p{q, k, v, dout, lse, delta, key_mask, dq, dk, dv, B, H, Lq, Lk,
             {}, mask_sb, causal, scale};
    for (int t = 0; t < 7; ++t) {
      for (int s = 0; s < 3; ++s) p.st[t][s] = strides[3 * t + s];
    }
    return by_head_dim(Dh, [&](auto dh) {
      constexpr int kDh = decltype(dh)::value;
      return dkv ? launch_dkv_f32<kDh>(p, st) : launch_dq_f32<kDh>(p, st);
    });
  }
  if (dtype != 1 || !hopper::aligned(ptrs, 7, strides, 21, 8)) {
    return cudaErrorInvalidValue;
  }
  TcParams p{};
  const int64_t* s = strides;   // q 0, k 3, v 6, dout 9, dq 12, dk 15, dv 18
  auto map = [&](CUtensorMap* m, const void* t, int L, const int64_t* ts,
                 int rows) {
    return hopper::encode_bf16_rows(m, t, B, H, L, Dh, ts[0], ts[1], ts[2],
                                    rows);
  };
  bool ok;
  if (dkv) {
    const int bq = dkv_stream(Dh);
    ok = map(&p.own0, k, Lk, s + 3, kOwnRows) &&
         map(&p.own1, v, Lk, s + 6, kOwnRows) &&
         map(&p.str0, q, Lq, s, bq) && map(&p.str1, dout, Lq, s + 9, bq);
    p.out0 = dk;
    p.out1 = dv;
    for (int i = 0; i < 3; ++i) {
      p.st0[i] = s[15 + i];
      p.st1[i] = s[18 + i];
    }
  } else {
    ok = map(&p.own0, q, Lq, s, kOwnRows) &&
         map(&p.own1, dout, Lq, s + 9, kOwnRows) &&
         map(&p.str0, k, Lk, s + 3, kDqStream) &&
         map(&p.str1, v, Lk, s + 6, kDqStream);
    p.out0 = dq;
    for (int i = 0; i < 3; ++i) p.st0[i] = s[12 + i];
  }
  if (!ok) return cudaErrorInvalidValue;
  p.lse = lse;
  p.delta = delta;
  p.key_mask = key_mask;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.mask_sb = mask_sb;
  p.causal = causal;
  p.scale = scale;
  return by_head_dim(Dh, [&](auto dh) {
    constexpr int kDh = decltype(dh)::value;
    return dkv ? launch_dkv_tc<kDh>(p, st) : launch_dq_tc<kDh>(p, st);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides (host memory, 21 values): the
// (batch, head, row) strides of q, k, v, dout, dq, dk, dv in elements.
// Returns a cudaError_t (0 on success). The dq call writes only dq, the
// dk/dv call only dk and dv; the strides of all seven are given to both.
// bf16 needs every stride a multiple of 8 elements (16 bytes) and 16-byte
// aligned bases; the call builds the TMA tensor maps from them.
extern "C" int prismer_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* key_mask, void* dq,
    int B, int H, int Lq, int Lk, int Dh, const int64_t* strides,
    int64_t mask_sb, int causal, int dtype, float scale, void* stream) {
  return launch(false, q, k, v, dout, lse, delta, key_mask, dq, dq, dq, B, H,
                Lq, Lk, Dh, strides, mask_sb, causal, dtype, scale, stream);
}

extern "C" int prismer_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* key_mask, void* dk,
    void* dv, int B, int H, int Lq, int Lk, int Dh, const int64_t* strides,
    int64_t mask_sb, int causal, int dtype, float scale, void* stream) {
  return launch(true, q, k, v, dout, lse, delta, key_mask, dk, dk, dv, B, H,
                Lq, Lk, Dh, strides, mask_sb, causal, dtype, scale, stream);
}
