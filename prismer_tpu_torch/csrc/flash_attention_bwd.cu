// Flash attention backward for Hopper (sm_90a): a dq kernel and a dk/dv
// kernel.
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
// Ownership (no float atomics, so two runs are bit-identical): one block
// owns a 64-key tile of one (batch, head) and streams 32-row query tiles
// for dk/dv (a 32-key tile above Dh 128, so that a thread's dk and dv
// accumulators, 2 x rows x Dh / 8 values, stay in registers: 80 at Dh 160);
// one block owns a 64-row query tile and streams 32-key tiles for dq. Every causal tile is visited (at the decoder's L <= 30 there is
// one tile anyway), which keeps a fully masked row's gradient equal to the
// formula above.
//
// What bounds it on the H100: at the ViT trunk's shape (B=4, L=964, H=12,
// Dh=64) the two kernels do ~45 GFLOP per layer against ~10 MB of operands,
// so they are compute-bound. This first version runs the products on the
// FMA pipes in fp32 for both dtypes (bf16 operands are widened on their way
// into shared memory; a product of two bf16 values is exact in fp32): tiles
// sit in shared memory as fp32 rows padded by 4 floats, so 16-byte reads of
// eight consecutive rows hit distinct banks, and each thread keeps a 4 x 4
// block of scores (and of dp) or a 4-row slice of its block's dq / dk / dv
// in registers. Tensor-core tiles (mma.sync or wgmma) are later work.
//
// Head dims: 64, 80, 96, 128 and 160 (every one of the model registry's).
// A thread's output columns are 4-wide slices 32 apart; where Dh is not a
// multiple of 32 (80) the last slice of some threads lies past Dh and is
// skipped. Nothing else assumes a power of two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using prismer::round_to;

constexpr float kMaskFill = -1.0e9f;   // flash_attention.py:54 NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kOwn = 64;      // rows a block owns (keys for dk/dv, queries for dq)
constexpr int kStream = 32;   // rows streamed per step
constexpr size_t kMaxSmem = 227 * 1024;

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [row0, row0 + ROWS) of a (L, DH) slab with row stride sl, widened to
// fp32 into shared memory (row stride DH + 4); rows past L are zeros
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_tile(const T* base, int64_t sl, int row0,
                                          int L, float* dst) {
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
__device__ __forceinline__ void load_valid(const Params& p, int b, int k0,
                                           int n, int* valid) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const int col = k0 + r;
    int f = -1;
    if (col < p.Lk) {
      f = 1;
      if (p.key_mask != nullptr && p.key_mask[b * p.mask_sb + col] == 0) f = 0;
    }
    valid[r] = f;
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

// p and ds of one score: i, j global row / column, f the key's validity
__device__ __forceinline__ void prob_grad(const Params& p, float s, float dp,
                                         int i, int j, int f, float lse,
                                         float delta, float* pr, float* ds) {
  *pr = 0.f;
  *ds = 0.f;
  if (i >= p.Lq || f < 0) return;
  float x = s * p.scale;
  if (f == 0 || (p.causal && j > i + (p.Lk - p.Lq))) x = kMaskFill;
  const float e = exp2f((x - lse) * kLog2e);
  *pr = e;
  *ds = e * (dp - delta);
}

template <typename T>
__device__ __forceinline__ const T* slab(const void* base, const Params& p,
                                         int t, int b, int h) {
  return static_cast<const T*>(base) + b * p.st[t][0] + h * p.st[t][1];
}

// ---------------------------------------------------------------------------
// dk / dv: grid (ceil(Lk / OWN), H, B), OWN = 64 keys per block (32 above
// Dh 128)
// ---------------------------------------------------------------------------

template <typename T, int DH, int OWN>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
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
  float* ps = dos + BQ * LD;     // [BQ][LP] p, rounded to T
  float* dss = ps + BQ * LP;     // [BQ][LP] ds, rounded to T
  float* lse_s = dss + BQ * LP;  // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]
  int* valid = reinterpret_cast<int*>(delta_s + BQ);  // [BK]

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const T* qb = slab<T>(p.q, p, 0, b, h);
  const T* kb = slab<T>(p.k, p, 1, b, h);
  const T* vb = slab<T>(p.v, p, 2, b, h);
  const T* db = slab<T>(p.dout, p, 3, b, h);
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.Lq;

  load_tile<T, DH, BK>(kb, p.st[1][2], k0, p.Lk, ks);
  load_tile<T, DH, BK>(vb, p.st[2][2], k0, p.Lk, vs);
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
    load_tile<T, DH, BQ>(qb, p.st[0][2], q0, p.Lq, qs);
    load_tile<T, DH, BQ>(db, p.st[3][2], q0, p.Lq, dos);
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
        float pr, ds;
        prob_grad(p, s[r][c], dp[r][c], q0 + il, k0 + jl, valid[jl],
                  lse_s[il], delta_s[il], &pr, &ds);
        ps[il * LP + jl] = round_to<T>(pr);
        dss[il * LP + jl] = round_to<T>(ds);
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

  T* dkb = static_cast<T*>(p.dk) + b * p.st[5][0] + h * p.st[5][1];
  T* dvb = static_cast<T*>(p.dv) + b * p.st[6][0] + h * p.st[6][1];
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

// ---------------------------------------------------------------------------
// dq: grid (ceil(Lq / 64), H, B)
// ---------------------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = DH + 4;
  constexpr int BQ = kOwn, BK = kStream;
  constexpr int LS = BK + 4;   // row stride of the ds tile
  constexpr int NC = (DH + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [BQ][LD]
  float* dos = qs + BQ * LD;     // [BQ][LD]
  float* ks = dos + BQ * LD;     // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* dss = vs + BK * LD;     // [BQ][LS] ds, rounded to T
  float* lse_s = dss + BQ * LS;  // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]
  int* valid = reinterpret_cast<int*>(delta_s + BQ);  // [BK]

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const T* qb = slab<T>(p.q, p, 0, b, h);
  const T* kb = slab<T>(p.k, p, 1, b, h);
  const T* vb = slab<T>(p.v, p, 2, b, h);
  const T* db = slab<T>(p.dout, p, 3, b, h);
  const int64_t row_stats = (static_cast<int64_t>(b) * p.H + h) * p.Lq;

  load_tile<T, DH, BQ>(qb, p.st[0][2], q0, p.Lq, qs);
  load_tile<T, DH, BQ>(db, p.st[3][2], q0, p.Lq, dos);
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
    load_tile<T, DH, BK>(kb, p.st[1][2], k0, p.Lk, ks);
    load_tile<T, DH, BK>(vb, p.st[2][2], k0, p.Lk, vs);
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
        float pr, ds;
        prob_grad(p, s[r][c], dp[r][c], q0 + il, k0 + jl, valid[jl],
                  lse_s[il], delta_s[il], &pr, &ds);
        dss[il * LS + jl] = round_to<T>(ds);
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

  T* dqb = static_cast<T*>(p.dq) + b * p.st[4][0] + h * p.st[4][1];
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

template <typename K>
cudaError_t grant_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DH>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  static bool granted = false;
  constexpr int own = dkv_own<DH>();
  constexpr size_t smem = dkv_smem<DH, own>();
  if (!granted) {
    const cudaError_t err =
        grant_smem(flash_bwd_dkv_kernel<T, DH, own>, smem);
    if (err != cudaSuccess) return err;
    granted = true;
  }
  const dim3 grid((p.Lk + own - 1) / own, p.H, p.B);
  flash_bwd_dkv_kernel<T, DH, own><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  static bool granted = false;
  constexpr size_t smem = dq_smem<DH>();
  if (!granted) {
    const cudaError_t err = grant_smem(flash_bwd_dq_kernel<T, DH>, smem);
    if (err != cudaSuccess) return err;
    granted = true;
  }
  const dim3 grid((p.Lq + kOwn - 1) / kOwn, p.H, p.B);
  flash_bwd_dq_kernel<T, DH><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// 4-element loads and stores: every stride a multiple of 4 elements and
// every base 16-byte aligned
bool aligned(const Params& p) {
  for (int t = 0; t < 7; ++t) {
    for (int s = 0; s < 3; ++s) {
      if (p.st[t][s] % 4 != 0) return false;
    }
  }
  const void* ptrs[] = {p.q, p.k, p.v, p.dout, p.dq, p.dk, p.dv};
  for (const void* ptr : ptrs) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  }
  return true;
}

template <typename T>
int launch_dh(bool dkv, int Dh, const Params& p, cudaStream_t st) {
  switch (Dh) {
    case 64: return dkv ? launch_dkv<T, 64>(p, st) : launch_dq<T, 64>(p, st);
    case 80: return dkv ? launch_dkv<T, 80>(p, st) : launch_dq<T, 80>(p, st);
    case 96: return dkv ? launch_dkv<T, 96>(p, st) : launch_dq<T, 96>(p, st);
    case 128:
      return dkv ? launch_dkv<T, 128>(p, st) : launch_dq<T, 128>(p, st);
    case 160:
      return dkv ? launch_dkv<T, 160>(p, st) : launch_dq<T, 160>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

int launch(bool dkv, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta,
           const int* key_mask, void* dq, void* dk, void* dv, int B, int H,
           int Lq, int Lk, int Dh, const int64_t* strides, int64_t mask_sb,
           int causal, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  Params p{q, k, v, dout, lse, delta, key_mask, dq, dk, dv, B, H, Lq, Lk,
           {}, mask_sb, causal, scale};
  for (int t = 0; t < 7; ++t) {
    for (int s = 0; s < 3; ++s) p.st[t][s] = strides[3 * t + s];
  }
  if (!aligned(p)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(dkv, Dh, p, st);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(dkv, Dh, p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides (host memory, 21 values): the
// (batch, head, row) strides of q, k, v, dout, dq, dk, dv in elements.
// Returns a cudaError_t (0 on success). The dq call writes only dq, the
// dk/dv call only dk and dv; the strides of all seven are given to both.
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
