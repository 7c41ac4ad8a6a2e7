// Flash attention forward for Hopper (sm_90a), one kernel for two TPU kernels.
//
// Replaces prismer_tpu/ops/flash_attention.py:
//   * flash_attention_packed (_packed_forward / _packed_kernel): mask-free,
//     non-causal attention on packed (B, L, H*Dh) operands;
//   * flash_attention (_flash_forward / _flash_kernel): head-split
//     (B, H, L, Dh) attention with an optional key-padding mask and causal
//     masking.
// A packed (B, L, H*Dh) tensor is a strided view of (B, H, L, Dh), so one
// kernel that takes per-tensor (batch, head, row) strides serves both. The
// TPU kernel's head-on-lanes grouping and whole-K VMEM blocks are not carried
// over: they worked around the TPU's (8, 128) tiling.
//
// What bounds it on the H100: at the encoder shape (B=8, L=964, H=12, Dh=64)
// the two products are ~23 GFLOP per layer, against ~18 MB of q/k/v/o, so it
// is compute-bound, and only the tensor cores reach the card's rate. The
// (L, L) scores never reach device memory. Two kernels share the contract:
//   * bf16 (the serving path): tensor-core tiles with mma.sync m16n8k16
//     (bf16 in, fp32 accumulate). One block of 4 warps per (64-row q-tile,
//     head, batch); each warp owns 16 query rows, keeps its Q fragments in
//     registers, and walks 64-key K/V tiles staged in shared memory (V
//     transposed on the way in, rows padded against bank conflicts). The
//     score fragment of QK^T is re-packed in registers as the A operand of
//     PV, so probabilities never leave registers; row statistics reduce
//     across the 4 threads of a quad.
//     Every row start must be 16-byte aligned (the wrapper checks).
//   * fp32 (the card-vs-CPU parity checks): FMA tiles, since the tensor
//     cores have no full-fp32 product. One thread owns one query row (no
//     cross-thread softmax reduction); K/V tiles sit in shared memory as
//     fp32 and are read as broadcasts, four values per load.
// Head dims: every one of the model registry's, 64 and 96 (Prismer-BASE),
// 80 (ViT-H/14's trunk), 128 and 160 (the LARGE and HUGE resamplers).
// None of the index arithmetic assumes a power of two: rows are cut into
// 16-byte vectors and 8-wide mma tiles, and every head dim is a multiple
// of 16. What the wide ones change:
//   * bf16: Q is staged through the K tile's shared memory (its fragments
//     then live in registers), so Q, K and V^T fit the 48 KB of static
//     shared memory up to Dh 160; per thread, Dh / 2 fp32 output values
//     plus Dh / 4 Q fragment words stay in registers (120 at Dh 160);
//   * fp32: above Dh 96 a thread's query row moves from registers to
//     shared memory (row stride Dh + 1, so the 32 rows a warp reads at once
//     sit in distinct banks), a block takes 32 rows and a key tile 8 keys,
//     so that the thread's Dh accumulators stay in registers and the
//     unrolled tile loops index them with constants (ptxas -v: no spills).
// Not yet done (later work): wgmma, TMA loads, double-buffered tiles, and
// splitting long K across blocks for few-query shapes (the resampler's 64
// latents give only B*H blocks).
//
// Numerics follow the JAX reference (mha_reference, flash_attention.py:57):
// scores and softmax statistics in fp32 from input-dtype operands; masked
// scores replaced by the finite -1e9 fill; causal keeps col <= row + (Lk-Lq);
// probabilities rounded to the input dtype before the PV product, which
// accumulates in fp32; out in the input dtype, lse = m + log(l) in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 64;     // query rows per block (16 per warp)
constexpr int kMmaBK = 64;     // keys per tile
constexpr int kMmaThreads = 128;

__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const Params p) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  constexpr int BQ = kMmaBQ, BK = kMmaBK;
  constexpr int QS = DH + 8;   // Q/K smem row stride (bf16): no bank conflicts
  constexpr int VS = BK + 8;   // V^T smem row stride
  constexpr int NKK = DH / 16; // k-steps of QK^T
  constexpr int NDT = DH / 8;  // 8-wide output tiles
  constexpr int VEC = 8;       // bf16 per 16-byte load
  static_assert(BQ == BK, "Q is staged through the K tile");
  // Q passes through ks once: its fragments are read into registers before
  // the first K tile overwrites it (the loop starts with a barrier)
  __shared__ __align__(16) __nv_bfloat16 ks[BK * QS];
  __shared__ __align__(16) __nv_bfloat16 vt[DH * VS];
  __nv_bfloat16* qs = ks;
  __shared__ int valid[BK];    // 1 keep, 0 masked (-1e9), -1 past Lk (skip)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;   // row within the 8-row half of a fragment
  const int tig = lane & 3;    // column pair within a fragment
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;

  using bf16 = __nv_bfloat16;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int e = tid; e < BQ * DH / VEC; e += kMmaThreads) {
    const int r = e / (DH / VEC);
    const int c = (e - r * (DH / VEC)) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < p.Lq) {
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * p.q_sl + c);
    }
    *reinterpret_cast<uint4*>(&qs[r * QS + c]) = val;
  }
  __syncthreads();
  const int rw = warp * 16 + gid;   // this thread's rows: rw and rw + 8
  uint32_t qf[NKK][4];
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
    qf[kk][0] = ld_b32(&qs[rw * QS + kk * 16 + tig * 2]);
    qf[kk][1] = ld_b32(&qs[(rw + 8) * QS + kk * 16 + tig * 2]);
    qf[kk][2] = ld_b32(&qs[rw * QS + kk * 16 + 8 + tig * 2]);
    qf[kk][3] = ld_b32(&qs[(rw + 8) * QS + kk * 16 + 8 + tig * 2]);
  }

  float o[NDT][4];
#pragma unroll
  for (int t = 0; t < NDT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m[2] = {kMInit, kMInit};
  float l[2] = {0.f, 0.f};   // this thread's partial row sums
  const int row[2] = {q0 + rw, q0 + rw + 8};
  const int causal_off = p.Lk - p.Lq;

  for (int k0 = 0; k0 < p.Lk; k0 += BK) {
    __syncthreads();   // previous tile fully consumed
    for (int e = tid; e < BK * DH / VEC; e += kMmaThreads) {
      const int r = e / (DH / VEC);
      const int c = (e - r * (DH / VEC)) * VEC;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < p.Lk) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * p.k_sl + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * p.v_sl + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * QS + c]) = kv;
      const bf16* v8 = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vt[(c + i) * VS + r] = v8[i];
    }
    for (int r = tid; r < BK; r += kMmaThreads) {
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

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = &ks[(nt * 8 + gid) * QS + tig * 2];
#pragma unroll
      for (int kk = 0; kk < NKK; ++kk) {
        mma_bf16(s[nt], qf[kk], ld_b32(krow + kk * 16),
                 ld_b32(krow + kk * 16 + 8));
      }
    }

    // scale, mask, online softmax (fragment: [half*2 + e] is row
    // rw + 8*half, column nt*8 + tig*2 + e)
    float tmax[2] = {kMInit, kMInit};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = nt * 8 + tig * 2 + e;
        const int f = valid[cl];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float x = s[nt][half * 2 + e] * p.scale;
          if (f == 0 || (p.causal && k0 + cl > row[half] + causal_off)) {
            x = kMaskFill;
          }
          s[nt][half * 2 + e] = x;
          if (f >= 0) tmax[half] = fmaxf(tmax[half], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      tmax[half] = fmaxf(tmax[half],
                         __shfl_xor_sync(0xffffffffu, tmax[half], 1));
      tmax[half] = fmaxf(tmax[half],
                         __shfl_xor_sync(0xffffffffu, tmax[half], 2));
      const float m_new = fmaxf(m[half], tmax[half]);
      alpha[half] = exp2f((m[half] - m_new) * kLog2e);
      m[half] = m_new;
      l[half] *= alpha[half];
    }
#pragma unroll
    for (int t = 0; t < NDT; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool keep = valid[nt * 8 + tig * 2 + e] >= 0;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float pr =
              keep ? exp2f((s[nt][half * 2 + e] - m[half]) * kLog2e) : 0.f;
          l[half] += pr;
          s[nt][half * 2 + e] = pr;
        }
      }
    }

    // O += P V: the score fragments of key tiles (2j, 2j+1) are the A
    // fragment of k-step j; probabilities are rounded to bf16 here
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int t = 0; t < NDT; ++t) {
        const bf16* vrow = &vt[(t * 8 + gid) * VS + j * 16 + tig * 2];
        mma_bf16(o[t], a, ld_b32(vrow), ld_b32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row[half] >= p.Lq) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    bf16* orow = ob + row[half] * p.o_sl + tig * 2;
#pragma unroll
    for (int t = 0; t < NDT; ++t) {
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16(o[t][half * 2] / denom, o[t][half * 2 + 1] / denom);
    }
    if (tig == 0) {
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Lq + row[half]] =
          m[half] + logf(denom);
    }
  }
}

template <int DH>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Lq + kMmaBQ - 1) / kMmaBQ, p.H, p.B);
  flash_fwd_mma_kernel<DH><<<grid, kMmaThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// the bf16 kernel's 16-byte loads need every row start 16-byte aligned
bool mma_aligned(const Params& p) {
  const int64_t strides[] = {p.q_sb, p.q_sh, p.q_sl, p.k_sb, p.k_sh, p.k_sl,
                             p.v_sb, p.v_sh, p.v_sl, p.o_sb, p.o_sh, p.o_sl};
  for (int64_t s : strides) {
    if (s % 8 != 0) return false;
  }
  const void* ptrs[] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  }
  return true;
}

template <int DH, int BK, int BQ>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Lq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_f32_kernel<DH, BK, BQ><<<grid, BQ, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int prismer_flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* key_mask, int B, int H, int Lq, int Lk, int Dh,
    int64_t q_sb, int64_t q_sh, int64_t q_sl,
    int64_t k_sb, int64_t k_sh, int64_t k_sl,
    int64_t v_sb, int64_t v_sh, int64_t v_sl,
    int64_t o_sb, int64_t o_sh, int64_t o_sl,
    int64_t mask_sb, int causal, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, key_mask, B, H, Lq, Lk,
           q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl,
           o_sb, o_sh, o_sl, mask_sb, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (Dh) {
      case 64: return launch_f32<64, 32, 64>(p, s);
      case 80: return launch_f32<80, 16, 64>(p, s);
      case 96: return launch_f32<96, 16, 64>(p, s);
      case 128: return launch_f32<128, 8, 32>(p, s);
      case 160: return launch_f32<160, 8, 32>(p, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != 1 || !mma_aligned(p)) return cudaErrorInvalidValue;
  switch (Dh) {
    case 64: return launch_mma<64>(p, s);
    case 80: return launch_mma<80>(p, s);
    case 96: return launch_mma<96>(p, s);
    case 128: return launch_mma<128>(p, s);
    case 160: return launch_mma<160>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
