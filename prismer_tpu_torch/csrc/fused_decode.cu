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
// of self cache against ~6 GFLOP, ~90 us at 3.35 TB/s. What the design does
// about it:
//   * every weight byte is read once per step for all N rows: a projection
//     block holds the (N, K) input in shared memory and streams its weight
//     rows (16-byte loads, coalesced, prefetched to L2 while the input tile
//     loads) against it. bf16: tensor cores (mma.sync m16n8k16, fp32
//     accumulation), one block per 8 output columns with its 8 warps
//     splitting K, partial sums added in warp order; fp32 (the card-side
//     parity runs): FMA, one warp per output column;
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
//   * each LayerNorm is one short kernel, one warp per row, the row held in
//     registers; the projections read its output as a plain input tile;
//   * the beam reorder rides on the self-attention read: block (row, head)
//     reads its row's source row from the old cache, writes it to the second
//     buffer, writes the fresh K/V column at `index`, and attends. It cannot
//     permute in place (row n reads row flat_beam[n]).
// Layer i+1 depends on all of layer i across blocks, so the entry launches a
// fixed sequence of short kernels per layer (14 for a layer with
// cross-attention, 13 for the first, 7 for the output layer, one final
// LayerNorm: 175 at 12 + 1 layers) on the caller's stream: one host call per
// step, no grid-wide barriers to deadlock, no per-phase register budget
// shared across phases. A cooperative persistent kernel or a CUDA graph would
// remove the launch gaps; that is later work, as are tensor-core tiles for
// the FMA (fp32) projections.
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

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

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
constexpr int kMmaChunk = 1024;        // k per input tile of an mma one
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kSelfThreads = 128;
constexpr int kCrossThreads = 512;
constexpr int kCrossWarps = kCrossThreads / 32;
constexpr int kMaxBeams = 8;
constexpr int kMaxLnDim = 1024;        // LayerNorm rows live in registers

enum Act { kActNone = 0, kActSqRelu = 1, kActGelu = 2 };

// Raise a kernel's dynamic shared memory limit once per size it needs.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* granted) {
  if (bytes <= *granted) return cudaSuccess;
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

// dst = LN(o + res) over one row of D <= kMaxLnDim, by one warp. The row
// is read once, 16 bytes per lane per load with every load in flight
// together, and kept in registers for the two-pass statistics.
template <typename T>
__device__ void ln_row(const T* o, const T* res, const float* s,
                       const float* b, int D, float eps, int lane, T* dst) {
  constexpr int V = Vec<T>::kN;
  constexpr int NV = kMaxLnDim / (32 * V);
  float x[NV][V];
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
  const float mean = warp_sum(sum) / D;
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
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = (lane + 32 * i) * V;
    if (k < D) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float y = (x[i][j] - mean) * rstd * s[k + j] + b[k + j];
        dst[k + j] = from_f<T>(y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// projection: out = act(round(x @ W^T) + b), x (N, K), W (M, K)
// ---------------------------------------------------------------------------

template <typename T>
struct DenseParams {
  const T* x;          // (N, K)
  const T* w;          // (M, K)
  const float* bias;   // (M,)
  T* out;              // (N, M)
  int N, K, M, kc, act;
};

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
  for (int k0 = 0; k0 < p.K; k0 += p.kc) {
    const int len = min(p.kc, p.K - k0);
    if (k0 > 0) __syncthreads();
    prismer::load_rows<T, NR>(p.x, p.K, row0, rows, k0, len, xs, p.kc);
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

// bf16 tensor-core projection: one block per 8 output columns and up to 32
// rows; its 8 warps split K in 32-wide chunks (prismer::mma_rows) and the
// partial sums are added in warp order, so the result does not depend on
// scheduling.
template <int MT>
__global__ void __launch_bounds__(kDenseThreads)
dense_mma_kernel(const DenseParams<__nv_bfloat16> p) {
  using bf16 = __nv_bfloat16;
  constexpr int R = MT * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = prismer::mma_ldx(p.kc);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);             // (R, ldx)
  float* red = reinterpret_cast<float*>(xs + R * ldx);       // (warps, R, 8)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * R;
  const int rows = min(R, p.N - row0);
  const int col0 = blockIdx.x * 8;

  if (warp == 0) {  // the block's 8 weight rows head for L2
    for (int c = 0; c < 8 && col0 + c < p.M; ++c) {
      prismer::prefetch_l2(p.w + static_cast<size_t>(col0 + c) * p.K,
                           p.K * static_cast<int>(sizeof(bf16)), lane);
    }
  }
  float acc[MT][1][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    acc[m][0][0] = acc[m][0][1] = acc[m][0][2] = acc[m][0][3] = 0.f;
  }
  for (int k0 = 0; k0 < p.K; k0 += p.kc) {
    const int len = min(p.kc, p.K - k0);
    if (k0 > 0) __syncthreads();
    prismer::load_rows<bf16, R>(p.x, p.K, row0, rows, k0, len, xs, ldx);
    __syncthreads();
    prismer::mma_rows<MT, 1, kDenseWarps, 4>(xs, ldx, p.w, p.K, k0, len, col0,
                                          p.M, warp, lane, acc);
  }
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float* r0 = red + (warp * R + m * 16 + gid) * 8 + tig * 2;
    r0[0] = acc[m][0][0];
    r0[1] = acc[m][0][1];
    r0[64] = acc[m][0][2];     // row + 8
    r0[65] = acc[m][0][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * 8; e += kDenseThreads) {
    const int r = e / 8;
    const int col = col0 + (e - r * 8);
    if (r < rows && col < p.M) {
      float s = 0.f;
      for (int w = 0; w < kDenseWarps; ++w) s += red[(w * R + r) * 8 + e % 8];
      p.out[static_cast<size_t>(row0 + r) * p.M + col] =
          dense_out<bf16>(s, p.bias[col], p.act);
    }
  }
}

template <typename T, int NR>
cudaError_t launch_dense_nr(DenseParams<T> p, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  constexpr int esz = sizeof(T);
  p.kc = std::min(p.K, std::max(8, kChunkBytes / (NR * esz) / 8 * 8));
  const size_t smem = static_cast<size_t>(NR) * p.kc * esz;
  cudaError_t err = allow_smem(dense_kernel<T, NR>, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + kDenseWarps - 1) / kDenseWarps,
                  (p.N + NR - 1) / NR);
  dense_kernel<T, NR><<<grid, kDenseThreads, smem, st>>>(p);
  return cudaGetLastError();
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

template <int MT>
cudaError_t launch_dense_mma(DenseParams<__nv_bfloat16> p, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  constexpr int R = MT * 16;
  p.kc = std::min(p.K, kMmaChunk);
  const size_t smem =
      static_cast<size_t>(R) * prismer::mma_ldx(p.kc) * 2 +
      static_cast<size_t>(kDenseWarps) * R * 8 * sizeof(float);
  const cudaError_t err = allow_smem(dense_mma_kernel<MT>, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + 7) / 8, (p.N + R - 1) / R);
  dense_mma_kernel<MT><<<grid, kDenseThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// fp32 (the card-side parity runs): FMA tiles; bf16: tensor-core tiles
template <typename T>
cudaError_t launch_dense(const DenseParams<T>& p, cudaStream_t st) {
  return launch_dense_fma<T>(p, st);
}

template <>
cudaError_t launch_dense<__nv_bfloat16>(const DenseParams<__nv_bfloat16>& p,
                                        cudaStream_t st) {
  return p.N <= 16 ? launch_dense_mma<1>(p, st) : launch_dense_mma<2>(p, st);
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
  static size_t granted = 48 * 1024;
  const size_t smem = (static_cast<size_t>(BEAMS) * p.L +
                       static_cast<size_t>(kCrossWarps) * BEAMS * p.Dh) *
                      sizeof(float);
  const cudaError_t err =
      allow_smem(cross_attn_kernel<T, KV, BEAMS>, smem, &granted);
  if (err != cudaSuccess) return err;
  cross_attn_kernel<T, KV, BEAMS>
      <<<dim3(p.H, p.B), kCrossThreads, smem, st>>>(p);
  return cudaGetLastError();
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
  static size_t self_granted = 48 * 1024;
  const int N = a.N, D = a.D, F = a.F, Dh = D / a.H;
  const size_t nd = static_cast<size_t>(N) * D;
  const size_t slab = static_cast<size_t>(a.T) * nd;       // one layer cache
  const size_t dd = static_cast<size_t>(D) * D;
  const size_t fd = static_cast<size_t>(F) * D;

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
  RETURN_IF_ERR(allow_smem(self_attn_kernel<T>, self_smem, &self_granted));

  auto dense = [&](const T* x, const T* w, const float* bias, T* out, int K,
                   int M, int act_kind) {
    DenseParams<T> p{};
    p.x = x;
    p.w = w;
    p.bias = bias;
    p.out = out;
    p.N = N;
    p.K = K;
    p.M = M;
    p.act = act_kind;
    return launch_dense<T>(p, st);
  };
  // x = LN(o + res), then out = act(x @ W^T + b)
  auto dense_ln = [&](const T* ln_o, const T* ln_res, const float* ln_s,
                      T* x, const T* w, const float* bias, T* out, int M,
                      int act_kind) {
    ln_kernel<T><<<(N + 7) / 8, 256, 0, st>>>(ln_o, ln_res, ln_s, ln_s + D,
                                              x, N, D, a.eps);
    RETURN_IF_ERR(cudaGetLastError());
    return dense(x, w, bias, out, D, M, act_kind);
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
    self_attn_kernel<T><<<dim3(a.H, N), kSelfThreads, self_smem, st>>>(sp);
    RETURN_IF_ERR(cudaGetLastError());
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
  ln_kernel<T><<<(N + 7) / 8, 256, 0, st>>>(
      o, res, prev_ln, prev_ln + D, static_cast<T*>(a.hidden_out), N, D,
      a.eps);
  return cudaGetLastError();
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
      index >= T || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && (D % 32 != 0 || F % 32 != 0))) {  // 32-wide mma chunks
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
