// Beam-grouped decode cross-attention for Hopper (sm_90a): one kernel for
// two TPU kernels.
//
// Replaces prismer_tpu/ops/decode_attention.py:
//   * grouped_cross_attention_t (_grouped_t_kernel, the pallas_call at :210):
//     mode 0, "cross_t". Scores in fp32 from compute-dtype operands, times
//     1/sqrt(Dh); p = exp2((s - m) * log2(e)) against the row max m, l = sum
//     p; p rounded to the compute dtype before an fp32-accumulated PV; then
//     o / max(l, 1e-30), rounded. The probabilities are NOT normalised
//     before their rounding (unlike the port's dot_product_attention).
//   * grouped_decode_attention (_grouped_kernel, the pallas_call at :134):
//     mode 1, "decode". Operands widened to fp32, exp, fp32 p and PV, the
//     same division.
// The TPU kernel read K pre-transposed (B, H, Dh, L) and padded L to 128
// lanes with -1e9 keys; both were TPU workarounds. Here K and V are the
// per-layer cross cache's natural (B, H, L, Dh) slices and L is unpadded,
// so no key is masked.
//
// What bounds it on the H100: bytes. A decode step's Q = beams (3) query
// rows, or the prefill's beams x prompt tokens (12), meet a sample's whole
// K/V: at Prismer-BASE batch 8 (H 12, L 964, Dh 64, bf16) 23.7 MB per call
// against 0.2 GFLOP, 7.1 us at 3.35 TB/s. Design:
//   * one block per (sample, head) reads that head's K and V once for all
//     of the sample's query rows (up to 16 per pass; up to 64 rows take 4
//     passes, re-reading K/V from L2);
//   * scores: the queries sit in shared memory as fp32; each thread takes
//     whole keys, holds a key row in registers and dots it with every query
//     (broadcast reads), writing the scaled scores to a (16, L) fp32 tile
//     in shared memory: the row max is then exact before any exponent, as
//     in the TPU kernel, so p rounds at the same values;
//   * softmax statistics: one warp per query row;
//   * PV: V streams through shared memory in 64-key tiles (fp32), each
//     thread owning one column of up to four query rows, summing keys in
//     order (no atomics: two launches give the same bits).
// A simple first version: no tensor cores, no split of L across blocks
// (B x H blocks, 96 at BASE batch 8, fill fewer than the 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using prismer::from_f;
using prismer::round_to;
using prismer::to_f;
using prismer::Vec;
using prismer::warp_max;
using prismer::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQG = 16;          // query rows per pass
constexpr int kVT = 64;          // keys per staged V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 227 * 1024;

enum Mode { kCrossT = 0, kDecode = 1 };

template <typename T>
struct Params {
  const T* q;     // (B, H, Q, Dh)
  const T* k;     // (B, H, L, Dh)
  const T* v;
  T* out;         // (B, H, Q, Dh)
  int Q, L;
  float scale;
};

template <int DH>
__host__ __device__ constexpr size_t smem_floats(int L) {
  return static_cast<size_t>(kQG) * DH + static_cast<size_t>(kQG) * L +
         static_cast<size_t>(kVT) * DH + kQG;
}

// grid (B * H): one block per (sample, head)
template <typename T, int DH, int MODE>
__global__ void __launch_bounds__(kThreads)
grouped_attn_kernel(const Params<T> p) {
  static_assert(kThreads % DH == 0, "a thread owns one column in PV");
  constexpr int V = Vec<T>::kN;
  constexpr int RS = kThreads / DH;    // query rows apart in PV
  constexpr int RPT = kQG / RS;        // query rows per thread in PV
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                      // (kQG, DH) queries
  float* ss = qs + kQG * DH;           // (kQG, L) scores, then p
  float* vs = ss + kQG * p.L;          // (kVT, DH) V tile
  float* ls = vs + kVT * DH;           // (kQG) row sums

  const size_t bh = blockIdx.x;
  const T* qb = p.q + bh * p.Q * DH;
  const T* kb = p.k + bh * p.L * DH;
  const T* vb = p.v + bh * p.L * DH;
  T* ob = p.out + bh * p.Q * DH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = threadIdx.x % DH;
  const int row0 = threadIdx.x / DH;

  for (int q0 = 0; q0 < p.Q; q0 += kQG) {
    const int nq = min(kQG, p.Q - q0);
    __syncthreads();   // the previous pass is consumed
    for (int e = threadIdx.x; e < kQG * DH / V; e += kThreads) {
      const int r = e / (DH / V);
      const int c = (e - r * (DH / V)) * V;
      float x[V] = {};
      if (r < nq) Vec<T>::load(qb + static_cast<size_t>(q0 + r) * DH + c, x);
#pragma unroll
      for (int i = 0; i < V; ++i) qs[r * DH + c + i] = x[i];
    }
    __syncthreads();

    // scaled scores of every (query, key)
    for (int l = threadIdx.x; l < p.L; l += kThreads) {
      float kr[DH];
#pragma unroll
      for (int d = 0; d < DH; d += V) {
        Vec<T>::load(kb + static_cast<size_t>(l) * DH + d, kr + d);
      }
      for (int r = 0; r < nq; ++r) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qs + r * DH + d);
          s = fmaf(qq.x, kr[d], s);
          s = fmaf(qq.y, kr[d + 1], s);
          s = fmaf(qq.z, kr[d + 2], s);
          s = fmaf(qq.w, kr[d + 3], s);
        }
        ss[r * p.L + l] = s * p.scale;
      }
    }
    __syncthreads();

    // p against the exact row max, its sum in fp32, p rounded (cross_t)
    for (int r = warp; r < nq; r += kWarps) {
      float* row = ss + r * p.L;
      float m = -INFINITY;
      for (int l = lane; l < p.L; l += 32) m = fmaxf(m, row[l]);
      m = warp_max(m);
      float sum = 0.f;
      for (int l = lane; l < p.L; l += 32) {
        const float e = MODE == kCrossT ? exp2f((row[l] - m) * kLog2e)
                                        : expf(row[l] - m);
        sum += e;
        row[l] = MODE == kCrossT ? round_to<T>(e) : e;
      }
      sum = warp_sum(sum);
      if (lane == 0) ls[r] = sum;
    }

    // o[r][col] = sum_l p[r][l] v[l][col], V through shared memory
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    for (int l0 = 0; l0 < p.L; l0 += kVT) {
      const int nl = min(kVT, p.L - l0);
      __syncthreads();   // p is complete / the previous tile is consumed
      for (int e = threadIdx.x; e < kVT * DH / V; e += kThreads) {
        const int r = e / (DH / V);
        const int c = (e - r * (DH / V)) * V;
        float x[V] = {};
        if (r < nl) Vec<T>::load(vb + static_cast<size_t>(l0 + r) * DH + c, x);
#pragma unroll
        for (int i = 0; i < V; ++i) vs[r * DH + c + i] = x[i];
      }
      __syncthreads();
      for (int j = 0; j < nl; ++j) {
        const float vj = vs[j * DH + col];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          if (row0 + RS * i < nq) {
            acc[i] = fmaf(ss[(row0 + RS * i) * p.L + l0 + j], vj, acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = row0 + RS * i;
      if (r < nq) {
        ob[static_cast<size_t>(q0 + r) * DH + col] =
            from_f<T>(acc[i] / fmaxf(ls[r], 1e-30f));
      }
    }
  }
}

template <typename T, int DH, int MODE>
cudaError_t launch(const Params<T>& p, int blocks, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_floats<DH>(p.L) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_attn_kernel<T, DH, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  grouped_attn_kernel<T, DH, MODE><<<blocks, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                int B, int H, int Q, int L, int mode, float scale,
                cudaStream_t st) {
  const Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<T*>(out), Q, L,
                    scale};
  return mode == kCrossT ? launch<T, 64, kCrossT>(p, B * H, st)
                         : launch<T, 64, kDecode>(p, B * H, st);
}

}  // namespace

// q and out (B, H, Q, Dh), k and v (B, H, L, Dh), contiguous, 16-byte
// aligned, all of dtype 0 (fp32) or 1 (bf16); Dh 64, 1 <= Q <= 64; mode 0
// "cross_t" (kernel 11's rounding) or 1 "decode" (kernel 12's). Returns a
// cudaError_t (0 on success).
extern "C" int prismer_grouped_attention(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int H, int Q, int L, int Dh,
                                         int mode, int dtype, float scale,
                                         void* stream) {
  if (B <= 0 || H <= 0 || Q <= 0 || Q > 64 || L <= 0 || Dh != 64 ||
      (mode != kCrossT && mode != kDecode) || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? run<float>(q, k, v, out, B, H, Q, L, mode, scale, st)
             : run<__nv_bfloat16>(q, k, v, out, B, H, Q, L, mode, scale, st);
}
