// The two-pass fp32 LayerNorm of one row, shared by the encoder's LayerNorm
// kernels: layer_norm.cu (fused_layer_norm) and ln_proj.cu (ln_proj and
// adaptor_fused). Every kernel that includes this header computes the same
// bits for the same row, so the three agree with each other exactly.
//
// The definition is the TPU kernels' (prismer_tpu/ops/layer_norm.py
// _ln_kernel, prismer_tpu/ops/ln_proj.py _ln_f32), not the one-pass form
// the JAX package uses by default on the TPU: in fp32,
//
//   mean = sum(x) / D,  var = sum((x - mean)^2) / D,
//   y = (x - mean) * rsqrt(var + eps) * scale + bias.
//
// One warp owns the row. Each lane reads 16-byte slices of it (lane + 32 i)
// with all loads in flight together, keeps them in registers for both
// passes, and the warp's butterfly sums give every lane both moments.

#pragma once

#include "common.cuh"

namespace prismer {

// the widest row a warp keeps in registers (Prismer-BASE 768, LARGE 1024,
// HUGE 1280: a lane then holds 5 bf16 or 10 fp32 16-byte vectors)
constexpr int kLnMaxDim = 1280;

// 16 bytes of T from V fp32 values, each rounded to T
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v);

template <>
__device__ __forceinline__ void store_vec<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16>(__nv_bfloat16* p,
                                                         const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Row x[0:D) of the definition above, held by one warp (every lane
// constructs it): the lane's 16-byte slices (lane + 32 i) widened to fp32
// and centred on the row's mean (v), the mean and rsqrt(var + eps). D is a
// multiple of Vec<T>::kN and at most kLnMaxDim, x is 16-byte aligned.
template <typename T>
struct LnRow {
  static constexpr int V = Vec<T>::kN;
  static constexpr int NV = kLnMaxDim / (32 * V);
  float v[NV][V];
  float mean, rstd;

  __device__ __forceinline__ LnRow(const T* __restrict__ x, int D, float eps,
                                   int lane) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = (lane + 32 * i) * V;
      if (k < D) Vec<T>::load(x + k, v[i]);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((lane + 32 * i) * V < D) {
#pragma unroll
        for (int j = 0; j < V; ++j) sum += v[i][j];
      }
    }
    mean = warp_sum(sum) / static_cast<float>(D);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((lane + 32 * i) * V < D) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          v[i][j] -= mean;
          sq += v[i][j] * v[i][j];
        }
      }
    }
    rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
  }
};

// LayerNorm of x[0:D) by one warp (every lane calls it); scale and bias are
// fp32. emit(k, y) receives the lane's normalised values y[0:kN) of
// columns k .. k + kN - 1, in fp32: y = (x - mean) * rstd * scale + bias.
template <typename T, typename Emit>
__device__ __forceinline__ void ln_row(const T* __restrict__ x,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ bias, int D,
                                       float eps, int lane, Emit emit) {
  constexpr int V = Vec<T>::kN;
  const LnRow<T> row(x, D, eps, lane);
#pragma unroll
  for (int i = 0; i < LnRow<T>::NV; ++i) {
    const int k = (lane + 32 * i) * V;
    if (k < D) {
      float s[V], b[V], y[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        Vec<float>::load(scale + k + j, s + j);
        Vec<float>::load(bias + k + j, b + j);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) y[j] = row.v[i][j] * row.rstd * s[j] + b[j];
      emit(k, y);
    }
  }
}

}  // namespace prismer
