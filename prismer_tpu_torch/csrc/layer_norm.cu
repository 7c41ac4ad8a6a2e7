// LayerNorm with fp32 statistics over the last axis, for Hopper (sm_90a).
//
// Replaces prismer_tpu/ops/layer_norm.py fused_layer_norm (_ln_kernel,
// pallas_call at :58): y = LN(x) * scale + bias per row of an (R, D)
// activation, statistics and affine in fp32 (layer_norm.cuh), the result
// rounded to x's dtype. The backward is plain PyTorch in the wrapper, as the
// TPU kernel's custom_vjp backward is plain XLA.
//
// What bounds it on the H100: bytes. It reads x once and writes y once; at
// the encoder's (8 x 964, 768) bf16 activation that is 23.7 MB, 7.1 us at
// 3.35 TB/s, against ~8 fp32 operations per element (0.7 us at 67
// TFLOP/s).
//
// Design: one warp per row, eight rows per block. The TPU kernel moved
// 512-row blocks through VMEM; here a row of D <= 1280 fits in a warp's
// registers, so x is read from device memory once, in 16-byte slices with
// all of a lane's loads in flight, both statistics come from warp shuffles,
// and y leaves as 16-byte stores. Rows past R are neither read nor written.

#include "layer_norm.cuh"

namespace {

using prismer::kLnMaxDim;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ out, int R,
                  int D, float eps) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const size_t off = static_cast<size_t>(row) * D;
  T* dst = out + off;
  prismer::ln_row<T>(x + off, scale, bias, D, eps, threadIdx.x & 31,
                     [&](int k, const float* y) {
                       prismer::store_vec<T>(dst + k, y);
                     });
}

template <typename T>
cudaError_t run(const void* x, const float* scale, const float* bias,
                void* out, int R, int D, float eps, cudaStream_t st) {
  const int blocks = (R + kWarps - 1) / kWarps;
  layer_norm_kernel<T><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), R, D, eps);
  return cudaGetLastError();
}

}  // namespace

// x and out (R, D) row-major in x's dtype (0 fp32, 1 bf16), scale and bias
// (D,) fp32; D a multiple of 8 and at most 1280, every pointer 16-byte
// aligned. Returns a cudaError_t (0 on success).
extern "C" int prismer_layer_norm(const void* x, const float* scale,
                                  const float* bias, void* out, int R, int D,
                                  float eps, int dtype, void* stream) {
  if (R <= 0 || D <= 0 || D % 8 != 0 || D > kLnMaxDim ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? run<float>(x, scale, bias, out, R, D, eps, st)
                    : run<bf16>(x, scale, bias, out, R, D, eps, st);
}
