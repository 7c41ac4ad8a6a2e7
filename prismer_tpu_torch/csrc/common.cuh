// Helpers shared by the decode kernels (fused_decode.cu, lm_topk.cu).
//
// 16-byte vector loads of the compute dtype widened to fp32, rounding to the
// compute dtype, warp sums, and the "one warp per weight row" dot product
// that both kernels stream their weights through.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace prismer {

// 16 bytes of T, widened to fp32: `load` from memory, `unpack` from a
// register copy
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
  __device__ static void load(const float* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  // element 2i is the low half of word i
  __device__ static void unpack(const uint4& v, float* out) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back (the identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// butterfly sum: every lane ends with the warp's total
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

// One warp: acc[n] += dot(w[0:len], xs[n][0:len]) for the NR rows held in
// shared memory (row stride ldx elements). Each lane takes 16-byte slices
// of the weight row, so the warp reads the row once, coalesced, with up to
// four loads in flight per lane; the rows of xs are read as 16-byte vectors
// (conflict-free). The caller reduces acc across the warp. len and ldx are
// multiples of Vec<T>::kN.
template <typename T, int NR>
__device__ __forceinline__ void warp_rows_dot(const T* __restrict__ w,
                                              const T* xs, int ldx, int len,
                                              int lane, float (&acc)[NR]) {
  constexpr int V = Vec<T>::kN;
  constexpr int U = 4;
  for (int k0 = lane * V; k0 < len; k0 += 32 * V * U) {
    float wv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * 32 * V;
      if (k < len) Vec<T>::load(w + k, wv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * 32 * V;
      if (k < len) {
#pragma unroll
        for (int n = 0; n < NR; ++n) {
          float xv[V];
          Vec<T>::load(xs + n * ldx + k, xv);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[n] = fmaf(wv[u][j], xv[j], acc[n]);
        }
      }
    }
  }
}

// Ask for a row of `bytes` to be brought into L2, one 128-byte line per
// lane and step (all lanes of the warp take part).
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes,
                                            int lane) {
  const char* c = static_cast<const char*>(p);
  for (int off = lane * 128; off < bytes; off += 32 * 128) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
  }
}

// Copy rows [row0, row0 + NR) x columns [k0, k0 + len) of a row-major
// (N, K) matrix into shared memory (row stride ldx), rows past `rows` as
// zeros; 16-byte loads, eight in flight per thread. len, K, k0 and ldx are
// multiples of Vec<T>::kN.
template <typename T, int NR>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, int K,
                                          int row0, int rows, int k0,
                                          int len, T* xs, int ldx) {
  constexpr int V = Vec<T>::kN;
  constexpr int U = 8;
  const int segs = len / V;
  const int total = NR * segs;
  for (int e0 = threadIdx.x; e0 < total; e0 += blockDim.x * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      const int n = e / segs;
      if (e < total && n < rows) {
        v[u] = *reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(row0 + n) * K + k0 + (e - n * segs) * V);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total) {
        const int n = e / segs;
        *reinterpret_cast<uint4*>(xs + n * ldx + (e - n * segs) * V) = v[u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core tiles for skinny products: out (R x C) = x (R x K) W^T,
// x in shared memory, W (C, K) row-major in device memory (nn.Linear
// layout), R <= 32 rows (MT m16 tiles). mma.sync m16n8k16 (bf16 in, fp32
// accumulate). A warp takes NT n8 tiles of columns and every KSPLIT-th
// 32-wide k chunk. Inside a chunk a lane holds k = tig*8 .. tig*8 + 7 of
// its A rows and B column as one 16-byte vector; the two mma of the chunk
// use words (0, 1) and (2, 3) of those vectors, the same permutation of k
// for A and B, so the sum is the same product.
// ---------------------------------------------------------------------------

// row stride (elements) of an x tile of kc columns for mma_rows: a multiple
// of 64 plus 32, so 16-byte fragment reads are free of bank conflicts
__host__ __device__ inline int mma_ldx(int kc) {
  return (kc + 63) / 64 * 64 + 32;
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[m][t] += x[m*16 .. +16][k0 + kw] . W[col0 + t*8 .. +8][k0 + kw] over
// this warp's k chunks kw = (kgrp + i*KSPLIT) * 32 < len, U chunks' loads
// in flight; xs holds columns [k0, k0 + len) of x with row stride ldx.
// Columns at or past M read as zeros. Fragment layout of acc[m][t]: rows
// m*16 + gid (+8 for [2], [3]), columns col0 + t*8 + tig*2 (+1).
template <int MT, int NT, int KSPLIT, int U>
__device__ __forceinline__ void mma_rows(const __nv_bfloat16* xs, int ldx,
                                         const __nv_bfloat16* __restrict__ w,
                                         int K, int k0, int len, int col0,
                                         int M, int kgrp, int lane,
                                         float (&acc)[MT][NT][4]) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
  for (int c0 = kgrp * 32; c0 < len; c0 += KSPLIT * 32 * U) {
    uint4 bw[U][NT];
    uint4 aw[U][MT][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kc = c0 + u * KSPLIT * 32 + tig * 8;
      if (c0 + u * KSPLIT * 32 < len) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int col = col0 + t * 8 + gid;
          bw[u][t] = make_uint4(0u, 0u, 0u, 0u);
          if (col < M) {
            bw[u][t] = *reinterpret_cast<const uint4*>(
                w + static_cast<size_t>(col) * K + k0 + kc);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          aw[u][m][0] = *reinterpret_cast<const uint4*>(
              xs + (m * 16 + gid) * ldx + kc);
          aw[u][m][1] = *reinterpret_cast<const uint4*>(
              xs + (m * 16 + gid + 8) * ldx + kc);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u * KSPLIT * 32 < len) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint4 lo = aw[u][m][0];
          const uint4 hi = aw[u][m][1];
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const uint4 b = bw[u][t];
            mma_bf16(acc[m][t], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
            mma_bf16(acc[m][t], lo.z, hi.z, lo.w, hi.w, b.z, b.w);
          }
        }
      }
    }
  }
}

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

}  // namespace prismer
