// Multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces prismer_tpu/experts/ops/deform_attn_pallas.py
// ms_deform_attn_onehot (_onehot_matmul_kernel, pallas_call at :138). The
// spec is prismer_tpu/experts/ops/deform_attn.py ms_deform_attn (and the
// plain PyTorch port beside this kernel):
//
//   out[n, q, h*D + c] = sum_{l, p} w[n, q, h, l, p] *
//                        bilinear(value_l[n, :, :, h, c], loc[n, q, h, l, p])
//
// with grid_sample's align_corners=False frame (src = loc * size - 0.5) and
// zero padding decided per corner: a corner outside the level adds nothing.
//
// What bounds it on the H100: bytes. Per (n, q, h) it reads L*P locations
// and weights (12 x 12 bytes at the segmentation expert's shapes) and writes
// D fp32 outputs; the value rows it gathers are 4 corners x L*P points of D
// floats, mostly from L2 (one (n, h) slice of value is 4,725 x 128 B =
// 605 KB). At N = 16, S = Lq = 4,725, H = 8, D = 32 the inputs and output
// are 242 MB, 72 us at 3.35 TB/s; its 1.9 GFLOP of fp32 FMAs take 28 us at
// 67 TFLOP/s.
//
// The TPU kernel built a one-hot sampling matrix per (q tile, cell tile)
// and multiplied it on the MXU, because the TPU has no in-kernel gather.
// Here the gather is the natural form. Design: one warp per (n, q, h), lanes
// over the D channels (a loop for D > 32), so each bilinear corner is one
// coalesced row of D floats of value[n, start_l + y * W_l + x, h, :]. Lane j
// reads point j's location and weight once and turns them into the four
// corners' cell indices and weights (bilinear weight x attention weight, 0
// for a corner outside the level, whose index is clamped), as the TPU
// kernel's corner prep does; the warp then broadcasts them with shuffles and
// every lane does four loads and four FMAs per point. The sum runs in a
// fixed order (level, point, corner) with no atomics, so two launches give
// the same bits. A block's eight warps are eight consecutive queries of one
// (n, h), whose samples fall near each other in the value map, so their
// gathers share L1 lines.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

struct Corners {
  int idx[4];     // cell index within (n, :, h) rows, clamped into range
  float w[4];     // bilinear weight x attention weight, 0 outside
};

// point (lx, ly) of level l with attention weight a -> its four corners;
// the level is selected with unrolled compares, so `lv` stays in the
// parameter bank instead of a local-memory copy
__device__ __forceinline__ Corners point_corners(const Levels& lv, int l,
                                                 float lx, float ly,
                                                 float a) {
  int hl = 1, wl = 1, start = 0;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (i == l) {
      hl = lv.h[i];
      wl = lv.w[i];
      start = lv.start[i];
    }
  }
  const float x = lx * wl - 0.5f;
  const float y = ly * hl - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float dx = x - x0, dy = y - y0;
  // clamp before the int conversion; corners it moves are outside anyway
  const int xi = static_cast<int>(fminf(fmaxf(x0, -2.0f), float(wl)));
  const int yi = static_cast<int>(fminf(fmaxf(y0, -2.0f), float(hl)));
  const float cw[4] = {(1.0f - dx) * (1.0f - dy), dx * (1.0f - dy),
                       (1.0f - dx) * dy, dx * dy};
  Corners c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cx = xi + (k & 1), cy = yi + (k >> 1);
    const bool in = cx >= 0 && cx < wl && cy >= 0 && cy < hl;
    c.idx[k] = start + min(max(cy, 0), hl - 1) * wl + min(max(cx, 0), wl - 1);
    c.w[k] = in ? cw[k] * a : 0.0f;
  }
  return c;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_attn_kernel(const float* __restrict__ value,
                      const float* __restrict__ loc,
                      const float* __restrict__ attn,
                      float* __restrict__ out, Levels lv, int N, int S,
                      int Lq, int H, int D, int L, int P) {
  const int lane = threadIdx.x & 31;
  // warps ordered (n, h, q): a block holds consecutive queries of one head
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= static_cast<long long>(N) * H * Lq) return;
  const int q = static_cast<int>(warp % Lq);
  const long long nh = warp / Lq;
  const int h = static_cast<int>(nh % H);
  const int n = static_cast<int>(nh / H);
  const int lp = L * P;
  const long long task = (static_cast<long long>(n) * Lq + q) * H + h;

  const float* my_loc = loc + task * lp * 2;
  const float* my_attn = attn + task * lp;
  const long long row = static_cast<long long>(H) * D;
  const float* val = value + static_cast<long long>(n) * S * row +
                     static_cast<long long>(h) * D;
  float* my_out = out + (static_cast<long long>(n) * Lq + q) * row +
                  static_cast<long long>(h) * D;

  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < D;
    float acc = 0.0f;
    for (int j0 = 0; j0 < lp; j0 += 32) {
      Corners mine{};
      if (j0 + lane < lp) {
        const int j = j0 + lane;
        mine = point_corners(lv, j / P, __ldg(my_loc + 2 * j),
                             __ldg(my_loc + 2 * j + 1), __ldg(my_attn + j));
      }
      const int count = min(32, lp - j0);
#pragma unroll 4
      for (int j = 0; j < count; ++j) {
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int idx = __shfl_sync(0xffffffffu, mine.idx[k], j);
          const float w = __shfl_sync(0xffffffffu, mine.w[k], j);
          if (active) sum += w * __ldg(val + static_cast<long long>(idx) * row
                                       + c);
        }
        acc += sum;
      }
    }
    if (active) my_out[c] = acc;
  }
}

}  // namespace

// value (N, S, H, D), loc (N, Lq, H, L, P, 2), attn (N, Lq, H, L, P),
// out (N, Lq, H*D), all fp32 and contiguous; shapes: L (H_l, W_l) pairs on
// the host, in value's level order. Returns a cudaError_t (0 on success).
extern "C" int prismer_ms_deform_attn(const float* value, const float* loc,
                                      const float* attn, float* out,
                                      const int* shapes, int N, int S, int Lq,
                                      int H, int D, int L, int P,
                                      void* stream) {
  if (N <= 0 || Lq <= 0 || H <= 0 || D <= 0 || P <= 0 || L <= 0 ||
      L > kMaxLevels) {
    return cudaErrorInvalidValue;
  }
  Levels lv{};
  int start = 0;
  for (int l = 0; l < L; ++l) {
    if (shapes[2 * l] <= 0 || shapes[2 * l + 1] <= 0) {
      return cudaErrorInvalidValue;
    }
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return cudaErrorInvalidValue;
  const long long tasks = static_cast<long long>(N) * Lq * H;
  const long long blocks = (tasks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ms_deform_attn_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                          0, static_cast<cudaStream_t>(stream)>>>(
      value, loc, attn, out, lv, N, S, Lq, H, D, L, P);
  return cudaGetLastError();
}
