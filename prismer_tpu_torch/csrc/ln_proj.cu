// LayerNorm fused into its consumers, for Hopper (sm_90a): the encoder
// block's q/k/v projections, its MLP's first projection + quick_gelu, and
// its whole norm-early Adaptor.
//
// Replaces prismer_tpu/ops/ln_proj.py
//   * ln_proj (_ln_proj_kernel, pallas_call at :127):
//       out_i = act(LN(x) @ W_i + b_i) for one to three weights;
//   * adaptor_fused (_adaptor_kernel, pallas_call at :242):
//       out = x + up(sq_relu(down(LN(x)))).
// Weights are in the port's nn.Linear layout (F, D). The rounding points
// are the Pallas bodies' (ln_proj.py:84-105, 210-223): the fp32 LayerNorm
// (layer_norm.cuh) is rounded to the compute dtype T before the product;
// each product sums in fp32 and is rounded to T, then T's bias is added in
// T; ln_proj's activation runs in fp32 on that rounded value and is rounded
// once; the adaptor's relu and square are in T, its second product is
// taken the same way, and the residual add is in T.
//
// What bounds them on the H100: operations. At the encoder's R = 8 x 964
// rows and D = 768 (bf16): q/k/v 27.3 GFLOP (27.6 us at 989 TFLOP/s)
// against 50.9 MB of traffic (15.2 us at 3.35 TB/s); c_fc + quick_gelu
// (F = 3072) 36.4 GFLOP (36.8 us) against 64 MB; the adaptor 18.2 GFLOP
// (18.4 us) against 26 MB.
//
// Design. The TPU kernel held whole weights in VMEM beside a 512-row block.
// Here a block owns a row tile: its warps normalise the rows (one warp per
// row) into shared memory as T, and the products read them from there, so
// the normalised activations never reach device memory.
//   * ln_proj: a block normalises 64 rows (bf16; 32 in fp32) once and
//     computes up to six 128-column tiles of one output from them. The
//     grid runs over (column group of any output, row tile), groups
//     fastest, so the blocks that share a row tile run together. The three
//     q/k/v weights stay separate pointers: no concatenation per call.
//   * adaptor_fused: a block owns 32 rows (bf16; 16 in fp32) across all D
//     columns. It keeps LN(x) and the squared-ReLU bottleneck in shared
//     memory and writes only x + u.
//   Above D = 1024 (ViT-H/14's 1280) the bf16 row tiles halve, to 32 and
//   16 rows: a 64-row ln_proj tile (168 KB) or two 32-row adaptor tiles
//   beside the four weight stages (64 KB) would pass the 227 KB a block may
//   have. A 16-row tile is one m16 row of warps, each warp 16 columns.
// Weights stream through shared memory with cp.async in k slices (bf16:
// four stages of 64 columns; fp32: three of 32), each copied while the
// ones before it are multiplied, since the copy's latency, not the
// tensor cores, bounds a slice that is one barrier wide. bf16
// products use tensor cores: mma.sync m16n8k16, bf16 in, fp32 accumulate,
// eight warps as 2 (rows) x 4 (32 columns each). fp32 products run on FMA
// (TF32 stays off): warp w owns rows w, w + 8, ..., lane l columns
// l + 32 j. Each sum runs over k in one fixed order, so two launches give
// the same bits. Rows past R are neither read nor written.

#include "layer_norm.cuh"

namespace {

using prismer::Vec;
using prismer::from_f;
using prismer::round_to;
using prismer::to_f;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBn = 128;      // output columns per tile
constexpr int kGroup = 6;     // ln_proj column tiles per block
constexpr int kSub = 32;      // k width of a staged weight sub-slice
constexpr int kMaxOut = 3;
constexpr size_t kMaxSmem = 227 * 1024;

enum Act { kActNone = 0, kActQuickGelu = 1 };

// rows of a block: ln_proj's row tile and the adaptor's; `wide` is
// D > kWideDim, where the bf16 tiles halve
constexpr int kWideDim = 1024;
template <typename T>
constexpr int proj_rows(bool wide) { return sizeof(T) == 2 && !wide ? 64 : 32; }
template <typename T>
constexpr int adaptor_rows(bool wide) {
  return sizeof(T) == 2 && !wide ? 32 : 16;
}

// row stride (elements) of a normalised row tile: bf16 rows are a multiple
// of 64 plus 32 elements, so the 16-byte fragment reads are free of bank
// conflicts; fp32 rows are read as broadcasts
template <typename T>
__host__ __device__ inline int tile_ld(int D) {
  return sizeof(T) == 2 ? prismer::mma_ldx(D) : D + 4;
}

// A staged weight slice is subs<T>() sub-slices of kBn rows x kSub
// columns; stages<T>() slices are in shared memory at once. Row stride
// (elements) of a sub-slice: 64 bytes in bf16 (two rows per 128-byte
// line), 144 bytes in fp32 (eight consecutive rows fill distinct 16-byte
// bank groups).
template <typename T>
__host__ __device__ constexpr int subs() { return sizeof(T) == 2 ? 2 : 1; }
template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 2 ? 4 : 3; }
template <typename T>
__host__ __device__ constexpr int w_ld() {
  return sizeof(T) == 2 ? kSub : kSub + 4;
}
template <typename T>
__host__ __device__ constexpr int sub_elems() { return kBn * w_ld<T>(); }
template <typename T>
__host__ __device__ constexpr int stage_elems() {
  return subs<T>() * sub_elems<T>();
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [col0, col0 + kBn) x columns [k0, k0 + subs<T>() * kSub) of W
// (F, D) into the slice ws, rows at or past F as zeros (nothing is read
// for them)
template <typename T>
__device__ __forceinline__ void load_w_slice(const T* __restrict__ W, int F,
                                             int D, int col0, int k0, T* ws) {
  constexpr int V = Vec<T>::kN;
  constexpr int kSegs = kSub / V;
  constexpr int kPerSub = kBn * kSegs;
  for (int c = threadIdx.x; c < subs<T>() * kPerSub; c += kThreads) {
    const int h = c / kPerSub;
    const int r = (c - h * kPerSub) / kSegs;
    const int s = c - h * kPerSub - r * kSegs;
    const bool valid = col0 + r < F;
    const T* src = valid ? W + static_cast<size_t>(col0 + r) * D + k0 +
                               h * kSub + s * V
                         : W;
    cp_async16(ws + h * sub_elems<T>() + r * w_ld<T>() + s * V, src, valid);
  }
}

// LN of rows [row0, row0 + rows) of x (R, D) into xs (row stride ldx), one
// warp per row; rows at or past R are zeros and x is not read for them
template <typename T>
__device__ void ln_tile(const T* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, int R, int D,
                        float eps, int row0, int rows, T* xs, int ldx) {
  constexpr int V = Vec<T>::kN;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    T* dst = xs + r * ldx;
    if (row0 + r < R) {
      prismer::ln_row<T>(x + static_cast<size_t>(row0 + r) * D, scale, bias,
                         D, eps, lane, [&](int k, const float* y) {
                           prismer::store_vec<T>(dst + k, y);
                         });
    } else {
      const float zero[V] = {};
      for (int k = lane * V; k < D; k += 32 * V) {
        prismer::store_vec<T>(dst + k, zero);
      }
    }
  }
}

// One kBn-column output tile of BM rows: acc = A[0:BM, 0:D] .
// W[col0 : col0 + kBn, 0:D]^T with A in shared memory (row stride lda) and
// W (F, D) streamed through the stages<T>() slices of ws. `product` starts with a
// barrier, so A and ws may have been written just before it. `for_each`
// calls f(r, c, sum) for row r < BM and column c < kBn of the tile.
template <typename T, int BM>
struct Tile;

// the k-slice pipeline shared by both types: `mul(sub, k0)` multiplies
// the staged sub-slice `sub` that holds columns k0 .. k0 + kSub - 1
template <typename T, typename Mul>
__device__ __forceinline__ void stream_w(const T* __restrict__ W, int F, int D,
                                         int col0, T* ws, Mul mul) {
  constexpr int kS = stages<T>();
  constexpr int kc = subs<T>() * kSub;
  const int nk = D / kc;
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < nk) load_w_slice(W, F, D, col0, s * kc, ws + s * stage_elems<T>());
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kS - 2>();
    __syncthreads();
    const int nxt = i + kS - 1;
    if (nxt < nk) {
      load_w_slice(W, F, D, col0, nxt * kc,
                   ws + (nxt % kS) * stage_elems<T>());
    }
    cp_async_commit();
    const T* slice = ws + (i % kS) * stage_elems<T>();
#pragma unroll
    for (int h = 0; h < subs<T>(); ++h) {
      mul(slice + h * sub_elems<T>(), i * kc + h * kSub);
    }
  }
}

template <int BM>
struct Tile<bf16, BM> {
  // warps as WR (rows) x WC (columns): 2 x 4 from 32 rows up, 1 x 8 at 16
  static constexpr int WR = BM >= 32 ? 2 : 1;
  static constexpr int WC = kWarps / WR;
  static constexpr int WN = kBn / WC;  // columns per warp: 32 or 16
  static constexpr int WM = BM / WR;   // rows per warp
  static constexpr int MT = WM / 16;   // m16 tiles per warp
  static constexpr int NT = WN / 8;    // n8 tiles per warp
  static_assert(MT >= 1 && WM % 16 == 0, "row tile of 16, 32 or 64 rows");
  float acc[MT][NT][4];

  __device__ void product(const bf16* A, int lda, const bf16* __restrict__ W,
                          int F, int D, int col0, bf16* ws) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int wm = warp / WC, wn = warp % WC;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;
    // a lane holds k = tig*8 .. tig*8 + 7 of its A rows and W row as one
    // 16-byte vector; the two mma of a 32-wide slice use words (0, 1) and
    // (2, 3), the same permutation of k for A and W (common.cuh mma_rows)
    stream_w(W, F, D, col0, ws, [&](const bf16* wsl, int k0) {
      const int k = k0 + tig * 8;
      uint4 a[MT][2], b[NT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int row = wm * WM + m * 16 + gid;
        a[m][0] = *reinterpret_cast<const uint4*>(A + row * lda + k);
        a[m][1] = *reinterpret_cast<const uint4*>(A + (row + 8) * lda + k);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        b[t] = *reinterpret_cast<const uint4*>(
            wsl + (wn * WN + t * 8 + gid) * kSub + tig * 8);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          prismer::mma_bf16(acc[m][t], a[m][0].x, a[m][1].x, a[m][0].y,
                            a[m][1].y, b[t].x, b[t].y);
          prismer::mma_bf16(acc[m][t], a[m][0].z, a[m][1].z, a[m][0].w,
                            a[m][1].w, b[t].z, b[t].w);
        }
      }
    });
  }

  // fragment layout: acc[m][t][e] is row m*16 + gid (+8 for e >= 2),
  // column t*8 + tig*2 (+1 for odd e) of the warp's sub-tile
  template <typename Fn>
  __device__ void for_each(Fn f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int wm = warp / WC, wn = warp % WC;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f(wm * WM + m * 16 + gid + (e >> 1) * 8,
            wn * WN + t * 8 + tig * 2 + (e & 1), acc[m][t][e]);
        }
  }
};

template <int BM>
struct Tile<float, BM> {
  static constexpr int RM = BM / kWarps;  // rows per warp
  static constexpr int CN = kBn / 32;     // columns per lane
  float acc[RM][CN];

  __device__ void product(const float* A, int lda,
                          const float* __restrict__ W, int F, int D, int col0,
                          float* ws) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
    stream_w(W, F, D, col0, ws, [&](const float* wsl, int k0) {
#pragma unroll
      for (int k = 0; k < kSub; k += 4) {
        float4 b[CN];
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          b[j] = *reinterpret_cast<const float4*>(
              wsl + (lane + 32 * j) * w_ld<float>() + k);
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(
              A + (warp + kWarps * i) * lda + k0 + k);
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
          }
        }
      }
    });
  }

  template <typename Fn>
  __device__ void for_each(Fn f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) f(warp + kWarps * i, lane + 32 * j, acc[i][j]);
  }
};

// the outputs of one ln_proj call; output i owns the grid's column groups
// [first[i], first[i] + ceil(f[i] / (kGroup * kBn)))
struct Proj {
  const void* w[kMaxOut];
  const void* b[kMaxOut];
  void* o[kMaxOut];
  int f[kMaxOut];
  int first[kMaxOut];
  int n;
};

__device__ __forceinline__ float quick_gelu(float x) {
  return x * (1.f / (1.f + expf(-1.702f * x)));
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
ln_proj_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, Proj p, int R, int D,
               float eps, int act) {
  extern __shared__ uint4 smem[];
  const int ldx = tile_ld<T>(D);
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = xs + BM * ldx;
  // this block's output, selected with unrolled compares so that `p` stays
  // in the parameter bank
  int sel = 0;
#pragma unroll
  for (int i = 1; i < kMaxOut; ++i) {
    if (i < p.n && static_cast<int>(blockIdx.x) >= p.first[i]) sel = i;
  }
  const T* W = nullptr;
  const T* b = nullptr;
  T* o = nullptr;
  int F = 0, first = 0;
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    if (i == sel) {
      W = static_cast<const T*>(p.w[i]);
      b = static_cast<const T*>(p.b[i]);
      o = static_cast<T*>(p.o[i]);
      F = p.f[i];
      first = p.first[i];
    }
  }
  const int row0 = blockIdx.y * BM;
  const int group = static_cast<int>(blockIdx.x) - first;
  const int col_end = min(F, (group + 1) * kGroup * kBn);

  ln_tile<T>(x, scale, bias, R, D, eps, row0, BM, xs, ldx);
  Tile<T, BM> tile;
  for (int col0 = group * kGroup * kBn; col0 < col_end; col0 += kBn) {
    tile.product(xs, ldx, W, F, D, col0, ws);
    tile.for_each([&](int r, int c, float v) {
      const int row = row0 + r, col = col0 + c;
      if (row < R && col < F) {
        float y = round_to<T>(round_to<T>(v) + to_f(b[col]));
        if (act == kActQuickGelu) y = quick_gelu(y);
        o[static_cast<size_t>(row) * F + col] = from_f<T>(y);
      }
    });
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
adaptor_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const T* __restrict__ wd,
               const T* __restrict__ bd, const T* __restrict__ wu,
               const T* __restrict__ bu, T* __restrict__ out, int R, int D,
               float eps) {
  extern __shared__ uint4 smem[];
  const int ldx = tile_ld<T>(D);
  T* ys = reinterpret_cast<T*>(smem);  // LN(x), then read-only
  T* hs = ys + BM * ldx;               // sq_relu(down(LN(x)))
  T* ws = hs + BM * ldx;
  const int row0 = blockIdx.x * BM;

  ln_tile<T>(x, scale, bias, R, D, eps, row0, BM, ys, ldx);
  Tile<T, BM> tile;
  for (int col0 = 0; col0 < D; col0 += kBn) {
    tile.product(ys, ldx, wd, D, D, col0, ws);
    tile.for_each([&](int r, int c, float v) {
      const int col = col0 + c;
      if (col < D) {
        const float h =
            fmaxf(round_to<T>(round_to<T>(v) + to_f(bd[col])), 0.f);
        hs[r * ldx + col] = from_f<T>(h * h);
      }
    });
  }
  for (int col0 = 0; col0 < D; col0 += kBn) {
    tile.product(hs, ldx, wu, D, D, col0, ws);
    tile.for_each([&](int r, int c, float v) {
      const int row = row0 + r, col = col0 + c;
      if (row < R && col < D) {
        const size_t i = static_cast<size_t>(row) * D + col;
        const float u = round_to<T>(round_to<T>(v) + to_f(bu[col]));
        out[i] = from_f<T>(to_f(x[i]) + u);
      }
    });
  }
}

template <typename K>
cudaError_t grant(K kernel, size_t bytes, size_t* granted) {
  if (bytes <= *granted) return cudaSuccess;
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

template <typename T, int BM>
cudaError_t run_ln_proj_rows(const void* x, const float* scale,
                             const float* bias, const Proj& p, int groups,
                             int R, int D, float eps, int act,
                             cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = (static_cast<size_t>(BM) * tile_ld<T>(D) +
                       stages<T>() * stage_elems<T>()) * sizeof(T);
  const cudaError_t err = grant(ln_proj_kernel<T, BM>, smem, &granted);
  if (err != cudaSuccess) return err;
  const int row_tiles = (R + BM - 1) / BM;
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  ln_proj_kernel<T, BM><<<dim3(groups, row_tiles), kThreads, smem, st>>>(
      static_cast<const T*>(x), scale, bias, p, R, D, eps, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_ln_proj(const void* x, const float* scale, const float* bias,
                        const Proj& p, int groups, int R, int D, float eps,
                        int act, cudaStream_t st) {
  return D > kWideDim
             ? run_ln_proj_rows<T, proj_rows<T>(true)>(x, scale, bias, p,
                                                       groups, R, D, eps, act,
                                                       st)
             : run_ln_proj_rows<T, proj_rows<T>(false)>(x, scale, bias, p,
                                                        groups, R, D, eps,
                                                        act, st);
}

template <typename T, int BM>
cudaError_t run_adaptor_rows(const void* x, const float* scale,
                             const float* bias, const void* wd,
                             const void* bd, const void* wu, const void* bu,
                             void* out, int R, int D, float eps,
                             cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = (2 * static_cast<size_t>(BM) * tile_ld<T>(D) +
                       stages<T>() * stage_elems<T>()) * sizeof(T);
  const cudaError_t err = grant(adaptor_kernel<T, BM>, smem, &granted);
  if (err != cudaSuccess) return err;
  adaptor_kernel<T, BM><<<(R + BM - 1) / BM, kThreads, smem, st>>>(
      static_cast<const T*>(x), scale, bias, static_cast<const T*>(wd),
      static_cast<const T*>(bd), static_cast<const T*>(wu),
      static_cast<const T*>(bu), static_cast<T*>(out), R, D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_adaptor(const void* x, const float* scale, const float* bias,
                        const void* wd, const void* bd, const void* wu,
                        const void* bu, void* out, int R, int D, float eps,
                        cudaStream_t st) {
  return D > kWideDim
             ? run_adaptor_rows<T, adaptor_rows<T>(true)>(
                   x, scale, bias, wd, bd, wu, bu, out, R, D, eps, st)
             : run_adaptor_rows<T, adaptor_rows<T>(false)>(
                   x, scale, bias, wd, bd, wu, bu, out, R, D, eps, st);
}

bool dims_ok(int R, int D, int dtype) {
  return R > 0 && D > 0 && D % (2 * kSub) == 0 && D <= prismer::kLnMaxDim &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// x (R, D) in the compute dtype (0 fp32, 1 bf16); scale and bias (D,) fp32;
// for i < n (1 to 3): w_i (f_i, D), b_i (f_i,) and out_i (R, f_i) in the
// compute dtype (unused pointers may be null); act 0 none, 1 quick_gelu.
// D a multiple of 64 and at most 1280, every pointer 16-byte aligned.
// Returns a cudaError_t (0 on success).
extern "C" int prismer_ln_proj(const void* x, const float* scale,
                               const float* bias, const void* w0,
                               const void* w1, const void* w2, const void* b0,
                               const void* b1, const void* b2, void* o0,
                               void* o1, void* o2, int f0, int f1, int f2,
                               int n, int R, int D, float eps, int act,
                               int dtype, void* stream) {
  if (!dims_ok(R, D, dtype) || n < 1 || n > kMaxOut ||
      (act != kActNone && act != kActQuickGelu)) {
    return cudaErrorInvalidValue;
  }
  Proj p{{w0, w1, w2}, {b0, b1, b2}, {o0, o1, o2}, {f0, f1, f2}, {0, 0, 0}, n};
  int groups = 0;
  for (int i = 0; i < n; ++i) {
    if (p.f[i] <= 0) return cudaErrorInvalidValue;
    p.first[i] = groups;
    groups += (p.f[i] + kGroup * kBn - 1) / (kGroup * kBn);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? run_ln_proj<float>(x, scale, bias, p, groups, R, D, eps, act, st)
             : run_ln_proj<bf16>(x, scale, bias, p, groups, R, D, eps, act, st);
}

// x and out (R, D), w_down and w_up (D, D), b_down and b_up (D,), all in
// the compute dtype (0 fp32, 1 bf16); scale and bias (D,) fp32. D a
// multiple of 64 and at most 1280, every pointer 16-byte aligned. Returns a
// cudaError_t (0 on success).
extern "C" int prismer_adaptor_fused(const void* x, const float* scale,
                                     const float* bias, const void* wd,
                                     const void* bd, const void* wu,
                                     const void* bu, void* out, int R, int D,
                                     float eps, int dtype, void* stream) {
  if (!dims_ok(R, D, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? run_adaptor<float>(x, scale, bias, wd, bd, wu, bu, out,
                                         R, D, eps, st)
                    : run_adaptor<bf16>(x, scale, bias, wd, bd, wu, bu, out,
                                        R, D, eps, st);
}
