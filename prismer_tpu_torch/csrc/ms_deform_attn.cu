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
// zero padding decided per corner: a corner outside the level adds nothing
// (its index is clamped, its weight is 0).
//
// What bounds it on the H100. Its bytes: at the segmentation expert's
// shapes (N 16, S = Lq = 4,725, H 8, D 32, levels 15 x 15, 30 x 30,
// 60 x 60, P 4) the inputs and output are 242 MB, 72 us at 3.35 TB/s; its
// 1.9 GFLOP of fp32 FMAs take 28 us at 67 TFLOP/s. But the gather reads far
// more than that from L1 and shared memory: every (n, q, h) reads 12 points
// x 4 corners of one 128-byte value row, 3.72 GB at those shapes, 0.11 ms
// at 128 bytes a cycle an SM, and each row takes an address, a load and 4
// FMAs a lane. So the time goes to the load pipe and to instruction issue,
// not to device memory. The TPU kernel built one-hot sampling tiles for its
// matrix unit because it has no gather; here the gather is the natural
// form, and the design cuts the work around each row:
//
//   * The coarse levels are staged whole in shared memory. A block works on
//     one (n, h) and a chunk of its queries (about one block an SM); at its
//     start one thread loads the rows of the staged levels of that head by
//     TMA (a 4-D tensor map over value, boxes of (D, 1, up to 256 rows, 1),
//     completion on one mbarrier). At those shapes the 15 x 15 and 30 x 30
//     levels are 1,125 rows, 144,000 bytes, so 8 of a query's 12 points
//     read shared memory. A level is staged when its rows fit the budget
//     and are no more than the chunk's gathers of that level would read.
//   * The other levels (60 x 60: 460 KB a head) are gathered from global
//     memory. A block takes its queries in index order, 64 in flight: at
//     the encoder's shapes (the queries are the value's positions) their
//     samples fall in a few rows of the finest map, which L1 holds. (A walk
//     in 8-row bands of each level's grid was 2-7 % slower: its divisions
//     cost more than its locality gained.)
//   * Eight lanes own a query, each lane 4 of its D = 32 columns (float4),
//     so one warp instruction loads one corner row of 4 queries. Lane c of
//     a query's group computes the four corners (rows and weights) of its
//     points c and c + 8 once, into a per-warp table in shared memory
//     ([point][query], so the 4 queries' entries of a point are 128
//     contiguous bytes); the group reads them back with two 16-byte loads
//     a point, a broadcast.
//   * On the main path the staged levels are known at compile time: staged
//     rows are shared loads at 32-bit addresses, the others read-only
//     global loads, asked for a pair of points ahead of the staged points
//     that hide their wait. The next query's locations and weights are
//     loaded while the current one is summed.
//   * The launch plan (chunks, staged levels, shared memory) is `make_plan`
//     here and experts/ops/deform_attn `deform_plan` in Python; the entry
//     refuses a call whose plan differs.
//
// A group of lanes owns each (n, q, h) and sums its points in a fixed
// order (the staged points in order, the others in order, the two sums
// added; corners in order within a point), with no atomics, so two
// launches give the same bits. fp32 throughout: there is no product here
// for tensor cores. A D that is not a multiple of 4 (or a value pointer
// not 16-byte aligned) takes the same kernel with scalar lanes and no
// staging; any L <= 8 and P, or other staged levels, take it with the
// points' loop and the staged levels at run time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>
#include <utility>

#include "hopper.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBoxRows = 256;              // a TMA box's largest extent
constexpr int kStageBytes = 160 * 1024;    // shared memory for staged rows
constexpr int kMinQueries = 2 * kWarps;    // queries a chunk is cut at
constexpr int kGroup = 8;                  // lanes a query
// a block's corner tables: for each of its 4 x kWarps queries in flight,
// 16 points of 32 bytes
constexpr int kTableSlots = 16;
constexpr int kTableBytes = kWarps * 64 * 32;

// The launch plan (ops: experts/ops/deform_attn.deform_plan).
struct Plan {
  int vec;                      // floats a lane loads per row: 4 or 1
  int chunks, per;              // query chunks per (n, h), queries a chunk
  int staged;                   // bit l: level l staged in shared memory
  int srow[kMaxLevels];         // its first shared row
  int box_rows[kMaxLevels];     // rows of one of its TMA boxes
  int boxes[kMaxLevels];        // its boxes
  int stage_rows;               // shared rows in all
  int smem;                     // dynamic shared memory of a block
};

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

Plan make_plan(const int* hs, const int* ws, int N, int S, int Lq, int H,
               int D, int L, int P, int sms, bool aligned) {
  Plan p = {};
  p.vec = (D % 4 == 0 && aligned) ? 4 : 1;
  const int nh = N * H;
  const int most = (Lq + kMinQueries - 1) / kMinQueries;
  p.chunks = std::max(1, std::min(sms / std::max(nh, 1), most));
  p.per = (Lq + p.chunks - 1) / p.chunks;
  p.chunks = (Lq + p.per - 1) / p.per;
  for (int l = 0; l < L; ++l) p.srow[l] = -1;
  if (p.vec == 4 && D <= kBoxRows) {
    // levels by rows, smallest first (ties: value order)
    int order[kMaxLevels];
    for (int l = 0; l < L; ++l) order[l] = l;
    for (int i = 1; i < L; ++i) {
      for (int j = i; j > 0; --j) {
        const long long a = 1LL * hs[order[j]] * ws[order[j]];
        const long long b = 1LL * hs[order[j - 1]] * ws[order[j - 1]];
        if (a >= b) break;
        std::swap(order[j], order[j - 1]);
      }
    }
    const int row_bytes = D * 4;
    const int m = 128 / gcd(128, row_bytes);   // boxes stay 128-B aligned
    long long used = 0;
    for (int i = 0; i < L; ++i) {
      const int l = order[i];
      const long long rows = 1LL * hs[l] * ws[l];
      if (rows > 4LL * P * p.per) continue;
      const int boxes = static_cast<int>((rows + kBoxRows - 1) / kBoxRows);
      int br = static_cast<int>((rows + boxes - 1) / boxes);
      br = (br + m - 1) / m * m;
      const long long bytes = 1LL * boxes * br * row_bytes;
      if (used + bytes > kStageBytes) continue;
      p.staged |= 1 << l;
      p.srow[l] = static_cast<int>(used / row_bytes);
      p.box_rows[l] = br;
      p.boxes[l] = boxes;
      used += bytes;
    }
    p.stage_rows = static_cast<int>(used / row_bytes);
  }
  // the corner tables, the staged rows, 128 bytes of alignment slack
  p.smem = kTableBytes + p.stage_rows * D * 4 + 128;
  return p;
}

struct Params {
  const float* value;
  const float* loc;
  const float* attn;
  float* out;
  int N, S, Lq, H, D, L, P;
  int chunks, per, staged, stage_bytes;
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
  int srow[kMaxLevels], box_rows[kMaxLevels], boxes[kMaxLevels];
};

struct Maps {
  CUtensorMap m[kMaxLevels];   // one per staged level (its box rows)
};

// a level as the block reads it (shared memory, so that a run-time level
// index reads no kernel parameter)
struct Level {
  float wf, hf;
  int w, h;
  int base;        // first row: shared row if staged, else row of value
  int start;       // first row of value
  int srow, box_rows, boxes;   // staged: shared row, TMA boxes
};

template <int V>
struct Acc;

// a lane's columns of a row, summed: `fma` loads them through the pointer
// it is given (a pointer into the staged rows is a shared-memory load)
template <>
struct Acc<4> {
  float4 v;
  __device__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ void add(float w, const float4& x) {
    v.x += w * x.x;
    v.y += w * x.y;
    v.z += w * x.z;
    v.w += w * x.w;
  }
  __device__ void fma(float w, const float* p) {
    add(w, *reinterpret_cast<const float4*>(p));
  }
  __device__ void add(const Acc& o) {
    v.x += o.v.x;
    v.y += o.v.y;
    v.z += o.v.z;
    v.w += o.v.w;
  }
  __device__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Acc<1> {
  float v;
  __device__ void zero() { v = 0.f; }
  __device__ void fma(float w, const float* p) { v += w * *p; }
  __device__ void add(const Acc& o) { v += o.v; }
  __device__ void store(float* p) const { *p = v; }
};

// a point's four corners as a task's table holds them: rows (clamped
// into the level, from its base row) and weights (0 for a corner outside
// it), in the order (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)
struct __align__(16) Corners {
  int idx[4];
  float w[4];
};

// the corners of point (lx, ly) of a level, weighted by a
__device__ __forceinline__ void corners(const Level& lv, float lx, float ly,
                                        float a, Corners* out) {
  const float x = lx * lv.wf - 0.5f;
  const float y = ly * lv.hf - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float dx = x - x0, dy = y - y0;
  // clamp before the int conversion; corners it moves are outside anyway
  const int cx = static_cast<int>(fminf(fmaxf(x0, -2.0f), lv.wf));
  const int cy = static_cast<int>(fminf(fmaxf(y0, -2.0f), lv.hf));
  const bool inx0 = cx >= 0 && cx < lv.w, inx1 = cx + 1 >= 0 && cx + 1 < lv.w;
  const bool iny0 = cy >= 0 && cy < lv.h, iny1 = cy + 1 >= 0 && cy + 1 < lv.h;
  const int rx0 = min(max(cx, 0), lv.w - 1);
  const int rx1 = min(max(cx + 1, 0), lv.w - 1);
  const int ry0 = lv.base + min(max(cy, 0), lv.h - 1) * lv.w;
  const int ry1 = lv.base + min(max(cy + 1, 0), lv.h - 1) * lv.w;
  Corners e;
  e.idx[0] = ry0 + rx0;
  e.idx[1] = ry0 + rx1;
  e.idx[2] = ry1 + rx0;
  e.idx[3] = ry1 + rx1;
  e.w[0] = inx0 && iny0 ? (1.0f - dx) * (1.0f - dy) * a : 0.0f;
  e.w[1] = inx1 && iny0 ? dx * (1.0f - dy) * a : 0.0f;
  e.w[2] = inx0 && iny1 ? (1.0f - dx) * dy * a : 0.0f;
  e.w[3] = inx1 && iny1 ? dx * dy * a : 0.0f;
  *out = e;
}

// the points of a task whose levels are fixed at compile time: which are
// staged, and how many are not (their rows wait in registers)
template <int NL, int NP, int ST>
struct Points {
  __host__ __device__ static constexpr bool staged(int j) {
    return (ST >> (j / NP)) & 1;
  }
  __host__ __device__ static constexpr int far() {
    int f = 0;
    for (int j = 0; j < NL * NP; ++j) f += staged(j) ? 0 : 1;
    return f;
  }
};

// V: floats a lane loads per row (4: float4 lanes; 1: scalar lanes);
// NL, NP, ST: levels, points and the staged levels' bits when fixed at
// compile time (0, 0, -1: at run time)
template <int V, int NL, int NP, int ST>
__global__ void __launch_bounds__(kThreads, 1)
ms_deform_attn_kernel(const Params prm, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) uint8_t raw[];
  __shared__ Level lv[kMaxLevels];
  __shared__ __align__(8) uint64_t bar;
  constexpr int kFixed = NL * NP;           // points a task when fixed
  constexpr int kRounds = kFixed ? (kFixed + kGroup - 1) / kGroup : 1;
  static_assert(kFixed <= kTableSlots, "a task's points fill its table");

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = blockIdx.x % prm.chunks;
  const int nh = blockIdx.x / prm.chunks;
  const int h = nh % prm.H;
  const int n = nh / prm.H;
  const int D = prm.D, H = prm.H;
  const int L = NL ? NL : prm.L;
  const int P = NP ? NP : prm.P;
  const int lp = L * P;
  uint8_t* base = raw + ((128 - (hopper::smem_addr(raw) & 127)) & 127);
  Corners* table = reinterpret_cast<Corners*>(base);
  float* stage = reinterpret_cast<float*>(base + kTableBytes);

  // constant indices into the parameters (unrolled): no local copy
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (threadIdx.x == l && l < L) {
      const bool st = (prm.staged >> l) & 1;
      lv[l] = {static_cast<float>(prm.w[l]), static_cast<float>(prm.h[l]),
               prm.w[l], prm.h[l], st ? prm.srow[l] : prm.start[l],
               prm.start[l], prm.srow[l], prm.box_rows[l],
               prm.boxes[l]};
    }
  }
  if (threadIdx.x == 0 && prm.staged) {
    hopper::mbar_init(&bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0 && prm.staged) {
    hopper::mbar_arrive_expect_tx(&bar, prm.stage_bytes);
    for (int l = 0; l < L; ++l) {
      if (!((prm.staged >> l) & 1)) continue;
      for (int b = 0; b < lv[l].boxes; ++b) {
        const int r = b * lv[l].box_rows;
        hopper::tma_load_4d(stage + static_cast<size_t>(lv[l].srow + r) * D,
                            &maps.m[l], &bar, 0, h, lv[l].start + r, n);
      }
    }
  }

  // a group of 8 lanes owns a task: lane c prepares the corners of points
  // c, c + 8, ... of it, and sums columns c * V + 8V i over every point
  const int c = lane & (kGroup - 1);
  const int group = lane / kGroup;
  // a warp's table is [point][group]: the four groups' entries of a point
  // are 128 contiguous bytes, so reading them is free of bank conflicts
  constexpr int kQuads = 32 / kGroup;              // tasks a warp
  Corners* mine = table + warp * kTableSlots * kQuads + group;
  constexpr int kSlots = kWarps * kQuads;          // tasks in flight
  const int begin = chunk * prm.per;
  const int end = min(begin + prm.per, prm.Lq);
  const long long hd = static_cast<long long>(H) * D;
  // the fixed-shape path's row offsets in 32 bits (the entry takes it only
  // for an (n, h) slice of value below 2^31 floats)
  const int hd32 = H * D;
  const float* val = prm.value + static_cast<long long>(n) * prm.S * hd +
                     static_cast<long long>(h) * D;
  // point 8r + c of the task of query q: its location and weight (0 past
  // the last point)
  auto held = [&](int q, int r, float* x, float* y, float* a) {
    const int j = r * kGroup + c;
    *x = *y = *a = 0.0f;
    if (j < lp) {
      const long long task = (static_cast<long long>(n) * prm.Lq + q) * H + h;
      *x = __ldg(prm.loc + (task * lp + j) * 2);
      *y = __ldg(prm.loc + (task * lp + j) * 2 + 1);
      *a = __ldg(prm.attn + task * lp + j);
    }
  };
  // point jj in the table (of level l), summed into acc: with the staged
  // levels fixed only staged points come here, read from shared memory
  auto gather = [&](Acc<V>& acc, int jj, int l, int colc) {
    const Corners e = mine[jj * kQuads];
    if (ST >= 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc.fma(e.w[k], stage + e.idx[k] * D + colc);
      }
    } else {
      const bool st = (prm.staged >> l) & 1;
      const float* rows = st ? stage : val;
      const long long stride = st ? D : hd;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc.fma(e.w[k], rows + e.idx[k] * stride + colc);
      }
    }
  };

  int t = begin + warp * kQuads + group;
  int q = t < end ? t : 0;
  // fixed shapes: the inputs of the lane's points, one task ahead
  float nx[kRounds], ny[kRounds], na[kRounds];
  if (kFixed) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) held(q, r, &nx[r], &ny[r], &na[r]);
  }
  if (prm.staged) hopper::mbar_wait(&bar, 0);

  // every lane runs while the warp's first group has a task (the warp
  // syncs around its table); a group past the end stores nothing
  for (; t - group < end; t += kSlots) {
    const int tn = t + kSlots;
    const int qn = tn < end ? tn : 0;
    float cx[kRounds], cy[kRounds], ca[kRounds];
    if (kFixed) {
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        cx[r] = nx[r];
        cy[r] = ny[r];
        ca[r] = na[r];
        held(qn, r, &nx[r], &ny[r], &na[r]);
      }
    }
    float* out = prm.out + (static_cast<long long>(n) * prm.Lq + q) * hd +
                 static_cast<long long>(h) * D;
    for (int c0 = 0; c0 < D; c0 += kGroup * V) {
      const int col = c0 + c * V;
      const int colc = col < D ? col : 0;
      Acc<V> acc;
      acc.zero();
      if constexpr (kFixed > 0) {
        // every point's corners into the table at once
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          const int j = r * kGroup + c;
          if (j < kFixed) {
            corners(lv[j / NP], cx[r], cy[r], ca[r], &mine[j * kQuads]);
          }
        }
        __syncwarp();
        // the rows in global memory (the longest wait) are asked for
        // ahead, a pair of far points at a time: the first pair before
        // the staged points, each next pair when the staged points
        // between two pairs are summed, so one pair waits in registers.
        // Staged points are summed in order into acc, far ones in order
        // into far_acc, and the sum is acc + far_acc: a fixed order
        using Pts = Points<NL, NP, ST>;
        constexpr int kFar = Pts::far();
        constexpr int kPairs = (kFar + 1) / 2;
        static_assert(kFixed - kFar >= kPairs, "staged points between pairs");
        constexpr int kPer = kPairs ? (kFixed - kFar + kPairs - 1) / kPairs
                                    : kFixed;
        Acc<V> far_acc;
        far_acc.zero();
        float4 far[2][4];
        // ask for the rows of far points [from, from + 2), sum those of
        // [from - 2, from); the indices fold to constants once unrolled
        auto pair = [&](int from) {
#pragma unroll
          for (int j = 0, i = 0; j < kFixed; ++j) {
            if (Pts::staged(j)) continue;
            const Corners e = mine[j * kQuads];
            if (i >= from - 2 && i < from) {
#pragma unroll
              for (int k = 0; k < 4; ++k) far_acc.add(e.w[k], far[i % 2][k]);
            }
            if (i >= from && i < from + 2) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                far[i % 2][k] = __ldg(reinterpret_cast<const float4*>(
                    val + e.idx[k] * hd32 + colc));
              }
            }
            ++i;
          }
        };
        pair(0);
#pragma unroll
        for (int j = 0, s = 0; j < kFixed; ++j) {
          if (!Pts::staged(j)) continue;
          gather(acc, j, j / NP, colc);
          if (++s % kPer == 0) pair(2 * (s / kPer));
        }
        if ((kFixed - kFar) % kPer != 0) pair(2 * kPairs);
        acc.add(far_acc);
        __syncwarp();
      } else {
        for (int j0 = 0; j0 < lp; j0 += kGroup) {
          float x, y, a;
          held(q, j0 / kGroup, &x, &y, &a);
          if (j0 + c < lp) {
            corners(lv[(j0 + c) / P], x, y, a, &mine[c * kQuads]);
          }
          __syncwarp();
          const int count = min(kGroup, lp - j0);
          for (int jj = 0; jj < count; ++jj) {
            gather(acc, jj, (j0 + jj) / P, colc);
          }
          __syncwarp();
        }
      }
      if (t < end && col < D) acc.store(out + col);
    }
    q = qn;
  }
}

// a 4-D map over value (D, H, S, N) whose boxes are (D, 1, rows, 1)
bool encode_level(CUtensorMap* map, const float* value, int N, int S, int H,
                  int D, int rows) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 4, static_cast<cuuint64_t>(H) * D * 4,
      static_cast<cuuint64_t>(S) * H * D * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
            const_cast<float*>(value), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// launch, granting the kernel its shared memory once per device and size
template <int V, int NL, int NP, int ST>
cudaError_t launch(const Params& prm, const Maps& maps, unsigned blocks,
                   int smem, cudaStream_t st) {
  static hopper::SmemGrant granted;
  auto kernel = ms_deform_attn_kernel<V, NL, NP, ST>;
  const cudaError_t err = granted.ensure(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, st>>>(prm, maps);
  return cudaGetLastError();
}

}  // namespace

// value (N, S, H, D), loc (N, Lq, H, L, P, 2), attn (N, Lq, H, L, P),
// out (N, Lq, H*D), all fp32 and contiguous; shapes: L (H_l, W_l) pairs on
// the host, in value's level order. chunks, staged and smem are the
// Python plan's (experts/ops/deform_attn.deform_plan); a call whose plan
// differs from make_plan's is refused. Returns a cudaError_t (0 on
// success).
extern "C" int prismer_ms_deform_attn(const float* value, const float* loc,
                                      const float* attn, float* out,
                                      const int* shapes, int N, int S, int Lq,
                                      int H, int D, int L, int P, int chunks,
                                      int staged, int smem, void* stream) {
  if (N <= 0 || Lq <= 0 || H <= 0 || D <= 0 || P <= 0 || L <= 0 ||
      L > kMaxLevels) {
    return cudaErrorInvalidValue;
  }
  Params prm = {};
  int hs[kMaxLevels], ws[kMaxLevels];
  int start = 0;
  for (int l = 0; l < L; ++l) {
    if (shapes[2 * l] <= 0 || shapes[2 * l + 1] <= 0) {
      return cudaErrorInvalidValue;
    }
    hs[l] = prm.h[l] = shapes[2 * l];
    ws[l] = prm.w[l] = shapes[2 * l + 1];
    prm.start[l] = start;
    start += hs[l] * ws[l];
  }
  if (start != S) return cudaErrorInvalidValue;
  // the SM count is kept per device: a call at one image is short enough
  // that the host's work shows beside it
  const int sms = hopper::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const bool aligned = reinterpret_cast<uintptr_t>(value) % 16 == 0;
  const Plan p = make_plan(hs, ws, N, S, Lq, H, D, L, P, sms, aligned);
  if (chunks != p.chunks || staged != p.staged || smem != p.smem) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = 1LL * N * H * p.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  prm.value = value;
  prm.loc = loc;
  prm.attn = attn;
  prm.out = out;
  prm.N = N;
  prm.S = S;
  prm.Lq = Lq;
  prm.H = H;
  prm.D = D;
  prm.L = L;
  prm.P = P;
  prm.chunks = p.chunks;
  prm.per = p.per;
  prm.staged = p.staged;
  prm.stage_bytes = p.stage_rows * D * 4;
  Maps maps = {};
  for (int l = 0; l < L; ++l) {
    prm.srow[l] = p.srow[l];
    prm.box_rows[l] = p.box_rows[l];
    prm.boxes[l] = p.boxes[l];
    if (((p.staged >> l) & 1) &&
        !encode_level(&maps.m[l], value, N, S, H, D, p.box_rows[l])) {
      return cudaErrorInvalidValue;
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  // the pixel decoder's shapes: 3 levels of 4 points, the first two staged
  if (p.vec == 4 && L == 3 && P == 4 && p.staged == 3 &&
      1LL * S * H * D < (1LL << 31)) {
    return launch<4, 3, 4, 3>(prm, maps, grid, p.smem, st);
  }
  if (p.vec == 4) {
    return launch<4, 0, 0, -1>(prm, maps, grid, p.smem, st);
  }
  return launch<1, 0, 0, -1>(prm, maps, grid, p.smem, st);
}
