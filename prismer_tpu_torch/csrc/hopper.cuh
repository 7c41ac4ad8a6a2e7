// Hopper (sm_90a) building blocks in inline PTX: TMA tensor loads,
// mbarriers, ldmatrix, and warpgroup matrix products (wgmma) with their
// shared-memory descriptors. Used by the flash-attention forward and
// backward kernels (flash_attention.cu, flash_attention_bwd.cu), the
// grouped decode cross-attention (decode_attention.cu), the fused decode
// step (fused_decode.cu), the decode loop's tail (lm_topk.cu,
// beam_update.cu), the fused label-smoothed CE (fused_ce.cu) and the
// encoder's LayerNorm-fed projections (ln_proj.cu); written
// without CUTLASS / CuTe so that every build error names a line of this
// repository.
//
// Shared-memory tiles are bf16, 64 columns (128 bytes) per row, in the
// 128-byte swizzle that a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes
// and a wgmma descriptor of layout type 1 reads. A tile wider than 64
// columns is stored as column blocks of 64, one after the other
// ([block][row][64]); every block starts 1024-byte aligned, the period of
// the swizzle. Two ways to read such a tile as a wgmma operand:
//   * K-major (the product's reduction runs along the row, e.g. S = Q K^T
//     over the head dim): 8-row groups 1024 bytes apart (SBO); the k-th
//     16-column step starts (k % 4) * 32 bytes into block k / 4;
//   * MN-major (the reduction runs down the rows, e.g. dV += P^T dO over
//     queries): 16 rows per k-step, 2048 bytes apart, 8-row groups 1024
//     bytes apart; one instruction covers at most the 64 columns of one
//     block, so a head dim of 80, 96 or 160 takes 64-, 32- or 16-wide
//     instructions, one per block.
// Accumulators (fp32) and register A operands (bf16 pairs) follow the
// mma.sync m16n8k16 fragment layout per warp: warp w of the warpgroup holds
// rows 16w + gid and 16w + gid + 8 (gid = lane / 4), columns 8j + 2 * (lane
// % 4) + {0, 1}; accumulator d[4j + 2 * half + e] is row 16w + gid + 8 *
// half, column 8j + 2 * (lane % 4) + e.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the driver is reached
                    // through cudaGetDriverEntryPoint, not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <utility>

namespace hopper {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that the runtime loaded, or null
inline EncodeTiled encode_tiled() {
  // looked up once: a function-local static is initialised thread-safely
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      return reinterpret_cast<EncodeTiled>(ptr);
    }
    return nullptr;
  }();
  return fn;
}

// A (B, H, L, D) view of `elt`-byte elements with element strides (sb, sh,
// sl, 1), loaded in boxes of 128 bytes of columns (64 bf16, 32 fp32) x
// `rows` rows of one (batch, head), 128-byte swizzle. Rows past L and
// columns past D read as zeros. The strides of extent-1 dimensions are never
// followed, so any multiple of 16 bytes stands in for them.
inline bool encode_rows(CUtensorMap* map, CUtensorMapDataType type, int elt,
                        const void* base, int B, int H, int L, int D,
                        int64_t sb, int64_t sh, int64_t sl, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  if (L == 1) sl = 16 / elt;
  if (H == 1) sh = sl * L;
  if (B == 1) sb = sh * H;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * elt,
                                 static_cast<cuuint64_t>(sh) * elt,
                                 static_cast<cuuint64_t>(sb) * elt};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / elt),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 rows: boxes of 64 columns
inline bool encode_bf16_rows(CUtensorMap* map, const void* base, int B, int H,
                             int L, int D, int64_t sb, int64_t sh, int64_t sl,
                             int rows) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, B, H, L,
                     D, sb, sh, sl, rows);
}

// fp32 rows: boxes of 32 columns, so a 64-column row takes two column
// blocks of 128 bytes
inline bool encode_f32_rows(CUtensorMap* map, const void* base, int B, int H,
                            int L, int D, int64_t sb, int64_t sh, int64_t sl,
                            int rows) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, B, H, L,
                     D, sb, sh, sl, rows);
}

// every base 16-byte aligned and every stride a multiple of `elems`
// elements: 8 for the bf16 tensor maps above (16-byte rows), 4 for fp32
// kernels that move rows in 16-byte vectors
inline bool aligned(const void* const* ptrs, int n_ptrs,
                    const int64_t* strides, int n_strides, int elems) {
  for (int i = 0; i < n_strides; ++i) {
    if (strides[i] % elems != 0) return false;
  }
  for (int i = 0; i < n_ptrs; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  }
  return true;
}

// The tensor map of a (rows, cols) row-major bf16 tensor in boxes of 64
// columns x box_rows rows (128-byte swizzle, zeros past the edges), copied
// to *out; false if it cannot be encoded. Encoded once per (pointer, rows,
// cols, box_rows) in one cache of kMapCache entries that every source
// including this header shares: weights do not move between calls, and a
// map stays valid for whatever tensor later lies at the same address with
// the same shape (PyTorch's allocator hands per-call activations and
// scratch back at the same few addresses). The caller gets a copy, made
// under the cache's lock: a later miss, in this thread or another, may
// reuse the cache entry of an earlier hit.
constexpr int kMapCache = 128;

inline bool cached_bf16_map(CUtensorMap* out, const void* p, int rows,
                            int64_t cols, int box_rows) {
  struct Entry {
    const void* p = nullptr;
    int rows = 0;
    int64_t cols = 0;
    int box = 0;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[kMapCache];
  static int next = 0;
  const std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.p == p && e.rows == rows && e.cols == cols && e.box == box_rows) {
      *out = e.map;
      return true;
    }
  }
  Entry& e = cache[next];
  next = (next + 1) % kMapCache;
  e.p = nullptr;
  if (!encode_bf16_rows(&e.map, p, 1, 1, rows, static_cast<int>(cols), 0, 0,
                        cols, box_rows)) {
    return false;
  }
  e.p = p;
  e.rows = rows;
  e.cols = cols;
  e.box = box_rows;
  *out = e.map;
  return true;
}

constexpr size_t kMaxSmem = 227 * 1024;   // a block's shared memory on sm_90

// allow `kernel` `bytes` of dynamic shared memory (above 48 KB needs it)
template <typename K>
cudaError_t grant_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// host: per-device facts. A process may launch on any of its cards, from any
// thread: the wrappers make the tensors' card current for each launch
// (ops/_build.py `launch_device`), and what the host keeps of a card is kept
// per device, under a lock.
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;   // cards whose facts the tables keep

// the current device; a device past the tables is an error, not a miss
inline cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev >= 0 && *dev < kMaxDevices ? cudaSuccess
                                         : cudaErrorInvalidDevice;
}

// the current device's SM count, read once per device; 0 on an error
inline int sm_count() {
  static std::mutex mu;
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (current_device(&dev) != cudaSuccess) return 0;
  const std::lock_guard<std::mutex> lock(mu);
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess) {
    sms[dev] = 0;
  }
  return sms[dev];
}

// One kernel's dynamic shared-memory grant on each device: the attribute
// that cudaFuncSetAttribute sets holds for the current device only. A
// launch site keeps one of these in a static and calls ensure() before each
// launch; the grant is raised when a launch needs more than any before it
// on that device.
class SmemGrant {
 public:
  template <typename K>
  cudaError_t ensure(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = current_device(&dev);
    if (err != cudaSuccess) return err;
    const std::lock_guard<std::mutex> lock(mu_);
    if (bytes_[dev] >= bytes) return cudaSuccess;
    err = grant_smem(kernel, bytes);
    if (err == cudaSuccess) bytes_[dev] = bytes;
    return err;
  }

 private:
  std::mutex mu_;
  size_t bytes_[kMaxDevices] = {};
};

// ---------------------------------------------------------------------------
// programmatic dependent launch
// ---------------------------------------------------------------------------

// Launch `kernel` with programmatic stream serialization: it may become
// resident while the kernel before it on the stream still runs, and waits
// for it in grid_dep_wait. Such a kernel reads before its wait only what
// the kernels before it do not write, writes nothing before it, and every
// one of its blocks executes the wait.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, int threads,
                       size_t smem, cudaStream_t st, Args&&... args) {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// wait until every grid this one was launched after (with the launch
// attribute cudaLaunchAttributeProgrammaticStreamSerialization) has
// completed and its writes are visible; a no-op without the attribute
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// let the next grid of the stream launch once every block of this one has
// issued this (or exited); it then waits in grid_dep_wait
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// device: mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after `raw` (the swizzle's period);
// a kernel asks for 1024 bytes more than its layout for it
__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// barrier `id` (1-15; 0 is __syncthreads) among `threads` threads, a
// multiple of 32
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

// make this thread's shared-memory stores visible to the async proxy
// (a wgmma operand written with plain stores); a barrier follows
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// make initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also adds `bytes` to the transaction count the current
// phase waits for (issue before the copies that complete on it)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// one arrival (release: this thread's earlier shared-memory writes are
// visible to whoever waits on the phase)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a rank-4 tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// an L2 policy that evicts the lines it loads first: for a stream read once
// (a weight that does not fit the L2), so it does not push out what a
// later kernel reads again
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// tma_load_4d with an L2 cache policy
__device__ __forceinline__ void tma_load_4d_hint(void* dst,
                                                 const CUtensorMap* map,
                                                 uint64_t* bar, int c0,
                                                 int c1, int c2, int c3,
                                                 uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "l"(policy)
      : "memory");
}

// one box of shared memory (in the map's swizzle) to a rank-4 tensor map;
// elements past the tensor's edges are not written. Joins the thread's
// open bulk group (commit it, then wait for its reads before the shared
// memory is reused; the grid's end makes the writes visible)
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of the thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// the byte offset of bf16 columns (col, col + 1) of row `row` in a box of
// 64-column (128-byte) rows in the 128-byte swizzle (the layout a TMA load
// writes and a TMA store reads); col even
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// ---------------------------------------------------------------------------
// device: ldmatrix (mma.sync fragments from shared memory)
// ---------------------------------------------------------------------------

// four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, which lands in r[i]: lane t holds row t / 4, columns 2 (t % 4)
// and 2 (t % 4) + 1 (an mma.sync A or B fragment register)
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed: lane t holds rows 2 (t % 4) and
// 2 (t % 4) + 1 of column t / 4 (a B fragment of a row-major k x n tile)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the inverse of ldsm_x4: lanes 8i .. 8i + 7 give the row addresses of
// matrix i, which is written from r[i] (lane t: row t / 4, columns 2 (t % 4)
// and 2 (t % 4) + 1)
__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t* r) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1);
// offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// operand of a product reducing along the 128-byte rows (K-major)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// operand of a product reducing down the rows (MN-major), at most one
// 64-column block wide
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the same for register A operands: kept unchanged (and their registers
// not reused) until here, after the wait that ends the product reading them
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k-step t from an accumulator of the same rows: columns
// 16t .. 16t + 15 of acc, rounded to bf16 (the mma.sync re-pack)
__device__ __forceinline__ void acc_to_a(const float* acc, int t,
                                         uint32_t* a) {
  a[0] = pack_bf16(acc[8 * t + 0], acc[8 * t + 1]);
  a[1] = pack_bf16(acc[8 * t + 2], acc[8 * t + 3]);
  a[2] = pack_bf16(acc[8 * t + 4], acc[8 * t + 5]);
  a[3] = pack_bf16(acc[8 * t + 6], acc[8 * t + 7]);
}

// d (64 x 8) (+)= A (64 x 16, shared, K-major) * B (16 x 8, shared,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n8(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 16) (+)= A (64 x 16, shared, K-major) * B (16 x 16, shared,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 24) (+)= A (64 x 16, shared, K-major) * B (16 x 24, shared,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n24(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32) (+)= A (64 x 16, shared, K-major) * B (16 x 32, shared,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 48) (+)= A (64 x 16, shared, K-major) * B (16 x 48, shared,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n48(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 16) (+)= A (64 x 16, registers) * B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 32) (+)= A (64 x 16, registers) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 64) (+)= A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


// d (64 x 64) (+)= A (64 x 16) * B (16 x 64), both from shared memory;
// TA / TB 1 reads A / B MN-major (transposed), 0 K-major; scale_d 0
// overwrites d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_sst_n64(float* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 128) (+)= A (64 x 16) * B (16 x 128), both from shared memory;
// TA / TB 1 reads A / B MN-major (transposed), 0 K-major; scale_d 0
// overwrites d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_sst_n128(float* d, uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 256) (+)= A (64 x 16) * B (16 x 256), both from shared memory;
// TA / TB 1 reads A / B MN-major (transposed), 0 K-major; scale_d 0
// overwrites d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_sst_n256(float* d, uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x N) (+)= A (64 x 16) * B (16 x N), both from shared memory, each
// K-major (0) or MN-major (1, at most one 64-column block wide: N 64 for an
// MN-major B)
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_sst(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256,
                "wgmma_sst: N is 64, 128 or 256");
  static_assert(TB == 0 || N == 64, "wgmma_sst: an MN-major B is 64 wide");
  if constexpr (N == 64) {
    wgmma_sst_n64<TA, TB>(d, a, b, scale_d);
  } else if constexpr (N == 128) {
    wgmma_sst_n128<TA, TB>(d, a, b, scale_d);
  } else {
    wgmma_sst_n256<TA, TB>(d, a, b, scale_d);
  }
}

// d (64 x N) (+)= A (64 x 16) * B (16 x N): A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 8 || N == 16 || N == 24 || N == 32 || N == 48 ||
                    N == 64,
                "wgmma_ss: N is 8, 16, 24, 32, 48 or 64");
  if constexpr (N == 8) {
    wgmma_ss_n8(d, a, b, scale_d);
  } else if constexpr (N == 16) {
    wgmma_ss_n16(d, a, b, scale_d);
  } else if constexpr (N == 24) {
    wgmma_ss_n24(d, a, b, scale_d);
  } else if constexpr (N == 32) {
    wgmma_ss_n32(d, a, b, scale_d);
  } else if constexpr (N == 48) {
    wgmma_ss_n48(d, a, b, scale_d);
  } else {
    wgmma_ss_n64(d, a, b, scale_d);
  }
}

// d (64 x N) (+)= A (64 x 16, registers) * B (16 x N, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_rs: N is 16, 32, 64");
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, b, scale_d);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, b, scale_d);
  } else {
    wgmma_rs_n64(d, a, b, scale_d);
  }
}

// d (64 x DH) += A (64 x 16, registers) * B, where B is the k-step's 16
// rows of a tile of `rows` rows (column blocks rows * 128 bytes apart),
// MN-major; one instruction per 64-column block
template <int DH, int ROWS>
__device__ __forceinline__ void wgmma_rs_wide(float* d, const uint32_t* a,
                                              uint32_t tile, int t) {
#pragma unroll
  for (int c = 0; c * 64 < DH; ++c) {
    constexpr int kRest = DH % 64 == 0 ? 64 : DH % 64;
    const uint64_t b = mnmajor_desc(tile + c * ROWS * 128 + t * 2048);
    if ((c + 1) * 64 <= DH) {
      wgmma_rs<64>(d + 32 * c, a, b, 1);
    } else {
      wgmma_rs<kRest>(d + 32 * c, a, b, 1);
    }
  }
}

// d (64 x 128) (+)= A (64 x 16, registers) * B (16 x 128, shared, K-major);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_rsk_n128(float* d, const uint32_t* a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// a warpgroup's registers a thread: every warp of the warpgroup executes
// it. A warp-specialised kernel lowers its producer's and raises its
// consumers' (the totals within the register file)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d (64 x N) (+)= A * B^T over DH columns, A (64 rows) and B (N rows) K-major
// tiles of DH columns; the first step overwrites d
template <int DH, int N>
__device__ __forceinline__ void wgmma_ss_rows(float* d, uint32_t a_tile,
                                              uint32_t b_tile) {
#pragma unroll
  for (int k = 0; k < DH / 16; ++k) {
    const uint32_t off_a = (k / 4) * 64 * 128 + (k % 4) * 32;
    const uint32_t off_b = (k / 4) * N * 128 + (k % 4) * 32;
    wgmma_ss<N>(d, kmajor_desc(a_tile + off_a), kmajor_desc(b_tile + off_b),
                k > 0 ? 1 : 0);
  }
}

}  // namespace hopper
