// One step of beam-search bookkeeping for Hopper (sm_90a).
//
// Replaces prismer_tpu/ops/beam_update.py beam_update (_kernel): everything
// between candidate selection and the decoder step. EOS candidates ranked
// below K retire into the finished set with a length-penalised score; the
// top-K non-EOS candidates continue; done samples freeze; the flat beam
// permutation for the self-cache reorder comes out alongside. The spec is
// prismer_tpu/models/generation.py beam_bookkeeping, and the outputs are
// bit-identical to it (and to the plain PyTorch port beside this kernel).
//
// What bounds it on the H100: nothing the card measures. It touches a few
// kilobytes per step (B*K sequences of T int32 tokens), so its cost is the
// launch and a few dependent memory round trips. The TPU kernel's 0/1
// selector matmuls and 128-lane canvases (beam_update.py:89-99, :122-145)
// existed because the TPU has no cheap gather; here direct indexing
// replaces them. Design: one warp per sample, several samples a block. The
// lanes load the 2K candidates (2K <= 32) and both score rows in one
// coalesced load each; the done rule on the old state takes warp min / max
// (exact in any order); both top-K selections (3K merged finished
// candidates, two per lane, and 2K continuing ones) are K rounds of a
// shuffle arg-max, lowest index on ties (lax.top_k order), each round
// taking the best entry not yet taken; the warp then copies the K*T
// sequence entries, as int4 where T % 4 == 0. Division by the length
// penalty is IEEE (no fast math), so scores are bit-identical to the fp32
// reference.
//
// It launches with programmatic stream serialization after lm_topk's
// selection kernel, which triggers after its own wait, so it becomes
// resident only once lm_topk's logits kernel and everything before it have
// completed. Before its wait it reads only the old score rows, which
// lm_topk does not write; it writes nothing before the wait. On the
// per-layer path it follows PyTorch's kernels, and the wait ends at their
// completion.

#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1.0e7f;  // generation.py:38 NEG_INF
constexpr int kMaxBeams = 16;       // 2K candidates in one warp's lanes
constexpr int kWarps = 4;           // samples per block
constexpr unsigned kAll = 0xffffffffu;

// (value desc, index asc): the first index among equal values wins
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// the warp's best (value, index) offer, on every lane
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kAll, v, o);
    const int oi = __shfl_xor_sync(kAll, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

struct Args {
  const float* vals;     // (B, 2K) candidates
  const int* beam;
  const int* tok;
  const int* aseq;       // (B*K, T) old state
  const float* ascore;   // (B, K)
  const int* fseq;
  const float* fscore;
  int* out_aseq;
  float* out_ascore;
  int* out_fseq;
  float* out_fscore;
  int* out_tok;
  int* out_beam;         // (B, K) flat source rows
  int B, K, T, index;
  float pen;
  int eos_id, pad_id;
};

// Copy sample b's K alive and K finished rows in VEC-int units: output row
// r of the alive set reads alive row a_src(r) (its token at `index` put
// over it), of the finished set finished row f_src(r), or alive row f_src(r)
// with EOS at `index` (f_alive); a done sample keeps its rows. Lane r holds
// row r's sources.
template <int VEC>
__device__ __forceinline__ void copy_rows(const Args& p, int b, int lane,
                                          bool done, int a_src, int a_tok,
                                          int f_src, bool f_alive) {
  using Unit = typename std::conditional<VEC == 4, int4, int>::type;
  const int tv = p.T / VEC;
  const int per = p.K * tv;     // units per set
  const size_t base = static_cast<size_t>(b) * p.K * p.T;
  for (int u0 = 0; u0 < 2 * per; u0 += 32) {
    const int u = u0 + lane;
    const bool act = u < 2 * per;
    const int fin = act && u >= per;
    const int rem = u - fin * per;
    const int r = act ? rem / tv : 0;
    const int c = rem - r * tv;
    const int as_r = __shfl_sync(kAll, a_src, r);
    const int at_r = __shfl_sync(kAll, a_tok, r);
    const int fs_r = __shfl_sync(kAll, f_src, r);
    const bool fa_r = __shfl_sync(kAll, f_alive ? 1 : 0, r) != 0;
    if (!act) continue;
    const int* src;
    bool put = false;
    int token = 0;
    if (done) {
      src = (fin ? p.fseq : p.aseq) + base + r * p.T;
    } else if (!fin) {
      src = p.aseq + base + as_r * p.T;
      put = true;
      token = at_r;
    } else if (fa_r) {
      src = p.aseq + base + fs_r * p.T;
      put = true;
      token = p.eos_id;
    } else {
      src = p.fseq + base + fs_r * p.T;
    }
    Unit x = reinterpret_cast<const Unit*>(src)[c];
    if (put && p.index / VEC == c) {
      if constexpr (VEC == 4) {
        switch (p.index % 4) {
          case 0: x.x = token; break;
          case 1: x.y = token; break;
          case 2: x.z = token; break;
          default: x.w = token; break;
        }
      } else {
        x = token;
      }
    }
    int* dst = (fin ? p.out_fseq : p.out_aseq) + base + r * p.T;
    reinterpret_cast<Unit*>(dst)[c] = x;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32)
beam_update_kernel(const Args p) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + threadIdx.x / 32;
  const bool live = b < p.B;
  const int K = p.K;
  const int KK = 2 * K;
  // the old scores: not written by lm_topk, whose selection this kernel
  // follows, so read before the wait
  float fs = INFINITY, as = -INFINITY;
  if (live && lane < K) {
    fs = p.fscore[b * K + lane];
    as = p.ascore[b * K + lane];
  }
  hopper::grid_dep_wait();
  if (!live) return;

  float v = 0.f;
  int bm = 0, tk = 0;
  if (lane < KK) {
    v = p.vals[b * KK + lane];
    bm = p.beam[b * KK + lane];
    tk = p.tok[b * KK + lane];
  }
  // done rule on the OLD state (generation.batch_done)
  float worst = fs, best = as;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    worst = fminf(worst, __shfl_xor_sync(kAll, worst, o));
    best = fmaxf(best, __shfl_xor_sync(kAll, best, o));
  }
  const bool done = worst >= best / p.pen;

  // merged [old finished (K) ; EOS candidates (2K)]: entry q in lane q % 32,
  // slot q / 32; entries past 3K count as taken
  float mv[2];
  bool taken[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s;
    const int j = q - K;
    const float f_q = __shfl_sync(kAll, fs, q & 31);
    const float v_j = __shfl_sync(kAll, v, j & 31);
    const int t_j = __shfl_sync(kAll, tk, j & 31);
    if (q < K) {
      mv[s] = f_q;
    } else {
      const bool fin = t_j == p.eos_id && j < K && !done;
      mv[s] = fin ? v_j / p.pen : kNegInf;
    }
    taken[s] = q >= 3 * K;
  }
  int f_src = 0;       // lane r: merged entry of finished slot r
  float f_score = 0.f;
  for (int r = 0; r < K; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    if (!taken[0]) {
      bv = mv[0];
      bi = lane;
    }
    if (!taken[1] && better(mv[1], lane + 32, bv, bi)) {
      bv = mv[1];
      bi = lane + 32;
    }
    warp_best(bv, bi);
    if (lane == (bi & 31)) {
      if (bi >= 32) {
        taken[1] = true;
      } else {
        taken[0] = true;
      }
    }
    if (lane == r) {
      f_src = bi;
      f_score = bv;
    }
  }

  // continue with the top-K non-EOS candidates
  const float cv = tk == p.eos_id ? kNegInf : v;
  bool ctaken = lane >= KK;
  int n_beam = 0, n_tok = 0;   // lane r: continuing slot r
  float n_score = 0.f;
  for (int r = 0; r < K; ++r) {
    float bv = ctaken ? -INFINITY : cv;
    int bi = ctaken ? INT_MAX : lane;
    warp_best(bv, bi);
    if (lane == bi) ctaken = true;
    const int nb = __shfl_sync(kAll, bm, bi);
    const int nt = __shfl_sync(kAll, tk, bi);
    if (lane == r) {
      n_beam = nb;
      n_tok = nt;
      n_score = bv;
    }
  }

  // a finished slot fed by candidate j reads alive row beam[j]
  const int cand_beam = __shfl_sync(kAll, bm, (f_src - K) & 31);
  const bool f_alive = f_src >= K;
  copy_rows<VEC>(p, b, lane, done, n_beam, n_tok,
                 f_alive ? cand_beam : f_src, f_alive);
  if (lane < K) {
    const int o = b * K + lane;
    p.out_ascore[o] = done ? as : n_score;
    p.out_fscore[o] = done ? fs : f_score;
    p.out_tok[o] = done ? p.pad_id : n_tok;
    p.out_beam[o] = n_beam + b * K;
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// Returns a cudaError_t (0 on success).
extern "C" int prismer_beam_update(
    const float* vals, const int* beam, const int* tok, const int* aseq,
    const float* ascore, const int* fseq, const float* fscore, int* out_aseq,
    float* out_ascore, int* out_fseq, float* out_fscore, int* out_tok,
    int* out_beam, int B, int K, int T, int index, float pen, int eos_id,
    int pad_id, void* stream) {
  if (B <= 0 || K <= 0 || K > kMaxBeams || index < 0 || index >= T) {
    return cudaErrorInvalidValue;
  }
  const Args p{vals,      beam,     tok,        aseq,    ascore,
               fseq,      fscore,   out_aseq,   out_ascore, out_fseq,
               out_fscore, out_tok, out_beam,   B,       K,
               T,         index,    pen,        eos_id,  pad_id};
  const dim3 grid((B + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = T % 4 == 0 && aligned16(aseq) && aligned16(fseq) &&
                   aligned16(out_aseq) && aligned16(out_fseq);
  const cudaError_t err =
      vec ? hopper::launch_pdl(beam_update_kernel<4>, grid, kWarps * 32, 0,
                               st, p)
          : hopper::launch_pdl(beam_update_kernel<1>, grid, kWarps * 32, 0,
                               st, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}
