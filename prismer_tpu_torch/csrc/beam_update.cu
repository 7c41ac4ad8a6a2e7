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
// kilobytes per step (B*K sequences of T int32 tokens), so its cost is one
// launch. The TPU kernel's 0/1 selector matmuls and 128-lane canvases
// (beam_update.py:89-99, :122-145) existed because the TPU has no cheap
// gather; here direct indexing replaces them. Design: one block per sample;
// thread 0 runs the two tiny top-K selections (2K and 3K candidates) in
// shared memory, then the whole block copies the K*T sequence entries.
//
// Tie order: both top-K loops pick the lowest index among equal values
// (lax.top_k order). Division by the length penalty is IEEE (no fast math),
// so scores are bit-identical to the fp32 reference.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1.0e7f;  // generation.py:38 NEG_INF
constexpr int kMaxBeams = 16;
constexpr int kThreads = 128;

// lowest-index-first arg-max over the entries not yet taken
__device__ int argmax_untaken(const float* x, const bool* taken, int n) {
  int best = -1;
  for (int i = 0; i < n; ++i) {
    if (taken[i]) continue;
    if (best < 0 || x[i] > x[best]) best = i;
  }
  return best;
}

__global__ void __launch_bounds__(kThreads)
beam_update_kernel(const float* __restrict__ vals, const int* __restrict__ beam,
                   const int* __restrict__ tok, const int* __restrict__ aseq,
                   const float* __restrict__ ascore,
                   const int* __restrict__ fseq,
                   const float* __restrict__ fscore, int* __restrict__ out_aseq,
                   float* __restrict__ out_ascore, int* __restrict__ out_fseq,
                   float* __restrict__ out_fscore, int* __restrict__ out_tok,
                   int* __restrict__ out_beam, int K, int T, int index,
                   float pen, int eos_id, int pad_id) {
  const int b = blockIdx.x;
  const int KK = 2 * K;
  __shared__ int s_done;
  __shared__ int fin_src[kMaxBeams];    // merged index: < K old, else K + j
  __shared__ float fin_score[kMaxBeams];
  __shared__ int new_beam[kMaxBeams];
  __shared__ int new_tok[kMaxBeams];
  __shared__ float new_score[kMaxBeams];

  const float* v = vals + b * KK;
  const int* bm = beam + b * KK;
  const int* tk = tok + b * KK;

  if (threadIdx.x == 0) {
    // done rule on the OLD state (generation.batch_done)
    float worst = fscore[b * K];
    float best = ascore[b * K];
    for (int i = 1; i < K; ++i) {
      worst = fminf(worst, fscore[b * K + i]);
      best = fmaxf(best, ascore[b * K + i]);
    }
    const bool done = worst >= best / pen;
    s_done = done ? 1 : 0;

    // merged [old finished ; EOS candidates] scores, then top-K
    float merged[3 * kMaxBeams];
    bool taken[3 * kMaxBeams];
    for (int i = 0; i < K; ++i) merged[i] = fscore[b * K + i];
    for (int j = 0; j < KK; ++j) {
      const bool fin = tk[j] == eos_id && j < K && !done;
      merged[K + j] = fin ? v[j] / pen : kNegInf;
    }
    for (int i = 0; i < 3 * K; ++i) taken[i] = false;
    for (int r = 0; r < K; ++r) {
      const int i = argmax_untaken(merged, taken, 3 * K);
      taken[i] = true;
      fin_src[r] = i;
      fin_score[r] = merged[i];
    }

    // continue with the top-K non-EOS candidates
    float cont[2 * kMaxBeams];
    for (int j = 0; j < KK; ++j) {
      cont[j] = tk[j] == eos_id ? kNegInf : v[j];
      taken[j] = false;
    }
    for (int r = 0; r < K; ++r) {
      const int j = argmax_untaken(cont, taken, KK);
      taken[j] = true;
      new_score[r] = cont[j];
      new_beam[r] = bm[j];
      new_tok[r] = tk[j];
    }
  }
  __syncthreads();
  const bool done = s_done != 0;

  const int* a_rows = aseq + static_cast<long long>(b) * K * T;
  const int* f_rows = fseq + static_cast<long long>(b) * K * T;
  int* oa = out_aseq + static_cast<long long>(b) * K * T;
  int* of = out_fseq + static_cast<long long>(b) * K * T;
  for (int e = threadIdx.x; e < K * T; e += blockDim.x) {
    const int r = e / T;
    const int t = e - r * T;
    if (done) {
      oa[e] = a_rows[e];
      of[e] = f_rows[e];
      continue;
    }
    oa[e] = t == index ? new_tok[r] : a_rows[new_beam[r] * T + t];
    const int src = fin_src[r];
    if (src < K) {
      of[e] = f_rows[src * T + t];
    } else {
      of[e] = t == index ? eos_id : a_rows[bm[src - K] * T + t];
    }
  }
  if (threadIdx.x < K) {
    const int r = threadIdx.x;
    out_ascore[b * K + r] = done ? ascore[b * K + r] : new_score[r];
    out_fscore[b * K + r] = done ? fscore[b * K + r] : fin_score[r];
    out_tok[b * K + r] = done ? pad_id : new_tok[r];
    out_beam[b * K + r] = new_beam[r] + b * K;
  }
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
  beam_update_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, beam, tok, aseq, ascore, fseq, fscore, out_aseq, out_ascore,
      out_fseq, out_fscore, out_tok, out_beam, K, T, index, pen, eos_id,
      pad_id);
  return cudaGetLastError();
}
