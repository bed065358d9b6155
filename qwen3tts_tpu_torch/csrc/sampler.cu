// K4's standalone entry: sample one token per row of a [R, V] float32 logits
// matrix with the sampler the fused kernels run in their epilogues (no serve
// path calls this entry; frame 0 is drawn by the PyTorch sample_token). A
// row runs on the block of the site that samples rows of its width: up to
// kMaxCodeVocab on the code predictor's (kCodeThreads), up to
// kMaxCodecVocab on the codec head's (kHeadThreads); a wider row is
// refused. See sampler.cuh for the semantics and the design.
#include "sampler.cuh"

namespace {

template <int NT, int EPT>
__global__ void __launch_bounds__(NT) sample_rows_kernel(
    const float* __restrict__ logits, int V, const int* __restrict__ seeds, int step,
    float temp, float top_p, int top_k, int greedy, int use_top_p, int suppress_start,
    int eos_id, const int8_t* __restrict__ seen, float penalty, int* __restrict__ out) {
  __shared__ SampleSmem<NT> sm;
  __shared__ float2 queue[NT * EPT];
  const int r = blockIdx.x;
  float x[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int i = slot_index<NT, 1>(k);
    x[k] = i < V ? logits[(size_t)r * V + i] : 0.f;
  }
  const SampleArgs a{temp, top_p, penalty, top_k, suppress_start, eos_id, greedy != 0,
                     use_top_p != 0, (uint32_t)seeds[r], (uint32_t)step, seen};
  const int tok = suppress_penalize_sample<NT, EPT, 1>(x, V, a, sm, queue);
  if (threadIdx.x == 0) out[r] = tok;
}

template <int NT, int EPT>
int launch_rows(const void* logits, int R, int V, const void* seeds, int step, float temp,
                float top_p, int top_k, int greedy, int use_top_p, int suppress_start,
                int eos_id, const void* seen, float penalty, void* out, cudaStream_t st) {
  sample_rows_kernel<NT, EPT><<<R, NT, 0, st>>>(
      (const float*)logits, V, (const int*)seeds, step, temp, top_p, top_k, greedy, use_top_p,
      suppress_start, eos_id, (const int8_t*)seen, penalty, (int*)out);
  return (int)cudaGetLastError();
}

// The block a row of width V runs on: threads, elements a thread (0, 0
// when none takes it).
inline void row_block(int V, int* nt, int* ept) {
  *nt = V <= kMaxCodeVocab ? kCodeThreads : V <= kMaxCodecVocab ? kHeadThreads : 0;
  *ept = V <= kMaxCodeVocab ? kMaxCodeVocab / kCodeThreads
         : V <= kMaxCodecVocab ? kMaxCodecVocab / kHeadThreads : 0;
}

}  // namespace

extern "C" int qtts_sample_rows(const void* logits, int R, int V, const void* seeds,
                                int step, float temp, float top_p, int top_k,
                                int greedy, int use_top_p, int suppress_start,
                                int eos_id, const void* seen, float penalty,
                                void* out, void* stream) {
  if (R < 1 || V < 1 || V > kMaxCodecVocab) return (int)cudaErrorInvalidValue;
  auto launch = V <= kMaxCodeVocab ? launch_rows<kCodeThreads, kMaxCodeVocab / kCodeThreads>
                                   : launch_rows<kHeadThreads, kMaxCodecVocab / kHeadThreads>;
  return launch(logits, R, V, seeds, step, temp, top_p, top_k, greedy, use_top_p,
                suppress_start, eos_id, seen, penalty, out, (cudaStream_t)stream);
}

// How a row of width V is sampled: out[0..2] = the block's threads, the
// elements a thread holds, the block-wide exchanges (sample_exchanges) of
// a row with these parameters. cudaErrorInvalidValue for a row too wide.
extern "C" int qtts_sample_shape(int V, int greedy, int top_k, int use_top_p, float top_p,
                                 void* out) {
  int* o = (int*)out;
  row_block(V, &o[0], &o[1]);
  o[2] = sample_exchanges(greedy != 0, top_k > 0 && top_k < V, use_top_p != 0 && !(top_p >= 1.0f));
  return o[0] > 0 ? 0 : (int)cudaErrorInvalidValue;
}
