// K4's standalone entry: sample one token per row of a [R, V] float32 logits
// matrix with the sampler the fused kernels run in their epilogues (no serve
// path calls this entry; frame 0 is drawn by the PyTorch sample_token). See
// sampler.cuh for the semantics and the design.
#include "sampler.cuh"

namespace {

constexpr int kSampleThreads = 1024;

__global__ void sample_rows_kernel(const float* __restrict__ logits, int V,
                                   const int* __restrict__ seeds, int step,
                                   float temp, float top_p, int top_k, int greedy,
                                   int use_top_p, int suppress_start, int eos_id,
                                   const int8_t* __restrict__ seen, float penalty,
                                   int* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  __shared__ int redi[32];
  float* l = smem;
  float* p = smem + V;
  const int r = blockIdx.x;
  for (int i = threadIdx.x; i < V; i += blockDim.x) l[i] = logits[(size_t)r * V + i];
  __syncthreads();
  const int tok = suppress_penalize_sample(
      l, p, V, suppress_start, eos_id, seen, penalty, temp, top_p, top_k,
      greedy != 0, use_top_p != 0, seeds[r], step, red, redi);
  if (threadIdx.x == 0) out[r] = tok;
}

}  // namespace

extern "C" int qtts_sample_rows(const void* logits, int R, int V, const void* seeds,
                                int step, float temp, float top_p, int top_k,
                                int greedy, int use_top_p, int suppress_start,
                                int eos_id, const void* seen, float penalty,
                                void* out, void* stream) {
  const size_t smem = 2 * (size_t)V * sizeof(float);
  cudaFuncSetAttribute(sample_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  sample_rows_kernel<<<R, kSampleThreads, smem, (cudaStream_t)stream>>>(
      (const float*)logits, V, (const int*)seeds, step, temp, top_p, top_k, greedy,
      use_top_p, suppress_start, eos_id, (const int8_t*)seen, penalty, (int*)out);
  return (int)cudaGetLastError();
}
