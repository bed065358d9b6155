// The code predictor's 16 passes for B lanes, shared by K2
// (code_predictor.cu, one lane) and K6 (code_predictor_batched.cu).
//
// Pass 0 runs each lane's talker hidden through the L layers (conditioning
// only); pass p = 1..S feeds the lane's cb0 embedding (p = 1) or
// embds[p-2][code_{p-2}] (p >= 2), then samples code p-1 from heads[p-1]
// at sampler step p with the lane's seed. rest_sum[b] = sum_s
// embds[s][code_s], the next talker step's embedding term. The codes stay
// on the device between passes: the embedding fetch reads the code that the
// sampler wrote.
//
// The KV scratch [2, L, B, Hkv, CTX, D] (K then V) comes from the caller
// uninitialised; attention reads only rows below the current position, all
// written earlier in the same call.
#pragma once

#include "layer.cuh"

namespace {

// Lane blockIdx.x: x_out[b] (when given) = embds[table][codes[b, idx]];
// rest_sum[b] += that row. codes is [B, code_ld].
__global__ void cp_embed_kernel(const __nv_bfloat16* __restrict__ embds, int V, int H,
                                const int* __restrict__ codes, int code_ld, int table, int idx,
                                float* __restrict__ x_out, float* __restrict__ rest_sum) {
  const int b = blockIdx.x;
  const int code = codes[(size_t)b * code_ld + idx];
  const __nv_bfloat16* row = embds + ((size_t)table * V + code) * H;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float v = __bfloat162float(row[i]);
    if (x_out != nullptr) x_out[(size_t)b * H + i] = v;
    rest_sum[(size_t)b * H + i] += v;
  }
}

// xinit [2, B, H] float32: the lanes' talker hidden, then their cb0
// embedding. codes [B, S] int32; rest_sum [B, H] float32, zeroed by the
// caller. Lane b samples with seeds[b] (or `seed` when seeds is null) and
// with temps[b] and topps[b] (or the scalars when null: K6 in continuous
// serving takes each request's own, pallas_code_predictor_batched.py:86-88).
// Attention rounds neither q nor p (the Pallas kernels' code predictor);
// T is the KV scratch's type.
template <typename T>
void predict_codes(const Dims& d, const StackWeights& sw, int L, int V, int CTX, int S,
                   const float* xinit, const float* cos_tab, const float* sin_tab,
                   const float* out_norm, const __nv_bfloat16* heads,
                   const __nv_bfloat16* embds, float temp, float top_p, int top_k, int greedy,
                   int use_top_p, int seed, const int* seeds, const float* temps,
                   const float* topps, int* codes, float* rest_sum, T* kv, const Work& w,
                   cudaStream_t st) {
  const int B = w.B, H = d.H, half = d.D / 2;
  const long head_stride = (long)CTX * d.D, lane_stride = (long)d.Hkv * head_stride;
  const size_t layer_kv = (size_t)B * lane_stride;
  T* kc = kv;
  T* vc = kv + (size_t)L * layer_kv;
  const size_t smem = 2 * (size_t)V * sizeof(float);
  cudaFuncSetAttribute(head_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  for (int p = 0; p <= S; ++p) {
    if (p <= 1) {
      cudaMemcpyAsync(w.x, xinit + (size_t)p * B * H, sizeof(float) * B * H,
                      cudaMemcpyDeviceToDevice, st);
    } else {
      cp_embed_kernel<<<B, kRowThreads, 0, st>>>(embds, V, H, codes, S, p - 2, p - 2, w.x,
                                                 rest_sum);
    }
    ProjOut last{};
    for (int l = 0; l < L; ++l) {
      const auto lv = layer_view(sw, d, l, kc + l * layer_kv, vc + l * layer_kv, head_stride,
                                 lane_stride);
      last = run_layer(d, lv, last, w, cos_tab + (size_t)p * half, sin_tab + (size_t)p * half,
                       p, CTX, 0, 0, st);
    }
    if (p == 0) continue;
    final_norm(d, last, out_norm, w, w.hnorm, st);
    const int splits = project_bf16(w, w.hnorm, heads + (size_t)(p - 1) * H * V, H, V, st);
    head_sample_kernel<<<B, kRowThreads, smem, st>>>(
        w.head, splits, V, nullptr, codes, S, p - 1, V, -1, nullptr, 1.0f, temp, top_p, top_k,
        greedy, use_top_p, seed, seeds, p, temps, topps, nullptr);
  }
  cp_embed_kernel<<<B, kRowThreads, 0, st>>>(embds, V, H, codes, S, S - 1, S - 1, nullptr,
                                             rest_sum);
}

}  // namespace
