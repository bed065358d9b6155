// K2: the 15 residual codes of one frame — the code predictor's whole
// autoregressive inner loop in one C call.
//
// Replaces qwen3tts_tpu/ops/pallas_code_predictor.py:260 fused_predict_codes
// (w8a8 mode). Pass 0 runs the talker hidden through the 5 layers
// (conditioning only); pass p = 1..15 feeds the cb0 embedding (p = 1) or
// embds[p-2][code_{p-2}] (p >= 2), then samples code p-1 from heads[p-1] at
// sampler step p. The result is codes[15] and rest_sum = sum_s
// embds[s][code_s], the next talker step's embedding term.
//
// What bounds it on the H100: bytes, re-read every pass. The TPU kernel
// keeps the int8 block stack (~78.5 MB at 0.6B widths) resident in 128 MB
// of VMEM and reads it once per frame. An H100 SM has 227 KB of shared
// memory and the card 50 MB of L2, so the stack cannot stay on chip: each of
// the 16 passes streams it again, 16 x 78.5 = 1.26 GB per frame, plus 15
// bf16 LM heads (15 x 4.2 MB = 63 MB) and 15 embedding rows. At 3.35 TB/s
// that is a floor of ~0.4 ms per frame. This first version streams the
// weights with the same split-K GEMVs as K1 and launches ~13 kernels per
// layer (~1,100 per frame) from one C call; launch latency dominates it.
// Splitting the stack across SMs in a persistent kernel is later work.
//
// The 5-layer x 16-position KV scratch [2, L, Hkv, 16, D] (float32) comes
// from the caller uninitialised; attention reads only rows below the
// current position, all written earlier in the same call.
#include "layer.cuh"

namespace {

// x_out (when given) = embds[table][codes[idx]]; rest_sum += that row.
__global__ void cp_embed_kernel(const __nv_bfloat16* __restrict__ embds, int V, int H,
                                const int* __restrict__ codes, int table, int idx,
                                float* __restrict__ x_out, float* __restrict__ rest_sum) {
  const int code = codes[idx];
  const __nv_bfloat16* row = embds + ((size_t)table * V + code) * H;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float v = __bfloat162float(row[i]);
    if (x_out != nullptr) x_out[i] = v;
    rest_sum[i] += v;
  }
}

}  // namespace

extern "C" size_t qtts_cp_ws_bytes(int H, int Hq, int Hkv, int D, int F, int CTX, int V) {
  const Dims d{H, Hq, Hkv, D, F, 0.f};
  return carve_work(nullptr, nullptr, d, CTX, V);
}

extern "C" int qtts_code_predictor(
    const void* xinit, const void* cos_tab, const void* sin_tab,
    const void* attn_n, const void* q_n, const void* k_n, const void* ffn_n,
    const void* out_norm,
    const void* wqkv_q, const void* wqkv_s, const void* wo_q, const void* wo_s,
    const void* wgu_q, const void* wgu_s, const void* wd_q, const void* wd_s,
    const void* heads, const void* embds,
    int L, int H, int Hq, int Hkv, int D, int F, int V, int CTX, int S, float eps,
    float temp, float top_p, int top_k, int greedy, int use_top_p, int seed,
    void* codes_out, void* rest_sum, void* kv, void* ws, void* stream) {
  const Dims d{H, Hq, Hkv, D, F, eps};
  if (int bad = check_dims(d, V)) return bad;
  if (S + 1 > CTX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Work w;
  carve_work(&w, (char*)ws, d, CTX, V);
  const int qkv = (Hq + 2 * Hkv) * D, hd = Hq * D, half = D / 2;
  const long head_stride = (long)CTX * D;
  const size_t layer_kv = (size_t)Hkv * CTX * D;
  float* kc = (float*)kv;
  float* vc = kc + (size_t)L * layer_kv;
  const float* xi = (const float*)xinit;
  const __nv_bfloat16* emb = (const __nv_bfloat16*)embds;
  int* codes = (int*)codes_out;
  const size_t smem = 2 * (size_t)V * sizeof(float);
  cudaFuncSetAttribute(head_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  for (int p = 0; p <= S; ++p) {
    if (p <= 1) {
      cudaMemcpyAsync(w.x, xi + (size_t)p * H, sizeof(float) * H, cudaMemcpyDeviceToDevice, st);
    } else {
      cp_embed_kernel<<<1, kRowThreads, 0, st>>>(emb, V, H, codes, p - 2, p - 2, w.x,
                                                 (float*)rest_sum);
    }
    for (int l = 0; l < L; ++l) {
      LayerView<float> lv;
      lv.wqkv = (const int8_t*)wqkv_q + (size_t)l * H * qkv;
      lv.wo = (const int8_t*)wo_q + (size_t)l * hd * H;
      lv.wgu = (const int8_t*)wgu_q + (size_t)l * H * 2 * F;
      lv.wd = (const int8_t*)wd_q + (size_t)l * F * H;
      lv.sqkv = (const float*)wqkv_s + (size_t)l * qkv;
      lv.so = (const float*)wo_s + (size_t)l * H;
      lv.sgu = (const float*)wgu_s + (size_t)l * 2 * F;
      lv.sd = (const float*)wd_s + (size_t)l * H;
      lv.attn_n = (const float*)attn_n + (size_t)l * H;
      lv.q_n = (const float*)q_n + (size_t)l * D;
      lv.k_n = (const float*)k_n + (size_t)l * D;
      lv.ffn_n = (const float*)ffn_n + (size_t)l * H;
      lv.K = kc + (size_t)l * layer_kv;
      lv.V = vc + (size_t)l * layer_kv;
      lv.head_stride = head_stride;
      const float* prev_sd = l > 0 ? (const float*)wd_s + (size_t)(l - 1) * H : nullptr;
      run_layer(d, lv, prev_sd, w, (const float*)cos_tab + (size_t)p * half,
                (const float*)sin_tab + (size_t)p * half, p, CTX, st);
    }
    if (p == 0) continue;
    final_norm(d, (const float*)wd_s + (size_t)(L - 1) * H, (const float*)out_norm, w,
               w.hnorm, st);
    const __nv_bfloat16* head = (const __nv_bfloat16*)heads + (size_t)(p - 1) * H * V;
    const int splits = gemv_bf16(w.hnorm, head, H, V, w.head, st);
    head_sample_kernel<<<1, kRowThreads, smem, st>>>(
        w.head, splits, V, nullptr, codes, p - 1, V, -1, nullptr, 1.0f, temp, top_p, top_k,
        greedy, use_top_p, seed, p);
  }
  cp_embed_kernel<<<1, kRowThreads, 0, st>>>(emb, V, H, codes, S - 1, S - 1, nullptr,
                                             (float*)rest_sum);
  return (int)cudaGetLastError();
}
