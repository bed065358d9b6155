// K2: the 15 residual codes of one frame — the code predictor's whole
// autoregressive inner loop in one C call (code_predictor.cuh, one lane).
//
// Replaces qwen3tts_tpu/ops/pallas_code_predictor.py:260 fused_predict_codes
// (w8a8 mode).
//
// What bounds it on the H100: bytes, re-read every pass. The TPU kernel
// keeps the int8 block stack (~78.6 MB at 0.6B widths) resident in 128 MB
// of VMEM and reads it once per frame. An H100 SM has 227 KB of shared
// memory and the card 50 MB of L2, so the stack cannot stay on chip: each of
// the 16 passes streams it again, 16 x 78.6 = 1.26 GB per frame, plus 15
// bf16 LM heads (15 x 4.2 MB = 63 MB) and 15 embedding rows. The card's
// bound counts each byte once (~0.14 GB, ~0.04 ms); the re-reads are this
// design's cost, a floor of ~0.4 ms per frame at 3.35 TB/s. This first
// version streams the weights with split-K GEMVs and launches ~13 kernels
// per layer (~1,100 per frame) from one C call; launch latency dominates it.
// Splitting the stack across SMs in a persistent kernel is later work.
//
// The KV scratch is float32, [2, L, Hkv, 16, D], as the Pallas kernel's.
#include "code_predictor.cuh"

extern "C" size_t qtts_cp_ws_bytes(int H, int Hq, int Hkv, int D, int F, int CTX, int V) {
  const Dims d{H, Hq, Hkv, D, F, 0.f};
  return carve_work(nullptr, nullptr, d, 1, CTX, V);
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
  if (int bad = check_dims(d, V, 1)) return bad;
  if (S + 1 > CTX) return (int)cudaErrorInvalidValue;
  Work w;
  carve_work(&w, (char*)ws, d, 1, CTX, V);
  const StackWeights sw = w8a8_stack(wqkv_q, wqkv_s, wo_q, wo_s, wgu_q, wgu_s, wd_q, wd_s,
                                     attn_n, q_n, k_n, ffn_n);
  predict_codes(d, sw, L, V, CTX, S, (const float*)xinit, (const float*)cos_tab,
                (const float*)sin_tab, (const float*)out_norm, (const __nv_bfloat16*)heads,
                (const __nv_bfloat16*)embds, temp, top_p, top_k, greedy, use_top_p, seed,
                nullptr, nullptr, nullptr, (int*)codes_out, (float*)rest_sum, (float*)kv, w,
                (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
