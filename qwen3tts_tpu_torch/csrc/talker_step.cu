// K1: one talker frame through all layers, the output norm, the codec head
// and the sampling of the next frame's codebook-0 token.
//
// Replaces qwen3tts_tpu/ops/pallas_talker_step.py:387 fused_talker_step and
// :980 fused_talker_step_hbm (w8a8 mode). On the TPU the two differ only in
// where the KV cache lives (VMEM blocks vs HBM slabs); here the cache always
// lives in device memory, so one kernel serves every capacity.
//
// What bounds it on the H100: bytes. At 0.6B widths one frame reads the
// int8 projections of 28 layers (28 x 15.7 MB = 440 MB), the bf16 codec head
// (6.3 MB) and the valid KV prefix: 28 layers x 2 (K, V) x 8 heads x 128 x
// 2 bytes = 114,688 bytes per cached row, 115 MB at n = 1000. At 3.35 TB/s
// the weights and head alone take ~0.13 ms, and 1000 rows another ~0.03 ms;
// everything else is small. The design streams each weight once with
// coalesced 4-byte loads spread over all SMs (split-K GEMVs whose int32
// atomics are exact, so the split changes no bit), keeps the single-token
// activations in one block each, and reads only the valid KV rows. It
// launches ~13 kernels per layer from one C call (no host round trip inside
// a frame); launch latency, not bandwidth, is what this first version pays
// for — a persistent kernel or a CUDA graph is later work.
//
// The KV cache is updated in place: the new K/V row is written at n_past
// (the Pallas kernel aliases its KV operand to its output instead).
#include "layer.cuh"

extern "C" size_t qtts_talker_ws_bytes(int H, int Hq, int Hkv, int D, int F, int C, int Vc) {
  const Dims d{H, Hq, Hkv, D, F, 0.f};
  return carve_work(nullptr, nullptr, d, 1, C, Vc);
}

extern "C" int qtts_talker_step(
    const void* x_in, int n_past, const void* cosv, const void* sinv,
    const void* attn_n, const void* q_n, const void* k_n, const void* ffn_n,
    const void* wqkv_q, const void* wqkv_s, const void* wo_q, const void* wo_s,
    const void* wgu_q, const void* wgu_s, const void* wd_q, const void* wd_s,
    const void* out_norm, const void* codec_head, void* kv,
    int L, int H, int Hq, int Hkv, int D, int F, int C, int Vc, float eps,
    const void* seen, float temp, float top_p, float penalty, int top_k, int greedy,
    int use_top_p, int suppress_start, int eos_id, int seed,
    void* hidden_out, void* logits_out, void* tok_out, void* ws, void* stream) {
  const Dims d{H, Hq, Hkv, D, F, eps};
  if (int bad = check_dims(d, Vc, 1)) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  Work w;
  carve_work(&w, (char*)ws, d, 1, C, Vc);
  const StackWeights sw{(const int8_t*)wqkv_q, (const int8_t*)wo_q, (const int8_t*)wgu_q,
                        (const int8_t*)wd_q,   (const float*)wqkv_s, (const float*)wo_s,
                        (const float*)wgu_s,   (const float*)wd_s,   (const float*)attn_n,
                        (const float*)q_n,     (const float*)k_n,    (const float*)ffn_n};
  const long head_stride = (long)C * D;
  __nv_bfloat16* kvb = (__nv_bfloat16*)kv;
  cudaMemcpyAsync(w.x, x_in, sizeof(float) * H, cudaMemcpyDeviceToDevice, st);
  for (int l = 0; l < L; ++l) {
    const auto lv = layer_view(sw, d, l, kvb + (size_t)(2 * l) * Hkv * head_stride,
                               kvb + (size_t)(2 * l + 1) * Hkv * head_stride, head_stride, 0L);
    run_layer(d, lv, l > 0 ? sw.sd + (size_t)(l - 1) * H : nullptr, w, (const float*)cosv,
              (const float*)sinv, n_past, C, 1, 1, st);
  }
  final_norm(d, sw.sd + (size_t)(L - 1) * H, (const float*)out_norm, w, (float*)hidden_out,
             st);
  const int splits = project_bf16(w, (const float*)hidden_out,
                                  (const __nv_bfloat16*)codec_head, H, Vc, st);
  const size_t smem = 2 * (size_t)Vc * sizeof(float);
  cudaFuncSetAttribute(head_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  head_sample_kernel<<<1, kRowThreads, smem, st>>>(
      w.head, splits, Vc, (float*)logits_out, (int*)tok_out, 1, 0, suppress_start, eos_id,
      (const int8_t*)seen, penalty, temp, top_p, top_k, greedy, use_top_p, seed, nullptr, 0);
  return (int)cudaGetLastError();
}
