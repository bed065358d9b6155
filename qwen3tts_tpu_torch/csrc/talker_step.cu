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
// (6.3 MB) and the valid KV prefix (28 x 2 x 8 x n x 128 x 2 bytes: 23 MB at
// n = 1000). At 3.35 TB/s that is ~0.14 ms; everything else is small. The
// design streams each weight once with coalesced 4-byte loads spread over
// all SMs (split-K GEMVs whose int32 atomics are exact, so the split changes
// no bit), keeps the single-token activations in one block each, and reads
// only the valid KV rows. It launches ~13 kernels per layer from one C call
// (no host round trip inside a frame); launch latency, not bandwidth, is
// what this first version pays for — a persistent kernel or a CUDA graph is
// later work.
//
// The KV cache is updated in place: the new K/V row is written at n_past
// (the Pallas kernel aliases its KV operand to its output instead).
#include "layer.cuh"

extern "C" size_t qtts_talker_ws_bytes(int H, int Hq, int Hkv, int D, int F, int C, int Vc) {
  const Dims d{H, Hq, Hkv, D, F, 0.f};
  return carve_work(nullptr, nullptr, d, C, Vc);
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
  if (int bad = check_dims(d, Vc)) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  Work w;
  carve_work(&w, (char*)ws, d, C, Vc);
  const int qkv = (Hq + 2 * Hkv) * D, hd = Hq * D;
  const long head_stride = (long)C * D;
  __nv_bfloat16* kvb = (__nv_bfloat16*)kv;
  cudaMemcpyAsync(w.x, x_in, sizeof(float) * H, cudaMemcpyDeviceToDevice, st);
  for (int l = 0; l < L; ++l) {
    LayerView<__nv_bfloat16> lv;
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
    lv.K = kvb + (size_t)(2 * l) * Hkv * head_stride;
    lv.V = kvb + (size_t)(2 * l + 1) * Hkv * head_stride;
    lv.head_stride = head_stride;
    const float* prev_sd = l > 0 ? (const float*)wd_s + (size_t)(l - 1) * H : nullptr;
    run_layer(d, lv, prev_sd, w, (const float*)cosv, (const float*)sinv, n_past, C, st);
  }
  final_norm(d, (const float*)wd_s + (size_t)(L - 1) * H, (const float*)out_norm, w,
             (float*)hidden_out, st);
  const int splits = gemv_bf16((const float*)hidden_out, (const __nv_bfloat16*)codec_head, H,
                               Vc, w.head, st);
  const size_t smem = 2 * (size_t)Vc * sizeof(float);
  cudaFuncSetAttribute(head_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  head_sample_kernel<<<1, kRowThreads, smem, st>>>(
      w.head, splits, Vc, (float*)logits_out, (int*)tok_out, 0, suppress_start, eos_id,
      (const int8_t*)seen, penalty, temp, top_p, top_k, greedy, use_top_p, seed, 0);
  return (int)cudaGetLastError();
}
