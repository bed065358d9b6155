// K1: one talker frame through all layers, the output norm, the codec head
// and the sampling of the next frame's codebook-0 token.
//
// Replaces qwen3tts_tpu/ops/pallas_talker_step.py:387 fused_talker_step and
// :980 fused_talker_step_hbm in their weight modes (w8a8, bf16, w4bf16, f32
// (the float32 tier's weights, which the Pallas "bf16" mode dots at their
// own dtype), and the per-projection tuple of the q4 tier; layer.cuh), over
// a bf16 or a float32 cache (kv_f32) with a bf16 or a float32 codec head
// (head_f32): the float32 tier (RuntimeConfig(dtype="float32")) serves on
// the card with the default flags. On the TPU the two
// differ only in where the KV cache lives (VMEM blocks vs HBM slabs); here
// the cache always lives in device memory, so one kernel serves every
// capacity. With kv_scale given, the cache is the int8-KV tier's (q, scale)
// pair (their kv_int8 operand, _make_kernel_hbm :564 and
// _make_kernel_hbm_pipelined :765): kv int8 [L, 2, Hkv, C, D], kv_scale
// float32 [L, 2, Hkv, C]; the attention reads the int8 rows below n_past
// and attends the new row in bf16 before quantizing it into the cache
// (layer.cuh's header).
//
// What bounds it on the H100: bytes. At 0.6B widths one frame reads the
// projections of 28 layers — 440 MB in int8, 881 MB in bf16, 375 MB in the
// q4 tier and 330 MB in q4pure (u4 nibbles plus 8 bytes of float32 scale
// and offset per 32 rows and column) — the bf16 codec head (6.3 MB) and the
// valid KV prefix: 28 layers x 2 (K, V) x 8 heads x 128 x 2 bytes = 114,688
// bytes per cached row, 115 MB at n = 1000 (the int8 cache: 57,344 bytes
// of values and 1,792 of scales per row). At 3.35 TB/s the int8 weights
// and head alone take ~0.13 ms; everything else is small. The design
// streams each weight once by GEMVs that put a whole projection's loads in
// flight over all SMs, 16 bytes a thread and row (split-K: int32 atomics
// in w8a8, exact in any order; float64 per-split partials merged in split
// order in the float modes; layer.cuh), keeps the single-token activations
// in one block each, and reads only the valid KV rows, streamed through
// shared memory by one attention launch per layer. It launches 10 kernels
// per layer (11 over the int8 cache) from one C call (no host round trip
// inside a frame), all but the first with programmatic dependent launch:
// each kernel is resident before the one it follows ends, and each GEMV
// streams its weights while the row kernel before it runs (layer.cuh
// run_layer). Folding the row kernels into the GEMVs, or a CUDA graph of
// the frame, is later work.
//
// The KV cache is updated in place: the new K/V row (or its int8 row and
// scale) is written at n_past (the Pallas kernel returns the row and its
// wrapper scatters it instead).
#include "layer.cuh"

extern "C" size_t qtts_talker_ws_bytes(int H, int Hq, int Hkv, int D, int F, int Vc,
                                       int modes) {
  const Dims d{H, Hq, Hkv, D, F, 0.f};
  return carve_work(nullptr, nullptr, d, 1, Vc, modes);
}

// The attention kernel's cluster size (layer.cuh attn_clusters) for B
// lanes, Hkv KV heads, G query heads per KV head and at most `rows` rows a
// lane, over a bf16 (kv_kind = 0), an int8 (1) or a float32 cache (2); K1
// and K5 share it. For the tests of the split rule.
extern "C" int qtts_talker_attention_clusters(int B, int Hkv, int G, int rows, int kv_kind) {
  return attn_clusters(B, Hkv, G, rows, kAttD * (kv_kind == 1 ? 1 : kv_kind == 2 ? 4 : 2));
}

// The tile plan of K5's GEMM for x [B >= 2, K] @ W [K, N] of plan code
// `code` (layer.cuh gemm_plan): out[0..2] = column strips, K splits, tiles
// per split.
extern "C" int qtts_gemm_plan(int code, int K, int N, void* out) {
  const GemmPlan p = gemm_plan(code, K, N);
  int* o = (int*)out;
  o[0] = p.gx;
  o[1] = p.ks;
  o[2] = p.per;
  return 0;
}

// The grid of K1's GEMV for x [K] @ W [K, N] of plan code `code` (layer.cuh
// kPlan*: a weight mode, the codec head, f32; gemv_plan): out[0..2] =
// column blocks, K splits, weight rows per split.
extern "C" int qtts_gemv_plan(int code, int K, int N, void* out) {
  const GemvPlan p = gemv_plan(code, K, N);
  int* o = (int*)out;
  o[0] = p.gx;
  o[1] = p.ks;
  o[2] = p.rows;
  return 0;
}

extern "C" int qtts_talker_step(
    const void* x_in, int n_past, const void* cosv, const void* sinv,
    const void* attn_n, const void* q_n, const void* k_n, const void* ffn_n,
    const void* w0, const void* s0, const void* z0, int G0,
    const void* w1, const void* s1, const void* z1, int G1,
    const void* w2, const void* s2, const void* z2, int G2,
    const void* w3, const void* s3, const void* z3, int G3,
    const void* out_norm, const void* codec_head, int modes, void* kv, void* kv_scale,
    int kv_f32, int head_f32, int L, int H, int Hq, int Hkv, int D, int F, int C, int Vc,
    float eps, const void* seen, float temp, float top_p, float penalty, int top_k, int greedy,
    int use_top_p, int suppress_start, int eos_id, int seed,
    void* hidden_out, void* logits_out, void* tok_out, void* ws, void* stream) {
  const Dims d{H, Hq, Hkv, D, F, eps};
  const StackWeights sw{
      Proj{proj_mode(modes, 0), w0, (const float*)s0, (const float*)z0, G0},
      Proj{proj_mode(modes, 1), w1, (const float*)s1, (const float*)z1, G1},
      Proj{proj_mode(modes, 2), w2, (const float*)s2, (const float*)z2, G2},
      Proj{proj_mode(modes, 3), w3, (const float*)s3, (const float*)z3, G3},
      (const float*)attn_n, (const float*)q_n, (const float*)k_n, (const float*)ffn_n};
  if (int bad = check_dims(d, Vc, 1)) return bad;
  if (int bad = check_groups(sw, d)) return bad;
  if (kv_f32 && kv_scale != nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Work w;
  carve_work(&w, (char*)ws, d, 1, Vc, modes);
  const long head_stride = (long)C * D, layer_stride = (long)Hkv * head_stride;
  cudaMemcpyAsync(w.x, x_in, sizeof(float) * H, cudaMemcpyDeviceToDevice, st);
  ProjOut last{};
  for (int l = 0; l < L; ++l) {
    const float* cs = (const float*)cosv;
    const float* sn = (const float*)sinv;
    if (kv_scale != nullptr) {
      int8_t* kvq = (int8_t*)kv;
      float* ks = (float*)kv_scale;
      auto lv = layer_view(sw, d, l, kvq + 2 * l * layer_stride, kvq + (2 * l + 1) * layer_stride,
                           head_stride, 0L);
      lv.Ks = ks + (size_t)(2 * l) * Hkv * C;
      lv.Vs = ks + (size_t)(2 * l + 1) * Hkv * C;
      last = run_layer(d, lv, last, w, cs, sn, n_past, 1, 1, st);
    } else if (kv_f32) {
      float* kvf = (float*)kv;
      const auto lv = layer_view(sw, d, l, kvf + 2 * l * layer_stride,
                                 kvf + (2 * l + 1) * layer_stride, head_stride, 0L);
      last = run_layer(d, lv, last, w, cs, sn, n_past, 1, 1, st);
    } else {
      __nv_bfloat16* kvb = (__nv_bfloat16*)kv;
      const auto lv = layer_view(sw, d, l, kvb + 2 * l * layer_stride,
                                 kvb + (2 * l + 1) * layer_stride, head_stride, 0L);
      last = run_layer(d, lv, last, w, cs, sn, n_past, 1, 1, st);
    }
  }
  final_norm(d, last, (const float*)out_norm, w, (float*)hidden_out, st);
  const int splits = project_head(w, (const float*)hidden_out, codec_head, head_f32, H, Vc, st);
  chain_launch(w, false, head_sample_kernel, dim3(1), dim3(kHeadThreads), 0, st,
               (const float*)w.head, splits, Vc, (float*)logits_out, (int*)tok_out, 1, 0,
               suppress_start, eos_id, (const int8_t*)seen, penalty, temp, top_p, top_k, greedy,
               use_top_p, seed, (const int*)nullptr, 0, (const float*)nullptr,
               (const float*)nullptr, (const float*)nullptr);
  const int last_err = (int)cudaGetLastError();
  return w.err != cudaSuccess ? (int)w.err : last_err;
}

// A harness for the projection kernels alone, K1's GEMVs (B = 1) and K5's
// tensor-core GEMMs (B >= 2): for each of L layers of one stacked [L, K, N]
// projection of plan code `code` (w8a8, bf16, w4bf16 as their WeightMode,
// kPlanF32 for f32; w, s, z, G as in qtts_talker_step), y = x @ W_l for B
// lanes, as run_layer launches it (the GEMVs with programmatic dependent
// launch, one after the other). x is int8 [B, K] (w8a8) or float32 [B, K]
// (holding bf16 values, as the row kernels emit them, except in f32); the
// results land in the workspace: the int32 accumulator [B, N] (w8a8, added
// to, never cleared) or the float64 partials [halves, splits, B, N]
// (overwritten layer by layer): a check runs one layer on a cleared
// workspace. kPlanHead and kPlanHeadF32 (B = 1) run the codec head's GEMV
// over bf16 or float32 W_l into float32 partials [splits, N]. Off every
// serving path: chip_smoke.py times K1's GEMVs beside the w4 GEMV probe
// (w4_gemv_probe.cu) and both in its projection phase.
inline bool head_code(int code) { return code == kPlanHead || code == kPlanHeadF32; }
inline int code_mode(int code) { return code == kPlanF32 ? kF32 : code; }

extern "C" size_t qtts_project_ws_bytes(int code, int B, int K, int N) {
  if (head_code(code)) return sizeof(float) * (size_t)gemv_plan(code, K, N).ks * N;
  const int mode = code_mode(code);
  return mode == kW8A8 ? sizeof(int) * (size_t)B * N
                       : sizeof(double) * (mode == kW4BF16 ? 2 : 1) *
                             (size_t)float_splits(B, mode, K, N) * B * N;
}

extern "C" int qtts_project_layers(int code, const void* x, const void* w, const void* s,
                                   const void* z, int G, int L, int B, int K, int N, void* ws,
                                   void* stream) {
  if (B < 1 || B > kMaxLanes || K % 16 != 0 || N % 16 != 0 || code < 0 || code > kPlanHeadF32 ||
      (head_code(code) && B != 1) || (code == kW4BF16 && !groups_ok(K, G)))
    return (int)cudaErrorInvalidValue;
  Work wk{};
  wk.B = B;
  wk.ldq = K;
  wk.xq = (int8_t*)x;
  wk.xf = (float*)x;
  wk.part = (double*)ws;
  wk.head = (float*)ws;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t esize = code == kPlanHeadF32 ? sizeof(float) : sizeof(__nv_bfloat16);
  for (int l = 0; l < L; ++l) {
    if (head_code(code))
      project_head(wk, (const float*)x, (const char*)w + esize * l * K * N,
                   code == kPlanHeadF32, K, N, st);
    else
      project(wk, layer_proj(Proj{code_mode(code), w, (const float*)s, (const float*)z, G}, l,
                             K, N),
              K, N, (int*)ws, nullptr, st);
  }
  const int last = (int)cudaGetLastError();
  return wk.err != cudaSuccess ? (int)wk.err : last;
}
