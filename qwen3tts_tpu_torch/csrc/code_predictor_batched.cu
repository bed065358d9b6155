// K6: the 15 residual codes of one frame for each of B lanes — the code
// predictor's autoregressive inner loop for a batch as one cooperative
// launch of the persistent kernel in code_predictor_persistent.cuh.
//
// Replaces qwen3tts_tpu/ops/pallas_code_predictor_batched.py:235
// fused_predict_codes_batched (w8a8 mode), with its per-lane temperature and
// top-p operands (:86-88, :291-299; temps and topps [B] float32, or null for
// the scalars: continuous serving gives each request its own). Lane b
// equals K2 run with seed seeds[b] (and the lane's temperature and top-p):
// the per-lane activation scales, the exact int32 dots and the
// counter-hash noise (a function of seed, step and vocab slot only) make the
// lanes independent. As in the Pallas kernel, the KV scratch is stored in
// the embedding dtype (bf16, or float32 with float32 heads and embeddings:
// emb_f32, the float32 tier; float32 in K2) and neither q nor the
// probabilities are rounded, so on bf16 weights a lane can differ from K2 in
// the last bits of its attention.
//
// What bounds it on the H100: per frame-set the 5 int8 layers (78.6 MB at
// 0.6B widths) and the 15 bf16 heads (62.9 MB) are the card's bound by
// bytes (~0.04 ms at 3.35 TB/s); at B = 64 the int8 products are 2 x 64 x 16
// passes x 78.6 M = 0.16 T operations, ~0.08 ms at the int8 tensor-core
// peak. The TPU kernel keeps the block stack in VMEM for all 16 passes; an
// H100 cannot (227 KB shared per SM, 50 MB L2), so each pass streams the
// stack once for all B lanes (a weight tile is read by one block and
// multiplied against every lane's activation row), 16 x 78.6 MB = 1.26 GB
// per frame-set, a floor of ~0.38 ms. Launch latency no longer bounds it
// (one launch per frame-set, not ~1,020): at B = 64 the __dp4a products on
// the CUDA cores (~20 G instructions per call) set the GEMM phases' time,
// and the 670 grid barriers and the one-block lane phases between them add
// theirs; IMMA products are the next step. The TPU kernel's one-hot matmul
// embedding gather and its lane-major KV scratch [L, Hkv, CTX, B, D] are
// TPU tiling artifacts: here the block of a lane fetches its embedding row,
// and the scratch is lane-major over heads, [2, L, B, Hkv, 16, D].
//
// Cap: B <= 64 per call, the Pallas kernel's VMEM lane budget; the decode
// loop runs larger batches in groups of 64.
#include "code_predictor_persistent.cuh"

// K6 over float32 heads, embeddings and K/V scratch: the same kernel with T
// = float, instantiated in code_predictor_batched_f32.cu (its four lane
// widths double this file's compile time, and the sources compile in
// parallel). params points at a CpParams of this header.
extern "C" int qtts_cp_batched_launch_f32(const void* params, int B, void* stream);
extern "C" int qtts_cp_batched_grid_f32(const void* params, int B, void* out);

extern "C" size_t qtts_cp_batched_ws_bytes(int B, int H, int Hq, int Hkv, int D, int F,
                                           int CTX, int V, int emb_f32) {
  (void)CTX;
  return cp_carve(nullptr, nullptr, B, H, Hq, Hkv, D, F, V, emb_f32);
}

extern "C" int qtts_code_predictor_batched(
    const void* xinit, int B, const void* cos_tab, const void* sin_tab,
    const void* attn_n, const void* q_n, const void* k_n, const void* ffn_n,
    const void* out_norm,
    const void* wqkv_q, const void* wqkv_s, const void* wo_q, const void* wo_s,
    const void* wgu_q, const void* wgu_s, const void* wd_q, const void* wd_s,
    const void* heads, const void* embds, int emb_f32,
    int L, int H, int Hq, int Hkv, int D, int F, int V, int CTX, int S, float eps,
    float temp, float top_p, int top_k, int greedy, int use_top_p, const void* seeds,
    const void* temps, const void* topps, void* codes_out, void* rest_sum, void* kv, void* ws,
    void* stream) {
  if (int bad = cp_check(B, H, Hq, Hkv, D, F, V, CTX, S)) return bad;
  const CpParams P = cp_params(xinit, B, cos_tab, sin_tab, attn_n, q_n, k_n, ffn_n, out_norm,
                               wqkv_q, wqkv_s, wo_q, wo_s, wgu_q, wgu_s, wd_q, wd_s, heads,
                               embds, emb_f32, L, H, Hq, Hkv, D, F, V, CTX, S, eps, temp, top_p,
                               top_k, greedy, use_top_p, 0, seeds, temps, topps, codes_out,
                               rest_sum, kv, ws);
  return emb_f32 ? qtts_cp_batched_launch_f32(&P, B, stream)
                 : cp_by_lanes<__nv_bfloat16, CpLaunch>(B, P, (cudaStream_t)stream);
}

// The grid one K6 call for B lanes launches (as qtts_cp_grid).
extern "C" int qtts_cp_batched_grid(int B, int L, int H, int Hq, int Hkv, int D, int F, int V,
                                    int CTX, int S, int emb_f32, void* out) {
  if (int bad = cp_check(B, H, Hq, Hkv, D, F, V, CTX, S)) return bad;
  CpParams P{};
  P.B = B; P.L = L; P.H = H; P.Hq = Hq; P.Hkv = Hkv; P.D = D; P.F = F; P.V = V;
  P.CTX = CTX; P.S = S; P.emb_f32 = emb_f32;
  return emb_f32 ? qtts_cp_batched_grid_f32(&P, B, out)
                 : cp_by_lanes<__nv_bfloat16, CpGrid>(B, P, (int*)out);
}
