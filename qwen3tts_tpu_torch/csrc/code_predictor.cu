// K2: the 15 residual codes of one frame — the code predictor's whole
// autoregressive inner loop as one cooperative launch of the persistent
// kernel in code_predictor_persistent.cuh, for one lane.
//
// Replaces qwen3tts_tpu/ops/pallas_code_predictor.py:260 fused_predict_codes
// (w8a8 mode), one pallas_call per frame on the TPU; one kernel per frame
// here too.
//
// What bounds it on the H100: the card's bound counts each byte once (the
// ~78.6 MB int8 block stack at 0.6B widths, 15 bf16 heads, ~0.04 ms), but
// the TPU kernel keeps the stack resident in VMEM for all 16 passes and an
// H100 cannot (227 KB of shared memory per SM, 50 MB of L2): each pass
// streams it again, 16 x 78.6 MB = 1.26 GB per frame, a floor of ~0.38 ms
// at 3.35 TB/s. Launch latency no longer bounds it (one launch per frame,
// not ~1,020): its grid barriers (670 per call, ~1.4 us each) and the
// chains of dependent latencies of the phases between them do, the row
// work that one lane leaves to one block while the others wait above all.
//
// The KV scratch is float32, [2, L, Hkv, 16, D], as the Pallas kernel's.
// The heads and embedding tables are bf16, or float32 (emb_f32: the
// float32 tier's int8 blocks).
#include "code_predictor_persistent.cuh"

extern "C" size_t qtts_cp_ws_bytes(int H, int Hq, int Hkv, int D, int F, int CTX, int V,
                                   int emb_f32) {
  (void)CTX;
  return cp_carve(nullptr, nullptr, 1, H, Hq, Hkv, D, F, V, emb_f32);
}

extern "C" int qtts_code_predictor(
    const void* xinit, const void* cos_tab, const void* sin_tab,
    const void* attn_n, const void* q_n, const void* k_n, const void* ffn_n,
    const void* out_norm,
    const void* wqkv_q, const void* wqkv_s, const void* wo_q, const void* wo_s,
    const void* wgu_q, const void* wgu_s, const void* wd_q, const void* wd_s,
    const void* heads, const void* embds, int emb_f32,
    int L, int H, int Hq, int Hkv, int D, int F, int V, int CTX, int S, float eps,
    float temp, float top_p, int top_k, int greedy, int use_top_p, int seed,
    void* codes_out, void* rest_sum, void* kv, void* ws, void* stream) {
  if (int bad = cp_check(1, H, Hq, Hkv, D, F, V, CTX, S)) return bad;
  const CpParams P = cp_params(xinit, 1, cos_tab, sin_tab, attn_n, q_n, k_n, ffn_n, out_norm,
                               wqkv_q, wqkv_s, wo_q, wo_s, wgu_q, wgu_s, wd_q, wd_s, heads,
                               embds, emb_f32, L, H, Hq, Hkv, D, F, V, CTX, S, eps, temp, top_p,
                               top_k, greedy, use_top_p, seed, nullptr, nullptr, nullptr, codes_out,
                               rest_sum, kv, ws);
  return cp_launch<float, 0>(P, (cudaStream_t)stream);
}

// The grid one K2 call launches: out[0..4] = blocks, grid barriers per
// call, blocks per SM, SMs, dynamic shared bytes per block.
extern "C" int qtts_cp_grid(int L, int H, int Hq, int Hkv, int D, int F, int V, int CTX, int S,
                            int emb_f32, void* out) {
  if (int bad = cp_check(1, H, Hq, Hkv, D, F, V, CTX, S)) return bad;
  CpParams P{};
  P.B = 1; P.L = L; P.H = H; P.Hq = Hq; P.Hkv = Hkv; P.D = D; P.F = F; P.V = V;
  P.CTX = CTX; P.S = S; P.emb_f32 = emb_f32;
  return CpGrid<float, 0>::go(P, (int*)out);
}
