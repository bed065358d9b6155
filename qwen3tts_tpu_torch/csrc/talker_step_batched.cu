// K5: one talker frame-set for B lockstep lanes — all layers, the output
// norm, the codec head and the sampling of each lane's next codebook-0
// token — in one C call.
//
// Replaces qwen3tts_tpu/ops/pallas_talker_step.py:1604
// fused_talker_step_batched (kernel _make_kernel_batched :1402) in its
// weight modes (w8a8, bf16, w4bf16, f32 and the q4 tier's per-projection
// tuple; layer.cuh), batch-major cache [B, L, 2, Hkv, C, D] bf16 or float32
// (kv_f32; the codec head bf16 or float32: head_f32), with the two
// operands only continuous serving uses (runtime/continuous.py): `start`
// [B] int32, lane b's first valid cache row (:1618; rows below it hold the
// lane's previous occupant, and lane b attends [start[b], n_past] only),
// whose lower bound over the lanes, start_min (a host int: the scheduler's
// mirror, so no per-frame read of `start` back to the host), moves the
// attention grid's first chunk up, the counterpart of the Pallas min-start
// DMA skip (:1445); and per-lane temperature, top-p and repetition penalty
// [B] float32 for the cb0 epilogue (:1691-1695, _sample_operands :237).
// Null pointers give the scalars and start 0, as synthesize_batch runs it.
// With kv_scale given, the cache is the int8-KV tier's (q, scale) pair (its
// kv_int8 operand, :1402, :1641): kv int8 [B, L, 2, Hkv, C, D], kv_scale
// float32 [B, L, 2, Hkv, C] (layer.cuh's header); it takes no `start`,
// which the JAX package never combines with it.
//
// With lane_major, it also replaces the lane-major kernel
// (pallas_talker_step.py:1246 _make_kernel_batched_lane, reached through
// :1604 with kv_layout="lane"): the cache is [L, 2, Hkv, C, B, D], bf16 or
// float32, so a (kv, head)'s rows of all lanes form one [C, B, D] slab and
// a lane's rows lie B * D elements apart. As there, it takes no int8 pair,
// no `start` and no sampling (null seen): it returns the hidden state and
// the logits, and the decode loop draws cb0 from them. Design: the row
// kernels over the lane-major strides (layer.cuh's header: head_stride = C
// B D, lane_stride = D, row_stride = B D), and the attention of
// batch-major K5 (its grid, clusters and arithmetic, so the two layouts
// agree bit for bit on the same cache contents) whose ring tiles arrive as
// one tensor copy each: a CUtensorMap (lane_map, encoded once a call
// through the runtime's driver entry point, no -lcuda) describes the cache
// as {D, B, rows, Hkv, 2 L} with rows the valid rows, and a tile is its box
// {D, 1, tile rows} at (lane, first row, head, layer's K or V), which the
// TMA unit gathers row by row. A block of two adjacent lanes, whose tile
// rows are 512-byte runs, measured no faster on the H100 (PERF.md, PR 22).
// A map the driver refuses (a cache off 16-byte alignment) returns
// kLaneMapFailed before any launch: there is no other copy path. A null
// codec_head (and out_norm) returns the residual x as the hidden state and
// no logits, the Pallas kernel's with_head=False.
//
// What bounds it on the H100: bytes. A frame-set reads the 28 layers'
// projections (440 MB in int8, 881 MB in bf16, 375 MB in q4, 330 MB in
// q4pure at 0.6B widths) and the bf16 codec head (6.3 MB) once for all
// lanes, and each lane's valid KV prefix: 114,688 bytes per cached row and
// lane (28 layers x 2 x 8 heads x 128 x 2 bytes), 0.55 GB at B = 16 and
// n_past = 300. The int8 products are 2 x B x 440 M operations (56 G at
// B = 64, 0.03 ms at the int8 peak), far below the 0.13 ms that the
// weights take at 3.35 TB/s. The TPU kernel's point is that the weights are
// read once per frame-set, not once per lane (M = B MXU dots, :1463); here
// each projection is one GEMM on the tensor cores (layer.cuh:
// gemm_i8_mma_kernel, int8 mma into exact int32 sums; gemm_f64_mma_kernel,
// float64 mma over bf16 values widened exactly, for bf16 and w4bf16) that
// streams the weight tiles through a ring in shared memory by asynchronous
// copies and multiplies each against all B lanes' activation rows, so every
// weight byte leaves device memory once, whatever B is. The float modes'
// 2 x B float64 operations per weight (56 G at B = 64) bound them at 0.84
// ms per call on the float64 tensor cores' 67 TFLOP/s, above their bytes
// (0.26 ms in bf16). The per-lane steps
// (norms, quantization, RoPE, attention, sampling) run one block per lane or
// per (head, lane); the attention is one launch per layer, a cluster per
// (lane, KV head) streaming the rows through shared memory (layer.cuh). It
// pays for launch latency (10 kernels per layer, as in K1); PERF.md has the
// measured times.
//
// Numerics follow the batched Pallas kernel, not K1: q is rounded to the KV
// dtype (:1529), the probabilities stay float32 (:1535-1543). The current
// step's K/V, which the Pallas kernel folds in as an extra column at n_past
// (:1554-1567), is written into the cache first and attended with the rest,
// the same function; the softmax is dense where the Pallas kernel's is
// online, a difference of summation order only. (With the int8 cache the
// row is attended from a bf16 staging row and folded in last, as the Pallas
// kernel folds it: layer.cuh's header.) The KV cache is updated in place at
// n_past. Cap: B <= 128 (kMaxLanes); u4 groups of a multiple of 32 rows
// (kFTK, the float GEMM's packed-row tile, so that each tile lies in one
// group: layer.cuh's groups_ok; the talker's groups are 32 rows).
#include "layer.cuh"

namespace {

// cuTensorMapEncodeTiled, reached through the runtime; null where the
// driver does not give it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// The lane-major cache [L, 2, Hkv, C, B, D] of esz-byte elements as the
// attention's tensor map sees it: dims {D, B, rows, Hkv, 2 L} (innermost
// first; rows = the valid rows, so that no tile reads past them), the byte
// strides of dims 1-4, and the box {D, 1, att_tile_rows, 1, 1}: one ring
// tile of one lane (ops/fused_talker_step.lane_map_shape mirrors it).
struct LaneMapShape {
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5];
};

LaneMapShape lane_map_shape(int L, int Hkv, int C, int B, int D, int rows, int esz) {
  const cuuint64_t row = (cuuint64_t)D * esz;
  return LaneMapShape{
      {(cuuint64_t)D, (cuuint64_t)B, (cuuint64_t)rows, (cuuint64_t)Hkv, 2 * (cuuint64_t)L},
      {row, B * row, (cuuint64_t)C * B * row, (cuuint64_t)Hkv * C * B * row},
      {(cuuint32_t)D, 1, (cuuint32_t)att_tile_rows((int)row), 1, 1}};
}

// Encode that map over kv into *map (no fill: elements past the dims arrive
// as zeros); false where the driver refuses it.
bool lane_map(CUtensorMap* map, void* kv, bool f32, const LaneMapShape& m) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                kv, m.dims, m.strides, m.box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// qtts_talker_step_batched's return when the lane-major cache's tensor map
// cannot be encoded (nothing was launched)
constexpr int kLaneMapFailed = -1;

// The lane-major cache's tensor-map geometry (lane_map_shape) for a bf16 or
// (kv_f32) float32 cache: out[0..13] int64 = dims[5], strides[4], box[5].
extern "C" int qtts_lane_map_shape(int L, int Hkv, int C, int B, int D, int rows, int kv_f32,
                                   void* out) {
  const LaneMapShape m = lane_map_shape(L, Hkv, C, B, D, rows, kv_f32 ? 4 : 2);
  long long* o = (long long*)out;
  for (int i = 0; i < 5; ++i) o[i] = (long long)m.dims[i];
  for (int i = 0; i < 4; ++i) o[5 + i] = (long long)m.strides[i];
  for (int i = 0; i < 5; ++i) o[9 + i] = (long long)m.box[i];
  return 0;
}

extern "C" size_t qtts_talker_batched_ws_bytes(int B, int H, int Hq, int Hkv, int D, int F,
                                               int Vc, int modes) {
  const Dims d{H, Hq, Hkv, D, F, 0.f};
  return carve_work(nullptr, nullptr, d, B, Vc, modes);
}

extern "C" int qtts_talker_step_batched(
    const void* x_in, int B, int n_past, const void* cosv, const void* sinv,
    const void* attn_n, const void* q_n, const void* k_n, const void* ffn_n,
    const void* w0, const void* s0, const void* z0, int G0,
    const void* w1, const void* s1, const void* z1, int G1,
    const void* w2, const void* s2, const void* z2, int G2,
    const void* w3, const void* s3, const void* z3, int G3,
    const void* out_norm, const void* codec_head, int modes, void* kv, void* kv_scale,
    int kv_f32, int head_f32, int lane_major,
    int L, int H, int Hq, int Hkv, int D, int F, int C, int Vc, float eps,
    const void* seen, const void* seeds, float temp, float top_p, float penalty, int top_k,
    int greedy, int use_top_p, int suppress_start, int eos_id, const void* start,
    int start_min, const void* temps, const void* topps, const void* pens,
    void* hidden_out, void* logits_out, void* tok_out, void* ws, void* stream) {
  const Dims d{H, Hq, Hkv, D, F, eps};
  const StackWeights sw{
      Proj{proj_mode(modes, 0), w0, (const float*)s0, (const float*)z0, G0},
      Proj{proj_mode(modes, 1), w1, (const float*)s1, (const float*)z1, G1},
      Proj{proj_mode(modes, 2), w2, (const float*)s2, (const float*)z2, G2},
      Proj{proj_mode(modes, 3), w3, (const float*)s3, (const float*)z3, G3},
      (const float*)attn_n, (const float*)q_n, (const float*)k_n, (const float*)ffn_n};
  if (int bad = check_dims(d, Vc, B)) return bad;
  if (int bad = check_groups(sw, d)) return bad;
  if (kv_scale != nullptr && (start != nullptr || start_min != 0 || kv_f32 || lane_major))
    return (int)cudaErrorInvalidValue;
  if (lane_major && (start != nullptr || start_min != 0 || seen != nullptr))
    return (int)cudaErrorInvalidValue;
  if ((codec_head == nullptr) != (out_norm == nullptr) || (codec_head == nullptr && seen != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Work w;
  carve_work(&w, (char*)ws, d, B, Vc, modes);
  // batch-major [B, L, 2, Hkv, C, D]: a lane's rows contiguous; lane-major
  // [L, 2, Hkv, C, B, D]: a row of all lanes contiguous
  const long head_stride = (long)C * D * (lane_major ? B : 1);
  const long layer_stride = (long)Hkv * head_stride;
  const long lane_stride = lane_major ? (long)D : (long)L * 2 * layer_stride;
  const long row_stride = lane_major ? (long)B * D : (long)D;
  CUtensorMap kv_map;   // every layer's attention reads the rows [0, n_past]
  if (lane_major &&
      !lane_map(&kv_map, kv, kv_f32, lane_map_shape(L, Hkv, C, B, D, n_past + 1, kv_f32 ? 4 : 2)))
    return kLaneMapFailed;
  cudaMemcpyAsync(w.x, x_in, sizeof(float) * B * H, cudaMemcpyDeviceToDevice, st);
  ProjOut last{};
  for (int l = 0; l < L; ++l) {
    const float* cs = (const float*)cosv;
    const float* sn = (const float*)sinv;
    if (lane_major && kv_f32) {
      float* kvf = (float*)kv;
      auto lv = layer_view(sw, d, l, kvf + 2 * l * layer_stride, kvf + (2 * l + 1) * layer_stride,
                           head_stride, lane_stride, row_stride);
      lv.kv_map = &kv_map;
      lv.plane = 2 * l;
      last = run_layer<float, true>(d, lv, last, w, cs, sn, n_past, 1, 0, st);
    } else if (lane_major) {
      __nv_bfloat16* kvb = (__nv_bfloat16*)kv;
      auto lv = layer_view(sw, d, l, kvb + 2 * l * layer_stride,
                           kvb + (2 * l + 1) * layer_stride, head_stride, lane_stride,
                           row_stride);
      lv.kv_map = &kv_map;
      lv.plane = 2 * l;
      last = run_layer<__nv_bfloat16, true>(d, lv, last, w, cs, sn, n_past, 1, 0, st);
    } else if (kv_scale != nullptr) {
      int8_t* kvq = (int8_t*)kv;
      float* ks = (float*)kv_scale;
      auto lv = layer_view(sw, d, l, kvq + 2 * l * layer_stride, kvq + (2 * l + 1) * layer_stride,
                           head_stride, lane_stride);
      lv.Ks = ks + (size_t)(2 * l) * Hkv * C;
      lv.Vs = ks + (size_t)(2 * l + 1) * Hkv * C;
      last = run_layer(d, lv, last, w, cs, sn, n_past, 1, 0, st);
    } else if (kv_f32) {
      float* kvf = (float*)kv;
      const auto lv = layer_view(sw, d, l, kvf + 2 * l * layer_stride,
                                 kvf + (2 * l + 1) * layer_stride, head_stride, lane_stride,
                                 row_stride);
      last = run_layer(d, lv, last, w, cs, sn, n_past, 1, 0, st, (const int*)start,
                       start_min);
    } else {
      __nv_bfloat16* kvb = (__nv_bfloat16*)kv;
      const auto lv = layer_view(sw, d, l, kvb + 2 * l * layer_stride,
                                 kvb + (2 * l + 1) * layer_stride, head_stride, lane_stride,
                                 row_stride);
      last = run_layer(d, lv, last, w, cs, sn, n_past, 1, 0, st, (const int*)start,
                       start_min);
    }
  }
  final_norm(d, last, (const float*)out_norm, w, (float*)hidden_out, st);
  if (codec_head == nullptr) {   // the residual x is the hidden state; no logits
    const int last_err = (int)cudaGetLastError();
    return w.err != cudaSuccess ? (int)w.err : last_err;
  }
  const int splits = project_head(w, (const float*)hidden_out, codec_head, head_f32, H, Vc, st);
  head_sample_kernel<<<B, kHeadThreads, 0, st>>>(
      w.head, splits, Vc, (float*)logits_out, (int*)tok_out, 1, 0, suppress_start, eos_id,
      (const int8_t*)seen, penalty, temp, top_p, top_k, greedy, use_top_p, 0,
      (const int*)seeds, 0, (const float*)temps, (const float*)topps, (const float*)pens);
  const int last_err = (int)cudaGetLastError();
  return w.err != cudaSuccess ? (int)w.err : last_err;
}
