// One Qwen3 decoder layer for one token in each of B lanes, as a handful of
// kernels: the building blocks of K1 (talker_step.cu), which runs one lane,
// and of K5 (talker_step_batched.cu), which runs B. K2 and K6 (the
// persistent kernel of code_predictor_persistent.cuh) reuse the device
// helpers (emit/quantize, proj_value's arithmetic); their own w8a8 tile
// keeps the __dp4a form of the earlier batched GEMM.
//
//   resid_rms        x += previous projection; h = RMSNorm(x); emit(h)
//   project          y[b, :] = x[b, :] @ W     (in the projection's mode)
//   qkv_post         q/k RMSNorm + NEOX RoPE; K/V row written into the cache
//   attn_layer       o = softmax(q . K^T * D^-0.5) @ V for every lane and
//                    KV head, one cluster each, in one launch
//   attn_emit        emit(o)
//   project          o_proj
//   resid_rms        x += o_proj; h = RMSNorm(x); emit(h)
//   project          gate/up
//   swiglu           a = silu(gate) * up; emit(a)
//   project          down (added to x by the next layer's first kernel)
//
// Weight modes. Each projection has its own (the Pallas kernels' per-weight
// modes, qwen3tts_tpu/ops/pallas_talker_step.py:71 _make_mm_values and :153
// _weight_mode; the code predictor runs w8a8 only):
//   w8a8    int8 W [K, N] and scales [N]. emit() quantizes the activation
//           per token (s = max(amax, 1e-8) * (1/127), round half to even),
//           the dot accumulates in int32 (exact and independent of order, so
//           the split-K atomics and the GEMV/GEMM choice change nothing),
//           and the consumer reads acc * (s * w_scale) in float32;
//   bf16    bf16 W [K, N]. emit() writes the float32 activation rounded to
//           bf16 (the GEMVs round it again, which changes nothing);
//   w4bf16  split-half nibbles [K/2, N] (byte i: row i low, row i + K/2
//           high) with float32 scale and zero [G, N] per group of gs = K/G
//           logical rows. Per half, w = q * s - z (product rounded first)
//           rounded to bf16, dotted with the bf16 activation;
//   f32     float32 W [K, N] (the float32 tier: the Pallas "bf16" mode
//           dots x.astype(wq.dtype), which is float32 then). emit() writes
//           the float32 activation unrounded.
// A bf16 x bf16 product, and a float32 x float32 one, is exact in float64,
// so the float modes sum their products in float64 into per-split partials
// [halves, splits, B, N] (no float atomics), and the consumer adds the
// splits in order and rounds once to float32 per half; the w4bf16 halves
// are then added in float32, as the Pallas kernel adds its two float32
// dots. The plain versions compute the same float64 dots, so both get the
// same bits.
//
// The KV cache holds bf16 or float32 rows (T), or the int8 pair below; q is
// rounded to T (a no-op for float32), and so are the probabilities where
// round_p asks for it. Float32 rows are 512 bytes: the attention ring takes
// 32 of them a tile, so that a tile is 16 KB in both dtypes and the cluster
// sizes and the shared memory are the bf16 cache's.
//
// Layouts. A lane's cache rows of one KV head are contiguous in the
// batch-major cache [B, L, 2, Hkv, C, D] (K1: B = 1) and lie row_stride = B
// * D elements apart in the lane-major one [L, 2, Hkv, C, B, D]
// (pallas_talker_step.py:1246 _make_kernel_batched_lane, K5 with
// kv_layout="lane"), where row t of all lanes is one [B, D] run of the
// [C, B, D] slab. The row kernels take the cache through (head_stride,
// lane_stride, row_stride). attn_layer_kernel brings each ring tile in
// with one copy: a batch-major lane's contiguous rows as one bulk copy,
// a lane-major lane's rows as one tensor copy (attn_layer_kernel<T, G,
// true>: the box of a CUtensorMap over the whole cache, encoded once a
// call by talker_step_batched.cu, that the TMA unit gathers row by row).
// The grid, the clusters and each lane's arithmetic are the same in both,
// so lane-major K5 equals batch-major K5 bit for bit on the same cache
// contents.
//
// Lanes. Every per-token kernel takes its lane from the grid (blockIdx.x
// for the row kernels, y or z for the others) and finds lane b's vectors at
// b times their length; one lane is the grid of one. `project` is a GEMV
// for one lane (split-K, on the CUDA cores) and, for B lanes, a GEMM on the
// tensor cores (gemm_i8_mma_kernel: int8 mma into int32; gemm_f64_mma_kernel:
// float64 mma over bf16 values widened exactly) that streams each weight
// tile into shared memory once, by asynchronous copies through a ring, and
// multiplies it against all B lanes' activation rows: every weight byte
// leaves device memory once per call, whatever B is. That is the point of
// the batched Pallas kernels (pallas_talker_step.py:1463 and
// pallas_code_predictor_batched.py:69, M = B MXU dots). The GEMMs' section
// below says what bounds them and how they are built.
//
// Attention optionally casts q and the softmax probabilities to the KV dtype
// (round_q, round_p: the single-stream talker kernel casts both, :338 and
// :349; the batched one casts q only, :1529; the code predictors neither),
// and reads only positions below n_valid: no masked position is ever
// multiplied by cache memory, stale or not. The softmax is dense: the row
// maximum, then the sum, then p = e / sum; the batched Pallas kernel's
// online softmax computes the same function in another summation order.
//
// What bounds the attention on the H100: the K and V rows, 2 * Hkv * D * 2
// bytes a row per lane and layer (7.34 GB per K5 call at B = 16, n_past =
// 4000: 2.19 ms at 3.35 TB/s), and beside them the conversions of every K
// and V element to float64 (16 a clock per SM; about 1 ms of that call).
// attn_layer_kernel therefore streams each (lane, KV head)'s rows through
// a ring of 64-row tiles in shared memory, each one copy (TMA: a bulk copy
// of a batch-major lane's contiguous rows, a tensor copy of a lane-major
// lane's strided ones) completing on the stage's mbarrier, issued by one
// thread all but one stage ahead: K for the scores, then V,
// whose first tiles are in flight while the softmax runs. The rows are
// split over a thread block cluster of up to 16 blocks (about two blocks on
// each SM for the whole grid, at least 64 rows each); a block keeps its
// slice's scores in shared memory, the cluster exchanges the maximum and
// the float64 sum over distributed shared memory, and rank 0 adds the
// blocks' float64 partial o. In a tile, a quarter-warp shares a row's dot
// products (its 16-byte reads cover the row once, one bank each; q in
// registers as float64; three shuffles), and p @ V runs in [G, 4] float64
// accumulators per thread. One launch per layer replaces three and a
// merge, and neither the scores nor the partials touch device memory.
//
// Per-lane start (K5 in continuous serving, pallas_talker_step.py:1419-1423,
// :1516-1517): with a `start` operand [B], lane b attends the rows
// [start[b], pos] only (lane_start: clamped to [0, pos], so the current row
// always counts, as the Pallas kernel folds it in after its chunk loop).
// Rows below start are never read: they enter neither the softmax max nor
// its sum nor p @ V. The cluster splits only rows from start_min on, the
// caller's lower bound of every lane's start (the Pallas kernel's
// min-start DMA skip, :1445), so the blocks' slices shrink with it. K1
// passes no start.
//
// The int8 KV cache (the int8-KV tier; the Pallas kernels' kv_int8 operand,
// :564, :765, :1402): int8 rows with one float32 scale per row, read by
// attn_layer_kernel<int8_t> (128-byte rows; the ring, the cluster and the
// order as above). The current step's K/V rows go to a bf16 staging buffer
// instead of the cache and are attended from there, unquantized, folded in
// after the cached rows as the Pallas kernels fold them into their flash
// state (:716-725, :930, :1554-1566); kv_row_quant then writes their (q,
// scale) at pos. A cached score is (q . k) * D^-0.5 * k_scale (:693, :907,
// :1529-1533); a cached row's e = exp(s - m) (m the cached rows' maximum,
// not yet normalized) is multiplied by its V scale, then rounded to bf16 in
// K1 (:701-703) and kept in float32 in K5 (:1541-1543), once per row and
// query head, before p @ V; rank 0 folds in the current row and divides by
// the sum last (o = (acc * alpha + p * v) / l, :711-725). q is rounded to
// bf16. The quantization is
// ops/kv_quant.py's: scale = max(amax, 1e-8) * float32(1/127), q =
// clip(rint(x / scale), -127, 127) with an IEEE divide (__fdiv_rn).
//
// Every float sum whose result feeds a rounding — the projections of the
// float modes, the RMSNorm variances, q.k, the softmax sum, p @ V — runs in
// float64 and is rounded to float32 once, and exp (softmax, SiLU) is
// evaluated in float64 and rounded. Products of float32 operands are exact
// in float64, so these results depend on summation order only through
// float64 roundings, far below float32's, and the plain versions, which do
// the same in PyTorch, get the same float32 bits (tests/
// test_torch_attention_order.py rebuilds the attention's cluster order and
// holds it to the plain version bit for bit).
// Without this, a last bit of difference now and then flips an activation's
// int8 or bf16 rounding (at B = 64 already within two layers), and the
// layers amplify the flip. For the same reason no product is fused into an
// add (__fmul_rn, __fadd_rn, __fsub_rn) where the plain version rounds it
// first.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "sampler.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kRowThreads = 1024;   // one block handles one lane's vector
constexpr int kMaxGroup = 8;        // query heads per KV head
constexpr int kSplitTarget = 264;   // ~2 blocks per SM of an H100
constexpr int kMaxLanes = 128;      // lanes of one batched call
constexpr int kGemmTN = 128;        // output columns per codec head GEMM block
constexpr int kGemmTKf = 32;        // bf16 head rows per shared tile
constexpr int kGemmThreads = 256;   // threads of a GEMM block
constexpr int kHeadSplits = 8;      // K splits of the batched head GEMM
// head_sample_kernel: a block of kHeadThreads samples a codec-head row of
// at most kMaxCodecVocab logits held in registers (sampler.cuh), kHeadEPT
// a thread in runs of kHeadP
constexpr int kHeadEPT = kMaxCodecVocab / kHeadThreads;
constexpr int kHeadP = kHeadEPT % 4 == 0 ? 4 : kHeadEPT % 2 == 0 ? 2 : 1;

enum WeightMode { kW8A8 = 0, kBF16 = 1, kW4BF16 = 2, kF32 = 3 };

// The codes of a GEMV or GEMM plan (gemv_plan, gemm_plan) and of the
// projection harness (talker_step.cu qtts_project_layers): the weight
// modes w8a8, bf16, w4bf16 as they are, then the codec head's GEMV over
// bf16 (kPlanHead) and float32 weights (kPlanHeadF32), and the f32 mode.
constexpr int kPlanHead = 3, kPlanF32 = 4, kPlanHeadF32 = 5;
__host__ __device__ constexpr int plan_code(int mode) { return mode == kF32 ? kPlanF32 : mode; }

// One projection's weights (a whole stack, or one layer of it).
struct Proj {
  int mode;
  const void* w;    // int8 [K, N] | bf16 [K, N] | packed u4 int8 [K/2, N] | f32 [K, N]
  const float* s;   // w8a8: scales [N]; w4bf16: group scales [G, N]
  const float* z;   // w4bf16: group offsets [G, N]
  int G;            // w4bf16: groups
};

// Where a projection's result lies and how its consumer reads it.
struct ProjOut {
  const int* acc;       // w8a8: int32 [B, N]
  const float* s_act;   // w8a8: activation scales [B]
  const float* ws;      // w8a8: weight scales [N]
  const double* part;   // bf16 / w4bf16: partials [halves, splits, B, N]
  int splits, halves, B, N;
};

// What a row kernel hands the next projection.
struct Emit {
  int8_t* xq;     // w8a8: int8 rows [B, ldq] and their scales s_out [B]
  float* s_out;
  float* xf;      // float modes: float32 rows [B, ldq] (bf16 values unless f32)
  int round;      // xf rounded to bf16 (bf16, w4bf16), or not (f32)
  int ldq;
  int* zero;      // w8a8: the projection's int32 accumulator [B, zero_n], cleared
  int zero_n;
};

// Element n of lane b of a projection's result (float32).
__device__ __forceinline__ float proj_value(const ProjOut& p, int b, int n) {
  if (p.acc != nullptr)
    return __fmul_rn((float)p.acc[(size_t)b * p.N + n], __fmul_rn(p.s_act[b], p.ws[n]));
  float y = 0.f;
  for (int h = 0; h < p.halves; ++h) {
    double s = 0.0;
    for (int sp = 0; sp < p.splits; ++sp)
      s += p.part[(((size_t)h * p.splits + sp) * p.B + b) * p.N + n];
    y = h == 0 ? (float)s : __fadd_rn(y, (float)s);
  }
  return y;
}

__host__ __device__ __forceinline__ bool proj_present(const ProjOut& p) {
  return p.acc != nullptr || p.part != nullptr;
}

__device__ void quantize_buf(const float* buf, int n, float amax_local, int8_t* xq,
                             float* s_out, float* red) {
  const float am = block_max(amax_local, red);
  const float s = fmaxf(am, 1e-8f) * (1.0f / 127.0f);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    xq[i] = (int8_t)fminf(fmaxf(rintf(buf[i] / s), -127.f), 127.f);
  if (threadIdx.x == 0) s_out[0] = s;
}

// Lane b's row buf[0:n) (shared, written by this thread at i = tid + k *
// blockDim) to the next projection, in its mode.
__device__ void emit_row(const float* buf, int n, float amax_local, const Emit& e, int b,
                         float* red) {
  if (e.xf != nullptr) {   // rounded to bf16 here, once (the projections' operand)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      e.xf[(size_t)b * e.ldq + i] = e.round ? bf16_round(buf[i]) : buf[i];
  } else {
    quantize_buf(buf, n, amax_local, e.xq + (size_t)b * e.ldq, e.s_out + b, red);
  }
  if (e.zero != nullptr)
    for (int i = threadIdx.x; i < e.zero_n; i += blockDim.x) e.zero[(size_t)b * e.zero_n + i] = 0;
}

// Lane blockIdx.x: x += the previous projection (when present); h =
// x * rsqrt(mean(x^2)+eps) * norm. Then h goes to the next projection
// (emit), or, when h_out is given, is written there in float32 (x itself
// when norm is null: K5 without its codec head returns the residual).
__global__ void resid_rms_kernel(float* x, ProjOut in,
                                 const float* __restrict__ norm, int H, float eps, Emit e,
                                 float* __restrict__ h_out) {
  extern __shared__ float buf[];
  __shared__ float red[32];
  __shared__ double redd[32];
  pdl_trigger();
  pdl_wait();
  const int b = blockIdx.x;
  const bool add = proj_present(in);
  x += (size_t)b * H;
  if (h_out != nullptr) h_out += (size_t)b * H;
  double ss = 0.0;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    float v = x[i];
    if (add) v = __fadd_rn(v, proj_value(in, b, i));
    x[i] = v;
    buf[i] = v;
    ss += (double)v * v;
  }
  const float var = (float)(block_sum(ss, redd) / H);
  const float rs = 1.0f / sqrtf(var + eps);
  float am = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float h = norm != nullptr ? buf[i] * rs * norm[i] : buf[i];
    buf[i] = h;
    am = fmaxf(am, fabsf(h));
    if (h_out != nullptr) h_out[i] = h;
  }
  if (h_out == nullptr) emit_row(buf, H, am, e, b, red);
}

// --- K1's GEMVs (one lane) -----------------------------------------------
//
// y = x @ W for one lane: a projection of K1 in its weight mode, or the
// codec head (bf16 weights, float32 partials). What bounds them on the
// H100: the weight bytes, 2-6 MB a projection at 0.6B widths (0.6-1.9 µs
// at 3.35 TB/s) and 15.7 MB an int8 layer; they are too small to amortize
// a launch and a cold start, and they ask for about 25 KB of loads in flight
// on each SM (Little's law at ~1 µs of latency). So:
//   - a block of 256 threads owns one tile of 128 bytes of every weight row
//     (128 int8 or packed u4 columns, 64 bf16 ones) by 128 rows (64 packed
//     u4 rows) and streams it with one 16-byte load per thread and row, all
//     issued at once: 16 KB (8 KB for u4, plus its scales) per block, and a
//     grid of one block per tile (128-768 blocks at 0.6B widths), so every
//     SM has its share of the whole projection in flight at once;
//   - the weight loads are issued before pdl_wait(): under programmatic
//     dependent launch (run_layer, B = 1) the blocks become resident while
//     the row kernel before them still runs, and only x, and the
//     accumulator that row kernel cleared, wait for it;
//   - the reduction: each thread sums its rows, a warp's four thread rows
//     are reduce-scattered by shuffles (gemv_scatter), the 8 warps added in
//     order in shared memory; then w8a8 adds its int32 sums by atomics
//     (exact in any order), the float modes write their split's float64
//     partial [halves, splits, 1, N] (the consumer adds the splits in
//     order, proj_value), the head its float32 partial.
// Whatever does not need x also runs before the wait, off the chain's
// critical path: w8a8 transposes 4 rows x 4 columns of bytes
// (byte_transpose) for __dp4a against x's 4 bytes (4 dp4a per 16 bytes);
// the float modes ready each weight for a DFMA without a float64 conversion
// (cvt to or from f64 issues 16 a clock per SM): a bf16 value's bits
// shifted into a double's high word with the exponent field widened from 8
// to 11 bits but not rebiased (bf16_hi) are that value times 2^-896
// exactly, zeros and subnormals included (finite values only), and x is
// multiplied by 2^896 once per row (exact: |x| < 2^128), so each DFMA adds
// the exact product; u4 weights are dequantized as dequant4 does (float32
// q * s - z, each rounded, then two at a time to bf16, to nearest even, by
// one cvt) with the group's scale and offset staged in shared memory once
// per block. After the wait, x is read through L2 (ld_chain).
// ops/fused_talker_step.gemv_plan mirrors the tiles;
// tests/test_torch_gemv_order.py holds the summation order to the plain
// versions' bits.
// Float32 weights (f32 mode, the float32 codec head) take the bf16 GEMV's
// form with 4 columns a thread (32 a block) and no bf16_hi: each weight is
// widened to float64 by one conversion after the wait; their products with
// the float32 x are exact in float64 too.
constexpr int kGemvThreads = 256;
constexpr int kGemvTX = 8;                        // threads along a row: 8 x 16 bytes
constexpr int kGemvTY = kGemvThreads / kGemvTX;   // thread rows

// Rows a thread takes (packed rows for u4), columns of a block, by plan code.
__host__ __device__ constexpr int gemv_thread_rows(int code) { return code == kW4BF16 ? 2 : 4; }
__host__ __device__ constexpr int gemv_cols(int code) {
  return code == kBF16 || code == kPlanHead ? 64
         : code == kPlanF32 || code == kPlanHeadF32 ? 32 : 128;
}

// One 16-byte load of weights read once (no L1 allocation); volatile, so
// that it is issued where it stands, before pdl_wait().
__device__ __forceinline__ int4 ld_weights16(const void* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// A load of data the chain writes (x, xq), through L2, issued where it
// stands: after pdl_wait().
__device__ __forceinline__ float ld_chain(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ int ld_chain(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Keep v computed before the next volatile statement (pdl_wait()): the
// weights' transforms belong to the part of a GEMV that overlaps the
// kernel before it.
__device__ __forceinline__ void pin(uint32_t& v) { asm volatile("" : "+r"(v)); }

// The high word of a double equal to the bf16 value held in the top 16 bits
// of f times 2^-896 (exactly, for every finite value; its low word is 0):
// the exponent field widened from 8 to 11 bits, not rebiased; the sign kept.
__device__ __forceinline__ uint32_t bf16_hi(uint32_t f) {
  return (uint32_t)(((int)f >> 3) & (int)0x8FFFE000);
}
__device__ __forceinline__ double from_hi(uint32_t hi) { return __hiloint2double((int)hi, 0); }

constexpr double kBf16Unscale = 0x1p896;   // x's factor against bf16_hi

// x[k] rounded to bf16, as a double times 2^896 (0 past K).
__device__ __forceinline__ double x_scaled(const float* x, int k, int K) {
  return k < K ? (double)bf16_round(ld_chain(x + k)) * kBf16Unscale : 0.0;
}

// Two u4 weights q_a, q_b (0..15) with scales s_a, s_b and offsets z_a,
// z_b, each bf16(q * s - z) as dequant4 computes it (float32, each
// operation rounded; then to bf16, to nearest even, both in one cvt), as
// bf16_hi gives them: *ha, *hb. m_a, m_b: the nibbles as the float32 bits
// 0x4B0000qq (2^23 + q).
__device__ __forceinline__ void w4_pair_hi(uint32_t m_a, float s_a, float z_a, uint32_t m_b,
                                           float s_b, float z_b, uint32_t* ha, uint32_t* hb) {
  const float a = __fsub_rn(__fmul_rn(__fsub_rn(__uint_as_float(m_a), 8388608.f), s_a), z_a);
  const float b = __fsub_rn(__fmul_rn(__fsub_rn(__uint_as_float(m_b), 8388608.f), s_b), z_b);
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);   // a in the low half
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&p);
  *ha = bf16_hi(u << 16);
  *hb = bf16_hi(u);
}

// The block's sums of a GEMV. Thread (tx, ty) holds NV values v (sums over
// its rows; index i is the block's output tx * NV + i); a warp
// reduce-scatters them over its four thread rows (lane bits 3-4), leaving
// ((t0 + t1) + (t2 + t3)) of NV / 4 of them in each lane, into red [warps,
// NV / 4, 32]. Fewer shuffles than a full reduction: NV / 2 + NV / 4 per
// lane.
template <typename T, int NV>
__device__ __forceinline__ void gemv_scatter(T (&v)[NV], T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool b1 = lane & 8, b2 = lane & 16;
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {   // lanes with bit 3 set keep the upper half
    const T send = b1 ? v[i] : v[NV / 2 + i];
    const T keep = b1 ? v[NV / 2 + i] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < NV / 4; ++i) {   // then bit 4 picks the quarter
    const T send = b2 ? v[i] : v[NV / 4 + i];
    const T keep = b2 ? v[NV / 4 + i] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int j = 0; j < NV / 4; ++j) red[(warp * (NV / 4) + j) * 32 + lane] = v[j];
}

// Output o of the block (o < 8 * NV; after a __syncthreads()): its 8
// warps' sums (gemv_scatter) added in order from zero.
template <typename T, int NV>
__device__ __forceinline__ T gemv_block_sum(const T* red, int o) {
  const int tx = o / NV, i = o % NV, j = i % (NV / 4);
  const int lane = tx + 8 * (i / (NV / 2) + 2 * ((i % (NV / 2)) / (NV / 4)));
  T s = 0;
#pragma unroll
  for (int r = 0; r < kGemvThreads / 32; ++r) s += red[(r * (NV / 4) + j) * 32 + lane];
  return s;
}

// w8a8: acc[n] += sum over this block's 128 rows of xq[k] * W[k, n], W int8
// [K, N] (K a multiple of 4, N of 16); grid (N / 128, K / 128). Before the
// wait: the loads and their 4 x 4 byte transposes; after it: x's 4 bytes,
// 16 dp4a, the sums.
__global__ void __launch_bounds__(kGemvThreads)
gemv_i8_kernel(const int8_t* xq, const int8_t* __restrict__ W, int K, int N, int* acc) {
  __shared__ int red[kGemvThreads / 32 * 4 * 32];
  pdl_trigger();
  const int tx = threadIdx.x % kGemvTX, ty = threadIdx.x / kGemvTX;
  const int n0 = blockIdx.x * 128 + 16 * tx, k0 = blockIdx.y * 128 + 4 * ty;
  int4 w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = n0 < N && k0 + i < K ? ld_weights16(W + (size_t)(k0 + i) * N + n0)
                                : make_int4(0, 0, 0, 0);
  uint32_t t[16];   // t[4q + j]: column 4q + j's rows k0..k0 + 3, one byte each
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = byte_transpose(reinterpret_cast<const uint32_t*>(&w[0])[q],
                                  reinterpret_cast<const uint32_t*>(&w[1])[q],
                                  reinterpret_cast<const uint32_t*>(&w[2])[q],
                                  reinterpret_cast<const uint32_t*>(&w[3])[q]);
    t[4 * q] = v.x;
    t[4 * q + 1] = v.y;
    t[4 * q + 2] = v.z;
    t[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) pin(t[j]);
  pdl_wait();
  const int xw = k0 < K ? ld_chain(reinterpret_cast<const int*>(xq + k0)) : 0;
  int a[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = __dp4a((int)t[j], xw, 0);
  gemv_scatter(a, red);
  __syncthreads();
  const int n = blockIdx.x * 128 + threadIdx.x;
  if (threadIdx.x < 128 && n < N) atomicAdd(acc + n, gemv_block_sum<int, 16>(red, threadIdx.x));
}

// Float weights W [K, N] of type Wt (bf16, N a multiple of 8; or float32,
// N a multiple of 4) against x float32 (rounded to bf16 for bf16 weights):
// this block's 128 rows x 8 * NV columns into partial[blockIdx.y, N], NV =
// 8 (bf16) or 4 (float32) columns a thread. Acc = double: a projection,
// exact products summed in float64 (bf16 weights widened to bf16_hi before
// the wait, float32 ones converted after it); Acc = float: the codec head,
// summed in float32 (the consumer adds the splits in float32).
template <typename Wt, typename Acc>
__global__ void __launch_bounds__(kGemvThreads)
gemv_float_kernel(const float* x, const Wt* __restrict__ W, int K, int N, Acc* partial) {
  constexpr bool kF64 = std::is_same<Acc, double>::value;
  constexpr bool kBw = std::is_same<Wt, __nv_bfloat16>::value;
  constexpr int NV = 16 / (int)sizeof(Wt), kCols = kGemvTX * NV;
  __shared__ Acc red[kGemvThreads / 32 * (NV / 4) * 32];
  pdl_trigger();
  const int tx = threadIdx.x % kGemvTX, ty = threadIdx.x / kGemvTX;
  const int n0 = blockIdx.x * kCols + NV * tx, k0 = blockIdx.y * 128 + 4 * ty;
  int4 w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = n0 < N && k0 + i < K ? ld_weights16(W + (size_t)(k0 + i) * N + n0)
                                : make_int4(0, 0, 0, 0);
  // row i, column j: bf16_hi (bf16, double), or the weight's float32 bits
  uint32_t h[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {   // word c: columns 2c (low half), 2c + 1 (high); float32: c
      const uint32_t u = reinterpret_cast<const uint32_t*>(&w[i])[c];
      if constexpr (kBw) {
        h[i][2 * c] = kF64 ? bf16_hi(u << 16) : u << 16;
        h[i][2 * c + 1] = kF64 ? bf16_hi(u) : u & 0xffff0000u;
        pin(h[i][2 * c]);
        pin(h[i][2 * c + 1]);
      } else {
        h[i][c] = u;
        pin(h[i][c]);
      }
    }
  pdl_wait();
  Acc xv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kBw && kF64) xv[i] = x_scaled(x, k0 + i, K);
    else if constexpr (kBw) xv[i] = k0 + i < K ? bf16_round(ld_chain(x + k0 + i)) : 0.f;
    else xv[i] = k0 + i < K ? (Acc)ld_chain(x + k0 + i) : (Acc)0;
  }
  Acc a[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    Acc v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // a bf16 x bf16 product is exact in float32
      if constexpr (kBw && kF64) v = __fma_rn(xv[i], from_hi(h[i][j]), v);
      else if constexpr (kF64) v = __fma_rn(xv[i], (double)__uint_as_float(h[i][j]), v);
      else v = __fmaf_rn(xv[i], __uint_as_float(h[i][j]), v);
    }
    a[j] = v;
  }
  gemv_scatter(a, red);
  __syncthreads();
  const int n = blockIdx.x * kCols + threadIdx.x;
  if (threadIdx.x < kCols && n < N)
    partial[(size_t)blockIdx.y * N + n] = gemv_block_sum<Acc, NV>(red, threadIdx.x);
}

// One u4 weight: (q * s - z) in float32 with the product rounded first (no
// FMA), rounded to bf16, widened to double (K5's GEMM widens its tiles with
// it; the GEMV takes w4_pair_hi).
__device__ __forceinline__ double dequant4(uint32_t q, float s, float z) {
  return (double)bf16_round(__fsub_rn(__fmul_rn((float)q, s), z));
}

// u4: x float32 [2 * Kh] (rounded to bf16) @ the weight Q [Kh, N] (split-
// half nibbles, N a multiple of 16) with scale S and offset Z [G, N], gs =
// 2 * Kh / G logical rows per group, a multiple of 32: this block's 64
// packed rows x 128 columns, float64 partials of the low half (rows [0,
// Kh)) into partial[0, blockIdx.y, N] and of the high half into
// partial[1, blockIdx.y, N]. The block's rows lie in at most two groups per
// half, whose scale and offset rows it copies into shared memory; the
// weights are dequantized before the wait, so that only x's products and
// the sums follow it.
__global__ void __launch_bounds__(kGemvThreads)
gemv_w4_kernel(const float* x, const int8_t* __restrict__ Q, const float* __restrict__ S,
               const float* __restrict__ Z, int Kh, int N, int gs, int G, double* partial) {
  constexpr int R = gemv_thread_rows(kW4BF16), kRows = kGemvTY * R;
  __shared__ __align__(16) float sc[2][2][2][128];   // [group][half][scale, offset][column]
  __shared__ double red[kGemvThreads / 32 * 8 * 32];
  pdl_trigger();
  const int tx = threadIdx.x % kGemvTX, ty = threadIdx.x / kGemvTX;
  const int nb = blockIdx.x * 128, n0 = nb + 16 * tx;
  const int r0 = blockIdx.y * kRows, i0 = r0 + R * ty, g0 = r0 / gs, Gh = G / 2;
  int4 w[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    w[i] = n0 < N && i0 + i < Kh ? ld_weights16(Q + (size_t)(i0 + i) * N + n0)
                                 : make_int4(0, 0, 0, 0);
  {   // one 16-byte copy a thread: (group, half, scale or offset, 4 columns)
    const int c = threadIdx.x, q = c % 32, sz = (c / 32) % 2, h = (c / 64) % 2, gi = c / 128;
    const int g = g0 + gi, n = nb + 4 * q;
    const bool ok = g * gs < Kh && n < N;
    cp_async16(&sc[gi][h][sz][4 * q], ok ? (sz ? Z : S) + (size_t)(h * Gh + g) * N + n : S, ok);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  const int gi = i0 / gs - g0;
  uint32_t hl[R][16], hh[R][16];   // row i, column j: the low and high weights' bf16_hi
#pragma unroll
  for (int q = 0; q < 4; ++q) {   // columns 16 tx + 4q .. + 3
    const float4 sl = *reinterpret_cast<const float4*>(&sc[gi][0][0][16 * tx + 4 * q]);
    const float4 zl = *reinterpret_cast<const float4*>(&sc[gi][0][1][16 * tx + 4 * q]);
    const float4 sh = *reinterpret_cast<const float4*>(&sc[gi][1][0][16 * tx + 4 * q]);
    const float4 zh = *reinterpret_cast<const float4*>(&sc[gi][1][1][16 * tx + 4 * q]);
    const float s_l[4] = {sl.x, sl.y, sl.z, sl.w}, z_l[4] = {zl.x, zl.y, zl.z, zl.w};
    const float s_h[4] = {sh.x, sh.y, sh.z, sh.w}, z_h[4] = {zh.x, zh.y, zh.z, zh.w};
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const uint32_t word = reinterpret_cast<const uint32_t*>(&w[i])[q];
      const uint32_t lo4 = word & 0x0F0F0F0Fu, hi4 = (word >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // byte j's nibbles as 0x4B0000qq
        const uint32_t sel = 0x7540u | j;
        w4_pair_hi(__byte_perm(lo4, 0x4B000000u, sel), s_l[j], z_l[j],
                   __byte_perm(hi4, 0x4B000000u, sel), s_h[j], z_h[j], &hl[i][4 * q + j],
                   &hh[i][4 * q + j]);
        pin(hl[i][4 * q + j]);
        pin(hh[i][4 * q + j]);
      }
    }
  }
  pdl_wait();
  double xl[R], xh[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    xl[i] = x_scaled(x, i0 + i, Kh);
    xh[i] = i0 + i < Kh ? x_scaled(x, Kh + i0 + i, 2 * Kh) : 0.0;
  }
  double a[32];   // a[16 h + j]: half h, column 16 tx + j
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    double lo = 0.0, hi = 0.0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      lo = __fma_rn(xl[i], from_hi(hl[i][j]), lo);
      hi = __fma_rn(xh[i], from_hi(hh[i][j]), hi);
    }
    a[j] = lo;
    a[16 + j] = hi;
  }
  gemv_scatter(a, red);
  __syncthreads();
  const int o = threadIdx.x, h = (o % 32) / 16, n = nb + 16 * (o / 32) + o % 16;
  if (n < N)
    partial[((size_t)h * gridDim.y + blockIdx.y) * N + n] = gemv_block_sum<double, 32>(red, o);
}

// --- the batched projections on the tensor cores (B >= 2) -----------------
//
// gemm_i8_mma_kernel (w8a8) and gemm_f64_mma_kernel (bf16, w4bf16) stand in
// for the M = B dots of the batched Pallas talker kernel
// (qwen3tts_tpu/ops/pallas_talker_step.py:1604 fused_talker_step_batched,
// its projections at :1463): y[b, :] = x[b, :] @ W for the B lanes of a
// step, every weight byte read from device memory once, whatever B is.
//
// What bounds them on the H100, over one K5 call (28 layers at 0.6B
// widths): the weight bytes, 440 MB in int8 (0.131 ms at 3.35 TB/s), 881 MB
// in bf16 (0.263 ms), 330 MB in q4pure (0.099 ms); the int8 products, 2 x B
// x 440 M operations (56 G at B = 64: 0.028 ms at 1,979 TOPS); and the float
// modes' products, which are summed in float64 to keep the plain versions'
// bits: the same 56 G at B = 64 on the float64 tensor cores' 67 TFLOP/s,
// 0.84 ms (0.21 ms at B = 16).
//
// Design. Output columns go on the mma's M (16) and lanes on its N (8), so
// B pads to a multiple of 8. A block owns a strip of columns and a run of K
// tiles (gemm_plan: about one block per SM in int8, two in the float
// modes, each with several tiles). Weight tiles and the lanes' activation
// tiles stream into a ring of S stages by 16-byte cp.async, S - 1 tiles
// ahead. Per tile, one pass readies the weights for the mma in one of two
// buffers while the warps multiply the previous tile out of the other, so
// one barrier per tile orders copies, passes and products. Warp (mw, lw)
// multiplies 2 M tiles of 16 columns (32 * mw + 16 * m) against the lane
// tiles lw, lw + LW, ... (WL of them, 8 lanes each; empty ones skipped).
//   int8: mma.sync m16n8k32 s8 x s8 -> s32 (IMMA). Its weight operand wants
//         four consecutive k of a column in one word: the pass transposes
//         the tile's 4x4 byte blocks into a packed tile (padded rows, no
//         bank conflicts); the activation rows are k-contiguous as they are.
//         Split-K sums combine by int32 atomics into the accumulator that
//         the row kernels cleared: exact in any order.
//   float: mma.sync m16n8k8 f64 (DMMA). The pass widens each weight of the
//         tile to float64 once, in shared memory: bf16, float32 (f32 mode:
//         its tile is 8 KB, the activation unrounded), or one half's u4
//         nibbles dequantized as dequant4 does (a u4 weight's two halves go
//         to two blocks, blockIdx.z, which read the same packed bytes, one
//         projection's at most 3 MB, within the 50 MB L2). The activation
//         arrives rounded to bf16 (emit_row rounds it) and is widened as a
//         warp loads it. A bf16 x bf16 product is exact in float64, so
//         only the float64 addition order differs from the plain version
//         (tests/test_torch_gemm_order.py holds the plan's order to the
//         plain version's float32 bits). Each split writes its float64
//         partials [halves, splits, B, N]; the consumer adds the splits in
//         order.
constexpr int kGemmMinTiles = 2;      // K tiles a block takes at least (where K allows)
constexpr int kI8Blocks = 132;        // int8: blocks a GEMM aims at (one per SM)
constexpr int kI8Stages = 4;          // int8: ring stages
constexpr int kI8TN = 128;            // int8: output columns per block
constexpr int kI8TK = 128;            // int8: weight rows per tile
constexpr int kI8XRow = kI8TK + 16;   // int8: bytes per lane row of an activation stage
constexpr int kI8PRow = kI8TN + 8;    // int8: words per row of the packed tile
constexpr int kI8PWords = (kI8TK / 4) * kI8PRow;   // int8: words of one packed tile
constexpr int kI8MW = 4, kI8LW = 2;   // int8: warps along columns, along lanes
constexpr int kFBlocks = 264;         // float: blocks a GEMM aims at (two per SM)
constexpr int kFTN = 64;              // float: output columns per block
constexpr int kFTK = 32;              // float: weight rows (u4: packed rows) per tile
constexpr int kFXRow = kFTK + 4;      // float: floats per lane row of an activation stage
constexpr int kFWRow = kFTN + 8;      // float: doubles per row of the widened tile
constexpr int kFMW = 2, kFLW = 4;     // float: warps along columns, along lanes

// c += a (16 x 32, row) . b (32 x 8, col), int8 operands, int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 8, row) . b (8 x 8, col) in float64.
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4], double b0,
                                        double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// Bytes of shared memory of an int8 GEMM block for B8 lanes (B rounded up
// to 8): the ring's stages (weight tile, then the lanes' activation rows),
// then the two packed tiles.
__host__ __device__ constexpr int i8_stage_bytes(int B8) { return kI8TK * kI8TN + B8 * kI8XRow; }
__host__ __device__ constexpr int i8_smem_bytes(int B8) {
  return kI8Stages * i8_stage_bytes(B8) + 2 * kI8PWords * 4;
}

// acc[b, n] += sum over this block's K tiles of xq[b, k] * W[k, n]: int8 W
// [K, N], xq [B, ldq] (K, N, ldq multiples of 16), int32 atomics. Grid
// (column strips, K splits of `per` tiles); B <= 16 * WL.
template <int WL>
__global__ void __launch_bounds__(kGemmThreads)
gemm_i8_mma_kernel(const int8_t* __restrict__ xq, int ldq, int B, const int8_t* __restrict__ W,
                   int K, int N, int per, int* __restrict__ acc) {
  constexpr int S = kI8Stages;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  const int B8 = (B + 7) & ~7, stage = i8_stage_bytes(B8);
  uint32_t* P = reinterpret_cast<uint32_t*>(gemm_smem + S * stage);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int mw = warp % kI8MW, lw = warp / kI8MW;
  const int n0 = blockIdx.x * kI8TN, n_tiles = (K + kI8TK - 1) / kI8TK;
  const int t0 = blockIdx.y * per, nt = min(n_tiles, t0 + per) - t0;
  auto load = [&](int i) {   // tile t0 + i into stage i % S
    unsigned char* ws = gemm_smem + (i % S) * stage;
    const int k0 = (t0 + i) * kI8TK;
    for (int c = tid; c < kI8TK * (kI8TN / 16); c += kGemmThreads) {
      const int r = c / (kI8TN / 16), n = n0 + 16 * (c % (kI8TN / 16));
      const bool ok = k0 + r < K && n < N;
      cp_async16(ws + r * kI8TN + (n - n0), ok ? W + (size_t)(k0 + r) * N + n : W, ok);
    }
    for (int c = tid; c < B8 * (kI8TK / 16); c += kGemmThreads) {
      const int b = c / (kI8TK / 16), k = k0 + 16 * (c % (kI8TK / 16));
      const bool ok = b < B && k < K;
      cp_async16(ws + kI8TK * kI8TN + b * kI8XRow + (k - k0),
                ok ? xq + (size_t)b * ldq + k : xq, ok);
    }
  };
  auto pack = [&](int i) {   // tile i's weights, transposed into packed tile i & 1
    const uint32_t* raw = reinterpret_cast<const uint32_t*>(gemm_smem + (i % S) * stage);
    uint32_t* p = P + (i & 1) * kI8PWords;
    for (int j = tid; j < (kI8TK / 4) * (kI8TN / 4); j += kGemmThreads) {
      const int kw = j / (kI8TN / 4), q = j % (kI8TN / 4);
      const uint32_t* r = raw + 4 * kw * (kI8TN / 4) + q;
      *reinterpret_cast<int4*>(p + kw * kI8PRow + 4 * q) =
          byte_transpose(r[0], r[kI8TN / 4], r[2 * (kI8TN / 4)], r[3 * (kI8TN / 4)]);
    }
  };
  int c[2][WL][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < WL; ++j) c[m][j][0] = c[m][j][1] = c[m][j][2] = c[m][j][3] = 0;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nt) load(i);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();
  __syncthreads();
  pack(0);
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<S - 3>();
    __syncthreads();   // tiles i + 1 in, i packed; every warp done with tile i - 1
    if (i + S - 1 < nt) load(i + S - 1);
    cp_async_commit();
    if (i + 1 < nt) pack(i + 1);
    const uint32_t* p0 = P + (i & 1) * kI8PWords;
    const uint32_t* xs = reinterpret_cast<const uint32_t*>(gemm_smem + (i % S) * stage +
                                                           kI8TK * kI8TN);
#pragma unroll
    for (int s = 0; s < kI8TK / 32; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t* p = p0 + (8 * s + t) * kI8PRow + 32 * mw + 16 * m + g;
        a[m][0] = p[0];                 // column g,     k 4t..4t+3
        a[m][1] = p[8];                 // column g + 8
        a[m][2] = p[4 * kI8PRow];       // column g,     k 16+4t..
        a[m][3] = p[4 * kI8PRow + 8];
      }
#pragma unroll
      for (int j = 0; j < WL; ++j) {
        const int lt = lw + kI8LW * j;
        if (8 * lt >= B) continue;   // uniform over the warp
        const uint32_t* xr = xs + (8 * lt + g) * (kI8XRow / 4) + 8 * s + t;
        mma_s8(c[0][j], a[0], xr[0], xr[4]);
        mma_s8(c[1][j], a[1], xr[0], xr[4]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int n = n0 + 32 * mw + 16 * m + g;
#pragma unroll
    for (int j = 0; j < WL; ++j) {
      const int b = 8 * (lw + kI8LW * j) + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // c[e]: column n + 8 * (e >> 1), lane b + (e & 1)
        const int ne = n + 8 * (e >> 1), be = b + (e & 1);
        if (ne < N && be < B) atomicAdd(acc + (size_t)be * N + ne, c[m][j][e]);
      }
    }
  }
}

// The codec head for B lanes: x [B, ldx] float32 (rounded to bf16 for bf16
// weights) @ W [K, N] of type Wt (bf16 or float32): float32 partial sums of
// this block's 32-row K tiles into partial[split, b, N] (the consumer sums
// the splits in float32). Block = one 128-column strip x a run of tiles;
// each thread accumulates 4 columns x BPT lanes (lanes ty, ty + 8, ...);
// each weight element is read from device memory by exactly one block.
template <int BPT, typename Wt>
__global__ void __launch_bounds__(kGemmThreads)
gemm_head_kernel(const float* __restrict__ x, int ldx, int B, const Wt* __restrict__ W, int K,
                 int N, int tiles_per_split, float* __restrict__ partial) {
  constexpr bool kBw = std::is_same<Wt, __nv_bfloat16>::value;
  __shared__ __align__(16) float ws[kGemmTKf][kGemmTN];
  __shared__ float xs[kMaxLanes][kGemmTKf];
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int n = blockIdx.x * kGemmTN + 4 * tx;
  const int n_tiles = (K + kGemmTKf - 1) / kGemmTKf;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  float a[BPT][4];
#pragma unroll
  for (int i = 0; i < BPT; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kGemmTKf;
    __syncthreads();
    for (int r = ty; r < kGemmTKf; r += 8) {
      const int k = k0 + r;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K && n < N) {
        if constexpr (kBw) {
          const uint2 raw = *reinterpret_cast<const uint2*>(W + (size_t)k * N + n);
          const __nv_bfloat162 w01 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
          const __nv_bfloat162 w23 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
          f = make_float4(__low2float(w01), __high2float(w01), __low2float(w23),
                          __high2float(w23));
        } else {
          f = *reinterpret_cast<const float4*>(W + (size_t)k * N + n);
        }
      }
      *reinterpret_cast<float4*>(&ws[r][4 * tx]) = f;
    }
    for (int i = tid; i < B * kGemmTKf; i += kGemmThreads) {
      const int b = i / kGemmTKf, kk = i % kGemmTKf, k = k0 + kk;
      const float v = k < K ? x[(size_t)b * ldx + k] : 0.f;
      xs[b][kk] = kBw ? bf16_round(v) : v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kGemmTKf; ++kk) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        const float xv = xs[ty + 8 * i][kk];
        a[i][0] += xv * wv.x;
        a[i][1] += xv * wv.y;
        a[i][2] += xv * wv.z;
        a[i][3] += xv * wv.w;
      }
    }
  }
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < BPT; ++i) {
    const int b = ty + 8 * i;
    if (b >= B) break;
    float* out = partial + ((size_t)blockIdx.y * B + b) * N + n;
    out[0] = a[i][0];
    out[1] = a[i][1];
    out[2] = a[i][2];
    out[3] = a[i][3];
  }
}

// Bytes of shared memory of a float-mode GEMM block (WM: kBF16, kW4BF16 or
// kF32) for B8 lanes with S ring stages: the stages (the raw weight tile,
// for u4 its group's scale and offset rows, then the lanes' activation
// rows), then the two widened float64 tiles.
__host__ __device__ constexpr int f_wbytes(int wm) {
  return wm == kW4BF16 ? kFTK * kFTN + 2 * kFTN * 4 : kFTK * kFTN * (wm == kF32 ? 4 : 2);
}
__host__ __device__ constexpr int f_stage_bytes(int wm, int B8) {
  return f_wbytes(wm) + B8 * kFXRow * 4;
}
__host__ __device__ constexpr int f_smem_bytes(int wm, int B8, int S) {
  return S * f_stage_bytes(wm, B8) + 2 * kFTK * kFWRow * 8;
}

// Float64 partials of this block's K tiles of x [B, ldx] (float32: bf16
// values, or any float32 in f32) @ W into partial[h, split, b, N]. WM =
// kBF16 or kF32: W bf16 or float32 [K, N] (Wv), h = 0. WM = kW4BF16: a u4
// weight Q [K/2, N] (Wv, split-half nibbles) with
// scale S and offset Z [G, N], gs = K / G a multiple of kFTK; block
// (x, y, h) sums half h: the packed rows' low (h = 0) or high nibbles
// against x[:, h K/2 : (h + 1) K/2]. Grid (column strips, K splits of `per`
// tiles, halves); B <= 32 * WL; ST ring stages.
template <int WM, int WL, int ST>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_f64_mma_kernel(const float* __restrict__ x, int ldx, int B, const void* __restrict__ Wv,
                    const float* __restrict__ S, const float* __restrict__ Z, int K, int N,
                    int gs, int G, int per, double* __restrict__ partial) {
  constexpr bool W4 = WM == kW4BF16;
  constexpr int WB = f_wbytes(WM);
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  const int B8 = (B + 7) & ~7, stage = f_stage_bytes(WM, B8);
  double* Wd = reinterpret_cast<double*>(gemm_smem + ST * stage);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int mw = warp % kFMW, lw = warp / kFMW, h = blockIdx.z;
  const int rows = W4 ? K / 2 : K;   // weight rows in memory
  const int n0 = blockIdx.x * kFTN, n_tiles = (rows + kFTK - 1) / kFTK;
  const int t0 = blockIdx.y * per, nt = min(n_tiles, t0 + per) - t0;
  auto load = [&](int i) {   // tile t0 + i into stage i % ST
    unsigned char* ws = gemm_smem + (i % ST) * stage;
    const int k0 = (t0 + i) * kFTK;
    if constexpr (W4) {
      const int8_t* Q = (const int8_t*)Wv;
      for (int c = tid; c < kFTK * (kFTN / 16); c += kGemmThreads) {
        const int r = c / (kFTN / 16), n = n0 + 16 * (c % (kFTN / 16));
        const bool ok = k0 + r < rows && n < N;
        cp_async16(ws + r * kFTN + n - n0, ok ? Q + (size_t)(k0 + r) * N + n : Q, ok);
      }
      // the tile's group in half h: its scale row, then its offset row
      const size_t grp = (size_t)(k0 / gs + h * (G / 2)) * N;
      float* sc = reinterpret_cast<float*>(ws + kFTK * kFTN);
      for (int c = tid; c < 2 * (kFTN / 4); c += kGemmThreads) {
        const int n = n0 + 4 * (c % (kFTN / 4));
        cp_async16(sc + (c / (kFTN / 4)) * kFTN + n - n0,
                  n < N ? (c < kFTN / 4 ? S : Z) + grp + n : S, n < N);
      }
    } else {   // bf16 or float32 rows: EB bytes an element, 16 / EB a copy
      constexpr int EB = WM == kF32 ? 4 : 2, EC = 16 / EB;
      const unsigned char* W = (const unsigned char*)Wv;
      for (int c = tid; c < kFTK * (kFTN / EC); c += kGemmThreads) {
        const int r = c / (kFTN / EC), n = n0 + EC * (c % (kFTN / EC));
        const bool ok = k0 + r < rows && n < N;
        cp_async16(ws + EB * (r * kFTN + n - n0), ok ? W + EB * ((size_t)(k0 + r) * N + n) : W,
                   ok);
      }
    }
    float* xs = reinterpret_cast<float*>(ws + WB);
    for (int c = tid; c < B8 * (kFTK / 4); c += kGemmThreads) {
      const int b = c / (kFTK / 4), k = k0 + 4 * (c % (kFTK / 4));
      const bool ok = b < B && k < rows;
      cp_async16(xs + b * kFXRow + k - k0, ok ? x + (size_t)b * ldx + h * rows + k : x, ok);
    }
  };
  auto widen = [&](int i) {   // tile i's weights, in float64, into widened tile i & 1
    const unsigned char* ws = gemm_smem + (i % ST) * stage;
    double* d = Wd + (i & 1) * kFTK * kFWRow;
    for (int j = tid; j < kFTK * kFTN; j += kGemmThreads) {
      const int r = j / kFTN, n = j % kFTN;
      if constexpr (W4) {
        const float* sc = reinterpret_cast<const float*>(ws + kFTK * kFTN);
        const uint32_t q = ws[r * kFTN + n];
        d[r * kFWRow + n] = dequant4(h ? q >> 4 : q & 15u, sc[n], sc[kFTN + n]);
      } else if constexpr (WM == kF32) {
        d[r * kFWRow + n] = reinterpret_cast<const float*>(ws)[r * kFTN + n];
      } else {
        d[r * kFWRow + n] =
            __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(ws)[r * kFTN + n]);
      }
    }
  };
  double c[2][WL][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < WL; ++j) c[m][j][0] = c[m][j][1] = c[m][j][2] = c[m][j][3] = 0.0;
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nt) load(i);
    cp_async_commit();
  }
  cp_async_wait<ST - 2>();
  __syncthreads();
  widen(0);
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<ST - 3>();
    __syncthreads();   // tile i + 1 in, i widened; every warp done with tile i - 1
    if (i + ST - 1 < nt) load(i + ST - 1);
    cp_async_commit();
    if (i + 1 < nt) widen(i + 1);
    const double* wd = Wd + (i & 1) * kFTK * kFWRow;
    const float* xs = reinterpret_cast<const float*>(gemm_smem + (i % ST) * stage + WB);
#pragma unroll
    for (int s = 0; s < kFTK / 8; ++s) {
      double a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const double* p = wd + (8 * s + t) * kFWRow + 32 * mw + 16 * m + g;
        a[m][0] = p[0];                 // column g,     k t
        a[m][1] = p[8];                 // column g + 8, k t
        a[m][2] = p[4 * kFWRow];        // column g,     k t + 4
        a[m][3] = p[4 * kFWRow + 8];
      }
#pragma unroll
      for (int j = 0; j < WL; ++j) {
        const int lt = lw + kFLW * j;
        if (8 * lt >= B) continue;   // uniform over the warp
        const float* xr = xs + (8 * lt + g) * kFXRow + 8 * s + t;
        const double b0 = xr[0], b1 = xr[4];
        mma_f64(c[0][j], a[0], b0, b1);
        mma_f64(c[1][j], a[1], b0, b1);
      }
    }
  }
  double* out = partial + ((size_t)h * gridDim.y + blockIdx.y) * B * N;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int n = n0 + 32 * mw + 16 * m + g;
#pragma unroll
    for (int j = 0; j < WL; ++j) {
      const int b = 8 * (lw + kFLW * j) + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // c[e]: column n + 8 * (e >> 1), lane b + (e & 1)
        const int ne = n + 8 * (e >> 1), be = b + (e & 1);
        if (ne < N && be < B) out[(size_t)be * N + ne] = c[m][j][e];
      }
    }
  }
}

// --- attention and the other row kernels -----------------------------------

// One block per (head of the fused QKV output, lane) (block = D threads):
// q/k RMSNorm + NEOX RoPE of the QKV projection's result; q to q_out
// (float32), k and v rows written into the cache at the rows kdst/vdst
// point to (head h at h * head_stride, lane b at b * lane_stride).
template <typename T>
__global__ void qkv_post_kernel(ProjOut in, const float* __restrict__ qn,
                                const float* __restrict__ kn, const float* __restrict__ cosv,
                                const float* __restrict__ sinv, int Hq, int Hkv, int D,
                                float eps, float* __restrict__ q_out, T* __restrict__ kdst,
                                T* __restrict__ vdst, long head_stride, long lane_stride) {
  __shared__ float v[1024];
  __shared__ double redd[32];
  pdl_trigger();
  pdl_wait();
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x, i = h * D + d;
  const float y = proj_value(in, b, i);
  kdst += (size_t)b * lane_stride;
  vdst += (size_t)b * lane_stride;
  if (h >= Hq + Hkv) {
    vdst[(long)(h - Hq - Hkv) * head_stride + d] = from_f<T>(y);
    return;
  }
  const float var = (float)(block_sum((double)y * y, redd) / D);
  const float* w = h < Hq ? qn : kn;
  v[d] = y * (1.0f / sqrtf(var + eps)) * w[d];
  __syncthreads();
  const int half = D / 2, j = d % half;
  const float x1 = v[j], x2 = v[j + half];
  // each product rounded before the sum, as the plain version computes it
  const float o = d < half ? __fsub_rn(__fmul_rn(x1, cosv[j]), __fmul_rn(x2, sinv[j]))
                           : __fadd_rn(__fmul_rn(x1, sinv[j]), __fmul_rn(x2, cosv[j]));
  if (h < Hq) q_out[(size_t)b * Hq * D + i] = o;
  else kdst[(long)(h - Hq) * head_stride + d] = from_f<T>(o);
}

// Lane b's first attended row: start[b] clamped to [0, n_valid - 1], or 0
// without a start operand.
__device__ __forceinline__ int lane_start(const int* start, int b, int n_valid) {
  return start == nullptr ? 0 : min(max(start[b], 0), n_valid - 1);
}

// --- attention: one cluster per (lane, KV head), one launch per layer -------

constexpr int kAttD = 128;           // head_dim the attention kernel takes
constexpr int kAttThreads = 256;
constexpr int kAttTile = 64;         // K or V rows per ring stage (at most)
constexpr int kAttStages = 3;
constexpr int kAttMinRows = 64;      // rows a block of a cluster takes at least
constexpr int kAttMaxCluster = 16;   // a non-portable cluster
constexpr size_t kAttMaxSmem = 232448;   // shared memory a block may have

// Rows of one ring tile for cache rows of row_bytes: 64 (int8, bf16) or 32
// (float32), so that a tile is at most 16 KB.
__host__ __device__ constexpr int att_tile_rows(int row_bytes) {
  return row_bytes > 2 * kAttD ? kAttTile / 2 : kAttTile;
}

// Byte offsets in the attention kernel's shared memory, for G query heads
// per KV head, slices of at most `cap` rows and cache rows of row_bytes.
struct AttLayout {
  size_t o_blk, pd, dstat, redd, fstat, redf, bar, scores, total;
  __host__ __device__ AttLayout(int G, int cap, int row_bytes) {
    size_t ring = (size_t)kAttStages * att_tile_rows(row_bytes) * row_bytes;
    const size_t red = (size_t)8 * G * kAttD * sizeof(double);   // reuses the ring
    if (red > ring) ring = red;
    o_blk = ring;                                             // double [G, D]
    pd = o_blk + (size_t)G * kAttD * sizeof(double);          // double [2, G, tile]
    dstat = pd + (size_t)2 * G * kAttTile * sizeof(double);   // double [2, G]
    redd = dstat + (size_t)2 * G * sizeof(double);            // double [32]
    fstat = redd + 32 * sizeof(double);                       // float [6, G]
    redf = fstat + (size_t)6 * G * sizeof(float);             // float [32]
    bar = redf + 32 * sizeof(float);                          // uint64 [stages]
    scores = bar + kAttStages * sizeof(uint64_t);             // float [G, cap]
    total = scores + (size_t)G * cap * sizeof(float);
  }
};

// Row t of (kv half, head h) of lane b in an int8 cache half K or V (lane b
// at b * lane_stride, head h at h * head_stride, row t at t * D) has its
// scale at (b * lane_stride + h * head_stride) / D + t of that half's
// scales: the scale array is the cache's shape without its last axis.
__device__ __forceinline__ long q8_scale_base(int b, int h, long head_stride,
                                              long lane_stride, int D) {
  return ((long)b * lane_stride + (long)h * head_stride) / D;
}

// A cache element's value as the attention reads it: q is rounded to the
// cache's T (bf16; the int8 cache's staging rows are bf16; float32 is not
// rounded), and so is p where round_p asks for it.
template <typename T>
__device__ __forceinline__ float round_to_kv(float v) {
  return std::is_same<T, float>::value ? v : bf16_round(v);
}

// One layer's attention for lane b = blockIdx.z and KV head h = blockIdx.y,
// its G query heads of q [B, Hq * D] float32 into out [B, Hq * D] float32
// (the header gives the function and its bits). The gridDim.x blocks of a
// cluster split the lane's rows [t0, n_end) into contiguous slices of at
// most `cap` rows, rank r the r-th. T = bf16 or float: t0 = max(start_b,
// floor_row), n_end = n_valid. T = int8: the cached rows [0, n_end = pos)
// with their scales Ks and Vs, then the current row from cur [B, 2, Hkv, D]
// (bf16). Each block streams its K rows, then its V rows, through one ring
// of kAttStages tiles (att_tile_rows rows each; kAttStages - 1 tiles in
// flight), one copy a tile issued by thread 0: batch-major (!Lane), row t
// of (lane b, head h) lies at b * lane_stride + h * head_stride + t * D
// elements of K or V and a tile's rows are one bulk copy; lane-major
// (Lane, bf16 or float), a tile is one tensor copy of kv_map's box {D, 1,
// tile} at (0, b, first row, h, plane for K or plane + 1 for V), whose
// rows past n_end arrive as zeros (lane_map in talker_step_batched.cu). A
// block keeps its slice's scores in shared memory; the max and the float64
// sum of exp(s - m) are exchanged over distributed shared memory (the sum
// added in rank order), and rank 0 adds the blocks' float64 partial o in
// rank order and rounds it to float32 once.
template <typename T, int G, bool Lane>
__global__ void __launch_bounds__(kAttThreads)
attn_layer_kernel(const float* q, const T* __restrict__ K, const T* __restrict__ V,
                  long head_stride, long lane_stride, int n_end, int floor_row, int cap,
                  float scale, int round_q, int round_p, const int* __restrict__ start,
                  const float* __restrict__ Ks, const float* __restrict__ Vs,
                  const __nv_bfloat16* cur, float* __restrict__ out,
                  __grid_constant__ const CUtensorMap kv_map, int plane) {
  constexpr bool kQ8 = std::is_same<T, int8_t>::value;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kRow = kAttD * (int)sizeof(T);
  constexpr int kTile = att_tile_rows(kRow);   // rows of a ring tile
  static_assert(!(Lane && kQ8), "the lane-major cache holds bf16 or float32 rows");
  extern __shared__ __align__(128) unsigned char att_smem[];   // a tensor copy's destination
  const AttLayout lay(G, cap, kRow);
  double* o_blk = reinterpret_cast<double*>(att_smem + lay.o_blk);
  double* pd = reinterpret_cast<double*>(att_smem + lay.pd);
  double* dstat = reinterpret_cast<double*>(att_smem + lay.dstat);   // sum of e: block, cluster
  double* redd = reinterpret_cast<double*>(att_smem + lay.redd);
  // max: block, cluster; int8 only: s_cur, alpha, p_cur, l
  float* fstat = reinterpret_cast<float*>(att_smem + lay.fstat);
  float* redf = reinterpret_cast<float*>(att_smem + lay.redf);
  float* sc = reinterpret_cast<float*>(att_smem + lay.scores);      // [G, cap]: s, then p
  uint64_t* bar = reinterpret_cast<uint64_t*>(att_smem + lay.bar);
  pdl_trigger();
  pdl_wait();   // the current row and q come from the kernel before
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), S = (int)cluster.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z, Hkv = gridDim.y, Hq = Hkv * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = kQ8 ? 0 : max(lane_start(start, b, n_end), floor_row);
  const int per = (n_end - t0 + S - 1) / S;
  const int lo = t0 + rank * per, hi = min(n_end, lo + per), nr = max(hi - lo, 0);
  const int nt = (nr + kTile - 1) / kTile, total = 2 * nt;
  const T* Kb = K + (size_t)b * lane_stride + (size_t)h * head_stride;
  const T* Vb = V + (size_t)b * lane_stride + (size_t)h * head_stride;
  const float* qh = q + (size_t)b * Hq * kAttD + (size_t)h * G * kAttD;

  // tile i < nt: K rows [lo + kTile i, ...); tile nt + j: V rows [lo + kTile j, ...)
  auto load = [&](int i) {   // warp 0: the tile's rows, one copy issued by lane 0
    const int j = i < nt ? i : i - nt, r0 = lo + j * kTile, n = min(kTile, hi - r0);
    const T* src = (i < nt ? Kb : Vb) + (size_t)r0 * kAttD;
    unsigned char* dst = att_smem + (size_t)(i % kAttStages) * kTile * kRow;
    if (lane != 0) return;
    if constexpr (Lane) {   // the whole box arrives, rows past n_end as zeros
      mbar_expect(bar + i % kAttStages, (unsigned)(kTile * kRow));
      tensor_load_5d(dst, &kv_map, 0, b, r0, h, plane + (i >= nt), bar + i % kAttStages);
    } else {
      mbar_expect(bar + i % kAttStages, (unsigned)(n * kRow));
      bulk_load(dst, src, (unsigned)(n * kRow), bar + i % kAttStages);
    }
  };
  auto wait_tile = [&](int i) { mbar_wait(bar + i % kAttStages, (i / kAttStages) & 1); };
  if (warp == 0) {   // the first tiles are in flight while q is read
    if (lane == 0) {
      for (int s = 0; s < kAttStages; ++s) mbar_init(bar + s);
      mbar_init_fence();
    }
    __syncwarp();
    for (int i = 0; i < kAttStages - 1 && i < total; ++i) load(i);
  }

  // scores: lane bits 3-4 pick the row (warp w: rows 4w.. and 4w + 32..),
  // bits 0-2 the 16-byte chunks `part` (and part + 8, + 16, + 24 as the
  // row is longer) of it
  const int part = lane & 7;
  const int srow = warp * 4 + (lane >> 3);
  double qr[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int col = kQ8    ? 16 * part + e
                      : kF32 ? 4 * (part + 8 * (e / 4)) + e % 4
                             : (e < 8 ? 8 * part + e : 8 * (part + 8) + e - 8);
      const float v = qh[g * kAttD + col];
      qr[g][e] = kQ8 ? bf16_round(v) : round_q ? round_to_kv<T>(v) : v;
    }
  if (kQ8 && warp < G) {   // the current row's score, (q . k) * scale
    const __nv_bfloat16* kc = cur + ((size_t)b * 2 * Hkv + h) * kAttD;
    double a = 0.0;
    for (int d = lane; d < kAttD; d += 32)
      a += (double)bf16_round(qh[warp * kAttD + d]) * (double)__bfloat162float(kc[d]);
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane == 0) fstat[2 * G + warp] = __fmul_rn((float)a, scale);
  }
  __syncthreads();   // the barriers are set
  const float* ksb =
      kQ8 ? Ks + q8_scale_base(b, h, head_stride, lane_stride, kAttD) + lo : nullptr;
  float mloc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mloc[g] = -3.4e38f;
  for (int i = 0; i < nt; ++i) {
    wait_tile(i);
    __syncthreads();   // tile i landed; stage (i - 1) % kAttStages is free
    if (warp == 0 && i + kAttStages - 1 < total) load(i + kAttStages - 1);
    const unsigned char* tile = att_smem + (size_t)(i % kAttStages) * kTile * kRow;
    const int rows = min(kTile, nr - i * kTile);
#pragma unroll
    for (int j = 0; j < kTile / 32; ++j) {
      const int r = srow + 32 * j;
      const unsigned char* rp = tile + r * kRow;
      double a[G];
#pragma unroll
      for (int g = 0; g < G; ++g) a[g] = 0.0;
      float kf[16];
      if constexpr (kQ8) {
        const uint4 u = *reinterpret_cast<const uint4*>(rp + 16 * part);
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
        for (int e = 0; e < 16; ++e) kf[e] = (float)k8[e];
      } else if constexpr (kF32) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 u = *reinterpret_cast<const float4*>(rp + 16 * (part + 8 * c));
          kf[4 * c] = u.x;
          kf[4 * c + 1] = u.y;
          kf[4 * c + 2] = u.z;
          kf[4 * c + 3] = u.w;
        }
      } else {
        bf16x8(*reinterpret_cast<const uint4*>(rp + 16 * part), kf);
        bf16x8(*reinterpret_cast<const uint4*>(rp + 16 * (part + 8)), kf + 8);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const double kv = (double)kf[e];
#pragma unroll
        for (int g = 0; g < G; ++g) a[g] = fma(qr[g][e], kv, a[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) a[g] += __shfl_xor_sync(0xffffffffu, a[g], o);
      if (part == 0 && r < rows) {
        const int t = i * kTile + r;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = __fmul_rn((float)a[g], scale);
          if (kQ8) s = __fmul_rn(s, ksb[t]);
          sc[g * cap + t] = s;
          mloc[g] = fmaxf(mloc[g], s);
        }
      }
    }
  }

  // the cluster's max m (exact in any order), then its float64 sum of
  // e = exp(s - m), the blocks' sums added in rank order
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float m = block_max(mloc[g], redf);
    if (tid == 0) fstat[g] = m;
  }
  cluster.sync();
  if (tid < G) {
    float m = -3.4e38f;
    for (int r = 0; r < S; ++r) m = fmaxf(m, cluster.map_shared_rank(fstat, r)[tid]);
    fstat[G + tid] = m;
  }
  __syncthreads();
  const float* vsb =
      kQ8 ? Vs + q8_scale_base(b, h, head_stride, lane_stride, kAttD) + lo : nullptr;
  double sl[G];
#pragma unroll
  for (int g = 0; g < G; ++g) sl[g] = 0.0;
  for (int t = tid; t < nr; t += kAttThreads) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float s = sc[g * cap + t], m = fstat[G + g];
      if constexpr (kQ8) {   // e in float32, times the row's V scale: p @ V's weight
        const float e = (float)exp((double)(s - m));
        sl[g] += e;
        const float pv = __fmul_rn(e, vsb[t]);
        sc[g * cap + t] = round_p ? bf16_round(pv) : pv;
      } else {
        sl[g] += exp((double)(s - m));
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const double v = block_sum(sl[g], redd);
    if (tid == 0) dstat[g] = v;
  }
  cluster.sync();
  if (tid < G) {
    double tot = 0.0;
    for (int r = 0; r < S; ++r) tot += cluster.map_shared_rank(dstat, r)[tid];
    dstat[G + tid] = tot;
    if (kQ8) {   // the current row folds in after the cached rows
      const float m = fstat[G + tid], s_cur = fstat[2 * G + tid], mf = fmaxf(m, s_cur);
      const float alpha = (float)exp((double)(m - mf)), p = (float)exp((double)(s_cur - mf));
      fstat[3 * G + tid] = alpha;
      fstat[4 * G + tid] = p;
      fstat[5 * G + tid] = __fadd_rn(__fmul_rn(alpha, (float)tot), p);
    }
  }
  __syncthreads();
  if constexpr (!kQ8) {   // p = e / sum, rounded to float32 (and to T when round_p)
    for (int t = tid; t < nr; t += kAttThreads) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = (float)(exp((double)(sc[g * cap + t] - fstat[G + g])) / dstat[G + g]);
        sc[g * cap + t] = round_p ? round_to_kv<T>(p) : p;
      }
    }
    __syncthreads();
  }

  // p @ V in float64: thread (lane, warp) takes columns 4 lane.. and rows
  // warp + 8 i of each tile, 4 G independent sums
  double acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.0;
  for (int i = nt; i < total; ++i) {
    const int j = i - nt, rows = min(kTile, nr - j * kTile);
    wait_tile(i);
    double* pj = pd + (j & 1) * G * kTile;   // the tile's p, as doubles
    for (int k = tid; k < G * kTile; k += kAttThreads) {
      const int g = k / kTile, r = k % kTile;
      if (r < rows) pj[k] = (double)sc[g * cap + j * kTile + r];
    }
    __syncthreads();
    if (warp == 0 && i + kAttStages - 1 < total) load(i + kAttStages - 1);
    const unsigned char* tile = att_smem + (size_t)(i % kAttStages) * kTile * kRow;
    for (int r = warp; r < rows; r += 8) {
      double v[4];
      if constexpr (kQ8) {
        const char4 u = *reinterpret_cast<const char4*>(tile + r * kRow + lane * 4);
        v[0] = u.x;
        v[1] = u.y;
        v[2] = u.z;
        v[3] = u.w;
      } else if constexpr (kF32) {
        const float4 u = *reinterpret_cast<const float4*>(tile + r * kRow + lane * 16);
        v[0] = u.x;
        v[1] = u.y;
        v[2] = u.z;
        v[3] = u.w;
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(tile + r * kRow + lane * 8);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        v[0] = a.x;
        v[1] = a.y;
        v[2] = c.x;
        v[3] = c.y;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const double p = pj[g * kTile + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][c] = fma(p, v[c], acc[g][c]);
      }
    }
  }
  __syncthreads();   // the ring's last readers are done: it holds the row groups' sums
  double* red = reinterpret_cast<double*>(att_smem);   // [8, G, D]
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(warp * G + g) * kAttD + lane * 4 + c] = acc[g][c];
  __syncthreads();
  for (int k = tid; k < G * kAttD; k += kAttThreads) {
    double o = 0.0;
#pragma unroll
    for (int r = 0; r < 8; ++r) o += red[r * G * kAttD + k];
    o_blk[k] = o;
  }
  cluster.sync();
  if (rank == 0) {
    float* ob = out + (size_t)b * Hq * kAttD + (size_t)h * G * kAttD;
    for (int k = tid; k < G * kAttD; k += kAttThreads) {
      double o = 0.0;
      for (int r = 0; r < S; ++r) o += cluster.map_shared_rank(o_blk, r)[k];
      float of = (float)o;
      if constexpr (kQ8) {   // o = (o * alpha + p_cur * v_cur) / l
        const int g = k / kAttD;
        const float v = __bfloat162float(
            cur[((size_t)b * 2 + 1) * Hkv * kAttD + (size_t)h * kAttD + k % kAttD]);
        of = __fdiv_rn(__fadd_rn(__fmul_rn(of, fstat[3 * G + g]), __fmul_rn(fstat[4 * G + g], v)),
                       fstat[5 * G + g]);
      }
      ob[k] = of;
    }
  }
  cluster.sync();   // the blocks' shared memory stays until rank 0 has read it
}

// One staged bf16 row (lane blockIdx.y, row blockIdx.x of its [2 * Hkv]: K
// heads, then V heads) quantized as ops/kv_quant.quantize_kv quantizes it,
// into row pos of the int8 cache (K, V) and its scale (Ks, Vs). Block = D
// threads.
__global__ void kv_row_quant_kernel(const __nv_bfloat16* cur, int Hkv, int D,
                                    int8_t* __restrict__ K, int8_t* __restrict__ V,
                                    float* __restrict__ Ks, float* __restrict__ Vs,
                                    long head_stride, long lane_stride, int pos) {
  __shared__ float red[32];
  pdl_trigger();
  pdl_wait();
  const int j = blockIdx.x, b = blockIdx.y, h = j % Hkv, d = threadIdx.x;
  const float x = __bfloat162float(cur[((size_t)b * 2 * Hkv + j) * D + d]);
  const float s = __fmul_rn(fmaxf(block_max(fabsf(x), red), 1e-8f), 1.0f / 127.0f);
  const long row = (long)b * lane_stride + (long)h * head_stride + (long)pos * D;
  (j < Hkv ? K : V)[row + d] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
  if (d == 0) (j < Hkv ? Ks : Vs)[q8_scale_base(b, h, head_stride, lane_stride, D) + pos] = s;
}

// Lane blockIdx.x: its attention output o [n] (attn_layer_kernel's) to the
// O projection: emit(o).
__global__ void attn_emit_kernel(const float* o, int n, Emit e) {
  extern __shared__ float buf[];
  __shared__ float red[32];
  pdl_trigger();
  pdl_wait();
  const int b = blockIdx.x;
  float am = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = o[(size_t)b * n + i];
    buf[i] = v;
    am = fmaxf(am, fabsf(v));
  }
  emit_row(buf, n, am, e, b, red);
}

// Lane blockIdx.x: a = silu(gate) * up from the gate/up projection [2F];
// emit(a) to the down projection.
__global__ void swiglu_kernel(ProjOut in, int F, Emit e) {
  extern __shared__ float buf[];
  __shared__ float red[32];
  pdl_trigger();
  pdl_wait();
  const int b = blockIdx.x;
  float am = 0.f;
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    float g = proj_value(in, b, i);
    const float u = proj_value(in, b, F + i);
    g = g / (1.0f + (float)exp(-(double)g));
    const float a = g * u;
    buf[i] = a;
    am = fmaxf(am, fabsf(a));
  }
  emit_row(buf, F, am, e, b, red);
}

// P contiguous floats: one 16-, 8- or 4-byte access.
template <int P>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[P]) {
  if constexpr (P == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else if constexpr (P == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x; v[1] = u.y;
  } else {
    v[0] = *p;
  }
}
template <int P>
__device__ __forceinline__ void store_floats(float* p, const float (&v)[P]) {
  if constexpr (P == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (P == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else *p = v[0];
}

// The codec head rows head_sample_kernel takes (V <= kMaxCodecVocab, in
// whole runs of kHeadP); cudaErrorInvalidValue otherwise.
inline int head_check(int V) {
  return V < 1 || V > kMaxCodecVocab || V % kHeadP != 0 ? (int)cudaErrorInvalidValue : 0;
}

// Lane blockIdx.x of B (kHeadThreads threads): logits = sum of the head
// projection's split partials partial[split, b, V] (fixed order, eight
// splits' loads at a time), held in registers; optionally written to
// logits_out[b]; optionally sampled (sampler.cuh) into
// tok_out[b * tok_ld + tok_idx] with seeds[b] (or `seed` when seeds is
// null), the lane's row of `seen` [B, V], and the lane's temps[b],
// topps[b] and pens[b] (continuous serving: each request its own; a null
// array means the scalar, as for seeds).
__global__ void __launch_bounds__(kHeadThreads) head_sample_kernel(
    const float* partial, int splits, int V, float* __restrict__ logits_out,
    int* __restrict__ tok_out, int tok_ld, int tok_idx, int suppress_start, int eos_id,
    const int8_t* __restrict__ seen, float penalty, float temp, float top_p, int top_k,
    int greedy, int use_top_p, int seed, const int* __restrict__ seeds, int step,
    const float* __restrict__ temps, const float* __restrict__ topps,
    const float* __restrict__ pens) {
  constexpr int P = kHeadP;
  __shared__ SampleSmem<kHeadThreads> sm;
  __shared__ float2 queue[kHeadThreads * kHeadEPT];
  pdl_trigger();
  pdl_wait();
  const int b = blockIdx.x, B = gridDim.x;
  float x[kHeadEPT];
#pragma unroll
  for (int g = 0; g < kHeadEPT / P; ++g) {
    const int i = slot_index<kHeadThreads, P>(g * P);
    float v[P];
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = 0.f;
    if (i < V) {
      const float* src = partial + (size_t)b * V + i;
      for (int s = 0; s < splits; s += 8) {
        float u[8][P];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (s + t < splits) {
            load_floats<P>(src + (size_t)(s + t) * B * V, u[t]);
          } else {
#pragma unroll
            for (int j = 0; j < P; ++j) u[t][j] = 0.f;
          }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int j = 0; j < P; ++j)
            if (s + t < splits) v[j] += u[t][j];   // splits in order
      }
      if (logits_out != nullptr) store_floats<P>(logits_out + (size_t)b * V + i, v);
    }
#pragma unroll
    for (int j = 0; j < P; ++j) x[g * P + j] = v[j];
  }
  if (tok_out == nullptr) return;
  const SampleArgs a{temps != nullptr ? temps[b] : temp,
                     topps != nullptr ? topps[b] : top_p,
                     pens != nullptr ? pens[b] : penalty,
                     top_k, suppress_start, eos_id, greedy != 0, use_top_p != 0,
                     (uint32_t)(seeds != nullptr ? seeds[b] : seed), (uint32_t)step,
                     seen != nullptr ? seen + (size_t)b * V : nullptr};
  const int tok = suppress_penalize_sample<kHeadThreads, kHeadEPT, P>(x, V, a, sm, queue);
  if (threadIdx.x == 0) tok_out[(size_t)b * tok_ld + tok_idx] = tok;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Dims {
  int H, Hq, Hkv, D, F;
  float eps;
};

// Device scratch of one decoder stack for B lanes, carved from one
// workspace buffer; lane b's row of each [B, n] buffer starts at b * n.
struct Work {
  int B;           // lanes
  int ldq;         // row stride of xq and xf
  float* x;        // [B, H] residual carry
  int8_t* xq;      // [B, ldq] quantized activation (w8a8 projections)
  float* xf;       // [B, ldq] float32 activation (the float modes' projections)
  float* s;        // [4, B] activation scales: qkv, o, gate/up, down
  int* acc_qkv;    // [B, (Hq+2Hkv)*D]
  int* acc_o;      // [B, H]
  int* acc_gu;     // [B, 2F]
  int* acc_d;      // [B, H]
  double* part;    // float-mode projection partials [halves, splits, B, N]
  float* q;        // [B, Hq*D]
  float* attn;     // [B, Hq*D] attention output
  float* hnorm;    // [B, H] output-normed hidden
  float* head;     // [splits, B, Vh] head projection partials
  __nv_bfloat16* stage;  // [B, 2, Hkv, D] this step's K/V rows (int8 KV cache)
  mutable cudaError_t err = cudaSuccess;   // the first refused launch it saw (see run_layer)
};

inline size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// The grid of a GEMV (one lane) x [K] @ W [K, N] of plan code `code`
// (plan_code of a WeightMode, kPlanHead or kPlanHeadF32): gx column blocks
// of gemv_cols(code), ks K splits of `rows` weight rows (packed rows for
// w4bf16), one block each (ops/fused_talker_step.gemv_plan mirrors it).
struct GemvPlan {
  int gx, ks, rows;
};

inline GemvPlan gemv_plan(int code, int K, int N) {
  GemvPlan p;
  p.rows = kGemvTY * gemv_thread_rows(code);
  const int cols = gemv_cols(code), krows = code == kW4BF16 ? K / 2 : K;
  p.gx = (N + cols - 1) / cols;
  p.ks = (krows + p.rows - 1) / p.rows;
  return p;
}

// Split n_tiles K tiles over at most max_splits blocks per column strip;
// returns the number of splits, and the tiles of each in *per.
inline int tile_split(int n_tiles, int max_splits, int* per) {
  const int ks = max_splits < n_tiles ? (max_splits > 0 ? max_splits : 1) : n_tiles;
  *per = (n_tiles + ks - 1) / ks;
  return (n_tiles + *per - 1) / *per;
}

// The tile plan of a batched projection (B >= 2) x [B, K] @ W [K, N] of
// plan code `code` (plan_code of its WeightMode): gx column strips of tn
// columns; the weight rows (packed rows for w4bf16) cut into n_tiles tiles
// of tk, split into ks runs of `per` tiles
// (the last one shorter) of at least kGemmMinTiles tiles where there are
// enough, one block per (strip, run, u4 half): about kI8Blocks (int8) or
// kFBlocks (float) blocks, or fewer. The same for every B
// (ops/fused_talker_step.gemm_plan mirrors it).
struct GemmPlan {
  int tn, tk, gx, n_tiles, per, ks;
};

inline GemmPlan gemm_plan(int code, int K, int N) {
  GemmPlan p;
  p.tn = code == kW8A8 ? kI8TN : kFTN;
  p.tk = code == kW8A8 ? kI8TK : kFTK;
  const int rows = code == kW4BF16 ? K / 2 : K, halves = code == kW4BF16 ? 2 : 1;
  p.gx = (N + p.tn - 1) / p.tn;
  p.n_tiles = (rows + p.tk - 1) / p.tk;
  const int blocks = code == kW8A8 ? kI8Blocks : kFBlocks;
  const int splits = std::min(blocks / (p.gx * halves), p.n_tiles / kGemmMinTiles);
  p.ks = tile_split(p.n_tiles, std::max(1, splits), &p.per);
  return p;
}

// The K splits of a float-mode projection x [B, K] @ W [K, N] (its
// WeightMode): the GEMV's (B = 1) or the GEMM's; the partials are
// [halves, splits, B, N].
inline int float_splits(int B, int mode, int K, int N) {
  const int code = plan_code(mode);
  return B == 1 ? gemv_plan(code, K, N).ks : gemm_plan(code, K, N).ks;
}

inline int proj_mode(int modes, int j) { return (modes >> (2 * j)) & 3; }

// Carve `w` out of base (or only count the bytes when base is null). modes
// packs the four projections' WeightMode, 2 bits each, wqkv first (0: all
// w8a8).
inline size_t carve_work(Work* w, char* base, const Dims& d, int B, int Vh, int modes = 0) {
  const int qkv = (d.Hq + 2 * d.Hkv) * d.D, hd = d.Hq * d.D;
  const int xqn = d.H > hd ? (d.H > d.F ? d.H : d.F) : (hd > d.F ? hd : d.F);
  // the head's splits: the same for bf16 and float32 weights (128 rows a split)
  const int head_splits = B == 1 ? gemv_plan(kPlanHead, d.H, Vh).ks : kHeadSplits;
  const int shapes[4][2] = {{d.H, qkv}, {hd, d.H}, {d.H, 2 * d.F}, {d.F, d.H}};
  size_t part_n = 0;
  for (int j = 0; j < 4; ++j) {
    const int m = proj_mode(modes, j);
    if (m == kW8A8) continue;
    const size_t n = (size_t)(m == kW4BF16 ? 2 : 1) *
                     float_splits(B, m, shapes[j][0], shapes[j][1]) * B * shapes[j][1];
    if (n > part_n) part_n = n;
  }
  size_t off = 0;
  auto take = [&](size_t bytes) { char* p = base ? base + off : nullptr; off += align256(bytes); return p; };
  Work t;
  t.B = B;
  t.ldq = (xqn + 15) & ~15;   // 16-byte rows for the GEMMs' copies
  t.x = (float*)take(sizeof(float) * B * d.H);
  t.xq = (int8_t*)take((size_t)B * t.ldq);
  t.xf = modes != 0 ? (float*)take(sizeof(float) * B * t.ldq) : nullptr;
  t.s = (float*)take(sizeof(float) * 4 * B);
  t.acc_qkv = (int*)take(sizeof(int) * B * qkv);
  t.acc_o = (int*)take(sizeof(int) * B * d.H);
  t.acc_gu = (int*)take(sizeof(int) * B * 2 * d.F);
  t.acc_d = (int*)take(sizeof(int) * B * d.H);
  t.part = part_n ? (double*)take(sizeof(double) * part_n) : nullptr;
  t.q = (float*)take(sizeof(float) * B * hd);
  t.attn = (float*)take(sizeof(float) * B * hd);
  t.hnorm = (float*)take(sizeof(float) * B * d.H);
  t.head = (float*)take(sizeof(float) * (size_t)head_splits * B * Vh);
  t.stage = (__nv_bfloat16*)take(sizeof(__nv_bfloat16) * (size_t)B * 2 * d.Hkv * d.D);
  if (w) *w = t;
  return off;
}

template <template <int> class Launch, typename... Args>
inline void by_lanes(int B, Args... args) {
  if (B <= 8) Launch<1>::go(args...);
  else if (B <= 16) Launch<2>::go(args...);
  else if (B <= 32) Launch<4>::go(args...);
  else if (B <= 64) Launch<8>::go(args...);
  else Launch<16>::go(args...);
}

template <int BPT>
struct GemmHead {
  static void go(dim3 grid, cudaStream_t st, const float* x, int B, const void* W, int head_f32,
                 int K, int N, int per, float* partial) {
    if (head_f32)
      gemm_head_kernel<BPT, float><<<grid, kGemmThreads, 0, st>>>(x, K, B, (const float*)W, K,
                                                                  N, per, partial);
    else
      gemm_head_kernel<BPT, __nv_bfloat16><<<grid, kGemmThreads, 0, st>>>(
          x, K, B, (const __nv_bfloat16*)W, K, N, per, partial);
  }
};

// The batched GEMMs for B lanes (B >= 2): the lane tiles each warp takes
// (WL) from B; the dynamic shared memory granted once per instantiation (a
// refusal shows in the launch's error).
template <int WL>
void launch_i8(const GemmPlan& p, cudaStream_t st, const int8_t* xq, int ldq, int B,
               const int8_t* W, int K, int N, int* acc) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(gemm_i8_mma_kernel<WL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           i8_smem_bytes(kMaxLanes));
  (void)attr;
  gemm_i8_mma_kernel<WL><<<dim3(p.gx, p.ks), kGemmThreads, i8_smem_bytes((B + 7) & ~7), st>>>(
      xq, ldq, B, W, K, N, p.per, acc);
}

inline void gemm_i8(const GemmPlan& p, cudaStream_t st, const int8_t* xq, int ldq, int B,
                    const int8_t* W, int K, int N, int* acc) {
  const int wl = (B + 8 * kI8LW - 1) / (8 * kI8LW);
  if (wl <= 1) launch_i8<1>(p, st, xq, ldq, B, W, K, N, acc);
  else if (wl <= 2) launch_i8<2>(p, st, xq, ldq, B, W, K, N, acc);
  else if (wl <= 4) launch_i8<4>(p, st, xq, ldq, B, W, K, N, acc);
  else launch_i8<8>(p, st, xq, ldq, B, W, K, N, acc);
}

template <int WM, int WL, int ST>
void launch_f64(const GemmPlan& p, cudaStream_t st, const float* x, int ldx, int B,
                const void* W, const float* S, const float* Z, int K, int N, int gs, int G,
                double* partial) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_f64_mma_kernel<WM, WL, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      f_smem_bytes(WM, kMaxLanes, ST));
  (void)attr;
  gemm_f64_mma_kernel<WM, WL, ST><<<dim3(p.gx, p.ks, WM == kW4BF16 ? 2 : 1), kGemmThreads,
                                    f_smem_bytes(WM, (B + 7) & ~7, ST), st>>>(
      x, ldx, B, W, S, Z, K, N, gs, G, p.per, partial);
}

// Lanes per warp from B; four ring stages, three for more than 64 lanes
// (two blocks still fit an SM in bf16 and w4bf16; one in f32, whose tiles
// are twice as large).
template <int WM>
void gemm_f64(const GemmPlan& p, cudaStream_t st, const float* x, int ldx, int B, const void* W,
              const float* S, const float* Z, int K, int N, int gs, int G, double* partial) {
  const int wl = (B + 8 * kFLW - 1) / (8 * kFLW);
  if (wl <= 1) launch_f64<WM, 1, 4>(p, st, x, ldx, B, W, S, Z, K, N, gs, G, partial);
  else if (wl <= 2) launch_f64<WM, 2, 4>(p, st, x, ldx, B, W, S, Z, K, N, gs, G, partial);
  else launch_f64<WM, 4, 3>(p, st, x, ldx, B, W, S, Z, K, N, gs, G, partial);
}

// y[b, :] = x[b, :] @ W for the w.B lanes, in p's mode: w8a8 reads w.xq and
// adds into acc (cleared by the kernel before) with activation scales
// s_act; the float modes read w.xf and write split partials into w.part.
// One lane: the GEMV, launched with programmatic dependent launch (its
// weight stream starts while the kernel before it runs); a refused launch
// is kept in w.err. Returns how the consumer reads y.
inline ProjOut project(const Work& w, const Proj& p, int K, int N, int* acc,
                       const float* s_act, cudaStream_t st) {
  ProjOut o{};
  o.B = w.B;
  o.N = N;
  cudaError_t e = cudaSuccess;
  if (p.mode == kW8A8) {
    const int8_t* W = (const int8_t*)p.w;
    if (w.B == 1) {
      const GemvPlan g = gemv_plan(kW8A8, K, N);
      e = launch_ex(gemv_i8_kernel, dim3(g.gx, g.ks), dim3(kGemvThreads), 0, st, 0, true,
                    (const int8_t*)w.xq, W, K, N, acc);
    } else {
      gemm_i8(gemm_plan(kW8A8, K, N), st, w.xq, w.ldq, w.B, W, K, N, acc);
    }
    o.acc = acc;
    o.s_act = s_act;
    o.ws = p.s;
  } else {
    o.part = w.part;
    o.splits = float_splits(w.B, p.mode, K, N);
    o.halves = p.mode == kW4BF16 ? 2 : 1;
    if (w.B > 1) {
      const GemmPlan g = gemm_plan(plan_code(p.mode), K, N);
      if (p.mode == kBF16)
        gemm_f64<kBF16>(g, st, w.xf, w.ldq, w.B, p.w, nullptr, nullptr, K, N, 1, 0, w.part);
      else if (p.mode == kF32)
        gemm_f64<kF32>(g, st, w.xf, w.ldq, w.B, p.w, nullptr, nullptr, K, N, 1, 0, w.part);
      else
        gemm_f64<kW4BF16>(g, st, w.xf, w.ldq, w.B, p.w, p.s, p.z, K, N, K / p.G, p.G, w.part);
    } else {
      const GemvPlan g = gemv_plan(plan_code(p.mode), K, N);
      if (p.mode == kBF16)
        e = launch_ex(gemv_float_kernel<__nv_bfloat16, double>, dim3(g.gx, g.ks),
                      dim3(kGemvThreads), 0, st, 0, true, (const float*)w.xf,
                      (const __nv_bfloat16*)p.w, K, N, w.part);
      else if (p.mode == kF32)
        e = launch_ex(gemv_float_kernel<float, double>, dim3(g.gx, g.ks), dim3(kGemvThreads), 0,
                      st, 0, true, (const float*)w.xf, (const float*)p.w, K, N, w.part);
      else
        e = launch_ex(gemv_w4_kernel, dim3(g.gx, g.ks), dim3(kGemvThreads), 0, st, 0, true,
                      (const float*)w.xf, (const int8_t*)p.w, p.s, p.z, K / 2, N, K / p.G, p.G,
                      w.part);
    }
  }
  if (e != cudaSuccess && w.err == cudaSuccess) w.err = e;
  return o;
}

// The w.B lanes' x [B, K] float32 @ W [K, N] (the codec head: bf16, or
// float32 when head_f32) into float32 split partials w.head [splits, B, N];
// returns the number of splits. One lane: the GEMV, launched as project
// launches it.
inline int project_head(const Work& w, const float* x, const void* W, int head_f32, int K,
                        int N, cudaStream_t st) {
  if (w.B == 1) {
    const GemvPlan g = gemv_plan(head_f32 ? kPlanHeadF32 : kPlanHead, K, N);
    const cudaError_t e =
        head_f32 ? launch_ex(gemv_float_kernel<float, float>, dim3(g.gx, g.ks),
                             dim3(kGemvThreads), 0, st, 0, true, x, (const float*)W, K, N, w.head)
                 : launch_ex(gemv_float_kernel<__nv_bfloat16, float>, dim3(g.gx, g.ks),
                             dim3(kGemvThreads), 0, st, 0, true, x, (const __nv_bfloat16*)W, K,
                             N, w.head);
    if (e != cudaSuccess && w.err == cudaSuccess) w.err = e;
    return g.ks;
  }
  const int gx = (N + kGemmTN - 1) / kGemmTN;
  int per;
  int max_splits = (kSplitTarget + gx - 1) / gx;
  if (max_splits > kHeadSplits) max_splits = kHeadSplits;
  const int ks = tile_split((K + kGemmTKf - 1) / kGemmTKf, max_splits, &per);
  by_lanes<GemmHead>(w.B, dim3(gx, ks), st, x, w.B, W, head_f32, K, N, per, w.head);
  return ks;
}

// The four projections and norms of one stacked decoder (leading axis L).
struct StackWeights {
  Proj qkv, o, gu, d;
  const float *attn_n, *q_n, *k_n, *ffn_n;
};

// Layer l of a stacked [L, K, N] projection.
inline Proj layer_proj(const Proj& p, int l, int K, int N) {
  Proj o = p;
  if (p.mode == kW8A8) {
    o.w = (const int8_t*)p.w + (size_t)l * K * N;
    o.s = p.s + (size_t)l * N;
  } else if (p.mode == kBF16) {
    o.w = (const __nv_bfloat16*)p.w + (size_t)l * K * N;
  } else if (p.mode == kF32) {
    o.w = (const float*)p.w + (size_t)l * K * N;
  } else {
    o.w = (const int8_t*)p.w + (size_t)l * (K / 2) * N;
    o.s = p.s + (size_t)l * p.G * N;
    o.z = p.z + (size_t)l * p.G * N;
  }
  return o;
}

// One layer's weights and cache view (T = int8_t: the int8 KV cache, with
// its row scales Ks and Vs; see q8_scale_base).
template <typename T>
struct LayerView {
  Proj qkv, o, gu, d;
  const float *attn_n, *q_n, *k_n, *ffn_n;
  T* K;  // lane 0, head 0, row 0 of this layer's keys; head h at + h * head_stride
  T* V;  // lane b at + b * lane_stride, row t at + t * row_stride
  long head_stride;
  long lane_stride;
  long row_stride;
  float* Ks = nullptr;
  float* Vs = nullptr;
  // the lane-major cache's tensor map (talker_step_batched.cu) and this
  // layer's K plane in it (V: plane + 1); null for a batch-major cache
  const CUtensorMap* kv_map = nullptr;
  int plane = 0;
};

template <typename T>
LayerView<T> layer_view(const StackWeights& s, const Dims& d, int l, T* K, T* V,
                        long head_stride, long lane_stride, long row_stride = 0) {
  const int qkv = (d.Hq + 2 * d.Hkv) * d.D, hd = d.Hq * d.D;
  LayerView<T> lv;
  lv.qkv = layer_proj(s.qkv, l, d.H, qkv);
  lv.o = layer_proj(s.o, l, hd, d.H);
  lv.gu = layer_proj(s.gu, l, d.H, 2 * d.F);
  lv.d = layer_proj(s.d, l, d.F, d.H);
  lv.attn_n = s.attn_n + (size_t)l * d.H;
  lv.q_n = s.q_n + (size_t)l * d.D;
  lv.k_n = s.k_n + (size_t)l * d.D;
  lv.ffn_n = s.ffn_n + (size_t)l * d.H;
  lv.K = K;
  lv.V = V;
  lv.head_stride = head_stride;
  lv.lane_stride = lane_stride;
  lv.row_stride = row_stride > 0 ? row_stride : d.D;
  return lv;
}

// How a row kernel hands its row to projection p (index j: its activation
// scale slot; acc/n: its int32 accumulator, cleared for w8a8).
inline Emit emit_for(const Work& w, const Proj& p, int j, int* acc, int n) {
  Emit e{};
  e.ldq = w.ldq;
  if (p.mode == kW8A8) {
    e.xq = w.xq;
    e.s_out = w.s + j * w.B;
    e.zero = acc;
    e.zero_n = n;
  } else {
    e.xf = w.xf;
    e.round = p.mode != kF32;
  }
  return e;
}

inline int attn_cap(int rows, int clusters) { return std::max(1, (rows + clusters - 1) / clusters); }

// The cluster size of the attention kernel for B lanes, Hkv KV heads and at
// most `rows` rows a lane: about two blocks on each SM (kSplitTarget
// blocks), each of at least kAttMinRows rows, at most kAttMaxCluster; more
// where one block's slice of scores would not fit its shared memory.
inline int attn_clusters(int B, int Hkv, int G, int rows, int row_bytes) {
  int s = std::min(kSplitTarget / (B * Hkv), (rows + kAttMinRows - 1) / kAttMinRows);
  s = std::max(1, std::min(s, kAttMaxCluster));
  while (s < kAttMaxCluster && AttLayout(G, attn_cap(rows, s), row_bytes).total > kAttMaxSmem) ++s;
  return s;
}

template <typename T, int G, bool Lane>
cudaError_t attn_launch(const Dims& d, const LayerView<T>& lv, const Work& w, int n_end,
                        int floor_row, int round_q, int round_p, const int* start,
                        cudaStream_t st) {
  constexpr int row = kAttD * (int)sizeof(T);
  static const CUtensorMap no_map{};
  const int rows = n_end - floor_row, S = attn_clusters(w.B, d.Hkv, G, rows, row);
  const int cap = attn_cap(rows, S);
  return launch_cluster_ex(attn_layer_kernel<T, G, Lane>, dim3(S, d.Hkv, w.B), kAttThreads,
                           AttLayout(G, cap, row).total, st, w.B == 1, (const float*)w.q,
                           (const T*)lv.K, (const T*)lv.V, lv.head_stride, lv.lane_stride,
                           n_end, floor_row, cap, 1.0f / sqrtf((float)d.D),
                           round_q, round_p, start,
                           (const float*)lv.Ks, (const float*)lv.Vs,
                           (const __nv_bfloat16*)w.stage, w.attn, Lane ? *lv.kv_map : no_map,
                           lv.plane);
}

// One attention launch for the w.B lanes into w.attn: rows [floor_row,
// n_end) of each lane's cache (the kernel takes the lane's start above
// floor_row); int8: the cached rows [0, n_end) and the staged current row.
// Lane: lv is a layer of the lane-major cache (its kv_map set).
template <typename T, bool Lane>
cudaError_t attention(const Dims& d, const LayerView<T>& lv, const Work& w, int n_end,
                      int floor_row, int round_q, int round_p, const int* start,
                      cudaStream_t st) {
  switch (d.Hq / d.Hkv) {
    case 1:
      return attn_launch<T, 1, Lane>(d, lv, w, n_end, floor_row, round_q, round_p, start, st);
    case 2:
      return attn_launch<T, 2, Lane>(d, lv, w, n_end, floor_row, round_q, round_p, start, st);
    case 4:
      return attn_launch<T, 4, Lane>(d, lv, w, n_end, floor_row, round_q, round_p, start, st);
    default:
      return attn_launch<T, 8, Lane>(d, lv, w, n_end, floor_row, round_q, round_p, start, st);
  }
}

// Launch a row kernel of the w.B lanes' chain on `grid` x `block`: for one
// lane (K1) with programmatic dependent launch unless `first` (the chain's
// first kernel, after a copy), for B lanes (K5) as a plain launch; a
// refused launch is kept in w.err.
template <typename... Exp, typename... Act>
void chain_launch(const Work& w, bool first, void (*kernel)(Exp...), dim3 grid, dim3 block,
                  size_t smem, cudaStream_t st, Act&&... args) {
  const cudaError_t e = launch_ex(kernel, grid, block, smem, st, 0, w.B == 1 && !first,
                                  std::forward<Act>(args)...);
  if (e != cudaSuccess && w.err == cudaSuccess) w.err = e;
}

// Launch one layer for the w.B lanes' tokens at position `pos` (their K/V
// rows are written at `pos`, attention covers rows [0, pos], or [start[b],
// pos] with a per-lane start operand, whose lower bound over the lanes is
// start_min). `prev` is the previous layer's down projection (empty for
// the first layer: x already holds the layer input). Returns this layer's
// down projection; a refused launch is kept in w.err. round_q / round_p:
// see the header. T = int8_t runs the int8 KV cache's attention (the
// header; q rounded to bf16 whatever round_q, round_p rounds p * v_scale;
// no start operand). Lane = true: lv is a layer of the lane-major cache
// (its kv_map set; no start operand).
//
// One lane (K1): every kernel but the first of the chain is launched with
// programmatic dependent launch, and every kernel of layer.cuh that it
// launches calls pdl_trigger() on entry and pdl_wait() before its first
// access to a buffer of the chain (common.cuh): a GEMV's blocks become
// resident and stream their weights while the row kernel before them runs,
// and a row kernel is resident when the GEMV before it ends. K5 (B lanes)
// launches the same kernels plainly, where both calls are no-ops.
template <typename T, bool Lane = false>
ProjOut run_layer(const Dims& d, const LayerView<T>& lv, const ProjOut& prev, const Work& w,
                  const float* cosv, const float* sinv, int pos, int round_q, int round_p,
                  cudaStream_t st, const int* start = nullptr, int start_min = 0) {
  constexpr bool q8 = std::is_same<T, int8_t>::value;
  const int qkv = (d.Hq + 2 * d.Hkv) * d.D, hd = d.Hq * d.D, B = w.B;
  const size_t row_smem = sizeof(float) * (size_t)(d.H > d.F ? (d.H > hd ? d.H : hd)
                                                            : (d.F > hd ? d.F : hd));
  const dim3 rows(B), row_threads(kRowThreads);
  chain_launch(w, !proj_present(prev), resid_rms_kernel, rows, row_threads, row_smem, st, w.x,
               prev, lv.attn_n, d.H, d.eps, emit_for(w, lv.qkv, 0, w.acc_qkv, qkv),
               (float*)nullptr);
  const ProjOut oq = project(w, lv.qkv, d.H, qkv, w.acc_qkv, w.s + 0 * B, st);
  const dim3 heads(d.Hq + 2 * d.Hkv, B);
  if constexpr (q8) {   // the new rows go to the staging rows, attended from there
    chain_launch(w, false, qkv_post_kernel<__nv_bfloat16>, heads, dim3(d.D), 0, st, oq, lv.q_n,
                 lv.k_n, cosv, sinv, d.Hq, d.Hkv, d.D, d.eps, w.q, w.stage,
                 w.stage + (size_t)d.Hkv * d.D, (long)d.D, 2L * d.Hkv * d.D);
  } else {
    chain_launch(w, false, qkv_post_kernel<T>, heads, dim3(d.D), 0, st, oq, lv.q_n, lv.k_n,
                 cosv, sinv, d.Hq, d.Hkv, d.D, d.eps, w.q, lv.K + (size_t)pos * lv.row_stride,
                 lv.V + (size_t)pos * lv.row_stride, lv.head_stride, lv.lane_stride);
  }
  const int floor_row = q8 ? 0 : std::min(std::max(start_min, 0), pos);
  const cudaError_t e =
      attention<T, Lane>(d, lv, w, q8 ? pos : pos + 1, floor_row, round_q, round_p, start, st);
  if (e != cudaSuccess && w.err == cudaSuccess) w.err = e;
  if constexpr (q8)
    chain_launch(w, false, kv_row_quant_kernel, dim3(2 * d.Hkv, B), dim3(d.D), 0, st,
                 (const __nv_bfloat16*)w.stage, d.Hkv, d.D, lv.K, lv.V, lv.Ks, lv.Vs,
                 lv.head_stride, lv.lane_stride, pos);
  chain_launch(w, false, attn_emit_kernel, rows, row_threads, row_smem, st, (const float*)w.attn,
               hd, emit_for(w, lv.o, 1, w.acc_o, d.H));
  const ProjOut oo = project(w, lv.o, hd, d.H, w.acc_o, w.s + 1 * B, st);
  chain_launch(w, false, resid_rms_kernel, rows, row_threads, row_smem, st, w.x, oo, lv.ffn_n,
               d.H, d.eps, emit_for(w, lv.gu, 2, w.acc_gu, 2 * d.F), (float*)nullptr);
  const ProjOut og = project(w, lv.gu, d.H, 2 * d.F, w.acc_gu, w.s + 2 * B, st);
  chain_launch(w, false, swiglu_kernel, rows, row_threads, row_smem, st, og, d.F,
               emit_for(w, lv.d, 3, w.acc_d, d.H));
  return project(w, lv.d, d.F, d.H, w.acc_d, w.s + 3 * B, st);
}

// After the last layer: x += its down projection `last`; hnorm =
// RMSNorm(x) * out_norm for each of the w.B lanes (x itself when out_norm
// is null).
inline void final_norm(const Dims& d, const ProjOut& last, const float* out_norm,
                       const Work& w, float* hnorm, cudaStream_t st) {
  chain_launch(w, false, resid_rms_kernel, dim3(w.B), dim3(kRowThreads), sizeof(float) * d.H, st,
               w.x, last, out_norm, d.H, d.eps, Emit{}, hnorm);
}

// Check the shapes the kernels assume; returns a cudaError_t-like code
// (cudaErrorInvalidValue) when they do not hold.
inline int check_dims(const Dims& d, int N_head, int B) {
  const int G = d.Hq / d.Hkv;
  if (d.D != kAttD || G < 1 || d.Hq % d.Hkv != 0 || G > kMaxGroup || (G & (G - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  // the GEMMs and GEMVs copy 16-byte pieces of rows; the head GEMV's take 8
  // bf16 columns (B = 1), the head GEMM's 4
  if (d.H % 16 != 0 || d.F % 16 != 0 || N_head % (B == 1 ? 8 : 4) != 0)
    return (int)cudaErrorInvalidValue;
  if (B < 1 || B > kMaxLanes) return (int)cudaErrorInvalidValue;
  return head_check(N_head);   // head_sample_kernel holds the row in registers
}

// Check a u4 projection's groups: G even, and gs = K / G logical rows
// dividing each half of K, a multiple of kFTK (32): each tile of the GEMM
// (B >= 2) lies in one group, and the GEMV's 64-row blocks in at most two.
inline bool groups_ok(int K, int G) {
  return G >= 2 && G % 2 == 0 && K % G == 0 && (K / 2) % (K / G) == 0 && (K / G) % kFTK == 0;
}

inline int check_groups(const StackWeights& s, const Dims& d) {
  const Proj* ps[4] = {&s.qkv, &s.o, &s.gu, &s.d};
  const int ks[4] = {d.H, d.Hq * d.D, d.H, d.F};
  for (int j = 0; j < 4; ++j)
    if (ps[j]->mode == kW4BF16 && !groups_ok(ks[j], ps[j]->G))
      return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
