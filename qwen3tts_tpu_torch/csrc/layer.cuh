// One Qwen3 decoder layer for a single token, w8a8, as a handful of kernels:
// the building blocks of K1 (talker_step.cu) and K2 (code_predictor.cu).
//
//   resid_rms_quant  x += previous projection; h = RMSNorm(x); int8(h)
//   gemv_w8a8        acc[n] += sum_k xq[k] * W[k, n]          (int32, split-K)
//   qkv_post         q/k RMSNorm + NEOX RoPE; K/V row written into the cache
//   attn_scores      s[h, t] = q_h . k_t * D^-0.5  for t < n_valid
//   attn_softmax     p = softmax(s) rounded to the KV dtype
//   attn_pv          per-chunk partial sums of p @ V
//   merge_quant      sum of the chunk partials; int8(o)
//   gemv_w8a8        o_proj
//   resid_rms_quant  x += o_proj; h = RMSNorm(x); int8(h)
//   gemv_w8a8        gate/up
//   swiglu_quant     a = silu(gate) * up; int8(a)
//   gemv_w8a8        down (added to x by the next layer's first kernel)
//
// Numerics follow the Pallas kernels' w8a8 mode
// (qwen3tts_tpu/ops/pallas_talker_step.py:71 _make_mm_values): activations
// are quantized per token with s = max(amax, 1e-8) * (1/127) and
// round-half-even (rintf), the dots accumulate in int32 — exact and
// independent of order, so the split-K atomics change nothing — and the
// result is acc * (s * w_scale) in float32. Attention casts q and the softmax
// probabilities to the KV dtype, as the Pallas kernel does (:338, :349), and
// reads only positions below n_valid: no masked position is ever multiplied
// by cache memory, stale or not.
#pragma once

#include "common.cuh"
#include "sampler.cuh"

namespace {

constexpr int kRowThreads = 1024;   // one block handles one token's vector
constexpr int kAttnChunk = 64;      // positions per attention block
constexpr int kMaxGroup = 8;        // query heads per KV head
constexpr int kSplitTarget = 264;   // ~2 blocks per SM of an H100

__device__ void quantize_buf(const float* buf, int n, float amax_local, int8_t* xq,
                             float* s_out, float* red) {
  const float am = block_max(amax_local, red);
  const float s = fmaxf(am, 1e-8f) * (1.0f / 127.0f);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    xq[i] = (int8_t)fminf(fmaxf(rintf(buf[i] / s), -127.f), 127.f);
  if (threadIdx.x == 0) s_out[0] = s;
}

// x += acc * (s_in * ws_in) when acc is given; h = x * rsqrt(mean(x^2)+eps)
// * norm. Then h is quantized into (xq, s_out), or, when h_out is given,
// written there in float32. zero[0:zero_n) is cleared for the next GEMV.
__global__ void resid_rms_quant_kernel(float* __restrict__ x, const int* __restrict__ acc,
                                       const float* __restrict__ s_in,
                                       const float* __restrict__ ws_in,
                                       const float* __restrict__ norm, int H, float eps,
                                       int8_t* __restrict__ xq, float* __restrict__ s_out,
                                       float* __restrict__ h_out, int* __restrict__ zero,
                                       int zero_n) {
  extern __shared__ float buf[];
  __shared__ float red[32];
  const float sa = acc != nullptr ? s_in[0] : 0.f;
  float ss = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    float v = x[i];
    if (acc != nullptr) v = v + (float)acc[i] * (sa * ws_in[i]);
    x[i] = v;
    buf[i] = v;
    ss += v * v;
  }
  const float var = block_sum(ss, red) / (float)H;
  const float rs = 1.0f / sqrtf(var + eps);
  float am = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float h = buf[i] * rs * norm[i];
    buf[i] = h;
    am = fmaxf(am, fabsf(h));
    if (h_out != nullptr) h_out[i] = h;
  }
  if (h_out == nullptr) quantize_buf(buf, H, am, xq, s_out, red);
  for (int i = threadIdx.x; i < zero_n; i += blockDim.x) zero[i] = 0;
}

// acc[n] += sum_{k in this block's K range} xq[k] * W[k, n], W int8 [K, N]
// row-major. Block (32, 8): x walks 4-column groups (one 4-byte load per
// thread per row, a warp reads 128 contiguous bytes), y walks rows; grid.y
// splits K so that the narrow projections still fill the card.
__global__ void gemv_w8a8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ W,
                                 int K, int N, int kchunk, int* __restrict__ acc) {
  __shared__ int part[8][32][4];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = (blockIdx.x * 32 + tx) * 4;
  const int kb = blockIdx.y * kchunk, ke = min(K, kb + kchunk);
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  if (n0 < N) {
#pragma unroll 4
    for (int k = kb + ty; k < ke; k += 8) {
      const int xv = xq[k];
      const char4 w = *reinterpret_cast<const char4*>(W + (size_t)k * N + n0);
      a0 += xv * w.x;
      a1 += xv * w.y;
      a2 += xv * w.z;
      a3 += xv * w.w;
    }
  }
  part[ty][tx][0] = a0; part[ty][tx][1] = a1; part[ty][tx][2] = a2; part[ty][tx][3] = a3;
  __syncthreads();
  if (ty == 0 && n0 < N) {
    for (int j = 0; j < 4; ++j) {
      int s = 0;
      for (int y = 0; y < 8; ++y) s += part[y][tx][j];
      atomicAdd(acc + n0 + j, s);
    }
  }
}

// float32 x (rounded to bf16) @ W bf16 [K, N]: per-split partial sums into
// partial[split, N] (summed in a fixed order by the consumer).
__global__ void gemv_bf16_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ W,
                                 int K, int N, int kchunk, float* __restrict__ partial) {
  __shared__ float part[8][32][4];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = (blockIdx.x * 32 + tx) * 4;
  const int kb = blockIdx.y * kchunk, ke = min(K, kb + kchunk);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (n0 < N) {
#pragma unroll 4
    for (int k = kb + ty; k < ke; k += 8) {
      const float xv = bf16_round(x[k]);
      const uint2 raw = *reinterpret_cast<const uint2*>(W + (size_t)k * N + n0);
      const __nv_bfloat162 w01 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 w23 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      a0 += xv * __low2float(w01);
      a1 += xv * __high2float(w01);
      a2 += xv * __low2float(w23);
      a3 += xv * __high2float(w23);
    }
  }
  part[ty][tx][0] = a0; part[ty][tx][1] = a1; part[ty][tx][2] = a2; part[ty][tx][3] = a3;
  __syncthreads();
  if (ty == 0 && n0 < N) {
    for (int j = 0; j < 4; ++j) {
      float s = 0.f;
      for (int y = 0; y < 8; ++y) s += part[y][tx][j];
      partial[(size_t)blockIdx.y * N + n0 + j] = s;
    }
  }
}

// One block per head of the fused QKV output (block = D threads): dequant,
// q/k RMSNorm + NEOX RoPE; q to q_out (float32), k and v rows written into
// the cache at the rows kdst/vdst point to (head h at h * head_stride).
template <typename T>
__global__ void qkv_post_kernel(const int* __restrict__ acc, const float* __restrict__ s_in,
                                const float* __restrict__ ws, const float* __restrict__ qn,
                                const float* __restrict__ kn, const float* __restrict__ cosv,
                                const float* __restrict__ sinv, int Hq, int Hkv, int D,
                                float eps, float* __restrict__ q_out, T* __restrict__ kdst,
                                T* __restrict__ vdst, long head_stride) {
  __shared__ float v[1024];
  __shared__ float red[32];
  const int h = blockIdx.x, d = threadIdx.x, i = h * D + d;
  const float y = (float)acc[i] * (s_in[0] * ws[i]);
  if (h >= Hq + Hkv) {
    vdst[(long)(h - Hq - Hkv) * head_stride + d] = from_f<T>(y);
    return;
  }
  const float var = block_sum(y * y, red) / (float)D;
  const float* w = h < Hq ? qn : kn;
  v[d] = y * (1.0f / sqrtf(var + eps)) * w[d];
  __syncthreads();
  const int half = D / 2, j = d % half;
  const float x1 = v[j], x2 = v[j + half];
  const float o = d < half ? x1 * cosv[j] - x2 * sinv[j] : x1 * sinv[j] + x2 * cosv[j];
  if (h < Hq) q_out[i] = o;
  else kdst[(long)(h - Hq) * head_stride + d] = from_f<T>(o);
}

// scores[hq, t] = (q_hq rounded to T) . K[h, t] * scale, t in this chunk.
// grid (Hkv, chunks); each warp takes one position at a time.
template <typename T>
__global__ void attn_scores_kernel(const float* __restrict__ q, const T* __restrict__ K,
                                   long head_stride, int n_valid, int G, int D, float scale,
                                   float* __restrict__ scores, int ld) {
  extern __shared__ float qs[];
  const int h = blockIdx.x;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    qs[i] = to_f<T>(from_f<T>(q[(size_t)h * G * D + i]));
  __syncthreads();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int t0 = blockIdx.y * kAttnChunk, t1 = min(n_valid, t0 + kAttnChunk);
  for (int t = t0 + wid; t < t1; t += nw) {
    const T* krow = K + (long)h * head_stride + (size_t)t * D;
    float a[kMaxGroup];
    for (int g = 0; g < G; ++g) a[g] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float kv = to_f<T>(krow[d]);
      for (int g = 0; g < G; ++g) a[g] += qs[g * D + d] * kv;
    }
    for (int g = 0; g < G; ++g) {
      float s = a[g];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) scores[(size_t)(h * G + g) * ld + t] = s * scale;
    }
  }
}

// p = softmax(scores[hq, 0:n_valid]) in float32, then rounded to T.
template <typename T>
__global__ void attn_softmax_kernel(float* __restrict__ scores, int ld, int n_valid) {
  __shared__ float red[32];
  float* s = scores + (size_t)blockIdx.x * ld;
  float m = -3.4e38f;
  for (int t = threadIdx.x; t < n_valid; t += blockDim.x) m = fmaxf(m, s[t]);
  m = block_max(m, red);
  float sum = 0.f;
  for (int t = threadIdx.x; t < n_valid; t += blockDim.x) {
    const float e = expf(s[t] - m);
    s[t] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int t = threadIdx.x; t < n_valid; t += blockDim.x) s[t] = to_f<T>(from_f<T>(s[t] / sum));
}

// partial[chunk, hq, d] = sum_{t in chunk, t < n_valid} p[hq, t] * V[h, t, d].
// grid (Hkv, chunks), block G * D threads.
template <typename T>
__global__ void attn_pv_kernel(const float* __restrict__ p, int ld, const T* __restrict__ V,
                               long head_stride, int n_valid, int G, int D, int Hq,
                               float* __restrict__ partial) {
  const int h = blockIdx.x, g = threadIdx.x / D, d = threadIdx.x % D;
  const int hq = h * G + g;
  const int t0 = blockIdx.y * kAttnChunk, t1 = min(n_valid, t0 + kAttnChunk);
  const float* pr = p + (size_t)hq * ld;
  const T* vb = V + (long)h * head_stride + d;
  float o = 0.f;
  for (int t = t0; t < t1; ++t) o += pr[t] * to_f<T>(vb[(size_t)t * D]);
  partial[(size_t)blockIdx.y * Hq * D + (size_t)hq * D + d] = o;
}

// o = sum over chunks of the partials (fixed order); int8(o).
__global__ void merge_quant_kernel(const float* __restrict__ partial, int chunks, int n,
                                   int8_t* __restrict__ xq, float* __restrict__ s_out,
                                   int* __restrict__ zero, int zero_n) {
  extern __shared__ float buf[];
  __shared__ float red[32];
  float am = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float o = 0.f;
    for (int c = 0; c < chunks; ++c) o += partial[(size_t)c * n + i];
    buf[i] = o;
    am = fmaxf(am, fabsf(o));
  }
  quantize_buf(buf, n, am, xq, s_out, red);
  for (int i = threadIdx.x; i < zero_n; i += blockDim.x) zero[i] = 0;
}

// a = silu(gate) * up from the gate/up accumulator [2F]; int8(a).
__global__ void swiglu_quant_kernel(const int* __restrict__ acc, const float* __restrict__ s_in,
                                    const float* __restrict__ ws, int F,
                                    int8_t* __restrict__ xq, float* __restrict__ s_out,
                                    int* __restrict__ zero, int zero_n) {
  extern __shared__ float buf[];
  __shared__ float red[32];
  const float sa = s_in[0];
  float am = 0.f;
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    float g = (float)acc[i] * (sa * ws[i]);
    const float u = (float)acc[F + i] * (sa * ws[F + i]);
    g = g / (1.0f + expf(-g));
    const float a = g * u;
    buf[i] = a;
    am = fmaxf(am, fabsf(a));
  }
  quantize_buf(buf, F, am, xq, s_out, red);
  for (int i = threadIdx.x; i < zero_n; i += blockDim.x) zero[i] = 0;
}

// logits = sum of the head GEMV's split partials (fixed order); optionally
// written to logits_out; optionally sampled (sampler.cuh) into tok_out[idx].
__global__ void head_sample_kernel(const float* __restrict__ partial, int splits, int V,
                                   float* __restrict__ logits_out, int* __restrict__ tok_out,
                                   int tok_idx, int suppress_start, int eos_id,
                                   const int8_t* __restrict__ seen, float penalty, float temp,
                                   float top_p, int top_k, int greedy, int use_top_p,
                                   int seed, int step) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  __shared__ int redi[32];
  float* l = smem;
  float* p = smem + V;
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[(size_t)s * V + i];
    l[i] = v;
    if (logits_out != nullptr) logits_out[i] = v;
  }
  __syncthreads();
  if (tok_out == nullptr) return;
  const int tok = suppress_penalize_sample(l, p, V, suppress_start, eos_id, seen, penalty,
                                           temp, top_p, top_k, greedy != 0,
                                           use_top_p != 0, seed, step, red, redi);
  if (threadIdx.x == 0) tok_out[tok_idx] = tok;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Dims {
  int H, Hq, Hkv, D, F;
  float eps;
};

// Device scratch of one decoder stack, carved from one workspace buffer.
struct Work {
  float* x;        // [H] residual carry
  int8_t* xq;      // [max(H, Hq*D, F)] quantized activation
  float* s;        // [4] activation scales: qkv, o, gate/up, down
  int* acc_qkv;    // [(Hq+2Hkv)*D]
  int* acc_o;      // [H]
  int* acc_gu;     // [2F]
  int* acc_d;      // [H]
  float* q;        // [Hq*D]
  float* scores;   // [Hq, C]
  float* partial;  // [ceil(C/kAttnChunk), Hq*D]
  float* hnorm;    // [H] output-normed hidden
  float* head;     // [kSplitTarget, Vh] head GEMV partials
};

inline size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// Carve `w` out of base (or only count the bytes when base is null).
inline size_t carve_work(Work* w, char* base, const Dims& d, int C, int Vh) {
  const int qkv = (d.Hq + 2 * d.Hkv) * d.D, hd = d.Hq * d.D;
  const int xqn = d.H > hd ? (d.H > d.F ? d.H : d.F) : (hd > d.F ? hd : d.F);
  const int chunks = (C + kAttnChunk - 1) / kAttnChunk;
  size_t off = 0;
  auto take = [&](size_t bytes) { char* p = base ? base + off : nullptr; off += align256(bytes); return p; };
  Work t;
  t.x = (float*)take(sizeof(float) * d.H);
  t.xq = (int8_t*)take(xqn);
  t.s = (float*)take(sizeof(float) * 4);
  t.acc_qkv = (int*)take(sizeof(int) * qkv);
  t.acc_o = (int*)take(sizeof(int) * d.H);
  t.acc_gu = (int*)take(sizeof(int) * 2 * d.F);
  t.acc_d = (int*)take(sizeof(int) * d.H);
  t.q = (float*)take(sizeof(float) * hd);
  t.scores = (float*)take(sizeof(float) * (size_t)d.Hq * C);
  t.partial = (float*)take(sizeof(float) * (size_t)chunks * hd);
  t.hnorm = (float*)take(sizeof(float) * d.H);
  t.head = (float*)take(sizeof(float) * (size_t)kSplitTarget * Vh);
  if (w) *w = t;
  return off;
}

inline int split_for(int K, int gx, int* kchunk) {
  int ks = (kSplitTarget + gx - 1) / gx;
  if (ks > K / 8) ks = K / 8 > 0 ? K / 8 : 1;
  *kchunk = (K + ks - 1) / ks;
  return (K + *kchunk - 1) / *kchunk;
}

inline void gemv_w8a8(const int8_t* xq, const int8_t* W, int K, int N, int* acc,
                      cudaStream_t st) {
  const int gx = (N / 4 + 31) / 32;
  int kchunk;
  const int ks = split_for(K, gx, &kchunk);
  gemv_w8a8_kernel<<<dim3(gx, ks), dim3(32, 8), 0, st>>>(xq, W, K, N, kchunk, acc);
}

// Returns the number of K splits written into `partial`.
inline int gemv_bf16(const float* x, const __nv_bfloat16* W, int K, int N, float* partial,
                     cudaStream_t st) {
  const int gx = (N / 4 + 31) / 32;
  int kchunk;
  const int ks = split_for(K, gx, &kchunk);
  gemv_bf16_kernel<<<dim3(gx, ks), dim3(32, 8), 0, st>>>(x, W, K, N, kchunk, partial);
  return ks;
}

// One layer's weights and cache view.
template <typename T>
struct LayerView {
  const int8_t *wqkv, *wo, *wgu, *wd;
  const float *sqkv, *so, *sgu, *sd;
  const float *attn_n, *q_n, *k_n, *ffn_n;
  T* K;  // head 0, row 0 of this layer's keys; head h at K + h * head_stride
  T* V;
  long head_stride;
};

// Launch one layer for the token at position `pos` (its K/V row is written
// at `pos`, attention covers rows [0, pos]). `prev_sd` is the previous
// layer's down-projection scale row, or null for the first layer (then x
// already holds the layer input).
template <typename T>
void run_layer(const Dims& d, const LayerView<T>& lv, const float* prev_sd, const Work& w,
               const float* cosv, const float* sinv, int pos, int C, cudaStream_t st) {
  const int qkv = (d.Hq + 2 * d.Hkv) * d.D, hd = d.Hq * d.D, G = d.Hq / d.Hkv;
  const int n_valid = pos + 1, chunks = (n_valid + kAttnChunk - 1) / kAttnChunk;
  const size_t row_smem = sizeof(float) * (size_t)(d.H > d.F ? (d.H > hd ? d.H : hd)
                                                            : (d.F > hd ? d.F : hd));
  resid_rms_quant_kernel<<<1, kRowThreads, row_smem, st>>>(
      w.x, prev_sd ? w.acc_d : nullptr, w.s + 3, prev_sd, lv.attn_n, d.H, d.eps, w.xq,
      w.s + 0, nullptr, w.acc_qkv, qkv);
  gemv_w8a8(w.xq, lv.wqkv, d.H, qkv, w.acc_qkv, st);
  qkv_post_kernel<T><<<d.Hq + 2 * d.Hkv, d.D, 0, st>>>(
      w.acc_qkv, w.s + 0, lv.sqkv, lv.q_n, lv.k_n, cosv, sinv, d.Hq, d.Hkv, d.D, d.eps, w.q,
      lv.K + (size_t)pos * d.D, lv.V + (size_t)pos * d.D, lv.head_stride);
  attn_scores_kernel<T><<<dim3(d.Hkv, chunks), 256, sizeof(float) * G * d.D, st>>>(
      w.q, lv.K, lv.head_stride, n_valid, G, d.D, 1.0f / sqrtf((float)d.D), w.scores, C);
  attn_softmax_kernel<T><<<d.Hq, kRowThreads, 0, st>>>(w.scores, C, n_valid);
  attn_pv_kernel<T><<<dim3(d.Hkv, chunks), G * d.D, 0, st>>>(
      w.scores, C, lv.V, lv.head_stride, n_valid, G, d.D, d.Hq, w.partial);
  merge_quant_kernel<<<1, kRowThreads, row_smem, st>>>(w.partial, chunks, hd, w.xq, w.s + 1,
                                                       w.acc_o, d.H);
  gemv_w8a8(w.xq, lv.wo, hd, d.H, w.acc_o, st);
  resid_rms_quant_kernel<<<1, kRowThreads, row_smem, st>>>(
      w.x, w.acc_o, w.s + 1, lv.so, lv.ffn_n, d.H, d.eps, w.xq, w.s + 2, nullptr, w.acc_gu,
      2 * d.F);
  gemv_w8a8(w.xq, lv.wgu, d.H, 2 * d.F, w.acc_gu, st);
  swiglu_quant_kernel<<<1, kRowThreads, row_smem, st>>>(w.acc_gu, w.s + 2, lv.sgu, d.F, w.xq,
                                                        w.s + 3, w.acc_d, d.H);
  gemv_w8a8(w.xq, lv.wd, d.F, d.H, w.acc_d, st);
}

// After the last layer: x += down projection; hnorm = RMSNorm(x) * out_norm.
inline void final_norm(const Dims& d, const float* last_sd, const float* out_norm,
                       const Work& w, float* hnorm, cudaStream_t st) {
  resid_rms_quant_kernel<<<1, kRowThreads, sizeof(float) * d.H, st>>>(
      w.x, w.acc_d, w.s + 3, last_sd, out_norm, d.H, d.eps, nullptr, nullptr, hnorm,
      nullptr, 0);
}

// Check the shapes the kernels assume; returns a cudaError_t-like code
// (cudaErrorInvalidValue) when they do not hold.
inline int check_dims(const Dims& d, int N_head) {
  const int G = d.Hq / d.Hkv;
  if (d.D % 32 != 0 || d.D > 1024 || d.Hq % d.Hkv != 0 || G > kMaxGroup || G * d.D > 1024)
    return (int)cudaErrorInvalidValue;
  if (d.H % 4 != 0 || d.F % 4 != 0 || N_head % 4 != 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
