// Single-query GQA decode attention over one layer of the stacked KV cache:
// out[b, h*G + g] = softmax(q[b, h*G + g] . K[b, h, t] * D^-0.5) @ V[b, h, t]
// over t < n_valid, with float32 scores, probabilities and p.V sums, and
// the sum of the probabilities l divided out at the end (by max(l, 1e-30)).
//
// Replaces qwen3tts_tpu/ops/pallas_attention.py:83 decode_attention_pallas
// and :201 decode_attention_pallas_layered. The two differ on the TPU only in
// how a layer of the cache reaches the kernel (a slice the caller makes, or
// the layer index in the block index map); here the caller passes a pointer
// to the layer inside the stacked [B?, L, 2, Hkv, C, D] cache, a view with no
// copy, so one kernel serves both. The lane dimension is the Pallas call
// under vmap of the batched unfused loop.
//
// What bounds it on the H100: bytes. Each lane and KV head reads n_valid
// K rows and n_valid V rows of D = 128 bf16: 2 * n_valid * Hkv * D * 2 bytes
// per lane and layer, 4.1 MB at n_valid = 1000 (1.2 us at 3.35 TB/s); the
// arithmetic is 4 G D flops per row, far below the float32 rate. The design
// is a split-K flash-decode. The grid is lanes x KV heads x splits of
// [0, n_valid), sized so that ~264 blocks fill the 132 SMs even for one
// lane. A block takes the G query rows of its KV head over its chunk, 32
// rows at a time: each half-warp reads a K row with 16-byte loads (eight
// bf16 a thread) and reduces the G dot products with shuffles; one warp per
// query row updates the running max, rescale factor and denominator (an
// online softmax, as in the Pallas kernel); then 16 column groups x 8 row
// groups read the V rows with 16-byte loads into [G, 8] float32
// accumulators per thread. The block writes its unnormalised partial
// (m, l, acc[G, D]) to a workspace, and a combine kernel rescales the
// partials by exp(m_i - M), sums them in split order and divides. Nothing at
// or past n_valid is read, and there are no atomics: every run gives the
// same bits. The same one-pass structure is the cure PERF.md names for the
// three-pass attention of the fused talker kernels (layer.cuh); it is kept
// self-contained here so that a later change can lift it there.
#include "common.cuh"

namespace {

constexpr int kAttnD = 128;         // head_dim the kernel takes
constexpr int kAttnThreads = 128;   // four warps; thread d owns column d at the end
constexpr int kAttnTile = 32;       // cached rows per step (one per lane of a warp)
constexpr int kAttnRowGroups = 8;   // p.V: 16 column groups x 8 row groups
constexpr int kAttnBlockTarget = 264;

struct AttnSplit { int splits, chunk; };

// Splits of [0, n_valid) into chunks of a multiple of kAttnTile rows.
AttnSplit attn_split(int B, int Hkv, int n_valid) {
  const int want = (kAttnBlockTarget + B * Hkv - 1) / (B * Hkv);
  int chunk = (n_valid + want - 1) / want;
  chunk = ((chunk + kAttnTile - 1) / kAttnTile) * kAttnTile;
  return AttnSplit{(n_valid + chunk - 1) / chunk, chunk};
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Block (split blockIdx.x, KV head blockIdx.y, lane blockIdx.z). kv points
// at the layer's K half of lane 0 ([2, Hkv, C, D] per lane, lane_stride
// elements apart); q and the partials are dense.
template <int G>
__global__ void __launch_bounds__(kAttnThreads)
decode_attn_partial_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ kv, long long lane_stride,
                           int Hkv, int C, int n_valid, int chunk, float scale,
                           float* __restrict__ part_acc, float* __restrict__ part_ml) {
  __shared__ float sp[G][kAttnTile];   // scores, then probabilities
  __shared__ float s_m[G], s_l[G], s_alpha[G];
  __shared__ float sacc[kAttnRowGroups][G][kAttnD];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, hl = lane & 15;
  const int dg = tid & 15, rg = tid >> 4;
  const int t0 = split * chunk, t1 = min(n_valid, t0 + chunk);
  const size_t head = (size_t)C * kAttnD;
  const __nv_bfloat16* K = kv + (size_t)b * lane_stride + (size_t)h * head;
  const __nv_bfloat16* V = K + (size_t)Hkv * head;
  const __nv_bfloat16* qh = q + ((size_t)b * Hkv + h) * G * kAttnD;

  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) load8(qh + (size_t)g * kAttnD + hl * 8, qr[g]);
  if (tid < G) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;

  for (int base = t0; base < t1; base += kAttnTile) {
    const int tn = min(kAttnTile, t1 - base);
    // scores: half-warp (warp, half) takes rows warp*2 + half + 8 i; every
    // lane of a warp joins the shuffles, valid row or not
    for (int r0 = warp * 2; r0 < tn; r0 += 8) {
      const int r = r0 + half;
      float kf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < tn) load8(K + (size_t)(base + r) * kAttnD + hl * 8, kf);
      float d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        d[g] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d[g] = fmaf(qr[g][i], kf[i], d[g]);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) d[g] += __shfl_xor_sync(0xffffffffu, d[g], o);
      }
      if (hl == 0 && r < tn) {
#pragma unroll
        for (int g = 0; g < G; ++g) sp[g][r] = d[g] * scale;
      }
    }
    __syncthreads();
    // online softmax: warp w updates query rows g = w, w + 4, ...
    for (int g = warp; g < G; g += kAttnThreads / 32) {
      const float s = lane < tn ? sp[g][lane] : -3.4e38f;
      float mt = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mt);
      const float p = lane < tn ? expf(s - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      sp[g][lane] = p;
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        s_alpha[g] = a;
        s_l[g] = a * s_l[g] + ps;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
    // p.V: thread (dg, rg) takes columns dg*8.. and rows rg + 8 i
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = s_alpha[g];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= a;
    }
    for (int r = rg; r < tn; r += kAttnRowGroups) {
      float vf[8];
      load8(V + (size_t)(base + r) * kAttnD + dg * 8, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sp[g][r];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
    }
    __syncthreads();
  }
  // the row groups' partials summed in order by the thread of each column
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) sacc[rg][g][dg * 8 + i] = acc[g][i];
  __syncthreads();
  const size_t row = ((size_t)b * Hkv + h) * gridDim.x + split;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < kAttnRowGroups; ++r) o += sacc[r][g][tid];
    part_acc[(row * G + g) * kAttnD + tid] = o;
  }
  if (tid < G) {
    part_ml[(row * G + tid) * 2] = s_m[tid];
    part_ml[(row * G + tid) * 2 + 1] = s_l[tid];
  }
}

// Block (query head blockIdx.x, lane blockIdx.y), thread d: the splits'
// partials rescaled to the common max, summed in split order, divided.
__global__ void decode_attn_combine_kernel(const float* __restrict__ part_acc,
                                           const float* __restrict__ part_ml, int Hkv, int G,
                                           int splits, __nv_bfloat16* __restrict__ out) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int h = hq / G, g = hq % G;
  const size_t row0 = ((size_t)b * Hkv + h) * splits;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, part_ml[((row0 + s) * G + g) * 2]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t r = (row0 + s) * G + g;
    const float w = expf(part_ml[r * 2] - M);
    L += part_ml[r * 2 + 1] * w;
    O += part_acc[r * kAttnD + d] * w;
  }
  out[((size_t)b * Hkv * G + hq) * kAttnD + d] = __float2bfloat16(O / fmaxf(L, 1e-30f));
}

template <int G>
void launch_partial(dim3 grid, const __nv_bfloat16* q, const __nv_bfloat16* kv,
                    long long lane_stride, int Hkv, int C, int n_valid, int chunk, float scale,
                    float* acc, float* ml, cudaStream_t st) {
  decode_attn_partial_kernel<G><<<grid, kAttnThreads, 0, st>>>(q, kv, lane_stride, Hkv, C,
                                                               n_valid, chunk, scale, acc, ml);
}

}  // namespace

// Bytes of the partials (m, l, acc[D]) per lane, query row and split.
extern "C" size_t qtts_decode_attention_ws_bytes(int B, int Hq, int Hkv, int D, int n_valid) {
  return sizeof(float) * (size_t)B * Hq * attn_split(B, Hkv, n_valid).splits * (D + 2);
}

// q [B, Hq, D] bf16; kv: the layer's K half of lane 0 inside the stacked
// cache (V follows at Hkv * C * D elements, lanes lane_stride apart),
// 16-byte aligned; out [B, Hq, D] bf16. D = 128, Hq / Hkv in {1, 2, 4, 8},
// 1 <= n_valid <= C.
extern "C" int qtts_decode_attention(const void* q, const void* kv, long long lane_stride,
                                     int B, int Hq, int Hkv, int C, int D, int n_valid,
                                     float scale, void* out, void* ws, void* stream) {
  const int G = Hkv > 0 && Hq % Hkv == 0 ? Hq / Hkv : 0;
  if (D != kAttnD || B < 1 || n_valid < 1 || n_valid > C || !(G == 1 || G == 2 || G == 4 || G == 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const AttnSplit sp = attn_split(B, Hkv, n_valid);
  float* acc = (float*)ws;
  float* ml = acc + (size_t)B * Hq * sp.splits * D;
  const dim3 grid(sp.splits, Hkv, B);
  const auto* qb = (const __nv_bfloat16*)q;
  const auto* kvb = (const __nv_bfloat16*)kv;
  switch (G) {
    case 1: launch_partial<1>(grid, qb, kvb, lane_stride, Hkv, C, n_valid, sp.chunk, scale, acc, ml, st); break;
    case 2: launch_partial<2>(grid, qb, kvb, lane_stride, Hkv, C, n_valid, sp.chunk, scale, acc, ml, st); break;
    case 4: launch_partial<4>(grid, qb, kvb, lane_stride, Hkv, C, n_valid, sp.chunk, scale, acc, ml, st); break;
    default: launch_partial<8>(grid, qb, kvb, lane_stride, Hkv, C, n_valid, sp.chunk, scale, acc, ml, st); break;
  }
  decode_attn_combine_kernel<<<dim3(Hq, B), kAttnD, 0, st>>>(acc, ml, Hkv, G, sp.splits,
                                                             (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}
