// Single-query GQA decode attention over one layer of the stacked KV cache:
// out[b, h*G + g] = softmax(q[b, h*G + g] . K[b, h, t] * D^-0.5) @ V[b, h, t]
// over t < n_valid, with float32 scores, probabilities and p.V sums, and
// the sum of the probabilities l divided out at the end (by max(l, 1e-30)).
//
// The cache and q are bf16 or float32 (T; the float32 tier's unfused step
// reaches it from C = 1024 on), the output is T; the scores,
// probabilities and sums are float32 in both.
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
// per lane and layer (twice that in float32), 4.1 MB at n_valid = 1000 (1.2
// us at 3.35 TB/s); the
// arithmetic is 4 G D flops per row, far below the float32 rate. The rows
// of one (lane, KV head) are contiguous, so the design streams them through
// a ring of tiles in shared memory: each stage holds 64 K rows and the same
// 64 V rows (32 of each in float32: a stage is 32 KB in both dtypes, so the
// occupancy and the cluster are the same), two bulk copies (TMA without a
// tensor map) that complete on the
// stage's mbarrier, issued by one thread two tiles ahead of the one being
// consumed (64 KB in flight a block, two blocks an SM). A tile is consumed
// from shared memory with one block barrier: each warp owns 8 of its 64
// rows and keeps its own online softmax state (running max, rescale
// factor and denominator, as in the Pallas kernel) and p.V sums; a
// quarter-warp takes a row (its 16-byte reads cover the row's 256 bytes,
// one bank each; q in registers; three shuffles), and each lane
// accumulates p.V for 4 columns in [G, 4] float32 registers. At the end the
// block adds its warps' states in warp order, rescaled to their common max.
// The splits of [0, n_valid) of one (lane, KV head) form a thread block
// cluster, sized so that the grid fills the 132 SMs about twice; each block
// leaves (m, l, acc[G, D]) in its shared memory, and rank 0 reads the
// others' over distributed shared memory, rescales them by exp(m_i - M),
// sums them in rank order and divides: one launch per call, no workspace,
// and every run gives the same bits.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 128;                     // head_dim the kernel takes
constexpr int kThreads = 256;
constexpr int kTile = 64;                   // rows per split unit of the split rule
constexpr int kStages = 3;
constexpr int kStageBytes = 2 * kTile * kD * 2;   // a ring stage: 32 KB
constexpr int kBlockTarget = 264;           // two blocks on each of 132 SMs
constexpr int kMaxSplits = 16;              // a non-portable cluster

struct Split { int splits, per; };

// Splits of [0, n_valid) (a cluster per lane and KV head), at most one per
// tile of rows, each `per` rows but the last.
Split decode_split(int B, int Hkv, int n_valid) {
  int s = kBlockTarget / (B * Hkv);
  s = min(min(s, (n_valid + kTile - 1) / kTile), kMaxSplits);
  s = max(s, 1);
  const int per = (n_valid + s - 1) / s;
  return Split{(n_valid + per - 1) / per, per};
}

size_t decode_smem(int G) {
  return (size_t)kStages * kStageBytes + sizeof(float) * ((size_t)2 * G + G * kD) +
         sizeof(uint64_t) * (kStages + 1);
}

// Sixteen elements of a row as float32: bf16, the 16-byte chunks part and
// part + 8 (elements 8 part.. and 8 (part + 8)..); float32, the chunks part,
// part + 8, + 16, + 24 (elements 4 (part + 8 c)..).
__device__ __forceinline__ void row16(const __nv_bfloat16* p, int part, float* f) {
  bf16x8(*reinterpret_cast<const uint4*>(p + 8 * part), f);
  bf16x8(*reinterpret_cast<const uint4*>(p + 8 * (part + 8)), f + 8);
}
__device__ __forceinline__ void row16(const float* p, int part, float* f) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 u = *reinterpret_cast<const float4*>(p + 4 * (part + 8 * c));
    f[4 * c] = u.x;
    f[4 * c + 1] = u.y;
    f[4 * c + 2] = u.z;
    f[4 * c + 3] = u.w;
  }
}

// Four consecutive elements (columns 4 lane..) of a row as float32.
__device__ __forceinline__ float4 col4(const __nv_bfloat16* p, int lane) {
  const uint2 u = *reinterpret_cast<const uint2*>(p + 4 * lane);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 col4(const float* p, int lane) {
  return *reinterpret_cast<const float4*>(p + 4 * lane);
}

// Block (split = cluster rank, KV head blockIdx.y, lane blockIdx.z). kv
// points at the layer's K half of lane 0 ([2, Hkv, C, D] per lane,
// lane_stride elements apart); q and out are dense [B, Hq, D], all of T
// (bf16 or float). A ring tile holds kRows rows (64 bf16, 32 float32). Warp
// w owns rows 4w..4w+3 (and 4w+32..4w+35 in bf16) of every tile and keeps
// its own online softmax state (m, l) and p.V sums over them; the warps'
// states are combined at the end, then the cluster's.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kv, long long lane_stride,
                   int Hkv, int C, int n_valid, int per, float scale, T* __restrict__ out) {
  constexpr int kRowBytes = kD * (int)sizeof(T);
  constexpr int kRows = kStageBytes / (2 * kRowBytes), J = kRows / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_m = reinterpret_cast<float*>(smem + kStages * kStageBytes);   // [G]
  float* s_l = s_m + G;                                                  // [G]
  float* o_blk = s_l + G;                                                // [G, kD]
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(o_blk + G * kD) + 7) & ~(uintptr_t)7);   // [kStages]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), S = (int)cluster.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lo = rank * per, hi = min(n_valid, lo + per), nr = max(hi - lo, 0);
  const int nt = (nr + kRows - 1) / kRows;
  const T* K = kv + (size_t)b * lane_stride + (size_t)h * C * kD;
  const T* V = K + (size_t)Hkv * C * kD;

  auto load = [&](int i) {   // thread 0: tile i's K rows and V rows into stage i % kStages
    const int r0 = lo + i * kRows;
    const unsigned bytes = min(kRows, hi - r0) * kRowBytes;
    unsigned char* st = smem + (i % kStages) * kStageBytes;
    mbar_expect(bar + i % kStages, 2 * bytes);
    bulk_load(st, K + (size_t)r0 * kD, bytes, bar + i % kStages);
    bulk_load(st + kRows * kRowBytes, V + (size_t)r0 * kD, bytes, bar + i % kStages);
  };
  if (tid == 0) {   // the first tiles are in flight while q is read
    for (int s = 0; s < kStages; ++s) mbar_init(bar + s);
    mbar_init_fence();
    for (int i = 0; i < kStages - 1 && i < nt; ++i) load(i);
  }

  // scores: a quarter-warp per row (lane bits 3-4 pick it), its 8 lanes the
  // 16-byte column chunks of row16 (bits 0-2: `part`)
  const int part = lane & 7, quarter = lane >> 3;
  float qr[G][16];
  const T* qh = q + ((size_t)b * Hkv + h) * G * kD;
#pragma unroll
  for (int g = 0; g < G; ++g) row16(qh + g * kD, part, qr[g]);
  // the warp's softmax state, and p.V for columns 4 lane.. in each lane
  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;
  }
  __syncthreads();   // the barriers are set
  for (int i = 0; i < nt; ++i) {
    mbar_wait(bar + i % kStages, (i / kStages) & 1);
    __syncthreads();   // tile i landed; stage (i - 1) % kStages is free
    if (tid == 0 && i + kStages - 1 < nt) load(i + kStages - 1);
    const unsigned char* Kt = smem + (i % kStages) * kStageBytes;
    const unsigned char* Vt = Kt + kRows * kRowBytes;
    const int rows = min(kRows, nr - i * kRows);
    float s[J][G];   // this lane's rows: 4 warp + quarter (+ 32)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int r = warp * 4 + quarter + 32 * j;
      float kf[16];
      row16(reinterpret_cast<const T*>(Kt + r * kRowBytes), part, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        s[j][g] = r < rows ? d * scale : -3.4e38f;
      }
    }
    // online softmax over the warp's 8 rows of the tile
    float p[J][G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = s[0][g];
#pragma unroll
      for (int j = 1; j < J; ++j) mt = fmaxf(mt, s[j][g]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
      const float m_new = fmaxf(m[g], mt), alpha = expf(m[g] - m_new);
#pragma unroll
      for (int j = 0; j < J; ++j)
        p[j][g] = warp * 4 + quarter + 32 * j < rows ? expf(s[j][g] - m_new) : 0.f;
      float ps = p[0][g];
#pragma unroll
      for (int j = 1; j < J; ++j) ps += p[j][g];
      ps += __shfl_xor_sync(0xffffffffu, ps, 8);
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
      l[g] = alpha * l[g] + ps;
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int r = warp * 4 + qq + 32 * j;
        if (r >= rows) continue;   // the same for every lane of the warp
        const float4 v = col4(reinterpret_cast<const T*>(Vt + r * kRowBytes), lane);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pr = __shfl_sync(0xffffffffu, p[j][g], qq * 8);
          acc[g][0] = fmaf(pr, v.x, acc[g][0]);
          acc[g][1] = fmaf(pr, v.y, acc[g][1]);
          acc[g][2] = fmaf(pr, v.z, acc[g][2]);
          acc[g][3] = fmaf(pr, v.w, acc[g][3]);
        }
      }
  }
  // the warps' states rescaled to the block's max and added in warp order
  __syncthreads();   // the ring's last readers are done
  float* wacc = reinterpret_cast<float*>(smem);   // [8, G, kD]
  float* wml = wacc + 8 * G * kD;                  // [8, G, 2]
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < 4; ++c) wacc[(warp * G + g) * kD + lane * 4 + c] = acc[g][c];
    if (lane == 0) {
      wml[(warp * G + g) * 2] = m[g];
      wml[(warp * G + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * kD; i += kThreads) {
    const int g = i / kD;
    float M = kNegInf;
    for (int w = 0; w < 8; ++w) M = fmaxf(M, wml[(w * G + g) * 2]);
    float L = 0.f, O = 0.f;
    for (int w = 0; w < 8; ++w) {
      const float f = expf(wml[(w * G + g) * 2] - M);
      L += wml[(w * G + g) * 2 + 1] * f;
      O += wacc[(w * G + g) * kD + i % kD] * f;
    }
    o_blk[i] = O;
    if (i % kD == 0) {
      s_m[g] = M;
      s_l[g] = L;
    }
  }
  cluster.sync();
  // rank 0: the splits rescaled to the common max, summed in rank order
  if (rank == 0) {
    for (int i = tid; i < G * kD; i += kThreads) {
      const int g = i / kD;
      float M = kNegInf;
      for (int r = 0; r < S; ++r) M = fmaxf(M, cluster.map_shared_rank(s_m, r)[g]);
      float L = 0.f, O = 0.f;
      for (int r = 0; r < S; ++r) {
        const float w = expf(cluster.map_shared_rank(s_m, r)[g] - M);
        L += cluster.map_shared_rank(s_l, r)[g] * w;
        O += cluster.map_shared_rank(o_blk, r)[i] * w;
      }
      out[((size_t)b * Hkv + h) * G * kD + i] = from_f<T>(O / fmaxf(L, 1e-30f));
    }
  }
  cluster.sync();    // the other blocks' shared memory stays until rank 0 has read it
}

template <typename T, int G>
cudaError_t launch(const Split& sp, int B, const void* q, const void* kv, long long lane_stride,
                   int Hkv, int C, int n_valid, float scale, void* out, cudaStream_t st) {
  return launch_cluster(decode_attn_kernel<T, G>, dim3(sp.splits, Hkv, B), kThreads,
                        decode_smem(G), st, (const T*)q, (const T*)kv, lane_stride, Hkv, C,
                        n_valid, sp.per, scale, (T*)out);
}

template <typename T>
cudaError_t launch_g(int G, const Split& sp, int B, const void* q, const void* kv,
                     long long lane_stride, int Hkv, int C, int n_valid, float scale, void* out,
                     cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, 1>(sp, B, q, kv, lane_stride, Hkv, C, n_valid, scale, out, st);
    case 2: return launch<T, 2>(sp, B, q, kv, lane_stride, Hkv, C, n_valid, scale, out, st);
    case 4: return launch<T, 4>(sp, B, q, kv, lane_stride, Hkv, C, n_valid, scale, out, st);
    default: return launch<T, 8>(sp, B, q, kv, lane_stride, Hkv, C, n_valid, scale, out, st);
  }
}

}  // namespace

// The splits (cluster size) one call uses; for the tests of the split rule.
extern "C" int qtts_decode_attention_splits(int B, int Hkv, int n_valid) {
  return decode_split(B, Hkv, n_valid).splits;
}

// q [B, Hq, D]; kv: the layer's K half of lane 0 inside the stacked cache
// (V follows at Hkv * C * D elements, lanes lane_stride apart), 16-byte
// aligned; out [B, Hq, D]; all bf16, or all float32 when f32. D = 128, Hq /
// Hkv in {1, 2, 4, 8}, 1 <= n_valid <= C. One launch; returns its
// cudaError_t.
extern "C" int qtts_decode_attention(const void* q, const void* kv, long long lane_stride,
                                     int B, int Hq, int Hkv, int C, int D, int n_valid,
                                     float scale, int f32, void* out, void* stream) {
  const int G = Hkv > 0 && Hq % Hkv == 0 ? Hq / Hkv : 0;
  if (D != kD || B < 1 || n_valid < 1 || n_valid > C || !(G == 1 || G == 2 || G == 4 || G == 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Split sp = decode_split(B, Hkv, n_valid);
  return f32 ? (int)launch_g<float>(G, sp, B, q, kv, lane_stride, Hkv, C, n_valid, scale, out,
                                    st)
             : (int)launch_g<__nv_bfloat16>(G, sp, B, q, kv, lane_stride, Hkv, C, n_valid,
                                            scale, out, st);
}
