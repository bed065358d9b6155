// The code predictor's 16 passes for B lanes as ONE persistent cooperative
// kernel, shared by K2 (code_predictor.cu, one lane, float32 KV scratch)
// and K6 (code_predictor_batched.cu, B <= 64 lanes, KV scratch in the
// embedding dtype). The heads and the embedding tables are bf16 or float32
// (emb_f32: the float32 tier's int8 blocks run here too, as the Pallas
// kernel reads them whatever the compute dtype); the normed hidden the
// head reads is kept in that dtype.
//
// Pass 0 runs each lane's talker hidden through the L layers (conditioning
// only); pass p = 1..S feeds the lane's cb0 embedding (p = 1) or
// embds[p-2][code_{p-2}] (p >= 2), then samples code p-1 from heads[p-1]
// at sampler step p with the lane's seed. rest_sum[b] = sum_s
// embds[s][code_s] (added in order of s), the next talker step's embedding
// term. The codes never leave the device between passes.
//
// One co-resident grid of kCpThreads-thread blocks runs every phase; the
// phases are separated by cooperative_groups grid barriers, and inside a
// phase the work items go to blocks by a grid-stride loop:
//   lanes             the row phases (residual + RMSNorm + int8
//                     quantization, SwiGLU, final norm, sampling); lane b
//                     always lands on block b % gridDim.x, so a lane's
//                     residual x, codes and rest_sum are only ever touched
//                     by one block;
//   (lane, KV heads)  attention: the G query heads and the K/V head of 2
//                     KV heads (4 when there are more items than blocks):
//                     q/k norm, RoPE, the K/V row into the scratch, the <=
//                     CTX rows staged in shared memory, scores, softmax and
//                     p @ V. The lane's last item to finish (a counter per
//                     lane, after a __threadfence) quantizes the lane's
//                     whole o, whose scale needs every head: no barrier of
//                     its own;
//   (strip, K split)  the GEMM phases: a 128-column strip times a run of
//                     weight tiles, streamed through shared memory with
//                     16-byte cp.async copies, double-buffered (the next
//                     tile of the block, even of its next item, is in
//                     flight while the current one is multiplied). Each item
//                     stores its int32 sums as one K split's partial; the
//                     consumer adds the splits with 16-byte loads, 8 in
//                     flight. (The multi-launch design's int32 atomics cost
//                     ~15 us per phase at B = 64 in this kernel.)
// Per layer and pass: row, QKV GEMM, attention, O GEMM, row, gate/up GEMM,
// SwiGLU, down GEMM: 8 barriers. Per pass p >= 1 two more (final norm, head
// GEMM); sampling lane b and the next pass's first row phase of lane b run
// in one phase on the same block. cp_barriers() counts them: 670 at the
// 0.6B code predictor (L = 5, S = 15), against ~1,020 launches of the
// multi-launch design it replaces. One plan serves every B: at one lane,
// recomputing the lane's rows inside every GEMM block (431 barriers) saved
// 2% of K2's device time on the H100 and nothing measurable end to end,
// and it needs a second partial buffer, since each block then gathers one
// projection's partials in the phase that stores the next one's.
//
// Arithmetic: the w8a8 mode of layer.cuh, unchanged. Activations are
// quantized per lane (quantize_buf), products are __dp4a into int32 (exact,
// so the K splits and the tiling change no bit), a projection is read as
// acc * (s_act * w_scale) in float32, and every float sum that feeds a
// rounding (RMSNorm variances, q.k, the softmax sum, p @ V) runs in float64
// and is rounded once. The head sums its exact bf16 x bf16 (or float32 x
// float32) products in float64 per K split; the splits are added in order
// in float64 and rounded once to the float32 logit, so a logit does not
// depend on the grid. Attention rounds neither q nor p (the Pallas code predictors). B =
// 1 takes a GEMV form of the same tiles (the 8 warps split the tile's K
// rows; BPT = 0); B > 1 the GEMM form (each
// thread 4 columns x BPT lanes, __dp4a over the words byte_transpose packs).
//
// Data written by one block and read by another within the call (partials,
// quantized activations, attention output, normed hidden, the KV rows) is
// read through L2 (__ldcg, cp.async.cg): the grid barrier (or the lane's
// counter) orders the accesses, and L2 is the level every SM sees.
//
// The KV scratch [2, L, B, Hkv, CTX, D] (K then V) comes from the caller
// uninitialised; attention reads only rows at or below the current
// position, all written earlier in the same call.
#pragma once

#include <cooperative_groups.h>

#include "layer.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCpThreads = 256;        // 8 warps: 32 column groups x 8 lane groups
constexpr int kCpTN = 128;             // output columns per GEMM item
constexpr int kCpTK8 = 128;            // int8 weight rows per tile (16 KB)
constexpr int kCpTKh = 64;             // bf16 head rows per tile (16 KB; 32 float32 rows)
constexpr int kCpMaxLanes = 64;        // lanes of one call (the Pallas VMEM budget)
constexpr int kCpMaxCtx = 32;          // positions a lane's attention stages
constexpr int kCpWStage = 16384;       // bytes of one weight tile
constexpr int kCpXStage = kCpMaxLanes * 128;   // bytes of one activation tile
constexpr int kCpRedOff = 2 * (kCpWStage + kCpXStage);   // GEMV reduction scratch
constexpr int kCpRedBytes = 8 * 32 * 4 * (int)sizeof(double);
constexpr int kCpXdOff = kCpRedOff + kCpRedBytes;         // the head's float64 activations
constexpr int kCpXdBytes = kCpMaxLanes * kCpTKh * (int)sizeof(double);
constexpr int kCpBarriersPerLayer = 8;
constexpr int kCpSampleEPT = kMaxCodeVocab / kCpThreads;   // the sampler's row in registers
static_assert(kCpThreads == kCodeThreads, "sampler.cuh's code site is this block");

struct CpParams {
  int B, L, H, Hq, Hkv, D, F, V, CTX, S;
  float eps;
  const float* xinit;            // [2, B, H]
  const float* cos_tab;          // [CTX, D/2]
  const float* sin_tab;
  const float *attn_n, *q_n, *k_n, *ffn_n, *out_norm;
  const int8_t *wqkv, *wo, *wgu, *wd;        // [L, K, N] int8
  const float *sqkv, *so, *sgu, *sd;         // [L, N] weight scales
  const void* heads;             // [S, H, V] bf16, or float32 when emb_f32
  const void* embds;             // [S, V, H] bf16, or float32 when emb_f32
  int emb_f32;
  float temp, top_p;
  int top_k, greedy, use_top_p, seed;
  const int* seeds;              // [B] or null (then seed)
  const float* temps;            // [B] or null (then temp)
  const float* topps;            // [B] or null (then top_p)
  int* codes;                    // [B, S]
  float* rest_sum;               // [B, H], zeroed by the kernel
  void* kv;                      // [2, L, B, Hkv, CTX, D] of T
  // workspace
  float* x;                      // [2, B, H] residual, double-buffered
  int8_t* xq;                    // [B, ldq] quantized activation
  int ldq;
  float* s_act;                  // [4, B] activation scales: qkv, o, gate/up, down
  int* part;                     // [splits, B, N] int32 partials of the current projection
  float* o;                      // [B, Hq * D] attention output
  int* done;                     // [B] attention items finished per lane
  void* hn;                      // [B, H] output-normed hidden in the heads' dtype
  double* head_part;             // [head splits, B, V]
  int splits[5];                 // K splits of qkv, o, gate/up, down, head
};

// Grid barriers of one call (the kernel's phase plan; see the header).
inline int cp_barriers(int L, int S) { return (S + 1) * L * kCpBarriersPerLayer + 2 * S; }

// Head rows of one 16 KB weight tile: 64 bf16 rows of 128 columns, or 32
// float32 rows.
__host__ __device__ __forceinline__ int cp_head_rows(int emb_f32) {
  return emb_f32 ? kCpTKh / 2 : kCpTKh;
}

template <typename T> __device__ __forceinline__ float ld_kv(const T* p);
template <> __device__ __forceinline__ float ld_kv<float>(const float* p) { return __ldcg(p); }
template <> __device__ __forceinline__ float ld_kv<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}

// The int32 sum over `splits` K splits of 4 columns (int4 group q) of one
// lane's partials (base: lane row, stride: one split, in int4), the
// splits' 16-byte loads issued 8 at a time.
__device__ __forceinline__ int4 cp_split_sum(const int4* base, size_t stride, int splits,
                                             int q) {
  int4 a = make_int4(0, 0, 0, 0);
  for (int s = 0; s < splits; s += 8) {
    int4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = s + j < splits ? __ldcg(base + (s + j) * stride + q) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < 8; ++j) { a.x += v[j].x; a.y += v[j].y; a.z += v[j].z; a.w += v[j].w; }
  }
  return a;
}

// acc * (s_act * ws[c]) in float32 for 4 columns (ws their 4 weight
// scales): layer.cuh's proj_value of an int32 accumulator.
__device__ __forceinline__ void cp_scale4(int4 a, float s_act, float4 ws, float* out) {
  out[0] = __fmul_rn((float)a.x, __fmul_rn(s_act, ws.x));
  out[1] = __fmul_rn((float)a.y, __fmul_rn(s_act, ws.y));
  out[2] = __fmul_rn((float)a.z, __fmul_rn(s_act, ws.z));
  out[3] = __fmul_rn((float)a.w, __fmul_rn(s_act, ws.w));
}

// Q groups of 4 columns per thread at a time, the splits' loads 16 / Q at
// a time: 16 loads in flight. The weight scales are loaded first.
template <int Q>
__device__ __forceinline__ void cp_gather_q(const int4* base, size_t stride, int splits,
                                            int n4, float s_act, const float* ws, float* out) {
  constexpr int SB = 16 / Q;
  const int bd = blockDim.x;
  for (int q0 = threadIdx.x; q0 < n4; q0 += Q * bd) {
    float4 w[Q];
    int4 a[Q];
#pragma unroll
    for (int g = 0; g < Q; ++g) {
      const int q = q0 + g * bd;
      w[g] = q < n4 ? *reinterpret_cast<const float4*>(ws + 4 * q)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      a[g] = make_int4(0, 0, 0, 0);
    }
    for (int s = 0; s < splits; s += SB) {
      int4 v[Q][SB];
#pragma unroll
      for (int g = 0; g < Q; ++g)
#pragma unroll
        for (int j = 0; j < SB; ++j)
          v[g][j] = q0 + g * bd < n4 && s + j < splits
                        ? __ldcg(base + (s + j) * stride + q0 + g * bd)
                        : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int g = 0; g < Q; ++g)
#pragma unroll
        for (int j = 0; j < SB; ++j) {
          a[g].x += v[g][j].x; a[g].y += v[g][j].y; a[g].z += v[g][j].z; a[g].w += v[g][j].w;
        }
    }
#pragma unroll
    for (int g = 0; g < Q; ++g) {
      const int q = q0 + g * bd;
      if (q < n4) cp_scale4(a[g], s_act, w[g], out + 4 * q);
    }
  }
}

// Columns [0, n) of lane b of w8a8 projection `proj` [B, N] (its int32
// partials in P.part, P.splits[proj] of them), into out[0, n): the splits
// summed (exact), then scaled (cp_scale4). n a multiple of 4.
__device__ void cp_gather(const CpParams& P, int proj, int N, int b, float s_act,
                          const float* ws, int n, float* out) {
  const size_t stride = (size_t)P.B * N / 4;
  const int splits = P.splits[proj];
  const int4* base = reinterpret_cast<const int4*>(P.part + (size_t)b * N);
  const int n4 = n / 4, per = (n4 + blockDim.x - 1) / blockDim.x;
  if (per >= 4) cp_gather_q<4>(base, stride, splits, n4, s_act, ws, out);
  else if (per >= 2) cp_gather_q<2>(base, stride, splits, n4, s_act, ws, out);
  else cp_gather_q<1>(base, stride, splits, n4, s_act, ws, out);
}

// --- the GEMM phases ---------------------------------------------------------

// Walk this block's items (strip, split) of an [n_strips x splits] grid,
// each item a run of tiles; op loads a tile into a stage, multiplies a
// stage, and flushes an item's sums. The next tile is loaded while the
// current one is multiplied.
template <class Op>
__device__ void cp_tiles(Op& op, int n_strips, int n_tiles, int splits) {
  const int per = (n_tiles + splits - 1) / splits;
  splits = (n_tiles + per - 1) / per;
  const int items = n_strips * splits;
  int item = blockIdx.x;
  if (item >= items) return;
  int t = (item % splits) * per, stage = 0;
  op.load(0, item / splits, t);
  cp_async_commit();
  op.zero();
  while (true) {
    int nitem = item, nt = t + 1;
    if (nt >= min(n_tiles, (item % splits + 1) * per)) {
      nitem += gridDim.x;
      nt = (nitem % splits) * per;
    }
    if (nitem < items) op.load(stage ^ 1, nitem / splits, nt);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    op.compute(stage, t);
    __syncthreads();   // the next load goes into this stage
    if (nitem != item) {
      op.flush(item / splits, item % splits);
      if (nitem >= items) break;
      op.zero();
    }
    item = nitem;
    t = nt;
    stage ^= 1;
  }
  cp_async_wait<0>();
}

// part[split, b, n] = xq[b, split's rows] . W[split's rows, n] over int8 W
// [K, N] (K, N multiples of 128), stored (no atomics: the consumer adds the
// splits, exact in int32). BPT = 0: one lane, the warps split each tile's
// rows; else thread (tx, ty) sums 4 columns for lanes ty, ty + 8, ... (B <=
// 8 * BPT).
template <int BPT>
struct CpGemmI8 {
  const int8_t* W;
  const int8_t* xq;
  int ldq, B, N;
  int* part;
  unsigned char* sm;
  int a[BPT > 0 ? BPT : 1][4];

  __device__ void load(int stage, int strip, int t) {
    const int k0 = t * kCpTK8, n0 = strip * kCpTN;
    unsigned char* ws = sm + stage * kCpWStage;
    unsigned char* xs = sm + 2 * kCpWStage + stage * kCpXStage;
    for (int c = threadIdx.x; c < kCpTK8 * 8; c += kCpThreads) {   // read once a pass: evict first
      const int r = c >> 3, q = c & 7;
      cp_async16(ws + r * 128 + q * 16, W + (size_t)(k0 + r) * N + n0 + q * 16, true, true);
    }
    for (int c = threadIdx.x; c < B * 8; c += kCpThreads) {
      const int b = c >> 3, q = c & 7;
      cp_async16(xs + b * 128 + q * 16, xq + (size_t)b * ldq + k0 + q * 16);
    }
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < (BPT > 0 ? BPT : 1); ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0;
  }
  __device__ void compute(int stage, int t) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(sm + stage * kCpWStage);
    const int* xs = reinterpret_cast<const int*>(sm + 2 * kCpWStage + stage * kCpXStage);
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    if constexpr (BPT == 0) {
#pragma unroll
      for (int kw = ty; kw < kCpTK8 / 4; kw += 8) {
        const uint32_t* r = w + 4 * kw * 32 + tx;
        const int4 c = byte_transpose(r[0], r[32], r[64], r[96]);
        const int xv = xs[kw];
        a[0][0] = __dp4a(xv, c.x, a[0][0]);
        a[0][1] = __dp4a(xv, c.y, a[0][1]);
        a[0][2] = __dp4a(xv, c.z, a[0][2]);
        a[0][3] = __dp4a(xv, c.w, a[0][3]);
      }
    } else {
#pragma unroll 4
      for (int kw = 0; kw < kCpTK8 / 4; ++kw) {
        const uint32_t* r = w + 4 * kw * 32 + tx;
        const int4 c = byte_transpose(r[0], r[32], r[64], r[96]);
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
          const int xv = xs[(ty + 8 * i) * 32 + kw];   // rows >= B: stale, never written out
          a[i][0] = __dp4a(xv, c.x, a[i][0]);
          a[i][1] = __dp4a(xv, c.y, a[i][1]);
          a[i][2] = __dp4a(xv, c.z, a[i][2]);
          a[i][3] = __dp4a(xv, c.w, a[i][3]);
        }
      }
    }
  }
  __device__ void flush(int strip, int split) {
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int n = strip * kCpTN + 4 * tx;
    if constexpr (BPT == 0) {
      int* red = reinterpret_cast<int*>(sm + kCpRedOff);
      for (int j = 0; j < 4; ++j) red[(ty * 32 + tx) * 4 + j] = a[0][j];
      __syncthreads();
      if (ty == 0) {
        int s[4] = {0, 0, 0, 0};
        for (int y = 0; y < 8; ++y)
          for (int j = 0; j < 4; ++j) s[j] += red[(y * 32 + tx) * 4 + j];
        *reinterpret_cast<int4*>(part + (size_t)split * N + n) = make_int4(s[0], s[1], s[2], s[3]);
      }
      __syncthreads();
    } else {
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        const int b = ty + 8 * i;
        if (b >= B) break;
        *reinterpret_cast<int4*>(part + ((size_t)split * B + b) * N + n) =
            make_int4(a[i][0], a[i][1], a[i][2], a[i][3]);
      }
    }
  }
};

// Four consecutive head weights (16 bytes of float32, 8 of bf16) at p, and
// one activation, as float64.
__device__ __forceinline__ void cp_w4(const unsigned char* p, int tx, const __nv_bfloat16*,
                                      double (&w)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p + tx * 8);
  const __nv_bfloat162 w01 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 w23 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  w[0] = __low2float(w01);
  w[1] = __high2float(w01);
  w[2] = __low2float(w23);
  w[3] = __high2float(w23);
}
__device__ __forceinline__ void cp_w4(const unsigned char* p, int tx, const float*,
                                      double (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p + tx * 16);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}
__device__ __forceinline__ double cp_x(const __nv_bfloat16* x) { return __bfloat162float(*x); }
__device__ __forceinline__ double cp_x(const float* x) { return *x; }

// part[split, b, n] = sum over the split's rows k of hn[b, k] * W[k, n], E x
// E products (exact for bf16 and float32) summed in float64 (W the [H, V]
// head, hn in E). A tile is 16 KB of weights: TK = 64 bf16 rows or 32
// float32 rows of 128 columns, and 128 bytes of each lane's hn. The GEMM
// form widens the tile's activations to float64 once, in shared memory.
template <int BPT, typename E>
struct CpGemmHead {
  static constexpr int RB = kCpTN * (int)sizeof(E);   // bytes of a tile row
  static constexpr int TK = kCpWStage / RB;            // rows of a tile
  static constexpr int EC = 16 / (int)sizeof(E);       // elements a 16-byte copy
  const E* W;
  const E* hn;
  int H, B, N;
  double* part;
  unsigned char* sm;
  double a[BPT > 0 ? BPT : 1][4];

  __device__ void load(int stage, int strip, int t) {
    const int k0 = t * TK, n0 = strip * kCpTN;
    unsigned char* ws = sm + stage * kCpWStage;
    unsigned char* xs = sm + 2 * kCpWStage + stage * kCpXStage;
    for (int c = threadIdx.x; c < TK * (RB / 16); c += kCpThreads) {
      const int r = c / (RB / 16), q = c % (RB / 16);
      cp_async16(ws + r * RB + q * 16, W + (size_t)(k0 + r) * N + n0 + q * EC, true, true);
    }
    for (int c = threadIdx.x; c < B * 8; c += kCpThreads) {
      const int b = c >> 3, q = c & 7;
      cp_async16(xs + b * 128 + q * 16, hn + (size_t)b * H + k0 + q * EC);
    }
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < (BPT > 0 ? BPT : 1); ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.0;
  }
  __device__ void compute(int stage, int t) {
    const unsigned char* ws = sm + stage * kCpWStage;
    const E* xs = reinterpret_cast<const E*>(sm + 2 * kCpWStage + stage * kCpXStage);
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    if constexpr (BPT == 0) {
      for (int kk = ty; kk < TK; kk += 8) {
        double w[4];
        cp_w4(ws + kk * RB, tx, xs, w);
        const double xv = cp_x(xs + kk);
        a[0][0] += xv * w[0];
        a[0][1] += xv * w[1];
        a[0][2] += xv * w[2];
        a[0][3] += xv * w[3];
      }
    } else {
      double* xd = reinterpret_cast<double*>(sm + kCpXdOff);   // [lanes, TK]
      for (int i = threadIdx.x; i < B * TK; i += kCpThreads)
        xd[i] = cp_x(xs + (i / TK) * (128 / (int)sizeof(E)) + i % TK);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < TK; ++kk) {
        double wv[4];
        cp_w4(ws + kk * RB, tx, xs, wv);
        const double w0 = wv[0], w1 = wv[1], w2 = wv[2], w3 = wv[3];
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
          const double xv = xd[(ty + 8 * i) * TK + kk];   // rows >= B: never written out
          a[i][0] += xv * w0;
          a[i][1] += xv * w1;
          a[i][2] += xv * w2;
          a[i][3] += xv * w3;
        }
      }
    }
  }
  __device__ void flush(int strip, int split) {
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int n = strip * kCpTN + 4 * tx;
    if constexpr (BPT == 0) {
      double* red = reinterpret_cast<double*>(sm + kCpRedOff);
      for (int j = 0; j < 4; ++j) red[(ty * 32 + tx) * 4 + j] = a[0][j];
      __syncthreads();
      if (ty == 0)
        for (int j = 0; j < 4; ++j) {
          double s = 0.0;
          for (int y = 0; y < 8; ++y) s += red[(y * 32 + tx) * 4 + j];
          part[(size_t)split * N + n + j] = s;
        }
      __syncthreads();
    } else {
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        const int b = ty + 8 * i;
        if (b >= B) break;
        double2* out = reinterpret_cast<double2*>(part + ((size_t)split * B + b) * N + n);
        out[0] = make_double2(a[i][0], a[i][1]);
        out[1] = make_double2(a[i][2], a[i][3]);
      }
    }
  }
};

// --- the lane phases -----------------------------------------------------------

struct CpShared {
  float red[32];
  int redi[32];
  double redd[32];
  int last;
  SampleSmem<kCpThreads> samp;
};

// Lane b's row: x = xin (+ projection `proj` when > 0, with weight scales
// ws; proj is also its activation-scale slot),
// written to xout when given; h = RMSNorm(x) * norm. Either h is quantized
// into xq_out (scale *s_out), or, with hn_out, written there in the heads'
// dtype (rounded to bf16, or float32 as it is when P.emb_f32). xin is read
// through L2: other blocks may have written it. buf: shared, H floats.
__device__ void cp_norm_row(const CpParams& P, int b, const float* xin, float* xout, int proj,
                            const float* ws, const float* norm, int8_t* xq_out,
                            float* s_out, void* hn_out, float* buf, CpShared& sh) {
  const int H = P.H, bd = blockDim.x;
  float xv[8], nv[8];   // H <= 8 * blockDim: element tid + k * blockDim
#pragma unroll
  for (int k = 0; k < 8; ++k) {   // issued before the gather's loads
    const int i = threadIdx.x + k * bd;
    if (i < H) {
      xv[k] = __ldcg(xin + i);
      nv[k] = norm[i];
    }
  }
  if (proj > 0) {
    cp_gather(P, proj, H, b, __ldcg(P.s_act + proj * P.B + b), ws, H, buf);
    __syncthreads();
  }
  double ss = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = threadIdx.x + k * bd;
    if (i >= H) break;
    float v = xv[k];
    if (proj > 0) v = __fadd_rn(v, buf[i]);
    if (xout != nullptr) xout[i] = v;
    xv[k] = v;
    ss += (double)v * v;
  }
  const float var = (float)(block_sum(ss, sh.redd) / H);
  const float rs = 1.0f / sqrtf(var + P.eps);
  float am = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = threadIdx.x + k * bd;
    if (i >= H) break;
    const float h = xv[k] * rs * nv[k];
    buf[i] = h;
    am = fmaxf(am, fabsf(h));
    if (hn_out != nullptr) {
      if (P.emb_f32) static_cast<float*>(hn_out)[i] = h;
      else static_cast<__nv_bfloat16*>(hn_out)[i] = __float2bfloat16(h);
    }
  }
  if (hn_out == nullptr) quantize_buf(buf, H, am, xq_out, s_out, sh.red);
  __syncthreads();   // buf is read again by the lane's next row
}

// The RoPE and norm tables of one head for lane d = lane + 32 j (D <=
// 256), loaded into registers ahead of their use.
struct CpRopeTab {
  float w[8], c[8], s[8];
};

__device__ __forceinline__ void cp_rope_tab(CpRopeTab& t, const float* w, const float* cosv,
                                            const float* sinv, int D) {
  const int lane = threadIdx.x & 31, half = D / 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = lane + 32 * j;
    if (d < D) {
      const int k = d < half ? d : d - half;
      t.w[j] = w[d];
      t.c[j] = cosv[k];
      t.s[j] = sinv[k];
    }
  }
}

// q/k RMSNorm + NEOX RoPE of one head (warp-wide: lane owns d = lane +
// 32 j): y [D] (shared) in, the roped row out (shared). layer.cuh's qkv_post.
__device__ __forceinline__ void cp_norm_rope(const float* y, const CpRopeTab& t, int D,
                                             float eps, float* wrow, float* out) {
  const int lane = threadIdx.x & 31, half = D / 2;
  double ss = 0.0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = lane + 32 * j;
    if (d < D) ss += (double)y[d] * y[d];
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float var = (float)(ss / D);
  const float r = 1.0f / sqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = lane + 32 * j;
    if (d < D) wrow[d] = y[d] * r * t.w[j];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = lane + 32 * j;
    if (d >= D) continue;
    const int k = d < half ? d : d - half;
    const float x1 = wrow[k], x2 = wrow[k + half];
    // each product rounded before the sum, as the plain version computes it
    out[d] = d < half ? __fsub_rn(__fmul_rn(x1, t.c[j]), __fmul_rn(x2, t.s[j]))
                      : __fadd_rn(__fmul_rn(x1, t.s[j]), __fmul_rn(x2, t.c[j]));
  }
}

// KV heads per attention item: as many as the 8 warps hold at one warp per
// query head plus one for K and one for V (2 at G = 2), twice that when the
// items would otherwise take more than one round of the grid (B = 64: 128
// items of 4 heads on 132 blocks, not 256 of 2); the warps then loop over
// the roles.
__host__ __device__ __forceinline__ int cp_heads_per_item(int G, int Hkv, int B, int grid) {
  int hp = (kCpThreads / 32) / (G + 2);
  while (hp > 1 && Hkv % hp != 0) --hp;
  if (hp < 1) hp = 1;
  if (B * (Hkv / hp) > grid && Hkv % (2 * hp) == 0) hp *= 2;
  return hp;
}

// The most KV heads an item can take (sizes its shared memory).
inline int cp_max_heads_per_item(int G, int Hkv) {
  return cp_heads_per_item(G, Hkv, 2, 1);
}

// 16 bytes of a KV row (4 floats or 8 bf16) widened into out.
__device__ __forceinline__ void cp_widen(const float*, uint4 v, float* out) {
  *reinterpret_cast<uint4*>(out) = v;
}
__device__ __forceinline__ void cp_widen(const __nv_bfloat16*, uint4 v, float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = __uint_as_float(w[j] << 16);
    out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Lane b, KV heads h0 .. h0 + HP - 1, layer l, position pos: the
// projection's query heads and K and V heads of those KV heads; q/k norm
// and RoPE; the K/V rows into the scratch at pos; K/V rows 0..pos staged in
// shared memory; per query head the scores, their softmax and p @ V,
// written to P.o. The lane's last item to finish quantizes the lane's whole
// o for the O projection: the work of layer.cuh's qkv_post, attention and
// emit kernels. The item's HP * (G + 2) roles (per head slot: its query
// heads, K, V) go to the warps in turn.
template <typename T>
__device__ __noinline__ void cp_attention(const CpParams& P, int b, int h0, int HP, int l,
                                          int pos, float* smem, CpShared& sh) {
  const int D = P.D, Hq = P.Hq, Hkv = P.Hkv, G = Hq / Hkv, CTX = P.CTX;
  const int qkvN = (Hq + 2 * Hkv) * D, hd = Hq * D, n_valid = pos + 1, GD = G * D;
  float* yq = smem;                  // [HP, G, D] projection of the query heads
  float* yk = yq + HP * GD;          // [HP, D]
  float* yv = yk + HP * D;           // [HP, D]
  float* qs = yv + HP * D;           // [HP, G, D] roped queries
  float* ks = qs + HP * GD;          // [HP, CTX, D] keys (as stored, widened)
  float* vs = ks + HP * CTX * D;     // [HP, CTX, D] values
  float* sc = vs + HP * CTX * D;     // [HP, G, CTX] scores, then probabilities
  float* wv = sc + HP * G * CTX;     // [8 warps, D] RoPE scratch
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const size_t head_stride = (size_t)CTX * D;
  T* K = reinterpret_cast<T*>(P.kv) + (((size_t)l * P.B + b) * Hkv + h0) * head_stride;
  T* Vc = K + (size_t)P.L * P.B * Hkv * head_stride;
  const int n_roles = HP * (G + 2);
  const float* cosv = P.cos_tab + (size_t)pos * (D / 2);
  const float* sinv = P.sin_tab + (size_t)pos * (D / 2);
  CpRopeTab tab;   // the norm and RoPE tables of this warp's first role, loaded ahead
  if (wid < n_roles && wid % (G + 2) <= G)
    cp_rope_tab(tab, (wid % (G + 2) < G ? P.q_n : P.k_n) + (size_t)l * D, cosv, sinv, D);
  // one pass of loads: the three projection ranges, then the cached rows
  {
    const float sq = __ldcg(P.s_act + b);
    const float* wsq = P.sqkv + (size_t)l * qkvN;
    const size_t stride = (size_t)P.B * qkvN / 4;
    const int4* base = reinterpret_cast<const int4*>(P.part + (size_t)b * qkvN);
    const int nq = HP * GD / 4, nk = HP * D / 4;
    for (int i = threadIdx.x; i < nq + 2 * nk; i += blockDim.x) {
      const int c = i < nq ? h0 * GD + 4 * i
                           : (i < nq + nk ? (Hq + h0) * D + 4 * (i - nq)
                                          : (Hq + Hkv + h0) * D + 4 * (i - nq - nk));
      const float4 w4 = *reinterpret_cast<const float4*>(wsq + c);
      cp_scale4(cp_split_sum(base, stride, P.splits[0], c / 4), sq, w4, yq + 4 * i);
    }
    constexpr int per = 16 / sizeof(T);   // elements of one 16-byte load
    const int row16 = D / per, n16 = HP * pos * row16;
#pragma unroll 4
    for (int i = threadIdx.x; i < 2 * n16; i += blockDim.x) {
      const int kv = i >= n16, j = i - kv * n16, hh = j / (pos * row16), r = j % (pos * row16);
      const T* src = (kv ? Vc : K) + hh * head_stride;
      const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src) + r);
      cp_widen(src, v, (kv ? vs : ks) + hh * CTX * D + r * per);
    }
  }
  __syncthreads();
  for (int r = wid; r < n_roles; r += nw) {
    const int slot = r / (G + 2), role = r % (G + 2);
    if (r != wid && role <= G)
      cp_rope_tab(tab, (role < G ? P.q_n : P.k_n) + (size_t)l * D, cosv, sinv, D);
    float* kr = ks + ((size_t)slot * CTX + pos) * D;
    float* vr = vs + ((size_t)slot * CTX + pos) * D;
    if (role < G) {
      cp_norm_rope(yq + (slot * G + role) * D, tab, D, P.eps, wv + wid * D,
                   qs + (slot * G + role) * D);
    } else if (role == G) {
      cp_norm_rope(yk + slot * D, tab, D, P.eps, wv + wid * D, kr);
      for (int d = lane; d < D; d += 32) {
        const T v = from_f<T>(kr[d]);
        K[slot * head_stride + (size_t)pos * D + d] = v;
        kr[d] = to_f<T>(v);
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        const T v = from_f<T>(yv[slot * D + d]);
        Vc[slot * head_stride + (size_t)pos * D + d] = v;
        vr[d] = to_f<T>(v);
      }
    }
    __syncwarp();   // wrow is the warp's again for its next role
  }
  __syncthreads();
  const float scale = 1.0f / sqrtf((float)D);
  // one (query head, position) pair per 4 lanes, each lane a quarter of D;
  // the start rotates with t and the quarter, so that the 8 quads of a warp
  // (8 consecutive positions) read 32 different banks
  const int n_pairs = HP * G * n_valid, part = threadIdx.x & 3, n = D / 4;
  for (int r0 = 0; r0 < n_pairs; r0 += blockDim.x / 4) {   // warp-uniform rounds
    const int pr = r0 + threadIdx.x / 4;
    double a = 0.0;
    int qh = 0, t = 0;
    if (pr < n_pairs) {
      qh = pr / n_valid;
      t = pr % n_valid;
      const float* qrow = qs + qh * D + part * n;
      const float* krow = ks + ((size_t)(qh / G) * CTX + t) * D + part * n;
      int d = (t + 8 * part) % n;
      for (int m = 0; m < n; ++m) {
        a += qrow[d] * (double)krow[d];
        d = d + 1 == n ? 0 : d + 1;
      }
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    if (pr < n_pairs && part == 0) sc[qh * CTX + t] = (float)a * scale;
  }
  __syncthreads();
  for (int qh = wid; qh < HP * G; qh += nw) {   // n_valid <= 32: one position per lane
    float* s = sc + qh * CTX;
    const float v = lane < n_valid ? s[lane] : -3.4e38f;
    float m = v;
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const double e = lane < n_valid ? exp((double)(v - m)) : 0.0;
    double sum = e;
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane < n_valid) s[lane] = (float)(e / sum);
  }
  __syncthreads();
  float* ob = P.o + (size_t)b * hd + (size_t)h0 * GD;
  for (int i = threadIdx.x; i < HP * GD; i += blockDim.x) {
    const int qh = i / D, d = i % D;
    const float* vcol = vs + (size_t)(qh / G) * CTX * D + d;
    double acc = 0.0;
#pragma unroll 8
    for (int t = 0; t < n_valid; ++t) acc += (double)sc[qh * CTX + t] * vcol[(size_t)t * D];
    ob[i] = (float)acc;
  }
  // the lane's last item quantizes its o (threadfence reduction: the block
  // barrier, then one gpu-scope fence, which is cumulative, before the count)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    sh.last = atomicAdd(P.done + b, 1) == Hkv / HP - 1;
    if (sh.last) __threadfence();
  }
  __syncthreads();
  if (!sh.last) return;
  float am = 0.f;
#pragma unroll 8
  for (int i = threadIdx.x; i < hd; i += blockDim.x) {
    const float v = __ldcg(P.o + (size_t)b * hd + i);
    smem[i] = v;
    am = fmaxf(am, fabsf(v));
  }
  quantize_buf(smem, hd, am, P.xq + (size_t)b * P.ldq, P.s_act + 1 * P.B + b, sh.red);
  if (threadIdx.x == 0) P.done[b] = 0;
  __syncthreads();
}

// Lane b: a = silu(gate) * up from the gate/up projection of layer l,
// quantized for the down projection into xq_out (scale *s_out). buf:
// shared, 2F floats.
__device__ void cp_swiglu(const CpParams& P, int b, int l, float* buf, int8_t* xq_out,
                          float* s_out, CpShared& sh) {
  const int F = P.F;
  cp_gather(P, 2, 2 * F, b, __ldcg(P.s_act + 2 * P.B + b), P.sgu + (size_t)l * 2 * F,
            2 * F, buf);
  __syncthreads();
  float am = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    float g = buf[i];
    const float u = buf[F + i];
    g = g / (1.0f + (float)exp(-(double)g));
    const float a = g * u;
    buf[i] = a;
    am = fmaxf(am, fabsf(a));
  }
  quantize_buf(buf, F, am, xq_out, s_out, sh.red);
  __syncthreads();
}

// Lane b after pass p >= 1: logits = the head splits summed in order in
// float64, rounded once, held in registers (the sampler's slots in pairs:
// element pair q = tid + j * kCpThreads); code p-1 sampled at step p; its
// embedding row embds[p-1][code] added to rest_sum and, unless p == S, made
// the next pass's input, the row x (null when p == S).
__device__ __noinline__ void cp_sample(const CpParams& P, int b, int p, float* x,
                                       float* smem, CpShared& sh) {
  const int V = P.V, H = P.H, hs = P.splits[4];
  float lg[kCpSampleEPT];
  const double2* hp = reinterpret_cast<const double2*>(P.head_part + (size_t)b * V);
  const size_t stride = (size_t)P.B * V / 2;
#pragma unroll
  for (int j = 0; j < kCpSampleEPT / 2; ++j) {
    const int q = threadIdx.x + j * kCpThreads;
    double2 a = make_double2(0.0, 0.0);
    if (q < V / 2) {
      for (int s = 0; s < hs; s += 8) {
        double2 v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          v[t] = s + t < hs ? __ldcg(hp + (s + t) * stride + q) : make_double2(0.0, 0.0);
#pragma unroll
        for (int t = 0; t < 8; ++t) { a.x += v[t].x; a.y += v[t].y; }   // splits in order
      }
    }
    lg[2 * j] = (float)a.x;
    lg[2 * j + 1] = (float)a.y;
  }
  const int tok = sample_row<kCpThreads, kCpSampleEPT, 2>(
      lg, V, P.temps != nullptr ? P.temps[b] : P.temp, P.topps != nullptr ? P.topps[b] : P.top_p,
      P.top_k, P.greedy != 0, P.use_top_p != 0, P.seeds != nullptr ? P.seeds[b] : P.seed, p,
      sh.samp, reinterpret_cast<float2*>(smem));   // the noise queue in the lane phases' memory
  if (threadIdx.x == 0) P.codes[(size_t)b * P.S + p - 1] = tok;
  const size_t row = ((size_t)(p - 1) * V + tok) * H;
  const float* rowf = static_cast<const float*>(P.embds) + row;
  const __nv_bfloat16* rowb = static_cast<const __nv_bfloat16*>(P.embds) + row;
  float* rs = P.rest_sum + (size_t)b * H;
#pragma unroll 4
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float v = P.emb_f32 ? rowf[i] : __bfloat162float(rowb[i]);
    if (x != nullptr) x[i] = v;
    rs[i] += v;
  }
  __syncthreads();
}

// The GEMM phases, attention and sampling are separate (not inlined)
// functions, each with its own register allocation: measured on the H100,
// the kernel then spills nothing (inlined, it spilled ~1 KB a thread and
// ran up to 8% slower at one lane), and with the weight loads' L2 policy
// inlined into the kernel it faulted (illegal instruction). The kernel
// asks for one block per SM (__launch_bounds__ min 1): at two, the 128
// registers a thread may then hold made it spill, and it ran 24-27% slower
// at B = 1, 16 and 64.
// proj: 0 qkv, 1 o, 2 gate/up, 3 down (its splits).
template <int BPT>
__device__ __noinline__ void cp_gemm(const CpParams& P, int proj, const int8_t* W, int K, int N,
                                     unsigned char* sm) {
  CpGemmI8<BPT> op{W, P.xq, P.ldq, P.B, N, P.part, sm};
  cp_tiles(op, N / kCpTN, K / kCpTK8, P.splits[proj]);
}

// The head's GEMM of pass p (see cp_gemm), over bf16 or float32 heads.
template <int BPT, typename E>
__device__ __forceinline__ void cp_head_of(const CpParams& P, int p, unsigned char* sm) {
  CpGemmHead<BPT, E> op{static_cast<const E*>(P.heads) + (size_t)(p - 1) * P.H * P.V,
                        static_cast<const E*>(P.hn), P.H, P.B, P.V, P.head_part, sm};
  cp_tiles(op, P.V / kCpTN, P.H / cp_head_rows(P.emb_f32), P.splits[4]);
}

template <int BPT>
__device__ __noinline__ void cp_head(const CpParams& P, int p, unsigned char* sm) {
  if (P.emb_f32) cp_head_of<BPT, float>(P, p, sm);
  else cp_head_of<BPT, __nv_bfloat16>(P, p, sm);
}

template <typename T, int BPT>
__global__ void __launch_bounds__(kCpThreads, 1) cp_persistent_kernel(const CpParams P) {
  extern __shared__ __align__(16) unsigned char cp_smem[];
  __shared__ CpShared sh;
  cg::grid_group grid = cg::this_grid();
  unsigned char* smem = cp_smem;
  float* fsm = reinterpret_cast<float*>(smem);
  const int B = P.B, H = P.H, F = P.F, L = P.L, Hkv = P.Hkv;
  const int HP = cp_heads_per_item(P.Hq / Hkv, Hkv, B, gridDim.x);
  const int qkvN = (P.Hq + 2 * P.Hkv) * P.D, hd = P.Hq * P.D;
  auto X = [&](int i, int b) { return P.x + ((size_t)i * B + b) * H; };
  auto XQ = [&](int b) { return P.xq + (size_t)b * P.ldq; };
  int xi = 0;   // the residual buffer that holds x (the same in every block)
  for (int p = 0; p <= P.S; ++p) {
    for (int l = 0; l < L; ++l) {
      // residual + RMSNorm + quantization for QKV; layer 0 first sets the
      // pass's input (xinit, or the previous pass's sampled embedding)
      for (int b = blockIdx.x; b < B; b += gridDim.x) {
        float* xn = X(xi ^ 1, b);
        if (l > 0) {
          cp_norm_row(P, b, X(xi, b), xn, 3, P.sd + (size_t)(l - 1) * H,
                      P.attn_n + (size_t)l * H, XQ(b), P.s_act + b, nullptr, fsm, sh);
          continue;
        }
        if (p >= 2) {
          cp_sample(P, b, p - 1, xn, fsm, sh);
        } else {
          for (int i = threadIdx.x; i < H; i += blockDim.x) {
            xn[i] = P.xinit[((size_t)p * B + b) * H + i];
            if (p == 0) P.rest_sum[(size_t)b * H + i] = 0.f;
          }
          if (p == 0 && threadIdx.x == 0) P.done[b] = 0;
          __syncthreads();
        }
        cp_norm_row(P, b, xn, nullptr, 0, nullptr, P.attn_n, XQ(b), P.s_act + b, nullptr, fsm,
                    sh);
      }
      xi ^= 1;
      grid.sync();
      cp_gemm<BPT>(P, 0, P.wqkv + (size_t)l * H * qkvN, H, qkvN, smem);
      grid.sync();
      for (int it = blockIdx.x; it < B * Hkv / HP; it += gridDim.x)
        cp_attention<T>(P, it / (Hkv / HP), it % (Hkv / HP) * HP, HP, l, p, fsm, sh);
      grid.sync();
      cp_gemm<BPT>(P, 1, P.wo + (size_t)l * hd * H, hd, H, smem);
      grid.sync();
      for (int b = blockIdx.x; b < B; b += gridDim.x)
        cp_norm_row(P, b, X(xi, b), X(xi ^ 1, b), 1, P.so + (size_t)l * H,
                    P.ffn_n + (size_t)l * H, XQ(b), P.s_act + 2 * B + b, nullptr, fsm, sh);
      xi ^= 1;
      grid.sync();
      cp_gemm<BPT>(P, 2, P.wgu + (size_t)l * H * 2 * F, H, 2 * F, smem);
      grid.sync();
      for (int b = blockIdx.x; b < B; b += gridDim.x)
        cp_swiglu(P, b, l, fsm, XQ(b), P.s_act + 3 * B + b, sh);
      grid.sync();
      cp_gemm<BPT>(P, 3, P.wd + (size_t)l * F * H, F, H, smem);
      grid.sync();
    }
    if (p == 0) continue;
    for (int b = blockIdx.x; b < B; b += gridDim.x)
      cp_norm_row(P, b, X(xi, b), nullptr, 3, P.sd + (size_t)(L - 1) * H, P.out_norm, nullptr,
                  nullptr, (char*)P.hn + (P.emb_f32 ? 4 : 2) * (size_t)b * H, fsm, sh);
    grid.sync();
    cp_head<BPT>(P, p, smem);
    grid.sync();
  }
  for (int b = blockIdx.x; b < B; b += gridDim.x) cp_sample(P, b, P.S, nullptr, fsm, sh);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The workspace of one call for B lanes, carved from base (or only counted
// when base is null): the int32 partials sized for every projection at its
// most splits (one per weight tile), the head's for up to H /
// cp_head_rows(emb_f32).
inline size_t cp_carve(CpParams* P, char* base, int B, int H, int Hq, int Hkv, int D, int F,
                       int V, int emb_f32) {
  const int qkvN = (Hq + 2 * Hkv) * D, hd = Hq * D;
  int ldq = H > hd ? H : hd;
  ldq = ldq > F ? ldq : F;
  ldq = (ldq + 15) & ~15;
  const size_t shapes[4][2] = {{(size_t)H, (size_t)qkvN}, {(size_t)hd, (size_t)H},
                               {(size_t)H, 2 * (size_t)F}, {(size_t)F, (size_t)H}};
  size_t part_n = 0;
  for (const auto& kn : shapes) {
    const size_t n = (kn[0] / kCpTK8) * kn[1];
    part_n = n > part_n ? n : part_n;
  }
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  CpParams t{};
  t.ldq = ldq;
  t.x = (float*)take(sizeof(float) * 2 * B * H);
  t.xq = (int8_t*)take((size_t)B * ldq);
  t.s_act = (float*)take(sizeof(float) * 4 * B);
  t.part = (int*)take(sizeof(int) * part_n * B);
  t.o = (float*)take(sizeof(float) * (size_t)B * hd);
  t.done = (int*)take(sizeof(int) * B);
  t.hn = take((emb_f32 ? sizeof(float) : sizeof(__nv_bfloat16)) * B * H);
  t.head_part = (double*)take(sizeof(double) * (size_t)(H / cp_head_rows(emb_f32)) * B * V);
  if (P != nullptr) {
    P->ldq = t.ldq; P->x = t.x; P->xq = t.xq; P->s_act = t.s_act; P->part = t.part;
    P->o = t.o; P->done = t.done; P->hn = t.hn; P->head_part = t.head_part;
  }
  return off;
}

// The shapes the kernel assumes (cudaErrorInvalidValue otherwise): every
// GEMM dimension a multiple of its tile, D a multiple of 32 up to 256, a
// KV head's G query heads plus its K and V head on the 8 warps, and at most
// kCpMaxCtx positions.
inline int cp_check(int B, int H, int Hq, int Hkv, int D, int F, int V, int CTX, int S) {
  const int hd = Hq * D, qkvN = (Hq + 2 * Hkv) * D;
  if (B < 1 || B > kCpMaxLanes || S < 1 || S + 1 > CTX || CTX > kCpMaxCtx ||
      H > 8 * kCpThreads)
    return (int)cudaErrorInvalidValue;
  if (D % 32 != 0 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv + 2 > kCpThreads / 32)
    return (int)cudaErrorInvalidValue;
  if (H % kCpTK8 != 0 || hd % kCpTK8 != 0 || F % kCpTK8 != 0 || qkvN % kCpTN != 0 ||
      V % kCpTN != 0 || V > kMaxCodeVocab)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Dynamic shared memory: the GEMM stages and scratch, or the largest lane
// phase (attention, SwiGLU, a row, the sampler's noise queue), whichever is
// larger.
inline size_t cp_smem_bytes(int H, int Hq, int Hkv, int D, int F, int CTX) {
  const size_t G = Hq / Hkv, hd = (size_t)Hq * D;
  const size_t HP = cp_max_heads_per_item(Hq / Hkv, Hkv);
  const size_t attn =
      HP * (2 * G * D + 2 * D + 2 * (size_t)CTX * D + G * CTX) + (kCpThreads / 32) * D;
  size_t floats = attn > hd ? attn : hd;
  const size_t rows[3] = {2 * (size_t)F, (size_t)H,
                          (size_t)sample_queue_floats<kCpThreads, kCpSampleEPT>()};
  for (size_t r : rows) floats = r > floats ? r : floats;
  const size_t gemm = kCpXdOff + kCpXdBytes;
  return gemm > floats * sizeof(float) ? gemm : floats * sizeof(float);
}

// K splits of a GEMM with n_strips column strips and n_tiles weight tiles
// on a grid of `grid` blocks. The GEMV form (one lane, latency-bound):
// about one item per block, at most 8 splits, so that a consumer's split
// sum is one batch of 8 loads. The GEMM form (bound by its __dp4a
// products): one tile per item, which spreads the tiles most evenly over
// the SMs (two blocks share an SM; gate/up's 384 tiles are then at most 3
// per SM, not 4 as with 2-tile items).
inline int cp_splits(int grid, int n_strips, int n_tiles, bool gemv) {
  if (!gemv) return n_tiles;
  int s = (grid + n_strips - 1) / n_strips;
  s = s > 8 ? 8 : s;
  s = s < 1 ? 1 : (s > n_tiles ? n_tiles : s);
  const int per = (n_tiles + s - 1) / s;
  return (n_tiles + per - 1) / per;
}

struct CpPlan {
  int blocks, blocks_per_sm, sms;
  size_t smem;
};

// The co-resident grid of one instantiation for these shapes: blocks per
// SM from the occupancy calculator times the SMs, capped at what the widest
// phase can use. An error when no block fits or the device cannot launch
// cooperatively.
template <typename T, int BPT>
int cp_plan(const CpParams& P, CpPlan* plan) {
  // the attribute and occupancy queries once per device and shared-memory
  // size (host time counts on the single-stream path)
  static int cached_dev = -1;
  static CpPlan cached{};
  auto fn = cp_persistent_kernel<T, BPT>;
  const size_t smem = cp_smem_bytes(P.H, P.Hq, P.Hkv, P.D, P.F, P.CTX);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != cached_dev || smem != cached.smem) {
    int coop = 0, sms = 0, nb = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fn, kCpThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorNotSupported;
    if (nb < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached = CpPlan{0, nb, sms, smem};
    cached_dev = dev;
  }
  const int qkvN = (P.Hq + 2 * P.Hkv) * P.D, hd = P.Hq * P.D;
  const int widest[5] = {(qkvN / kCpTN) * (P.H / kCpTK8), (P.H / kCpTN) * (hd / kCpTK8),
                         (2 * P.F / kCpTN) * (P.H / kCpTK8), (P.H / kCpTN) * (P.F / kCpTK8),
                         (P.V / kCpTN) * (P.H / cp_head_rows(P.emb_f32))};
  int cap = P.B * P.Hkv;
  for (int w : widest) cap = w > cap ? w : cap;
  *plan = cached;
  const int all = cached.blocks_per_sm * cached.sms;
  plan->blocks = all < cap ? all : cap;
  return 0;
}

// One cooperative launch of the whole call on `st`; returns the launch's
// error, or cudaGetLastError() after it.
template <typename T, int BPT>
int cp_launch(CpParams P, cudaStream_t st) {
  CpPlan plan;
  if (int bad = cp_plan<T, BPT>(P, &plan)) return bad;
  const int qkvN = (P.Hq + 2 * P.Hkv) * P.D, hd = P.Hq * P.D, g = plan.blocks;
  const bool gemv = BPT == 0;
  P.splits[0] = cp_splits(g, qkvN / kCpTN, P.H / kCpTK8, gemv);
  P.splits[1] = cp_splits(g, P.H / kCpTN, hd / kCpTK8, gemv);
  P.splits[2] = cp_splits(g, 2 * P.F / kCpTN, P.H / kCpTK8, gemv);
  P.splits[3] = cp_splits(g, P.H / kCpTN, P.F / kCpTK8, gemv);
  P.splits[4] = cp_splits(g, P.V / kCpTN, P.H / cp_head_rows(P.emb_f32), gemv);
  void* args[] = {&P};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)cp_persistent_kernel<T, BPT>,
                                                    dim3(g), dim3(kCpThreads), args, plan.smem,
                                                    st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Lanes per thread of the GEMM form for B lanes (layer.cuh's by_lanes);
// one lane takes the GEMV form.
template <typename T, template <typename, int> class Fn, typename... Args>
int cp_by_lanes(int B, Args... args) {
  if (B == 1) return Fn<T, 0>::go(args...);
  if (B <= 8) return Fn<T, 1>::go(args...);
  if (B <= 16) return Fn<T, 2>::go(args...);
  if (B <= 32) return Fn<T, 4>::go(args...);
  return Fn<T, 8>::go(args...);
}

template <typename T, int BPT>
struct CpLaunch {
  static int go(const CpParams& P, cudaStream_t st) { return cp_launch<T, BPT>(P, st); }
};

template <typename T, int BPT>
struct CpGrid {
  static int go(const CpParams& P, int* out) {
    CpPlan plan;
    if (int bad = cp_plan<T, BPT>(P, &plan)) return bad;
    out[0] = plan.blocks;
    out[1] = cp_barriers(P.L, P.S);
    out[2] = plan.blocks_per_sm;
    out[3] = plan.sms;
    out[4] = (int)plan.smem;
    return 0;
  }
};

// The parameters of one call (workspace carved from ws).
inline CpParams cp_params(const void* xinit, int B, const void* cos_tab, const void* sin_tab,
                          const void* attn_n, const void* q_n, const void* k_n,
                          const void* ffn_n, const void* out_norm, const void* wqkv_q,
                          const void* wqkv_s, const void* wo_q, const void* wo_s,
                          const void* wgu_q, const void* wgu_s, const void* wd_q,
                          const void* wd_s, const void* heads, const void* embds,
                          int emb_f32, int L, int H,
                          int Hq, int Hkv, int D, int F, int V, int CTX, int S, float eps,
                          float temp, float top_p, int top_k, int greedy, int use_top_p,
                          int seed, const void* seeds, const void* temps, const void* topps,
                          void* codes, void* rest_sum, void* kv, void* ws) {
  CpParams P{};
  P.B = B; P.L = L; P.H = H; P.Hq = Hq; P.Hkv = Hkv; P.D = D; P.F = F; P.V = V;
  P.CTX = CTX; P.S = S; P.eps = eps;
  P.xinit = (const float*)xinit;
  P.cos_tab = (const float*)cos_tab;
  P.sin_tab = (const float*)sin_tab;
  P.attn_n = (const float*)attn_n;
  P.q_n = (const float*)q_n;
  P.k_n = (const float*)k_n;
  P.ffn_n = (const float*)ffn_n;
  P.out_norm = (const float*)out_norm;
  P.wqkv = (const int8_t*)wqkv_q; P.sqkv = (const float*)wqkv_s;
  P.wo = (const int8_t*)wo_q; P.so = (const float*)wo_s;
  P.wgu = (const int8_t*)wgu_q; P.sgu = (const float*)wgu_s;
  P.wd = (const int8_t*)wd_q; P.sd = (const float*)wd_s;
  P.heads = heads;
  P.embds = embds;
  P.emb_f32 = emb_f32;
  P.temp = temp; P.top_p = top_p; P.top_k = top_k; P.greedy = greedy;
  P.use_top_p = use_top_p; P.seed = seed;
  P.seeds = (const int*)seeds;
  P.temps = (const float*)temps;
  P.topps = (const float*)topps;
  P.codes = (int*)codes;
  P.rest_sum = (float*)rest_sum;
  P.kv = kv;
  if (ws != nullptr) cp_carve(&P, (char*)ws, B, H, Hq, Hkv, D, F, V, emb_f32);
  return P;
}

}  // namespace
