// W8A16 GEMM: y[M, N] = T((sum_k x[m, k] * q[k, n]) * scale[n]) with x of
// type T (bf16 or float32) [M, K], q int8 [K, N] in the [in, out] layout,
// scale float32 [1, N], and the sum in float32.
//
// Replaces qwen3tts_tpu/ops/pallas_int8_matmul.py:47 int8_matmul_pallas
// (and the XLA convert+dot it stands in for, ops/quantized_matmul.py:75-83):
// every 2-D int8 product outside the fused kernels — the prefill's
// projections, and the unfused decode step's at M = 1 (one stream) or M = B
// (lanes).
//
// What bounds it on the H100: bytes. The weight is K x N int8, 4-6.3 MB at
// the 0.6B projections, against x and y of a few hundred KB at M <= 128;
// at 3.35 TB/s that is 1.3-1.9 us. The products (2 M K N, 1.6 GFLOP at
// M = 128) take ~1.6 us at the bf16 tensor cores' peak.
//
// Design: one launch per call, no workspace. A block owns 64 output
// columns (grid.y), a block of rows (grid.z) and one K range; the K ranges
// of a column tile are the ranks of a thread block cluster (grid.x, up to
// 16 with the non-portable attribute), sized by int8_mm_plan so that about
// two blocks run on each of the 132 SMs. Each block streams its weight
// tiles (and the matching x columns) through a ring of 16-byte cp.async
// copies (common.cuh), several tiles in flight, one barrier per tile. At
// the end each block leaves its float32 partial [rows, 64] in shared
// memory, and rank r sums its share of the outputs over the S ranks'
// partials in rank order (distributed shared memory: cluster_store_push /
// _pull), applies the scale and casts: every run gives the same bits, with
// no atomics. Two paths:
//   FFMA (float32 x, and bf16 x with M <= 8: the decode step, a few lanes):
//     8 rows a block, 64-row weight tiles in a 4-stage ring; thread (k
//     group, column quad) widens one word of 4 weights to float per tile
//     row (exact, by the exponent trick: no I2F) and multiplies it against
//     the block's rows with float32 FMAs; the 16 k groups are added in a
//     fixed order. float32 x stays here: its 1e-5 relative gate does not
//     admit splitting x into bf16 parts.
//   Tensor cores (bf16 x with M > 8: the prefill, the batched unfused
//     step): up to 128 rows a block, 32-row weight tiles in a 4-stage ring.
//     Per tile one pass widens the int8 weights to bf16 (exact: |q| <= 128
//     has at most 8 significant bits) into a column-major tile in one of
//     two buffers, while the warps multiply the previous tile out of the
//     other with mma.sync m16n8k16 bf16 x bf16 -> float32 (columns on the
//     mma's M, rows of x on its N, as K5's GEMMs lay them out, layer.cuh).
//     The products are exact; only the float32 summation order differs from
//     the plain version, within the gate's one bf16 ulp.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 64;             // output columns per block
constexpr int kBlockTarget = 264;   // two blocks on each of 132 SMs
constexpr int kMaxSplits = 16;      // a non-portable cluster
constexpr int kPRow = kTN + 4;      // floats per row of a block's partial
// FFMA path
constexpr int kFmaRows = 8;         // rows of x per block
constexpr int kFmaTK = 64;          // weight rows per tile
constexpr int kFmaStages = 4;
// tensor-core path
constexpr int kMmaRows = 128;       // rows of x per block
constexpr int kMmaTK = 32;          // weight rows per tile
constexpr int kMmaStages = 4;
constexpr int kWRow = kTN + 16;     // bytes per weight row of a stage (the widening reads miss)
constexpr int kBRow = kMmaTK + 8;   // bf16 per x row of a stage and per column of a widened
                                    // tile: the mma fragments' loads are conflict-free

struct MmPlan { int path, splits, per, col_tiles, row_tiles; };

// The plan of one call (mirrored by ops/int8_matmul.int8_mm_plan): path 1
// (tensor cores) for bf16 x with M > 8, else path 0 (FFMA); K splits (the
// cluster), tiles per split, column tiles, row blocks.
MmPlan mm_plan(int M, int K, int N, int x_bf16) {
  const int path = x_bf16 && M > kFmaRows ? 1 : 0;
  const int rows = path ? kMmaRows : kFmaRows, tk = path ? kMmaTK : kFmaTK;
  const int col_tiles = N / kTN, row_tiles = (M + rows - 1) / rows, tiles = K / tk;
  const int blocks = col_tiles * row_tiles;
  int s = (kBlockTarget + blocks - 1) / blocks;
  s = max(1, min(min(s, tiles), kMaxSplits));
  const int per = (tiles + s - 1) / s;
  return MmPlan{path, (tiles + per - 1) / per, per, col_tiles, row_tiles};
}

// Four int8 weights (byte i of w) as floats, exactly: byte b ^ 0x80 = b + 128
// becomes the low mantissa byte of 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void i8x4_to_f(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// The same as two words of bf16 pairs (bytes 0, 1 and 2, 3): a small
// integer's float has zeros in its low 16 bits, so its high half is its
// bf16 exactly.
__device__ __forceinline__ uint2 i8x4_to_bf16(uint32_t w) {
  float f[4];
  i8x4_to_f(w, f);
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void store4(T* y, float4 v) {
  y[0] = from_f<T>(v.x);
  y[1] = from_f<T>(v.y);
  y[2] = from_f<T>(v.z);
  y[3] = from_f<T>(v.w);
}

// The cluster's reduction. Every block has left its float32 partial
// [rows, kPRow] at `part`, and rank r owns a contiguous share of the column
// quads (4 columns of one row): it writes y[m0 + m, n0 + n] =
// T((part_0 + part_1 + ... + part_{S-1})[m, n] * scale[n]) for them,
// adding the ranks' partials in rank order. Neighbouring threads take
// neighbouring quads of a row, so a remote access hits every bank once.

// Pull (the tensor-core path): after a cluster barrier, the owner reads the
// ranks' partials over distributed shared memory; a second barrier keeps
// every block's shared memory until the owners have read it.
template <typename T>
__device__ void cluster_store_pull(float* part, int rows, int m0, int n0, const float* scale,
                                   T* y, int N) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), S = (int)cluster.num_blocks();
  const int quads = rows * (kTN / 4), share = (quads + S - 1) / S;
  const int e1 = min(quads, (rank + 1) * share);
  cluster.sync();   // every block's partial written
  for (int e = rank * share + (int)threadIdx.x; e < e1; e += kThreads) {
    const int m = e / (kTN / 4), n = 4 * (e % (kTN / 4));
    float4 s = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + m * kPRow + n);
    for (int r = 1; r < S; ++r) {
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) + m * kPRow + n);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float4 sc = *reinterpret_cast<const float4*>(scale + n0 + n);
    store4(y + (size_t)(m0 + m) * N + n0 + n,
           make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w));
  }
  cluster.sync();   // the blocks' shared memory stays until every owner has read it
}

// Push (the FFMA path): each rank writes its quads into their owners'
// `inbox` [S][share] (shared memory of its own, used by nothing else), so
// one cluster barrier suffices and the owners then add locally. The block
// must have arrived at the cluster barrier on entry (cluster_arrive): its
// wait here guarantees that every block of the cluster runs before any
// remote write. Measured faster than the pull at M <= 8; at M = 128 its
// inbox would cost the tensor-core path a block per SM.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
template <typename T>
__device__ void cluster_store_push(const float* part, float4* inbox, int rows, int m0, int n0,
                                   const float* scale, T* y, int N) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), S = (int)cluster.num_blocks();
  const int quads = rows * (kTN / 4), share = (quads + S - 1) / S;
  const int e1 = min(quads, (rank + 1) * share);
  __syncthreads();   // the block's partial written
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every block has started
  for (int e = threadIdx.x; e < quads; e += kThreads) {
    const int owner = e / share, m = e / (kTN / 4), n = 4 * (e % (kTN / 4));
    cluster.map_shared_rank(inbox, owner)[rank * share + e - owner * share] =
        *reinterpret_cast<const float4*>(part + m * kPRow + n);
  }
  cluster.sync();   // every rank's quads are in their owners' inboxes
  for (int e = rank * share + (int)threadIdx.x; e < e1; e += kThreads) {
    const int m = e / (kTN / 4), n = 4 * (e % (kTN / 4)), slot = e - rank * share;
    float4 s = inbox[slot];
    for (int r = 1; r < S; ++r) {
      const float4 v = inbox[r * share + slot];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float4 sc = *reinterpret_cast<const float4*>(scale + n0 + n);
    store4(y + (size_t)(m0 + m) * N + n0 + n,
           make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w));
  }
}

__host__ __device__ constexpr int fma_stage_bytes(int MR, int xsize) {
  return kFmaTK * kTN + MR * kFmaTK * xsize;
}

// The FFMA block's shared memory: the ring, which the k groups' sums and
// the partial reuse after the loop, then the inbox [S][share] quads.
__host__ __device__ constexpr int fma_inbox_offset(int MR, int xsize) {
  return kFmaStages * fma_stage_bytes(MR, xsize) > 4 * (8 * MR * kTN + MR * kPRow)
             ? kFmaStages * fma_stage_bytes(MR, xsize)
             : 4 * (8 * MR * kTN + MR * kPRow);
}

// FFMA path. Block (rank = K range, column tile blockIdx.y, row block
// blockIdx.z of 8 rows); MR >= the block's rows. Thread (k group kg =
// tid / 16, column quad tid % 16) takes tile rows kg, kg + 16, ...
template <typename T, int MR>
__global__ void __launch_bounds__(kThreads)
int8_mm_ffma_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, T* __restrict__ y, int M, int K, int N,
                    int per) {
  constexpr int S = kFmaStages, kStage = fma_stage_bytes(MR, sizeof(T));
  constexpr int kPieces = kFmaTK * (int)sizeof(T) / 16;   // 16-byte pieces per x row
  extern __shared__ __align__(16) unsigned char mm_smem[];
  const int tid = threadIdx.x, quad = tid % 16, kg = tid / 16, warp = tid >> 5;
  cluster_arrive();
  const int rank = (int)cg::this_cluster().block_rank();
  const int n0 = blockIdx.y * kTN, m0 = blockIdx.z * kFmaRows, rows = min(MR, M - m0);
  const int t0 = rank * per, nt = min(K / kFmaTK, t0 + per) - t0;
  auto load = [&](int i) {   // tile t0 + i into stage i % S
    unsigned char* st = mm_smem + (i % S) * kStage;
    const int k0 = (t0 + i) * kFmaTK;
    {
      const int r = tid / 4, p = tid % 4;   // 64 rows x 4 pieces
      cp_async16(st + r * kTN + 16 * p, q + (size_t)(k0 + r) * N + n0 + 16 * p);
    }
    for (int e = tid; e < MR * kPieces; e += kThreads) {
      const int m = e / kPieces, p = e % kPieces;
      const bool ok = m < rows;
      cp_async16(st + kFmaTK * kTN + m * kFmaTK * sizeof(T) + 16 * p,
                 ok ? reinterpret_cast<const unsigned char*>(x + (size_t)(m0 + m) * K + k0) +
                          16 * p
                    : reinterpret_cast<const unsigned char*>(x),
                 ok);
    }
  };
  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nt) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();   // tile i in; every thread done with tile i - 1's stage
    if (i + S - 1 < nt) load(i + S - 1);
    cp_async_commit();
    const unsigned char* st = mm_smem + (i % S) * kStage;
    const T* xs = reinterpret_cast<const T*>(st + kFmaTK * kTN);
#pragma unroll
    for (int rr = 0; rr < kFmaTK / 16; ++rr) {
      const int r = kg + 16 * rr;
      float f[4];
      i8x4_to_f(*reinterpret_cast<const uint32_t*>(st + r * kTN + 4 * quad), f);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float xv = to_f(xs[m * kFmaTK + r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, f[j], acc[m][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the k groups' sums go there
  // a warp holds k groups 2w (lanes < 16) and 2w + 1 (lanes >= 16) of the
  // same quads; then the 8 warps' sums are added in warp order
  float* red = reinterpret_cast<float*>(mm_smem);   // [8 warps][MR][kTN]
  float* part = red + 8 * MR * kTN;                  // [MR][kPRow]
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = acc[m][j] + __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    if ((tid & 31) < 16)
      *reinterpret_cast<float4*>(red + (warp * MR + m) * kTN + 4 * quad) =
          make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  for (int e = tid; e < MR * kTN; e += kThreads) {
    const int m = e / kTN, n = e % kTN;
    float s = red[m * kTN + n];
    for (int w = 1; w < kThreads / 32; ++w) s += red[(w * MR + m) * kTN + n];
    part[m * kPRow + n] = s;
  }
  cluster_store_push(part, reinterpret_cast<float4*>(mm_smem + fma_inbox_offset(MR, sizeof(T))),
                     rows, m0, n0, scale, y, N);
}

__host__ __device__ constexpr int mma_stage_bytes(int R8) {
  return kMmaTK * kWRow + R8 * kBRow * 2;
}

// Tensor-core path. Block (rank = K range, column tile blockIdx.y, row
// block blockIdx.z of up to 128 rows). Warp (mw = warp & 1, lw = warp >> 1)
// multiplies 2 M tiles of 16 columns (32 mw + 16 m) against the 8-row tiles
// lw, lw + 4, ... (WL of them; empty ones skipped).
template <int WL>
__global__ void __launch_bounds__(kThreads)
int8_mm_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int K,
                   int N, int per) {
  constexpr int S = kMmaStages;
  extern __shared__ __align__(16) unsigned char mm_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int mw = warp & 1, lw = warp >> 1;
  const int rank = (int)cg::this_cluster().block_rank();
  const int n0 = blockIdx.y * kTN, m0 = blockIdx.z * kMmaRows, rows = min(kMmaRows, M - m0);
  const int R8 = (min(kMmaRows, M) + 7) & ~7, stage = mma_stage_bytes(R8);
  __nv_bfloat16* Wt = reinterpret_cast<__nv_bfloat16*>(mm_smem + S * stage);   // 2 x [kTN][kBRow]
  const int t0 = rank * per, nt = min(K / kMmaTK, t0 + per) - t0;
  auto load = [&](int i) {   // tile t0 + i into stage i % S
    unsigned char* st = mm_smem + (i % S) * stage;
    const int k0 = (t0 + i) * kMmaTK;
    if (tid < kMmaTK * 4) {
      const int r = tid / 4, p = tid % 4;
      cp_async16(st + r * kWRow + 16 * p, q + (size_t)(k0 + r) * N + n0 + 16 * p);
    }
    for (int e = tid; e < R8 * (kMmaTK / 8); e += kThreads) {
      const int m = e / (kMmaTK / 8), p = e % (kMmaTK / 8);
      const bool ok = m < rows;
      cp_async16(st + kMmaTK * kWRow + (m * kBRow + 8 * p) * 2,
                 ok ? x + (size_t)(m0 + m) * K + k0 + 8 * p : x, ok);
    }
  };
  auto widen = [&](int i) {   // tile i's weights as bf16 into Wt[i & 1], [column][k]
    if (tid >= (kMmaTK / 4) * (kTN / 4)) return;
    const unsigned char* st = mm_smem + (i % S) * stage;
    __nv_bfloat16* w = Wt + (i & 1) * kTN * kBRow;
    const int nb = tid % (kTN / 4), kb = tid / (kTN / 4);   // rows 4 kb.., columns 4 nb..
    const uint32_t* r = reinterpret_cast<const uint32_t*>(st + 4 * kb * kWRow) + nb;
    const int4 tr = byte_transpose(r[0], r[kWRow / 4], r[2 * (kWRow / 4)], r[3 * (kWRow / 4)]);
    const uint32_t cw[4] = {(uint32_t)tr.x, (uint32_t)tr.y, (uint32_t)tr.z, (uint32_t)tr.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint2*>(w + (4 * nb + j) * kBRow + 4 * kb) = i8x4_to_bf16(cw[j]);
  };
  float c[2][WL][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < WL; ++j) c[m][j][0] = c[m][j][1] = c[m][j][2] = c[m][j][3] = 0.f;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nt) load(i);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();
  __syncthreads();
  if (nt > 0) widen(0);
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<S - 3>();
    __syncthreads();   // tile i + 1 in, tile i widened; every warp done with tile i - 1
    if (i + S - 1 < nt) load(i + S - 1);
    cp_async_commit();
    if (i + 1 < nt) widen(i + 1);
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(mm_smem + (i % S) * stage + kMmaTK * kWRow);
    const __nv_bfloat16* w = Wt + (i & 1) * kTN * kBRow;
#pragma unroll
    for (int s = 0; s < kMmaTK / 16; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const __nv_bfloat16* p = w + (32 * mw + 16 * m + g) * kBRow + 16 * s + 2 * t;
        a[m][0] = *reinterpret_cast<const uint32_t*>(p);                 // column g, k 2t
        a[m][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kBRow);     // column g + 8
        a[m][2] = *reinterpret_cast<const uint32_t*>(p + 8);             // column g, k 2t + 8
        a[m][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kBRow + 8);
      }
#pragma unroll
      for (int j = 0; j < WL; ++j) {
        const int lt = lw + 4 * j;
        if (8 * lt >= rows) continue;   // uniform over the warp
        const __nv_bfloat16* xr = xs + (8 * lt + g) * kBRow + 16 * s + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
        mma_bf16(c[0][j], a[0], b0, b1);
        mma_bf16(c[1][j], a[1], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the block's partial goes there
  float* part = reinterpret_cast<float*>(mm_smem);   // [R8][kPRow]
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int n = 32 * mw + 16 * m + g;
#pragma unroll
    for (int j = 0; j < WL; ++j) {
      const int r = 8 * (lw + 4 * j) + 2 * t;
      if (r >= R8) continue;
      // c[e]: column n + 8 * (e >> 1), row r + (e & 1)
      part[r * kPRow + n] = c[m][j][0];
      part[(r + 1) * kPRow + n] = c[m][j][1];
      part[r * kPRow + n + 8] = c[m][j][2];
      part[(r + 1) * kPRow + n + 8] = c[m][j][3];
    }
  }
  cluster_store_pull(part, rows, m0, n0, scale, y, N);
}

size_t ffma_smem_bytes(int MR, int xsize) {
  return fma_inbox_offset(MR, xsize) + sizeof(float4) * ((size_t)MR * (kTN / 4) + kMaxSplits);
}

size_t mma_smem_bytes(int R8) {
  const size_t ring = (size_t)kMmaStages * mma_stage_bytes(R8);
  const size_t part = sizeof(float) * (size_t)R8 * kPRow;
  return (ring > part ? ring : part) + sizeof(__nv_bfloat16) * 2 * kTN * kBRow;
}

template <typename T, int MR>
cudaError_t launch_ffma(const T* x, const int8_t* q, const float* scale, T* y, int M, int K,
                        int N, const MmPlan& p, cudaStream_t st) {
  return launch_cluster(int8_mm_ffma_kernel<T, MR>, dim3(p.splits, p.col_tiles, p.row_tiles),
                        kThreads, ffma_smem_bytes(MR, sizeof(T)), st, x, q, scale, y, M, K, N,
                        p.per);
}

template <typename T>
cudaError_t run_ffma(const T* x, const int8_t* q, const float* scale, T* y, int M, int K, int N,
                     const MmPlan& p, cudaStream_t st) {
  if (M == 1) return launch_ffma<T, 1>(x, q, scale, y, M, K, N, p, st);
  if (M == 2) return launch_ffma<T, 2>(x, q, scale, y, M, K, N, p, st);
  if (M <= 4) return launch_ffma<T, 4>(x, q, scale, y, M, K, N, p, st);
  return launch_ffma<T, 8>(x, q, scale, y, M, K, N, p, st);
}

template <int WL>
cudaError_t launch_mma(const __nv_bfloat16* x, const int8_t* q, const float* scale,
                       __nv_bfloat16* y, int M, int K, int N, const MmPlan& p, cudaStream_t st) {
  const int R8 = (min(kMmaRows, M) + 7) & ~7;
  return launch_cluster(int8_mm_mma_kernel<WL>, dim3(p.splits, p.col_tiles, p.row_tiles),
                        kThreads, mma_smem_bytes(R8), st, x, q, scale, y, M, K, N, p.per);
}

}  // namespace

// The plan of one call: path, K splits (cluster size), tiles per split,
// column tiles, row blocks (grid = splits x column tiles x row blocks).
extern "C" int qtts_int8_mm_plan(int M, int K, int N, int x_bf16, void* out) {
  const MmPlan p = mm_plan(M, K, N, x_bf16);
  int* o = (int*)out;
  o[0] = p.path;
  o[1] = p.splits;
  o[2] = p.per;
  o[3] = p.col_tiles;
  o[4] = p.row_tiles;
  return 0;
}

// x [M, K] (bf16 when x_bf16, else float32), q int8 [K, N], scale float32
// [N], y [M, N] of x's type; x, q and scale 16-byte aligned; K and N
// multiples of 64. One cluster launch.
extern "C" int qtts_int8_matmul(const void* x, const void* q, const void* scale, void* y, int M,
                                int K, int N, int x_bf16, void* stream) {
  if (M < 1 || K < 64 || K % 64 != 0 || N < 64 || N % kTN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const MmPlan p = mm_plan(M, K, N, x_bf16);
  const int8_t* qw = (const int8_t*)q;
  const float* sc = (const float*)scale;
  if (!x_bf16) return (int)run_ffma((const float*)x, qw, sc, (float*)y, M, K, N, p, st);
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  __nv_bfloat16* yb = (__nv_bfloat16*)y;
  if (p.path == 0) return (int)run_ffma(xb, qw, sc, yb, M, K, N, p, st);
  const int tiles8 = (min(kMmaRows, M) + 7) / 8;   // 8-row tiles of the first row block
  if (tiles8 <= 4) return (int)launch_mma<1>(xb, qw, sc, yb, M, K, N, p, st);
  if (tiles8 <= 8) return (int)launch_mma<2>(xb, qw, sc, yb, M, K, N, p, st);
  return (int)launch_mma<4>(xb, qw, sc, yb, M, K, N, p, st);
}
