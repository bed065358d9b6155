// K3: one residual block of the vocoder's decoder stack,
//   out = x + conv_k1(snake2(conv_k7_dilated(snake1(x)))),
// causal, over x [B, T, C] float32 (B lanes of T rows each, the lanes
// independent) with conv weights [K, C, C] (JAX layout).
//
// Replaces qwen3tts_tpu/ops/pallas_vocoder.py:162 fused_res_block. The
// reference for the port is the float32 XLA path, so every product here is
// a float32 FMA on the CUDA cores: no TF32, no bf16.
//
// What bounds it on the H100: operations. The two convolutions are
// 16 C^2 T float32 operations against 8 C T bytes of x and out (and the
// weights once): about 2 C operations per byte, against a ridge of
// 67 TFLOP/s / 3.35 TB/s = 20, so every width (C = 768 .. 96) is
// compute-bound on the CUDA cores.
//
// Design. A block owns kTM = 128 rows (grid.x, so the ~2.9 M rows of C = 96
// at 1500 frames fit) and TN output columns (grid.y). Each of its 2 TN
// threads holds an 8 x 8 register tile (rows ty + 16 i; columns 4 tx .. and
// TN/2 + 4 tx ..), fed per 4 input channels by 8 float4 shared loads of A
// and 8 of B for 256 FFMAs. The input channels go in chunks of kKC = 8
// through a 3-stage ring of 16-byte cp.async copies (common.cuh), one chunk
// ahead, one barrier per chunk. A chunk is the window of x rows
// [t0 - 6 d, t0 + 128) (rows before 0 and from T on arrive as zeros:
// snake(0) = 0, so the causal zero halo stays exact) and the 7 taps' weight
// tiles W[tap, chunk, n-tile]. The 7 taps read the one window at row
// offsets tap * d, so x leaves device memory once per chunk, not once per
// tap. snake1 is applied in place to the next chunk's window, once per
// element, while the current chunk multiplies. The epilogue adds the bias
// and applies snake2 with exp(alpha) and exp(-beta) tabled once per column
// per block.
//   Narrow blocks (C = 96, 192: 640-1920 rows per frame, so the rows alone
//   fill the SMs): one block holds all C columns, keeps snake2's tile in
//   shared memory (128 x 196 floats at C = 192) and runs the 1x1 conv
//   there, streaming w2 through the same ring, then adds the bias and the
//   residual: one launch per res block.
//   Wide blocks (C = 384, 768: 32-160 rows per frame): columns tiled by 128
//   (one block an SM; 64-column tiles, three an SM, measured slower at
//   both widths); the first launch writes snake2(conv_k7 + b1) to a
//   scratch s2, the second runs the same tile code as a 1x1 conv over s2
//   with the bias and residual epilogue: two launches per res block.
// Any T runs (the last row tile is masked), and any C that is a multiple of
// 8 (wide tiles mask their last columns).
// Lanes (the vocoder's batched groups): grid.z is the lane. A block's rows
// are tested against its lane's [0, T) and addressed among the group's
// B * T rows (lane * T + t), so the halo rows before a lane's row 0 read as
// zeros, never as the previous lane's tail, and each lane's output equals
// the one-lane launch's bit for bit. One launch (two at the wide widths)
// serves the whole group. The pointers stay kernel parameters: per-lane
// pointers held in registers cost C = 96 and 192 about 6% on an H100.
// What holds it near half the float32 peak: an SM's shared memory delivers
// 128 bytes a clock against 128 FFMA lanes, and the 8 x 8 tile loads 16
// floats per 64 FFMAs a thread (a 128-bit load takes four wavefronts), so
// the loads take as long as the products; cuDNN's float32 convolutions of
// the same shapes run no faster (PERF.md).
#include "common.cuh"

namespace {

constexpr int kTM = 128;          // rows per block
constexpr int kKC = 8;            // input channels per ring chunk
constexpr int kKCP = kKC + 4;     // floats per window row (16-byte rows, ty and ty + 1 apart)
constexpr int kStages = 3;
constexpr int kTaps = 7;
constexpr int kWideTN = 128;      // columns per block of the wide widths
constexpr int kTC = 8;            // columns per thread (kTC / 4 float4 groups, kTG apart);
                                  // 16 measured slower: fewer warps, more registers
template <int TN> constexpr int kTG = 4 * TN / kTC;
template <int TN> constexpr int kResThreads = 16 * TN / kTC;   // 16 row groups

enum Mode { kFused = 0, kToS2 = 1, kResidual = 2 };

struct ResArgs {
  const float* x;       // [B, T, C] the conv's input: x (kFused, kToS2) or s2 (kResidual)
  const float* w;       // [taps, C, C]
  const float* b;       // [C]
  const float* a_in;    // snake1's alpha and beta [C] (7 taps)
  const float* be_in;
  const float* a_out;   // snake2's alpha and beta [C] (kFused, kToS2)
  const float* be_out;
  const float* w2;      // kFused: the 1x1 conv [C, C] and its bias
  const float* b2;
  const float* r;       // the residual (kFused, kResidual)
  float* out;           // [B, T, C]
  int T, C, dil;        // rows per lane, channels, dilation
};

__host__ __device__ constexpr int res_taps(int mode) { return mode == kResidual ? 1 : kTaps; }

// Floats of one ring stage: the window (kTM + halo rows) and the taps'
// weight tiles.
__host__ __device__ inline int res_stage_floats(int taps, int halo, int TN) {
  return (kTM + halo) * kKCP + taps * kKC * TN;
}

// acc[i][4 h + j] += sum over 4 consecutive input channels k of
// A[(ty + 16 i) * lda + k] * B[k * TN + h * kTG + 4 tx + j].
template <int TN>
__device__ __forceinline__ void fma_k4(float (&acc)[8][kTC], const float* A, int lda,
                                       const float* B, int ty, int tx) {
  float4 av[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * lda);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float bv[kTC];
#pragma unroll
    for (int h = 0; h < kTC / 4; ++h) {
      const float4 b = *reinterpret_cast<const float4*>(B + k * TN + h * kTG<TN> + 4 * tx);
      bv[4 * h] = b.x;
      bv[4 * h + 1] = b.y;
      bv[4 * h + 2] = b.z;
      bv[4 * h + 3] = b.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = k == 0 ? av[i].x : k == 1 ? av[i].y : k == 2 ? av[i].z : av[i].w;
#pragma unroll
      for (int j = 0; j < kTC; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
    }
  }
}

// One block: rows [t0, t0 + 128) x columns [n0, n0 + TN) of the MODE's
// conv (see the header); 2 TN threads. Two blocks an SM at TN = 96; one at
// TN = 128 and 192, whose threads need more than 128 registers each.
template <int TN, int MODE>
__global__ void __launch_bounds__(kResThreads<TN>, TN == 96 ? 2 : 1)
res_conv_kernel(ResArgs a) {
  constexpr int kThreads = kResThreads<TN>, kTX = TN / kTC, taps = res_taps(MODE);
  constexpr bool kSnakeIn = taps == kTaps;
  extern __shared__ __align__(16) float res_smem[];
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int C = a.C, T = a.T;
  const long t0 = (long)blockIdx.x * kTM;        // the block's first row in its lane
  const long f0 = (long)blockIdx.z * T + t0;     // that row among the group's B * T rows
  const int n0 = blockIdx.y * TN;
  const int halo = kSnakeIn ? (taps - 1) * a.dil : 0, wrows = kTM + halo;
  float* ea_in = res_smem;                                  // [C] exp(alpha1)
  float* eb_in = res_smem + C;                              // [C] exp(-beta1)
  float* ea_out = res_smem + (kSnakeIn ? 2 * C : 0);        // [TN] exp(alpha2), block's columns
  float* eb_out = ea_out + TN;                              // [TN] exp(-beta2)
  float* ring = eb_out + TN;
  const int stage = res_stage_floats(taps, halo, TN);
  if (kSnakeIn)
    for (int c = tid; c < C; c += kThreads) {
      ea_in[c] = expf(a.a_in[c]);
      eb_in[c] = expf(-a.be_in[c]);
    }
  if (MODE != kResidual)
    for (int n = tid; n < TN; n += kThreads) {
      const bool ok = n0 + n < C;
      ea_out[n] = ok ? expf(a.a_out[n0 + n]) : 0.f;
      eb_out[n] = ok ? expf(-a.be_out[n0 + n]) : 0.f;
    }

  auto load = [&](int c) {   // chunk c: the window and the taps' weight tiles
    float* win = ring + (c % kStages) * stage;
    float* wt = win + wrows * kKCP;
    const int k0 = c * kKC;
    for (int e = tid; e < wrows * (kKC / 4); e += kThreads) {
      const int r = e / (kKC / 4), p = e % (kKC / 4);
      const long t = t0 - halo + r;
      const bool ok = t >= 0 && t < T;   // the lane's own rows; zeros outside
      cp_async16(win + r * kKCP + 4 * p,
                 ok ? a.x + (size_t)(f0 - halo + r) * C + k0 + 4 * p : a.x, ok);
    }
    for (int e = tid; e < taps * kKC * (TN / 4); e += kThreads) {
      const int row = e / (TN / 4), p = e % (TN / 4);   // row = tap * kKC + kk
      const int tap = row / kKC, kk = row % kKC, n = n0 + 4 * p;
      const bool ok = n < C;
      cp_async16(wt + row * TN + 4 * p,
                 ok ? a.w + ((size_t)tap * C + k0 + kk) * C + n : a.w, ok);
    }
  };
  auto snake_in = [&](int c) {   // snake1 in place over chunk c's window
    float* win = ring + (c % kStages) * stage;
    const int k0 = c * kKC;
    for (int e = tid; e < wrows * kKC; e += kThreads) {
      const int r = e / kKC, kk = e % kKC;
      float* p = win + r * kKCP + kk;
      const float v = *p, s = sinf(v * ea_in[k0 + kk]);
      *p = v + eb_in[k0 + kk] * s * s;
    }
  };

  float acc[8][kTC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;
  const int nc = C / kKC;
  load(0);
  cp_async_commit();
  if (nc > 1) load(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();   // chunk 0 in, the tables written
  if (kSnakeIn) snake_in(0);
  for (int c = 0; c < nc; ++c) {
    // chunk c + 1 in (the snake pass reads it; without one, chunk c is enough)
    if (kSnakeIn) cp_async_wait<0>(); else cp_async_wait<1>();
    __syncthreads();   // chunk c snaked; every warp done with chunk c - 1's stage
    if (c + 2 < nc) load(c + 2);
    cp_async_commit();
    if (kSnakeIn && c + 1 < nc) snake_in(c + 1);
    const float* win = ring + (c % kStages) * stage;
    const float* wt = win + wrows * kKCP;
#pragma unroll 1
    for (int tap = 0; tap < taps; ++tap)
#pragma unroll
      for (int kq = 0; kq < kKC / 4; ++kq)
        fma_k4<TN>(acc, win + tap * a.dil * kKCP + 4 * kq, kKCP, wt + (tap * kKC + 4 * kq) * TN,
                   ty, tx);
  }

  if constexpr (MODE == kFused) {
    // snake2's tile stays in shared memory, [kTM][C + 4] (here TN == C),
    // with w2's ring behind it; both alias the ring, which every warp is
    // done with after this barrier
    __syncthreads();
    const int lds = C + 4;
    float* s2 = ring;
    float* wring = s2 + kTM * lds;
    auto load2 = [&](int c) {
      float* wt = wring + (c % kStages) * (kKC * TN);
      for (int e = tid; e < kKC * (TN / 4); e += kThreads) {
        const int kk = e / (TN / 4), p = e % (TN / 4);
        cp_async16(wt + kk * TN + 4 * p, a.w2 + (size_t)(c * kKC + kk) * C + 4 * p);
      }
    };
    load2(0);
    cp_async_commit();
    if (nc > 1) load2(1);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int h = 0; h < kTC / 4; ++h) {
        const int nl = h * kTG<TN> + 4 * tx;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = acc[i][4 * h + j] + a.b[nl + j];
          const float s = sinf(y * ea_out[nl + j]);
          v[j] = y + eb_out[nl + j] * s * s;
          acc[i][4 * h + j] = 0.f;
        }
        *reinterpret_cast<float4*>(s2 + row * lds + nl) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<1>();
      __syncthreads();   // s2 written; w2 chunk c in; every warp done with chunk c - 1
      if (c + 2 < nc) load2(c + 2);
      cp_async_commit();
      const float* wt = wring + (c % kStages) * (kKC * TN);
#pragma unroll
      for (int kq = 0; kq < kKC / 4; ++kq)
        fma_k4<TN>(acc, s2 + c * kKC + 4 * kq, lds, wt + 4 * kq * TN, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long t = t0 + ty + 16 * i;
    if (t >= T) continue;
    const size_t row = (size_t)(f0 + ty + 16 * i) * C;
#pragma unroll
    for (int h = 0; h < kTC / 4; ++h) {
      const int nl = h * kTG<TN> + 4 * tx, n = n0 + nl;
      if (n >= C) continue;
      const float* bias = MODE == kFused ? a.b2 : a.b;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][4 * h + j] + bias[n + j];
      if constexpr (MODE == kToS2) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float s = sinf(v[j] * ea_out[nl + j]);
          v[j] = v[j] + eb_out[nl + j] * s * s;
        }
      } else {
        const float4 r = *reinterpret_cast<const float4*>(a.r + row + n);
        v[0] = r.x + v[0];
        v[1] = r.y + v[1];
        v[2] = r.z + v[2];
        v[3] = r.w + v[3];
      }
      *reinterpret_cast<float4*>(a.out + row + n) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The launches of one res block (mirrored by ops/fused_vocoder.res_block_plan);
// each launch's grid is (row_tiles, col_tiles, lanes).
struct ResPlan { int launches, tn, row_tiles, col_tiles, halo; };

ResPlan res_block_plan(int T, int C, int dil) {
  const int rows = (T + kTM - 1) / kTM, halo = (kTaps - 1) * dil;
  if (C == 96 || C == 192) return ResPlan{1, C, rows, 1, halo};
  return ResPlan{2, kWideTN, rows, (C + kWideTN - 1) / kWideTN, halo};
}

size_t res_smem_bytes(int mode, int TN, int C, int halo) {
  const int taps = res_taps(mode);
  const size_t tabs = (taps == kTaps ? 2 * (size_t)C : 0) + 2 * (size_t)TN;
  size_t ring = (size_t)kStages * res_stage_floats(taps, taps == kTaps ? halo : 0, TN);
  if (mode == kFused) {
    const size_t phase2 = (size_t)kTM * (C + 4) + (size_t)kStages * kKC * TN;
    ring = ring > phase2 ? ring : phase2;
  }
  return (tabs + ring) * sizeof(float);
}

template <int TN, int MODE>
cudaError_t launch(const ResArgs& a, const ResPlan& p, int lanes, cudaStream_t st) {
  const size_t smem = res_smem_bytes(MODE, TN, a.C, p.halo);
  cudaError_t e = cudaFuncSetAttribute(res_conv_kernel<TN, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)p.row_tiles, (unsigned)p.col_tiles, (unsigned)lanes);
  res_conv_kernel<TN, MODE><<<grid, kResThreads<TN>, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The plan of one res block: launches, rows per block, columns per block,
// row tiles (grid.x), column tiles (grid.y), halo rows (6 * dilation).
extern "C" int qtts_res_block_plan(int T, int C, int dilation, void* out) {
  const ResPlan p = res_block_plan(T, C, dilation);
  int* o = (int*)out;
  o[0] = p.launches;
  o[1] = kTM;
  o[2] = p.tn;
  o[3] = p.row_tiles;
  o[4] = p.col_tiles;
  o[5] = p.halo;
  return 0;
}

// x, out [B, T, C] and w1 [7, C, C], w2 [1, C, C] float32, 16-byte aligned;
// biases and snake parameters [C]; s2 [B, T, C] scratch, used (and needed)
// only where the plan takes two launches. C a multiple of 8; B <= 65535.
extern "C" int qtts_res_block(const void* x, const void* w1, const void* b1, const void* a1,
                              const void* be1, const void* w2, const void* b2, const void* a2,
                              const void* be2, void* s2, void* out, int B, int T, int C,
                              int dilation, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || C < 8 || C % 8 != 0 || dilation < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const ResPlan p = res_block_plan(T, C, dilation);
  const float *fx = (const float*)x, *fw1 = (const float*)w1, *fb1 = (const float*)b1,
              *fa1 = (const float*)a1, *fbe1 = (const float*)be1, *fw2 = (const float*)w2,
              *fb2 = (const float*)b2, *fa2 = (const float*)a2, *fbe2 = (const float*)be2;
  if (p.launches == 1) {
    const ResArgs a{fx, fw1, fb1, fa1, fbe1, fa2, fbe2, fw2, fb2, fx, (float*)out, T, C, dilation};
    return (int)(C == 96 ? launch<96, kFused>(a, p, B, st) : launch<192, kFused>(a, p, B, st));
  }
  if (s2 == nullptr) return (int)cudaErrorInvalidValue;
  const ResArgs k7{fx, fw1, fb1, fa1, fbe1, fa2, fbe2, nullptr, nullptr, nullptr, (float*)s2,
                   T, C, dilation};
  cudaError_t e = launch<kWideTN, kToS2>(k7, p, B, st);
  if (e != cudaSuccess) return (int)e;
  const ResArgs k1{(const float*)s2, fw2, fb2, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, fx, (float*)out, T, C, 1};
  return (int)launch<kWideTN, kResidual>(k1, p, B, st);
}
