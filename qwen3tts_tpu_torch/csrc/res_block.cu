// K3: one residual block of the vocoder's decoder stack,
//   out = x + conv_k1(snake2(conv_k7_dilated(snake1(x)))),
// causal, over x [T, C] float32 with conv weights [K, C, C] (JAX layout).
//
// Replaces qwen3tts_tpu/ops/pallas_vocoder.py:162 fused_res_block. The
// reference for the port is the float32 XLA path, so every product here is
// a float32 FMA: no TF32, no bf16.
//
// What bounds it on the H100: at the wide blocks (C = 768, 384) the k=7
// conv is 14*T*C^2 flops against 8*T*C bytes — compute-bound on the CUDA
// cores (67 TFLOP/s float32 outside the tensor cores); at the narrow ones
// (C = 192, 96; T up to 2.9M rows for 1500 frames) it is closer to the
// memory line. This first version is three plain kernels: snake1 into a
// scratch copy, a register-tiled (64 x 64 tile, 4 x 4 per thread) float32
// GEMM over the 7 dilated taps whose epilogue adds the bias and applies
// snake2 into a second scratch, and the same GEMM for the 1x1 conv whose
// epilogue adds the bias and the residual. The tiles mask any ragged edge,
// so every C (96 and 192 included) runs unpadded; rows before t = 0 read as
// zero, which is the causal zero halo of 6 * dilation rows. Keeping the
// snake/conv chain on chip, as the Pallas kernel does, is later work.
#include "common.cuh"

namespace {

constexpr int TM = 64, TN = 64, TK = 16, kThreads = 256;

__global__ void snake_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                             const float* __restrict__ beta, float* __restrict__ out,
                             long n, int C) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const float a = expf(alpha[c]), ib = expf(-beta[c]);
    const float v = x[i];
    const float s = sinf(v * a);
    out[i] = v + ib * s * s;
  }
}

// out[t, n] = epilogue(sum_{tap, ci} A[t - (taps-1-tap)*dil, ci] * W[tap, ci, n])
// with A rows before 0 read as zero. SNAKE: y = acc + b; out = snake(y).
// Otherwise: out = r + (acc + b).
template <bool SNAKE>
__global__ void __launch_bounds__(kThreads)
conv_gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ b, const float* __restrict__ alpha,
                 const float* __restrict__ beta, const float* __restrict__ r,
                 float* __restrict__ out, int T, int C, int taps, int dil) {
  __shared__ float As[TK][TM + 4];
  __shared__ float Bs[TK][TN];
  const int tid = threadIdx.x;
  const long tm0 = (long)blockIdx.x * TM;
  const int tn0 = blockIdx.y * TN;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int tap = 0; tap < taps; ++tap) {
    const long shift = (long)(tap - (taps - 1)) * dil;
    const float* Wt = W + (size_t)tap * C * C;
    for (int k0 = 0; k0 < C; k0 += TK) {
      for (int e = tid; e < TM * TK; e += kThreads) {
        const int rr = e / TK, c = e % TK;
        const long t = tm0 + rr + shift;
        const int ci = k0 + c;
        As[c][rr] = (t >= 0 && t < T && ci < C) ? A[(size_t)t * C + ci] : 0.f;
      }
      for (int e = tid; e < TK * TN; e += kThreads) {
        const int rr = e / TN, c = e % TN;
        const int ci = k0 + rr, n = tn0 + c;
        Bs[rr][c] = (ci < C && n < C) ? Wt[(size_t)ci * C + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long t = tm0 + ty * 4 + i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tn0 + tx * 4 + j;
      if (n >= C) continue;
      const float y = acc[i][j] + b[n];
      float o;
      if (SNAKE) {
        const float s = sinf(y * expf(alpha[n]));
        o = y + expf(-beta[n]) * s * s;
      } else {
        o = r[(size_t)t * C + n] + y;
      }
      out[(size_t)t * C + n] = o;
    }
  }
}

}  // namespace

extern "C" int qtts_res_block(const void* x, const void* w1, const void* b1, const void* a1,
                              const void* be1, const void* w2, const void* b2, const void* a2,
                              const void* be2, void* s1, void* s2, void* out, int T, int C,
                              int dilation, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long n = (long)T * C;
  const int sb = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  snake_kernel<<<sb, 256, 0, st>>>((const float*)x, (const float*)a1, (const float*)be1,
                                   (float*)s1, n, C);
  const dim3 grid((unsigned)((T + TM - 1) / TM), (unsigned)((C + TN - 1) / TN));
  conv_gemm_kernel<true><<<grid, kThreads, 0, st>>>(
      (const float*)s1, (const float*)w1, (const float*)b1, (const float*)a2,
      (const float*)be2, nullptr, (float*)s2, T, C, 7, dilation);
  conv_gemm_kernel<false><<<grid, kThreads, 0, st>>>(
      (const float*)s2, (const float*)w2, (const float*)b2, nullptr, nullptr,
      (const float*)x, (float*)out, T, C, 1, 1);
  return (int)cudaGetLastError();
}
