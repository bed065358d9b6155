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
// the 0.6B projections, against x and y of a few KB at M <= 10; at 3.35 TB/s
// that is 1.3-1.9 us. Even at M = 128 the float32 multiply-adds (2 M K N =
// 0.8-1.6 GFLOP) stay near the bytes' time on the CUDA cores. The design:
// a block owns 64 output columns and one K range; it stages each [64 x 64]
// int8 weight tile in shared memory with 16-byte loads (four per weight row)
// and the matching x columns of up to 128 rows as float32, converts each
// weight to float in registers (exact) and accumulates with float32 FMAs,
// one column and up to 32 rows per thread. K is split so that the narrow
// projections still put ~264 blocks on the 132 SMs; the splits write
// float32 partials to a workspace and a second kernel sums them in split
// order and applies the scale, so the result has the same bits on every
// run (no atomics). M above 128 takes further block rows (grid.z), which
// read the weight tiles again, from L2. A first, simple version: the tensor
// cores (mma.sync on bf16 tiles) and a cp.async pipeline are later work.
#include "common.cuh"

namespace {

constexpr int kMmTN = 64;                         // output columns per block
constexpr int kMmTK = 64;                         // weight rows per shared tile
constexpr int kMmThreads = 256;                   // 64 columns x 4 row groups
constexpr int kMmRowGroups = kMmThreads / kMmTN;  // rows m = group + 4 j
constexpr int kMmMaxRows = 128;                   // rows of x per block
constexpr int kMmBlockTarget = 264;               // ~2 blocks per SM

// Block (column tile blockIdx.x, K split blockIdx.y, row block blockIdx.z):
// part[split, m, n] = sum over the split's k of x[m, k] * q[k, n] (float32).
// RPT accumulators per thread cover the block's rows (RPT * 4 >= rows).
template <typename T, int RPT>
__global__ void __launch_bounds__(kMmThreads)
int8_mm_partial_kernel(const T* __restrict__ x, const int8_t* __restrict__ q, int M, int K,
                       int N, int kchunk, float* __restrict__ part) {
  __shared__ __align__(16) int8_t sq[kMmTK][kMmTN];
  __shared__ float sx[kMmMaxRows][kMmTK];
  const int tid = threadIdx.x;
  const int col = tid % kMmTN, group = tid / kMmTN;
  const int n0 = blockIdx.x * kMmTN;
  const int m0 = blockIdx.z * kMmMaxRows, rows = min(kMmMaxRows, M - m0);
  const int kb = blockIdx.y * kchunk, ke = min(K, kb + kchunk);
  float acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += kMmTK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kMmTK * (kMmTN / 16); i += kMmThreads) {
      const int r = i / (kMmTN / 16), c = (i % (kMmTN / 16)) * 16;
      *reinterpret_cast<int4*>(&sq[r][c]) =
          __ldg(reinterpret_cast<const int4*>(q + (size_t)(k0 + r) * N + n0 + c));
    }
    for (int i = tid; i < rows * kMmTK; i += kMmThreads) {
      const int m = i / kMmTK, k = i % kMmTK;
      sx[m][k] = to_f(x[(size_t)(m0 + m) * K + k0 + k]);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kMmTK; ++k) {
      const float w = (float)sq[k][col];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int m = group + j * kMmRowGroups;
        if (m < rows) acc[j] = fmaf(sx[m][k], w, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int m = group + j * kMmRowGroups;
    if (m < rows) part[((size_t)blockIdx.y * M + m0 + m) * N + n0 + col] = acc[j];
  }
}

// y[m, n] = T((sum over splits, in split order, of part[s, m, n]) * scale[n]).
template <typename T>
__global__ void int8_mm_reduce_kernel(const float* __restrict__ part, int splits, int M, int N,
                                      const float* __restrict__ scale, T* __restrict__ y) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (i >= MN) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += part[(size_t)p * MN + i];
  y[i] = from_f<T>(s * scale[i % N]);
}

struct MmSplit { int splits, kchunk; };

MmSplit mm_split(int M, int K, int N) {
  const int tiles = (N / kMmTN) * ((M + kMmMaxRows - 1) / kMmMaxRows);
  const int want = (kMmBlockTarget + tiles - 1) / tiles;
  const int ktiles = K / kMmTK;
  const int kchunk = ((ktiles + want - 1) / want) * kMmTK;
  return MmSplit{(K + kchunk - 1) / kchunk, kchunk};
}

template <typename T, int RPT>
void launch_partial(const T* x, const int8_t* q, int M, int K, int N, MmSplit sp, float* part,
                    cudaStream_t st) {
  const dim3 grid(N / kMmTN, sp.splits, (M + kMmMaxRows - 1) / kMmMaxRows);
  int8_mm_partial_kernel<T, RPT><<<grid, kMmThreads, 0, st>>>(x, q, M, K, N, sp.kchunk, part);
}

template <typename T>
int run(const T* x, const int8_t* q, const float* scale, T* y, float* part, int M, int K, int N,
        cudaStream_t st) {
  const MmSplit sp = mm_split(M, K, N);
  const int rows = M < kMmMaxRows ? M : kMmMaxRows;
  const int rpt = (rows + kMmRowGroups - 1) / kMmRowGroups;
  if (rpt <= 1) launch_partial<T, 1>(x, q, M, K, N, sp, part, st);
  else if (rpt <= 4) launch_partial<T, 4>(x, q, M, K, N, sp, part, st);
  else if (rpt <= 16) launch_partial<T, 16>(x, q, M, K, N, sp, part, st);
  else launch_partial<T, 32>(x, q, M, K, N, sp, part, st);
  const size_t MN = (size_t)M * N;
  int8_mm_reduce_kernel<T><<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(part, sp.splits, M, N,
                                                                          scale, y);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of float32 partials the call needs (allocated by the wrapper).
extern "C" size_t qtts_int8_matmul_ws_bytes(int M, int K, int N) {
  return sizeof(float) * (size_t)mm_split(M, K, N).splits * M * N;
}

// x [M, K] (bf16 when x_bf16, else float32), q int8 [K, N] (16-byte
// aligned), scale float32 [N], y [M, N] of x's type. K and N are multiples
// of 64.
extern "C" int qtts_int8_matmul(const void* x, const void* q, const void* scale, void* y,
                                void* ws, int M, int K, int N, int x_bf16, void* stream) {
  if (M < 1 || K % kMmTK != 0 || N % kMmTN != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return run((const __nv_bfloat16*)x, (const int8_t*)q, (const float*)scale,
               (__nv_bfloat16*)y, (float*)ws, M, K, N, st);
  return run((const float*)x, (const int8_t*)q, (const float*)scale, (float*)y, (float*)ws, M,
             K, N, st);
}
