// The 4-bit GEMV probe: a layer-gridded GEMV of one int8 activation row
// x [1, K] against L layers of weights, out[n] = sum_l sum_k x[k] * W_l[k, n]
// in int32, with the weights either int8 [L, K, N] ("int8") or two 4-bit
// values per byte [L, K/2, N] ("packed": byte [i, n] holds row i in its low
// nibble and row i + K/2 in its high nibble, each biased by 8).
//
// Replaces tools/exp_w4_gemv.py:87 `call` (its int8 and packed variants,
// the two its main() runs). Its int4 and int4dot variants are the same
// arithmetic on Mosaic's native int4 dtype, which neither torch nor this
// card's loads have; "packed" is the same data in bytes.
//
// The probe asks whether 4-bit weights halve the time of a weight-streaming
// GEMV or whether the unpacking eats the saving. What bounds it on the
// H100: bytes, L x K x N (int8) or half that (packed), 117 MB or 59 MB at
// L = 28, K = 1024, N = 4096, ~0.035 or ~0.018 ms at 3.35 TB/s. The design:
// one launch for all L layers over the flattened (layer, row) axis, a
// block of 32 x 8 threads walking 4-column groups with one 4-byte load per
// thread and row, grid.y splitting the rows over about four blocks an SM,
// and the per-block int32 sums added with atomics (exact in any order).
// K1's GEMVs (layer.cuh) take another design, 16-byte loads of whole tiles
// in flight, one launch per layer; chip_smoke.py times them beside it.
#include "common.cuh"

namespace {

constexpr int kProbeSplitTarget = 528;   // ~4 blocks per SM

template <bool kPacked>
__global__ void probe_gemv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ W,
                                  int rows_per_layer, int K, int N, int total_rows, int chunk,
                                  int* __restrict__ out) {
  __shared__ int part[8][32][4];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = (blockIdx.x * 32 + tx) * 4;
  const int rb = blockIdx.y * chunk, re = min(total_rows, rb + chunk);
  int a[4] = {0, 0, 0, 0};
  if (n0 < N) {
#pragma unroll 4
    for (int r = rb + ty; r < re; r += 8) {
      const int k = r % rows_per_layer;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(W + (size_t)r * N + n0);
      if (kPacked) {
        const int xl = x[k], xh = x[k + K / 2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int byte = (w >> (8 * j)) & 0xff;
          a[j] += xl * ((byte & 15) - 8) + xh * ((byte >> 4) - 8);
        }
      } else {
        const int xv = x[k];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] += xv * (int)(int8_t)((w >> (8 * j)) & 0xff);
      }
    }
  }
  for (int j = 0; j < 4; ++j) part[ty][tx][j] = a[j];
  __syncthreads();
  if (ty == 0 && n0 < N) {
    for (int j = 0; j < 4; ++j) {
      int s = 0;
      for (int y = 0; y < 8; ++y) s += part[y][tx][j];
      atomicAdd(out + n0 + j, s);
    }
  }
}

}  // namespace

// out [N] int32 (zeroed by the caller) += the probe's GEMV; packed selects
// the variant. K even, N a multiple of 4.
extern "C" int qtts_w4_gemv_probe(const void* x, const void* w, int packed, int L, int K,
                                  int N, void* out, void* stream) {
  if (K % 2 != 0 || N % 4 != 0 || L < 1) return (int)cudaErrorInvalidValue;
  const int rows = packed ? K / 2 : K, total = L * rows;
  const int gx = (N / 4 + 31) / 32;
  int ks = (kProbeSplitTarget + gx - 1) / gx;
  if (ks > total / 8) ks = total / 8 > 0 ? total / 8 : 1;
  const int chunk = (total + ks - 1) / ks;
  const dim3 grid(gx, (total + chunk - 1) / chunk), block(32, 8);
  cudaStream_t st = (cudaStream_t)stream;
  if (packed)
    probe_gemv_kernel<true><<<grid, block, 0, st>>>((const int8_t*)x, (const int8_t*)w, rows, K,
                                                    N, total, chunk, (int*)out);
  else
    probe_gemv_kernel<false><<<grid, block, 0, st>>>((const int8_t*)x, (const int8_t*)w, rows,
                                                     K, N, total, chunk, (int*)out);
  return (int)cudaGetLastError();
}
