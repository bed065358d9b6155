// Block-wide reductions shared by the port's kernels.
//
// Everything here has internal linkage (anonymous namespace): each .cu file
// that includes it gets its own copy, so the shared library links without
// duplicate symbols.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct MaxOp { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct MinOp { __device__ float operator()(float a, float b) const { return fminf(a, b); } };
struct SumOp { template <typename T> __device__ T operator()(T a, T b) const { return a + b; } };

// Reduce v over the whole block; every thread gets the result. blockDim.x
// must be a multiple of 32. `sh` is shared scratch of at least 32 values;
// the leading __syncthreads protects it from the previous call's readers.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* sh, Op op, T init) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = lane < nw ? sh[lane] : init;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ float block_sum(float v, float* sh) { return block_reduce(v, sh, SumOp(), 0.f); }
__device__ double block_sum(double v, double* sh) { return block_reduce(v, sh, SumOp(), 0.0); }
__device__ float block_max(float v, float* sh) { return block_reduce(v, sh, MaxOp(), -3.4e38f); }
__device__ float block_min(float v, float* sh) { return block_reduce(v, sh, MinOp(), 3.4e38f); }

// Integer count over the block (exact, order-free).
__device__ int block_count(int v, int* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = lane < nw ? sh[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (value, index) argmax over the block with the first maximum winning, as
// jnp.argmax and torch.argmax break ties.
__device__ __forceinline__ void argmax_pick(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

__device__ int block_argmax(float v, int i, float* shv, int* shi) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    argmax_pick(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
  __syncthreads();
  if (lane == 0) { shv[wid] = v; shi[wid] = i; }
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = lane < nw ? shv[lane] : -3.4e38f;
  i = lane < nw ? shi[lane] : 0x7fffffff;
  for (int o = 16; o > 0; o >>= 1)
    argmax_pick(v, i, __shfl_xor_sync(0xffffffffu, v, o), __shfl_xor_sync(0xffffffffu, i, o));
  return i;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace
