// Block-wide reductions, bulk, tensor and asynchronous copies, programmatic
// dependent launch and the cluster launch shared by the port's kernels.
//
// Everything here has internal linkage (anonymous namespace): each .cu file
// that includes it gets its own copy, so the shared library links without
// duplicate symbols.
#pragma once

#include <cuda.h>   // CUtensorMap (types only: nothing links the driver library)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr float kNegInf = -1e30f;

struct MaxOp { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Eight bf16 values (16 bytes) as float32.
__device__ __forceinline__ void bf16x8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Hopper's bulk copy (TMA without a tensor map) of contiguous bytes from
// device to shared memory, completing on an mbarrier in shared memory. One
// thread initializes each barrier (one arrival per phase), then per use
// posts the bytes the phase expects and issues the copies (16-byte aligned,
// a multiple of 16 bytes); every thread waits for the phase with its
// parity: the k-th use of a barrier completes phase k, parity k & 1.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)));
}
// After the inits, before any use (a __syncthreads() must follow).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Hopper's tensor copy (TMA with a tensor map, `map` a __grid_constant__
// kernel parameter): the map's box at coordinates c0..c4 (innermost first)
// into shared memory (128-byte aligned), completing on an mbarrier like
// bulk_load. Elements outside the tensor arrive as zeros and are never
// read; the phase expects the whole box's bytes.
__device__ __forceinline__ void tensor_load_5d(void* dst, const CUtensorMap* map, int c0, int c1,
                                               int c2, int c3, int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3), "r"(c4), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Asynchronous 16-byte copies from device to shared memory through L2 only
// (cp.async.cg), the ring that the GEMMs, K3 and the persistent code
// predictor stream their tiles through: issue a tile's copies, commit them
// as one group, and wait until at most N groups are still in flight (then a
// __syncthreads() makes every thread's copies visible to the block). With
// !ok the 16 bytes are zeros and src is not read. evict_first marks the
// line to leave L2 first: for a stream read once (a weight tile of the code
// predictor's 78.6 MB per pass) that should not evict the data the next
// phases read again.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok = true,
                                           bool evict_first = false) {
  if (evict_first) {
    uint64_t pol;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0), "l"(pol)
                 : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four words w0..w3 (rows k..k+3, columns n..n+3 of an int8 tile) ->
// column j's four k packed in word j (byte i = row k + i).
__device__ __forceinline__ int4 byte_transpose(uint32_t w0, uint32_t w1, uint32_t w2,
                                               uint32_t w3) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t2 = __byte_perm(w0, w1, 0x7362), t3 = __byte_perm(w2, w3, 0x7362);
  return make_int4((int)__byte_perm(t0, t1, 0x5410), (int)__byte_perm(t0, t1, 0x7632),
                   (int)__byte_perm(t2, t3, 0x5410), (int)__byte_perm(t2, t3, 0x7632));
}

// Programmatic dependent launch (Hopper): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// kernel before it in the stream still runs, once every block of that one
// has called pdl_trigger() (or exited). pdl_wait() then blocks until the
// kernel before has completed and its writes are visible. Every kernel
// launched with the attribute waits before it touches a buffer an earlier
// kernel writes or reads and before it exits, so the order of a chain holds
// transitively; only reads of data no kernel of the chain writes (weights,
// norms) may come before the wait. A pointer to a buffer the chain writes
// is never `const __restrict__` in such a kernel: the compiler may take
// that data for read-only over the whole kernel and load it early, before
// the wait. Both are no-ops in a kernel launched without the attribute.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Launch `kernel` on `grid` x `block` with `smem` bytes of dynamic shared
// memory, as clusters of `cluster` blocks along x when cluster > 0, and
// with programmatic dependent launch when `pdl` (see pdl_wait). Returns
// the launch's error.
template <typename... Exp, typename... Act>
cudaError_t launch_ex(void (*kernel)(Exp...), dim3 grid, dim3 block, size_t smem,
                      cudaStream_t st, unsigned cluster, bool pdl, Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  unsigned n = 0;
  if (cluster > 0) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
}

// Launch `kernel` on `grid` as clusters of grid.x blocks (one cluster per
// (y, z)), with `smem` bytes of dynamic shared memory (the attribute is set
// first, as above 48 KB it must be), with programmatic dependent launch when
// `pdl`. A cluster of more than 8 blocks needs the non-portable attribute,
// which Hopper grants up to 16. Returns the first error: an attribute the
// card refuses or a launch it refuses.
template <typename... Exp, typename... Act>
cudaError_t launch_cluster_ex(void (*kernel)(Exp...), dim3 grid, int threads, size_t smem,
                              cudaStream_t st, bool pdl, Act&&... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess && grid.x > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return launch_ex(kernel, grid, dim3(threads), smem, st, grid.x, pdl,
                   std::forward<Act>(args)...);
}

template <typename... Exp, typename... Act>
cudaError_t launch_cluster(void (*kernel)(Exp...), dim3 grid, int threads, size_t smem,
                           cudaStream_t st, Act&&... args) {
  return launch_cluster_ex(kernel, grid, threads, smem, st, false, std::forward<Act>(args)...);
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
