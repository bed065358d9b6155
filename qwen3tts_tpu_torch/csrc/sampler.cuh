// K4: the counter-hash sampler as a __device__ function, shared by the fused
// talker step (its cb0 epilogue), the fused code predictor (one code per
// pass) and the standalone sample_rows entry (sampler.cu).
//
// Replaces the sampler the Pallas kernels run in their bodies
// (qwen3tts_tpu/ops/kernel_prng.py:78 gumbel_noise, :91 make_sampler), with
// the same semantics: greedy = first-max argmax; else temperature ->
// top-k threshold by a 30-step bisection on the value range (ties kept) ->
// top-p threshold by a 20-step bisection on the probability (only when
// use_top_p; kept wholesale when top_p >= 1) -> argmax(l + Gumbel noise).
// The noise is a murmur3-finalizer hash of (seed, step, vocab slot) in
// uint32, bit-identical to the JAX and plain PyTorch versions.
//
// One thread block samples one row. The row lives in shared memory for the
// whole chain: the cost is 50 block-wide reductions of a 2-3K-element row,
// a few microseconds of latency, and no device-memory traffic beyond the
// row itself.
#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t murmur_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float gumbel(uint32_t seed, uint32_t step, uint32_t slot) {
  const uint32_t base = seed + step * 0x9E3779B9u;
  const uint32_t x = murmur_mix(murmur_mix(slot + base * 0x85EBCA6Bu) ^ base);
  const float u = (float)(x >> 8) * (1.0f / 16777216.0f) + 1e-12f;
  return -logf(-logf(u));
}

// Sample from l[0:V) (shared memory; overwritten). p is shared scratch of V
// floats, red 32 floats, redi 32 ints. Every thread returns the token.
__device__ int sample_row(float* l, float* p, int V, float temp, float top_p,
                          int top_k, bool greedy, bool use_top_p, int seed,
                          int step, float* red, int* redi) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (greedy) {
    float bv = -3.4e38f; int bi = 0x7fffffff;
    for (int i = tid; i < V; i += nt) argmax_pick(bv, bi, l[i], i);
    return block_argmax(bv, bi, red, redi);
  }
  const float inv_t = 1.0f / fmaxf(temp, 1e-6f);
  float lmin = 3.4e38f, lmax = -3.4e38f;
  for (int i = tid; i < V; i += nt) {
    const float v = l[i] * inv_t;
    l[i] = v;
    lmin = fminf(lmin, v);
    lmax = fmaxf(lmax, v);
  }
  if (top_k > 0 && top_k < V) {
    float lo = block_min(lmin, red) - 1.0f;
    float hi = block_max(lmax, red);
    for (int it = 0; it < 30; ++it) {
      const float mid = 0.5f * (lo + hi);
      int c = 0;
      for (int i = tid; i < V; i += nt) c += l[i] >= mid;
      const bool take = block_count(c, redi) >= top_k;
      lo = take ? mid : lo;
      hi = take ? hi : mid;
    }
    for (int i = tid; i < V; i += nt) l[i] = l[i] >= lo ? l[i] : kNegInf;
    __syncthreads();
  }
  if (use_top_p) {
    float m = -3.4e38f;
    for (int i = tid; i < V; i += nt) m = fmaxf(m, l[i]);
    m = block_max(m, red);
    float s = 0.f;
    for (int i = tid; i < V; i += nt) { const float e = expf(l[i] - m); p[i] = e; s += e; }
    s = block_sum(s, red);
    float pmax = 0.f;
    for (int i = tid; i < V; i += nt) { const float q = p[i] / s; p[i] = q; pmax = fmaxf(pmax, q); }
    float hi = block_max(pmax, red), lo = 0.f;
    for (int it = 0; it < 20; ++it) {
      const float mid = 0.5f * (lo + hi);
      float mass = 0.f;
      for (int i = tid; i < V; i += nt) mass += p[i] >= mid ? p[i] : 0.f;
      const bool take = block_sum(mass, red) >= top_p;
      lo = take ? mid : lo;
      hi = take ? hi : mid;
    }
    for (int i = tid; i < V; i += nt)
      if (!(top_p >= 1.0f || p[i] >= lo)) l[i] = kNegInf;
    __syncthreads();
  }
  float bv = -3.4e38f; int bi = 0x7fffffff;
  for (int i = tid; i < V; i += nt)
    argmax_pick(bv, bi, l[i] + gumbel((uint32_t)seed, (uint32_t)step, (uint32_t)i), i);
  return block_argmax(bv, bi, red, redi);
}

// The cb0 epilogue of the talker step, also used by sample_rows: suppress
// [suppress_start, V) except eos_id, HF repetition penalty over seen (when
// not null), then sample. l is shared memory holding the logits.
__device__ int suppress_penalize_sample(
    float* l, float* p, int V, int suppress_start, int eos_id,
    const int8_t* seen, float penalty, float temp, float top_p, int top_k,
    bool greedy, bool use_top_p, int seed, int step, float* red, int* redi) {
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    float v = l[i];
    if (i >= suppress_start && i != eos_id) v = kNegInf;
    if (seen != nullptr && seen[i] != 0) v = v > 0.f ? v / penalty : v * penalty;
    l[i] = v;
  }
  __syncthreads();
  return sample_row(l, p, V, temp, top_p, top_k, greedy, use_top_p, seed, step, red, redi);
}

}  // namespace
