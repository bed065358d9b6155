// K4: the counter-hash sampler as __device__ code, shared by the fused
// talker step (its cb0 epilogue, head_sample_kernel in layer.cuh), the
// fused code predictor (one code per pass, cp_sample) and the standalone
// sample_rows entry (sampler.cu).
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
// One thread block samples one row, and the work is a chain of decisions:
// its time is the number of block-wide exchanges and what a thread does
// between them. The design:
// - The row lives in registers, EPT elements a thread: slot k holds
//   element (k / P) * NT * P + tid * P + k % P (P contiguous elements a
//   load). A wider row than NT * EPT is refused by the C entries.
// - The prologue (suppression, penalty, temperature) and the row's min and
//   max are one pass and one exchange (__reduce_min_sync /
//   __reduce_max_sync on the order-preserving integer image of the floats).
// - Each bisection runs in rounds of kSampleLevels (M) steps. From the
//   round's (lo, hi) every thread builds, in registers, the same binary tree
//   of the 2^M - 1 midpoints the next M steps could take, by the sequential
//   steps' float operations (node j's lo and hi are its in-order
//   neighbours at its depth), sorted along the in-order. Top-k: each
//   element between the first and the last midpoint finds its bin among
//   them by M compares (a select tree picks each compare's node), the
//   compares' ballots slice the warp's bins, lane v counts the warp's
//   elements in bins v and above, and one exchange sums the warps' counts:
//   every midpoint's count(l >= mid). The count does not grow along the
//   in-order, so the M steps take exactly the midpoints whose count
//   reaches top_k: a ballot's popcount b, and the new (lo, hi) are
//   midpoints b and b + 1. Counts are integers, so lo is the sequential
//   bisection's bit for bit. The same exchange brings the round's start
//   interval's least and largest element; where they decide every step
//   left, those steps run without counting (topk_finish). Top-p: each
//   thread sums, for every candidate, its probabilities at or above it in
//   slot order; a warp transposes and sums the partials (lane j ends with
//   candidate j's) and one exchange sums the warps' in warp order: one
//   fixed order per candidate, and a mass that does not grow along the
//   in-order either (rounded sums of non-increasing terms in a fixed
//   order).
// - The noise only where it can change a score: an element at or below
//   kNegInf (filtered, suppressed) keeps its value as its score, which is
//   what l + g gives in float32 (|g| < 17, far below half an ulp of 1e30);
//   every score, so the first-max argmax, is the plain version's. The
//   others are queued per warp, so that a warp's lanes share its draws.
// - The argmax: the first maximum of a thread's slots, two warp reductions
//   (the largest key, then the least index holding it) and one exchange.
// Exchanges alternate between two shared buffers, so each takes one
// __syncthreads: exchange n + 2 reuses exchange n's buffer only after every
// warp has passed exchange n + 1's barrier, so has read exchange n's. A
// default-sampled row (temperature > 0, top-k 50, top-p 1) takes at most
// 1 + 30 / M + 1 exchanges (sample_exchanges), where a chain of sequential
// steps takes 33 block reductions; fewer where a round's interval decides
// the steps left without counting (topk_finish).
#pragma once

#include "common.cuh"

namespace {

constexpr int kTopkSteps = 30;     // kernel_prng._BSEARCH_ITERS
constexpr int kToppSteps = 20;     // kernel_prng._TOPP_ITERS
constexpr int kSampleLevels = 5;   // bisection steps one round decides (M)
static_assert(kSampleLevels >= 1 && kSampleLevels <= 5, "a lane holds one midpoint");

// The sites' blocks: a codec-head row (K1/K5's head_sample_kernel, kHeadThreads
// threads, rows up to kMaxCodecVocab) and a code's row (K2/K6's cp_sample on
// the code predictor's block of kCodeThreads, rows up to kMaxCodeVocab).
constexpr int kHeadThreads = 512;
constexpr int kMaxCodecVocab = 3072;
constexpr int kCodeThreads = 256;
constexpr int kMaxCodeVocab = 2048;

__host__ __device__ constexpr int sample_rounds(int steps) {
  return (steps + kSampleLevels - 1) / kSampleLevels;
}

// Block-wide exchanges of one row at most: greedy, or sampled with the
// top-k stage (0 < top_k < V) and the top-p stage (use_top_p and top_p < 1)
// or not.
__host__ __device__ constexpr int sample_exchanges(bool greedy, bool topk, bool topp) {
  return greedy ? 1
                : (topk || topp ? 1 : 0) + (topk ? sample_rounds(kTopkSteps) : 0) +
                      (topp ? 1 + sample_rounds(kToppSteps) : 0) + 1;
}

// Shared scratch of a block of NT threads: two exchange buffers of a word
// a lane and of a round's stats a warp. The sampler also takes a queue in
// shared memory where each warp puts the (value, index) pairs that draw
// noise: NT * EPT float2 for EPT elements a thread (sample_queue_floats
// floats), the caller's, free while it samples.
template <int NT>
struct SampleSmem {
  uint32_t buf[2][NT / 32][32];
  uint32_t stat[2][NT / 32][4];
};

template <int NT, int EPT>
constexpr int sample_queue_floats() { return 2 * NT * EPT; }

// What a top-k round learns of its start interval [lo, hi): the least and
// the largest element in it (as float_key; none: min > max) and the
// elements at or above hi.
struct IntervalStats {
  uint32_t kmin, kmax;
  int above;
};

// The sampling parameters of one row.
struct SampleArgs {
  float temp, top_p, penalty;
  int top_k, suppress_start, eos_id;
  bool greedy, use_top_p;
  uint32_t seed, step;
  const int8_t* seen;   // the row's seen-set [V], or null (no penalty)
};

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

// The order-preserving unsigned image of a float (-0 taken as +0, as float
// comparisons take it) and back.
__device__ __forceinline__ uint32_t float_key(float f) {
  const uint32_t u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ uint32_t to_word(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t to_word(float v) { return __float_as_uint(v); }
template <typename T> __device__ __forceinline__ T from_word(uint32_t w);
template <> __device__ __forceinline__ uint32_t from_word<uint32_t>(uint32_t w) { return w; }
template <> __device__ __forceinline__ float from_word<float>(uint32_t w) {
  return __uint_as_float(w);
}

template <int NT, int P>
__device__ __forceinline__ int slot_index(int k) {
  return (k / P) * (NT * P) + (int)threadIdx.x * P + k % P;
}

// Every lane's v summed over the block's warps in warp order; every thread
// gets its lane's sum.
template <int NT, typename T>
__device__ __forceinline__ T exchange_sum(T v, SampleSmem<NT>& sm, int& ph) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  sm.buf[ph][w][lane] = to_word(v);
  __syncthreads();
  T a = 0;
#pragma unroll
  for (int u = 0; u < NT / 32; ++u) a += from_word<T>(sm.buf[ph][u][lane]);
  ph ^= 1;
  return a;
}

// The sum of every thread's v in a fixed order (each warp's xor butterfly,
// then the warps' sums by the same butterfly); every thread gets it.
template <int NT>
__device__ __forceinline__ float block_sum_fixed(float v, SampleSmem<NT>& sm, int& ph) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) sm.buf[ph][w][0] = __float_as_uint(v);
  __syncthreads();
  v = lane < NT / 32 ? __uint_as_float(sm.buf[ph][lane][0]) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  ph ^= 1;
  return v;
}

// Lane l gets the warp's sum of v[l] (a transposing butterfly: 31 shuffles).
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = up ? v[i] : v[i + o];
      const float keep = up ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return v[0];
}

// The in-order nodes of the tree of LV bisection steps from t[0] = lo and
// t[2^LV] = hi, in registers: node j at depth d (an odd multiple of
// 2^(LV-1-d)) is the midpoint of t[j - 2^(LV-1-d)] and t[j + 2^(LV-1-d)],
// the lo and hi the sequential steps hold when they reach it, by their
// float operations. A node lies between its in-order neighbours, so the
// nodes are sorted. (Template recursion keeps every index a constant, so
// the nodes stay in registers.)
template <int LV, int D = 0>
__device__ __forceinline__ void tree_nodes(float (&t)[(1 << LV) + 1]) {
  if constexpr (D < LV) {
    constexpr int half = (1 << LV) >> (D + 1);
#pragma unroll
    for (int j = half; j < (1 << LV); j += 2 * half) t[j] = 0.5f * (t[j - half] + t[j + half]);
    tree_nodes<LV, D + 1>(t);
  }
}

// Narrow the candidates cand[0, 2^(E+1)) by the compares c[E], c[E-1], ..,
// c[0] (the last compare picks between neighbours) to cand[0].
template <int LV, int E>
__device__ __forceinline__ void narrow(float (&cand)[1 << LV], const bool (&c)[LV]) {
  if constexpr (E >= 0) {
#pragma unroll
    for (int i = 0; i < (1 << E); ++i) cand[i] = c[E] ? cand[2 * i + 1] : cand[2 * i];
    narrow<LV, E - 1>(cand, c);
  }
}

// The search of v from depth D on: compare v with the depth-D node that the
// compares above it chose (a select tree over them), ballot the compare.
template <int LV, int D = 0>
__device__ __forceinline__ void search(float v, const float (&t)[(1 << LV) + 1], bool (&c)[LV],
                                       uint32_t (&bits)[LV]) {
  if constexpr (D < LV) {
    constexpr int half = (1 << LV) >> (D + 1);
    float cand[1 << LV];
#pragma unroll
    for (int i = 0; i < (1 << D); ++i) cand[i] = t[i * 2 * half + half];
    narrow<LV, D - 1>(cand, c);
    c[D] = v >= cand[0];
    bits[D] = __ballot_sync(0xffffffffu, c[D]);
    search<LV, D + 1>(v, t, c, bits);
  }
}

// t[j] for 0 <= j <= 2^LV (a select tree over j's bits).
template <int LV>
__device__ __forceinline__ float pick(const float (&t)[(1 << LV) + 1], int j) {
  float cand[1 << LV];
  bool c[LV];
#pragma unroll
  for (int i = 0; i < (1 << LV); ++i) cand[i] = t[i];
#pragma unroll
  for (int d = 0; d < LV; ++d) c[d] = (j >> (LV - 1 - d)) & 1;
  narrow<LV, LV - 1>(cand, c);
  return j == (1 << LV) ? t[1 << LV] : cand[0];
}

// One top-k round of LV steps over the row x: count(x >= mid) for every
// midpoint of the tree, then the steps' decisions (see the header). An
// element's bin is the number of midpoints at or below it; LV compares find
// it, each against the node that a select tree picks by the compares before
// it (registers only, so the elements' searches overlap), and the compares'
// ballots are the warp's bins, bit-sliced. Lane v counts the warp's
// elements in bins v and above by comparing the slices with v's bits. Only
// the elements between the first and the last midpoint are searched (a
// slot whose warp holds none is skipped): the others lie below every
// midpoint or at or above all of them, and the latter are counted apart.
// (Where the cb0 suppression's -1e30 stretches the range, as the JAX
// kernels' bisection keeps it, every unsuppressed logit lies above the last
// midpoint, and whole rounds skip the search.)
template <int NT, int EPT, int LV>
__device__ __forceinline__ void topk_round(const float (&x)[EPT], int top_k, float& lo,
                                           float& hi, SampleSmem<NT>& sm, int& ph,
                                           IntervalStats& st) {
  constexpr int N = 1 << LV;
  static_assert(N <= 32, "a lane holds one midpoint's count");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t smin = 0xffffffffu, smax = 0u, above = 0u;   // the start interval's
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const bool inside = x[k] >= lo && x[k] < hi;
    smin = inside ? min(smin, float_key(x[k])) : smin;
    smax = inside ? max(smax, float_key(x[k])) : smax;
    above += x[k] >= hi;
  }
  smin = __reduce_min_sync(0xffffffffu, smin);
  smax = __reduce_max_sync(0xffffffffu, smax);
  above = __reduce_add_sync(0xffffffffu, above);
  if (lane == 0) {
    sm.stat[ph][w][0] = smin;
    sm.stat[ph][w][1] = smax;
    sm.stat[ph][w][2] = above;
  }
  float t[N + 1];
  t[0] = lo;
  t[N] = hi;
  tree_nodes<LV>(t);
  // the warp's elements between the first and the last midpoint, and at or
  // above the last (above every midpoint)
  uint32_t in[EPT], up[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    in[k] = __ballot_sync(0xffffffffu, x[k] >= t[1] && x[k] < t[N - 1]);
    up[k] = __ballot_sync(0xffffffffu, x[k] >= t[N - 1]);
  }
  uint32_t cnt = 0;   // the warp's elements at or above midpoint `lane`
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    cnt += __popc(up[k]);
    if (in[k] != 0) {
      bool c[LV];
      uint32_t bits[LV];   // bits[d]: the warp's compares at depth d (bin bit LV-1-d)
      search<LV>(x[k], t, c, bits);
      uint32_t ge = 0, eq = in[k];
#pragma unroll
      for (int d = 0; d < LV; ++d) {   // bin >= lane, from the top bit down
        const uint32_t one = ((lane >> (LV - 1 - d)) & 1) ? 0xffffffffu : 0u;
        ge |= eq & bits[d] & ~one;
        eq &= ~(bits[d] ^ one);
      }
      cnt += __popc(ge | eq);
    }
  }
  const int q = ph;   // the exchange's buffers, the counts' and the stats'
  cnt = exchange_sum<NT>(cnt, sm, ph);
  const bool lead = lane < NT / 32;
  st.kmin = __reduce_min_sync(0xffffffffu, lead ? sm.stat[q][lane][0] : 0xffffffffu);
  st.kmax = __reduce_max_sync(0xffffffffu, lead ? sm.stat[q][lane][1] : 0u);
  st.above = (int)__reduce_add_sync(0xffffffffu, lead ? sm.stat[q][lane][2] : 0u);
  const int taken = __popc(__ballot_sync(0xffffffffu, lane >= 1 && lane < N && (int)cnt >= top_k));
  lo = pick<LV>(t, taken);
  hi = pick<LV>(t, taken + 1);
}

// The remaining `steps` top-k steps from (lo, hi) without counting, where
// the stats of an interval that holds (lo, hi) decide them all: a midpoint
// at or below the interval's least element counts every element from lo
// up, so it is taken (lo's count reaches top_k: lo only takes midpoints
// that reach it, or is the row's min - 1); a midpoint above its largest
// element counts the elements at or above its hi, so it is taken when
// those reach top_k. A midpoint in between is undecided: returns false,
// and (lo, hi) stay as they were. Exact: the sequential steps take the
// same midpoints.
__device__ __forceinline__ bool topk_finish(float& lo, float& hi, const IntervalStats& st,
                                            int top_k, int steps) {
  const float smin = st.kmin <= st.kmax ? key_float(st.kmin) : INFINITY;
  const float smax = st.kmin <= st.kmax ? key_float(st.kmax) : -INFINITY;
  const bool take_above = st.above >= top_k;
  float a = lo, c = hi;
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    const float mid = 0.5f * (a + c);
    if (!(mid <= smin) && !(mid > smax)) return false;
    const bool take = mid <= smin || take_above;
    a = take ? mid : a;
    c = take ? c : mid;
  }
  lo = a;
  hi = c;
  return true;
}

// One top-p round of LV steps over the probabilities p: every candidate's
// mass, then the steps' decisions (see the header).
template <int NT, int EPT, int LV>
__device__ __forceinline__ void topp_round(const float (&p)[EPT], float top_p, float& lo,
                                           float& hi, SampleSmem<NT>& sm, int& ph) {
  constexpr int N = 1 << LV;
  static_assert(N <= 32, "a lane holds one candidate's mass");
  const int lane = threadIdx.x & 31;
  float t[N + 1];
  t[0] = lo;
  t[N] = hi;
  tree_nodes<LV>(t);
  float acc[32];   // candidate j's partial at acc[j] (slots in order); node 0 is none
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float a = 0.f;
    if (j >= 1 && j < N) {
#pragma unroll
      for (int k = 0; k < EPT; ++k) a += p[k] >= t[j] ? p[k] : 0.f;
    }
    acc[j] = a;
  }
  const float m = exchange_sum<NT>(warp_transpose_sum(acc), sm, ph);
  const int taken = __popc(__ballot_sync(0xffffffffu, lane >= 1 && lane < N && m >= top_p));
  lo = pick<LV>(t, taken);
  hi = pick<LV>(t, taken + 1);
}

// STEPS bisection steps in rounds of kSampleLevels, the last one shorter.
// After each round, the steps left are finished without counting when the
// stats of the round's start interval decide them all (topk_finish).
template <int NT, int EPT, int STEPS>
__device__ __forceinline__ void topk_bisect(const float (&x)[EPT], int top_k, float& lo,
                                            float& hi, SampleSmem<NT>& sm, int& ph) {
  IntervalStats st;
#pragma unroll 1
  for (int r = 0; r < STEPS / kSampleLevels; ++r) {
    topk_round<NT, EPT, kSampleLevels>(x, top_k, lo, hi, sm, ph, st);
    if (topk_finish(lo, hi, st, top_k, STEPS - (r + 1) * kSampleLevels)) return;
  }
  if constexpr (STEPS % kSampleLevels != 0)
    topk_round<NT, EPT, STEPS % kSampleLevels>(x, top_k, lo, hi, sm, ph, st);
}

template <int NT, int EPT, int STEPS>
__device__ __forceinline__ void topp_bisect(const float (&p)[EPT], float top_p, float& lo,
                                            float& hi, SampleSmem<NT>& sm, int& ph) {
#pragma unroll 1
  for (int r = 0; r < STEPS / kSampleLevels; ++r)
    topp_round<NT, EPT, kSampleLevels>(p, top_p, lo, hi, sm, ph);
  if constexpr (STEPS % kSampleLevels != 0)
    topp_round<NT, EPT, STEPS % kSampleLevels>(p, top_p, lo, hi, sm, ph);
}

// The block's first maximum from each thread's candidate (key, index): the
// largest key, then the least index holding it (two warp reductions and
// one exchange). Returns the index.
template <int NT>
__device__ __forceinline__ int block_first_max(uint32_t bk, uint32_t bi,
                                               SampleSmem<NT>& sm, int& ph) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t km = __reduce_max_sync(0xffffffffu, bk);
  uint32_t im = __reduce_min_sync(0xffffffffu, bk == km ? bi : 0xffffffffu);
  if (lane == 0) {
    sm.buf[ph][w][0] = km;
    sm.buf[ph][w][1] = im;
  }
  __syncthreads();
  bk = lane < NT / 32 ? sm.buf[ph][lane][0] : 0u;
  bi = lane < NT / 32 ? sm.buf[ph][lane][1] : 0xffffffffu;
  ph ^= 1;
  km = __reduce_max_sync(0xffffffffu, bk);
  return (int)__reduce_min_sync(0xffffffffu, bk == km ? bi : 0xffffffffu);
}

// The first maximum of x over the block (greedy): its element index.
template <int NT, int EPT, int P>
__device__ __forceinline__ int row_argmax(const float (&x)[EPT], SampleSmem<NT>& sm,
                                          int& ph) {
  uint32_t bk = 0, bi = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < EPT; ++k) {   // slots in increasing index
    const uint32_t key = float_key(x[k]);
    bi = key > bk ? (uint32_t)slot_index<NT, P>(k) : bi;
    bk = key > bk ? key : bk;
  }
  return block_first_max<NT>(bk, bi, sm, ph);
}

// The first maximum of x + Gumbel noise. The elements above kNegInf (those
// whose score the noise can change) are queued per warp, and the warp's
// lanes draw the queue's noise in turn whichever slots the elements came
// from (a code predictor's row keeps ~50 of 2048); every other element's
// score is its value, below every queued score.
template <int NT, int EPT, int P>
__device__ __forceinline__ int noisy_argmax(const float (&x)[EPT], uint32_t seed,
                                            uint32_t step, SampleSmem<NT>& sm,
                                            float2* queue, int& ph) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float2* q = queue + w * 32 * EPT;
  uint32_t bk = 0, bi = 0xffffffffu;
  int n = 0;
#pragma unroll
  for (int k = 0; k < EPT; ++k) {   // slots in increasing index
    const bool draw = x[k] > kNegInf;
    const uint32_t m = __ballot_sync(0xffffffffu, draw);
    const uint32_t idx = (uint32_t)slot_index<NT, P>(k);
    if (draw) q[n + __popc(m & ((1u << lane) - 1u))] = make_float2(x[k], __uint_as_float(idx));
    const uint32_t key = draw ? 0u : float_key(x[k]);
    bi = key > bk ? idx : bi;
    bk = key > bk ? key : bk;
    n += __popc(m);
  }
  __syncwarp();
  // the queue's order does not matter (ties go to the least index); up to
  // four draws in flight a lane
  int e = lane;
  for (; e + 96 < n; e += 128) {
    uint32_t key[4], idx[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 v = q[e + 32 * u];
      idx[u] = __float_as_uint(v.y);
      key[u] = float_key(v.x + gumbel(seed, step, idx[u]));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      bi = key[u] > bk || (key[u] == bk && idx[u] < bi) ? idx[u] : bi;
      bk = key[u] > bk ? key[u] : bk;
    }
  }
  for (; e < n; e += 32) {
    const float2 v = q[e];
    const uint32_t idx = __float_as_uint(v.y);
    const uint32_t key = float_key(v.x + gumbel(seed, step, idx));
    bi = key > bk || (key == bk && idx < bi) ? idx : bi;
    bk = key > bk ? key : bk;
  }
  return block_first_max<NT>(bk, bi, sm, ph);
}

// Sample one row held in registers (x: the logits of slots k, see the
// header; overwritten): suppress [suppress_start, V) except eos_id, apply
// the repetition penalty over seen, then sample. Every thread returns the
// token. NT = blockDim.x; a barrier must separate two calls of a block.
template <int NT, int EPT, int P>
__device__ __forceinline__ int suppress_penalize_sample(float (&x)[EPT], int V,
                                                        const SampleArgs& a,
                                                        SampleSmem<NT>& sm,
                                                        float2* queue) {
  static_assert(NT % 32 == 0 && NT <= 1024 && EPT % P == 0, "sampler block shape");
  int ph = 0;
  const float inv_t = 1.0f / fmaxf(a.temp, 1e-6f);
  uint32_t kmin = 0xffffffffu, kmax = 0u;
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int i = slot_index<NT, P>(k);
    float v = -INFINITY;   // past the row: below every midpoint, never the maximum
    if (i < V) {
      v = x[k];
      if (i >= a.suppress_start && i != a.eos_id) v = kNegInf;
      if (a.seen != nullptr && a.seen[i] != 0) v = v > 0.f ? v / a.penalty : v * a.penalty;
      if (!a.greedy) v = v * inv_t;
      kmin = min(kmin, float_key(v));
      kmax = max(kmax, float_key(v));
    }
    x[k] = v;
  }
  if (a.greedy) return row_argmax<NT, EPT, P>(x, sm, ph);
  const bool topk = a.top_k > 0 && a.top_k < V;
  const bool topp = a.use_top_p && !(a.top_p >= 1.0f);
  if (topk || topp) {   // the row's min and max: one exchange
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    if (lane == 0) {
      sm.buf[ph][w][0] = kmin;
      sm.buf[ph][w][1] = kmax;
    }
    __syncthreads();
    kmin = __reduce_min_sync(0xffffffffu, lane < NT / 32 ? sm.buf[ph][lane][0] : 0xffffffffu);
    kmax = __reduce_max_sync(0xffffffffu, lane < NT / 32 ? sm.buf[ph][lane][1] : 0u);
    ph ^= 1;
  }
  if (topk) {
    float lo = key_float(kmin) - 1.0f, hi = key_float(kmax);
    topk_bisect<NT, EPT, kTopkSteps>(x, a.top_k, lo, hi, sm, ph);
#pragma unroll
    for (int k = 0; k < EPT; ++k)
      if (slot_index<NT, P>(k) < V && !(x[k] >= lo)) x[k] = kNegInf;
  }
  if (topp) {
    // the row's maximum survives the top-k stage (lo only takes midpoints
    // that at least one element reaches), so it is the prologue's; its
    // exp is 1, so the largest probability is 1 / sum
    const float m = key_float(kmax);
    float p[EPT], s = 0.f;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      p[k] = expf(x[k] - m);
      s += p[k];
    }
    s = block_sum_fixed<NT>(s, sm, ph);
#pragma unroll
    for (int k = 0; k < EPT; ++k) p[k] = p[k] / s;
    float lo = 0.f, hi = 1.0f / s;
    topp_bisect<NT, EPT, kToppSteps>(p, a.top_p, lo, hi, sm, ph);
#pragma unroll
    for (int k = 0; k < EPT; ++k)
      if (slot_index<NT, P>(k) < V && !(p[k] >= lo)) x[k] = kNegInf;
  }
  return noisy_argmax<NT, EPT, P>(x, a.seed, a.step, sm, queue, ph);
}

// Sample one row without suppression or penalty (the code predictor's).
template <int NT, int EPT, int P>
__device__ __forceinline__ int sample_row(float (&x)[EPT], int V, float temp, float top_p, int top_k,
                          bool greedy, bool use_top_p, int seed, int step,
                          SampleSmem<NT>& sm, float2* queue) {
  const SampleArgs a{temp, top_p, 1.0f, top_k, V, -1, greedy, use_top_p,
                     (uint32_t)seed, (uint32_t)step, nullptr};
  return suppress_penalize_sample<NT, EPT, P>(x, V, a, sm, queue);
}

}  // namespace
