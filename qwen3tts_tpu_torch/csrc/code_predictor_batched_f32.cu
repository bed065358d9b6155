// K6 over float32 heads, embeddings and K/V scratch (the float32 tier,
// RuntimeConfig(dtype="float32", quant="int8")): the persistent kernel of
// code_predictor_persistent.cuh with T = float, for code_predictor_batched.cu
// (which says what K6 replaces and what bounds it). A translation unit of
// its own only so that it compiles beside the bf16 one: one file held both
// in 107 s on the H100's host, the other sources in at most 44 s.
#include "code_predictor_persistent.cuh"

// params: a CpParams (code_predictor_persistent.cuh) that
// qtts_code_predictor_batched filled; the launch's or the grid query's
// cudaError_t.
extern "C" int qtts_cp_batched_launch_f32(const void* params, int B, void* stream) {
  return cp_by_lanes<float, CpLaunch>(B, *static_cast<const CpParams*>(params),
                                      (cudaStream_t)stream);
}

extern "C" int qtts_cp_batched_grid_f32(const void* params, int B, void* out) {
  return cp_by_lanes<float, CpGrid>(B, *static_cast<const CpParams*>(params), (int*)out);
}
