#!/usr/bin/env python3
"""Drive the port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py            # needs one CUDA device

Phases (each prints a line; any failure exits non-zero):
  1. device: torch's device name and count, nvidia-smi's name and power limit;
  2. build: compiles the CUDA kernels (qwen3tts_tpu_torch/csrc) with nvcc
     and the GGUF reader's host library (qwen3tts_tpu_torch/native) with g++;
  3. kernels: each kernel against its plain PyTorch version on the card, on
     the same inputs, at the main paths' full 0.6B widths, with the stated
     tolerance, and both timed with CUDA events after a warm-up; beside
     each time, the least time the card could take for the same work. K4
     (check_sampler) on 64 rows of each width it samples, of sampler_rows'
     adversarial kinds, greedy, top-k and top-k + top-p with per-row
     parameters (tokens equal), with its block-wide exchanges a row and its
     time inside K1, K5, K2 and K6 (sampler_sites). K1
     and K5 run in every weight mode, each on its tier's weights: w8a8
     (int8), bf16 (the default tier), the q4 tier's mixed tuple and w4bf16
     (q4pure); the new modes must agree with their plain versions to 0.0 in
     the hidden state and the K/V rows over 2 layers. K5 also with the
     operands of continuous serving (B = 64, C = 1024, n_past = 600: per-lane
     starts over [0, n_past], one lane at n_past, and per-lane sampling
     parameters; 0.0 over 2 layers, cb0 equal in every lane; timed beside K5
     without start) and K6 with per-lane temperature and top-p (codes
     equal). K1 and K5 over the int8-KV tier's (q, scale) cache
     (check_talker_step_kv_int8): over 2 layers and at full depth, hidden
     0.0 and the whole (q, scale) cache bit for bit after the step, cb0
     equal; timed beside their bf16-KV times at K1 C = 4352, n_past 300 and
     4000, K5 B = 16, C = 4352, n_past = 4000 and B = 64, C = 512, n_past =
     300; the cache's bytes and the peak memory of one K5 call at B = 64,
     C = 4352 in both tiers. K2 and K6 (one persistent cooperative kernel
     per call) also report their device time, their grid (blocks, grid
     barriers per call) and the kernels one call launches under the
     profiler: exactly one of the port's library, or the phase fails.
     Decode attention's yardstick (scaled_dot_product_attention) is timed
     by events and by device time at B = 1, C = 1280, n_valid = 300 and B =
     16, C = 4352, n_valid = 4000; decode attention must launch one kernel
     per call under the profiler (launches_per_call), and the kernels' split
     rules must equal their Python mirrors, which the CPU tests hold to
     cover every row once. K1 and K5 report their device busy time (the
     union of their kernels' intervals: K1's chain runs under programmatic
     dependent launch, so intervals overlap), the shares of it of their
     attention stage (attention_device_ms: attn_layer_kernel,
     attn_emit_kernel and, over the int8 cache, kv_row_quant_kernel) and of
     their projections (gemv_device_ms: GEMVs or GEMMs, the head's
     included), the event ms of a call with the profiler attached
     (ms_profiled) and the port's kernels per call (launches_per_call); the
     W8A16 GEMM's yardstick
     torch._weight_int8pack_mm its device time (library_device_ms) at the
     QKV shape (M = 1) and w_down at M = 128, and the GEMM must run as one
     kernel per call in every case. K3 reports its device time per
     decoder width and over the 12 res blocks of a 64-frame clip beside
     cuDNN's two convolutions alone, and must take the plan's launches per
     res block (one at C = 96 and 192, two at 384 and 768); over a group
     of 16 lanes of 64 frames at each width (check_res_block_lanes), every
     lane must equal K3 on that lane alone bit for bit, the group must
     take the plan's launches, and it is timed beside 16 one-lane calls;
     the split rules include K3's and the GEMM's plans. Then the projection kernels
     alone (check_projections: the four talker projections over 28 seeded
     layers in w8a8, bf16 and w4bf16; one layer against its plain version
     at B = 1 (K1's GEMVs) and 16, 64 and 128 (K5's GEMMs), int32 equal or
     float32 bits equal; each 28-layer pass timed by events and device time
     with its weight GB/s, beside its bound and the library call that
     computes the same function, torch._int_mm or float64 torch.matmul,
     reported in K1's or K5's entry of the mode under "projections"), K1's
     codec-head GEMV (check_head_gemv: within 1e-3 of its plain version,
     timed per call beside float32 torch.matmul, in K1's entry as
     "codec_head"), and the split rules include K5's GEMM plan and K1's
     GEMV plan against their mirrors. Then the 4-bit GEMV probe (int8 and
     packed-nibble weights, exact) beside K1's projection kernels at the
     probe's shape. Then the JAX package's random streams (check_prng, a
     `prng` line): the host's keys, splits and bits equal PRNG_GOLDENS; the
     card's threefry over a [16, 3072] field equal to the host's numpy form
     bit for bit and to the goldens; the card's Gumbel field within
     GUMBEL_ULPS of float64 over the same uniforms; the host's key work per
     frame timed for one stream and 64 lanes (after the serve phase's
     requests, a `prng_cost` line sets it beside the int8 sampled 256
     request's ms per frame);
  4. serve, each path with the launch counts set to 0 just before it and
     read just after: one Qwen3TTS(quant="int8", device="cuda") with
     synthetic weights answers three single-stream requests (greedy 64
     tokens; sampled 256; sampled 1500, whose KV capacity exceeds 1024
     rows), each of which must succeed with finite audio of n_frames * 1920
     samples and launch K1, K2, K3 and the W8A16 GEMM (the prefill's
     projections); then two synthesize_batch calls (16 texts greedy, 64
     texts sampled), whose lanes must have finite audio and codes in range,
     which must emit at least 8 frames per lane in all and launch K5, K6, K3
     and the GEMM; then the int8-KV tier on the same weights
     (RuntimeConfig.kv_quant="int8", `serve_kv_int8` lines): the sampled
     1500-token request (C = 2304) and the 64-lane sampled batch, which
     must launch K1[kv_int8] or K5[kv_int8] and no K1/K5 over a bf16 cache;
     then the unfused path on the same weights,
     Qwen3TTS(..., fused_talker=False, fused_cp=False): a greedy 64-token
     request (C = 256: the GEMM, attention in PyTorch), then a sampled
     request of max_audio_tokens=520 and a 16-lane greedy batch of 520
     (both at C = 1280: the GEMM and the decode-attention kernel), which
     must launch the
     GEMM and K3 (the C = 1280 ones also decode attention) and none of K1,
     K2, K5, K6. Then the other weight tiers (TIER_SERVE), each on its own
     Qwen3TTS with the default flags: the bf16 tier is Qwen3TTS() itself
     (two requests and a 16-lane batch through K1/K5 in bf16 mode, K3, and
     no K2, K6 or GEMM: its code predictor is the eager predict_codes), q4
     (a request and a 16-lane batch: K1/K5 mixed, K2/K6, K3, the GEMM) and
     q4pure (a request and a 16-lane batch: K1/K5 w4bf16, K2/K6, K3, no
     GEMM), then one unfused q4 request. Then continuous serving
     (serve_queues, `serve_queue` lines): the JAX bench's mix (48 requests,
     16 lanes, every request at exactly its budget), synthesize_queue on 128
     sampled texts on 64 lanes beside synthesize_batch in two groups of 64,
     a tight greedy queue (16 lanes, C = 384: a compaction, a session reset,
     host mirrors equal to the state, the first fill equal to
     synthesize_batch), the bf16 tier's queue and an unfused queue at C =
     1280; the fused int8 queues must launch K5 with `start`, K6 with
     per-lane sampling and the GEMM and no K1 or K2, the bf16 one K5 with
     `start` in bf16 mode and no K6 or GEMM, the unfused one the GEMM and no
     decode-attention kernel. Then streaming (serve_stream,
     `serve_stream` lines): synthesize_streaming of the sampled 256-token
     request (codes equal to synthesize's, each chunk equal to its window
     vocoded alone, K1, K2, K3 and the GEMM launched, TTFA over nine
     seeds, frames/s beside synthesize's); the 128-text queue on 64 lanes
     with on_audio (codes equal to the same queue's on the serial loop,
     one finish per request, each request's TTFA, frames/s beside the
     queue without on_audio; K5 with start, K6 per lane, K3, the GEMM);
     the 64-lane batch's codes through vocode_batched beside lane by lane
     (each lane within VOCODE_LANE_TOL, both walls, the peak memory); the
     bf16 tier's greedy stream (codes equal to synthesize's). Then the
     random streams on the sampled serves (check_sampled_serves,
     `sampled_serve` lines): on the int8 pipeline and the bf16 tier, the
     same seed twice gives the same codes, and the draws the loop hands K2
     (or the bf16 tier's predict_codes) and K1 each frame equal seed32 of
     the host's split chain from prng_key(seed); in a 16-lane int8
     synthesize_batch (4 lanes on the bf16 tier) lane b's draws equal the
     single stream's from split(prng_key(seed), 16)[b], and the lanes'
     codes beside the single stream's are counted, not gated. Then the
     checkpoint path (serve_checkpoint,
     `serve_checkpoint` lines), in a temporary directory: a full-width
     checkpoint written by tools/hf_fixture.py (BF16 main model, float32
     tokenizer, config.json files; its bytes and write seconds printed);
     Qwen3TTS.from_pretrained of it in the int8 tier (every leaf on the
     card, a sample equal to the written tensors after the layout
     contract; t_load_ms), a sampled 256-token request and a
     synthesize_with_voice from a seeded 10 s WAV (both K1, K2, K3 and
     the GEMM; t_encode_ms; the embedding within 1e-4 relative of the
     CPU's), the bf16 tier's from_pretrained and a greedy 64-token
     request (K1[bf16] and K3, no K2 or GEMM), a Q8_0 GGUF directory
     written from it, load_models and the 256-token request, the CLI
     in-process (-r, --quant int8, --max-tokens 64: rc 0, a 24 kHz WAV of
     K1's launches x 1920 samples) and unload_models. Then, on that
     checkpoint, the parity tools (parity_fullsize, `parity_fullsize`
     lines): the port's verify_stage bars and compare_e2e gates against
     the JAX package's goldens at full width (tests/torch_goldens/
     fullsize, over the fixture of PROVENANCE.json's seed) in float32 (the
     unfused step, K3; no K1/K2), the golden codes teacher-forced per
     codebook (shares gated at TEACHER_FORCED_FLOORS) and vocoded (max abs
     and RMS error gated at VOCODER_GOLDEN_*), each bar and gate printed as
     it passes or fails and any failure fatal; and the checkpoint tools
     (checkpoint_tools, `checkpoint_tools` lines): the converter to q8_0
     (and q4_k_mixed when time allows) with each file's seconds, the
     inspector's audit of each, the load split by stage (parse, tokenizer,
     read + dequantization, host to device, casts, int8 quantization) of
     the q8_0 files through the native and the Python reader beside the
     int8 safetensors load, and the 256-token request served from the
     converted q8_0 files read by NativeGGUF (SINGLE_PATH). Then multi-GPU
     serving (serve_multi_gpu, `multi_gpu` lines): MULTI_GPU_WORLD ranks
     spawned after the kernels were built (NCCL with a card a rank, else
     gloo with every rank on card 0; the backend and each rank's device
     printed), each on the int8 weights: dp = 2 with the fused batched
     loop on each rank's 8 of 16 sampled lanes (its lanes equal bit for
     bit a single-process batch of the same lanes with the same keys, the
     codes gathered in lane order equal on every rank, its lanes vocoded
     by vocode_batched_groups and the audio gathered and finite); tp = 2
     on the unfused greedy step at C = 1280, teacher-forced against the
     unsharded run for 8 frames (frame 0's codes equal, every step's
     logits within TP_LOGITS_COS_FLOOR by cosine); a continuous queue on
     dp = 2 whose requests emit exactly their budgets (the share of frames
     equal to the unsharded scheduler's reported); each rank must launch
     K5, K6, K3, the GEMM and decode attention, and neither K1 nor K2, and
     holds the GEMM and decode attention against their plain versions at
     every shape its paths gave them (CallShapes: a tp shard's wo and
     w_down with float32 x, its local heads; a dp rank's rows);
     ms per frame-set beside the single-process figures. No path may
     launch K1/K5 in another tier's mode. K4's
     standalone entry (sample_rows) has no caller on a serve path: frame 0's
     codebook-0 token is drawn by the PyTorch sampler with the JAX
     package's exact top-k, and K4's device code runs inside K1, K2, K5 and
     K6; the kernel phase still holds it against its plain version; the
     probe is off every path. Then serving under load (serve_load,
     `serve_load` lines), the port's serving tools at reduced size on the
     int8 pipeline: benchmark_continuous's lognormal mix (64 requests,
     budgets 24-128) through the continuous scheduler and the
     length-sorted static batches on 16 lanes; the same requests as a
     Poisson trace at 0.7 of that continuous run's frames/s through
     benchmark_arrivals' online continuous and static servers; the
     streamed queue of benchmark_streaming_load (32 requests on 16 lanes).
     Every request emits exactly its budget (the streamed queue, which
     keeps EOS, at most its budget), with one first-codes event and one
     finish; every latency percentile is finite; the continuous runs
     launch K5 with `start`, K6 per lane and the GEMM and no K1 or K2, the
     static runs K5, K6 and the GEMM without `start`, the streamed queue
     also K3; the arrivals run's codes are reported beside the offline
     run's as shares equal. Then quality (quality, `quality` lines):
     check_quant_cosine's prefill-logits cosines of int8, q4 and q4pure
     against bf16 at full width on the bf16 tier's weights, gated on the
     JAX tool's bars (0.99, 0.97, 0.90); ab_kv_int8 single stream over 256
     frames (K1 and K1[kv_int8] with K2) and at 16 lanes (K5 and
     K5[kv_int8] with K6): equal frame counts, codes in range, the match
     rate and frame-exact share reported. Then trace (trace_request, a
     `trace` line): utils/profiling.trace around the greedy 64-token
     request inside annotate("request"); the one trace file written must
     name the region and K1's and K2's kernels;
  5. profile: the sampled 256-token request, the 16-lane batch, the
     unfused 64-token request, the bf16 tier's sampled request and the
     128-text sampled queue again,
     under torch.profiler with device activity only; prints the device's
     busy time (the union of its kernel and copy intervals), its idle
     share, and the kernels with the most device time in each.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

The phases are plain functions of (config, device) so the CPU tests can run
them at a tiny configuration, where each kernel wrapper runs its plain
version; main() itself refuses to run without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

KERNELS = {
    # name: (wrapper module, wrapper name, source, replaced TPU kernel); a
    # name "wrapper[mode]" is that wrapper's launches in one weight mode
    # (ops/fused_talker_step.mode_label), the bare K1/K5 names their w8a8 mode
    "fused_talker_step": (
        "qwen3tts_tpu_torch.ops.fused_talker_step", "fused_talker_step",
        "qwen3tts_tpu_torch/csrc/talker_step.cu",
        "qwen3tts_tpu/ops/pallas_talker_step.py:387"),
    "fused_predict_codes": (
        "qwen3tts_tpu_torch.ops.fused_code_predictor", "fused_predict_codes",
        "qwen3tts_tpu_torch/csrc/code_predictor.cu",
        "qwen3tts_tpu/ops/pallas_code_predictor.py:260"),
    "fused_res_block": (
        "qwen3tts_tpu_torch.ops.fused_vocoder", "fused_res_block",
        "qwen3tts_tpu_torch/csrc/res_block.cu",
        "qwen3tts_tpu/ops/pallas_vocoder.py:162"),
    "sample_rows": (
        "qwen3tts_tpu_torch.ops.sampling", "sample_rows",
        "qwen3tts_tpu_torch/csrc/sampler.cu",
        "qwen3tts_tpu/ops/kernel_prng.py:91"),
    "fused_talker_step_batched": (
        "qwen3tts_tpu_torch.ops.fused_talker_step", "fused_talker_step_batched",
        "qwen3tts_tpu_torch/csrc/talker_step_batched.cu",
        "qwen3tts_tpu/ops/pallas_talker_step.py:1604"),
    "fused_predict_codes_batched": (
        "qwen3tts_tpu_torch.ops.fused_code_predictor_batched", "fused_predict_codes_batched",
        "qwen3tts_tpu_torch/csrc/code_predictor_batched.cu",
        "qwen3tts_tpu/ops/pallas_code_predictor_batched.py:235"),
    "decode_attention": (
        "qwen3tts_tpu_torch.ops.decode_attention", "decode_attention_kernel",
        "qwen3tts_tpu_torch/csrc/decode_attention.cu",
        "qwen3tts_tpu/ops/pallas_attention.py:83"),
    "int8_matmul": (
        "qwen3tts_tpu_torch.ops.int8_matmul", "int8_matmul",
        "qwen3tts_tpu_torch/csrc/int8_matmul.cu",
        "qwen3tts_tpu/ops/pallas_int8_matmul.py:47"),
    "w4_gemv_probe": (
        "qwen3tts_tpu_torch.ops.w4_gemv_probe", "w4_gemv_probe",
        "qwen3tts_tpu_torch/csrc/w4_gemv_probe.cu",
        "tools/exp_w4_gemv.py:87"),
}
# the non-w8a8 weight modes of K1 and K5, one entry each; the tier that
# serves each mode (RuntimeConfig.quant)
MODE_TIERS = {"bf16": None, "mixed": "q4", "w4bf16": "q4pure"}
for _mode in MODE_TIERS:
    for _k in ("fused_talker_step", "fused_talker_step_batched"):
        KERNELS[f"{_k}[{_mode}]"] = KERNELS[_k]
# the operands only continuous serving passes (runtime/continuous.py), one
# entry each: K5's launches with `start` (and per-lane sampling), K6's with
# per-lane temperature and top-p (the wrappers' operand_launches)
OPERAND_ENTRIES = {"fused_talker_step_batched[start]": "start",
                   "fused_predict_codes_batched[per_lane]": "per_lane"}
# the int8-KV tier's operand, one entry each for K1 and K5: their launches
# over the (q, scale) cache, which count in no weight mode's entry
KV_INT8_ENTRIES = ("fused_talker_step[kv_int8]", "fused_talker_step_batched[kv_int8]")
OPERAND_ENTRIES.update({name: "kv_int8" for name in KV_INT8_ENTRIES})
for _name in OPERAND_ENTRIES:
    KERNELS[_name] = KERNELS[_name.partition("[")[0]]
# K1's int8-KV operand is the Pallas HBM kernel's (kv_int8 in :564 and :765)
KERNELS["fused_talker_step[kv_int8]"] = KERNELS["fused_talker_step"][:3] + (
    "qwen3tts_tpu/ops/pallas_talker_step.py:980",)
# TPU kernels a kernel replaces besides the one KERNELS names
ALSO_REPLACES = {"decode_attention": "qwen3tts_tpu/ops/pallas_attention.py:201"}
ALSO_REPLACES.update({name: "qwen3tts_tpu/ops/pallas_talker_step.py:980" for name in KERNELS
                      if name.partition("[")[0] == "fused_talker_step"
                      and name not in KV_INT8_ENTRIES})
# K1 and K5 over a bf16 cache, in every weight mode and with `start`
BF16_KV_TALKER = tuple(name for name in KERNELS
                       if name.partition("[")[0] in ("fused_talker_step",
                                                     "fused_talker_step_batched")
                       and name not in KV_INT8_ENTRIES)
# the kernels each main path must launch (K4's standalone entry is on none:
# see the module docstring); the unfused path launches decode attention
# only at KV capacities of 1024 rows and more
SINGLE_PATH = ("fused_talker_step", "fused_predict_codes", "fused_res_block", "int8_matmul")
BATCH_PATH = ("fused_talker_step_batched", "fused_predict_codes_batched", "fused_res_block",
              "int8_matmul")
UNFUSED_PATH = ("int8_matmul", "fused_res_block")
FUSED_ONLY = ("fused_talker_step", "fused_predict_codes", "fused_talker_step_batched",
              "fused_predict_codes_batched") + tuple(OPERAND_ENTRIES) + tuple(
                  f"{k}[{m}]" for m in MODE_TIERS
                  for k in ("fused_talker_step", "fused_talker_step_batched"))
# the continuous scheduler on int8 weights, fused: K5 with `start`, K6 with
# per-lane sampling, the GEMM (the refills' prefill windows); never K1 or K2
QUEUE_PATH = ("fused_talker_step_batched", "fused_talker_step_batched[start]",
              "fused_predict_codes_batched", "fused_predict_codes_batched[per_lane]",
              "int8_matmul")
QUEUE_FORBIDDEN = ("fused_talker_step", "fused_predict_codes")

# the rows K4's device code samples inside the fused kernels, by site
# (k4_rows; K2's and K6's 15 a lane a call run one after another)
K4_ROWS = ("k4_rows[K1]", "k4_rows[K5]", "k4_rows[K2]", "k4_rows[K6]")
COUNT_KEYS = tuple(KERNELS) + K4_ROWS

# NVIDIA H100 SXM data sheet, dense: memory rate and peak operations per
# second by operand type (float32 on the CUDA cores, no TF32; float64 on
# the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12,
                  "f64": 67e12}   # f64: the float64 tensor cores


# The JAX package's random streams (jax 0.9.0, threefry2x32 with
# partitionable counters, x64 off) for seeds 0, 3, -5, 2**31 - 1 and
# 2**32 + 7: the key jax.random.PRNGKey(seed); bits32 = jax.random.bits(key,
# (), "uint32"); frames: the chain key <- split(key, 3)[0] over 8 frames,
# each row (next key, k_cb0, k_cp as 3 x 2 words, bits32(k_cb0),
# bits32(k_cp)); uniform_bits: the first 16 float32 bit patterns in [1, 2)
# of jax.random.uniform's draw of a [3072] field from the key,
# (bits >> 9) | 0x3F800000. tests/test_torch_prng.py holds them to JAX.
PRNG_GOLDENS = {
    0: dict(
        key=(0, 0), bits32=0xf29a4fa7,
        frames=(
            (0x6b200159, 0x99ba4efe, 0x375f238f, 0xcddb151d, 0xf71f4ea9, 0xa20e4081,
             0x01de0365, 0xe706ef41),
            (0xf84e8312, 0x2fef64f3, 0x50afc224, 0x7e1f9c78, 0xa93d9cf0, 0x9315c51c,
             0x1ab2c6af, 0x3a7dfe39),
            (0x28b634de, 0x60d66271, 0xd27b7b07, 0x1bbbc408, 0xefb19f56, 0x8a79961c,
             0x15258749, 0x1afbf28f),
            (0x4261bcc8, 0x503c5210, 0x5bc24216, 0x070c6e87, 0x05a5866e, 0x6a33083a,
             0x02ba9f11, 0x5668dad3),
            (0xeb9c96eb, 0xe49d75ba, 0xfecb63f2, 0xc9786838, 0x893bc3c2, 0x93b8f9f4,
             0x27b4fbc6, 0xf892c906),
            (0x6e0f73e8, 0x5544d40a, 0x41309a55, 0xa982aeb1, 0x43d6e153, 0xacaf10fc,
             0x6be451e8, 0x07c82f3f),
            (0xc8707800, 0x5cb8bf13, 0xe8c62632, 0x3e76ad98, 0xc6a03d68, 0xb8380b38,
             0x6199bf10, 0xa59fdce9),
            (0x480e21bc, 0x27fe39cc, 0xc994b17e, 0x86da44d7, 0x0b5f0902, 0x71b16599,
             0x3a9353a9, 0x54d715cf),
        ),
        uniform_bits=(0x3ff94d27, 0x3ffd421b, 0x3faa8887, 0x3fbbfd54, 0x3fc8f21d, 0x3f952f34,
                      0x3fa7b475, 0x3fd840e6, 0x3fdf960c, 0x3f95e3ce, 0x3ffe2013, 0x3f833c76,
                      0x3fd1ece4, 0x3fc80641, 0x3ff31970, 0x3ff79eed)),
    3: dict(
        key=(0, 3), bits32=0x12f51d7e,
        frames=(
            (0xdd8a639b, 0xcf7f7ee5, 0x7405344b, 0x842f0e8e, 0x3d10ce32, 0x9b32c2ec,
             0x06a7964b, 0x47414215),
            (0x2ba22c5a, 0x299bf09b, 0x55d47019, 0x5e96a52b, 0x7feb6258, 0x302822a8,
             0x61a17bdc, 0x64a4b626),
            (0x8e3d0ff6, 0x49e3f2a4, 0xb1ec3168, 0x3245ea46, 0x8fc951fe, 0x71d694f0,
             0xd16d9655, 0x5aeb9bb1),
            (0x77d2f506, 0x375a59c3, 0x7dc1cedc, 0x40f7c80a, 0xbe88da0c, 0xaae09e92,
             0x2781263a, 0x27e736cc),
            (0x23212714, 0x020ad073, 0xbe63b4fc, 0xf66117ce, 0xcea9d50f, 0x1565c796,
             0xf739cfc9, 0x7a7bd5a3),
            (0x4199014b, 0x30fc9d0a, 0x3e74f545, 0x64caa71e, 0xf6596dc3, 0x3a4b1984,
             0x2c444841, 0x2e902ea1),
            (0xf063aafa, 0xdea07ad5, 0xd5ef913b, 0x99e252ff, 0x42b372bd, 0xa0ec5455,
             0x264bd74e, 0x90698b1c),
            (0xe1a4f2e3, 0x0f4e538a, 0xcaa4472a, 0xbfd6194c, 0x6d603269, 0xbf71755d,
             0xf38cb09c, 0xd6d1fac4),
        ),
        uniform_bits=(0x3f897a8e, 0x3ff8151d, 0x3fd31106, 0x3ffce126, 0x3fa3a1e2, 0x3fca9db7,
                      0x3f8da1f9, 0x3fb0d728, 0x3f9aff3b, 0x3f906111, 0x3fde531b, 0x3f93fc09,
                      0x3fa68444, 0x3fa0e327, 0x3ffc0513, 0x3f8dce49)),
    -5: dict(
        key=(0, 4294967291), bits32=0xad4ea3d7,
        frames=(
            (0x94fd9837, 0x39b33be0, 0xe0028f47, 0xe4b2f3da, 0x5ce9d9a3, 0x5e8815bd,
             0x471d94f1, 0x173a8f23),
            (0x4996f4c2, 0x02b819f8, 0xeb3c038e, 0xb0d498c6, 0x166ed6e2, 0x936a3813,
             0xd7444168, 0x605157f7),
            (0x3b6951b9, 0x8e199968, 0x3477cdf7, 0x7c045231, 0x8fd44a30, 0x7bbdee43,
             0xa178d986, 0xeb298211),
            (0x70dd0442, 0x3579f7bd, 0x7cd31015, 0x2b426752, 0xa6696ecb, 0x5c646188,
             0x29f9f670, 0xb61165f7),
            (0xa6410c53, 0xc5dd2e7c, 0x1b94dee6, 0xf3375d92, 0xe00bd3e8, 0x7247fea0,
             0xc08502a9, 0xa4073312),
            (0x04381fee, 0x2b53d9cb, 0xe2799c87, 0x65e020c2, 0x2da87071, 0x3947000b,
             0x59fd780e, 0xf93a6849),
            (0x1be563cc, 0x374c4610, 0xaefa62e7, 0x92a9e715, 0xc1685b1b, 0x82a8f169,
             0xa1d451ac, 0x5590e124),
            (0x6072d431, 0x6d37405b, 0xa6858f19, 0x6c506edb, 0xec8c06f4, 0x9327f897,
             0x564737be, 0x4bc018b0),
        ),
        uniform_bits=(0x3fd6a751, 0x3f82583e, 0x3f8130e6, 0x3fcf9f1b, 0x3fe38fe9, 0x3fae59e6,
                      0x3fecd8d5, 0x3fc7ba54, 0x3f97bbcc, 0x3f872664, 0x3fc1dfe8, 0x3fb95e58,
                      0x3f890432, 0x3ff48ed2, 0x3fb6c934, 0x3f967bed)),
    2147483647: dict(
        key=(0, 2147483647), bits32=0x32209ba5,
        frames=(
            (0xe8222fe3, 0xda02b446, 0x8e90c653, 0xc734932d, 0x681666d7, 0x3c82a14e,
             0xc5affa5d, 0xd7fe9d57),
            (0xf0c145d5, 0x15f15cdf, 0xe0894c4c, 0x3a6e1e4c, 0xaacd47d6, 0x69dcadf5,
             0xf0ad09e4, 0xd2cb7955),
            (0xbc2a51f6, 0x2cfc08e4, 0xb304298a, 0x3b72096a, 0x44df5f53, 0xee89a82d,
             0xce622d6c, 0x9ea05967),
            (0x3a4afc36, 0x5f47e054, 0xf74fcc20, 0x0986b99d, 0x8ae3252e, 0xc8df7c8d,
             0xdbaf3905, 0x24d537ed),
            (0x231ed31b, 0x0de87943, 0x1926c0e1, 0x451d2b7c, 0x6433dd28, 0xfe6f5059,
             0x37ef003d, 0xaab1ad9c),
            (0x52e92bf9, 0x8f891d15, 0xa7e7e384, 0x8237a450, 0xcde9cd78, 0xa52bb6e0,
             0xf11c20ac, 0xbb3481ae),
            (0xbc43ab06, 0xd42b913e, 0x5b357421, 0xe891cab1, 0x3d4c3a46, 0xf5f16dc7,
             0x34360f3f, 0x039e1046),
            (0x3d18dbc9, 0x3a3a0da7, 0xccce4288, 0x4158c485, 0x17c59155, 0xef86f4e3,
             0xb802f130, 0x431119ce),
        ),
        uniform_bits=(0x3f99104d, 0x3fa4d22a, 0x3faa4a63, 0x3fb13415, 0x3fdb0156, 0x3fe2f3da,
                      0x3f812771, 0x3f8e25ac, 0x3fefa048, 0x3ff1d896, 0x3f93cc6b, 0x3fc844b4,
                      0x3fecc742, 0x3fa9e9d0, 0x3f9972a1, 0x3fc0ad5e)),
    4294967303: dict(
        key=(0, 7), bits32=0xac91290b,
        frames=(
            (0xd817648b, 0x74864d80, 0x0ba028bf, 0xf22056bf, 0x399897a9, 0x741fbe03,
             0xacd58f1f, 0x34bc48e8),
            (0xa32ec77c, 0x7d253859, 0x1fcc2a28, 0x91a6b5e2, 0x7b48f583, 0x37b1d9b0,
             0xfcd103fb, 0x031e7c3c),
            (0x7d775d1b, 0x4d2e3a54, 0x7bfed959, 0xbabb5edb, 0x2937aa79, 0x1bf4d5f6,
             0xd7c8175c, 0xcda23a53),
            (0xa0ee99cf, 0x61daf1e9, 0x25c0db38, 0x573f2f39, 0x4b066eb7, 0xc5eed7ba,
             0xb2ff39b3, 0x05d44e42),
            (0x62aae9c4, 0x1c548a4c, 0x17d7bcf6, 0x6783f0d5, 0x6eaed00e, 0x7c856dc7,
             0x06c6260d, 0x7120d919),
            (0xd63bbc51, 0xe1f38c16, 0x04debdb7, 0x2bffb605, 0x83c7d65f, 0xfcd6c966,
             0xe2db8e63, 0xaa1ef75c),
            (0x3eba77f9, 0xb553edbe, 0x46ea0cc9, 0x18981f19, 0xcbfa9008, 0x342fdb5d,
             0xcadf98c8, 0xebf43c29),
            (0x7c6482b8, 0xe1475d8d, 0x48b83ca2, 0xcfe7eaa9, 0xbe5af194, 0x36789f2f,
             0x80613172, 0x616e55e6),
        ),
        uniform_bits=(0x3fd64894, 0x3ffcc03f, 0x3fa6c394, 0x3fb8d3a2, 0x3fdd8db1, 0x3fd0c24d,
                      0x3fb96a19, 0x3fb4ab6a, 0x3f88ee07, 0x3f8b7c58, 0x3faf8347, 0x3febae1e,
                      0x3fd9c430, 0x3f852b09, 0x3ff70250, 0x3fbe1317)),
}


class SmokeFailure(RuntimeError):
    pass


def wrapper(name):
    import importlib

    mod, fn, _, _ = KERNELS[name]
    return getattr(importlib.import_module(mod), fn)


def kernel_mode(name):
    """The weight mode a KERNELS name counts (K1 and K5: "w8a8" for the bare
    name), or None for a kernel without modes and for an operand entry."""
    if name in OPERAND_ENTRIES or not hasattr(wrapper(name), "mode_launches"):
        return None
    return name.partition("[")[2].rstrip("]") or "w8a8"


def reset_counts():
    for name in KERNELS:
        fn = wrapper(name)
        fn.launches = 0
        for counts in ("mode_launches", "operand_launches"):
            if hasattr(fn, counts):
                getattr(fn, counts).clear()


def read_counts():
    """Launches per KERNELS name: a wrapper's count; for K1 and K5, its
    count in the name's weight mode; for an operand entry, the wrapper's
    launches with that operand."""
    out = {}
    for name in KERNELS:
        fn, mode = wrapper(name), kernel_mode(name)
        if name in OPERAND_ENTRIES:
            out[name] = fn.operand_launches.get(OPERAND_ENTRIES[name], 0)
        else:
            out[name] = fn.launches if mode is None else fn.mode_launches.get(mode, 0)
    return out


def k4_rows():
    """The rows K4's device code has sampled inside the fused kernels, under
    K4_ROWS (sample_rows.site_rows; reset_k4_rows sets them to 0)."""
    return {f"k4_rows[{site}]": n for site, n in wrapper("sample_rows").site_rows.items()}


def reset_k4_rows():
    rows = wrapper("sample_rows").site_rows
    for site in rows:
        rows[site] = 0


def timed(fn, device, iters=5):
    """Mean milliseconds per call after one warm-up: CUDA events on a card,
    the host clock on the CPU (CPU times are never reported as device
    times)."""
    import torch

    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def bound(nbytes, ops):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves `nbytes` (each input read once, each output written once)
    and does ops[type] operations: the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _stack(blocks):
    """(bytes, weight counts by operand type) of a decoder stack as the
    kernels read it: the norms (float32) and each projection's leaves (int8
    q and float32 scales; u4 packed q, float32 scales and offsets; or plain
    bf16). An int8 weight is an int8 product; a u4 or bf16 weight a bf16
    one (the Pallas kernels' dots in those modes)."""
    ts = [blocks.attn_norm, blocks.q_norm, blocks.k_norm, blocks.ffn_norm]
    counts = {"int8": 0, "bf16": 0}
    for w in (blocks.wqkv, blocks.wo, blocks.w_gateup, blocks.w_down):
        if hasattr(w, "zero"):        # QuantLinear4: K/2 packed rows
            ts += list(w)
            counts["bf16"] += 2 * w.q.numel()
        elif hasattr(w, "q"):
            ts += list(w)
            counts["int8"] += w.q.numel()
        else:
            ts.append(w)
            counts["bf16"] += w.numel()
    return _nbytes(*ts), counts


def talker_step_bound(tp, tcfg, B, n_past, rows=None, kv_int8=False):
    """One talker step for B lanes at n_past: the stack, output norm and
    codec head once; each lane's KV rows 0..n_past (bf16; kv_int8: int8
    values and a float32 scale per row and head), or rows[b] of them (the
    rows [start_b, n_past] a lane attends with K5's start operand), and its
    input, outputs, seen-set and seed (with per-lane sampling parameters,
    12 bytes more). Operations: the projections' products by type, the bf16
    head, the float32 attention (q.k and p.v) over the rows read."""
    H, Vc, L = tcfg.hidden_size, tcfg.codec_vocab_size, tcfg.n_layers
    sb, n = _stack(tp.blocks)
    D = tcfg.head_dim
    kv_row = L * 2 * tcfg.n_kv_heads * (D + 4 if kv_int8 else 2 * D)
    lane = H * 2 + H * 4 + Vc * 4 + Vc + 8 + (0 if rows is None else 12)
    n_rows = B * (n_past + 1) if rows is None else int(sum(rows))
    nbytes = sb + _nbytes(tp.output_norm, tp.codec_head) + n_rows * kv_row + B * lane
    attn = 4 * L * tcfg.n_heads * n_rows * tcfg.head_dim
    return bound(nbytes, {"int8": 2 * B * n["int8"], "bf16": 2 * B * (n["bf16"] + H * Vc),
                          "f32": attn})


def code_predictor_bound(cp, ccfg, B):
    """One frame-set of the code predictor for B lanes: the stack and the 15
    heads once; each lane's inputs, 15 embedding rows and outputs.
    Operations: 16 passes of int8 products, 15 bf16 heads, the float32
    attention over positions 0..p."""
    H, V, S, L = ccfg.hidden_size, ccfg.vocab_size, ccfg.n_steps, ccfg.n_layers
    sb, n = _stack(cp.blocks)
    n8 = n["int8"]
    nbytes = sb + _nbytes(cp.output_norm, cp.heads) + B * (2 * H * 2 + S * H * 2 + S * 4
                                                           + H * 4 + 4)
    attn = sum(4 * L * ccfg.n_heads * (p + 1) * ccfg.head_dim for p in range(S + 1))
    return bound(nbytes, {"int8": 2 * (S + 1) * B * n8, "bf16": 2 * S * B * H * V,
                          "f32": B * attn})


def make_pipeline(cfg, device, seed=0, quant="int8"):
    """A Qwen3TTS in weight tier `quant` on synthetic weights from `seed`."""
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, quant=quant))
    tts = Qwen3TTS(cfg, device=device)
    if not tts.load_models(None, synthetic=True, seed=seed):
        raise SmokeFailure(tts.error_msg)
    return tts


# check_sampler's rows: per width, SAMPLER_ROWS rows of SAMPLER_KINDS in
# turn; top-k values (V - 1 and V filled in per width); per-row parameters,
# each row r its SAMPLER_TEMPS[r % 3] and SAMPLER_TOP_PS[r % 2]
SAMPLER_ROWS = 64
SAMPLER_KINDS = ("normal", "ties at the 50th", "flat", "few levels", "spike", "narrow",
                 "-1e30 block")
SAMPLER_TOP_KS = (1, 50, -1, 0)     # -1: V - 1; 0: V (the stage off)
SAMPLER_TEMPS = (0.05, 0.9, 1.5)
SAMPLER_TOP_PS = (0.9, 1.0)


def sampler_rows(R, V, seed):
    """[R, V] float32 logits of the adversarial kinds (SAMPLER_KINDS, row r
    kind r % 7): normal (sd 3); the values ranked 45-60 equal to the 50th
    (ties at the k-th value); one value everywhere; 5 levels (ties
    everywhere); one spike of 40 over sd 0.5; sd 1e-3 around 7 (midpoints
    at float granularity); normal with a block of -1e30 inside the row (the
    cb0 suppression's value, within the bisection's range)."""
    import numpy as np

    g = np.random.default_rng(seed)
    rows = g.normal(size=(R, V)) * 3
    for r in range(R):
        kind, x = r % len(SAMPLER_KINDS), rows[r]
        if kind == 1:
            order = np.argsort(-x)
            x[order[45:61]] = x[order[49]]
        elif kind == 2:
            x[:] = 0.75
        elif kind == 3:
            x[:] = np.round(x / 3) * 0.5
        elif kind == 4:
            x[:] = g.normal(size=V) * 0.5
            x[g.integers(V)] = 40.0
        elif kind == 5:
            x[:] = 7.0 + g.normal(size=V) * 1e-3
        elif kind == 6:
            lo = g.integers(V // 2)
            x[lo:lo + V // 4] = -1e30
    return rows.astype(np.float32)


def sampler_sites(tts, device, B=64, C=512, n_past=300):
    """K4 inside the fused kernels, default sampling (temperature 0.9, top-k
    50, penalty 1.05) against greedy: K1's head_sample_kernel (int8, one
    lane at n_past), its device µs a call as its busy share (charged from
    the end of the kernel before it: under programmatic dependent launch its
    interval holds the head GEMV's wait) and as its interval; K5's
    head_sample_kernel at B lanes (device ms a call); K2 (one frame) and K6
    at B lanes, the persistent kernel's device ms a call, sampled and greedy
    in turns, the median of three traces of 10 calls (their difference: what a
    lane's 15 sequential samples cost beyond their argmax). Empty off the
    card."""
    import torch

    from qwen3tts_tpu_torch.ops.fused_code_predictor import fused_predict_codes
    from qwen3tts_tpu_torch.ops.fused_code_predictor_batched import fused_predict_codes_batched
    from qwen3tts_tpu_torch.ops.fused_talker_step import (fused_talker_step,
                                                          fused_talker_step_batched)

    if device.type != "cuda":
        return {}
    from torch.profiler import ProfilerActivity, profile

    tp, tcfg = tts.talker_params, tts.config.talker
    L, Hkv, D, Vc, H = (tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim, tcfg.codec_vocab_size,
                        tcfg.hidden_size)
    g = torch.Generator(device=device).manual_seed(29)
    modes = {"sampled": dict(temperature=0.9, greedy=False, use_top_p=False),
             "greedy": dict(temperature=0.0, greedy=True, use_top_p=False)}
    base = dict(output_norm=tp.output_norm, codec_head=tp.codec_head, top_k=50,
                repetition_penalty=1.05, suppress_start=Vc - tcfg.n_suppressed_tail,
                eos_id=tcfg.codec_eos_id)
    out = {}
    x = torch.randn((H,), generator=g, device=device)
    kv = torch.randn((L, 2, Hkv, C, D), generator=g, device=device, dtype=torch.bfloat16)
    seen = (torch.rand((Vc,), generator=g, device=device) < 0.05).to(torch.int8)
    for mode, mk in modes.items():
        run = lambda: fused_talker_step(tp.blocks, tcfg, x, n_past, kv, seen=seen,  # noqa: E731
                                        seed=17, **base, **mk)
        run()
        torch.cuda.synchronize(device)
        best = []
        for _ in range(3):   # the trace that caught the most kernels
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize(device)
            ev = [e for e in device_events(prof) if e["cat"] == "kernel"]
            best = ev if len(ev) > len(best) else best
        heads = [e for e in best if kernel_name(e["name"]) == "head_sample_kernel"]
        out[f"K1 {mode}"] = dict(
            head_sample_busy_us=busy_shares(best, (("head_sample_kernel",),))[0] * 1e3
            if heads else None,
            head_sample_interval_us=heads[0]["dur"] if heads else None)
    del kv
    xb = torch.randn((B, H), generator=g, device=device)
    kvb = torch.randn((B, L, 2, Hkv, C, D), generator=g, device=device, dtype=torch.bfloat16)
    seenb = (torch.rand((B, Vc), generator=g, device=device) < 0.05).to(torch.int8)
    seeds = torch.arange(B, dtype=torch.int32, device=device) * 31 + 1
    for mode, mk in modes.items():
        run = lambda: fused_talker_step_batched(  # noqa: E731
            tp.blocks, tcfg, xb, n_past, kvb, seen=seenb, seeds=seeds, **base, **mk)
        out[f"K5 B={B} {mode}"] = dict(head_sample_device_ms=device_ms_per_call(
            lambda: [run() for _ in range(5)], 5, ("head_sample_kernel",), device, expect=5))
    del kvb
    cp, ccfg = tts.cp_params, tts.config.code_predictor
    th = torch.randn((B, ccfg.hidden_size), generator=g, device=device).to(tts.dtype)
    cb0 = tp.codec_embd[torch.arange(B, device=device) * 29 + 5]
    seeds = torch.arange(B, dtype=torch.int32, device=device) * 104729 - 3000
    runs = {}
    for mode, mk in modes.items():
        mk = dict(mk, top_k=50)
        runs[("K2", mode)] = (lambda mk=mk: fused_predict_codes(cp, ccfg, th[0], cb0[0], 991,
                                                               **mk))
        runs[(f"K6 B={B}", mode)] = (lambda mk=mk: fused_predict_codes_batched(
            cp, ccfg, th, cb0, seeds, **mk))
    # sampled and greedy in turns, three times: the difference is a few
    # percent of a call
    ms = {key: [] for key in runs}
    for _ in range(3):
        for key, run in runs.items():
            ms[key].append(device_ms_per_call(lambda run=run: [run() for _ in range(10)], 10,
                                              (CP_KERNEL,), device, expect=10))
    for name in ("K2", f"K6 B={B}"):
        for mode in modes:
            got = sorted(v for v in ms[(name, mode)] if v is not None)
            out[f"{name} {mode}"] = dict(device_ms=got[len(got) // 2] if got else None,
                                         device_ms_runs=ms[(name, mode)])
        s_ms, g_ms = out[f"{name} sampled"]["device_ms"], out[f"{name} greedy"]["device_ms"]
        out[f"{name} sampled_minus_greedy_ms"] = (None if s_ms is None or g_ms is None
                                                  else s_ms - g_ms)
    return out


def sampler_gate(tts):
    """K4 against its plain version on SAMPLER_ROWS rows of each width the
    sites sample (the codec head's with the cb0 suppression and a
    repetition penalty over a seen-set; the code predictor's without), of
    the adversarial kinds of sampler_rows, with per-row seeds: greedy and,
    for each top-k of SAMPLER_TOP_KS, top-k with per-row temperatures and
    top-k + top-p with per-row temperatures and top-p (rows grouped by
    their parameters, a call a group). Returns (tokens that differ,
    tokens drawn)."""
    import torch

    from qwen3tts_tpu_torch.ops.sampling import sample_rows, sample_rows_plain

    dev, tcfg = tts.device, tts.config.talker
    widths = ((tcfg.codec_vocab_size, True), (tts.config.code_predictor.vocab_size, False))
    worst, draws = 0, 0
    for V, supp in widths:
        R = SAMPLER_ROWS
        logits = torch.from_numpy(sampler_rows(R, V, seed=V)).to(dev)
        seeds = (torch.arange(R, dtype=torch.int32) * 7919 - 11).to(dev)
        kw = {}
        if supp:
            g = torch.Generator(device="cpu").manual_seed(11)
            kw = dict(suppress_start=V - tcfg.n_suppressed_tail, eos_id=tcfg.codec_eos_id,
                      seen=(torch.rand((V,), generator=g) < 0.05).to(dev),
                      repetition_penalty=1.05)
        calls = [(torch.arange(R), dict(temperature=0.0, top_p=1.0, top_k=50, greedy=True,
                                        use_top_p=False))]
        for top_k in SAMPLER_TOP_KS:
            k = V - 1 if top_k == -1 else (V if top_k == 0 else top_k)
            for t_i, temp in enumerate(SAMPLER_TEMPS):
                rows = torch.arange(t_i, R, len(SAMPLER_TEMPS))
                calls.append((rows, dict(temperature=temp, top_p=1.0, top_k=k, greedy=False,
                                         use_top_p=False)))
                for p_i, top_p in enumerate(SAMPLER_TOP_PS):
                    sel = rows[rows % len(SAMPLER_TOP_PS) == p_i]
                    calls.append((sel, dict(temperature=temp, top_p=top_p, top_k=k,
                                            greedy=False, use_top_p=True)))
        for rows, mk in calls:
            rows = rows.to(dev)
            args = (logits[rows].contiguous(), seeds[rows].contiguous(), 3)
            a = sample_rows(*args, **kw, **mk)
            b = sample_rows_plain(*args, **kw, **mk)
            worst += int((a.long().cpu() != b.long().cpu()).sum())
            draws += int(rows.numel())
    return worst, draws


def check_sampler(tts, report, iters):
    """K4 against its plain version (sampler_gate). Tolerance: tokens equal
    (0 differences). Both versions see the same float32 logits; the scale,
    the top-k counts and the noise are exact, and only the top-p masses'
    float sums run in another order. Timed: one [1, V] row and 64 rows at
    each width (device µs; a row at the code predictor's width runs on its
    256-thread block), the block-wide exchanges of a row (sample_shape),
    and K4 inside K1, K5, K2 and K6 (sampler_sites)."""
    import torch

    from qwen3tts_tpu_torch.ops.sampling import sample_rows, sample_rows_plain, sample_shape

    dev, tcfg = tts.device, tts.config.talker
    widths = ((tcfg.codec_vocab_size, True), (tts.config.code_predictor.vocab_size, False))
    worst, draws = sampler_gate(tts)
    if worst:
        raise SmokeFailure(f"sample_rows: {worst} of {draws} tokens differ from the plain "
                           "version")
    V = tcfg.codec_vocab_size
    default = dict(temperature=0.9, top_p=1.0, top_k=50, greedy=False, use_top_p=False)
    kw = dict(suppress_start=V - tcfg.n_suppressed_tail, eos_id=tcfg.codec_eos_id)
    g = torch.Generator(device="cpu").manual_seed(5)
    logits = torch.randn((1, V), generator=g).to(dev)
    seeds = torch.tensor([5], dtype=torch.int32, device=dev)
    # one row: the logits in, the seed, the token out; about 50 float32
    # operations per logit (the top-k bisection's 30 compares, the hash and
    # the two logs of the Gumbel noise, the argmax)
    bound_ms, bound_by = bound(V * 4 + 8, {"f32": 50 * V})
    run = lambda: sample_rows(logits, seeds, 0, **kw, **default)  # noqa: E731
    rows_us, shapes = {}, {}
    for W, supp in widths:
        for R in (1, 64):
            x = torch.randn((R, W), generator=g).to(dev)
            sd = torch.arange(R, dtype=torch.int32, device=dev)
            k = kw if supp else {}
            ms = device_ms_per_call(
                lambda: [sample_rows(x, sd, 0, **k, **default) for _ in range(iters)], iters,
                ("sample_rows_kernel",), dev, expect=iters)
            rows_us[f"[{R}, {W}]"] = None if ms is None else ms * 1e3
        if dev.type == "cuda":
            shapes[W] = dict(zip(("threads", "elements_per_thread", "exchanges_default"),
                                 sample_shape(W, greedy=False, top_k=50, use_top_p=False)))
            shapes[W]["exchanges_greedy"] = sample_shape(W, greedy=True, top_k=50,
                                                         use_top_p=False)[2]
            shapes[W]["exchanges_top_p"] = sample_shape(W, greedy=False, top_k=50,
                                                        use_top_p=True, top_p=0.9)[2]
    report["sample_rows"] = dict(
        max_abs_err=float(worst),   # tokens that differ (0 when the gate passed)
        ms=timed(run, dev, iters),
        device_ms=device_ms_per_call(lambda: [run() for _ in range(iters)], iters,
                                     ("sample_rows_kernel",), dev, expect=iters),
        plain_ms=timed(lambda: sample_rows_plain(logits, seeds, 0, **kw, **default), dev, iters),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=f"one [1, {V}] row, top-k 50, temperature 0.9",
        tolerance=f"tokens equal over {draws} draws", device_us_per_call=rows_us,
        block=shapes, sites=sampler_sites(tts, dev))
    print(f"kernel sample_rows: {draws} tokens equal; {report['sample_rows']['ms']:.4f} ms "
          f"(device {report['sample_rows']['device_ms']}; plain "
          f"{report['sample_rows']['plain_ms']:.4f} ms); device us a call {rows_us}; "
          f"block {shapes}; sites {report['sample_rows']['sites']}")


def gumbel_ulps(g, u):
    """The error of a float32 Gumbel field g = -log(-log(u)) against its
    float64 value from the same uniforms u, in units of one float32 ulp of
    each log: |g - g64| / (ulp(g64) + ulp(w) / w), w = -log(u). Near
    g = 0 the outer log cancels, so the output's own ulp is no measure: one
    ulp of w moves g by ulp(w) / w."""
    import numpy as np

    u = np.asarray(u, np.float64)
    g64 = -np.log(-np.log(u))
    w = -np.log(u)
    unit = (np.spacing(np.abs(g64).astype(np.float32)).astype(np.float64)
            + np.spacing(w.astype(np.float32)).astype(np.float64) / w)
    return np.abs(np.asarray(g, np.float64) - g64) / unit


GUMBEL_ULPS = 2.0


def host_uniform_bits(keys, V):
    """uniform_bits of keys [R, 2] over V counters by the numpy form of the
    hash, on the host: uint32 [R, V]."""
    import numpy as np

    from qwen3tts_tpu_torch.ops import prng

    k = prng.key_array(keys).reshape(-1, 2)
    b0, b1 = prng.threefry2x32(k[:, :1], k[:, 1:], np.uint32(0),
                               np.arange(V, dtype=np.uint32)[None])
    return ((b0 ^ b1) >> 9) | np.uint32(0x3F800000)


def check_prng(device, iters=20):
    """The JAX package's random streams in the port (ops/prng.py) against
    PRNG_GOLDENS and across its forms. Host: prng_key, bits32, the split
    chain of 8 frames and its bits in the Python-int form and the numpy
    form over the five keys at once, all equal to the goldens. Device: the
    uniform bit patterns of a [16, 3072] field (the five golden keys and
    split(prng_key(11), 11)) by the torch form on `device` equal to the
    numpy form bit for bit, and the goldens' first 16 of each golden key;
    the Gumbel field on `device` within GUMBEL_ULPS of float64
    -log(-log(u)) of the same uniforms (gumbel_ulps). Timed: the host's key
    work per frame (decode_loop.frame_draws: split into 3 and two seeds)
    for one stream (Python ints) and 64 lanes (numpy), and the [16, 3072]
    field on `device`. Prints one `prng` line; returns its dict."""
    import numpy as np
    import torch

    from qwen3tts_tpu_torch.ops import prng
    from qwen3tts_tpu_torch.runtime.decode_loop import frame_draws

    bad = []
    lanes = prng.key_array([prng.prng_key(s) for s in PRNG_GOLDENS])
    lane_chain = lanes                                      # [5, 2]
    for i, (seed, g) in enumerate(PRNG_GOLDENS.items()):
        key = prng.prng_key(seed)
        if key != g["key"] or prng.bits32(key) != g["bits32"]:
            bad.append(f"seed {seed}: key or bits32")
        for f, row in enumerate(g["frames"]):
            nxt, k_cb0, k_cp = prng.split(key, 3)
            got = (*nxt, *k_cb0, *k_cp, prng.bits32(k_cb0), prng.bits32(k_cp))
            if got != tuple(row):
                bad.append(f"seed {seed} frame {f}: split or bits")
            key = nxt
    for f in range(8):
        s3 = prng.split(lane_chain, 3)
        want = np.asarray([g["frames"][f] for g in PRNG_GOLDENS.values()], np.uint32)
        got = np.concatenate([s3.reshape(-1, 6), prng.bits32(s3[:, 1])[:, None],
                              prng.bits32(s3[:, 2])[:, None]], axis=1)
        if not np.array_equal(got, want):
            bad.append(f"lanes frame {f}: split or bits")
        lane_chain = s3[:, 0]
    keys = np.concatenate([lanes, prng.key_array(prng.split(prng.prng_key(11), 11))])
    V = 3072
    dev_bits = prng.uniform_bits(keys, V, device).cpu().numpy().view(np.uint32)
    host_bits = host_uniform_bits(keys, V)
    if not np.array_equal(dev_bits, host_bits):
        bad.append(f"device field: {int((dev_bits != host_bits).sum())} bit patterns differ "
                   "from the host form")
    gold = np.asarray([g["uniform_bits"] for g in PRNG_GOLDENS.values()], np.uint32)
    if not np.array_equal(dev_bits[:len(gold), :16], gold):
        bad.append("device field: the goldens' uniform bits differ")
    u = np.maximum(host_bits.view(np.float32) - np.float32(1.0), np.float32(prng.TINY))
    g = prng.gumbel(keys, V, device).cpu().numpy()
    ulps = float(gumbel_ulps(g, u).max())
    if not ulps <= GUMBEL_ULPS:
        bad.append(f"Gumbel field {ulps:.3f} ulps from float64 (tolerance {GUMBEL_ULPS})")
    if bad:
        raise SmokeFailure("prng: " + "; ".join(bad))

    def per_call_us(fn, n):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    key64 = prng.key_array(prng.split(prng.prng_key(5), 64))
    out = dict(
        goldens="equal", device_field_bits="equal to the host form and the goldens",
        gumbel_max_ulps=ulps, gumbel_tolerance_ulps=GUMBEL_ULPS, field=[len(keys), V],
        frame_keys_us=per_call_us(lambda: frame_draws((0, 3), True, True), 2000),
        frame_keys_64_lanes_us=per_call_us(lambda: frame_draws(key64, True, True), 200),
        field_ms=timed(lambda: prng.gumbel(torch.as_tensor(keys.astype(np.int64), device=device),
                                           V), device, iters))
    print("prng " + json.dumps(out))
    return out


def _truncated(tts, n_layers):
    """The talker's first n_layers layers at full width (same kernels)."""
    from qwen3tts_tpu_torch.models.transformer_core import BlockParams

    def cut(w):
        return type(w)(*(t[:n_layers] for t in w)) if hasattr(w, "_fields") else w[:n_layers]

    blocks = BlockParams(*[cut(w) for w in tts.talker_params.blocks])
    return blocks, dataclasses.replace(tts.config.talker, n_layers=n_layers)


def _lane_cos(a, b):
    """Cosine similarity of each row of a and b."""
    import torch

    return torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1)


# the kernels of layer.cuh that K1 and K5 launch (their device time is the
# sum of these, one stream, in order)
TALKER_KERNEL_PREFIXES = ("resid_rms_kernel", "gemv_", "gemm_", "qkv_post_kernel",
                          "attn_", "swiglu_kernel", "head_sample_kernel")
# the attention stage of K1 and K5: the attention kernel and the per-lane
# emit (attn_layer_kernel, attn_emit_kernel), and with the int8 cache the
# current row's quantization (kv_row_quant_kernel)
ATTENTION_PREFIXES = ("attn_", "kv_row_")


def talker_call_stats(run, device, key="", tries=3):
    """One K1/K5 call under the profiler, under names ending in `key`:
    device_ms, the union of its kernels' intervals (K1 launches its chain
    with programmatic dependent launch, so a kernel's interval can hold its
    wait on the one before: summing durations would count the overlap
    twice); attention_device_ms and gemv_device_ms, the parts of that union
    that its attention stage's and its projections' kernels (GEMVs or GEMMs,
    the codec head's included) add when the intervals are taken in the
    order they start (busy_shares: a kernel of the chain is charged from
    where the one before it ends; without overlap, its duration);
    launches_per_call, the port's kernels it launches; and ms_profiled, CUDA
    events around the call while the profiler traces it (beside the
    report's ms, taken without: whether the tracing serializes the chain).
    From the one of `tries` traces that caught the most of its kernels (the
    profiler can drop a short run's events). None off the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = [f"{k}{key}" for k in ("device_ms", "attention_device_ms", "gemv_device_ms",
                                   "launches_per_call", "ms_profiled")]
    if device.type != "cuda":
        return dict.fromkeys(names)
    run()
    torch.cuda.synchronize(device)
    best, best_ms = [], None
    for _ in range(tries):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(device)
        ours = [e for e in device_events(prof) if e["cat"] == "kernel" and kernel_name(
            e["name"]).startswith(TALKER_KERNEL_PREFIXES + ATTENTION_PREFIXES)]
        if len(ours) > len(best):
            best, best_ms = ours, start.elapsed_time(end)
    shares = busy_shares(best, (ATTENTION_PREFIXES, ("gemv_", "gemm_")))
    return dict(zip(names, (device_busy_ms(best), *shares, len(best), best_ms)))


def busy_shares(events, groups):
    """For each tuple of kernel-name prefixes in `groups`, the milliseconds
    of the events' union (device_busy_ms) that its kernels add when the
    intervals are taken in the order they start: the union's partition
    among the kernels, each charged from the latest end before it."""
    out = [0.0] * len(groups)
    end = float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        if b > end:
            name = kernel_name(e["name"])
            for i, prefixes in enumerate(groups):
                if name.startswith(prefixes):
                    out[i] += (b - max(a, end)) / 1e3
            end = b
    return out


def _gates(exact):
    """(hidden, kv row) bounds of the 2-layer gate: 0.0 in the float modes
    (exact: every sum that feeds a rounding is exact to float32 in both
    versions), else PR 1's 1e-3 and 0.05 (a bf16 ulp at |x| < 8 is at most
    0.03)."""
    return (0.0, 0.0) if exact else (1e-3, 0.05)


def check_talker_step(tts, report, iters, key="fused_talker_step",
                      positions=((512, (10, 300)), (4352, (10, 300, 4000))), exact=False):
    """K1 against the plain version on clones of the same cache, at each KV
    capacity and n_past, from identical inputs (one step: teacher-forced,
    never chained), in the weight mode of tts's tier; reported under `key`.
    n_past 4000 at C=4352 reaches the rows a default request
    (max_audio_tokens=4096) attends over: a softmax row longer than the
    1024 threads of its block, and p.V partials merged over 60+ chunks.

    Two gates. (1) The first 2 layers at full width, greedy and sampled:
    hidden within 1e-3 abs (exact: 0.0), the written K/V row within 0.05
    (exact: 0.0), logits within 1e-3 (the head sums in float32 in two
    orders), cb0 equal. (2) All layers: cosine of hidden and of logits >=
    0.99, greedy cb0 equal unless the plain logits' top-2 gap is below twice
    the logits error. Why not an absolute bound for (2): a last-bit
    difference that flips a bf16 rounding of q or p or an activation
    rounding grows chaotically through 28 layers of random synthetic
    weights (a 1-ulp rsqrt difference alone grew to 0.17 in the hidden). The
    float64 sums of layer.cuh and the plain version leave only the head's
    logits to differ in their last bits, so (2) holds with room to spare.
    The report's max_abs_err is the worst of both gates; ms is CUDA events
    around a run of calls, device_ms the kernels' own time under the
    profiler."""
    import torch

    from qwen3tts_tpu_torch.ops.fused_talker_step import (
        fused_talker_step, fused_talker_step_plain)

    tp, dev = tts.talker_params, tts.device
    tcfg = tts.config.talker
    g = torch.Generator(device="cpu").manual_seed(5)
    x = (torch.randn((tcfg.hidden_size,), generator=g)).to(device=dev, dtype=tts.dtype)
    Vc = tcfg.codec_vocab_size
    seen = torch.zeros((Vc,), dtype=torch.int8, device=dev)
    seen[:64] = 1
    base = dict(output_norm=tp.output_norm, codec_head=tp.codec_head, seen=seen, seed=17,
                top_k=50, repetition_penalty=1.05, suppress_start=Vc - 1024, eos_id=2150)
    greedy = dict(base, temperature=0.0, greedy=True, use_top_p=False)
    sampled = dict(base, temperature=0.9, greedy=False, use_top_p=False)
    short_blocks, short_cfg = _truncated(tts, min(2, tcfg.n_layers))
    tol_h, tol_kv = _gates(exact)
    errs_short, errs_full, cos_full = [], [], []
    for C, n_pasts in positions:
        kv0 = (torch.randn((tcfg.n_layers, 2, tcfg.n_kv_heads, C, tcfg.head_dim),
                           generator=g) * 0.5).to(device=dev, dtype=tts.dtype)
        for n_past in n_pasts:
            for kw in (greedy, sampled):
                kva = kv0[:short_cfg.n_layers].clone()
                kvb = kva.clone()
                a = fused_talker_step(short_blocks, short_cfg, x, n_past, kva, **kw)
                b = fused_talker_step_plain(short_blocks, short_cfg, x, n_past, kvb, **kw)
                eh, el = _max_err(a.hidden, b.hidden), _max_err(a.logits, b.logits)
                ekv = _max_err(kva[:, :, :, n_past], kvb[:, :, :, n_past])
                ca, cb = int(a.cb0.reshape(-1)[0]), int(b.cb0.reshape(-1)[0])
                print(f"kernel {key} 2 layers C={C} n_past={n_past} "
                      f"greedy={kw['greedy']}: hidden err {eh:.3e}, logits err {el:.3e}, "
                      f"kv row err {ekv:.3e}, cb0 {ca} vs {cb}")
                if not (eh <= tol_h and el <= 1e-3 and ekv <= tol_kv and ca == cb):
                    raise SmokeFailure(f"{key} (2 layers) disagrees at C={C}, n_past={n_past}")
                errs_short.append(max(eh, el))
            kva, kvb = kv0.clone(), kv0.clone()
            a = fused_talker_step(tp.blocks, tcfg, x, n_past, kva, **greedy)
            b = fused_talker_step_plain(tp.blocks, tcfg, x, n_past, kvb, **greedy)
            eh, el = _max_err(a.hidden, b.hidden), _max_err(a.logits, b.logits)
            ch = float(_lane_cos(a.hidden[None], b.hidden[None]))
            cl = float(_lane_cos(a.logits[None], b.logits[None]))
            top2 = torch.topk(b.logits.float(), 2).values
            ca, cb = int(a.cb0.reshape(-1)[0]), int(b.cb0.reshape(-1)[0])
            cb0_ok = ca == cb or float(top2[0] - top2[1]) < 2 * el
            print(f"kernel {key} {tcfg.n_layers} layers C={C} n_past={n_past}: "
                  f"hidden cos {ch:.6f} (err {eh:.3e}), logits cos {cl:.6f} (err {el:.3e}), "
                  f"cb0 {ca} vs {cb}")
            if not (ch >= 0.99 and cl >= 0.99 and cb0_ok):
                raise SmokeFailure(f"{key} disagrees at C={C}, n_past={n_past}")
            errs_full.append(max(eh, el))
            cos_full.append(min(ch, cl))
    n_past = 300
    kv = kv0.clone()
    bound_ms, bound_by = talker_step_bound(tp, tcfg, 1, n_past)
    run = lambda: fused_talker_step(tp.blocks, tcfg, x, n_past, kv, **greedy)  # noqa: E731
    report[key] = dict(
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        max_abs_err=max(errs_short + errs_full),
        max_abs_err_2_layers=max(errs_short),
        max_abs_err_all_layers=max(errs_full),
        min_cos_all_layers=min(cos_full),
        ms=timed(run, dev, iters),
        **talker_call_stats(run, dev),
        plain_ms=timed(lambda: fused_talker_step_plain(tp.blocks, tcfg, x, n_past, kv,
                                                       **greedy), dev, iters),
        shape=f"C={C} n_past={n_past}",
        tolerance=(f"2 layers: hidden {tol_h} abs, kv row {tol_kv}, logits 1e-3, cb0 equal; "
                   f"all layers: cosine 0.99"))
    if C > 4000:   # the rows a default request (max_audio_tokens=4096) attends over
        run = lambda: fused_talker_step(tp.blocks, tcfg, x, 4000, kv, **greedy)  # noqa: E731
        report[key].update(
            ms_n_past_4000=timed(run, dev, iters),
            **talker_call_stats(run, dev, "_n_past_4000"),
            bound_ms_n_past_4000=talker_step_bound(tp, tcfg, 1, 4000)[0])


def check_code_predictor(tts, report, iters):
    """K2 at full width, greedy and sampled (temperature 0.9, top-k 50, one
    seed). Tolerance: the 15 codes equal, and rest_sum within 1e-3 of the
    plain version's (a sum of 15 bf16 rows in float32). On the card also:
    one call launches exactly one kernel of the port's library, the
    persistent kernel (``cp_kernels_per_call``), whose device time and grid
    are reported."""
    import torch

    from qwen3tts_tpu_torch.ops.fused_code_predictor import (
        fused_predict_codes, fused_predict_codes_plain)

    cp, ccfg, dev = tts.cp_params, tts.config.code_predictor, tts.device
    g = torch.Generator(device="cpu").manual_seed(7)
    th = torch.randn((ccfg.hidden_size,), generator=g).to(device=dev, dtype=tts.dtype)
    cb0 = tts.talker_params.codec_embd[123]
    grid = cp_grid(ccfg, None, dev)
    err = 0.0
    for kw in (dict(temperature=0.0, top_k=50, greedy=True, use_top_p=False),
               dict(temperature=0.9, top_k=50, greedy=False, use_top_p=False)):
        ca, sa = fused_predict_codes(cp, ccfg, th, cb0, 991, **kw)
        cb, sb = fused_predict_codes_plain(cp, ccfg, th, cb0, 991, **kw)
        same = bool((ca.long().cpu() == cb.cpu()).all())
        e = _max_err(sa, sb)
        print(f"kernel fused_predict_codes greedy={kw['greedy']}: codes "
              f"{'equal' if same else 'DIFFER'} {ca.tolist()} vs {cb.tolist()}; "
              f"rest_sum err {e:.3e}; grid {grid}")
        if not (same and e <= 1e-3):
            raise SmokeFailure("fused_predict_codes disagrees with its plain version")
        err = max(err, e)
    run = lambda: fused_predict_codes(cp, ccfg, th, cb0, 991, **kw)  # noqa: E731
    bound_ms, bound_by = code_predictor_bound(cp, ccfg, 1)
    report["fused_predict_codes"] = dict(
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, shape="one frame",
        max_abs_err=err, ms=timed(run, dev, iters),
        device_ms=device_ms_per_call(run, 1, (CP_KERNEL,), dev, expect=1),
        kernels_per_call=cp_kernels_per_call(run, dev, "fused_predict_codes"), grid=grid,
        plain_ms=timed(lambda: fused_predict_codes_plain(cp, ccfg, th, cb0, 991, **kw),
                       dev, iters),
        tolerance="codes equal; rest_sum 1e-3 abs")


# the persistent code predictor kernel (K2, K6), and every kernel name of
# the port's library that a code predictor call could launch besides it
# (those of layer.cuh, which the multi-launch design launched)
CP_KERNEL = "cp_persistent_kernel"


def cp_grid(ccfg, B, device):
    """The persistent kernel's grid for K2 (B None) or K6 at B lanes
    (fused_code_predictor.kernel_grid); None off the card."""
    if device.type != "cuda":
        return None
    from qwen3tts_tpu_torch.ops.fused_code_predictor import kernel_grid

    return kernel_grid(ccfg, B)


def cp_kernels_per_call(fn, device, what, tries=3):
    """The device kernels one call of fn (one K2 or K6 call) launches, read
    from the profiler: dict(library: the port's kernels, all: every kernel,
    PyTorch's operand preparation included, names). Fails unless the
    library's kernels are exactly one, the persistent kernel. A trace that
    caught none of the library's kernels (the profiler can drop a short
    run's events) is taken again, up to `tries` times. None off the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(device)
        names = [kernel_name(e["name"]) for e in device_events(prof) if e["cat"] == "kernel"]
        ours = [n for n in names if n.startswith(TALKER_KERNEL_PREFIXES + ("cp_",))]
        if ours:
            break
    out = dict(library=len(ours), all=len(names), names=sorted(set(names)))
    print(f"kernels per call of {what}: {out}")
    if ours != [CP_KERNEL]:
        raise SmokeFailure(f"one {what} call launched {ours} of the port's kernels, "
                           f"not one {CP_KERNEL}")
    return out


def check_talker_step_batched(tts, report, iters, shapes=((16, 512, (10, 300)),
                                                          (64, 512, (10, 300)),
                                                          (16, 4352, (4000,)),
                                                          (5, 512, (10,)),
                                                          (24, 512, (10,)),
                                                          (128, 512, (10,))),
                              key="fused_talker_step_batched", exact=False):
    """K5 against the plain version per lane, on clones of the same batched
    cache, for each (B, C, n_past) of `shapes`, teacher-forced single steps
    with 64 distinct lane seeds, in the weight mode of tts's tier; reported
    under `key` (shapes[1] is the headline). The gates are K1's, lane by
    lane: (1) the first 2 layers at full width, greedy and sampled: hidden
    within 1e-3 (exact: 0.0) and logits within 1e-3, the written K/V rows
    within 0.05 (exact: 0.0), every lane's cb0 equal;
    (2) all layers, greedy: each lane's hidden and logits cosine >= 0.99 and
    its cb0 equal unless the plain logits' top-2 gap is below twice that
    lane's logits error (check_talker_step says why). The lane counts 5, 16,
    24, 64 and 128 reach every lane-tile instantiation of the batched
    GEMMs (layer.cuh, gemm_i8 and gemm_f64). Timed at each shape's last
    n_past."""
    import torch

    from qwen3tts_tpu_torch.ops.fused_talker_step import (
        fused_talker_step_batched, fused_talker_step_batched_plain)

    tp, dev = tts.talker_params, tts.device
    tcfg = tts.config.talker
    L, Hkv, D, Vc = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim, tcfg.codec_vocab_size
    g = torch.Generator(device=dev).manual_seed(15)
    short_blocks, short_cfg = _truncated(tts, min(2, L))
    Ls = short_cfg.n_layers
    tol_h, tol_kv = _gates(exact)
    errs_short, errs_full, cos_full, times = [], [], [], {}
    for i, (B, C, positions) in enumerate(shapes):
        x = torch.randn((B, tcfg.hidden_size), generator=g, device=dev).to(tts.dtype)
        seen = torch.zeros((B, Vc), dtype=torch.int8, device=dev)
        seen[:, :64] = 1
        seeds = torch.arange(B, dtype=torch.int32, device=dev) * 7919 - 1000
        base = dict(output_norm=tp.output_norm, codec_head=tp.codec_head, seen=seen,
                    seeds=seeds, top_k=50, repetition_penalty=1.05,
                    suppress_start=Vc - 1024, eos_id=tcfg.codec_eos_id)
        greedy = dict(base, temperature=0.0, greedy=True, use_top_p=False)
        sampled = dict(base, temperature=0.9, greedy=False, use_top_p=False)
        kv0 = torch.randn((B, L, 2, Hkv, C, D), generator=g, device=dev, dtype=tts.dtype) * 0.5
        for n_past in positions:
            for kw in (greedy, sampled):
                kva = kv0[:, :Ls].clone(memory_format=torch.contiguous_format)
                kvb = kva.clone()
                a = fused_talker_step_batched(short_blocks, short_cfg, x, n_past, kva, **kw)
                b = fused_talker_step_batched_plain(short_blocks, short_cfg, x, n_past, kvb,
                                                    **kw)
                eh, el = _max_err(a.hidden, b.hidden), _max_err(a.logits, b.logits)
                ekv = _max_err(kva[..., n_past, :], kvb[..., n_past, :])
                same = int((a.cb0.long() == b.cb0.long()).sum())
                print(f"kernel {key} 2 layers B={B} C={C} "
                      f"n_past={n_past} greedy={kw['greedy']}: hidden err {eh:.3e}, "
                      f"logits err {el:.3e}, kv row err {ekv:.3e}, cb0 equal {same}/{B}")
                if not (eh <= tol_h and el <= 1e-3 and ekv <= tol_kv and same == B):
                    raise SmokeFailure(f"{key} (2 layers) disagrees at "
                                       f"B={B}, C={C}, n_past={n_past}")
                errs_short.append(max(eh, el))
            del kva, kvb
            kva = kv0.clone()
            # the largest cache is not cloned twice: the plain version writes
            # its rows into kv0 itself
            kvb = kv0 if C * B > 64 * 512 else kv0.clone()
            a = fused_talker_step_batched(tp.blocks, tcfg, x, n_past, kva, **greedy)
            b = fused_talker_step_batched_plain(tp.blocks, tcfg, x, n_past, kvb, **greedy)
            ch, cl = _lane_cos(a.hidden, b.hidden), _lane_cos(a.logits, b.logits)
            el = (a.logits.float() - b.logits.float()).abs().amax(dim=-1)
            top2 = torch.topk(b.logits.float(), 2, dim=-1).values
            cb0_ok = (a.cb0.long() == b.cb0.long()) | (top2[:, 0] - top2[:, 1] < 2 * el)
            eh = _max_err(a.hidden, b.hidden)
            print(f"kernel {key} {L} layers B={B} C={C} n_past={n_past}: "
                  f"min lane cos hidden {float(ch.min()):.6f} logits {float(cl.min()):.6f} "
                  f"(err {eh:.3e}, {float(el.max()):.3e}); cb0 equal "
                  f"{int((a.cb0 == b.cb0).sum())}/{B}, gate {int(cb0_ok.sum())}/{B}")
            if not (bool((ch >= 0.99).all()) and bool((cl >= 0.99).all())
                    and bool(cb0_ok.all())):
                raise SmokeFailure(f"{key} disagrees at B={B}, C={C}, n_past={n_past}")
            errs_full.append(max(eh, float(el.max())))
            cos_full.append(min(float(ch.min()), float(cl.min())))
        n_t = positions[-1]
        run = lambda: fused_talker_step_batched(tp.blocks, tcfg, x, n_t, kva,  # noqa: E731
                                                **greedy)
        times[(B, C, n_t)] = dict(ms=timed(run, dev, iters),
                                  **talker_call_stats(run, dev),
                                  bound_ms=talker_step_bound(tp, tcfg, B, n_t)[0])
        if i == 1:
            plain_ms = timed(lambda: fused_talker_step_batched_plain(
                tp.blocks, tcfg, x, n_t, kvb, **greedy), dev, iters)
        del kva, kvb, kv0
    B, C, n_past = shapes[1][0], shapes[1][1], shapes[1][2][-1]
    bound_ms, bound_by = talker_step_bound(tp, tcfg, B, n_past)
    head = times[(B, C, n_past)]
    report[key] = dict(
        max_abs_err=max(errs_short + errs_full),
        max_abs_err_2_layers=max(errs_short),
        max_abs_err_all_layers=max(errs_full),
        min_lane_cos_all_layers=min(cos_full),
        ms=head["ms"], device_ms=head["device_ms"], plain_ms=plain_ms,
        attention_device_ms=head["attention_device_ms"],
        launches_per_call=head["launches_per_call"],
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=f"B={B} C={C} n_past={n_past}",
        times={f"B={b} C={c} n_past={n}": t for (b, c, n), t in times.items()},
        tolerance=(f"per lane: 2 layers hidden {tol_h} abs, kv rows {tol_kv}, logits 1e-3, "
                   f"cb0 equal; all layers cosine 0.99"))


def check_code_predictor_batched(tts, report, iters, B=64):
    """K6 at full width for B lanes with B distinct seeds, greedy and
    sampled (temperature 0.9, top-k 50). Gate: every lane's 15 codes equal
    the plain version's, rest_sum within 1e-3. Reported, not gated: how
    many lanes equal K2 run single-stream with the lane's seed (K6 keeps its
    K/V rows in bf16 as the Pallas kernel does, K2 in float32)."""
    import torch

    from qwen3tts_tpu_torch.ops.fused_code_predictor import fused_predict_codes
    from qwen3tts_tpu_torch.ops.fused_code_predictor_batched import (
        fused_predict_codes_batched, fused_predict_codes_batched_plain)

    cp, ccfg, dev = tts.cp_params, tts.config.code_predictor, tts.device
    g = torch.Generator(device="cpu").manual_seed(17)
    th = torch.randn((B, ccfg.hidden_size), generator=g).to(device=dev, dtype=tts.dtype)
    cb0 = tts.talker_params.codec_embd[torch.arange(B, device=dev) * 29 + 5]
    seeds = torch.arange(B, dtype=torch.int32, device=dev) * 104729 - 3000
    grids = {n: cp_grid(ccfg, n, dev) for n in (B, 20, 16, 5) if n <= B}
    err = 0.0
    for kw in (dict(temperature=0.0, top_k=50, greedy=True, use_top_p=False),
               dict(temperature=0.9, top_k=50, greedy=False, use_top_p=False)):
        ca, sa = fused_predict_codes_batched(cp, ccfg, th, cb0, seeds, **kw)
        cb, sb = fused_predict_codes_batched_plain(cp, ccfg, th, cb0, seeds, **kw)
        lanes_equal = int((ca.long() == cb.long()).all(dim=1).sum())
        single = sum(int(bool((fused_predict_codes(cp, ccfg, th[b], cb0[b], int(seeds[b]),
                                                   **kw)[0] == ca[b]).all())) for b in range(B))
        e = _max_err(sa, sb)
        print(f"kernel fused_predict_codes_batched B={B} greedy={kw['greedy']}: codes equal "
              f"in {lanes_equal}/{B} lanes; rest_sum err {e:.3e}; lanes equal to K2 "
              f"single-stream {single}/{B} (information); grid {grids[B]}")
        if not (lanes_equal == B and e <= 1e-3):
            raise SmokeFailure("fused_predict_codes_batched disagrees with its plain version")
        err = max(err, e)
        # fewer lanes reach the other lanes-per-thread instantiations of the
        # batched GEMMs; lanes are independent, so the plain lanes still hold
        for n in (n for n in (5, 20) if n < B):
            cn, sn = fused_predict_codes_batched(cp, ccfg, th[:n], cb0[:n], seeds[:n], **kw)
            en = _max_err(sn, sb[:n])
            print(f"kernel fused_predict_codes_batched B={n} greedy={kw['greedy']}: codes "
                  f"equal {bool((cn.long() == cb[:n].long()).all())}; rest_sum err {en:.3e}; "
                  f"grid {grids[n]}")
            if not (bool((cn.long() == cb[:n].long()).all()) and en <= 1e-3):
                raise SmokeFailure(f"fused_predict_codes_batched disagrees at B={n}")
            err = max(err, en)
    bound_ms, bound_by = code_predictor_bound(cp, ccfg, B)
    run = lambda: fused_predict_codes_batched(cp, ccfg, th, cb0, seeds, **kw)  # noqa: E731
    run16 = lambda: fused_predict_codes_batched(  # noqa: E731
        cp, ccfg, th[:16], cb0[:16], seeds[:16], **kw)
    report["fused_predict_codes_batched"] = dict(
        max_abs_err=err, ms=timed(run, dev, iters),
        device_ms=device_ms_per_call(run, 1, (CP_KERNEL,), dev, expect=1),
        kernels_per_call=cp_kernels_per_call(run, dev, "fused_predict_codes_batched"),
        grid=grids[B],
        plain_ms=timed(lambda: fused_predict_codes_batched_plain(cp, ccfg, th, cb0, seeds,
                                                                 **kw), dev, iters),
        ms_b16=timed(run16, dev, iters),
        device_ms_b16=device_ms_per_call(run16, 1, (CP_KERNEL,), dev, expect=1),
        grid_b16=grids.get(16),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        bound_ms_b16=code_predictor_bound(cp, ccfg, 16)[0],
        shape=f"B={B}, one frame-set", tolerance="codes equal per lane; rest_sum 1e-3 abs")


def lane_sampling(B, device):
    """Per-lane temperature, top-p and repetition penalty that differ lane
    by lane, as continuous serving's requests bring them: temperature in
    [0.6, 1.4), top-p in [0.8, 1.0], penalty in [1.0, 1.3]."""
    import torch

    lanes = torch.arange(B, device=device, dtype=torch.float32)
    return dict(temperature=0.6 + 0.8 * lanes / B, top_p=0.8 + 0.05 * (lanes % 5),
                repetition_penalty=1.0 + 0.05 * (lanes % 7))


def check_talker_step_start(tts, report, iters, B=64, C=1024, n_past=600, lows=(0, 200)):
    """K5 with the operands of continuous serving against its plain version
    on clones of one cache, per-lane sampling parameters (``lane_sampling``)
    and two layouts of the per-lane starts: spread over [low, n_past] for
    each low in ``lows``, the last lane at n_past (a done lane: only its own
    row), with start_min = low. low = 0 is the first fill; low = 200 is a
    splice's, where the kernel's grid begins at chunk 200 // 64 = 3 and the
    lane at 200 starts mid-chunk (the plain version raises if a start lies
    below start_min). The gates of check_talker_step_batched in the exact
    form, for each layout: (1) the first 2 layers, greedy and sampled (top-p
    on): hidden and the written K/V rows 0.0, logits 1e-3, cb0 equal in
    every lane; (2) all layers, greedy: each lane's cosine >= 0.99 and its
    cb0 equal unless the plain logits' top-2 gap is below twice its logits
    error. Each layout timed; the first also beside K5 without ``start``
    (every lane over rows [0, n_past]) at the same shape. The bound counts
    the weights once and each lane's rows [start_b, n_past]."""
    import torch

    from qwen3tts_tpu_torch.ops.fused_talker_step import (
        fused_talker_step_batched, fused_talker_step_batched_plain)

    key = "fused_talker_step_batched[start]"
    tp, dev = tts.talker_params, tts.device
    tcfg = tts.config.talker
    L, Hkv, D, Vc = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim, tcfg.codec_vocab_size
    g = torch.Generator(device=dev).manual_seed(31)
    short_blocks, short_cfg = _truncated(tts, min(2, L))
    x = torch.randn((B, tcfg.hidden_size), generator=g, device=dev).to(tts.dtype)
    seen = torch.zeros((B, Vc), dtype=torch.int8, device=dev)
    seen[:, :64] = 1
    seeds = torch.arange(B, dtype=torch.int32, device=dev) * 7919 - 1000
    kv0 = torch.randn((B, L, 2, Hkv, C, D), generator=g, device=dev, dtype=tts.dtype) * 0.5
    r = {}
    for low in lows:
        start = (low + torch.arange(B, device=dev) * (n_past - low) // max(B - 1, 1)
                 ).to(torch.int32)
        base = dict(output_norm=tp.output_norm, codec_head=tp.codec_head, seen=seen,
                    seeds=seeds, top_k=50, suppress_start=Vc - 1024, eos_id=tcfg.codec_eos_id,
                    start=start, start_min=low, **lane_sampling(B, dev))
        greedy = dict(base, greedy=True, use_top_p=False)
        sampled = dict(base, greedy=False, use_top_p=True)
        where = f"B={B} C={C} n_past={n_past} starts {low}..{n_past} start_min={low}"
        errs_short = []
        for kw in (greedy, sampled):
            kva = kv0[:, :short_cfg.n_layers].clone(memory_format=torch.contiguous_format)
            kvb = kva.clone()
            a = fused_talker_step_batched(short_blocks, short_cfg, x, n_past, kva, **kw)
            b = fused_talker_step_batched_plain(short_blocks, short_cfg, x, n_past, kvb, **kw)
            eh, el = _max_err(a.hidden, b.hidden), _max_err(a.logits, b.logits)
            ekv = _max_err(kva[..., n_past, :], kvb[..., n_past, :])
            same = int((a.cb0.long() == b.cb0.long()).sum())
            print(f"kernel {key} 2 layers {where} greedy={kw['greedy']}: hidden err "
                  f"{eh:.3e}, logits err {el:.3e}, kv row err {ekv:.3e}, cb0 equal {same}/{B}")
            if not (eh == 0.0 and el <= 1e-3 and ekv == 0.0 and same == B):
                raise SmokeFailure(f"{key} (2 layers, start_min {low}) disagrees with its "
                                   f"plain version")
            errs_short.append(max(eh, el))
        del kva, kvb
        kva = kv0.clone()
        a = fused_talker_step_batched(tp.blocks, tcfg, x, n_past, kva, **greedy)
        b = fused_talker_step_batched_plain(tp.blocks, tcfg, x, n_past, kv0, **greedy)
        ch, cl = _lane_cos(a.hidden, b.hidden), _lane_cos(a.logits, b.logits)
        el = (a.logits.float() - b.logits.float()).abs().amax(dim=-1)
        top2 = torch.topk(b.logits.float(), 2, dim=-1).values
        cb0_ok = (a.cb0.long() == b.cb0.long()) | (top2[:, 0] - top2[:, 1] < 2 * el)
        eh = _max_err(a.hidden, b.hidden)
        print(f"kernel {key} {L} layers {where}: min lane cos hidden {float(ch.min()):.6f} "
              f"logits {float(cl.min()):.6f} (err {eh:.3e}, {float(el.max()):.3e}); cb0 "
              f"equal {int((a.cb0 == b.cb0).sum())}/{B}, gate {int(cb0_ok.sum())}/{B}")
        if not (bool((ch >= 0.99).all()) and bool((cl >= 0.99).all()) and bool(cb0_ok.all())):
            raise SmokeFailure(f"{key} (start_min {low}) disagrees with its plain version at "
                               f"full depth")
        run = lambda: fused_talker_step_batched(tp.blocks, tcfg, x, n_past, kva,  # noqa: E731
                                                **greedy)
        rows = (n_past + 1 - start.clamp(max=n_past)).tolist()
        bound_ms, bound_by = talker_step_bound(tp, tcfg, B, n_past, rows=rows)
        sfx = "" if low == lows[0] else f"_start_min_{low}"
        r.update({
            f"max_abs_err_2_layers{sfx}": max(errs_short),
            f"min_lane_cos_all_layers{sfx}": float(min(ch.min(), cl.min())),
            f"max_abs_err{sfx}": max(errs_short + [eh, float(el.max())]),
            f"ms{sfx}": timed(run, dev, iters),
            **talker_call_stats(run, dev, sfx),
            f"bound_ms{sfx}": bound_ms, f"rows_attended{sfx}": int(sum(rows))})
        if not sfx:
            no_start = {k: v for k, v in greedy.items() if k not in ("start", "start_min")}
            run_all = lambda: fused_talker_step_batched(  # noqa: E731
                tp.blocks, tcfg, x, n_past, kva, **no_start)
            r.update(bound_by=bound_by, ms_without_start=timed(run_all, dev, iters),
                     device_ms_without_start=device_ms_per_call(run_all, 1,
                                                                TALKER_KERNEL_PREFIXES, dev),
                     bound_ms_without_start=talker_step_bound(tp, tcfg, B, n_past)[0],
                     plain_ms=timed(lambda: fused_talker_step_batched_plain(
                         tp.blocks, tcfg, x, n_past, kv0, **greedy), dev, iters))
        del kva
    r["max_abs_err"] = max(v for k, v in r.items() if k.startswith("max_abs_err"))
    report[key] = dict(
        r, library_ms=None,
        shape=(f"B={B} C={C} n_past={n_past}, per-lane sampling; starts spread over "
               f"[low, n_past] with start_min = low, low in {list(lows)} (the unsuffixed "
               f"numbers at low = {lows[0]})"),
        tolerance=("per lane: 2 layers hidden 0.0, kv rows 0.0, logits 1e-3, cb0 equal; "
                   "all layers cosine 0.99"))
    del kv0


def _int8_cache(kv):
    """The (q, scale) pair of a bf16 cache (ops/kv_quant.quantize_kv),
    quantized slice by slice along its first axis (no float32 copy of the
    whole cache)."""
    import torch

    from qwen3tts_tpu_torch.ops.kv_quant import quantize_kv

    parts = [quantize_kv(kv[i]) for i in range(kv.shape[0])]
    return torch.stack([q for q, _ in parts]), torch.stack([s for _, s in parts])


def _clone_pair(pair, n_layers=None, lane_axis=False):
    """A contiguous copy of an int8 cache pair, cut to its first n_layers
    layers (axis 0, or 1 with lane_axis)."""
    import torch

    cut = (slice(None),) * int(lane_axis) + (slice(0, n_layers),)
    return tuple(t[cut].clone(memory_format=torch.contiguous_format) for t in pair)


def _same_pair(a, b):
    """Both halves of two int8 cache pairs equal bit for bit."""
    import torch

    return bool(torch.equal(a[0], b[0])) and bool(torch.equal(a[1].view(torch.int32),
                                                             b[1].view(torch.int32)))


def _kv_int8_gates(step, plain, full_blocks, cfg, short_blocks, short_cfg, x, n_past, pair,
                   greedy, sampled, what, lane_axis):
    """Hold `step` (K1 or K5) over the int8 cache `pair` against `plain` on
    clones of it, from identical inputs: (1) the first 2 layers, greedy and
    sampled: hidden 0.0, logits 1e-3 (the head sums in float32 in two
    orders), the whole (q, scale) cache equal bit for bit after the step,
    cb0 equal in every lane; (2) all layers, greedy: hidden 0.0, the cache
    equal, cb0 equal unless the plain logits' top-2 gap is below twice the
    logits error. Returns the worst (2-layer, all-layer) error."""
    import torch

    worst = [0.0, 0.0]
    for i, (blocks, c, runs) in enumerate(((short_blocks, short_cfg, (greedy, sampled)),
                                           (full_blocks, cfg, (greedy,)))):
        for kw in runs:
            ka = _clone_pair(pair, c.n_layers, lane_axis)
            kb = _clone_pair(pair, c.n_layers, lane_axis)
            a = step(blocks, c, x, n_past, ka, **kw)
            b = plain(blocks, c, x, n_past, kb, **kw)
            eh, el = _max_err(a.hidden, b.hidden), _max_err(a.logits, b.logits)
            same = _same_pair(ka, kb)
            ca, cb = a.cb0.reshape(-1).long(), b.cb0.reshape(-1).long()
            top2 = torch.topk(b.logits.float().reshape(ca.numel(), -1), 2, dim=-1).values
            cb0_ok = bool(((ca == cb) | (top2[:, 0] - top2[:, 1] < 2 * el)).all()) if i \
                else bool((ca == cb).all())
            print(f"kernel {what} {c.n_layers} layers n_past={n_past} greedy={kw['greedy']}: "
                  f"hidden err {eh:.3e}, logits err {el:.3e}, (q, scale) cache "
                  f"{'equal' if same else 'DIFFERS'}, cb0 equal {int((ca == cb).sum())}/"
                  f"{ca.numel()}")
            if not (eh == 0.0 and (i or el <= 1e-3) and same and cb0_ok):
                raise SmokeFailure(f"{what} ({c.n_layers} layers, n_past {n_past}) disagrees "
                                   f"with its plain version")
            worst[i] = max(worst[i], eh, el)
        del ka, kb
    return worst


def check_talker_step_kv_int8(tts, report, iters, single=((512, (10, 300)), (4352, (4000,))),
                              batched=((16, 4352, (4000,)), (64, 512, (10, 300)),
                                       (5, 512, (10,)))):
    """K1 and K5 over the int8-KV tier's (q, scale) cache against their
    plain versions, in tts's weight mode, teacher-forced single steps from
    clones of one quantized cache (a random bf16 cache through quantize_kv),
    with the gates of ``_kv_int8_gates`` at each K1 (C, n_past) of `single`
    and K5 (B, C, n_past) of `batched`. Timed: K1 at C = 4352, n_past 300
    and 4000; K5 at B = 16, C = 4352, n_past = 4000 and at B = 64, C = 512,
    n_past = 300 (the headline, K5's bf16-KV headline shape), each beside
    the bf16-KV time at the same shape where ``check_talker_step`` and
    ``check_talker_step_batched`` put it in the report; the kernels of one
    call over each cache (``device_breakdown``): K1 at its last (C,
    n_past), K5 at C > 4000. Bound:
    the bytes of the weights, head, int8 rows and row scales read. Then the
    memory of one K5 call at B = 64, C = 4352 in both tiers
    (``kv_memory``)."""
    import torch

    from qwen3tts_tpu_torch.ops.fused_talker_step import (
        fused_talker_step, fused_talker_step_batched, fused_talker_step_batched_plain,
        fused_talker_step_plain)

    tp, dev = tts.talker_params, tts.device
    tcfg = tts.config.talker
    L, Hkv, D, Vc = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim, tcfg.codec_vocab_size
    g = torch.Generator(device=dev).manual_seed(41)
    short_blocks, short_cfg = _truncated(tts, min(2, L))

    def kws(B, per_lane):
        seen = torch.zeros((B, Vc) if per_lane else (Vc,), dtype=torch.int8, device=dev)
        seen[..., :64] = 1
        base = dict(output_norm=tp.output_norm, codec_head=tp.codec_head, seen=seen, top_k=50,
                    repetition_penalty=1.05, suppress_start=Vc - 1024, eos_id=tcfg.codec_eos_id)
        if per_lane:
            base["seeds"] = torch.arange(B, dtype=torch.int32, device=dev) * 7919 - 1000
        else:
            base["seed"] = 17
        return (dict(base, temperature=0.0, greedy=True, use_top_p=False),
                dict(base, temperature=0.9, greedy=False, use_top_p=False))

    def cache(shape):
        kv = torch.randn(shape, generator=g, device=dev, dtype=tts.dtype) * 0.5
        return kv, _int8_cache(kv)

    # K1
    key = "fused_talker_step[kv_int8]"
    x = torch.randn((tcfg.hidden_size,), generator=g, device=dev).to(tts.dtype)
    greedy, sampled = kws(1, False)
    errs, r = [0.0, 0.0], {}
    for C, n_pasts in single:
        kv, pair = cache((L, 2, Hkv, C, D))
        for n_past in n_pasts:
            w = _kv_int8_gates(fused_talker_step, fused_talker_step_plain, tp.blocks, tcfg,
                               short_blocks, short_cfg, x, n_past, pair, greedy, sampled,
                               f"{key} C={C}", False)
            errs = [max(a, b) for a, b in zip(errs, w)]
    # the kernels of one call over each cache, at the last C and n_past
    r.update(top_device_ms=device_breakdown(
        lambda: fused_talker_step(tp.blocks, tcfg, x, n_past, pair, **greedy), dev),
        bf16_kv_top_device_ms=device_breakdown(
            lambda: fused_talker_step(tp.blocks, tcfg, x, n_past, kv, **greedy), dev))
    del kv
    bf16 = report.get("fused_talker_step", {})
    for n_past, sfx in ((300, ""), (4000, "_n_past_4000")):
        run = lambda n=n_past: fused_talker_step(tp.blocks, tcfg, x, n, pair,  # noqa: E731
                                                 **greedy)
        r[f"ms{sfx}"] = timed(run, dev, iters)
        r.update(talker_call_stats(run, dev, sfx))
        r[f"bound_ms{sfx}"], bound_by = talker_step_bound(tp, tcfg, 1, n_past, kv_int8=True)
        r[f"bf16_kv_ms{sfx}"] = bf16.get(f"ms{sfx}")
    r["plain_ms"] = timed(lambda: fused_talker_step_plain(tp.blocks, tcfg, x, 300, pair,
                                                          **greedy), dev, iters)
    report[key] = dict(
        r, bound_by=bound_by, library_ms=None, max_abs_err=max(errs),
        max_abs_err_2_layers=errs[0], max_abs_err_all_layers=errs[1],
        shape=f"C={pair[0].shape[3]} n_past=300 (and 4000)",
        tolerance=("2 layers: hidden 0.0, (q, scale) cache bit for bit, logits 1e-3, cb0 equal; "
                   "all layers: hidden 0.0, cache bit for bit"))
    del pair

    # K5
    key = "fused_talker_step_batched[kv_int8]"
    errs, times = [0.0, 0.0], {}
    bf16 = report.get("fused_talker_step_batched", {})
    for B, C, n_pasts in batched:
        x = torch.randn((B, tcfg.hidden_size), generator=g, device=dev).to(tts.dtype)
        greedy, sampled = kws(B, True)
        kv, pair = cache((B, L, 2, Hkv, C, D))
        for n_past in n_pasts:
            w = _kv_int8_gates(fused_talker_step_batched, fused_talker_step_batched_plain,
                               tp.blocks, tcfg, short_blocks, short_cfg, x, n_past, pair,
                               greedy, sampled, f"{key} B={B} C={C}", True)
            errs = [max(a, b) for a, b in zip(errs, w)]
        n_t = n_pasts[-1]
        run = lambda: fused_talker_step_batched(tp.blocks, tcfg, x, n_t, pair,  # noqa: E731
                                                **greedy)
        where = f"B={B} C={C} n_past={n_t}"
        times[where] = dict(
            ms=timed(run, dev, iters),
            **talker_call_stats(run, dev),
            bound_ms=talker_step_bound(tp, tcfg, B, n_t, kv_int8=True)[0],
            bf16_kv_ms=(bf16.get("times", {}).get(where) or {}).get("ms"))
        if C > 4000:   # where attention costs most: the kernels of one call, both caches
            times[where].update(top_device_ms=device_breakdown(run, dev), bf16_kv_top_device_ms=(
                device_breakdown(lambda: fused_talker_step_batched(tp.blocks, tcfg, x, n_t, kv,
                                                                   **greedy), dev)))
        del kv
        if (B, C) == (64, 512):
            head = dict(times[where], plain_ms=timed(lambda: fused_talker_step_batched_plain(
                tp.blocks, tcfg, x, n_t, pair, **greedy), dev, iters), shape=where)
            bound_by = talker_step_bound(tp, tcfg, B, n_t, kv_int8=True)[1]
        del pair
    report[key] = dict(
        head, bound_by=bound_by, library_ms=None, max_abs_err=max(errs),
        max_abs_err_2_layers=errs[0], max_abs_err_all_layers=errs[1], times=times,
        memory=kv_memory(tts) if dev.type == "cuda" else None,
        tolerance=("per lane: 2 layers hidden 0.0, (q, scale) cache bit for bit, logits 1e-3, "
                   "cb0 equal; all layers hidden 0.0, cache bit for bit"))


def kv_memory(tts, B=64, C=4352, n_past=300):
    """The cache's bytes and torch.cuda.max_memory_allocated around one K5
    call (greedy, no sampling) at B lanes and capacity C, for a bf16 cache
    and for the int8 (q, scale) pair: each cache allocated, the peak
    statistics reset, the call made and synchronized. Returns {tier:
    {cache_bytes, allocated_before, peak_allocated}}."""
    import torch

    from qwen3tts_tpu_torch.ops.fused_talker_step import fused_talker_step_batched

    tp, dev, tcfg = tts.talker_params, tts.device, tts.config.talker
    shape = (B, tcfg.n_layers, 2, tcfg.n_kv_heads, C, tcfg.head_dim)
    x = torch.zeros((B, tcfg.hidden_size), device=dev, dtype=tts.dtype)
    out = {}
    for tier in ("bf16", "int8"):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        kv = (torch.zeros(shape, dtype=torch.bfloat16, device=dev) if tier == "bf16" else
              (torch.zeros(shape, dtype=torch.int8, device=dev),
               torch.full(shape[:-1], 1e-8 / 127, dtype=torch.float32, device=dev)))
        nbytes = _nbytes(*(kv if isinstance(kv, tuple) else (kv,)))
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        fused_talker_step_batched(tp.blocks, tcfg, x, n_past, kv, output_norm=tp.output_norm,
                                  codec_head=tp.codec_head)
        torch.cuda.synchronize(dev)
        out[tier] = dict(cache_bytes=nbytes, allocated_before=before,
                         peak_allocated=torch.cuda.max_memory_allocated(dev))
        print(f"memory K5 B={B} C={C} {tier} KV: cache {nbytes} bytes, allocated before the "
              f"call {before}, peak {out[tier]['peak_allocated']}")
        del kv
    torch.cuda.empty_cache()
    out["int8_over_bf16_cache"] = out["int8"]["cache_bytes"] / out["bf16"]["cache_bytes"]
    return out


def check_code_predictor_per_lane(tts, report, iters, B=64):
    """K6 with per-lane temperature and top-p (``lane_sampling``), greedy,
    sampled and sampled with top-p, B distinct seeds. Gate: every lane's 15
    codes equal the plain version's, rest_sum within 1e-3."""
    import torch

    from qwen3tts_tpu_torch.ops.fused_code_predictor_batched import (
        fused_predict_codes_batched, fused_predict_codes_batched_plain)

    key = "fused_predict_codes_batched[per_lane]"
    cp, ccfg, dev = tts.cp_params, tts.config.code_predictor, tts.device
    g = torch.Generator(device="cpu").manual_seed(37)
    th = torch.randn((B, ccfg.hidden_size), generator=g).to(device=dev, dtype=tts.dtype)
    cb0 = tts.talker_params.codec_embd[torch.arange(B, device=dev) * 31 + 7]
    seeds = torch.arange(B, dtype=torch.int32, device=dev) * 104729 - 5000
    samp = lane_sampling(B, dev)
    lane = dict(temperature=samp["temperature"], top_p=samp["top_p"], top_k=50)
    err = 0.0
    for kw in (dict(lane, greedy=True, use_top_p=False),
               dict(lane, greedy=False, use_top_p=False),
               dict(lane, greedy=False, use_top_p=True)):
        ca, sa = fused_predict_codes_batched(cp, ccfg, th, cb0, seeds, **kw)
        cb, sb = fused_predict_codes_batched_plain(cp, ccfg, th, cb0, seeds, **kw)
        lanes_equal = int((ca.long() == cb.long()).all(dim=1).sum())
        e = _max_err(sa, sb)
        print(f"kernel {key} B={B} greedy={kw['greedy']} top_p={kw['use_top_p']}: codes equal "
              f"in {lanes_equal}/{B} lanes; rest_sum err {e:.3e}")
        if not (lanes_equal == B and e <= 1e-3):
            raise SmokeFailure(f"{key} disagrees with its plain version")
        err = max(err, e)
    bound_ms, bound_by = code_predictor_bound(cp, ccfg, B)
    run = lambda: fused_predict_codes_batched(cp, ccfg, th, cb0, seeds, **kw)  # noqa: E731
    report[key] = dict(
        max_abs_err=err, ms=timed(run, dev, iters),
        device_ms=device_ms_per_call(run, 1, (CP_KERNEL,), dev, expect=1),
        kernels_per_call=cp_kernels_per_call(run, dev, key), grid=cp_grid(ccfg, B, dev),
        plain_ms=timed(lambda: fused_predict_codes_batched_plain(cp, ccfg, th, cb0, seeds, **kw),
                       dev, iters),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=f"B={B}, one frame-set, per-lane temperature and top-p",
        tolerance="codes equal per lane; rest_sum 1e-3 abs")


def _bf16_ulp(a):
    """The bf16 spacing at each |a| (8 significant bits)."""
    import torch

    a = a.float().abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def int8_mm_within(a, b, rel):
    """The W8A16 GEMM's tolerance against its plain version: each element
    within one bf16 ulp (float32 x, rel: 1e-5 relative) of the plain
    output, plus 1e-5 of the largest |plain| for outputs near 0."""
    tol = (1e-5 * b.float().abs() if rel else _bf16_ulp(b)) + 1e-5 * float(b.abs().max())
    return float(((a.float() - b.float()).abs() - tol).max()) <= 0


def attention_within(a, b):
    """Decode attention's tolerance against its plain version: each element
    within one bf16 ulp, plus 1e-6 for outputs near 0."""
    return bool(((a.float() - b.float()).abs() <= _bf16_ulp(b) + 1e-6).all())


def _layer_cycle(fn, n):
    """A call of fn(i) for i = 0..n-1: one timed unit that walks n layers'
    operands, so that, as on the main path, each call finds its operands
    in device memory and not in the 50 MB L2."""
    def run():
        for i in range(n):
            fn(i)

    return run


# the M at which the W8A16 GEMM is checked with float32 x (always on its
# FFMA path): one and two row blocks (8 | 9), a batch's lanes and the
# batched code predictor's prefill (256)
INT8_MM_FLOAT_ROWS = (1, 8, 9, 16, 128, 256)


def check_int8_matmul(tts, report, iters, rows=(1, 10, 64, 128)):
    """The W8A16 GEMM at the four projection shapes (K, N) of the talker's
    blocks, for each M of `rows` (1: an unfused single-stream step; 10: the
    prefill; up to 128: the batched unfused step's lanes) with bf16 x, at
    w_down for M = 2 * the last of `rows`, and with float32 x at the QKV
    shape for each M of INT8_MM_FLOAT_ROWS.
    Tolerance: each element within one bf16 ulp (float32 x: 1e-5 relative)
    of the plain version, plus 1e-5 of the largest |plain| for outputs near
    0, where the two float32 summation orders' rounding is the larger term.
    Every case must run as one kernel launch per call (the profiler's count
    over a 28-layer cycle). Timed per call cycling over the 28 layers'
    weights (cold in L2, as on the main path): ms from CUDA events around
    the run (the host's launch gaps included), device_ms the kernel's own
    time under the profiler; library_ms is torch._weight_int8pack_mm where
    this PyTorch has it for CUDA (the port never calls it)."""
    import torch

    from qwen3tts_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    blocks, dev = tts.talker_params.blocks, tts.device
    L = tts.config.talker.n_layers
    g = torch.Generator(device="cpu").manual_seed(19)
    names = ("wqkv", "wo", "w_gateup", "w_down")
    worst, times = 0.0, {}

    cases = [(name, M, tts.dtype) for name in names for M in rows]
    cases += [("wqkv", M, torch.float32) for M in INT8_MM_FLOAT_ROWS]
    cases += [("w_down", 2 * rows[-1], tts.dtype)]
    per_call = {}
    for name, M, dt in cases:
        w = getattr(blocks, name)
        K, N = w.q.shape[1:]
        x = torch.randn((M, K), generator=g).to(device=dev, dtype=dt)
        a = int8_matmul(x, w.q[0], w.scale[0])
        b = int8_matmul_plain(x, w.q[0], w.scale[0])
        e = _max_err(a, b)
        ok = int8_mm_within(a, b, rel=dt == torch.float32)
        cycle = _layer_cycle(lambda l: int8_matmul(x, w.q[l], w.scale[l]), L)
        n = launches_per_call(cycle, L, ("",), dev)
        print(f"kernel int8_matmul {name} M={M} K={K} N={N} x {str(dt)[6:]}: err {e:.3e} "
              f"({'within' if ok else 'OUTSIDE'} tolerance), {n} launches per call")
        if not ok:
            raise SmokeFailure(f"int8_matmul disagrees at {name}, M={M}, {dt}")
        if dev.type == "cuda" and n != 1:
            raise SmokeFailure(f"int8_matmul took {n} launches per call at {name}, M={M}, {dt}")
        per_call[f"{name} M={M} x {str(dt)[6:]}"] = n
        worst = max(worst, e)
        if (name, M) == ("wqkv", 1):
            headline_x = x
        if dt == tts.dtype and M in rows:
            run = _layer_cycle(lambda l: int8_matmul(x, w.q[l], w.scale[l]), L)
            nbytes = K * N + M * K * 2 + N * 4 + M * N * 2
            times[f"{name} M={M} K={K} N={N}"] = dict(
                ms=timed(run, dev, iters) / L,
                device_ms=device_ms_per_call(run, L, ("int8_mm_",), dev),
                bound_ms=bound(nbytes, {"bf16": 2 * M * K * N})[0])
    # the headline: one projection of an unfused single-stream step
    w, x = blocks.wqkv, headline_x
    K, N = w.q.shape[1:]
    head = times[f"wqkv M=1 K={K} N={N}"]
    library_ms = library_device_ms = None
    if hasattr(torch, "_weight_int8pack_mm"):
        for name, xl in (("wqkv", x), ("w_down", torch.randn(
                (rows[-1], blocks.w_down.q.shape[1]), generator=g).to(device=dev, dtype=tts.dtype))):
            wl = getattr(blocks, name)
            wt = [(wl.q[l].t().contiguous(), wl.scale[l].reshape(-1).to(tts.dtype))
                  for l in range(L)]
            try:
                torch._weight_int8pack_mm(xl, *wt[0])
            except (RuntimeError, NotImplementedError) as err:
                print(f"library _weight_int8pack_mm not available here: {str(err)[:120]}")
                break
            lib = _layer_cycle(lambda l, xl=xl, wt=wt: torch._weight_int8pack_mm(xl, *wt[l]), L)
            t = times[f"{name} M={xl.shape[0]} K={xl.shape[1]} N={wl.q.shape[2]}"]
            t.update(library_ms=timed(lib, dev, iters) / L,
                     library_device_ms=device_ms_per_call(lib, L, ("",), dev))
            if name == "wqkv":
                library_ms, library_device_ms = t["library_ms"], t["library_device_ms"]
    bound_ms, bound_by = bound(K * N + K * 2 + N * 4 + N * 2, {"bf16": 2 * K * N})
    report["int8_matmul"] = dict(
        max_abs_err=worst, ms=head["ms"], device_ms=head["device_ms"],
        plain_ms=timed(_layer_cycle(lambda l: int8_matmul_plain(x, w.q[l], w.scale[l]), L), dev,
                       iters) / L,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        library_device_ms=library_device_ms,
        shape=f"wqkv M=1 K={K} N={N} (one unfused step's QKV), per call over {L} layers",
        times=times, launches_per_call=per_call,
        tolerance="one bf16 ulp (float32 x: 1e-5 rel) + 1e-5 * max|plain| abs")


# the shapes at which the decode-attention row reports its yardstick
# (scaled_dot_product_attention's event and device times)
LIBRARY_ATTENTION_SHAPES = ((1, 1280, 300), (16, 4352, 4000))


def _sdpa_layers(q, kv, n):
    """Per layer l, torch.nn.functional.scaled_dot_product_attention of q
    [B, Hq, D] over the valid prefix of layer l of kv (the decode-attention
    kernel's yardstick; the port never calls it)."""
    import torch

    B, Hq, D = q.shape
    Hkv = kv.shape[3]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4 = q.reshape(B, Hq, 1, D)
    try:
        sdpa(q4, kv[:, 0, 0, :, :n], kv[:, 0, 1, :, :n], enable_gqa=True)
        return lambda l: sdpa(q4, kv[:, l, 0, :, :n], kv[:, l, 1, :, :n], enable_gqa=True)
    except TypeError:   # a PyTorch without enable_gqa: the heads expanded beforehand
        kx = [kv[:, l, :, :, :n].repeat_interleave(Hq // Hkv, dim=2) for l in range(kv.shape[1])]
        return lambda l: sdpa(q4, kx[l][:, 0], kx[l][:, 1])


def one_launch(run, L, device, where):
    """Kernels per call of run (L decode-attention calls) under the profiler,
    every kernel counted; fails unless it is one (None off the card)."""
    n = launches_per_call(run, L, ("",), device)
    if n is not None and n != 1:
        raise SmokeFailure(f"decode_attention launched {n} kernels per call at {where}, not 1")
    return n


# the (K, N) at which split_rules holds the GEMM and GEMV plans to their
# mirrors: the talker's four projections and its codec head at 0.6B widths,
# and other widths
GEMV_PLAN_SHAPES = ((1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (1024, 3072),
                    (64, 16), (4096, 256), (1536, 8960), (8192, 128))


def split_rules(device):
    """The kernels' split rules (the library's C functions) against their
    mirrors in the wrappers' modules, which the CPU tests hold to cover each
    lane's rows once: decode attention's splits, and K1/K5's attention
    clusters over a bf16 and an int8 cache, for every B from 1 to 128 at
    the talker's heads and a range of row counts; K5's GEMM plan and K1's
    GEMV plan in each mode, the codec head's GEMV plan
    (tests/test_torch_gemm_order.py and tests/test_torch_gemv_order.py hold
    their mirrors to cover each weight row once), and the projection
    harness's workspace bytes for every B from 1 to 128 (and the head's);
    K3's plan (every width, ragged T, each dilation) and the W8A16 GEMM's
    (M = 1..256 at the talker's shapes, bf16 and float32 x). Returns the
    cases compared; None off the card."""
    if device.type != "cuda":
        return None
    from qwen3tts_tpu_torch import _kernels
    from qwen3tts_tpu_torch.ops.decode_attention import decode_attention_split
    from qwen3tts_tpu_torch.ops.fused_talker_step import attention_clusters

    lib, cases = _kernels.load_library(), 0
    for B in range(1, 129):
        for n in (1, 2, 63, 64, 65, 300, 1000, 4000, 4352, 16000):
            for Hkv, G in ((8, 2), (2, 8)):
                c_dec = lib.qtts_decode_attention_splits(B, Hkv, n)
                c_tlk = [lib.qtts_talker_attention_clusters(B, Hkv, G, n, q8) for q8 in (0, 1)]
                if (c_dec != decode_attention_split(B, Hkv, n)[0]
                        or c_tlk != [attention_clusters(B, Hkv, G, n, q8) for q8 in (0, 1)]):
                    raise SmokeFailure(f"a split rule and its mirror differ at B={B} n={n} "
                                       f"Hkv={Hkv}")
                cases += 3
    # K5's GEMM plan and K1's GEMV plan (every mode and the head, the
    # talker's projections, its head and other widths), and the harness's
    # workspace for every B from 1 to 128
    import ctypes

    from qwen3tts_tpu_torch.ops.fused_talker_step import gemm_plan, gemv_plan
    from qwen3tts_tpu_torch.ops.w4_gemv_probe import HARNESS_CODES, project_ws_bytes

    out = (ctypes.c_int * 3)()
    for mode, code in HARNESS_CODES.items():
        for K, N in GEMV_PLAN_SHAPES:
            plans = [("K1's GEMV", lib.qtts_gemv_plan, gemv_plan)]
            if mode != "head":
                plans.append(("K5's GEMM", lib.qtts_gemm_plan, gemm_plan))
            for what, c_plan, mirror in plans:
                c_plan(code, K, N, ctypes.addressof(out))
                if tuple(out) != mirror(mode, K, N):
                    raise SmokeFailure(f"{what} plan and its mirror differ in {mode} at K={K} "
                                       f"N={N}: {tuple(out)} != {mirror(mode, K, N)}")
                cases += 1
            for B in range(1, 129) if mode != "head" else (1,):
                if lib.qtts_project_ws_bytes(code, B, K, N) != project_ws_bytes(mode, B, K, N):
                    raise SmokeFailure(f"the projection workspace and its mirror differ in "
                                       f"{mode} at B={B} K={K} N={N}")
                cases += 1
    # K3's plan and the W8A16 GEMM's (tests/test_torch_kernel_plans.py holds
    # their mirrors to cover each row, column and K row once)
    from qwen3tts_tpu_torch.ops.fused_vocoder import res_block_plan
    from qwen3tts_tpu_torch.ops.int8_matmul import int8_mm_plan

    out = (ctypes.c_int * 6)()
    for C in (96, 192, 384, 768, 8, 64, 136):
        for T in (1, 127, 128, 129, 64 * 47 + 37, 2048, 10240, 40960, 122880, 2880000):
            for d in (1, 3, 9):
                lib.qtts_res_block_plan(T, C, d, ctypes.addressof(out))
                if tuple(out) != res_block_plan(T, C, d):
                    raise SmokeFailure(f"K3's plan and its mirror differ at T={T} C={C} d={d}: "
                                       f"{tuple(out)} != {res_block_plan(T, C, d)}")
                cases += 1
    out = (ctypes.c_int * 5)()
    for K, N in ((1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (64, 64), (8192, 128)):
        for M in range(1, 257):
            for x_bf16 in (0, 1):
                lib.qtts_int8_mm_plan(M, K, N, x_bf16, ctypes.addressof(out))
                if tuple(out) != int8_mm_plan(M, K, N, bool(x_bf16)):
                    raise SmokeFailure(f"the W8A16 GEMM's plan and its mirror differ at M={M} "
                                       f"K={K} N={N} x_bf16={x_bf16}")
                cases += 1
    print(f"split rules: {cases} cases equal to their mirrors")
    return cases


def check_decode_attention(tts, report, iters, L=None,
                           shapes=((1, 1280, (1, 300, 1000)), (16, 1280, (1, 300, 1000)),
                                   (1, 4352, (1, 300, 1000, 4000)),
                                   (16, 4352, (1, 300, 1000, 4000)))):
    """The decode-attention kernel against its plain version at the talker's
    heads and head_dim on a random bf16 cache of L layers (default: all),
    for each (B, C, n_valid) of `shapes`, at the last layer. Tolerance: each
    element within one bf16 ulp of the plain version, plus 1e-6 for outputs
    near 0 (both sum in float32, in other orders). Timed per call cycling
    over the layers, as the unfused step calls it (ms and device_ms as in
    check_int8_matmul). library_ms is
    torch.nn.functional.scaled_dot_product_attention on the same valid
    prefix (the port never calls it), and library_device_ms its device time
    per call under the profiler, over every kernel it launches, at each
    shape of LIBRARY_ATTENTION_SHAPES that `shapes` holds."""
    import torch

    from qwen3tts_tpu_torch.ops.decode_attention import (decode_attention_kernel,
                                                          decode_attention_kernel_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg, dev = tts.config.talker, tts.device
    L = L or tcfg.n_layers
    Hq, Hkv, D = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim
    g = torch.Generator(device=dev).manual_seed(23)
    worst, times = 0.0, {}
    for B, C, n_valids in shapes:
        kv = torch.randn((B, L, 2, Hkv, C, D), generator=g, device=dev, dtype=tts.dtype)
        q = torch.randn((B, Hq, D), generator=g, device=dev).to(tts.dtype)
        for n in n_valids:
            a = decode_attention_kernel(q, kv, L - 1, n)
            b = decode_attention_kernel_plain(q, kv, L - 1, n)
            e = _max_err(a, b)
            ok = attention_within(a, b)
            print(f"kernel decode_attention B={B} C={C} n_valid={n}: err {e:.3e} "
                  f"({'within' if ok else 'OUTSIDE'} one bf16 ulp)")
            if not ok:
                raise SmokeFailure(f"decode_attention disagrees at B={B}, C={C}, n_valid={n}")
            worst = max(worst, e)
            run = _layer_cycle(lambda l: decode_attention_kernel(q, kv, l, n), L)
            t = times[f"B={B} C={C} n_valid={n}"] = dict(
                ms=timed(run, dev, iters) / L,
                device_ms=device_ms_per_call(run, L, ("decode_attn_",), dev),
                launches_per_call=one_launch(run, L, dev, f"B={B} C={C} n_valid={n}"),
                bound_ms=attention_bound(B, Hq, Hkv, D, n)[0])
            if (B, C, n) in LIBRARY_ATTENTION_SHAPES:
                lib = _layer_cycle(_sdpa_layers(q, kv, n), L)
                t.update(library_ms=timed(lib, dev, iters) / L,
                         library_device_ms=device_ms_per_call(lib, L, ("",), dev))
        del kv
    B, C, n = 1, 1280, 300
    kv = torch.randn((B, L, 2, Hkv, C, D), generator=g, device=dev, dtype=tts.dtype)
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(tts.dtype)
    bound_ms, bound_by = attention_bound(B, Hq, Hkv, D, n)
    run = _layer_cycle(lambda l: decode_attention_kernel(q, kv, l, n), L)
    library = _layer_cycle(_sdpa_layers(q, kv, n), L)
    report["decode_attention"] = dict(
        max_abs_err=worst, ms=timed(run, dev, iters) / L,
        device_ms=device_ms_per_call(run, L, ("decode_attn_",), dev),
        launches_per_call=one_launch(run, L, dev, f"B={B} C={C} n_valid={n}"),
        splits=split_rules(dev),
        plain_ms=timed(_layer_cycle(lambda l: decode_attention_kernel_plain(q, kv, l, n), L),
                       dev, iters) / L,
        library_ms=timed(library, dev, iters) / L,
        library_device_ms=device_ms_per_call(library, L, ("",), dev),
        bound_ms=bound_ms, bound_by=bound_by, times=times,
        shape=f"B={B} C={C} n_valid={n} (the unfused 600-token request), per layer",
        tolerance="one bf16 ulp + 1e-6 abs")


def check_w4_gemv_probe(report, device, iters, shape=None):
    """The probe of tools/exp_w4_gemv.py on the card: x [1, K] int8 against
    L layers of int8 [K, N] weights (values in [-8, 8)) and of the same
    values packed two per byte, each against its plain version EXACTLY (an
    int32 sum), timed with CUDA events (ms) and the profiler (device_ms),
    with the rate its weight bytes imply. Beside it, K1's own projection
    kernels at the same shape (ops/w4_gemv_probe.project_layers: one GEMV
    per layer, as run_layer launches it) in w8a8, bf16 and w4bf16 on
    synthetic weights: does 4-bit halve the weight time on this card, or do
    the unpacking and the scales eat the saving?"""
    import torch

    from qwen3tts_tpu_torch.ops import w4_gemv_probe as probe
    from qwen3tts_tpu_torch.ops.quant import quantize_per_channel, quantize_w4

    L, K, N = shape or (probe.L, probe.K, probe.N)
    g = torch.Generator(device="cpu").manual_seed(29)
    x = torch.randint(-127, 128, (1, K), generator=g, dtype=torch.int8).to(device)
    wv = torch.randint(-8, 8, (L, K, N), generator=g, dtype=torch.int8).to(device)
    variants = {"int8": (wv, False), "packed": (probe.pack_nibbles(wv), True)}
    times = {}
    for name, (w, packed) in variants.items():
        a = probe.w4_gemv_probe(x, w, packed)
        b = probe.w4_gemv_probe_plain(x, w, packed)
        err = int((a.long() - b.long()).abs().max())
        print(f"kernel w4_gemv_probe {name} L={L} K={K} N={N}: "
              f"{'exact' if err == 0 else f'DIFFERS by {err}'}")
        if err:
            raise SmokeFailure(f"w4_gemv_probe {name} differs from its plain version")
        nbytes = _nbytes(w, x) + N * 4
        run = lambda w=w, packed=packed: probe.w4_gemv_probe(x, w, packed)  # noqa: E731
        ms = timed(run, device, iters)
        dms = device_ms_per_call(run, 1, ("probe_gemv_kernel",), device, expect=1)
        times[name] = dict(
            ms=ms, device_ms=dms, weight_bytes=_nbytes(w),
            gb_per_s=_nbytes(w) / ((dms or ms) * 1e-3) / 1e9,
            plain_ms=timed(lambda w=w, packed=packed: probe.w4_gemv_probe_plain(x, w, packed),
                           device, iters),
            bound_ms=bound(nbytes, {"int8": 2 * L * K * N})[0])
    # K1's projection kernels at the probe's shape (a harness of the card
    # only: there is no plain version to run on the CPU)
    k1 = {}
    if device.type == "cuda":
        wf = torch.randn((L, K, N), generator=g).div_(K ** 0.5).to(device)
        xf = torch.randn((1, K), generator=g).to(device)
        k1 = {"w8a8": (quantize_per_channel(wf), x), "bf16": (wf.to(torch.bfloat16), xf),
              "w4bf16": (quantize_w4(wf), xf)}
        del wf
    k1_times = {}
    for mode, (w, xin) in k1.items():
        ws = probe.project_layers(xin, w, mode)
        run = lambda w=w, xin=xin, mode=mode, ws=ws: probe.project_layers(  # noqa: E731
            xin, w, mode, ws)
        wb = _nbytes(*(w if hasattr(w, "_fields") else (w,)))
        ms = timed(run, device, iters)
        dms = (_pass_device_ms(run, [L], device) or [None])[0]
        k1_times[mode] = dict(ms=ms, device_ms=dms, weight_bytes=wb,
                              gb_per_s=wb / ((dms or ms) * 1e-3) / 1e9,
                              bound_ms=bound(wb, {})[0])
        print(f"time K1 projection {mode} L={L} K={K} N={N}: {ms:.4f} ms "
              f"(device {dms}) for {wb / 1e6:.1f} MB")
    head = times["packed"]
    bound_ms, bound_by = bound(_nbytes(variants["packed"][0], x) + N * 4,
                               {"int8": 2 * L * K * N})
    report["w4_gemv_probe"] = dict(
        max_abs_err=0.0, ms=head["ms"], device_ms=head["device_ms"],
        plain_ms=head["plain_ms"], bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=f"packed, L={L} K={K} N={N}", times=times, k1_projection_times=k1_times,
        tolerance="exact (int32)")
    for name, t in times.items():
        print(f"time w4_gemv_probe {name}: {t['ms']:.4f} ms (device {t['device_ms']}), "
              f"{t['gb_per_s']:.1f} GB/s of weights")


# the projections alone (check_projections): the talker's four projections
# as (name, K, N) at 0.6B widths, the lane counts checked and timed (B = 1:
# K1's GEMVs; B >= 2: K5's GEMMs), the K1 and K5 entries each weight mode
# reports under
PROJ_LANES = (1, 16, 64, 128)
# the fewest rows torch._int_mm takes on CUDA
INT_MM_MIN_ROWS = 17
K1_KEYS = {"w8a8": "fused_talker_step", "bf16": "fused_talker_step[bf16]",
           "w4bf16": "fused_talker_step[w4bf16]"}
K5_KEYS = {"w8a8": "fused_talker_step_batched", "bf16": "fused_talker_step_batched[bf16]",
           "w4bf16": "fused_talker_step_batched[w4bf16]"}


def talker_projections(tcfg):
    H, hd, F = tcfg.hidden_size, tcfg.n_heads * tcfg.head_dim, tcfg.intermediate_size
    qkv = (tcfg.n_heads + 2 * tcfg.n_kv_heads) * tcfg.head_dim
    return (("wqkv", H, qkv), ("wo", hd, H), ("w_gateup", H, 2 * F), ("w_down", F, H))


def projection_weights(mode, L, K, N, device, seed):
    """L random layers [L, K, N] of one projection in `mode` (seeded): an
    int8 QuantLinear, a bf16 tensor or a u4 QuantLinear4, and their values
    as the kernels multiply them, in float64 (int8 values; bf16 values;
    dequantized u4 rounded to bf16), for the library's product."""
    import torch

    from qwen3tts_tpu_torch.ops.quant import dequantize4, quantize_per_channel, quantize_w4

    g = torch.Generator(device=device).manual_seed(seed)
    wf = torch.randn((L, K, N), generator=g, device=device).div_(K ** 0.5)
    if mode == "w8a8":
        w = quantize_per_channel(wf)
        return w, None
    if mode == "bf16":
        w = wf.to(torch.bfloat16)
        return w, w.double()
    w = quantize_w4(wf)
    return w, dequantize4(w).to(torch.bfloat16).double()


def _layer(w, l):
    """Layer l of a stacked weight, kept as a stack of one."""
    return type(w)(*(t[l:l + 1] for t in w)) if hasattr(w, "_fields") else w[l:l + 1]


def projection_bound(w, mode, L, B, K, N):
    """(bound_ms, bound_by, f64_floor_ms) of one pass of L layers of x [B, K]
    @ W_l [K, N]. The bound: the weights (every leaf), x and the L float32
    or int32 results [B, N] once each; 2 B K N operations a layer at the
    peak of the operands' type, int8 or bf16 (as _stack counts K5's
    products). f64_floor_ms (float modes; None for w8a8) is a floor of the
    port's design, not of the function: the same bytes, and the operations
    at the float64 tensor cores' peak, where the kernels sum to keep the
    plain versions' bits."""
    nbytes = _nbytes(*(w if hasattr(w, "_fields") else (w,))) + B * K * (
        1 if mode == "w8a8" else 4) + L * B * N * 4
    ops = 2 * L * B * K * N
    if mode == "w8a8":
        return (*bound(nbytes, {"int8": ops}), None)
    return (*bound(nbytes, {"bf16": ops}), bound(nbytes, {"f64": ops})[0])


def _library_ms(lib, device, iters):
    """(ms, device ms) of one yardstick run `lib`: CUDA events around the
    run (the host's dispatch of its calls included) and its kernels' own
    time under the profiler; (None, None) where there is none or the
    library refuses the shape (printed: a yardstick's refusal is no fault
    of the port)."""
    if lib is None:
        return None, None
    try:
        return timed(lib, device, iters), device_ms_per_call(lib, 1, ("",), device)
    except RuntimeError as e:
        print(f"library call refused: {e}")
        return None, None


def _pass_device_ms(run, counts, device, tries=3):
    """Device ms of each group of one run of `run` under the profiler, its
    GEMV and GEMM kernels (bare names starting with gemv_ or gemm_) in
    launch order cut into groups of counts[i], each group's the union of
    its kernels' intervals (the GEMVs run with programmatic dependent
    launch, so their intervals overlap); None off the card or when `tries`
    traces in a row did not catch every such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    run()
    torch.cuda.synchronize(device)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize(device)
        ks = sorted((e for e in device_events(prof) if e["cat"] == "kernel" and kernel_name(
            e["name"]).startswith(("gemv_", "gemm_"))), key=lambda e: e["ts"])
        if len(ks) == sum(counts):
            out, i = [], 0
            for n in counts:
                out.append(device_busy_ms(ks[i:i + n]))
                i += n
            return out
    return None


def check_projections(tcfg, report, device, iters, modes=("w8a8", "bf16", "w4bf16"),
                      lanes=PROJ_LANES, check_lanes=PROJ_LANES, L=None):
    """The projection kernels alone (ops/w4_gemv_probe.project_layers: one
    launch per layer, as run_layer launches them: K1's GEMVs for B = 1,
    with programmatic dependent launch, K5's GEMMs for B >= 2) in each
    weight mode, for the talker's four projections on L seeded random
    layers (default: all). For each B of check_lanes and projection: one
    layer on a zeroed workspace against project_layer_plain, the int32
    accumulator equal (w8a8) or the float32 result of the partials, summed
    as the consumer sums them, with the same bits (float modes); any
    difference fails. For each B of lanes: each projection's L-layer pass
    timed by CUDA events (ms) and the profiler (device_ms, the union of its
    kernels' intervals), the weight bytes it streams per second of device
    time (gb_per_s), its bound and the float modes' float64 floor
    (projection_bound), and the library yardstick, timed the same two ways
    (library_ms, library_device_ms): one PyTorch call per layer for the
    same function, which the port never calls: torch._int_mm (int8 x int8
    -> int32; on CUDA it takes more than 16 rows, so at B <= 16 x is padded
    with zero rows to INT_MM_MIN_ROWS = 17 and the padded product is timed) or
    float64 torch.matmul over the values the kernels multiply (for w4bf16
    dequantized in advance). The stage's totals (the four projections: one
    K1 or K5 call's projections) and the per-projection rows go into the
    mode's K1 entry (K1_KEYS, B = 1) or K5 entry (K5_KEYS), under
    "projections"."""
    import torch

    from qwen3tts_tpu_torch.ops import w4_gemv_probe as probe

    L = L or tcfg.n_layers
    shapes = talker_projections(tcfg)
    g = torch.Generator(device=device).manual_seed(31)
    t0 = time.perf_counter()
    for mode in modes:
        rows = {B: {} for B in lanes}
        for j, (name, K, N) in enumerate(shapes):
            w, wd = projection_weights(mode, L, K, N, device, seed=100 + j)
            w1 = _layer(w, L - 1)
            for B in sorted(set(check_lanes) | set(lanes)):
                if mode == "w8a8":
                    x = torch.randint(-127, 128, (B, K), generator=g, device=device,
                                      dtype=torch.int8)
                else:   # bf16 values, as the row kernels emit them
                    x = torch.randn((B, K), generator=g, device=device).to(
                        torch.bfloat16).float()
                kind = "K1 GEMV" if B == 1 else "K5 GEMM"
                if B in check_lanes:
                    ws = torch.zeros(probe.project_ws_bytes(mode, B, K, N),
                                     dtype=torch.uint8, device=device)
                    a = probe.project_result(probe.project_layers(x, w1, mode, ws), mode, B,
                                             K, N)
                    b = probe.project_layer_plain(x, w1, mode, 0)
                    same = torch.equal(a.view(torch.int32), b.view(torch.int32))
                    print(f"kernel {kind} projection {mode} {name} K={K} N={N} B={B}: "
                          f"{'equal' if same else 'DIFFERS'} (max abs err {_max_err(a, b):.3e})")
                    if not same:
                        raise SmokeFailure(f"the {kind} in {mode} differs from its plain "
                                           f"version at {name}, B={B}")
                if B not in lanes:
                    continue
                ws = probe.project_layers(x, w, mode)
                run = lambda x=x, w=w, ws=ws: probe.project_layers(x, w, mode, ws)  # noqa: E731
                if mode == "w8a8":
                    # torch._int_mm takes more than 16 rows on CUDA: at B <= 16
                    # x is padded with zero rows to 17, which it then computes
                    xp = x if B > 16 else torch.cat(
                        [x, x.new_zeros((INT_MM_MIN_ROWS - B, K))])
                    lib = _layer_cycle(lambda l, xp=xp, q=w.q: torch._int_mm(xp, q[l]), L)
                else:
                    xd = x.double()
                    lib = _layer_cycle(lambda l, xd=xd: torch.matmul(xd, wd[l]), L)
                bound_ms, bound_by, floor_ms = projection_bound(w, mode, L, B, K, N)
                lib_ms, lib_device_ms = _library_ms(lib, device, iters)
                rows[B][name] = dict(ms=timed(run, device, iters), run=run,
                                     weight_bytes=_nbytes(*(w if hasattr(w, "_fields")
                                                            else (w,))),
                                     library_ms=lib_ms, library_device_ms=lib_device_ms,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     f64_floor_ms=floor_ms)
            del w, wd, w1
        for B, per in rows.items():
            runs = [r.pop("run") for r in per.values()]
            dms = _pass_device_ms(lambda runs=runs: [r() for r in runs], [L] * len(runs),
                                  device)
            for r, d in zip(per.values(), dms or [None] * len(runs)):
                r["device_ms"] = d
                r["gb_per_s"] = None if d is None else r["weight_bytes"] / (d * 1e-3) / 1e9

            def total(key):
                v = [r[key] for r in per.values()]
                return None if None in v else sum(v)

            t = dict(ms=total("ms"), device_ms=None if dms is None else sum(dms),
                     weight_bytes=total("weight_bytes"), bound_ms=total("bound_ms"),
                     f64_floor_ms=total("f64_floor_ms"), library_ms=total("library_ms"),
                     library_device_ms=total("library_device_ms"), shapes=per)
            t["gb_per_s"] = (None if t["device_ms"] is None
                             else t["weight_bytes"] / (t["device_ms"] * 1e-3) / 1e9)
            print(f"time {'K1' if B == 1 else 'K5'} projections {mode} B={B}, {L} layers: "
                  f"{t['ms']:.4f} ms (device {t['device_ms']}, {t['gb_per_s']} GB/s), bound "
                  f"{t['bound_ms']:.4f} ms (float64 floor {t['f64_floor_ms']}), library "
                  f"{t['library_ms']} ms (device {t['library_device_ms']})")
            key = K1_KEYS[mode] if B == 1 else K5_KEYS[mode]
            entry = report.setdefault(key, {}).setdefault("projections", dict(
                layers=L, times={},
                library=("torch._int_mm (int32; it refuses 16 rows or fewer, so at B <= 16 "
                         "x padded with zero rows to 17)" if mode == "w8a8" else
                         "float64 torch.matmul over the multiplied values"),
                tolerance="exact: int32 equal (w8a8), float32 bits equal (float modes)"))
            entry["times"][f"B={B}"] = t
        for keys, picked in ((K1_KEYS, [B for B in check_lanes if B == 1]),
                             (K5_KEYS, [B for B in check_lanes if B > 1])):
            if picked:
                report.setdefault(keys[mode], {}).setdefault("projections", dict(
                    layers=L, times={}))["checked_lanes"] = picked
    print(f"projection phase: {time.perf_counter() - t0:.1f} s")


def check_head_gemv(tcfg, report, device, iters, L=None):
    """K1's codec-head GEMV alone (project_layers mode "head", B = 1: x [1,
    H] float32 @ bf16 [H, Vc] into float32 split partials, which
    head_sample_kernel adds in order) on L seeded random heads (default:
    the talker's layer count, so that each call finds its weights cold, as
    K1 does): the last one against the plain version (x rounded to bf16 @ W
    in float32) within 1e-3 (both sum in float32, in other orders); the
    L-call pass timed by events and the profiler (union of intervals), per
    call, with its weight GB/s, its bound (weights, x and the float32
    logits once) and the library call: float32 torch.matmul over the bf16
    values converted in advance (TF32 off). Reported under K1's w8a8 entry
    as "codec_head" (the head is bf16 in every mode)."""
    import torch

    from qwen3tts_tpu_torch.ops import w4_gemv_probe as probe

    torch.backends.cuda.matmul.allow_tf32 = False
    L = L or tcfg.n_layers
    K, N = tcfg.hidden_size, tcfg.codec_vocab_size
    g = torch.Generator(device=device).manual_seed(37)
    w = torch.randn((L, K, N), generator=g, device=device).div_(K ** 0.5).to(torch.bfloat16)
    x = torch.randn((1, K), generator=g, device=device)
    ws = torch.zeros(probe.project_ws_bytes("head", 1, K, N), dtype=torch.uint8, device=device)
    a = probe.project_result(probe.project_layers(x, w[L - 1:], "head", ws), "head", 1, K, N)
    b = probe.project_layer_plain(x, w, "head", L - 1)
    err = _max_err(a, b)
    print(f"kernel K1 codec head GEMV K={K} N={N}: max abs err {err:.3e} (tolerance 1e-3)")
    if not err <= 1e-3:
        raise SmokeFailure(f"K1's codec-head GEMV differs from its plain version by {err}")
    run = lambda: probe.project_layers(x, w, "head", ws)  # noqa: E731
    dms = _pass_device_ms(run, [L], device)
    wf, xb = w.float(), x.to(torch.bfloat16).float()
    lib = _layer_cycle(lambda l: torch.matmul(xb, wf[l]), L)
    lib_ms, lib_device_ms = _library_ms(lib, device, iters)
    wb = K * N * 2
    bound_ms, bound_by = bound(wb + K * 4 + N * 4, {"bf16": 2 * K * N})
    t = dict(ms=timed(run, device, iters) / L, device_ms=None if dms is None else dms[0] / L,
             weight_bytes=wb, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
             library_ms=None if lib_ms is None else lib_ms / L,
             library_device_ms=None if lib_device_ms is None else lib_device_ms / L,
             library="float32 torch.matmul over the bf16 values (TF32 off)",
             shape=f"K={K} N={N}, per call over {L} heads", tolerance="1e-3 abs")
    t["gb_per_s"] = None if t["device_ms"] is None else wb / (t["device_ms"] * 1e-3) / 1e9
    print(f"time K1 codec head GEMV: {t['ms']:.4f} ms (device {t['device_ms']}, "
          f"{t['gb_per_s']} GB/s), bound {bound_ms:.5f} ms, library {t['library_ms']} ms "
          f"(device {t['library_device_ms']})")
    report.setdefault("fused_talker_step", {})["codec_head"] = t
    del w, wf


def attention_bound(B, Hq, Hkv, D, n):
    """One layer's decode attention: each lane's n K and V rows (bf16), its
    query and output; 4 float32 operations per query head, row and column
    (q.k and p.V)."""
    return bound(B * (2 * n * Hkv * D * 2 + 2 * Hq * D * 2), {"f32": 4 * B * Hq * n * D})


# K3's kernel (csrc/res_block.cu), by its bare name's prefix
K3_PREFIXES = ("res_conv_kernel",)


def _conv_pair(args, d):
    """The res block's two convolutions alone through cuDNN
    (torch.nn.functional.conv1d, channels first, TF32 off): the dilated
    7-tap conv over x padded in advance, then the 1x1 conv, with their
    biases, no snake (a yardstick for K3's row; the port never calls it)."""
    import torch.nn.functional as F

    x, w1, b1, _, _, w2, b2 = args[:7]
    xp = F.pad(x.t().unsqueeze(0), (6 * d, 0)).contiguous()
    w1c, w2c = w1.permute(2, 1, 0).contiguous(), w2.permute(2, 1, 0).contiguous()
    return lambda: F.conv1d(F.conv1d(xp, w1c, b1, dilation=d), w2c, b2)


def check_res_block(tts, report, iters):
    """K3 at each decoder block's (C, T, d) for a clip of 64 frames, on the
    synthetic res-block weights and unit-normal inputs, and a ragged T.
    Tolerance: max abs error <= 1e-4 * (1 + max |plain|): both run float32
    FMAs (TF32 off) and differ only in summation order. Timed per width
    (the three dilations summed) and over all 12 blocks: CUDA-event ms and
    the kernels' device ms under the profiler, beside the two convolutions
    alone through cuDNN. Launches per res block (the profiler's count of
    K3's kernels in one call) must equal the plan's: one at C = 96 and 192,
    two at the wide widths."""
    import torch

    from qwen3tts_tpu_torch.ops.fused_vocoder import (RB_FUSED_WIDTHS, fused_res_block,
                                                      res_block_plain, res_block_plan)

    vcfg, dev = tts.config.vocoder, tts.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(9)
    frames = 64
    T = frames * 2 ** vcfg.n_convnext
    worst, times, nbytes, flops, widths = 0.0, [], 0, 0, {}

    def launches(run, C, T, d):
        want = res_block_plan(T, C, d)[0]
        n = launches_per_call(lambda: [run() for _ in range(3)], 3, K3_PREFIXES, dev)
        if want != (1 if C in RB_FUSED_WIDTHS else 2) or (dev.type == "cuda" and n != want):
            raise SmokeFailure(f"fused_res_block took {n} launches at C={C} T={T} d={d}; "
                               f"the plan says {want}")
        return n

    for blk, rate in zip(tts.vocoder_params.dec_blocks, vcfg.upsample_rates):
        T *= rate
        C = blk.convt_w.shape[-1]
        x = torch.randn((T, C), generator=g).to(dev)
        res = blk.res
        w = widths.setdefault(C, dict(T=T, ms=0.0, device_ms=0.0, cudnn_convs_device_ms=0.0,
                                      launches_per_res_block=[]))
        for i, d in enumerate(vcfg.res_dilations):
            args = (x, res.conv1_w[i], res.conv1_b[i], res.act1_alpha[i], res.act1_beta[i],
                    res.conv2_w[i], res.conv2_b[i], res.act2_alpha[i], res.act2_beta[i])
            a = fused_res_block(*args, dilation=d)
            b = res_block_plain(*args, dilation=d)
            e = _max_err(a, b)
            tol = 1e-4 * (1.0 + float(b.abs().max()))
            print(f"kernel fused_res_block C={C} T={T} d={d}: err {e:.3e} (tolerance {tol:.3e})")
            if not e <= tol:
                raise SmokeFailure(f"fused_res_block disagrees at C={C}, T={T}, d={d}")
            worst = max(worst, e)
            # a dilated 7-tap conv and a 1x1 conv: 16 C^2 T float32 operations;
            # x in, y out, the weights once
            flops += 16 * C * C * T
            nbytes += 2 * T * C * 4 + _nbytes(*args[1:])
            run = lambda args=args, d=d: fused_res_block(*args, dilation=d)  # noqa: E731
            times.append((timed(run, dev, iters),
                          timed(lambda: res_block_plain(*args, dilation=d), dev, iters)))
            dms = device_ms_per_call(run, 1, K3_PREFIXES, dev)
            cms = device_ms_per_call(_conv_pair(args, d), 1, ("",), dev)
            w["ms"] += times[-1][0]
            w["device_ms"] = None if dms is None or w["device_ms"] is None \
                else w["device_ms"] + dms
            w["cudnn_convs_device_ms"] = None if cms is None or w["cudnn_convs_device_ms"] is None \
                else w["cudnn_convs_device_ms"] + cms
            w["launches_per_res_block"].append(launches(run, C, T, d))
    # a ragged T (not a multiple of the 128-row tile) at the narrowest width,
    # as a request of an odd frame count gives, and at a wide one:
    # correctness and launches only, not timed
    for blk, T in ((tts.vocoder_params.dec_blocks[-1], 64 * 47 + 37),
                   (tts.vocoder_params.dec_blocks[1], 32 * 47 + 37)):
        res = blk.res
        x = torch.randn((T, res.conv1_w.shape[-1]), generator=g).to(dev)
        args = (x, res.conv1_w[2], res.conv1_b[2], res.act1_alpha[2], res.act1_beta[2],
                res.conv2_w[2], res.conv2_b[2], res.act2_alpha[2], res.act2_beta[2])
        b = res_block_plain(*args, dilation=9)
        e = _max_err(fused_res_block(*args, dilation=9), b)
        print(f"kernel fused_res_block ragged T={x.shape[0]} C={x.shape[1]} d=9: err {e:.3e}")
        if not e <= 1e-4 * (1.0 + float(b.abs().max())):
            raise SmokeFailure("fused_res_block disagrees on a ragged T")
        launches(lambda args=args: fused_res_block(*args, dilation=9), x.shape[1], T, 9)
        worst = max(worst, e)
    bound_ms, bound_by = bound(nbytes, {"f32": flops})
    dev_all = [w["device_ms"] for w in widths.values()]
    cudnn_all = [w["cudnn_convs_device_ms"] for w in widths.values()]
    report["fused_res_block"] = dict(
        max_abs_err=worst, ms=sum(t[0] for t in times), plain_ms=sum(t[1] for t in times),
        device_ms=None if None in dev_all else sum(dev_all),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        cudnn_convs_device_ms=None if None in cudnn_all else sum(cudnn_all),
        widths=widths,
        shape=f"all 12 res blocks of a {frames}-frame clip (times summed)",
        tolerance="1e-4 * (1 + max|plain|) abs")


RB_LANES, RB_LANE_FRAMES = 16, 64


def check_res_block_lanes(tts, report, iters, lanes=RB_LANES, frames=RB_LANE_FRAMES):
    """K3 over a group of lanes (the batched vocoder's groups) at each
    decoder block's (C, T) for `lanes` lanes of `frames` frames, d = 9 (the
    widest halo), unit-normal inputs: every lane of the group equal to K3
    on that lane alone, bit for bit (0.0: the tile arithmetic is per lane,
    and a lane's halo before its row 0 reads zeros, not the previous lane's
    rows), and the group within K3's tolerance of the plain version; the
    group takes the plan's launches per res block (one at C = 96 and 192,
    two at 384 and 768) whatever the lane count. Timed: the group's event
    and device ms beside `lanes` one-lane calls'. Adds "lanes" to K3's
    report entry."""
    import torch

    from qwen3tts_tpu_torch.ops.fused_vocoder import (fused_res_block, res_block_plain,
                                                      res_block_plan)

    vcfg, dev = tts.config.vocoder, tts.device
    g = torch.Generator(device="cpu").manual_seed(19)
    T, d = frames * 2 ** vcfg.n_convnext, vcfg.res_dilations[-1]
    out = {}
    for blk, rate in zip(tts.vocoder_params.dec_blocks, vcfg.upsample_rates):
        T *= rate
        C = blk.convt_w.shape[-1]
        res = blk.res
        x = torch.randn((lanes, T, C), generator=g).to(dev)
        w = (res.conv1_w[2], res.conv1_b[2], res.act1_alpha[2], res.act1_beta[2],
             res.conv2_w[2], res.conv2_b[2], res.act2_alpha[2], res.act2_beta[2])
        group = fused_res_block(x, *w, dilation=d)
        lane_err = max(_max_err(group[b], fused_res_block(x[b], *w, dilation=d))
                       for b in range(lanes))
        plain = res_block_plain(x, *w, dilation=d)
        e = _max_err(group, plain)
        tol = 1e-4 * (1.0 + float(plain.abs().max()))
        print(f"kernel fused_res_block {lanes} lanes C={C} T={T} d={d}: each lane against "
              f"the one-lane call {lane_err:.3e} (must be 0.0); against the plain version "
              f"{e:.3e} (tolerance {tol:.3e})")
        if lane_err != 0.0:
            raise SmokeFailure(f"fused_res_block over {lanes} lanes differs from the one-lane "
                               f"call at C={C}: {lane_err}")
        if not e <= tol:
            raise SmokeFailure(f"fused_res_block over {lanes} lanes disagrees with its plain "
                               f"version at C={C}")
        del plain
        run = lambda x=x, w=w: fused_res_block(x, *w, dilation=d)  # noqa: E731
        singles = lambda x=x, w=w: [fused_res_block(x[b], *w, dilation=d)  # noqa: E731
                                    for b in range(lanes)]
        want = res_block_plan(T, C, d)[0]
        n = launches_per_call(lambda: [run() for _ in range(3)], 3, K3_PREFIXES, dev)
        if dev.type == "cuda" and n != want:
            raise SmokeFailure(f"fused_res_block over {lanes} lanes took {n} launches at "
                               f"C={C}; the plan says {want}")
        out[C] = dict(lanes=lanes, T=T, dilation=d, launches_per_res_block=n,
                      lane_max_abs_err=lane_err, max_abs_err=e,
                      ms=timed(run, dev, iters), one_lane_calls_ms=timed(singles, dev, iters),
                      device_ms=device_ms_per_call(run, 1, K3_PREFIXES, dev),
                      one_lane_calls_device_ms=device_ms_per_call(singles, 1, K3_PREFIXES,
                                                                  dev))
        print(f"kernel fused_res_block {lanes} lanes C={C}: {out[C]['ms']:.4f} ms (device "
              f"{out[C]['device_ms']}) beside {lanes} one-lane calls "
              f"{out[C]['one_lane_calls_ms']:.4f} ms (device "
              f"{out[C]['one_lane_calls_device_ms']}); {n} launches per res block")
    report.setdefault("fused_res_block", {})["lanes"] = out


def serve(tts, requests):
    """Run the requests through synthesize; check each result. Returns
    per-request stats (with the launches each request made) and the launch
    counts of the whole run. Only kernel launches count: on CPU tensors the
    plain versions run and the counters stay at 0."""
    import numpy as np

    from qwen3tts_tpu_torch import SamplingConfig

    spf = tts.config.vocoder.samples_per_frame
    stats = []
    reset_counts()
    for text, kw in requests:
        before = read_counts()
        r = tts.synthesize(text, SamplingConfig(**kw))
        moved = {k: v - before[k] for k, v in read_counts().items()}
        ok = (r.success and r.n_frames > 0 and len(r.audio) == r.n_frames * spf
              and bool(np.isfinite(r.audio).all()))
        gen_ms = r.timings.t_generate_ms
        st = dict(request=kw, n_frames=r.n_frames, frames_per_s=r.n_frames / gen_ms * 1e3
                  if gen_ms else 0.0, ms_per_frame=gen_ms / max(r.n_frames, 1),
                  vocoder_ms=r.timings.t_decode_ms, total_ms=r.timings.t_total_ms,
                  launches=moved, ok=ok)
        print(f"request {kw}: success={r.success} frames={r.n_frames} "
              f"audio={len(r.audio)} finite={bool(np.isfinite(r.audio).all())} "
              f"{st['frames_per_s']:.2f} frames/s {st['ms_per_frame']:.3f} ms/frame "
              f"vocoder {st['vocoder_ms']:.1f} ms launches {moved}")
        if not ok:
            raise SmokeFailure(f"request {kw} failed: {r.error_msg or 'checks'}")
        codes = r.codes
        if not ((codes[:, 0] < 2048).all() and (codes[:, 1:] < 2048).all()
                and (codes >= 0).all()):
            raise SmokeFailure(f"request {kw}: codes out of range")
        stats.append(st)
    return stats, read_counts()


# Sampled requests on random synthetic weights may draw EOS at any frame;
# these seeds were checked on the H100 to give frames.
MAIN_REQUESTS = [
    ("Hello from the port.", dict(max_audio_tokens=64, temperature=0.0, seed=1)),
    ("The quick brown fox jumps over the lazy dog.", dict(max_audio_tokens=256, seed=3)),
    ("A longer request, long enough for a cache of more than a thousand rows.",
     dict(max_audio_tokens=1500, seed=4)),
]


def batch_texts(n):
    """n distinct request texts of a few lengths."""
    subjects = ("The quick brown fox", "A batch of requests", "Every lane",
                "This sentence, somewhat longer than the others, still")
    return [f"{subjects[i % len(subjects)]} number {i} jumps over the lazy dog."
            for i in range(n)]


# (number of texts, sampling) of the batched main path
BATCH_REQUESTS = [
    (16, dict(max_audio_tokens=128, temperature=0.0, seed=1)),
    (64, dict(max_audio_tokens=256, seed=3)),
]

# the int8-KV tier (RuntimeConfig.kv_quant="int8") on the int8 pipeline's
# weights: the sampled 1500-token request (C = 2304) and the 64-lane sampled
# batch; each must launch its [kv_int8] entry and no K1/K5 over a bf16 cache
KV_INT8_REQUESTS = [MAIN_REQUESTS[2]]
KV_INT8_BATCHES = [BATCH_REQUESTS[1]]
KV_INT8_SINGLE = ("fused_talker_step[kv_int8]", "fused_predict_codes", "fused_res_block",
                  "int8_matmul")
KV_INT8_BATCH = ("fused_talker_step_batched[kv_int8]", "fused_predict_codes_batched",
                 "fused_res_block", "int8_matmul")


def kv_int8_pipeline(tts):
    """A Qwen3TTS on tts's weights and flags with RuntimeConfig.kv_quant =
    "int8"."""
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    cfg = dataclasses.replace(tts.config, runtime=dataclasses.replace(tts.config.runtime,
                                                                      kv_quant="int8"))
    q = Qwen3TTS(cfg, device=tts.device, **tts.fused)
    q.set_params(tts.talker_params, tts.cp_params, tts.vocoder_params, tts.tokenizer)
    return q


def serve_kv_int8(tts, smi, requests=KV_INT8_REQUESTS, batches=KV_INT8_BATCHES,
                  min_frames_per_lane=8):
    """The int8-KV tier's serve phase on tts's weights: the requests, then
    the batches, each run's launch counts set to 0 just before it and
    checked just after (its [kv_int8] entry, K2/K6, K3 and the GEMM; none
    of K1/K5 over a bf16 cache). Prints serve_kv_int8 lines; returns the
    counts of both runs."""
    from qwen3tts_tpu_torch import SamplingConfig

    tts_kv = kv_int8_pipeline(tts)
    stats, single = serve(tts_kv, requests)
    for st in stats:
        check_launches(f"int8-KV request {st['request']}", st["launches"], KV_INT8_SINGLE,
                       BF16_KV_TALKER + KV_INT8_ENTRIES[1:])
        C = tts_kv._frame_budget(SamplingConfig(**st["request"]))[1]
        print("serve_kv_int8 " + json.dumps(dict(st, kv_capacity=C, card=smi)))
    stats, batch = serve_batches(tts_kv, batches, min_frames_per_lane)
    for st in stats:
        check_launches(f"int8-KV batch {st['lanes']}", st["launches"], KV_INT8_BATCH,
                       BF16_KV_TALKER + KV_INT8_ENTRIES[:1])
        print("serve_kv_int8_batch " + json.dumps(dict(st, card=smi)))
    return [single, batch]


# the unfused path on the same weights: single-stream requests (C = 256 and
# C = 1280), then a batch (C = 1280)
UNFUSED_REQUESTS = [
    ("Hello from the port.", dict(max_audio_tokens=64, temperature=0.0, seed=1)),
    ("An unfused request, long enough for a cache of more than a thousand rows.",
     dict(max_audio_tokens=520, seed=5)),
]
# 520 frames: the fewest that keep C = 1280 (frame bucket 1024), so the
# decode-attention kernel runs at the depth of a long request (the request
# above too: launch-bound, the unfused paths are the smoke's longest)
UNFUSED_BATCHES = [(16, dict(max_audio_tokens=520, temperature=0.0, seed=1))]


# The weight tiers beside int8, each on its own Qwen3TTS with the default
# flags ("auto": K1/K5 in every tier, K2/K6 on int8 code-predictor blocks);
# the bf16 tier is Qwen3TTS() on the default PipelineConfig(). Per tier:
# its single-stream requests and batches, the kernels each must launch,
# and the kernels none may launch (besides every other mode of K1/K5). Its
# weights are the int8 pipeline's synthetic draw (seed 0) in another tier.
TIER_SERVE = {
    None: dict(
        mode="bf16",
        requests=[("Hello from the default tier.",
                   dict(max_audio_tokens=64, temperature=0.0, seed=1)),
                  ("The quick brown fox jumps over the lazy dog.",
                   dict(max_audio_tokens=128, seed=3))],
        batches=[(16, dict(max_audio_tokens=64, temperature=0.0, seed=1))],
        single=("fused_talker_step[bf16]", "fused_res_block"),
        batch=("fused_talker_step_batched[bf16]", "fused_res_block"),
        forbidden=("fused_predict_codes", "fused_predict_codes_batched", "int8_matmul")),
    "q4": dict(
        mode="mixed",
        requests=[("The quick brown fox jumps over the lazy dog.",
                   dict(max_audio_tokens=256, seed=3))],
        batches=[(16, dict(max_audio_tokens=128, temperature=0.0, seed=1))],
        single=("fused_talker_step[mixed]", "fused_predict_codes", "fused_res_block",
                "int8_matmul"),
        batch=("fused_talker_step_batched[mixed]", "fused_predict_codes_batched",
               "fused_res_block", "int8_matmul"),
        forbidden=()),
    "q4pure": dict(
        mode="w4bf16",
        requests=[("The quick brown fox jumps over the lazy dog.",
                   dict(max_audio_tokens=256, seed=3))],
        batches=[(16, dict(max_audio_tokens=64, temperature=0.0, seed=1))],
        single=("fused_talker_step[w4bf16]", "fused_predict_codes", "fused_res_block"),
        batch=("fused_talker_step_batched[w4bf16]", "fused_predict_codes_batched",
               "fused_res_block"),
        # every talker projection is u4 and K2 runs the code predictor: no
        # int8 product is left for the W8A16 GEMM
        forbidden=("int8_matmul",)),
}
# the unfused path on the q4 tier's weights: the grouped QuantLinear4
# product of the FFN (PyTorch) and the GEMM of the attention projections
UNFUSED_Q4_REQUESTS = [("An unfused request on the q4 tier.",
                        dict(max_audio_tokens=32, temperature=0.0, seed=1))]
# K5's shapes in the non-w8a8 modes (B, C, n_past): shapes[1] is the
# headline; B = 5, 16, 24, 64 and 128 reach every lane-tile instantiation
# of the batched GEMMs
MODE_BATCH_SHAPES = ((16, 512, (10, 300)), (64, 512, (10, 300)), (5, 512, (10,)),
                     (24, 512, (10,)), (128, 512, (10,)))


def tier_forbidden(spec):
    """The kernels a tier's serve path must not launch: its own forbidden
    list, every K1/K5 entry of another weight mode (w8a8 included) and K1/K5
    over the int8 KV cache (the tier's cache is bf16)."""
    other = tuple(name for name in KERNELS
                  if kernel_mode(name) not in (None, spec["mode"]))
    return tuple(spec["forbidden"]) + other + KV_INT8_ENTRIES


def default_pipeline(seed=0):
    """Qwen3TTS() as a user makes it with no arguments (the default config,
    the bf16 tier, on the card), with synthetic weights."""
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    tts = Qwen3TTS()
    if not tts.load_models(None, synthetic=True, seed=seed):
        raise SmokeFailure(tts.error_msg)
    return tts


def unfused_pipeline(tts):
    """A Qwen3TTS on tts's weights with both fused kernels off."""
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    u = Qwen3TTS(tts.config, device=tts.device, fused_talker=False, fused_cp=False)
    u.set_params(tts.talker_params, tts.cp_params, tts.vocoder_params, tts.tokenizer)
    return u


def unfused_path(tts, kw):
    """The kernels a request of sampling kw must launch on the unfused path:
    the GEMM and K3, and decode attention when its KV capacity takes the
    kernel."""
    from qwen3tts_tpu_torch import SamplingConfig
    from qwen3tts_tpu_torch.ops.attention import use_decode_kernel

    tcfg = tts.config.talker
    C = tts._frame_budget(SamplingConfig(**kw))[1]
    attn = use_decode_kernel(C, tcfg.head_dim, tcfg.n_heads, tcfg.n_kv_heads)
    return UNFUSED_PATH + (("decode_attention",) if attn else ())


def check_launches(what, launches, path, forbidden=()):
    """Raise unless every kernel of `path` was launched and none of
    `forbidden` was."""
    idle = [k for k in path if launches[k] <= 0]
    wrong = [k for k in forbidden if launches[k] > 0]
    if idle or wrong:
        raise SmokeFailure(f"{what}: kernels not launched: {idle}; launched but off the "
                           f"path: {wrong}")


def serve_batches(tts, batches, min_frames_per_lane=8):
    """Run each batch through synthesize_batch and check it: every lane that
    emitted frames has finite audio of n_frames * 1920 samples and codes in
    range, and the batch emitted at least min_frames_per_lane frames per
    lane in all (random
    synthetic weights may draw EOS early in some lanes; lanes that stopped at
    frame 0 are counted). Returns per-batch stats and the launch counts of
    the whole run, counted from 0."""
    import numpy as np

    from qwen3tts_tpu_torch import SamplingConfig

    spf = tts.config.vocoder.samples_per_frame
    V = tts.config.code_predictor.vocab_size
    stats = []
    reset_counts()
    for n, kw in batches:
        before = read_counts()
        rs = tts.synthesize_batch(batch_texts(n), SamplingConfig(**kw))
        moved = {k: v - before[k] for k, v in read_counts().items()}
        frames = sum(r.n_frames for r in rs)
        for i, r in enumerate(rs):
            if r.n_frames == 0:
                continue
            ok = (r.success and len(r.audio) == r.n_frames * spf
                  and bool(np.isfinite(r.audio).all()) and (r.codes >= 0).all()
                  and (r.codes[:, 0] < 2048).all() and (r.codes[:, 1:] < V).all())
            if not ok:
                raise SmokeFailure(f"batch {n} {kw}: lane {i} failed ({r.error_msg or 'checks'})")
        gen_ms = rs[0].timings.t_generate_ms * n     # results carry the batch wall / B
        st = dict(request=kw, lanes=n, frames=frames,
                  lanes_stopped_at_frame_0=sum(r.n_frames == 0 for r in rs),
                  frames_per_s=frames / gen_ms * 1e3 if gen_ms else 0.0, generate_ms=gen_ms,
                  vocoder_ms=rs[0].timings.t_decode_ms * n, total_ms=rs[0].timings.t_total_ms,
                  launches=moved)
        print(f"batch {n} lanes {kw}: frames={frames} "
              f"stopped at frame 0: {st['lanes_stopped_at_frame_0']} "
              f"{st['frames_per_s']:.2f} frames/s (generate {gen_ms:.1f} ms, vocoder "
              f"{st['vocoder_ms']:.1f} ms) launches {moved}")
        if frames < min_frames_per_lane * n:
            raise SmokeFailure(f"batch {n} {kw}: {frames} frames < {min_frames_per_lane * n}")
        stats.append(st)
    return stats, read_counts()


def single_stream(tts, text, params, key):
    """generate_from_tokens on tts's weights and flags for one text, as
    synthesize runs it, from an explicit key: codes [n, 16] (numpy)."""
    import numpy as np
    import torch

    from qwen3tts_tpu_torch.pipeline import resolve_kv_quant
    from qwen3tts_tpu_torch.runtime import decode_loop

    tcfg = tts.config.talker
    padded, n_tok = tts._fit_tokens(tts.tokenizer.encode_for_tts(text))
    max_frames, kv_capacity = tts._frame_budget(params)
    out = decode_loop.generate_from_tokens(
        tts.talker_params, tts.cp_params, torch.from_numpy(padded), n_tok,
        torch.zeros((tcfg.hidden_size,), dtype=torch.float32, device=tts.device),
        params.language_id, key, talker_cfg=tcfg, cp_cfg=tts.config.code_predictor,
        max_frames=max_frames, kv_capacity=kv_capacity, temperature=params.temperature,
        top_k=params.top_k, top_p=params.top_p, repetition_penalty=params.repetition_penalty,
        nothink=params.language_id < 0, kv_quant=resolve_kv_quant(tts.config.runtime),
        **tts.fused)
    return out.codes.cpu().numpy().astype(np.int32)


class _DrawSpy:
    """Records what decode_loop hands the code predictor and the talker
    step each frame (K2's seed or predict_codes' key, K1's seed; K6's and
    K5's seeds [B]) and the keys frame 0's cb0 draws with (sample_cb0), by
    wrapping decode_loop's references to them while in use."""

    NAMES = ("fused_predict_codes", "fused_talker_step", "fused_predict_codes_batched",
             "fused_talker_step_batched", "sample_cb0")

    def __init__(self):
        from qwen3tts_tpu_torch.runtime import decode_loop

        self.dl = decode_loop
        self.real = {n: getattr(decode_loop, n) for n in self.NAMES}
        self.real_pc = decode_loop.cp_model.predict_codes
        self.cp, self.k1, self.cb0 = [], [], []

    def __enter__(self):
        import numpy as np

        r = self.real

        def seeds(v):
            return v if isinstance(v, int) else v.cpu().numpy().tolist()

        def cp(name):
            def spy(*a, **kw):
                self.cp.append(seeds(a[4]))
                return r[name](*a, **kw)
            return spy

        def k1(name):
            def spy(*a, **kw):
                self.k1.append(seeds(kw["seed"] if "seed" in kw else kw["seeds"]))
                return r[name](*a, **kw)
            return spy

        def spy_pc(*a, **kw):
            self.cp.append(np.array(a[4], dtype=np.uint32))
            return self.real_pc(*a, **kw)

        def spy_cb0(logits, keys, **kw):
            self.cb0.append(keys)
            return r["sample_cb0"](logits, keys, **kw)

        for name in ("fused_predict_codes", "fused_predict_codes_batched"):
            setattr(self.dl, name, cp(name))
        for name in ("fused_talker_step", "fused_talker_step_batched"):
            setattr(self.dl, name, k1(name))
        self.dl.sample_cb0 = spy_cb0
        self.dl.cp_model.predict_codes = spy_pc
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.dl, name, fn)
        self.dl.cp_model.predict_codes = self.real_pc


def host_chain(key, n, fused_cp):
    """The draws the fused talker's loop takes over n frames from `key`, on
    the host: frame 0's cb0 key split(key, 3)[1], and per frame K2's
    seed32(k_cp) (or k_cp for predict_codes) and K1's seed32(k_cb0)."""
    from qwen3tts_tpu_torch.ops import prng

    key, k0, _ = prng.split(prng.key_pair(key), 3)
    cp, k1 = [], []
    for _ in range(n):
        key, k_cb0, k_cp = prng.split(key, 3)
        cp.append(prng.seed32(k_cp) if fused_cp else k_cp)
        k1.append(prng.seed32(k_cb0))
    return k0, cp, k1


def _first_difference(a, b):
    """The first frame at which two code arrays differ (None if equal)."""
    n = min(len(a), len(b))
    rows = [f for f in range(n) if (a[f] != b[f]).any()]
    return rows[0] if rows else (None if len(a) == len(b) else n)


# (text, sampling, lanes) of check_sampled_serves, per pipeline
SAMPLED_SERVES = dict(
    int8=("The quick brown fox jumps over the lazy dog.",
          dict(max_audio_tokens=64, seed=3), 16),
    bf16=("The quick brown fox jumps over the lazy dog.",
          dict(max_audio_tokens=24, seed=3), 4),
)


def check_sampled_serves(tts, bf16, smi, specs=SAMPLED_SERVES):
    """The JAX package's random streams on the card's sampled serves, on
    the int8 pipeline (fused: K1/K2, K5/K6) and the bf16 tier (K1/K5 and the
    eager predict_codes). For each: synthesize twice with the same seed
    gives the same codes, and the draws the loop handed the code predictor
    and K1 each frame, and frame 0's cb0 key, equal host_chain's from
    prng_key(seed). Then a synthesize_batch of `lanes` copies of the text:
    the draws handed K6 (or predict_codes) and K5 in each frame-set, and
    frame 0's keys, hold lane b to host_chain from split(prng_key(seed),
    lanes)[b], the single stream's draws from that key. Any difference
    fails. The lanes' codes are set beside the single stream's from the
    same key, sampled and greedy, and counted, not gated: the batch's
    prefill runs B * P rows through the W8A16 GEMM where the single stream
    runs P, and on the card another row count sums in another order, so
    the codes part where the last bits first move a draw (on the CPU the
    plain versions agree, tests/test_torch_batch_slice.py). Prints a
    `sampled_serve` line per pipeline."""
    import numpy as np

    from qwen3tts_tpu_torch import SamplingConfig
    from qwen3tts_tpu_torch.ops import prng
    from qwen3tts_tpu_torch.runtime.decode_loop import resolve_fused_cp

    for what, pipe in (("int8", tts), ("bf16", bf16)):
        text, kw, lanes = specs[what]
        params = SamplingConfig(**kw)
        fused_cp = resolve_fused_cp(pipe.fused["fused_cp"], pipe.cp_params)
        with _DrawSpy() as spy:
            a = pipe.synthesize(text, params)
        b = pipe.synthesize(text, params)
        if not (a.success and a.n_frames > 0):
            raise SmokeFailure(f"sampled serve {what}: {a.error_msg or 'no frames'}")
        if not np.array_equal(a.codes, b.codes):
            raise SmokeFailure(f"sampled serve {what}: the same seed gave other codes")
        k0, want_cp, want_k1 = host_chain(prng.prng_key(kw["seed"]), a.n_frames, fused_cp)
        got_k0 = prng.key_pair(prng.key_array(spy.cb0[0]).reshape(2))
        got_cp = spy.cp if fused_cp else [prng.key_pair(c) for c in spy.cp]
        if (got_k0, got_cp, spy.k1) != (k0, want_cp, want_k1):
            raise SmokeFailure(f"sampled serve {what}: the loop's draws differ from the host "
                               f"chain ({len(spy.cp)}, {len(spy.k1)} recorded)")
        keys = prng.key_array(prng.split(prng.prng_key(kw["seed"]), lanes))
        with _DrawSpy() as spy:
            rs = pipe.synthesize_batch([text] * lanes, params)
        sets = len(spy.k1)
        for i in range(lanes):
            k0, want_cp, want_k1 = host_chain(keys[i], sets, fused_cp)
            got_k0 = prng.key_pair(prng.key_array(spy.cb0[0])[i])
            got_cp = [c[i] if fused_cp else prng.key_pair(c[i]) for c in spy.cp]
            if (got_k0, got_cp, [k[i] for k in spy.k1]) != (k0, want_cp, want_k1):
                raise SmokeFailure(f"sampled serve {what}: lane {i}'s draws differ from the "
                                   "single stream's with its key")
        first = [_first_difference(r.codes, single_stream(pipe, text, params, keys[i]))
                 for i, r in enumerate(rs)]
        greedy = SamplingConfig(**dict(kw, temperature=0.0))
        gb = pipe.synthesize_batch([text] * 4, greedy)
        gs = single_stream(pipe, text, greedy, keys[0])
        st = dict(what=what, request=kw, frames=a.n_frames, reproducible=True,
                  draws_equal_host_chain=len(want_k1), lanes=lanes, frame_sets=sets,
                  lane_draws_equal_host_chain=lanes, lane_frames=[r.n_frames for r in rs],
                  lanes_codes_equal_single_stream=sum(f is None for f in first),
                  lanes_first_differing_frame=first,
                  greedy_lanes_first_differing_frame=[_first_difference(r.codes, gs)
                                                      for r in gb])
        print("sampled_serve " + json.dumps(dict(st, card=smi)))


def _check_codes(codes, V, what):
    if not ((codes >= 0).all() and (codes[:, 0] < 2048).all() and (codes[:, 1:] < V).all()):
        raise SmokeFailure(f"{what}: codes out of range")


def run_scheduler(tts, requests, *, text_bucket, **kw):
    """requests [(tokens, n_tokens, budget, seed)] through one
    ContinuousScheduler on tts's weights and decode flags (kw: the
    scheduler's other arguments), the launch counts set to 0 just before
    run() and read just after. Returns (scheduler, each request's codes in
    submission order, the run() wall in ms, the counts)."""
    import numpy as np
    import torch

    from qwen3tts_tpu_torch.runtime.continuous import ContinuousScheduler

    tcfg = tts.config.talker
    sched = ContinuousScheduler(tts.talker_params, tts.cp_params, tcfg,
                                tts.config.code_predictor, text_bucket=text_bucket, **tts.fused,
                                **kw)
    spk = np.zeros((tcfg.hidden_size,), np.float32)
    rids = [sched.submit(t, n, spk, tcfg.english_language_id, seed=s, max_frames=bd)
            for t, n, bd, s in requests]
    reset_counts()
    t0 = time.perf_counter()
    out = sched.run()
    if tts.device.type == "cuda":
        torch.cuda.synchronize(tts.device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    return sched, [out[r] for r in rids], wall_ms, read_counts()


def _sched_stats(sched):
    return dict(chunks=sched.chunks_run, refills=sched.refills,
                compactions=sched.compactions, sessions=sched.sessions)


def bench_queue(tts, n=48, lanes=16, kv_capacity=512, chunk_frames=32, max_frames=96):
    """The JAX package's bench mini-run of continuous serving
    (bench.py:439-459) on the port: n requests of 10-31 random token ids,
    budgets lognormal(ln 52, 0.4) clipped to [24, 96] (both scaled by
    max_frames / 96), np.random.default_rng(5), temperature 0.9, top-k 50,
    EOS suppressed, 16 lanes, C = 512, K = 32, 8 refill slots. Every request
    must emit exactly its budget. Returns (stats, counts); the aggregate
    frames/s is the bench's: useful frames over the run() wall."""
    import numpy as np

    tcfg, V = tts.config.talker, tts.config.code_predictor.vocab_size
    scale = max_frames / 96
    rng = np.random.default_rng(5)
    budgets = np.clip(rng.lognormal(np.log(52 * scale), 0.4, n), 24 * scale,
                      max_frames).astype(np.int64)
    reqs = []
    for i in range(n):
        nt = int(rng.integers(10, 32))
        reqs.append((rng.integers(2, min(2000, tcfg.text_vocab_size), nt), nt,
                     int(budgets[i]), i))
    sched, codes, wall_ms, counts = run_scheduler(
        tts, reqs, text_bucket=32, lanes=lanes, kv_capacity=kv_capacity,
        chunk_frames=chunk_frames, refill_slots=8, max_frames=max_frames, temperature=0.9,
        top_k=50, repetition_penalty=1.05, allow_eos=False)
    for i, (c, bd) in enumerate(zip(codes, budgets)):
        if c.shape[0] != bd:
            raise SmokeFailure(f"bench queue: request {i} emitted {c.shape[0]} frames, "
                               f"not its budget {bd}")
        _check_codes(c, V, f"bench queue request {i}")
    useful = int(budgets.sum())
    st = dict(queue="bench mix", requests=n, lanes=lanes, kv_capacity=kv_capacity,
              chunk_frames=chunk_frames, useful_frames=useful, wall_ms=wall_ms,
              aggregate_frames_per_s=useful / wall_ms * 1e3, **_sched_stats(sched),
              launches=counts)
    print(f"queue bench mix: {n} requests, {useful} frames in {wall_ms:.1f} ms: "
          f"{st['aggregate_frames_per_s']:.2f} frames/s; {_sched_stats(sched)}")
    return st, counts


def queue_stats(tts):
    """The last synthesize_queue call's lanes, capacity and scheduler counts
    (its run()'s start time left out)."""
    return {k: v for k, v in tts.last_queue_stats.items() if k != "run_started"}


def serial_queue(tts, texts, sampling, **queue_kw):
    """synthesize_queue without on_audio on the scheduler's serial loop, the
    loop the queue streams on (without on_audio it takes the overlapped
    one): the same splice rows for every request as the streamed queue."""
    from qwen3tts_tpu_torch.runtime import continuous

    overlapped = continuous.ContinuousScheduler

    class Serial(overlapped):
        def __init__(self, *a, **k):
            super().__init__(*a, **dict(k, overlap_harvest=False))

    continuous.ContinuousScheduler = Serial
    try:
        return tts.synthesize_queue(texts, sampling, **queue_kw)
    finally:
        continuous.ContinuousScheduler = overlapped


def serve_queue(tts, texts, kw, lanes, what, **queue_kw):
    """texts through synthesize_queue with sampling kw, the launch counts
    set to 0 just before and read just after. Every result must succeed with
    finite audio of n_frames * 1920 samples and codes in range. Returns
    (stats, counts); frames/s is over the generate wall."""
    import numpy as np

    from qwen3tts_tpu_torch import SamplingConfig

    spf, V = tts.config.vocoder.samples_per_frame, tts.config.code_predictor.vocab_size
    reset_counts()
    rs = tts.synthesize_queue(texts, SamplingConfig(**kw), lanes=lanes, **queue_kw)
    counts = read_counts()
    for i, r in enumerate(rs):
        if not (r.success and r.n_frames > 0 and len(r.audio) == r.n_frames * spf
                and bool(np.isfinite(r.audio).all())):
            raise SmokeFailure(f"{what}: request {i} failed ({r.error_msg or 'checks'})")
        _check_codes(r.codes, V, f"{what} request {i}")
    n = len(texts)
    frames = sum(r.n_frames for r in rs)
    gen_ms = rs[0].timings.t_generate_ms * n     # results carry the queue's wall / n
    stats = queue_stats(tts)
    st = dict(queue=what, texts=n, request=kw, frames=frames,
              frames_per_s=frames / gen_ms * 1e3, generate_ms=gen_ms,
              vocoder_ms=rs[0].timings.t_decode_ms * n, **stats, launches=counts)
    print(f"queue {what}: {n} texts on {lanes} lanes, {frames} frames, "
          f"{st['frames_per_s']:.2f} frames/s (generate {gen_ms:.1f} ms); "
          f"{stats}; launches {counts}")
    return st, counts


def static_batches(tts, texts, kw, group):
    """The same texts through synthesize_batch in groups of `group`, one
    call after another: (frames, the sum of the generate walls in ms, the
    counts of the calls)."""
    from qwen3tts_tpu_torch import SamplingConfig

    frames, gen_ms = 0, 0.0
    reset_counts()
    for o in range(0, len(texts), group):
        rs = tts.synthesize_batch(texts[o:o + group], SamplingConfig(**kw))
        frames += sum(r.n_frames for r in rs)
        gen_ms += rs[0].timings.t_generate_ms * len(rs)
    return frames, gen_ms, read_counts()


# The queues of the serve phase (continuous serving): the JAX bench's mix;
# 128 texts on 64 lanes, sampled, beside synthesize_batch in two groups of
# 64; a tight greedy queue (16 lanes, C = 384) whose budgets force a
# compaction and a session reset; the bf16 tier; the unfused path at C =
# 1280 (where the non-continuous unfused step would take the attention
# kernel)
TIGHT_QUEUE = dict(lanes=16, kv_capacity=384, chunk_frames=8, refill_slots=8, max_frames=128)
QUEUE_SPECS = dict(
    bench=dict(n=48, lanes=16, kv_capacity=512, chunk_frames=32, max_frames=96),
    sampled=dict(texts=128, lanes=64, group=64, kw=dict(max_audio_tokens=128, seed=3)),
    tight=dict(TIGHT_QUEUE),
    bf16=dict(texts=32, lanes=16, kw=dict(max_audio_tokens=32, temperature=0.0, seed=1),
              budgets=[8 + (7 * i) % 25 for i in range(32)]),
    # max_audio_tokens 512 sizes the cache at C = 1280; the budgets keep the
    # requests short
    unfused=dict(texts=8, lanes=4, kw=dict(max_audio_tokens=512, temperature=0.0, seed=1),
                 budgets=[16, 20, 24, 28] * 2),
)


def tight_budgets(lanes=16, max_frames=128, chunk_frames=8):
    """Budgets of the tight queue, in four fills of `lanes` requests: M =
    max_frames frames, which end together; M - K, spliced above row 0,
    whose end blocks admission with lanes active (a compaction); M - 2K,
    which end past the admission limit with every lane idle (a session
    reset); then a staggered mix."""
    M, K = max_frames, chunk_frames
    stagger = [24, 40, 56, 72, 88, 104, 120, 128]
    return ([M] * lanes + [M - K] * lanes + [M - 2 * K] * lanes
            + [max(1, stagger[i % 8] * M // 128) for i in range(lanes)])


def tight_queue(tts, **kw):
    """The tight-capacity greedy queue through one ContinuousScheduler
    (TIGHT_QUEUE, or kw; EOS suppressed so that the budgets alone set the
    schedule). It must compact at least once and reset its session at least
    once, and its host mirrors must equal the state. The first fill (the
    first `lanes` requests, spliced at rows [0, P): the absolute positions
    of a fresh run) must give synthesize_batch's greedy codes for the same
    texts over the frames both emit (synthesize_batch stops a lane at EOS;
    K5's lanes are independent). Returns (stats, counts)."""
    from qwen3tts_tpu_torch import SamplingConfig

    cfg = dict(TIGHT_QUEUE, **kw)
    budgets = tight_budgets(cfg["lanes"], cfg["max_frames"], cfg["chunk_frames"])
    n = len(budgets)
    # numbers 10 and up: every text of a subject has the same length, so the
    # first fill's longest prompt is the queue's and both calls pad the
    # prompts to one bucket (the same shapes in every product)
    texts = batch_texts(n + 10)[10:]
    fitted = [tts._fit_tokens(tts.tokenizer.encode_for_tts(t)) for t in texts]
    reqs = [(p, k, b, i) for i, ((p, k), b) in enumerate(zip(fitted, budgets))]
    sched, codes, wall_ms, counts = run_scheduler(
        tts, reqs, text_bucket=max(p.shape[0] for p, _ in fitted), temperature=0.0, top_k=50,
        repetition_penalty=1.05, allow_eos=False, **cfg)
    sched.check_host_mirrors()
    st = dict(queue="tight greedy", requests=n, **cfg, frames=int(sum(budgets)),
              wall_ms=wall_ms, aggregate_frames_per_s=sum(budgets) / wall_ms * 1e3,
              **_sched_stats(sched), launches=counts)
    if sched.compactions < 1 or sched.sessions < 1:
        raise SmokeFailure(f"tight queue: {_sched_stats(sched)}: no compaction or no reset")
    lanes = cfg["lanes"]
    ref = tts.synthesize_batch(texts[:lanes], SamplingConfig(
        temperature=0.0, max_audio_tokens=cfg["max_frames"], seed=1))
    compared = 0
    for i, r in enumerate(ref):
        m = min(r.n_frames, len(codes[i]))
        if m == 0 or not (codes[i][:m] == r.codes[:m]).all():
            raise SmokeFailure(f"tight queue: first-fill request {i} differs from its "
                               f"synthesize_batch lane over {m} frames")
        compared += m
    st.update(first_fill_frames_compared=compared)
    print(f"queue tight greedy: {_sched_stats(sched)}; host mirrors equal the state; first "
          f"fill equals synthesize_batch over {compared} frames")
    return st, counts


def serve_queues(tts, tts_u, bf16, smi, specs=QUEUE_SPECS):
    """The serve phase's continuous queues (QUEUE_SPECS), each with the
    launch counts set to 0 just before it and checked just after: (1) the
    JAX bench's mix, int8 fused: K5 with start, K6 per lane, the GEMM, no K1
    or K2; (2) synthesize_queue on many sampled texts, then the same texts
    through synthesize_batch in groups (aggregate frames/s of both over
    their generate walls); (3) the tight greedy queue (compaction, reset,
    host mirrors, first fill == synthesize_batch); (4) the bf16 tier
    (bf16): K5 with start in bf16 mode, no K6 and no GEMM; (5) the unfused
    path (tts_u) at C >= 1024: the GEMM and no decode-attention kernel, none
    of K1, K2, K5, K6. Prints one serve_queue line each; returns the
    counts of every run."""
    int8_forbidden = QUEUE_FORBIDDEN + tier_forbidden(dict(mode="w8a8", forbidden=()))
    runs = []

    def report(st, counts, path, forbidden):
        check_launches(f"queue {st['queue']}", counts, path, forbidden)
        runs.append(counts)
        print("serve_queue " + json.dumps(dict(st, card=smi)))

    st, c = bench_queue(tts, **specs["bench"])
    report(st, c, QUEUE_PATH, int8_forbidden)
    sp = specs["sampled"]
    texts = batch_texts(sp["texts"])
    st, c = serve_queue(tts, texts, sp["kw"], sp["lanes"], "sampled")
    frames, gen_ms, sc = static_batches(tts, texts, sp["kw"], sp["group"])
    runs.append(sc)
    st.update(static_frames=frames, static_generate_ms=gen_ms,
              static_frames_per_s=frames / gen_ms * 1e3,
              continuous_over_static=st["frames_per_s"] / (frames / gen_ms * 1e3))
    print(f"queue sampled beside synthesize_batch in groups of {sp['group']}: {frames} frames, "
          f"{st['static_frames_per_s']:.2f} frames/s; continuous/static "
          f"{st['continuous_over_static']:.3f}")
    report(st, c, QUEUE_PATH + ("fused_res_block",), int8_forbidden)
    st, c = tight_queue(tts, **specs["tight"])
    report(st, c, QUEUE_PATH, int8_forbidden)
    sp = specs["bf16"]
    st, c = serve_queue(bf16, batch_texts(sp["texts"]), sp["kw"], sp["lanes"], "bf16",
                        max_audio_tokens_per_request=sp["budgets"])
    report(st, c, ("fused_talker_step_batched[bf16]", "fused_talker_step_batched[start]",
                   "fused_res_block"),
           tier_forbidden(TIER_SERVE[None]) + ("fused_talker_step[bf16]",
                                               "fused_predict_codes_batched[per_lane]"))
    sp = specs["unfused"]
    st, c = serve_queue(tts_u, batch_texts(sp["texts"]), sp["kw"], sp["lanes"], "unfused",
                        max_audio_tokens_per_request=sp["budgets"])
    if tts.device.type == "cuda" and st["kv_capacity"] < 1024:
        raise SmokeFailure(f"the unfused queue runs at C = {st['kv_capacity']}, below the "
                           f"decode-attention kernel's 1024 rows")
    report(st, c, UNFUSED_PATH, FUSED_ONLY + ("decode_attention",))
    return runs


# The streaming phase (serve_stream): (a) synthesize_streaming of the
# sampled 256-token request (chunks of 16 frames, 32 frames of history),
# its TTFA over `ttfa_seeds` (the first nine that give a chunk); (b) the
# 128-text sampled queue on 64 lanes with on_audio, the JAX package's
# streaming defaults (chunks of 8, history 16, cadence 32); (c) the 64-lane
# sampled batch's codes vocoded by vocode_batched and lane by lane; (d) the
# bf16 tier's greedy 64-token stream (eager code predictor).
STREAM_SPEC = dict(
    request=MAIN_REQUESTS[1], chunk_frames=16, history=32, ttfa_seeds=tuple(range(3, 23)),
    ttfa_n=9,
    queue=dict(texts=QUEUE_SPECS["sampled"]["texts"], lanes=QUEUE_SPECS["sampled"]["lanes"],
               kw=QUEUE_SPECS["sampled"]["kw"], chunk_frames=8, history=16, cadence=32),
    batch=BATCH_REQUESTS[1],
    bf16=dict(request=TIER_SERVE[None]["requests"][0], chunk_frames=16, history=32))
# each streamed chunk against its window vocoded alone (the same path):
# max abs error (samples in [-1, 1])
STREAM_TOL = 1e-4
# each lane of vocode_batched against its decode_codes. The plain float32
# stages' products and reductions run in another order at another row
# count (cuBLAS and the reduction kernels choose by shape), and the
# synthetic weights' snakes amplify a last-bit difference about a
# thousandfold: on an H100 the one-lane vocoder itself moved by 9.1e-4 when
# its clip was padded by one frame, and grouped lanes by up to 1.4e-3
# (PERF.md §6), so 1e-4 is below the floor of the float32 path. A lane that
# read another lane's rows or its padding would move by O(0.1). The line
# also reports lane 0's padded-by-a-frame difference (the floor, measured).
VOCODE_LANE_TOL = 5e-3


def _percentiles(ms):
    import numpy as np

    return dict(p50=float(np.percentile(ms, 50)), p90=float(np.percentile(ms, 90)),
                n=len(ms))


def stream_request(tts, text, kw, chunk_frames, history):
    """One synthesize_streaming call: (chunks, codes, frames per chunk, wall
    ms of the whole stream, ms to the first chunk in host memory)."""
    from qwen3tts_tpu_torch import SamplingConfig

    chunks, t_first = [], None
    t0 = time.perf_counter()
    for c in tts.synthesize_streaming(text, SamplingConfig(**kw), chunk_frames=chunk_frames,
                                      history=history):
        if t_first is None:
            t_first = (time.perf_counter() - t0) * 1e3
        chunks.append(c)
    wall_ms = (time.perf_counter() - t0) * 1e3
    st = tts.last_stream
    return chunks, st["codes"], list(st["chunk_frames"]), wall_ms, t_first


def stream_ttfa(tts, text, kw, chunk_frames, history, seeds, n):
    """synthesize_streaming's time to first audio, in ms on the host clock
    from the call to the first chunk in host memory, over the first n of
    `seeds` that give a chunk (random synthetic weights may draw EOS at
    frame 0); each stream is closed after its first chunk."""
    from qwen3tts_tpu_torch import SamplingConfig

    ttfa = []
    for seed in seeds:
        t0 = time.perf_counter()
        it = tts.synthesize_streaming(text, SamplingConfig(**dict(kw, seed=seed)),
                                      chunk_frames=chunk_frames, history=history)
        first = next(it, None)
        t = (time.perf_counter() - t0) * 1e3
        it.close()
        if first is not None:
            ttfa.append(t)
        if len(ttfa) == n:
            break
    return ttfa


def check_stream_chunks(tts, chunks, codes, sizes, history, what):
    """Each streamed chunk against its window [max(0, e - history), n)
    vocoded alone through decode_codes' path (the first chunk: [0, n0)),
    within STREAM_TOL; 1920 samples per frame in all. Returns the worst
    error."""
    spf = tts.config.vocoder.samples_per_frame
    if sum(len(c) for c in chunks) != len(codes) * spf or sum(sizes) != len(codes):
        raise SmokeFailure(f"{what}: {sum(len(c) for c in chunks)} samples for "
                           f"{len(codes)} frames")
    worst, e = 0.0, 0
    for i, (c, k) in enumerate(zip(chunks, sizes)):
        lo = 0 if i == 0 else max(0, e - history)
        want = tts._vocode(codes[lo:e + k])[(e - lo) * spf:(e + k - lo) * spf]
        err = float(abs(c - want).max()) if len(c) else 0.0
        if not err <= STREAM_TOL:
            raise SmokeFailure(f"{what}: chunk {i} differs from its window by {err}")
        worst, e = max(worst, err), e + k
    return worst


def serve_stream(tts, bf16, smi, spec=STREAM_SPEC):
    """The streaming phase (STREAM_SPEC), each path with the launch counts
    set to 0 just before it and read just after: (a) synthesize_streaming:
    codes equal to synthesize's with the same seed, every chunk within
    STREAM_TOL of its window vocoded alone, frames x 1920 samples, K1, K2,
    K3 and the GEMM launched; TTFA p50/p90 on the host clock from the call
    to the first chunk in host memory, over spec["ttfa_n"] seeds; the
    stream's frames/s over its wall beside synthesize's; (b) the sampled
    queue with on_audio: codes equal to the same queue without it, one
    finished call per request, n x 1920 samples, per-request TTFA from
    run()'s start to its first on_audio, aggregate frames/s beside the
    queue without on_audio (the default, overlapped loop; the codes are
    compared with the serial loop's, whose splice rows the streamed queue
    shares); K5 with start, K6 per lane, K3, the GEMM; (c)
    vocode_batched against lane-by-lane decode_codes on the 64-lane
    batch's codes (each lane within VOCODE_LANE_TOL; both walls; the peak
    memory of vocode_batched; VOCODE_LANE_TOL says why not STREAM_TOL);
    (d) the bf16 tier's greedy stream: codes
    equal to synthesize's. Prints one serve_stream line each; returns the
    counts of every run."""
    import numpy as np
    import torch

    from qwen3tts_tpu_torch import SamplingConfig
    from qwen3tts_tpu_torch.pipeline import vocode_batched, vocode_groups

    t_phase = time.perf_counter()
    dev, spf = tts.device, tts.config.vocoder.samples_per_frame
    runs = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def line(st):
        print("serve_stream " + json.dumps(dict(st, card=smi)))

    # (a) one request, streamed
    text, kw = spec["request"]
    full = tts.synthesize(text, SamplingConfig(**kw))
    reset_counts()
    chunks, codes, sizes, wall_ms, first_ms = stream_request(
        tts, text, kw, spec["chunk_frames"], spec["history"])
    counts = read_counts()
    runs.append(counts)
    if not (full.success and np.array_equal(codes, full.codes)):
        raise SmokeFailure(f"stream {kw}: codes differ from synthesize's "
                           f"({len(codes)} against {full.n_frames} frames)")
    err = check_stream_chunks(tts, chunks, codes, sizes, spec["history"], f"stream {kw}")
    check_launches(f"stream {kw}", counts, SINGLE_PATH,
                   tier_forbidden(dict(mode="w8a8", forbidden=())))
    ttfa = stream_ttfa(tts, text, kw, spec["chunk_frames"], spec["history"],
                       spec["ttfa_seeds"], spec["ttfa_n"])
    if len(ttfa) < spec["ttfa_n"]:
        raise SmokeFailure(f"stream TTFA: {len(ttfa)} of {len(spec['ttfa_seeds'])} seeds gave "
                           f"a first chunk")
    gen_ms = full.timings.t_generate_ms
    line(dict(what="request", request=kw, chunk_frames=spec["chunk_frames"],
              history=spec["history"], frames=len(codes), chunks=len(chunks),
              chunk_max_abs_err=err, first_chunk_ms=first_ms, ttfa_ms=_percentiles(ttfa),
              stream_wall_ms=wall_ms, stream_frames_per_s=len(codes) / wall_ms * 1e3,
              synthesize_frames_per_s=full.n_frames / gen_ms * 1e3,
              synthesize_total_ms=full.timings.t_total_ms, launches=counts))

    # (b) the queue, streamed, beside the same queue without on_audio
    q = spec["queue"]
    texts = batch_texts(q["texts"])
    qkw = dict(lanes=q["lanes"], chunk_frames=q["chunk_frames"])
    t0 = time.perf_counter()
    default = tts.synthesize_queue(texts, SamplingConfig(**q["kw"]), **qkw)
    default_ms = (time.perf_counter() - t0) * 1e3
    plain = serial_queue(tts, texts, SamplingConfig(**q["kw"]), **qkw)
    calls, first_at = [], {}

    def on_audio(idx, chunk, finished):
        first_at.setdefault(idx, time.perf_counter())
        calls.append((idx, len(chunk), bool(finished)))

    reset_counts()
    t0 = time.perf_counter()
    rs = tts.synthesize_queue(texts, SamplingConfig(**q["kw"]), on_audio=on_audio,
                              stream_history=q["history"], stream_cadence=q["cadence"], **qkw)
    stream_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    runs.append(counts)
    run0 = tts.last_queue_stats["run_started"]
    fins = [i for i, _, f in calls if f]
    if sorted(fins) != list(range(len(texts))):
        raise SmokeFailure(f"stream queue: finished calls {len(fins)} for {len(texts)} "
                           f"requests")
    for i, (r, p) in enumerate(zip(rs, plain)):
        if not np.array_equal(r.codes, p.codes):
            raise SmokeFailure(f"stream queue: request {i}'s codes differ from the queue "
                               f"without on_audio (serial loop)")
        got = sum(k for j, k, _ in calls if j == i)
        if r.n_frames and not (r.success and len(r.audio) == got == r.n_frames * spf
                               and bool(np.isfinite(r.audio).all())):
            raise SmokeFailure(f"stream queue: request {i} streamed {got} samples for "
                               f"{r.n_frames} frames")
    check_launches("stream queue", counts, QUEUE_PATH + ("fused_res_block",),
                   QUEUE_FORBIDDEN + tier_forbidden(dict(mode="w8a8", forbidden=())))
    frames = sum(r.n_frames for r in rs)
    ttfa_q = [(first_at[i] - run0) * 1e3 for i in range(len(texts)) if i in first_at]
    line(dict(queue_stats(tts), what="queue", texts=len(texts), request=q["kw"],
              chunk_frames=q["chunk_frames"], history=q["history"], cadence=q["cadence"],
              frames=frames, on_audio_calls=len(calls), ttfa_ms=_percentiles(ttfa_q),
              wall_ms=stream_ms, aggregate_frames_per_s=frames / stream_ms * 1e3,
              plain_wall_ms=default_ms,
              plain_aggregate_frames_per_s=sum(r.n_frames for r in default) / default_ms * 1e3,
              launches=counts))

    # (c) the batch's codes through vocode_batched and lane by lane
    n, bkw = spec["batch"]
    rs = tts.synthesize_batch(batch_texts(n), SamplingConfig(**bkw))
    live = [r for r in rs if r.n_frames]
    nf = [r.n_frames for r in live]
    bufs = np.zeros((len(live), max(nf), 16), np.int64)
    for j, r in enumerate(live):
        bufs[j, :r.n_frames] = r.codes
    reset_counts()
    sync()
    base = peak = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    grouped = vocode_batched(tts.vocoder_params, tts.config.vocoder, bufs, nf)
    grouped_ms = (time.perf_counter() - t0) * 1e3
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
    counts = read_counts()
    runs.append(counts)
    t0 = time.perf_counter()
    alone = [tts.decode_codes(r.codes) for r in live]
    alone_ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for j, (r, a) in enumerate(zip(live, alone)):
        e = float(abs(grouped[j, :r.n_frames * spf] - a).max())
        if not e <= VOCODE_LANE_TOL:
            raise SmokeFailure(f"vocode_batched: lane {j} differs from its decode_codes by {e}")
        worst = max(worst, e)
    check_launches("vocode_batched", counts, ("fused_res_block",))
    r = live[0]
    padded = tts._vocode(np.concatenate([r.codes, r.codes[:1]]))[:r.n_frames * spf]
    line(dict(what="vocode_batched", lanes=len(live), request=bkw, frames=sum(nf),
              groups=vocode_groups(nf), max_abs_err=worst, tolerance=VOCODE_LANE_TOL,
              one_lane_padded_by_a_frame_max_abs_err=float(abs(padded - alone[0]).max()),
              wall_ms=grouped_ms,
              lane_by_lane_wall_ms=alone_ms, memory_before_bytes=base, peak_memory_bytes=peak,
              launches=counts))

    # (d) the bf16 tier's stream (eager code predictor)
    text, kw = spec["bf16"]["request"]
    full = bf16.synthesize(text, SamplingConfig(**kw))
    reset_counts()
    chunks, codes, sizes, wall_ms, first_ms = stream_request(
        bf16, text, kw, spec["bf16"]["chunk_frames"], spec["bf16"]["history"])
    counts = read_counts()
    runs.append(counts)
    if not (full.success and np.array_equal(codes, full.codes)):
        raise SmokeFailure(f"bf16 stream {kw}: codes differ from synthesize's")
    if sum(len(c) for c in chunks) != len(codes) * spf:
        raise SmokeFailure(f"bf16 stream {kw}: samples do not match the frames")
    check_launches(f"bf16 stream {kw}", counts, TIER_SERVE[None]["single"],
                   tier_forbidden(TIER_SERVE[None]))
    line(dict(what="bf16 request", request=kw, frames=len(codes), chunks=len(chunks),
              first_chunk_ms=first_ms, stream_wall_ms=wall_ms,
              stream_frames_per_s=len(codes) / wall_ms * 1e3, launches=counts))
    print(f"serve_stream: {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return runs


# The checkpoint phase (serve_checkpoint): a full-width checkpoint written
# by tools/hf_fixture.py and served through the user's entry points. The
# int8 requests must launch the main path's kernels (SINGLE_PATH), the bf16
# tier's its own (TIER_SERVE[None]).
CHECKPOINT_REQUEST = MAIN_REQUESTS[1]
CHECKPOINT_BF16_REQUEST = TIER_SERVE[None]["requests"][0]
CHECKPOINT_VOICE_SECONDS = 10.0
CHECKPOINT_CLI_TOKENS = 64
# the speaker embedding on the card against the same audio on the CPU
EMBEDDING_REL_TOL = 1e-4


def _tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for t in tree:
            yield from _tensors(t)


def _to_device(tree, device):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(t, device) for t in tree))
    return tuple(_to_device(t, device) for t in tree)


def _dir_bytes(*dirs):
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d in dirs for f in os.listdir(d))


def check_checkpoint_params(tts, tts_dir, tok_dir):
    """Every leaf of tts's talker, code-predictor and vocoder params lies on
    tts's device, and a sample of leaves equals the checkpoint's tensors
    after the loaders' layout contract (linear .T, conv permute(2, 1, 0),
    transposed conv permuted and flipped, codebooks divided by their usage
    in float64, norms widened to float32)."""
    import torch

    from qwen3tts_tpu_torch.io.safetensors_io import SafetensorsDir

    trees = (tts.talker_params, tts.cp_params, tts.vocoder_params)
    off = {str(t.device) for tree in trees for t in _tensors(tree)
           if t.device.type != tts.device.type}
    if off:
        raise SmokeFailure(f"checkpoint leaves on {off}, not on {tts.device}")
    st, tk = SafetensorsDir(tts_dir), SafetensorsDir(tok_dir)
    tp, vp = tts.talker_params, tts.vocoder_params
    usage = tk.tensor("decoder.quantizer.rvq_first.vq.layers.0._codebook.cluster_usage")
    emb = tk.tensor("decoder.quantizer.rvq_first.vq.layers.0._codebook.embedding_sum")
    samples = [
        ("text_embd", tp.text_embd, st.tensor("talker.model.text_embedding.weight")),
        ("codec_head", tp.codec_head, st.tensor("talker.codec_head.weight").T),
        ("text_proj_fc2_w", tp.text_proj_fc2_w,
         st.tensor("talker.text_projection.linear_fc2.weight").T),
        ("blocks.attn_norm[-1]", tp.blocks.attn_norm[-1],
         st.tensor(f"talker.model.layers.{tts.config.talker.n_layers - 1}"
                   ".input_layernorm.weight")),
        ("cp.embds[14]", tts.cp_params.embds[14],
         st.tensor("talker.code_predictor.model.codec_embedding.14.weight")),
        ("pre_conv_w", vp.pre_conv_w, tk.tensor("decoder.pre_conv.conv.weight").permute(2, 1, 0)),
        ("dec_blocks[0].convt_w", vp.dec_blocks[0].convt_w,
         tk.tensor("decoder.decoder.1.block.1.conv.weight").permute(2, 0, 1).flip(0)),
        ("vq_first_cb", vp.vq_first_cb,
         emb.double() / usage.double().clamp(min=1e-5)[:, None]),
    ]
    for name, got, want in samples:
        if not torch.equal(got.cpu(), want.to(got.dtype)):
            raise SmokeFailure(f"checkpoint leaf {name} differs from the written tensor")


def _voice_request(tts, text, kw, ref_path):
    """synthesize_with_voice with the launch counts set to 0 just before it;
    the serve() checks on its result. Returns (stats, counts)."""
    import numpy as np

    from qwen3tts_tpu_torch import SamplingConfig

    reset_counts()
    r = tts.synthesize_with_voice(text, ref_path, SamplingConfig(**kw))
    counts = read_counts()
    spf = tts.config.vocoder.samples_per_frame
    ok = (r.success and r.n_frames > 0 and len(r.audio) == r.n_frames * spf
          and bool(np.isfinite(r.audio).all()))
    if not ok:
        raise SmokeFailure(f"voice request {kw} failed: {r.error_msg or 'checks'}")
    gen_ms = r.timings.t_generate_ms
    return dict(request=kw, n_frames=r.n_frames, frames_per_s=r.n_frames / gen_ms * 1e3,
                vocoder_ms=r.timings.t_decode_ms, t_encode_ms=r.timings.t_encode_ms,
                total_ms=r.timings.t_total_ms, launches=counts, ok=ok), counts


def serve_checkpoint(cfg, device, smi, root, *, request=CHECKPOINT_REQUEST,
                     bf16_request=CHECKPOINT_BF16_REQUEST,
                     voice_seconds=CHECKPOINT_VOICE_SECONDS, cli_tokens=CHECKPOINT_CLI_TOKENS):
    """The checkpoint path at cfg's widths, under the directory root: write
    a checkpoint with tools/hf_fixture.py (BF16 main model, float32
    tokenizer, config.json files), then, each run with the launch counts
    set to 0 just before it and checked just after:
      1. Qwen3TTS.from_pretrained(root, int8): every leaf on the device and
         a sample equal to the written tensors; one request (`request`),
         then synthesize_with_voice from a seeded voice_seconds WAV (both
         the main path's kernels, SINGLE_PATH); the embedding on the device
         against the CPU's of the same audio (EMBEDDING_REL_TOL);
      2. the bf16 tier, Qwen3TTS.from_pretrained(root): `bf16_request`, its
         tier's kernels and no K2 or GEMM;
      3. a Q8_0 GGUF directory written from it (write_gguf_dir): load_models
         then `request` (SINGLE_PATH);
      4. cli.main in-process (-r, --quant int8, --max-tokens cli_tokens,
         --seed 3): rc 0, a 24 kHz WAV of n_frames * 1920 samples (on the
         card n_frames = K1's launches) and SINGLE_PATH;
      5. unload_models, then is_loaded is False.
    Prints serve_checkpoint lines; returns the counts of every run."""
    import os

    import numpy as np
    import torch

    from qwen3tts_tpu_torch import cli
    from qwen3tts_tpu_torch.audio.wav import load_wav, save_wav
    from qwen3tts_tpu_torch.models import speaker_encoder as se
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS
    from qwen3tts_tpu_torch.tools import hf_fixture

    t_phase = time.perf_counter()
    int8_forbidden = tier_forbidden(dict(mode="w8a8", forbidden=()))
    runs = []

    def report(what, st, counts, path, forbidden):
        check_launches(f"checkpoint {what}", counts, path, forbidden)
        runs.append(counts)
        print("serve_checkpoint " + json.dumps(dict(st, what=what, card=smi)))

    t0 = time.perf_counter()
    tts_dir, tok_dir = hf_fixture.write_checkpoint_dir(root, cfg)
    ckpt = dict(checkpoint_bytes=_dir_bytes(tts_dir, tok_dir),
                write_s=time.perf_counter() - t0)
    print(f"checkpoint: {ckpt['checkpoint_bytes']} bytes written in {ckpt['write_s']:.1f} s")

    rt = dataclasses.replace(cfg.runtime, quant="int8")
    tts = Qwen3TTS.from_pretrained(root, rt, device=device)
    check_checkpoint_params(tts, tts_dir, tok_dir)
    stats, c = serve(tts, [request])
    report("int8 request", dict(stats[0], t_load_ms=tts.t_load_ms, **ckpt), c, SINGLE_PATH,
           int8_forbidden)

    sr = tts.config.speaker_encoder.sample_rate
    t = np.arange(int(voice_seconds * sr)) / sr
    rng = np.random.default_rng(0)
    ref = (0.3 * np.sin(2 * np.pi * 180.0 * t) * (1.0 + 0.5 * np.sin(2 * np.pi * 3.0 * t))
           + 0.03 * rng.standard_normal(t.shape)).astype(np.float32)
    ref_path = os.path.join(root, "ref.wav")
    save_wav(ref_path, ref, sr)
    st, c = _voice_request(tts, *request, ref_path)
    samples, _ = load_wav(ref_path)
    t0 = time.perf_counter()
    emb = tts.extract_speaker_embedding(samples)
    st["encode_ms_steady"] = (time.perf_counter() - t0) * 1e3
    cpu = se.speaker_embedding(_to_device(tts.speaker_params, "cpu"),
                               tts.config.speaker_encoder,
                               torch.from_numpy(samples[:max(rt.speaker_buckets)])).numpy()
    st["embedding_rel_err"] = float(np.abs(emb - cpu).max() / np.abs(cpu).max())
    if not st["embedding_rel_err"] <= EMBEDDING_REL_TOL:
        raise SmokeFailure(f"speaker embedding on {device} vs the CPU: relative error "
                           f"{st['embedding_rel_err']:.3g} > {EMBEDDING_REL_TOL}")
    report("int8 voice request", dict(st, voice_seconds=voice_seconds), c, SINGLE_PATH,
           int8_forbidden)

    bf16 = Qwen3TTS.from_pretrained(root, device=device)
    stats, c = serve(bf16, [bf16_request])
    report("bf16 request", dict(stats[0], t_load_ms=bf16.t_load_ms), c,
           TIER_SERVE[None]["single"], tier_forbidden(TIER_SERVE[None]))
    bf16.unload_models()

    gdir = os.path.join(root, "gguf")
    t0 = time.perf_counter()
    hf_fixture.write_gguf_dir(root, gdir)
    gguf_write_s = time.perf_counter() - t0
    g = Qwen3TTS(dataclasses.replace(cfg, runtime=rt), device=device)
    if not g.load_models(gdir):
        raise SmokeFailure(f"load_models of the GGUF directory: {g.error_msg}")
    stats, c = serve(g, [request])
    report("int8 GGUF request", dict(stats[0], t_load_ms=g.t_load_ms,
                                     gguf_bytes=_dir_bytes(gdir), gguf_write_s=gguf_write_s),
           c, SINGLE_PATH, int8_forbidden)
    g.unload_models()

    out = os.path.join(root, "cli.wav")
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["-m", root, "-t", request[0], "-r", ref_path, "-o", out, "--quant", "int8",
                   "--max-tokens", str(cli_tokens), "--seed", "3", "--device", str(device)])
    cli_s = time.perf_counter() - t0
    c = read_counts()
    if rc != 0:
        raise SmokeFailure(f"cli.main returned {rc}")
    audio, wav_sr = load_wav(out)
    spf = tts.config.vocoder.samples_per_frame
    frames = c["fused_talker_step"] if tts.device.type == "cuda" else len(audio) // spf
    if not (wav_sr == 24000 and 0 < len(audio) == frames * spf and frames <= cli_tokens):
        raise SmokeFailure(f"cli wav: {len(audio)} samples at {wav_sr} Hz for {frames} frames")
    report("cli", dict(n_frames=frames, wav_samples=len(audio), command_s=cli_s), c,
           SINGLE_PATH, int8_forbidden)

    tts.unload_models()
    if tts.is_loaded:
        raise SmokeFailure("is_loaded after unload_models")
    print(f"serve_checkpoint: {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return runs


# The parity phase (parity_fullsize): the JAX package's goldens at the 0.6B
# widths, committed under GOLDENS_FULLSIZE (its own tools/make_goldens.py,
# run on the CPU over tools/hf_fixture.py's checkpoint of PROVENANCE.json's
# seed), held against the port on the card in float32: its verify_stage
# bars and compare_e2e gates (the JAX tools' bars, not loosened), the
# golden codes teacher-forced through the talker and code predictor, and
# the golden codes vocoded. Each bar and gate is printed as it passes or
# fails; when the phase has printed them all, any that failed (its stage
# named) fails the smoke.
GOLDENS_FULLSIZE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                "torch_goldens", "fullsize")
# the port's vocoder (K3 in every res block) on the golden codes against
# the JAX package's audio, float32 both: the error measured first on the
# CPU (tools/verify_stage.py --teacher-forced --device cpu and the same
# function in tests/test_torch_goldens.py::test_fullsize_parity, the port's
# plain float32 vocoder against XLA:CPU's: max abs 1.96e-3-2.06e-3, RMS
# 9.75e-5-9.96e-5 over the 61440 samples as the thread count sums in
# another order, amplified by the snakes) times 5,
# room for the card's other summation orders (K3's tiles, cuDNN-free
# float32 matmuls)
VOCODER_GOLDEN_MAX_ABS = 1e-2
VOCODER_GOLDEN_RMS = 5e-4
# the least share of the 32 frames whose teacher-forced greedy code equals
# the golden one: cb0 (the talker) and cb1-15 (the code predictor, over the
# 15 codebooks). Measured on the CPU (test_fullsize_parity, verify_stage.py
# --teacher-forced --device cpu): 1.0 in every codebook, the port's float32
# logits ranking the JAX package's top code first in each of the 512 draws
TEACHER_FORCED_FLOORS = {"cb0": 1.0, "cb1_15": 1.0}


def parity_fullsize(cfg, device, smi, root, goldens_dir=GOLDENS_FULLSIZE,
                    max_abs=VOCODER_GOLDEN_MAX_ABS, rms=VOCODER_GOLDEN_RMS,
                    tf_floors=TEACHER_FORCED_FLOORS):
    """The port's verify_stage and compare_e2e on the goldens under
    goldens_dir (PROVENANCE.json names the fixture's seed), at cfg's widths
    in float32 on `device`, with the route that ran and the launches of
    each run (goldens.TOOL_FLAGS: the unfused talker step); then the two
    teacher-forced checks. Prints parity_fullsize lines; raises
    SmokeFailure, after printing them all, when a verify_stage bar or
    compare_e2e fails, a teacher-forced share falls below tf_floors, or
    the vocoder's error on the golden codes passes max_abs or rms; at
    once when a run launches a fused talker or code-predictor kernel or no
    K3. Returns the counts of the runs."""
    from qwen3tts_tpu_torch.config import RuntimeConfig
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS
    from qwen3tts_tpu_torch.tools import compare_e2e, goldens, hf_fixture, verify_stage

    t_phase = time.perf_counter()
    with open(os.path.join(goldens_dir, "PROVENANCE.json")) as f:
        prov = json.load(f)
    g = goldens.Goldens(goldens_dir)
    t0 = time.perf_counter()
    model = hf_fixture.fixture_for(cfg, root, prov["fixture"]["seed"])
    fixture_s = time.perf_counter() - t0
    tts = Qwen3TTS(dataclasses.replace(cfg, runtime=RuntimeConfig(dtype="float32")), device,
                   **goldens.TOOL_FLAGS)
    if not tts.load_models(model):
        raise SmokeFailure(f"load_models of the parity fixture: {tts.error_msg}")
    route = goldens.route(tts)
    on_card = tts.device.type == "cuda"

    def line(what, **kw):
        print("parity_fullsize " + json.dumps(dict(what=what, **kw, card=smi)))

    def launches(what, counts):
        wrong = [k for k in FUSED_ONLY if counts[k] > 0]
        if wrong or (on_card and counts["fused_res_block"] <= 0):
            raise SmokeFailure(f"parity {what}: launched {wrong}, K3 "
                               f"{counts['fused_res_block']} times")
        return {k: v for k, v in counts.items() if v}

    runs = []
    reset_counts()
    t0 = time.perf_counter()
    bars = verify_stage.verify(tts, g)
    wall = time.perf_counter() - t0
    runs.append(read_counts())
    used = launches("verify_stage", runs[-1])
    for b in bars:
        line("verify_stage", **b)
    line("route", route=route, launches=used, verify_wall_s=wall, t_load_ms=tts.t_load_ms,
         fixture_seed=prov["fixture"]["seed"], fixture_s=fixture_s)
    reset_counts()
    t0 = time.perf_counter()
    e2e = compare_e2e.compare(tts, g)
    runs.append(read_counts())
    line("compare_e2e", **e2e, launches=launches("compare_e2e", runs[-1]),
         wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    tf = goldens.teacher_forced(tts, g)
    line("teacher_forced", **tf, wall_s=time.perf_counter() - t0)
    reset_counts()
    voc = goldens.vocode_goldens(tts, g)
    runs.append(read_counts())
    ok = voc["max_abs_err"] <= max_abs and voc["rms_err"] <= rms and voc["lengths_equal"]
    line("vocoder_on_golden_codes", **voc, max_abs_tol=max_abs, rms_tol=rms, ok=ok,
         launches=launches("vocoder", runs[-1]))
    failed = [b["stage"] for b in bars if not b["ok"]] + ([] if e2e["pass"] else ["compare_e2e"])
    failed += [f"teacher_forced {k} {tf[k]} < {floor}" for k, floor in tf_floors.items()
               if not tf[k] >= floor]
    if not ok:
        failed.append(f"vocoder on the golden codes: max abs {voc['max_abs_err']:.3g} "
                      f"(tol {max_abs}), RMS {voc['rms_err']:.3g} (tol {rms}), lengths equal "
                      f"{voc['lengths_equal']}")
    n_gates = len(bars) + 2 + len(tf_floors)
    print(f"parity_fullsize: {n_gates - len(failed)} of {n_gates} gates pass; "
          f"FAILED: {failed or 'none'}; {time.perf_counter() - t_phase:.1f} s [{smi}]")
    tts.unload_models()
    if failed:
        raise SmokeFailure(f"parity at full width failed: {failed}")
    return runs


# The checkpoint-tools phase (checkpoint_tools): the port's converter and
# inspector on the fixture serve_checkpoint wrote, then a request served
# from the converted Q8_0 files through the native reader; and where a
# GGUF load's time goes, for both readers, beside the safetensors load.
# The q4_k_mixed conversion (and its audit, 15-25 s on the H100's hosts)
# runs only while the smoke has run under this many seconds, so a slow host
# keeps the whole smoke inside its limit.
CONVERT_Q4_UNTIL_S = 700.0


def checkpoint_tools(cfg, device, smi, root, *, request=CHECKPOINT_REQUEST, q4_until=None):
    """Under root (where serve_checkpoint wrote its checkpoint, seed 0):
      1. tools/convert_hf_to_gguf.py to q8_0, then, unless time.perf_counter()
         has passed q4_until, to q4_k_mixed: both kinds, each file's seconds
         and bytes;
      2. tools/inspect_checkpoint.py's audit of each output (parameter
         counts, every loaded leaf's shape against cfg's): must pass;
      3. the load split (load_split) of the q8_0 directory through the
         native reader and through the pure-Python GGUFReader, beside the
         int8 safetensors load;
      4. load_models of the q8_0 directory in the int8 tier (its readers
         must be NativeGGUF) and `request`, with SINGLE_PATH's launch
         counts checked as serve_checkpoint checks them.
    Prints checkpoint_tools lines; returns the counts of the request."""
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS
    from qwen3tts_tpu_torch.tools import convert_hf_to_gguf, hf_fixture, inspect_checkpoint
    from qwen3tts_tpu_torch.tools.time_gguf_load import load_readers, load_split, reader_name

    t_phase = time.perf_counter()

    def line(what, **kw):
        print("checkpoint_tools " + json.dumps(dict(what=what, **kw, card=smi)))

    tts_dir, tok_dir = (os.path.join(root, hf_fixture.TTS_DIR),
                        os.path.join(root, hf_fixture.TOKENIZER_DIR))
    dirs = {}
    for kind in ("q8_0", "q4_k_mixed"):
        if kind != "q8_0" and q4_until is not None and time.perf_counter() > q4_until:
            line("convert", type=kind, skipped=f"the smoke passed {CONVERT_Q4_UNTIL_S} s")
            continue
        d = dirs[kind] = os.path.join(root, f"tools_{kind}")
        os.makedirs(d, exist_ok=True)
        for what, src, stem in (("tts", tts_dir, "qwen3-tts-0.6b"),
                                ("tokenizer", tok_dir, "qwen3-tts-tokenizer")):
            out = os.path.join(d, f"{stem}-{kind}.gguf")
            r = convert_hf_to_gguf.convert(src, out, kind, what)
            line("convert", type=kind, kind=what, bytes=os.path.getsize(out), **r)
            t0 = time.perf_counter()
            n = sum(1 for _ in inspect_checkpoint.iter_tensors(out))
            errors = inspect_checkpoint.audit(out, what, cfg, device)
            line("audit", type=kind, kind=what, tensors=n, problems=errors, passed=not errors,
                 seconds=time.perf_counter() - t0)
            if errors:
                raise SmokeFailure(f"inspect_checkpoint --audit {what} of {out}: {errors}")

    rt = dataclasses.replace(cfg.runtime, quant="int8")
    cfg8 = dataclasses.replace(cfg, runtime=rt)
    q8 = dirs["q8_0"]
    for name, open_ckpts in load_readers(q8, tts_dir, tok_dir).items():
        line("load_split", reader=name, **load_split(open_ckpts, cfg8, device))

    g = Qwen3TTS(cfg8, device=device)
    if not g.load_models(q8):
        raise SmokeFailure(f"load_models of the converted q8_0 directory: {g.error_msg}")
    ckpt = g._open_checkpoint(0, "TTS")
    if reader_name(ckpt) != "NativeGGUF":
        raise SmokeFailure(f"the GGUF directory was read by {reader_name(ckpt)}")
    stats, c = serve(g, [request])
    check_launches("checkpoint_tools int8 request", c, SINGLE_PATH,
                   tier_forbidden(dict(mode="w8a8", forbidden=())))
    line("int8 GGUF request", **stats[0], t_load_ms=g.t_load_ms, reader=reader_name(ckpt))
    g.unload_models()
    print(f"checkpoint_tools: {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return [c]


# The multi_gpu phase (serve_multi_gpu): MULTI_GPU_WORLD ranks, one process
# each, spawned after the parent built the kernels; every rank builds the
# int8 pipeline from the same seed and runs the three checks of MULTI_GPU
# through the port's mesh entry points (qwen3tts_tpu_torch/parallel):
#   dp: a (2, 1) mesh, replicated weights, the fused batched loop (K5, K6,
#       the W8A16 prefill) on each rank's lanes of a sampled batch, codes
#       gathered over dp, each rank's lanes vocoded by vocode_batched_groups
#       (K3) and the audio gathered;
#   tp: a (1, 2) mesh, each rank's heads and FFN columns, the unfused greedy
#       step teacher-forced with the unsharded run's codes at a KV capacity
#       of `capacity` rows (the decode-attention kernel on the local heads);
#   queue: the continuous scheduler on the dp mesh (unfused under a mesh,
#       as the JAX package's), every request at exactly its budget.
MULTI_GPU_WORLD = 2
MULTI_GPU = dict(
    dp=dict(lanes=16, kw=dict(max_audio_tokens=64, seed=5)),
    tp=dict(text=MAIN_REQUESTS[0][0], capacity=1280, frames=8),
    queue=dict(lanes=4, kv_capacity=256, chunk_frames=4, refill_slots=2, max_frames=16,
               budgets=(12, 16, 8, 14, 16, 10, 8, 12), seed=40),
)
# the kernels each rank must launch on the phase's paths, and those it must
# not (the single-stream kernels)
MULTI_GPU_PATH = ("fused_talker_step_batched", "fused_predict_codes_batched",
                  "fused_res_block", "int8_matmul", "decode_attention")
MULTI_GPU_FORBIDDEN = ("fused_talker_step", "fused_predict_codes")
# the least cosine of a teacher-forced tp = 2 step's logits against the
# unsharded step's: the tp sums add the ranks' float32 partials in another
# order, and 28 random layers amplify a bf16 ulp of the hidden; the H100
# gave 0.99983 at the least over 9 steps (PERF.md §6), and 0.999
# leaves that margin 6x
TP_LOGITS_COS_FLOOR = 0.999
MULTI_GPU_TIMEOUT_S = 600


# the call sites, by module, of the two kernels whose shapes the mesh
# changes: a tp shard's widths and head counts, a dp rank's rows
MESH_SHAPE_SITES = (("qwen3tts_tpu_torch.ops.quant", "int8_matmul"),
                    ("qwen3tts_tpu_torch.parallel.collectives", "int8_matmul"),
                    ("qwen3tts_tpu_torch.ops.attention", "decode_attention_kernel"))


class CallShapes:
    """While in use, records each distinct shape at which MESH_SHAPE_SITES
    call the W8A16 GEMM ((M, K, N, x dtype), with the weight and scales of
    its first call) and decode attention ((q shape, cache shape, dtype,
    n_valid)), by wrapping the sites' references to the wrappers; the
    wrappers run and count their launches as before."""

    def __init__(self):
        self.mm, self.attn = {}, set()
        self.saved = []

    def __enter__(self):
        import importlib

        def mm(real):
            def spy(x, q, scale):
                self.mm.setdefault((*x.shape, q.shape[1], x.dtype), (q, scale))
                return real(x, q, scale)
            return spy

        def attn(real):
            def spy(q, kv, layer, n_valid):
                self.attn.add((tuple(q.shape), tuple(kv.shape), kv.dtype, int(n_valid)))
                return real(q, kv, layer, n_valid)
            return spy

        for mod_name, fn in MESH_SHAPE_SITES:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, fn)
            self.saved.append((mod, fn, real))
            setattr(mod, fn, (mm if fn == "int8_matmul" else attn)(real))
        return self

    def __exit__(self, *exc):
        for mod, fn, real in self.saved:
            setattr(mod, fn, real)
        self.saved = []


def check_call_shapes(shapes, dev):
    """The W8A16 GEMM and decode attention at every shape `shapes` (a
    CallShapes) recorded, each held against its plain version on the same
    inputs (random x with the call's weight and scales; a random query and
    cache, the last layer) at check_int8_matmul's and
    check_decode_attention's tolerances. Raises SmokeFailure on a miss;
    returns per kernel the shapes checked, their count and the worst
    error."""
    import torch

    from qwen3tts_tpu_torch.ops.decode_attention import (decode_attention_kernel,
                                                          decode_attention_kernel_plain)
    from qwen3tts_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain

    g = torch.Generator(device=dev).manual_seed(29)
    out = {k: dict(shapes=0, max_abs_err=0.0, cases=[])
           for k in ("int8_matmul", "decode_attention")}
    for (M, K, N, dt), (q, scale) in sorted(shapes.mm.items(), key=lambda kv: str(kv[0])):
        x = torch.randn((M, K), generator=g, device=dev).to(dt)
        a, b = int8_matmul(x, q, scale), int8_matmul_plain(x, q, scale)
        if not int8_mm_within(a, b, rel=dt == torch.float32):
            raise SmokeFailure(f"int8_matmul disagrees at the mesh's M={M} K={K} N={N} {dt}: "
                               f"err {_max_err(a, b):.3e}")
        r = out["int8_matmul"]
        r["cases"].append(f"M={M} K={K} N={N} x {str(dt)[6:]}")
        r["shapes"] += 1
        r["max_abs_err"] = max(r["max_abs_err"], _max_err(a, b))
    cache = {}
    for q_shape, kv_shape, dt, n in sorted(shapes.attn, key=str):
        if (q_shape, kv_shape, dt) not in cache:
            cache.clear()
            cache[(q_shape, kv_shape, dt)] = (
                torch.randn(q_shape, generator=g, device=dev).to(dt),
                torch.randn(kv_shape, generator=g, device=dev).to(dt))
        q, kv = cache[(q_shape, kv_shape, dt)]
        layer = kv_shape[-5] - 1
        a = decode_attention_kernel(q, kv, layer, n)
        b = decode_attention_kernel_plain(q, kv, layer, n)
        if not attention_within(a, b):
            raise SmokeFailure(f"decode_attention disagrees at the mesh's q {q_shape}, cache "
                               f"{kv_shape}, n_valid={n}: err {_max_err(a, b):.3e}")
        r = out["decode_attention"]
        r["cases"].append(f"q {list(q_shape)} cache {list(kv_shape)} n_valid={n}")
        r["shapes"] += 1
        r["max_abs_err"] = max(r["max_abs_err"], _max_err(a, b))
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def batch_tokens(tts, texts):
    """(tokens [B, Tb] int64, n_tokens [B]) as synthesize_batch pads them."""
    import numpy as np
    import torch

    fitted = [tts._fit_tokens(tts.tokenizer.encode_for_tts(t)) for t in texts]
    tokens = np.zeros((len(texts), max(p.shape[0] for p, _ in fitted)), np.int64)
    for i, (p, _) in enumerate(fitted):
        tokens[i, :p.shape[0]] = p
    return torch.from_numpy(tokens), [n for _, n in fitted]


def teacher_forced(tp, cp, cfg, tokens, n_tokens, frames, capacity, forced=None):
    """Greedy unfused frames through talker and code-predictor params tp, cp
    (a rank's tensor-parallel shard, or whole): the prefill, then `frames`
    talker steps into a cache of `capacity` rows, each step's input built
    from forced[f] (the reference run's codes) when given, else from the
    frame's own codes. Returns (codes [frames, 16], logits [frames + 1, Vc]
    float32: the prefill's, then each step's)."""
    import torch

    from qwen3tts_tpu_torch.models import code_predictor as cpm
    from qwen3tts_tpu_torch.models import talker as tm
    from qwen3tts_tpu_torch.parallel.shardings import local_config
    from qwen3tts_tpu_torch.runtime.decode_loop import _rest_embd_sum, sample_cb0

    tcfg, ccfg = local_config(cfg.talker, tp.blocks), local_config(cfg.code_predictor,
                                                                    cp.blocks)
    dev, dt = tp.codec_embd.device, tp.codec_embd.dtype
    Vc = tcfg.codec_vocab_size
    greedy = dict(temperature=0.0, top_k=0, top_p=1.0, greedy=True, use_top_p=False)
    with torch.no_grad():
        pre = tm.build_prefill(tp, tcfg, torch.as_tensor(tokens), n_tokens,
                               torch.zeros((tcfg.hidden_size,), device=dev),
                               tcfg.english_language_id)
        P, Trb = pre.prefill_embd.shape[0], pre.trailing.shape[0]
        kv = tm.make_kv_cache(tcfg, capacity, dt, dev)
        hidden, logits = tm.talker_prefill(tp, tcfg, pre.prefill_embd, kv)
        seen = torch.zeros((1, Vc), dtype=torch.int8, device=dev)
        codes, steps = [], [logits]
        for f in range(frames):
            cb0 = sample_cb0(logits[None], None, suppress_start=Vc - tcfg.n_suppressed_tail,
                             eos_id=-1, seen=seen if f else None, repetition_penalty=1.05,
                             **greedy)
            rest = cpm.predict_codes(cp, ccfg, hidden.to(dt), tp.codec_embd[cb0[0]], None,
                                     **greedy)
            codes.append(torch.cat([cb0.reshape(1), rest.to(torch.int64)]))
            use = codes[-1] if forced is None else forced[f].to(dev)
            seen[0, use[0]] = 1
            step = (tp.codec_embd[use[0]].float() + _rest_embd_sum(cp, use[1:])
                    + pre.trailing[min(f, Trb - 1)].float()).to(dt)
            hidden, logits = tm.talker_step(tp, tcfg, step, P + f, kv)
            steps.append(logits)
    return torch.stack(codes).cpu(), torch.stack(steps).float().cpu()


def _cosine(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float((a @ b) / (a.norm() * b.norm()))


def multi_gpu_checks(cfg, dev, devices, spec):
    """The three checks of the multi_gpu phase on this rank (the process
    group is up). Returns the rank's figures, its gathered results, the
    launch counts of the phase's main paths (the unsharded reference runs
    are not counted), and the W8A16 GEMM and decode attention held against
    their plain versions at every shape those paths gave them on this rank
    (check_call_shapes: a tp shard's widths and local heads, a dp rank's
    rows)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from qwen3tts_tpu_torch import SamplingConfig
    from qwen3tts_tpu_torch.ops import prng
    from qwen3tts_tpu_torch.parallel import collectives, shardings
    from qwen3tts_tpu_torch.parallel.mesh import make_mesh
    from qwen3tts_tpu_torch.pipeline import vocode_batched_groups
    from qwen3tts_tpu_torch.runtime import decode_loop
    from qwen3tts_tpu_torch.runtime.continuous import ContinuousScheduler

    world, rank = dist.get_world_size(), dist.get_rank()
    tts = make_pipeline(cfg, dev)
    tcfg, ccfg = cfg.talker, cfg.code_predictor
    dp_mesh, tp_mesh = make_mesh(world, 1, devices), make_mesh(1, world, devices)
    main = {k: 0 for k in COUNT_KEYS}
    shapes = CallShapes()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def counted(fn):
        """fn() on a main path: (its result, its wall ms), its launches added
        to the phase's counts."""
        reset_counts()
        rows = k4_rows()
        t0 = time.perf_counter()
        with shapes:
            r = fn()
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in read_counts().items():
            main[k] += v
        for k, v in k4_rows().items():
            main[k] += v - rows[k]
        return r, ms

    def shard(mesh):
        return (shardings.shard_params(tts.talker_params, shardings.talker_specs(), mesh),
                shardings.shard_params(tts.cp_params, shardings.code_predictor_specs(), mesh))

    def timed_ms(fn):
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, (time.perf_counter() - t0) * 1e3

    out = dict(rank=rank, device=str(dev), dp_rank=dp_mesh.dp_rank, tp_rank=tp_mesh.tp_rank)
    # 1. dp: the fused batched loop on each rank's lanes
    d = spec["dp"]
    params = SamplingConfig(**d["kw"])
    B = d["lanes"]
    tokens, n_tok = batch_tokens(tts, batch_texts(B))
    spk = torch.zeros((B, tcfg.hidden_size), device=dev)
    lang = [params.language_id] * B
    keys = np.asarray(prng.split(prng.prng_key(params.seed), B), np.uint32).reshape(B, 2)
    max_frames, C = tts._frame_budget(params)
    gen_kw = dict(talker_cfg=tcfg, cp_cfg=ccfg, max_frames=max_frames, kv_capacity=C,
                  temperature=params.temperature, top_k=params.top_k, top_p=params.top_p,
                  repetition_penalty=params.repetition_penalty)
    tpr, cpr = shard(dp_mesh)
    lo, hi = collectives.lane_range(dp_mesh, B)
    dist.barrier()
    res, dp_ms = counted(lambda: decode_loop.generate_from_tokens_batched(
        tpr, cpr, tokens, n_tok, spk, lang, keys, **gen_kw))
    n = list(res.n_frames)
    spf = cfg.vocoder.samples_per_frame

    def vocode_mine():
        buf = torch.zeros((hi - lo, max(max(n), 1) * spf))
        for g0, g1, audio in vocode_batched_groups(tts.vocoder_params, cfg.vocoder,
                                                   res.codes[lo:hi], n[lo:hi]):
            for b in range(g0, g1):
                buf[b, :n[lo + b] * spf] = torch.from_numpy(audio[b - g0, :n[lo + b] * spf])
        return collectives.gather_lanes(buf, dp_mesh)

    audio, vocode_ms = counted(vocode_mine)
    # the references run one rank at a time, each alone on its card
    for r in range(world):
        dist.barrier()
        if r == rank:
            ref, ref_ms = timed_ms(lambda: decode_loop.generate_from_tokens_batched(
                tts.talker_params, tts.cp_params, tokens[lo:hi], n_tok[lo:hi], spk[lo:hi],
                lang[lo:hi], keys[lo:hi], **gen_kw))
    dist.barrier()
    whole_ms = None
    if rank == 0:
        _, whole_ms = timed_ms(lambda: decode_loop.generate_from_tokens_batched(
            tts.talker_params, tts.cp_params, tokens, n_tok, spk, lang, keys, **gen_kw))
    dist.barrier()
    out["dp"] = dict(
        lanes=(lo, hi), codes=res.codes.numpy(), n_frames=n,
        lanes_equal_single_process=bool(torch.equal(ref.codes, res.codes[lo:hi])
                                        and list(ref.n_frames) == n[lo:hi]),
        frame_sets=max(n[lo:hi]), ms=dp_ms, ms_per_frame_set=dp_ms / max(max(n[lo:hi]), 1),
        single_process_lanes_ms_per_frame_set=ref_ms / max(max(ref.n_frames), 1),
        single_process_batch_ms_per_frame_set=(None if whole_ms is None
                                               else whole_ms / max(max(n), 1)),
        vocode_ms=vocode_ms, audio_finite=bool(torch.isfinite(audio).all()),
        audio_lanes=int(audio.shape[0]))
    # 2. tp: teacher-forced against the unsharded run
    t = spec["tp"]
    ids, n1 = tts._fit_tokens(tts.tokenizer.encode_for_tts(t["text"]))
    for r in range(world):
        dist.barrier()
        if r == rank:
            (ref_codes, ref_logits), ref_tp_ms = timed_ms(lambda: teacher_forced(
                tts.talker_params, tts.cp_params, cfg, ids, n1, t["frames"], t["capacity"]))
    tps, cps = shard(tp_mesh)
    dist.barrier()
    (tp_codes, tp_logits), tp_ms = counted(lambda: teacher_forced(
        tps, cps, cfg, ids, n1, t["frames"], t["capacity"], forced=ref_codes))
    cos = [_cosine(a, b) for a, b in zip(tp_logits, ref_logits)]
    out["tp"] = dict(
        frame0_codes_equal=bool(torch.equal(tp_codes[0], ref_codes[0])),
        codes_equal_share=float((tp_codes == ref_codes).float().mean()),
        cb0_equal=[bool(a.argmax() == b.argmax()) for a, b in zip(tp_logits, ref_logits)],
        logits_cos=cos, min_cos=min(cos), ms_per_frame=tp_ms / t["frames"],
        single_process_ms_per_frame=ref_tp_ms / t["frames"],
        local_heads=shardings.local_config(tcfg, tps.blocks).n_heads,
        local_wqkv=tuple(tps.blocks.wqkv.q.shape))
    # 3. a continuous queue on the dp mesh
    q = spec["queue"]
    reqs = [tts._fit_tokens(tts.tokenizer.encode_for_tts(x))
            for x in batch_texts(len(q["budgets"]))]
    qkw = {k: q[k] for k in ("lanes", "kv_capacity", "chunk_frames", "refill_slots",
                             "max_frames")}
    bucket = max(p.shape[0] for p, _ in reqs)

    def run_queue(tp, cp, mesh, **flags):
        sched = ContinuousScheduler(tp, cp, tcfg, ccfg, text_bucket=bucket, allow_eos=False,
                                    mesh=mesh, **flags, **qkw)
        spk1 = np.zeros((tcfg.hidden_size,), np.float32)
        rids = [sched.submit(p[:k], k, spk1, tcfg.english_language_id, seed=q["seed"] + i,
                             max_frames=bd)
                for i, ((p, k), bd) in enumerate(zip(reqs, q["budgets"]))]
        got = sched.run()
        sched.check_host_mirrors()
        return sched, [got[r] for r in rids]

    dist.barrier()
    (sched, qcodes), q_ms = counted(lambda: run_queue(tpr, cpr, dp_mesh))
    frames = sum(c.shape[0] for c in qcodes)
    out["queue"] = dict(codes=qcodes, frames=frames, ms=q_ms, frames_per_s=frames / q_ms * 1e3,
                        lanes=(sched.lo, sched.hi), fused=(sched.fused_cp, sched.fused_talker),
                        budgets_exact=[c.shape[0] for c in qcodes] == list(q["budgets"]),
                        chunks=sched.chunks_run, refills=sched.refills)
    if rank == 0:
        (_, base), base_ms = timed_ms(lambda: run_queue(
            tts.talker_params, tts.cp_params, None, fused_talker=False, fused_cp=False))
        same = sum(int((a == b).all(axis=1).sum()) for a, b in zip(qcodes, base))
        out["queue"].update(unsharded_frames_equal_share=same / max(frames, 1),
                            unsharded_frames_per_s=sum(c.shape[0] for c in base) / base_ms * 1e3)
    dist.barrier()
    out["counts"] = main
    # the two kernels at every shape this rank's main paths gave them
    out["shapes_checked"] = check_call_shapes(shapes, dev)
    return out


def multi_gpu_rank(rank, world, port, backend, devices, cfg, spec, out_dir):
    """The body of one rank of the multi_gpu phase (a spawned process): its
    process group, the checks, and its results saved to out_dir (a
    traceback instead when a check raised)."""
    import datetime
    import os
    import traceback

    import torch
    import torch.distributed as dist

    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=MULTI_GPU_TIMEOUT_S))
    try:
        out = multi_gpu_checks(cfg, dev, devices, spec)
    except Exception:  # noqa: BLE001 - reported by the parent
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def serve_multi_gpu(cfg, smi, *, spec=MULTI_GPU, world=MULTI_GPU_WORLD, devices=None,
                    backend=None):
    """The multi_gpu phase: spawn `world` ranks (NCCL with a card a rank
    where the machine has as many; else gloo, every rank on card 0), wait
    for them, and hold their results: every rank's gathered codes equal; a
    rank's dp lanes equal, bit for bit, a single-process batch of the same
    lanes with the same keys, its audio finite; under tp the first frame's
    codes equal the unsharded run's and every teacher-forced step's logits
    keep TP_LOGITS_COS_FLOOR; the queue emits every budget exactly; every
    rank launched the kernels of MULTI_GPU_PATH, and its GEMM and decode
    attention agreed with their plain versions at each shape it gave them. Prints a `multi_gpu` line
    per rank and returns their launch counts."""
    import torch
    import torch.multiprocessing as tmp

    cards = torch.cuda.device_count()
    if devices is None:
        devices = ([f"cuda:{r}" for r in range(world)] if cards >= world
                   else ["cuda:0"] * world)
    if backend is None:
        backend = "nccl" if cards >= world else "gloo"
    print(f"multi_gpu: {world} ranks, backend {backend}, devices {devices} [{smi}]")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ctx = tmp.start_processes(multi_gpu_rank,
                                  args=(world, _free_port(), backend, devices, cfg, spec, d),
                                  nprocs=world, join=False, start_method="spawn")
        try:
            deadline = time.monotonic() + MULTI_GPU_TIMEOUT_S
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise SmokeFailure(f"multi_gpu: the ranks did not finish in "
                                       f"{MULTI_GPU_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(30)
        outs = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(world)]
    for r, o in enumerate(outs):
        if "error" in o:
            raise SmokeFailure(f"multi_gpu rank {r} failed:\n{o['error']}")
    import numpy as np

    q0 = outs[0]["queue"]
    for o in outs:
        dp, tpr, q = o["dp"], o["tp"], o["queue"]
        what = f"multi_gpu rank {o['rank']}"
        if not (np.array_equal(dp["codes"], outs[0]["dp"]["codes"])
                and dp["n_frames"] == outs[0]["dp"]["n_frames"]):
            raise SmokeFailure(f"{what}: the gathered dp codes differ between ranks")
        if not dp["lanes_equal_single_process"]:
            raise SmokeFailure(f"{what}: lanes {dp['lanes']} differ from a single-process "
                               "batch of the same lanes")
        if not (dp["audio_finite"] and dp["audio_lanes"] == len(dp["n_frames"])):
            raise SmokeFailure(f"{what}: the gathered audio is not finite or misses lanes")
        if not tpr["frame0_codes_equal"]:
            raise SmokeFailure(f"{what}: tp = {world} frame 0's codes differ from the "
                               "unsharded run's")
        if tpr["min_cos"] < TP_LOGITS_COS_FLOOR:
            raise SmokeFailure(f"{what}: a tp step's logits cosine {tpr['min_cos']:.6f} < "
                               f"{TP_LOGITS_COS_FLOOR}")
        if not q["budgets_exact"] or q["fused"] != (False, False):
            raise SmokeFailure(f"{what}: the queue missed a budget or ran a fused kernel")
        if not all(np.array_equal(a, b) for a, b in zip(q["codes"], q0["codes"])):
            raise SmokeFailure(f"{what}: the queue's codes differ between ranks")
        check_launches(what, o["counts"], MULTI_GPU_PATH, MULTI_GPU_FORBIDDEN)
        line = dict(rank=o["rank"], device=o["device"], backend=backend, world=world,
                    dp={k: v for k, v in dp.items() if k not in ("codes",)},
                    tp=tpr, queue={k: v for k, v in q.items() if k != "codes"},
                    launches=o["counts"], shapes_checked=o["shapes_checked"], card=smi)
        print("multi_gpu " + json.dumps(line))
    print(f"multi_gpu: {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return [o["counts"] for o in outs]


# The serving-under-load phase (serve_load): the port's serving tools
# (qwen3tts_tpu_torch/tools/benchmark_continuous.py, benchmark_arrivals.py,
# benchmark_streaming_load.py) at reduced size on the int8 pipeline: the
# lognormal mix of make_requests (rng 17, budgets 24-128) through the
# continuous scheduler and the length-sorted static batches; the same
# requests as a Poisson trace at `utilization` of the continuous run's
# frames/s through both online servers (the continuous run's scheduler
# shape, so that the capacity it measured applies); the streamed queue on
# make_texts' mix (rng 17, budgets 24-256). Each run takes the tools' warm
# pass where the tool has one, except the arrivals, which the offline runs
# warmed at the same shapes.
SERVE_LOAD = dict(
    offline=dict(requests=64, lanes=16, capacity=1024, chunk=8, refill_slots=8, max_frames=128,
                 text_bucket=32, passes=2),
    utilization=0.7,
    stream=dict(requests=32, lanes=16, chunk=8, max_frames=256, history=16, cadence=32,
                passes=2))
# the static servers: K5, K6 and the prefill's GEMM, without `start`
STATIC_PATH = ("fused_talker_step_batched", "fused_predict_codes_batched", "int8_matmul")


def _finite_percentiles(stats, what):
    vals = [v for key in ("t_first_codes_ms", "e2e_ms", "ttfa_ms") if key in stats
            for v in stats[key].values()]
    if not vals or not all(v == v and abs(v) != float("inf") for v in vals):
        raise SmokeFailure(f"{what}: percentiles not finite: {stats}")


def _codes_in_range(codes, V, what):
    for i, c in enumerate(codes):
        _check_codes(c, V, f"{what} request {i}")


def _equal_share(got, want):
    """(share of requests whose codes equal, share of frames equal)."""
    reqs = sum(bool((g.shape == w.shape) and (g == w).all()) for g, w in zip(got, want))
    frames = sum(int((g[:len(w)] == w[:len(g)]).all(axis=1).sum()) for g, w in zip(got, want))
    return reqs / len(want), frames / sum(len(w) for w in want)


def serve_load(tts, smi, spec=SERVE_LOAD):
    """The serve_load phase (SERVE_LOAD) on tts's weights and decode flags,
    each run with the launch counts set to 0 just before it and read just
    after. (1) run_continuous beside run_static on the same requests:
    every request emits exactly its budget, codes in range, the continuous
    run launches K5 with `start`, K6 per lane and the GEMM and no K1 or K2,
    the static run K5, K6 and the GEMM without `start`; (2) the Poisson
    trace at spec["utilization"] of (1)'s continuous frames/s through
    run_continuous_arrivals (every budget exactly; one first-codes event
    and one finish per request; the same launches as (1)'s continuous run;
    its codes beside (1)'s as shares of requests and frames equal: on the
    card a request's codes depend on the prefill row count of its refill,
    ROADMAP queue 3 item 4, so they are counted, not gated) and
    run_static_arrivals (the static launches); (3) run_streaming_load's
    streamed queue: one finish and a first audio chunk per request, 0 <
    frames <= budget (the queue keeps EOS), audio of n_frames x 1920 finite
    samples, codes in range, K5 with `start`, K6 per lane, K3 and the GEMM.
    Every latency percentile must be finite. Prints one `serve_load` line
    per part; returns the counts of every run."""
    import numpy as np

    from qwen3tts_tpu_torch.tools import benchmark_arrivals as ba
    from qwen3tts_tpu_torch.tools import benchmark_continuous as bc
    from qwen3tts_tpu_torch.tools import benchmark_streaming_load as bs

    t_phase = time.perf_counter()
    tcfg, ccfg = tts.config.talker, tts.config.code_predictor
    tp, cp, V = tts.talker_params, tts.cp_params, ccfg.vocab_size
    cont_forbidden = QUEUE_FORBIDDEN + tier_forbidden(dict(mode="w8a8", forbidden=()))
    static_forbidden = cont_forbidden + ("fused_talker_step_batched[start]",
                                         "fused_predict_codes_batched[per_lane]")
    runs = []

    def counted(what, path, forbidden, fn, *a, **kw):
        reset_counts()
        out = fn(*a, **kw)
        counts = read_counts()
        check_launches(f"serve_load {what}", counts, path, forbidden)
        runs.append(counts)
        return out, counts

    sp = dict(spec["offline"])
    n = sp.pop("requests")
    shape = dict(lanes=sp["lanes"], max_frames=sp["max_frames"], text_bucket=sp["text_bucket"])
    rng = np.random.default_rng(17)
    reqs = bc.make_requests(n, rng, tb=sp["text_bucket"], max_frames=sp["max_frames"],
                            token_high=min(2000, tcfg.text_vocab_size))
    mean_budget = float(np.mean([r["budget"] for r in reqs]))
    (cont, codes), c_cont = counted("continuous", QUEUE_PATH, cont_forbidden, bc.run_continuous,
                                    tp, cp, tcfg, ccfg, reqs, flags=tts.fused, **sp)
    _codes_in_range(codes, V, "serve_load continuous")
    (static, _), c_static = counted("static", STATIC_PATH, static_forbidden, bc.run_static,
                                    tp, cp, tcfg, ccfg, reqs, passes=sp["passes"],
                                    flags=tts.fused, **shape)
    line = dict(what="continuous_vs_static", requests=n, **sp, budget_mean=mean_budget,
                budget_max=max(r["budget"] for r in reqs), continuous=cont, static=static,
                speedup=cont["frames_per_s"] / static["frames_per_s"],
                launches=dict(continuous=c_cont, static=c_static), card=smi)
    print("serve_load " + json.dumps(line))

    capacity = cont["frames_per_s"]
    rate = spec["utilization"] * capacity / mean_budget
    arrivals = ba.arrival_times(rng, rate, n)
    sched = {k: sp[k] for k in ("capacity", "chunk", "refill_slots")}
    (c_arr, a_codes), c_counts = counted(
        "continuous arrivals", QUEUE_PATH, cont_forbidden, ba.run_continuous_arrivals,
        tp, cp, tcfg, ccfg, reqs, arrivals, flags=tts.fused, **shape, **sched)
    _finite_percentiles(c_arr, "serve_load continuous arrivals")
    _codes_in_range(a_codes, V, "serve_load continuous arrivals")
    (s_arr, _), s_counts = counted(
        "static arrivals", STATIC_PATH, static_forbidden, ba.run_static_arrivals,
        tp, cp, tcfg, ccfg, reqs, arrivals, flags=tts.fused, **shape)
    _finite_percentiles(s_arr, "serve_load static arrivals")
    req_share, frame_share = _equal_share(a_codes, codes)
    line = dict(what="arrivals", requests=n, lanes=sp["lanes"], chunk=sp["chunk"],
                utilization=spec["utilization"], capacity_fps=capacity, rate_req_s=rate,
                offered_load_fps=rate * mean_budget, budget_mean=mean_budget,
                trace_span_s=float(arrivals[-1]), continuous=c_arr, static=s_arr,
                codes_equal_offline=dict(requests=req_share, frames=frame_share),
                launches=dict(continuous=c_counts, static=s_counts), card=smi)
    ba.speedups(line)
    print("serve_load " + json.dumps(line))

    st = dict(spec["stream"])
    budgets, texts = bs.make_texts(st["requests"], np.random.default_rng(17), st["max_frames"])
    params = bs.sampling(st["max_frames"])

    def stream():
        for _ in range(st["passes"]):
            out = bs.run_streaming_load(tts, texts, budgets, params, lanes=st["lanes"],
                                        chunk=st["chunk"], stream_history=st["history"],
                                        cadence=st["cadence"])
        return out

    (s_stats, results), s_load = counted("streaming", QUEUE_PATH + ("fused_res_block",),
                                         cont_forbidden, stream)
    spf = tts.config.vocoder.samples_per_frame
    for i, r in enumerate(results):
        if not (len(r.audio) == r.n_frames * spf and bool(np.isfinite(r.audio).all())):
            raise SmokeFailure(f"serve_load streaming: request {i}'s audio is not n_frames x "
                               f"{spf} finite samples")
    _codes_in_range([r.codes for r in results], V, "serve_load streaming")
    _finite_percentiles(s_stats, "serve_load streaming")
    print("serve_load " + json.dumps(dict(what="streaming", **s_stats, passes=st["passes"],
                                          launches=s_load, card=smi)))
    print(f"serve_load: {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return runs


# The quality phase: check_quant_cosine's three tiers against bf16 on the
# bf16 tier's weights (the same seeded draws as the int8 pipeline's before
# quantization), gated on its bars; ab_kv_int8 single stream and at 16
# lanes on the int8 pipeline. prompt: None for the JAX tool's 15 ids.
QUALITY = dict(prompt=None, ab=((256, 0), (256, 16)))
AB_PATHS = {
    0: (("fused_talker_step", "fused_talker_step[kv_int8]", "fused_predict_codes"),
        ("fused_talker_step_batched", "fused_talker_step_batched[kv_int8]")),
    1: (("fused_talker_step_batched", "fused_talker_step_batched[kv_int8]",
         "fused_predict_codes_batched"),
        ("fused_talker_step", "fused_talker_step[kv_int8]", "fused_predict_codes")),
}


def quality(tts, bf16, smi, spec=QUALITY):
    """The quality phase (QUALITY): (1) check_quant_cosine.quant_cosines on
    bf16's talker at its widths: each tier's prefill-logits cosine must
    beat its bar (check_quant_cosine.BARS); (2) ab_kv_int8 on tts's int8
    weights for each (frames, lanes) of spec["ab"], the launch counts set
    to 0 just before and read just after: both caches emit every frame of
    every lane, codes in range; the single stream must launch K1 and
    K1[kv_int8] (and K2), the batch K5 and K5[kv_int8] (and K6); the match
    rate and the frame-exact share are reported. Prints one `quality` line
    per part; returns the counts of the A/B runs."""
    from qwen3tts_tpu_torch.tools import ab_kv_int8 as ab
    from qwen3tts_tpu_torch.tools import check_quant_cosine as cq

    t_phase = time.perf_counter()
    tokens, n = cq.prompt(*(() if spec["prompt"] is None else (spec["prompt"],)))
    res = cq.quant_cosines(bf16.talker_params, bf16.config.talker, tokens, n)
    bad = cq.failed_bars(res)
    print("quality " + json.dumps(dict(what="check_quant_cosine", **res, bars=cq.BARS,
                                       failed=bad, card=smi)))
    if bad:
        raise SmokeFailure(f"quality: {bad} below the bars {cq.BARS}: {res}")
    tcfg, ccfg = tts.config.talker, tts.config.code_predictor
    V = ccfg.vocab_size
    runs = []
    for frames, lanes in spec["ab"]:
        reset_counts()
        st, codes = ab.ab_kv_int8(tts.talker_params, tts.cp_params, tcfg, ccfg, frames=frames,
                                  batch=lanes, token_high=min(150000, tcfg.text_vocab_size))
        counts = read_counts()
        path, forbidden = AB_PATHS[int(lanes > 0)]
        what = f"ab_kv_int8 {'single stream' if not lanes else f'{lanes} lanes'}"
        check_launches(f"quality {what}", counts, path, forbidden)
        runs.append(counts)
        want = frames * max(lanes, 1)
        if not st["none"]["frames"] == st["int8"]["frames"] == want:
            raise SmokeFailure(f"quality {what}: frames {st['none']['frames']} and "
                               f"{st['int8']['frames']}, not {want}")
        for kvq, c in codes.items():
            _check_codes(c.reshape(-1, c.shape[-1]), V, f"quality {what} {kvq}")
        print("quality " + json.dumps(dict(what=what, **st, launches=counts, card=smi)))
    print(f"quality: {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return runs


def trace_request(tts, smi, request=MAIN_REQUESTS[0]):
    """The trace phase: utils/profiling.trace around one request with an
    annotate("request") region, the launch counts set to 0 just before and
    read just after. The request must succeed and launch SINGLE_PATH's
    kernels; the one trace file written must name the region and, on a
    card, K1's kernels (TALKER_KERNEL_PREFIXES) and K2's (CP_KERNEL).
    Prints a `trace` line (the file's bytes and events, the kernels of K1
    and K2 it names, the wall with the profiler); returns the counts."""
    import glob
    import os

    import numpy as np

    from qwen3tts_tpu_torch import SamplingConfig
    from qwen3tts_tpu_torch.utils.profiling import annotate, trace

    text, kw = request
    with tempfile.TemporaryDirectory() as log_dir:
        reset_counts()
        t0 = time.perf_counter()
        with trace(log_dir):
            with annotate("request"):
                r = tts.synthesize(text, SamplingConfig(**kw))
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        if len(files) != 1:
            raise SmokeFailure(f"trace: {len(files)} trace files written, not 1")
        nbytes = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    if not (r.success and r.n_frames > 0 and bool(np.isfinite(r.audio).all())):
        raise SmokeFailure(f"trace: the request failed ({r.error_msg or 'checks'})")
    check_launches("trace request", counts, SINGLE_PATH)
    regions = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "request"]
    kernels = [kernel_name(e["name"]) for e in events if e.get("cat") == "kernel"]
    k1 = sum(k.startswith(TALKER_KERNEL_PREFIXES) for k in kernels)
    k2 = sum(k == CP_KERNEL for k in kernels)
    line = dict(request=kw, n_frames=r.n_frames, wall_ms=wall_ms, trace_bytes=nbytes,
                events=len(events), regions=len(regions), kernels=len(kernels),
                k1_kernels=k1, k2_kernels=k2, launches=counts, card=smi)
    print("trace " + json.dumps(line))
    if len(regions) != 1 or (tts.device.type == "cuda" and not (k1 and k2)):
        raise SmokeFailure(f"trace: the region or K1's and K2's kernels are missing: {line}")
    return counts


def profile_request(tts, text, kw, queue=None):
    """One request under torch.profiler, recording device activity only.
    The device was busy for the union of the kernel, copy and memset
    intervals in the trace; the wall is the host clock around the request
    (synthesize, synthesize_batch and synthesize_queue synchronize before
    they return). A list of texts runs as one synthesize_batch call, or as
    one synthesize_queue call with the arguments `queue`. Returns (results,
    wall ms, busy ms, the device activities with the most time)."""
    from torch.profiler import ProfilerActivity, profile

    from qwen3tts_tpu_torch import SamplingConfig

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if queue is not None:
            r = tts.synthesize_queue(text, SamplingConfig(**kw), **queue)
        elif isinstance(text, list):
            r = tts.synthesize_batch(text, SamplingConfig(**kw))
        else:
            r = [tts.synthesize(text, SamplingConfig(**kw))]
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    return r, wall_ms, device_busy_ms(events), device_top(events)


def device_events(prof):
    """The device activities of a finished profile as chrome-trace events
    (cat, name, ts and dur in microseconds), read from the profiler's event
    list (an unfused request launches millions of kernels, too many to write
    out as a JSON trace and read back): every event on the CUDA device, a
    copy or memset by its name, a kernel otherwise."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        cat = ("gpu_memcpy" if name.startswith("Memcpy") else
               "gpu_memset" if name.startswith("Memset") else "kernel")
        out.append(dict(cat=cat, name=name, ts=e.start_ns() / 1e3, dur=e.duration_ns() / 1e3))
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_ms(events):
    """Milliseconds covered by the union of the device intervals (kernels,
    copies, memsets) among chrome-trace events (microsecond ts and dur)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS and "dur" in e)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3


def kernel_name(name):
    """A kernel's bare function name: no return type, namespace, template or
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name)[0].strip().split(" ")[-1].split("::")[-1]


def device_ms_per_call(fn, calls, prefixes, device, expect=None, tries=3):
    """Device time per call of the kernels whose bare names start with one of
    `prefixes`, over one run of fn (`calls` calls) under torch.profiler:
    the kernels' own time, without the host's launch gaps that CUDA events
    around a run of calls include. `expect`, where given, is the number of
    such kernels one run of fn launches: the profiler can drop the events of
    a short run, so a trace that caught another number is not used. None
    off the card, and None when `tries` traces in a row caught none (or not
    the expected number) of the kernels: nothing was measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(device)
        durs = [e["dur"] for e in device_events(prof)
                if e["cat"] == "kernel" and kernel_name(e["name"]).startswith(prefixes)]
        if durs and (expect is None or len(durs) == expect):
            return sum(durs) / 1e3 / calls
    return None


def trace_kernel_counts(fn, prefixes, device, tries):
    """The number of kernels whose bare names start with one of `prefixes`
    in each of `tries` traces of one run of fn under torch.profiler, after
    a warm-up run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    counts = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(device)
        counts.append(sum(1 for e in device_events(prof) if e["cat"] == "kernel"
                          and kernel_name(e["name"]).startswith(prefixes)))
    return counts


def launches_per_call(fn, calls, prefixes, device, tries=5):
    """Kernels per call whose bare names start with one of `prefixes`, over
    one run of fn (`calls` calls): the largest count of `tries` traces
    (trace_kernel_counts). A trace can drop a kernel's event but never adds
    one, so that count is the one a gate on an exact number of launches can
    hold; on an H100 about one trace in a hundred came up short, and once
    three in a row did, hence five. None off the card, and None when no
    trace caught any of them."""
    if device.type != "cuda":
        return None
    best = max(trace_kernel_counts(fn, prefixes, device, tries))
    return best / calls if best else None


def device_breakdown(fn, device, n=12):
    """device_top of one call of fn under the profiler (device activity
    only), after a warm-up call; None off the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    return device_top(device_events(prof), n)


def device_top(events, n=8):
    """The n device activities with the most time in the trace: [name, ms,
    launches]; a kernel's name is cut to its bare function name (no return
    type, namespace, template or argument list)."""
    total = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            name = e.get("name", "?")
            if e["cat"] == "kernel":
                name = kernel_name(name)
            ms, k = total.get(name, (0.0, 0))
            total[name] = (ms + e["dur"] / 1e3, k + 1)
    top = sorted(total.items(), key=lambda kv: -kv[1][0])[:n]
    return [[name, ms, k] for name, (ms, k) in top]


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}") from e
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from qwen3tts_tpu_torch import PipelineConfig, _kernels
        from qwen3tts_tpu_torch.io import native
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    t_smoke = time.perf_counter()
    phase_s = {}

    def phase_done(name, since):
        phase_s[name] = time.perf_counter() - since
        return time.perf_counter()

    try:
        dev = torch.device("cuda", 0)
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = nvidia_smi_line()
        print(f"device: {kind} x{count}")
        print(smi)

        t0 = time.perf_counter()
        _kernels.build()
        _kernels.load_library()
        native.get_lib()    # the GGUF reader's host library, so no load times its g++
        print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_kernels.build_seconds:.1f} s, "
              f"g++ {native.build_seconds:.1f} s)")
        t0 = phase_done("build", t0)

        tts = make_pipeline(PipelineConfig(), dev)
        tiers = {None: default_pipeline()}
        tiers.update({q: make_pipeline(PipelineConfig(), dev, quant=q) for q in ("q4", "q4pure")})
        report = {}
        check_sampler(tts, report, iters=20)
        check_talker_step(tts, report, iters=5)
        check_code_predictor(tts, report, iters=3)
        check_talker_step_batched(tts, report, iters=3)
        check_code_predictor_batched(tts, report, iters=3)
        check_talker_step_start(tts, report, iters=3)
        check_talker_step_kv_int8(tts, report, iters=3)
        check_code_predictor_per_lane(tts, report, iters=3)
        check_res_block(tts, report, iters=3)
        check_res_block_lanes(tts, report, iters=3)
        check_int8_matmul(tts, report, iters=5)
        check_decode_attention(tts, report, iters=5)
        for q, spec in TIER_SERVE.items():
            mode = spec["mode"]
            check_talker_step(tiers[q], report, iters=5, key=f"fused_talker_step[{mode}]",
                              positions=((512, (10, 300)), (4352, (300, 4000))), exact=True)
            check_talker_step_batched(tiers[q], report, iters=3, shapes=MODE_BATCH_SHAPES,
                                      key=f"fused_talker_step_batched[{mode}]", exact=True)
        check_projections(tts.config.talker, report, dev, iters=3)
        check_head_gemv(tts.config.talker, report, dev, iters=3)
        check_w4_gemv_probe(report, dev, iters=10)
        prng_stats = check_prng(dev)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        t0 = phase_done("kernels", t0)
        for name, r in report.items():
            extra = "".join(f", {k} {r[k]}" for k in ("grid", "launches_per_call",
                                                       "attention_device_ms",
                                                       "library_device_ms") if r.get(k))
            print(f"time {name}: kernel {r['ms']:.4f} ms (device {r.get('device_ms')}), "
                  f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){extra} [{smi}]")

        # each main path with the counts set to 0 just before it and read
        # just after; K4's rows over the whole serve phase
        reset_k4_rows()
        int8_forbidden = tier_forbidden(dict(mode="w8a8", forbidden=()))
        stats, single_counts = serve(tts, MAIN_REQUESTS)
        for st in stats:
            check_launches(f"request {st['request']}", st["launches"], SINGLE_PATH,
                           int8_forbidden)
            print("serve " + json.dumps(dict(st, card=smi)))
        st = stats[1]
        print("prng_cost " + json.dumps(dict(
            request=st["request"], frames_per_s=st["frames_per_s"],
            ms_per_frame=st["ms_per_frame"], frame_keys_us=prng_stats["frame_keys_us"],
            share_of_frame=prng_stats["frame_keys_us"] * 1e-3 / st["ms_per_frame"],
            card=smi)))
        bstats, batch_counts = serve_batches(tts, BATCH_REQUESTS)
        for st in bstats:
            check_launches(f"batch {st['lanes']}", st["launches"], BATCH_PATH, int8_forbidden)
            print("serve_batch " + json.dumps(dict(st, card=smi)))
        runs = [single_counts, batch_counts] + serve_kv_int8(tts, smi)
        t0 = phase_done("serve, serve_batch, serve_kv_int8", t0)
        tts_u = unfused_pipeline(tts)
        ustats, c = serve(tts_u, UNFUSED_REQUESTS)
        runs.append(c)
        for st in ustats:
            check_launches(f"unfused request {st['request']}", st["launches"],
                           unfused_path(tts_u, st["request"]), FUSED_ONLY)
            print("serve_unfused " + json.dumps(dict(st, card=smi)))
        ubstats, c = serve_batches(tts_u, UNFUSED_BATCHES)
        runs.append(c)
        for st in ubstats:
            if "decode_attention" not in unfused_path(tts_u, st["request"]):
                raise SmokeFailure("the unfused batch's cache is below the kernel's 1024 rows")
            check_launches(f"unfused batch {st['lanes']}", st["launches"],
                           unfused_path(tts_u, st["request"]), FUSED_ONLY)
            print("serve_unfused_batch " + json.dumps(dict(st, card=smi)))
        t0 = phase_done("serve_unfused, serve_unfused_batch", t0)
        for q, spec in TIER_SERVE.items():
            label = spec["mode"]
            forbidden = tier_forbidden(spec)
            stats, c = serve(tiers[q], spec["requests"])
            runs.append(c)
            for st in stats:
                check_launches(f"{label} request {st['request']}", st["launches"],
                               spec["single"], forbidden)
                print("serve_tier " + json.dumps(dict(st, tier=q, card=smi)))
            stats, c = serve_batches(tiers[q], spec["batches"])
            runs.append(c)
            for st in stats:
                check_launches(f"{label} batch {st['lanes']}", st["launches"], spec["batch"],
                               forbidden)
                print("serve_tier_batch " + json.dumps(dict(st, tier=q, card=smi)))
        tq_u = unfused_pipeline(tiers["q4"])
        stats, c = serve(tq_u, UNFUSED_Q4_REQUESTS)
        runs.append(c)
        for st in stats:
            check_launches(f"unfused q4 request {st['request']}", st["launches"],
                           unfused_path(tiers["q4"], st["request"]), FUSED_ONLY)
            print("serve_tier_unfused " + json.dumps(dict(st, tier="q4", card=smi)))
        t0 = phase_done("serve_tier, serve_tier_batch, serve_tier_unfused", t0)
        runs += serve_queues(tts, tts_u, tiers[None], smi)
        t0 = phase_done("serve_queue", t0)
        runs += serve_stream(tts, tiers[None], smi)
        check_sampled_serves(tts, tiers[None], smi)
        t0 = phase_done("serve_stream, sampled serves", t0)
        with tempfile.TemporaryDirectory() as root:
            runs += serve_checkpoint(PipelineConfig(), dev, smi, root)
            torch.cuda.empty_cache()
            t0 = phase_done("serve_checkpoint", t0)
            runs += parity_fullsize(PipelineConfig(), dev, smi, root)
            torch.cuda.empty_cache()
            t0 = phase_done("parity_fullsize", t0)
            runs += checkpoint_tools(PipelineConfig(), dev, smi, root,
                                     q4_until=t_smoke + CONVERT_Q4_UNTIL_S)
            print(f"parity_fullsize + checkpoint_tools: "
                  f"{phase_s['parity_fullsize'] + time.perf_counter() - t0:.1f} s [{smi}]")
            t0 = phase_done("checkpoint_tools", t0)
        torch.cuda.empty_cache()
        runs += serve_multi_gpu(PipelineConfig(), smi)
        t0 = phase_done("multi_gpu", t0)
        runs += serve_load(tts, smi)
        t0 = phase_done("serve_load", t0)
        runs += quality(tts, tiers[None], smi)
        runs.append(trace_request(tts, smi))
        t0 = phase_done("quality, trace", t0)
        counts = {k: sum(r[k] for r in runs) for k in KERNELS}
        # the serve phase's rows in this process and on the multi-GPU ranks
        rows = {k: v + sum(r.get(k, 0) for r in runs) for k, v in k4_rows().items()}

        sp = QUEUE_SPECS["sampled"]
        for what, pipe, (text, kw), queue in (
                ("request", tts, MAIN_REQUESTS[1], None),
                ("batch", tts, (batch_texts(BATCH_REQUESTS[0][0]), BATCH_REQUESTS[0][1]), None),
                ("unfused request", tts_u, UNFUSED_REQUESTS[0], None),
                ("bf16 request", tiers[None], TIER_SERVE[None]["requests"][1], None),
                ("sampled queue", tts, (batch_texts(sp["texts"]), sp["kw"]),
                 dict(lanes=sp["lanes"]))):
            rs, wall_ms, busy_ms, top = profile_request(pipe, text, kw, queue)
            if not any(r.success for r in rs):
                raise SmokeFailure(f"profiled {what} failed: {rs[0].error_msg}")
            if not busy_ms > 0:
                raise SmokeFailure(f"the profile of the {what} holds no device activity")
            frames = sum(r.n_frames for r in rs)
            gen_ms = rs[0].timings.t_generate_ms * len(rs)
            print("profile " + json.dumps(dict(
                what=what, lanes=len(rs), request=kw, n_frames=frames, wall_ms=wall_ms,
                device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
                frames_per_s=frames / gen_ms * 1e3,
                vocoder_ms=rs[0].timings.t_decode_ms * len(rs), top_device_ms=top,
                card=smi)))
        phase_done("profile", t0)
        print("phase_seconds " + json.dumps(dict(phase_s, total=time.perf_counter() - t_smoke,
                                                 card=smi)))
    except Exception as e:  # noqa: BLE001 - the smoke reports any failure as exit 1
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    report["sample_rows"]["rows_sampled_on_paths"] = {
        k[len("k4_rows["):-1]: rows[k] for k in K4_ROWS}
    kernels = []
    for name, (_, _, src, replaces) in KERNELS.items():
        r = report[name]
        also = {"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces, **also,
                            launches=counts[name], **r))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
