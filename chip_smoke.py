#!/usr/bin/env python3
"""Drive the port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py            # needs one CUDA device

Phases (each prints a line; any failure exits non-zero):
  1. device: torch's device name and count, nvidia-smi's name and power limit;
  2. build: compiles the CUDA kernels (qwen3tts_tpu_torch/csrc) with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, on
     the same inputs, at the main paths' full 0.6B widths, with the stated
     tolerance, and both timed with CUDA events after a warm-up; beside
     each time, the least time the card could take for the same work. K1
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
     res block (one at C = 96 and 192, two at 384 and 768); the split
     rules include K3's and the GEMM's plans. Then the projection kernels
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
     probe's shape;
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
     request (C = 256: the GEMM, attention in PyTorch), then, with
     RuntimeConfig.kv_margin = 1000, a sampled request of
     max_audio_tokens=200 and a 16-lane greedy batch of 128 (both at C =
     1280: the GEMM and the decode-attention kernel), which must launch the
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
     decode-attention kernel. Then the checkpoint path (serve_checkpoint,
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
     K1's launches x 1920 samples) and unload_models. No path may launch
     K1/K5 in another tier's mode. K4's
     standalone entry (sample_rows) has no caller on a serve path: frame 0's
     codebook-0 token is drawn by the PyTorch sampler with the JAX
     package's exact top-k, and K4's device code runs inside K1, K2, K5 and
     K6; the kernel phase still holds it against its plain version; the
     probe is off every path;
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

# NVIDIA H100 SXM data sheet, dense: memory rate and peak operations per
# second by operand type (float32 on the CUDA cores, no TF32; float64 on
# the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12,
                  "f64": 67e12}   # f64: the float64 tensor cores


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


def check_sampler(tts, report, iters):
    """K4 on [1, 3072] (cb0: suppression + penalty) and [1, 2048] rows.
    Tolerance: tokens equal. Both versions see the same float32 logits; the
    temperature scale and the top-k counts are exact, so only the top-p
    mass sums differ in order, and the gate demands equal tokens anyway."""
    import torch

    from qwen3tts_tpu_torch.ops.sampling import sample_rows, sample_rows_plain

    dev = tts.device
    g = torch.Generator(device="cpu").manual_seed(11)
    worst = 0
    for V, supp in ((tts.config.talker.codec_vocab_size, True),
                    (tts.config.code_predictor.vocab_size, False)):
        logits = (torch.randn((1, V), generator=g) * 3).to(dev)
        seen = (torch.rand((V,), generator=g) < 0.05).to(dev) if supp else None
        kw = dict(suppress_start=V - 1024 if supp else None,
                  eos_id=tts.config.talker.codec_eos_id if supp else -1,
                  seen=seen, repetition_penalty=1.05)
        for temp, top_k, top_p in ((0.0, 50, 1.0), (0.9, 50, 1.0), (0.9, 50, 0.9)):
            greedy, use_top_p = temp <= 0, top_p < 1.0
            for seed in range(8):
                seeds = torch.tensor([seed * 7919 - 3], dtype=torch.int32, device=dev)
                a = sample_rows(logits, seeds, 0, temperature=temp, top_p=top_p,
                                top_k=top_k, greedy=greedy, use_top_p=use_top_p, **kw)
                b = sample_rows_plain(logits, seeds, 0, temperature=temp, top_p=top_p,
                                      top_k=top_k, greedy=greedy, use_top_p=use_top_p, **kw)
                worst = max(worst, int((a.long().cpu() != b.cpu()).sum()))
    if worst:
        raise SmokeFailure(f"sample_rows: {worst} token(s) differ from the plain version")
    V = tts.config.talker.codec_vocab_size
    logits = torch.randn((1, V), device=dev)
    seeds = torch.tensor([5], dtype=torch.int32, device=dev)
    kw = dict(temperature=0.9, top_p=1.0, top_k=50, greedy=False, use_top_p=False,
              suppress_start=V - 1024, eos_id=2150)
    # one row: the logits in, the seed, the token out; about 50 float32
    # operations per logit (the 30-step top-k bisection, the hash and the
    # two logs of the Gumbel noise, the argmax)
    bound_ms, bound_by = bound(V * 4 + 8, {"f32": 50 * V})
    report["sample_rows"] = dict(
        max_abs_err=float(worst),   # tokens that differ (0 when the gate passed)
        ms=timed(lambda: sample_rows(logits, seeds, 0, **kw), dev, iters),
        plain_ms=timed(lambda: sample_rows_plain(logits, seeds, 0, **kw), dev, iters),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=f"one [1, {V}] row, top-k 50",
        tolerance="tokens equal over 48 draws")
    print(f"kernel sample_rows: tokens equal; {report['sample_rows']['ms']:.4f} ms "
          f"(plain {report['sample_rows']['plain_ms']:.4f} ms)")


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

    def gate(a, b, rel):
        tol = (1e-5 * b.float().abs() if rel else _bf16_ulp(b)) + 1e-5 * float(b.abs().max())
        return float(((a.float() - b.float()).abs() - tol).max()) <= 0

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
        ok = gate(a, b, rel=dt == torch.float32)
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
            ok = bool(((a.float() - b.float()).abs() <= _bf16_ulp(b) + 1e-6).all())
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
    -> int32; on CUDA it takes more than 16 rows, so null at B <= 16) or
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
                    lib = (None if B <= 16 else _layer_cycle(
                        lambda l, x=x, q=w.q: torch._int_mm(x, q[l]), L))
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
                library=("torch._int_mm (int32; it refuses 16 rows or fewer, so none at B "
                         "<= 16)" if mode == "w8a8" else
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
     dict(max_audio_tokens=600, seed=5)),
]
# 520 frames: the fewest that keep C = 1280 (frame bucket 1024), so the
# decode-attention kernel runs at the depth of a long request
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
    st = dict(queue=what, texts=n, request=kw, frames=frames,
              frames_per_s=frames / gen_ms * 1e3, generate_ms=gen_ms,
              vocoder_ms=rs[0].timings.t_decode_ms * n, **tts.last_queue_stats,
              launches=counts)
    print(f"queue {what}: {n} texts on {lanes} lanes, {frames} frames, "
          f"{st['frames_per_s']:.2f} frames/s (generate {gen_ms:.1f} ms); "
          f"{tts.last_queue_stats}; launches {counts}")
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
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    try:
        dev = torch.device("cuda", 0)
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = nvidia_smi_line()
        print(f"device: {kind} x{count}")
        print(smi)

        t0 = time.perf_counter()
        _kernels.build()
        _kernels.load_library()
        print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_kernels.build_seconds:.1f} s)")

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
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        for name, r in report.items():
            extra = "".join(f", {k} {r[k]}" for k in ("grid", "launches_per_call",
                                                       "attention_device_ms",
                                                       "library_device_ms") if r.get(k))
            print(f"time {name}: kernel {r['ms']:.4f} ms (device {r.get('device_ms')}), "
                  f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){extra} [{smi}]")

        # each main path with the counts set to 0 just before it and read
        # just after
        int8_forbidden = tier_forbidden(dict(mode="w8a8", forbidden=()))
        stats, single_counts = serve(tts, MAIN_REQUESTS)
        for st in stats:
            check_launches(f"request {st['request']}", st["launches"], SINGLE_PATH,
                           int8_forbidden)
            print("serve " + json.dumps(dict(st, card=smi)))
        bstats, batch_counts = serve_batches(tts, BATCH_REQUESTS)
        for st in bstats:
            check_launches(f"batch {st['lanes']}", st["launches"], BATCH_PATH, int8_forbidden)
            print("serve_batch " + json.dumps(dict(st, card=smi)))
        runs = [single_counts, batch_counts] + serve_kv_int8(tts, smi)
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
        runs += serve_queues(tts, tts_u, tiers[None], smi)
        with tempfile.TemporaryDirectory() as root:
            runs += serve_checkpoint(PipelineConfig(), dev, smi, root)
        torch.cuda.empty_cache()
        counts = {k: sum(r[k] for r in runs) for k in KERNELS}

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
    except Exception as e:  # noqa: BLE001 - the smoke reports any failure as exit 1
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

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
