#!/usr/bin/env python3
"""Time one checkout's single-stream talker step (K1) and its GEMVs on an
NVIDIA GPU, alone and end to end, so that two checkouts can be compared on
one card.

    python3 qwen3tts_tpu_torch/tools/time_gemv.py [--package DIR]

DIR is the root of the checkout whose ``qwen3tts_tpu_torch`` is timed
(default: the checkout holding this file); its kernels are built first. To
compare two checkouts, run this once per checkout in turns, A B B A, back
to back on one card: times move between hosts and calls.

Prints one JSON line:
  - K1 (C = 4352, n_past = 300, greedy) in w8a8 (the int8 tier), bf16 (the
    default tier), the q4 tier's mixed tuple and w4bf16 (q4pure), and in
    w8a8 over the int8 KV cache: CUDA-event ms per call without the
    profiler, then from one call under it: the event ms with it attached,
    the device busy ms (the union of the call's kernel intervals: under
    programmatic dependent launch a kernel's interval can hold its wait),
    the union of its projection kernels' intervals (``gemv_`` / ``gemm_``,
    the codec head's included) and their share of the busy time, and the
    kernels per call;
  - K1's GEMVs alone (ops/w4_gemv_probe.project_layers, B = 1, one launch
    per layer) in w8a8, bf16 and w4bf16: the talker's four projections over
    28 seeded layers, and the probe's shape (L = 28, K = 1024, N = 4096):
    device ms per 28-layer pass (union of intervals) and the weight bytes
    streamed per second of it;
  - the int8 tier's greedy 64-token and sampled 256-token requests and the
    q4pure tier's sampled 256-token request of chip_smoke.py's serve phase:
    frames/s over the generate time;
  - K5 w8a8 at B = 64 (C = 512, n_past = 300), which runs no GEMV: event
    ms and device busy ms, the row that should not move.
The helpers are chip_smoke.py's, from the checkout holding this file.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIERS = {"w8a8": "int8", "bf16": None, "mixed": "q4", "w4bf16": "q4pure"}


def main() -> int:
    pkg = sys.argv[sys.argv.index("--package") + 1] if "--package" in sys.argv else HERE
    sys.path.insert(0, os.path.abspath(pkg))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("time_gemv: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import qwen3tts_tpu_torch
    from qwen3tts_tpu_torch import PipelineConfig, SamplingConfig, _kernels
    from qwen3tts_tpu_torch.ops import w4_gemv_probe as probe
    from qwen3tts_tpu_torch.ops.fused_talker_step import (fused_talker_step,
                                                          fused_talker_step_batched)

    _kernels.load_library()
    dev = torch.device("cuda", 0)
    out = {}

    def call_stats(run):
        st = smoke.talker_call_stats(run, dev)
        busy, gemv = st["device_ms"], st["gemv_device_ms"]
        return dict(ms=smoke.timed(run, dev, 10), **st,
                    gemv_share=None if not busy else gemv / busy)

    g = torch.Generator(device=dev).manual_seed(7)
    pipes = {}
    for mode, quant in TIERS.items():
        tts = smoke.make_pipeline(PipelineConfig(), dev, quant=quant)
        tp, tcfg = tts.talker_params, tts.config.talker
        L, Hkv, D, Vc, H = (tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim,
                            tcfg.codec_vocab_size, tcfg.hidden_size)
        x = torch.randn((H,), generator=g, device=dev)
        kv = torch.randn((L, 2, Hkv, 4352, D), generator=g, device=dev, dtype=torch.bfloat16)
        kw = dict(output_norm=tp.output_norm, codec_head=tp.codec_head,
                  seen=torch.zeros((Vc,), dtype=torch.int8, device=dev), seed=17, top_k=50,
                  repetition_penalty=1.05, suppress_start=Vc - 1024, eos_id=tcfg.codec_eos_id,
                  temperature=0.0, greedy=True, use_top_p=False)
        out[f"K1 {mode} C=4352 n_past=300"] = call_stats(
            lambda: fused_talker_step(tp.blocks, tcfg, x, 300, kv, **kw))
        if mode == "w8a8":
            pair = smoke._int8_cache(kv)
            out["K1 w8a8 int8 KV C=4352 n_past=300"] = call_stats(
                lambda: fused_talker_step(tp.blocks, tcfg, x, 300, pair, **kw))
            del pair
            xb = torch.randn((64, H), generator=g, device=dev)
            kvb = torch.randn((64, L, 2, Hkv, 512, D), generator=g, device=dev,
                              dtype=torch.bfloat16)
            kwb = dict(kw, seen=torch.zeros((64, Vc), dtype=torch.int8, device=dev),
                       seeds=torch.arange(64, dtype=torch.int32, device=dev))
            kwb.pop("seed")
            st = call_stats(lambda: fused_talker_step_batched(tp.blocks, tcfg, xb, 300, kvb,
                                                              **kwb))
            out["K5 w8a8 B=64 C=512 n_past=300"] = st
            del kvb
        del kv
        if quant in ("int8", "q4pure"):
            pipes[quant] = tts
        else:
            del tts
        torch.cuda.empty_cache()

    shapes = list(smoke.talker_projections(PipelineConfig().talker)) + [
        ("probe", probe.K, probe.N)]
    for mode in ("w8a8", "bf16", "w4bf16"):
        per, total_ms, total_bytes = {}, 0.0, 0
        for j, (name, K, N) in enumerate(shapes):
            w = smoke.projection_weights(mode, 28, K, N, dev, seed=100 + j)[0]
            if mode == "w8a8":
                x = torch.randint(-127, 128, (1, K), generator=g, device=dev, dtype=torch.int8)
            else:   # bf16 values, as the row kernels emit them
                x = torch.randn((1, K), generator=g, device=dev).to(torch.bfloat16).float()
            ws = probe.project_layers(x, w, mode)
            run = lambda x=x, w=w, ws=ws: probe.project_layers(x, w, mode, ws)  # noqa: E731
            dms = (smoke._pass_device_ms(run, [28], dev) or [None])[0]
            wb = smoke._nbytes(*(w if hasattr(w, "_fields") else (w,)))
            per[name] = dict(device_ms=dms, ms=smoke.timed(run, dev, 10), weight_bytes=wb,
                             gb_per_s=None if dms is None else wb / (dms * 1e-3) / 1e9)
            if name != "probe" and dms is not None:
                total_ms += dms
                total_bytes += wb
            del w, ws
        out[f"GEMVs {mode} 28 layers"] = dict(
            per_projection=per, talker_device_ms=total_ms,
            talker_gb_per_s=total_bytes / (total_ms * 1e-3) / 1e9 if total_ms else None)
        torch.cuda.empty_cache()

    for quant, (text, req) in (("int8", smoke.MAIN_REQUESTS[0]), ("int8", smoke.MAIN_REQUESTS[1]),
                               ("q4pure", smoke.TIER_SERVE["q4pure"]["requests"][0])):
        tts = pipes[quant]
        tts.synthesize(text, SamplingConfig(**dict(req, max_audio_tokens=16)))   # warm-up
        r = tts.synthesize(text, SamplingConfig(**req))
        out[f"request {quant} {req}"] = dict(
            frames=r.n_frames, frames_per_s=r.n_frames / r.timings.t_generate_ms * 1e3)
    print(json.dumps(dict(package=qwen3tts_tpu_torch.__file__, card=smoke.nvidia_smi_line(),
                          **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
