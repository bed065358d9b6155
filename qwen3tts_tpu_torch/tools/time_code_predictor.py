#!/usr/bin/env python3
"""Time one checkout's code predictor on an NVIDIA GPU, alone and end to
end, so that two checkouts can be compared on one card.

    python3 qwen3tts_tpu_torch/tools/time_code_predictor.py [--package DIR]

DIR is the root of the checkout whose ``qwen3tts_tpu_torch`` is timed
(default: the checkout holding this file); its kernels are built first. To
compare two checkouts, run this once per checkout in turns, A B B A, back
to back on one card: times move between hosts and calls.

Prints one JSON line:
  - K2 (one frame) and K6 at B = 64 and 16, sampled (temperature 0.9,
    top-k 50): CUDA-event ms per call and the device ms of every kernel one
    call launches (the port's and PyTorch's operand preparation alike, so
    that versions built of other kernels are timed alike);
  - the int8 sampled 256-token request of chip_smoke.py's serve phase, after
    its greedy 64-token request as a warm-up: frames/s over the generate
    time, then the same request under torch.profiler (device activity
    only): wall ms, device busy ms (union of kernel, copy and memset
    intervals), idle share, frames/s.
The helpers are chip_smoke.py's, from the checkout holding this file.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    pkg = sys.argv[sys.argv.index("--package") + 1] if "--package" in sys.argv else HERE
    sys.path.insert(0, os.path.abspath(pkg))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("time_code_predictor: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import qwen3tts_tpu_torch
    from qwen3tts_tpu_torch import PipelineConfig, SamplingConfig, _kernels
    from qwen3tts_tpu_torch.ops.fused_code_predictor import fused_predict_codes
    from qwen3tts_tpu_torch.ops.fused_code_predictor_batched import fused_predict_codes_batched

    _kernels.load_library()
    dev = torch.device("cuda", 0)
    tts = smoke.make_pipeline(PipelineConfig(), dev)
    cp, ccfg = tts.cp_params, tts.config.code_predictor
    g = torch.Generator(device="cpu").manual_seed(17)
    th = torch.randn((64, ccfg.hidden_size), generator=g).to(device=dev, dtype=tts.dtype)
    cb0 = tts.talker_params.codec_embd[torch.arange(64, device=dev) * 29 + 5]
    seeds = torch.arange(64, dtype=torch.int32, device=dev) * 104729 - 3000
    kw = dict(temperature=0.9, top_k=50, greedy=False, use_top_p=False)
    runs = {"K2": lambda: fused_predict_codes(cp, ccfg, th[0], cb0[0], 991, **kw)}
    for B in (64, 16):
        runs[f"K6 B={B}"] = (lambda B=B: fused_predict_codes_batched(
            cp, ccfg, th[:B], cb0[:B], seeds[:B], **kw))
    out = {name: dict(ms=smoke.timed(run, dev, 20),
                      device_ms=smoke.device_ms_per_call(run, 1, ("",), dev))
           for name, run in runs.items()}

    warm, (text, req) = smoke.MAIN_REQUESTS[0], smoke.MAIN_REQUESTS[1]
    tts.synthesize(warm[0], SamplingConfig(**warm[1]))
    r = tts.synthesize(text, SamplingConfig(**req))
    if not r.success:
        raise RuntimeError(f"request {req} failed: {r.error_msg}")
    rs, wall_ms, busy_ms, _ = smoke.profile_request(tts, text, req)
    out["request"] = dict(
        request=req, n_frames=r.n_frames, frames_per_s=r.n_frames / r.timings.t_generate_ms * 1e3,
        profiled=dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                      device_idle_share=1.0 - busy_ms / wall_ms,
                      frames_per_s=rs[0].n_frames / rs[0].timings.t_generate_ms * 1e3))
    print(json.dumps(dict(package=qwen3tts_tpu_torch.__file__, card=smoke.nvidia_smi_line(),
                          **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
