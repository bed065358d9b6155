#!/usr/bin/env python3
"""Time one checkout's sampled requests and its loop's random draws on an
NVIDIA GPU, so that two checkouts can be compared on one card.

    python3 qwen3tts_tpu_torch/tools/time_requests.py [--package DIR] [--runs N]

DIR is the root of the checkout whose ``qwen3tts_tpu_torch`` is timed
(default: the checkout holding this file); its kernels are built first. To
compare two checkouts, run this once per checkout in turns, A B B A, back
to back on one card: host rates move between processes and calls.

Prints one JSON line:
  - the int8 sampled 256-token request of chip_smoke.py's serve phase
    (MAIN_REQUESTS[1]), after its greedy 64-token request as a warm-up:
    frames and frames/s over the generate time of each of N runs (default
    8), and their mean;
  - the int8 64-lane sampled batch of the serve phase
    (BATCH_REQUESTS[1], synthesize_batch): frames/s over the batch's
    generate time of each of max(1, N // 4) runs, and their mean;
  - the bf16 tier's sampled 128-token request (TIER_SERVE[None]) on
    Qwen3TTS(), after an 8-token warm-up: the same over max(1, N // 4)
    runs;
  - the host's random draws per frame of the checkout's single-stream
    loop, in microseconds: decode_loop.frame_draws (a threefry split into
    3 and two int32 seeds) where the checkout has it, else draw_seeds(gen,
    2), the two torch.Generator draws a frame that it replaces.
The sampled codes, and so the frame counts at EOS, differ between versions
that draw otherwise; frames/s compares their rates. The helpers are
chip_smoke.py's, from the checkout holding this file.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rates(tts, text, kw, runs, SamplingConfig):
    out = []
    for _ in range(runs):
        r = tts.synthesize(text, SamplingConfig(**kw))
        if not r.success:
            raise RuntimeError(f"request {kw} failed: {r.error_msg}")
        out.append(dict(frames=r.n_frames,
                        frames_per_s=r.n_frames / r.timings.t_generate_ms * 1e3))
    return dict(request=kw, runs=out,
                mean_frames_per_s=sum(o["frames_per_s"] for o in out) / len(out))


def _per_frame_us(fn, n=2000):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    pkg = sys.argv[sys.argv.index("--package") + 1] if "--package" in sys.argv else HERE
    runs = int(sys.argv[sys.argv.index("--runs") + 1]) if "--runs" in sys.argv else 8
    sys.path.insert(0, os.path.abspath(pkg))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("time_requests: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import qwen3tts_tpu_torch
    from qwen3tts_tpu_torch import PipelineConfig, SamplingConfig, _kernels
    from qwen3tts_tpu_torch.runtime import decode_loop

    _kernels.load_library()
    dev = torch.device("cuda", 0)
    out = {}
    if hasattr(decode_loop, "frame_draws"):
        out["draws"] = "frame_draws"
        out["draws_us_per_frame"] = _per_frame_us(
            lambda: decode_loop.frame_draws((0, 3), True, True))
    else:
        gen = torch.Generator()
        gen.manual_seed(3)
        out["draws"] = "draw_seeds(gen, 2)"
        out["draws_us_per_frame"] = _per_frame_us(lambda: decode_loop.draw_seeds(gen, 2))

    tts = smoke.make_pipeline(PipelineConfig(), dev)
    warm, (text, req) = smoke.MAIN_REQUESTS[0], smoke.MAIN_REQUESTS[1]
    tts.synthesize(warm[0], SamplingConfig(**warm[1]))
    out["int8"] = _rates(tts, text, req, runs, SamplingConfig)
    lanes, req = smoke.BATCH_REQUESTS[1]
    batch = []
    for _ in range(max(1, runs // 4)):
        rs = tts.synthesize_batch(smoke.batch_texts(lanes), SamplingConfig(**req))
        frames = sum(r.n_frames for r in rs)
        batch.append(dict(frames=frames, frames_per_s=frames / (
            rs[0].timings.t_generate_ms * lanes) * 1e3))   # results carry the wall / B
    out["int8_batch"] = dict(request=req, lanes=lanes, runs=batch, mean_frames_per_s=sum(
        b["frames_per_s"] for b in batch) / len(batch))
    del tts
    torch.cuda.empty_cache()

    bf16 = smoke.default_pipeline()
    text, req = smoke.TIER_SERVE[None]["requests"][1]
    bf16.synthesize(text, SamplingConfig(**dict(req, max_audio_tokens=8)))
    out["bf16"] = _rates(bf16, text, req, max(1, runs // 4), SamplingConfig)
    print(json.dumps(dict(package=qwen3tts_tpu_torch.__file__, card=smoke.nvidia_smi_line(),
                          **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
