#!/usr/bin/env python3
"""Time one checkout's sampler (K4) at its four sites on an NVIDIA GPU, so
that two checkouts can be compared on one card.

    python3 qwen3tts_tpu_torch/tools/time_sampler.py [--package DIR]

DIR is the root of the checkout whose ``qwen3tts_tpu_torch`` is timed
(default: the checkout holding this file); its kernels are built first. To
compare two checkouts, run this once per checkout in turns, A B B A, back
to back on one card: times move between hosts and calls.

Prints one JSON line:
  - sample_rows (K4's standalone entry) on [R, 3072] rows with the cb0
    suppression and a repetition penalty, and on [R, 2048] rows (the code
    predictor's vocabulary), R = 1 and 64, greedy, top-k 50 at temperature
    0.9 (the default) and top-k 50 with top-p 0.9: CUDA-event ms per call
    and the device ms of its kernel per call;
  - K4 inside K1, K5 (B = 64), K2 and K6 (B = 64), sampled by default
    and greedy (chip_smoke.sampler_sites): K1's and K5's
    head_sample_kernel, K2's and K6's persistent kernel, and K2's and K6's
    sampled minus greedy, what the 15 sequential samples of a lane cost
    beyond their argmax.
The helpers are chip_smoke.py's, from the checkout holding this file.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODES = {"greedy": dict(temperature=0.0, top_p=1.0, greedy=True, use_top_p=False),
         "topk50": dict(temperature=0.9, top_p=1.0, greedy=False, use_top_p=False),
         "topk50_topp09": dict(temperature=0.9, top_p=0.9, greedy=False, use_top_p=True)}


def main() -> int:
    pkg = sys.argv[sys.argv.index("--package") + 1] if "--package" in sys.argv else HERE
    sys.path.insert(0, os.path.abspath(pkg))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("time_sampler: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import qwen3tts_tpu_torch
    from qwen3tts_tpu_torch import PipelineConfig, _kernels
    from qwen3tts_tpu_torch.ops.sampling import sample_rows

    _kernels.load_library()
    dev = torch.device("cuda", 0)
    out = {}
    g = torch.Generator(device="cpu").manual_seed(23)

    for V, supp in ((3072, True), (2048, False)):
        for R in (1, 64):
            logits = (torch.randn((R, V), generator=g) * 3).to(dev)
            seeds = torch.arange(R, dtype=torch.int32, device=dev) * 7919 - 3
            kw = dict(top_k=50)
            if supp:
                kw.update(suppress_start=V - 1024, eos_id=2150, repetition_penalty=1.05,
                          seen=(torch.rand((V,), generator=g) < 0.05).to(dev))
            for mode, mk in MODES.items():
                run = lambda: sample_rows(logits, seeds, 3, **kw, **mk)  # noqa: E731
                out[f"sample_rows [{R}, {V}] {mode}"] = dict(
                    ms=smoke.timed(run, dev, 20),
                    device_ms=smoke.device_ms_per_call(lambda: [run() for _ in range(10)], 10,
                                                       ("sample_rows_kernel",), dev,
                                                       expect=10))

    tts = smoke.make_pipeline(PipelineConfig(), dev)
    out.update(smoke.sampler_sites(tts, dev))
    print(json.dumps(dict(package=qwen3tts_tpu_torch.__file__, card=smoke.nvidia_smi_line(),
                          **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
