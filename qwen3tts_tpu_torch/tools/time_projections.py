#!/usr/bin/env python3
"""Time one checkout's batched projections on an NVIDIA GPU: K5 per call in
its four weight modes with its projection GEMMs' share, the projection
GEMMs alone, and the int8 batches that run K5, so that two checkouts can be
compared on one card.

    python3 qwen3tts_tpu_torch/tools/time_projections.py [--package DIR]

DIR is the root of the checkout whose ``qwen3tts_tpu_torch`` is timed
(default: the checkout holding this file); its kernels are built first. To
compare two checkouts, run this once per checkout in turns, A B B A, back
to back on one card: times move between hosts and calls.

Prints one JSON line:
  - K5 (C = 512, n_past = 300, greedy) at B = 16 and 64 in w8a8 (the int8
    tier), bf16 (the default tier), the q4 tier's mixed tuple and w4bf16
    (q4pure): CUDA-event ms per call; from one call under the profiler, the
    device ms of all its kernels, of its projection kernels (every GEMV or
    GEMM launch, ``gemv_`` or ``gemm_``, but the call's last, the codec
    head) and the kernels with the most device time;
  - the projection GEMMs alone (ops/w4_gemv_probe.project_layers: the
    talker's four projections over 28 seeded layers, one launch per layer)
    in w8a8, bf16 and w4bf16 at B = 16 and 64: device ms per 28-layer pass
    of each projection and their sum, one K5 call's projections;
  - the int8 pipeline's 16-lane greedy and 64-lane sampled batches of
    chip_smoke.py's serve phase: frames/s over the generate time.
The helpers are chip_smoke.py's, from the checkout holding this file.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GEMM_PREFIXES = ("gemv_", "gemm_")
TIERS = {"w8a8": "int8", "bf16": None, "mixed": "q4", "w4bf16": "q4pure"}


def main() -> int:
    pkg = sys.argv[sys.argv.index("--package") + 1] if "--package" in sys.argv else HERE
    sys.path.insert(0, os.path.abspath(pkg))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_projections: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import qwen3tts_tpu_torch
    from qwen3tts_tpu_torch import PipelineConfig, SamplingConfig, _kernels
    from qwen3tts_tpu_torch.ops import w4_gemv_probe as probe
    from qwen3tts_tpu_torch.ops.fused_talker_step import fused_talker_step_batched

    _kernels.load_library()
    dev = torch.device("cuda", 0)
    out = {}

    def k5_kernels(fn):
        """Device ms of one call of fn: all kernels, the projections (every
        GEMV/GEMM but the last, the codec head), the top kernels."""
        fn()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        ks = sorted((e for e in smoke.device_events(prof) if e["cat"] == "kernel"),
                    key=lambda e: e["ts"])
        gemm = [e for e in ks if smoke.kernel_name(e["name"]).startswith(GEMM_PREFIXES)]
        return dict(device_ms=sum(e["dur"] for e in ks) / 1e3,
                    projection_device_ms=sum(e["dur"] for e in gemm[:-1]) / 1e3,
                    kernels_per_call=len(ks), top_device_ms=smoke.device_top(ks, 5))

    g = torch.Generator(device=dev).manual_seed(7)
    int8 = None
    for mode, quant in TIERS.items():
        tts = smoke.make_pipeline(PipelineConfig(), dev, quant=quant)
        tp, tcfg = tts.talker_params, tts.config.talker
        L, Hkv, D, Vc, H = (tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim,
                            tcfg.codec_vocab_size, tcfg.hidden_size)
        for B in (16, 64):
            x = torch.randn((B, H), generator=g, device=dev)
            kv = torch.randn((B, L, 2, Hkv, 512, D), generator=g, device=dev,
                             dtype=torch.bfloat16)
            kw = dict(output_norm=tp.output_norm, codec_head=tp.codec_head,
                      seen=torch.zeros((B, Vc), dtype=torch.int8, device=dev),
                      seeds=torch.arange(B, dtype=torch.int32, device=dev), top_k=50,
                      repetition_penalty=1.05, suppress_start=Vc - 1024,
                      eos_id=tcfg.codec_eos_id, temperature=0.0, greedy=True, use_top_p=False)
            run = lambda: fused_talker_step_batched(tp.blocks, tcfg, x, 300, kv,  # noqa: E731
                                                    **kw)
            out[f"K5 {mode} B={B} C=512 n_past=300"] = dict(ms=smoke.timed(run, dev, 5),
                                                            **k5_kernels(run))
            del kv
        if quant == "int8":
            int8 = tts
        else:
            del tts
        torch.cuda.empty_cache()

    shapes = smoke.talker_projections(PipelineConfig().talker)
    for mode in ("w8a8", "bf16", "w4bf16"):
        weights = [smoke.projection_weights(mode, 28, K, N, dev, seed=100 + j)[0]
                   for j, (_, K, N) in enumerate(shapes)]
        for B in (16, 64):
            runs = []
            for (name, K, N), w in zip(shapes, weights):
                if mode == "w8a8":
                    x = torch.randint(-127, 128, (B, K), generator=g, device=dev,
                                      dtype=torch.int8)
                else:   # bf16 values, as the row kernels emit them
                    x = torch.randn((B, K), generator=g, device=dev).to(torch.bfloat16).float()
                ws = probe.project_layers(x, w, mode)
                runs.append(lambda x=x, w=w, ws=ws: probe.project_layers(x, w, mode, ws))
            dms = smoke._pass_device_ms(lambda: [r() for r in runs], [28] * len(runs), dev)
            out[f"projections {mode} B={B}"] = dict(
                device_ms=None if dms is None else sum(dms),
                per_projection=None if dms is None else
                {name: d for (name, _, _), d in zip(shapes, dms)},
                ms=smoke.timed(lambda: [r() for r in runs], dev, 5))
        del weights
        torch.cuda.empty_cache()

    for n_texts, req in smoke.BATCH_REQUESTS:
        rs = int8.synthesize_batch(smoke.batch_texts(n_texts), SamplingConfig(**req))
        frames = sum(r.n_frames for r in rs)
        gen_ms = rs[0].timings.t_generate_ms * n_texts
        out[f"batch {n_texts}"] = dict(request=req, frames=frames,
                                       frames_per_s=frames / gen_ms * 1e3)
    print(json.dumps(dict(package=qwen3tts_tpu_torch.__file__, card=smoke.nvidia_smi_line(),
                          **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
