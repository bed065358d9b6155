#!/usr/bin/env python3
"""Time one checkout's attention on an NVIDIA GPU: decode attention alone,
K1 and K5 per call with their attention-stage kernels' share, and the
batched requests that run K5, so that two checkouts can be compared on one
card.

    python3 qwen3tts_tpu_torch/tools/time_attention.py [--package DIR]

DIR is the root of the checkout whose ``qwen3tts_tpu_torch`` is timed
(default: the checkout holding this file); its kernels are built first. To
compare two checkouts, run this once per checkout in turns, A B B A, back
to back on one card: times move between hosts and calls.

Prints one JSON line:
  - decode attention at (B, C, n_valid) = (1, 1280, 300) and (16, 4352,
    4000), per call cycling over the 28 layers: CUDA-event ms, the device
    ms of every kernel the calls launch and the kernels per call;
  - K1 (w8a8, C = 4352, n_past 300 and 4000), K5 (w8a8: B = 64, C = 512,
    n_past = 300; B = 16, C = 4352, n_past = 4000; B = 64, C = 1024,
    n_past = 600 with per-lane starts spread over [0, 600]), K1/K5 over
    the int8 (q, scale) cache at the long shapes and K5 over the lane-major
    bf16 cache (kv_layout="lane", no sampling: B = 64, C = 512, n_past =
    300; B = 16, C = 4352, n_past = 4000; B = 13, C = 512, n_past = 300):
    CUDA-event ms per call;
    from one call under the profiler, the device ms of all its kernels, of
    its attention-stage kernels (bare names starting with ``attn_`` or
    ``kv_row_``, and ``merge_kernel`` in checkouts before the attention
    kernel of one launch per layer) and the number of each;
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
ATTENTION_PREFIXES = ("attn_", "merge_kernel", "kv_row_")


def main() -> int:
    pkg = sys.argv[sys.argv.index("--package") + 1] if "--package" in sys.argv else HERE
    sys.path.insert(0, os.path.abspath(pkg))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import qwen3tts_tpu_torch
    from qwen3tts_tpu_torch import PipelineConfig, SamplingConfig, _kernels
    from qwen3tts_tpu_torch.ops.decode_attention import decode_attention_kernel
    from qwen3tts_tpu_torch.ops.fused_talker_step import (fused_talker_step,
                                                          fused_talker_step_batched)

    _kernels.load_library()
    dev = torch.device("cuda", 0)
    tts = smoke.make_pipeline(PipelineConfig(), dev)
    tp, tcfg = tts.talker_params, tts.config.talker
    L, Hq, Hkv, D = tcfg.n_layers, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim
    Vc, H = tcfg.codec_vocab_size, tcfg.hidden_size
    g = torch.Generator(device=dev).manual_seed(7)

    def kernels_of(fn, calls):
        """(device ms per call of all kernels, of the attention stage's;
        kernels per call, attention kernels per call) from one run of fn."""
        fn()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        ks = [e for e in smoke.device_events(prof) if e["cat"] == "kernel"]
        att = [e for e in ks if smoke.kernel_name(e["name"]).startswith(ATTENTION_PREFIXES)]
        return dict(device_ms=sum(e["dur"] for e in ks) / 1e3 / calls,
                    attention_device_ms=sum(e["dur"] for e in att) / 1e3 / calls,
                    kernels_per_call=len(ks) / calls, attention_kernels_per_call=len(att) / calls,
                    top_device_ms=smoke.device_top(ks, 6))

    out = {}
    for B, C, n in ((1, 1280, 300), (16, 4352, 4000)):
        kv = torch.randn((B, L, 2, Hkv, C, D), generator=g, device=dev, dtype=torch.bfloat16)
        q = torch.randn((B, Hq, D), generator=g, device=dev).to(torch.bfloat16)
        run = smoke._layer_cycle(lambda l: decode_attention_kernel(q, kv, l, n), L)
        r = kernels_of(run, L)
        r.pop("top_device_ms")
        out[f"decode_attention B={B} C={C} n_valid={n}"] = dict(
            ms=smoke.timed(run, dev, 20) / L, **r)
        del kv

    def sampling(B):
        seen = torch.zeros((B, Vc) if B else (Vc,), dtype=torch.int8, device=dev)
        base = dict(output_norm=tp.output_norm, codec_head=tp.codec_head, seen=seen, top_k=50,
                    repetition_penalty=1.05, suppress_start=Vc - 1024,
                    eos_id=tcfg.codec_eos_id, temperature=0.0, greedy=True, use_top_p=False)
        if B:
            base["seeds"] = torch.arange(B, dtype=torch.int32, device=dev)
        else:
            base["seed"] = 17
        return base

    x1 = torch.randn((H,), generator=g, device=dev)
    kv = torch.randn((L, 2, Hkv, 4352, D), generator=g, device=dev, dtype=torch.bfloat16)
    pair = smoke._int8_cache(kv)
    for n_past in (300, 4000):
        run = lambda n=n_past: fused_talker_step(tp.blocks, tcfg, x1, n, kv,  # noqa: E731
                                                 **sampling(0))
        out[f"K1 C=4352 n_past={n_past}"] = dict(ms=smoke.timed(run, dev, 10),
                                                **kernels_of(run, 1))
    run = lambda: fused_talker_step(tp.blocks, tcfg, x1, 4000, pair, **sampling(0))  # noqa: E731
    out["K1[kv_int8] C=4352 n_past=4000"] = dict(ms=smoke.timed(run, dev, 10),
                                                **kernels_of(run, 1))
    del kv, pair
    for B, C, n_past, starts in ((64, 512, 300, False), (16, 4352, 4000, False),
                                 (64, 1024, 600, True), (16, 4352, 4000, "kv_int8")):
        x = torch.randn((B, H), generator=g, device=dev)
        kv = torch.randn((B, L, 2, Hkv, C, D), generator=g, device=dev, dtype=torch.bfloat16)
        kw = sampling(B)
        name = f"K5 B={B} C={C} n_past={n_past}"
        if starts == "kv_int8":
            kv = smoke._int8_cache(kv)
            name = f"K5[kv_int8] B={B} C={C} n_past={n_past}"
        elif starts:
            kw.update(start=(torch.arange(B, device=dev) * n_past // (B - 1)).to(torch.int32),
                      start_min=0)
            name += " starts 0..600"
        run = lambda: fused_talker_step_batched(tp.blocks, tcfg, x, n_past, kv,  # noqa: E731
                                                **kw)
        out[name] = dict(ms=smoke.timed(run, dev, 5), **kernels_of(run, 1))
        del kv
    for B, C, n_past in ((64, 512, 300), (16, 4352, 4000), (13, 512, 300)):
        x = torch.randn((B, H), generator=g, device=dev)
        kv = torch.randn((L, 2, Hkv, C, B, D), generator=g, device=dev, dtype=torch.bfloat16)
        run = lambda: fused_talker_step_batched(  # noqa: E731
            tp.blocks, tcfg, x, n_past, kv, kv_layout="lane", output_norm=tp.output_norm,
            codec_head=tp.codec_head)
        out[f"K5[lane] B={B} C={C} n_past={n_past}"] = dict(ms=smoke.timed(run, dev, 5),
                                                           **kernels_of(run, 1))
        del kv
    torch.cuda.empty_cache()
    for n_texts, req in smoke.BATCH_REQUESTS:
        rs = tts.synthesize_batch(smoke.batch_texts(n_texts), SamplingConfig(**req))
        frames = sum(r.n_frames for r in rs)
        gen_ms = rs[0].timings.t_generate_ms * n_texts
        out[f"batch {n_texts}"] = dict(request=req, frames=frames,
                                       frames_per_s=frames / gen_ms * 1e3)
    print(json.dumps(dict(package=qwen3tts_tpu_torch.__file__, card=smoke.nvidia_smi_line(),
                          **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
