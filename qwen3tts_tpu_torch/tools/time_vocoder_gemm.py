#!/usr/bin/env python3
"""Time one checkout's K3 (the vocoder res-block) and W8A16 GEMM on an
NVIDIA GPU, with the serve paths they sit on, so that two checkouts can be
compared on one card.

    python3 qwen3tts_tpu_torch/tools/time_vocoder_gemm.py [--package DIR]
    python3 qwen3tts_tpu_torch/tools/time_vocoder_gemm.py --repeat N

DIR is the root of the checkout whose ``qwen3tts_tpu_torch`` is timed
(default: the checkout holding this file); its kernels are built first. To
compare two checkouts, run this once per checkout in turns, A B B A, back
to back on one card: times move between hosts and calls.

With --repeat N it times nothing: it runs chip_smoke.py's K3 check N times
on this checkout and prints, per run, whether the check passed (its error
gate and its launch count), K3's largest error, the launches per res block
at each width, and every single trace's count of K3's kernels (three runs
of each res block per trace), so that a trace that dropped an event shows.

Prints one JSON line, on the int8 pipeline's seeded synthetic weights:
  - K3 at each decoder width for a 64-frame clip (the three dilations
    summed) and over all 12 res blocks: CUDA-event ms, the device ms of
    K3's kernels under the profiler (either checkout's kernel names), and
    kernels per res block;
  - vocoder_decode of a 64-frame clip: event ms and device ms of all its
    kernels;
  - the GEMM at chip_smoke.py's shapes (the talker's four projections at
    M = 1, 10, 64 and 128, bf16 x, cycling over the 28 layers' weights):
    device ms per call and kernels per call;
  - chip_smoke.py's 64-lane sampled batch: its vocoder ms and its generate
    frames/s; the 128-text sampled queue on 64 lanes: frames/s over its
    wall (which includes the vocoding);
  - the paths on which the GEMM runs every projection or the prefill, each
    with its generate frames/s (one run after a profiled one) and the
    GEMM's device ms and kernels over the profiled run: the fused int8
    greedy 64-token request (the GEMM in its prefill), and on the unfused
    path (both fused kernels off) chip_smoke.py's greedy 64-token request
    and its 16-lane greedy batch cut from 520 to 64 frames (M = 16).
The helpers are chip_smoke.py's, from the checkout holding this file.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# K3's kernels in either design: the three-kernel one and res_conv_kernel
K3_PREFIXES = ("snake_kernel", "conv_gemm_kernel", "res_conv_kernel")
GEMM_ROWS = (1, 10, 64, 128)


def gemm_in(run, dev, smoke):
    """Results of one profiled run() (a list of TTSResult) and the GEMM's
    device ms and kernel count in its trace, then the generate frames/s of
    a second, unprofiled run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(dev)
    durs = [e["dur"] for e in smoke.device_events(prof)
            if e["cat"] == "kernel" and smoke.kernel_name(e["name"]).startswith("int8_mm_")]
    rs = run()
    frames = sum(r.n_frames for r in rs)
    return dict(frames=frames, frames_per_s=frames / (rs[0].timings.t_generate_ms * len(rs)) * 1e3,
                gemm_device_ms=sum(durs) / 1e3, gemm_kernels=len(durs))


def repeat_res_block(smoke, n):
    """chip_smoke.check_res_block n times (see the module's docstring)."""
    import torch

    from qwen3tts_tpu_torch import PipelineConfig
    from qwen3tts_tpu_torch.ops.fused_vocoder import fused_res_block

    dev = torch.device("cuda", 0)
    tts = smoke.make_pipeline(PipelineConfig(), dev)
    vcfg, runs = tts.config.vocoder, []
    for _ in range(n):
        report, failure = {}, None
        try:
            smoke.check_res_block(tts, report, iters=1)
        except smoke.SmokeFailure as err:
            failure = str(err)
        r = report.get("fused_res_block", {})
        g = torch.Generator(device="cpu").manual_seed(9)
        T, traces = 64 * 2 ** vcfg.n_convnext, {}
        for blk, rate in zip(tts.vocoder_params.dec_blocks, vcfg.upsample_rates):
            T *= rate
            C, res = blk.convt_w.shape[-1], blk.res
            x = torch.randn((T, C), generator=g).to(dev)
            for i, d in enumerate(vcfg.res_dilations):
                args = (x, res.conv1_w[i], res.conv1_b[i], res.act1_alpha[i], res.act1_beta[i],
                        res.conv2_w[i], res.conv2_b[i], res.act2_alpha[i], res.act2_beta[i])
                traces[f"C={C} d={d}"] = smoke.trace_kernel_counts(
                    lambda args=args, d=d: [fused_res_block(*args, dilation=d) for _ in range(3)],
                    K3_PREFIXES, dev, 3)
        runs.append(dict(passed=failure is None, failure=failure,
                         max_abs_err=r.get("max_abs_err"),
                         launches_per_res_block={C: w["launches_per_res_block"]
                                                 for C, w in r.get("widths", {}).items()},
                         trace_counts=traces))
        print(json.dumps(runs[-1]), file=sys.stderr)
    print(json.dumps(dict(card=smoke.nvidia_smi_line(), runs=len(runs),
                          passed=sum(r["passed"] for r in runs), each=runs)))
    return 0 if all(r["passed"] for r in runs) else 1


def main() -> int:
    pkg = sys.argv[sys.argv.index("--package") + 1] if "--package" in sys.argv else HERE
    sys.path.insert(0, os.path.abspath(pkg))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("time_vocoder_gemm: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if "--repeat" in sys.argv:
        return repeat_res_block(smoke, int(sys.argv[sys.argv.index("--repeat") + 1]))
    import qwen3tts_tpu_torch
    from qwen3tts_tpu_torch import PipelineConfig, SamplingConfig, _kernels
    from qwen3tts_tpu_torch.models import vocoder as vocoder_model
    from qwen3tts_tpu_torch.ops.fused_vocoder import fused_res_block
    from qwen3tts_tpu_torch.ops.int8_matmul import int8_matmul

    _kernels.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tts = smoke.make_pipeline(PipelineConfig(), dev)
    vcfg, out = tts.config.vocoder, {}

    g = torch.Generator(device="cpu").manual_seed(9)
    T, k3 = 64 * 2 ** vcfg.n_convnext, {}
    for blk, rate in zip(tts.vocoder_params.dec_blocks, vcfg.upsample_rates):
        T *= rate
        C = blk.convt_w.shape[-1]
        x = torch.randn((T, C), generator=g).to(dev)
        res, w = blk.res, dict(T=T, ms=0.0, device_ms=0.0, kernels_per_res_block=[])
        for i, d in enumerate(vcfg.res_dilations):
            args = (x, res.conv1_w[i], res.conv1_b[i], res.act1_alpha[i], res.act1_beta[i],
                    res.conv2_w[i], res.conv2_b[i], res.act2_alpha[i], res.act2_beta[i])
            run = lambda args=args, d=d: fused_res_block(*args, dilation=d)  # noqa: E731
            w["ms"] += smoke.timed(run, dev, 5)
            dms = smoke.device_ms_per_call(run, 1, K3_PREFIXES, dev)
            w["device_ms"] = None if dms is None or w["device_ms"] is None \
                else w["device_ms"] + dms
            w["kernels_per_res_block"].append(smoke.launches_per_call(
                lambda run=run: [run() for _ in range(3)], 3, K3_PREFIXES, dev))
        k3[f"C={C}"] = w
    out["K3"] = dict(widths=k3, ms=sum(w["ms"] for w in k3.values()),
                     device_ms=None if any(w["device_ms"] is None for w in k3.values())
                     else sum(w["device_ms"] for w in k3.values()))

    codes = torch.randint(0, vcfg.codebook_size, (64, vcfg.n_codebooks), generator=g).to(dev)
    voc = lambda: vocoder_model.vocoder_decode(tts.vocoder_params, vcfg, codes, 64)  # noqa: E731
    out["vocoder_decode 64 frames"] = dict(ms=smoke.timed(voc, dev, 3),
                                           device_ms=smoke.device_ms_per_call(voc, 1, ("",),
                                                                              dev))

    blocks, L, gemm = tts.talker_params.blocks, tts.config.talker.n_layers, {}
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        wt = getattr(blocks, name)
        K, N = wt.q.shape[1:]
        for M in GEMM_ROWS:
            x = torch.randn((M, K), generator=g).to(device=dev, dtype=tts.dtype)
            run = smoke._layer_cycle(lambda l, x=x, wt=wt: int8_matmul(x, wt.q[l], wt.scale[l]),
                                     L)
            gemm[f"{name} M={M} K={K} N={N}"] = dict(
                ms=smoke.timed(run, dev, 5) / L,
                device_ms=smoke.device_ms_per_call(run, L, ("int8_mm_",), dev),
                kernels_per_call=smoke.launches_per_call(run, L, ("",), dev))
    out["GEMM"] = gemm

    lanes, req = smoke.BATCH_REQUESTS[1]
    rs = tts.synthesize_batch(smoke.batch_texts(lanes), SamplingConfig(**req))
    frames = sum(r.n_frames for r in rs)
    out[f"batch {lanes}"] = dict(
        request=req, frames=frames,
        vocoder_ms=max(r.timings.t_decode_ms for r in rs) * lanes,
        frames_per_s=frames / (rs[0].timings.t_generate_ms * lanes) * 1e3)
    sp = smoke.QUEUE_SPECS["sampled"]
    st, _ = smoke.serve_queue(tts, smoke.batch_texts(sp["texts"]), sp["kw"], sp["lanes"],
                              "sampled")
    out[f"queue {sp['texts']} sampled"] = dict(frames=st["frames"],
                                               frames_per_s=st["frames_per_s"],
                                               wall_ms=st["generate_ms"])

    text, req = smoke.MAIN_REQUESTS[0]
    out["fused request greedy 64"] = gemm_in(
        lambda: [tts.synthesize(text, SamplingConfig(**req))], dev, smoke)
    tts_u = smoke.unfused_pipeline(tts)
    text, req = smoke.UNFUSED_REQUESTS[0]
    out["unfused request greedy 64"] = gemm_in(
        lambda: [tts_u.synthesize(text, SamplingConfig(**req))], dev, smoke)
    lanes, req = smoke.UNFUSED_BATCHES[0]
    req = dict(req, max_audio_tokens=64)
    out[f"unfused batch {lanes} greedy 64"] = gemm_in(
        lambda: tts_u.synthesize_batch(smoke.batch_texts(lanes), SamplingConfig(**req)), dev,
        smoke)
    print(json.dumps(dict(package=qwen3tts_tpu_torch.__file__, card=smoke.nvidia_smi_line(),
                          **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
