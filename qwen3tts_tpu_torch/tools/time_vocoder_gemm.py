#!/usr/bin/env python3
"""Time one checkout's K3 (the vocoder res-block) and W8A16 GEMM on an
NVIDIA GPU, with the serve paths they sit on, so that two checkouts can be
compared on one card.

    python3 qwen3tts_tpu_torch/tools/time_vocoder_gemm.py [--package DIR]
        [--groups LANES:FRAMES,...]
    python3 qwen3tts_tpu_torch/tools/time_vocoder_gemm.py --repeat N
    python3 qwen3tts_tpu_torch/tools/time_vocoder_gemm.py --requests N [--package DIR]

DIR is the root of the checkout whose ``qwen3tts_tpu_torch`` is timed
(default: the checkout holding this file); its kernels are built first. To
compare two checkouts, run this once per checkout in turns, A B B A, back
to back on one card: times move between hosts and calls.

With --repeat N it times nothing: it runs chip_smoke.py's K3 check N times
on this checkout and prints, per run, whether the check passed (its error
gate and its launch count), K3's largest error, the launches per res block
at each width, and every single trace's count of K3's kernels (three runs
of each res block per trace), so that a trace that dropped an event shows.

With --requests N it times nothing else: the sampled 256-token request of
chip_smoke.py's serve phase through synthesize, N runs after a warm-up,
each run's generate frames/s and vocoder ms (t_decode_ms); short enough
to run each checkout in several processes, in turns, where one process's
host speed moves a request by several percent.

Prints one JSON line, on the int8 pipeline's seeded synthetic weights:
  - K3 at each decoder width for a 64-frame clip (the three dilations
    summed) and over all 12 res blocks: CUDA-event ms, the device ms of
    K3's kernels under the profiler (either checkout's kernel names), and
    kernels per res block;
  - vocoder_decode of a 64-frame clip: event ms and device ms of all its
    kernels;
  - synthesize of chip_smoke.py's sampled 256-token request, three runs
    after a warm-up: each run's generate frames/s and vocoder ms
    (t_decode_ms);
  - where the checkout has pipeline.vocode_batched: 64 windows of 8 to 48
    frames (the streamed queue's window lengths: a first emission of 8,
    steady ones of 16 history + 32 cadence, remainders between) on random
    codes, vocoded together, five runs after a warm-up: each run's wall ms;
  - the GEMM at chip_smoke.py's shapes (the talker's four projections at
    M = 1, 10, 64 and 128, bf16 x, cycling over the 28 layers' weights):
    device ms per call and kernels per call;
  - chip_smoke.py's 64-lane sampled batch: its vocoder ms and its generate
    frames/s; the 128-text sampled queue on 64 lanes: frames/s over its
    wall (which includes the vocoding);
  - the batch's codes vocoded lane by lane (decode_codes) and, where the
    checkout has it, through pipeline.vocode_batched: wall ms, the peak of
    torch.cuda.max_memory_allocated, the groups, the largest difference
    from lane by lane; with --groups, once more per LANES:FRAMES pair with
    VOCODE_MAX_LANES and VOCODE_MAX_LANE_FRAMES set to it (the sweep the
    constants were chosen from);
  - where the checkout streams: the 128-text queue with on_audio (chunks
    of 8, history 16, cadence 32) beside it without: aggregate frames/s
    over the wall and each request's time to first audio from run()'s
    start (p50, p90); synthesize_streaming of the sampled 256-token
    request (chunks of 16, history 32): TTFA over nine seeds on the host
    clock from the call to the first chunk in host memory, and the
    stream's frames/s over its wall (null where the checkout does not
    stream);
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
import time

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


def groups_arg():
    """--groups LANES:FRAMES,... as [(lanes, frames)] ([] without it)."""
    if "--groups" not in sys.argv:
        return []
    spec = sys.argv[sys.argv.index("--groups") + 1]
    return [tuple(int(v) for v in pair.split(":")) for pair in spec.split(",")]


def vocode_lanes(tts, rs, dev, sweep):
    """The batch results' codes vocoded lane by lane and, where the
    checkout has vocode_batched, grouped (see the module's docstring)."""
    import numpy as np
    import torch

    from qwen3tts_tpu_torch import pipeline

    live = [r for r in rs if r.n_frames]
    nf = [r.n_frames for r in live]
    spf = tts.config.vocoder.samples_per_frame

    def walled(fn):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, dict(wall_ms=(time.perf_counter() - t0) * 1e3, memory_before_bytes=base,
                         peak_memory_bytes=torch.cuda.max_memory_allocated(dev))

    alone, out = walled(lambda: [tts.decode_codes(r.codes) for r in live])
    out = dict(lanes=len(live), frames=sum(nf), lane_by_lane=out)
    if not hasattr(pipeline, "vocode_batched"):
        return dict(out, grouped=None)
    bufs = np.zeros((len(live), max(nf), 16), np.int64)
    for j, r in enumerate(live):
        bufs[j, :r.n_frames] = r.codes
    consts = (pipeline.VOCODE_MAX_LANES, pipeline.VOCODE_MAX_LANE_FRAMES)
    runs = {}
    for lanes, frames in [consts] + [g for g in sweep if g != consts]:
        pipeline.VOCODE_MAX_LANES, pipeline.VOCODE_MAX_LANE_FRAMES = lanes, frames
        try:
            pipeline.vocode_batched(tts.vocoder_params, tts.config.vocoder, bufs, nf)  # warm-up
            audio, st = walled(lambda: pipeline.vocode_batched(
                tts.vocoder_params, tts.config.vocoder, bufs, nf))
            err = max(float(abs(audio[j, :n * spf] - a).max())
                      for j, (n, a) in enumerate(zip(nf, alone)))
            st.update(groups=len(pipeline.vocode_groups(nf)), max_abs_err_to_lane_by_lane=err)
        except torch.cuda.OutOfMemoryError as e:
            st = dict(out_of_memory=str(e).splitlines()[0])
        runs[f"{lanes}:{frames}"] = st
        print(json.dumps({f"vocode_batched {lanes}:{frames}": st}), file=sys.stderr)
    pipeline.VOCODE_MAX_LANES, pipeline.VOCODE_MAX_LANE_FRAMES = consts
    return dict(out, grouped=runs, constants=f"{consts[0]}:{consts[1]}")


def single_request(tts, smoke, runs=3):
    """synthesize of the sampled 256-token request (see the module's
    docstring)."""
    from qwen3tts_tpu_torch import SamplingConfig

    text, req = smoke.MAIN_REQUESTS[1]
    tts.synthesize(text, SamplingConfig(**req))
    out = []
    for _ in range(runs):
        r = tts.synthesize(text, SamplingConfig(**req))
        out.append(dict(frames=r.n_frames,
                        frames_per_s=r.n_frames / r.timings.t_generate_ms * 1e3,
                        vocoder_ms=r.timings.t_decode_ms))
    return dict(request=req, runs=out)


def stream_windows(tts, dev, g, runs=5):
    """64 ragged windows vocoded together (see the module's docstring), or
    None where the checkout has no vocode_batched."""
    import torch

    from qwen3tts_tpu_torch import pipeline

    if not hasattr(pipeline, "vocode_batched"):
        return None
    vcfg = tts.config.vocoder
    nf = [8 + (37 * b) % 41 for b in range(64)]
    codes = torch.randint(0, vcfg.codebook_size, (64, max(nf), vcfg.n_codebooks),
                          generator=g).numpy()
    pipeline.vocode_batched(tts.vocoder_params, vcfg, codes, nf)
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        pipeline.vocode_batched(tts.vocoder_params, vcfg, codes, nf)
        walls.append((time.perf_counter() - t0) * 1e3)
    return dict(windows=len(nf), frames=sum(nf), groups=len(pipeline.vocode_groups(nf)),
                wall_ms=walls)


def stream_queue(tts, smoke, sp):
    """The sampled queue with on_audio (the JAX package's streaming
    defaults), or None where the checkout refuses on_audio."""
    import numpy as np

    from qwen3tts_tpu_torch import SamplingConfig

    first_at = {}
    texts = smoke.batch_texts(sp["texts"])
    t0 = time.perf_counter()
    try:
        rs = tts.synthesize_queue(texts, SamplingConfig(**sp["kw"]), lanes=sp["lanes"],
                                  on_audio=lambda i, c, f: first_at.setdefault(
                                      i, time.perf_counter()))
    except NotImplementedError:
        return None
    wall_ms = (time.perf_counter() - t0) * 1e3
    run0 = tts.last_queue_stats.get("run_started", t0)
    ttfa = [(t - run0) * 1e3 for t in first_at.values()]
    frames = sum(r.n_frames for r in rs)
    return dict(frames=frames, frames_per_s=frames / wall_ms * 1e3, wall_ms=wall_ms,
                ttfa_p50_ms=float(np.percentile(ttfa, 50)),
                ttfa_p90_ms=float(np.percentile(ttfa, 90)), requests_heard=len(ttfa))


def stream_request(tts, smoke):
    """synthesize_streaming's TTFA over chip_smoke.py's nine seeds and one
    whole stream's frames/s, or None where the checkout has no
    synthesize_streaming."""
    import numpy as np

    if not hasattr(tts, "synthesize_streaming"):
        return None
    sp = smoke.STREAM_SPEC
    (text, req), k, h = sp["request"], sp["chunk_frames"], sp["history"]
    ttfa = smoke.stream_ttfa(tts, text, req, k, h, sp["ttfa_seeds"], sp["ttfa_n"])
    _, codes, _, wall_ms, _ = smoke.stream_request(tts, text, req, k, h)
    return dict(ttfa_p50_ms=float(np.percentile(ttfa, 50)),
                ttfa_p90_ms=float(np.percentile(ttfa, 90)), seeds=len(ttfa),
                frames=len(codes), frames_per_s=len(codes) / wall_ms * 1e3)


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
    if "--requests" in sys.argv:
        import qwen3tts_tpu_torch
        from qwen3tts_tpu_torch import PipelineConfig

        tts = smoke.make_pipeline(PipelineConfig(), torch.device("cuda", 0))
        runs = single_request(tts, smoke, int(sys.argv[sys.argv.index("--requests") + 1]))
        print(json.dumps(dict(package=qwen3tts_tpu_torch.__file__, card=smoke.nvidia_smi_line(),
                              **runs)))
        return 0
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

    out["request sampled 256"] = single_request(tts, smoke)
    out["vocode stream windows"] = stream_windows(tts, dev, g)

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
    out[f"vocode batch {lanes}"] = vocode_lanes(tts, rs, dev, groups_arg())
    sp = smoke.QUEUE_SPECS["sampled"]
    st, _ = smoke.serve_queue(tts, smoke.batch_texts(sp["texts"]), sp["kw"], sp["lanes"],
                              "sampled")
    out[f"queue {sp['texts']} sampled"] = dict(frames=st["frames"],
                                               frames_per_s=st["frames_per_s"],
                                               wall_ms=st["generate_ms"])
    out[f"queue {sp['texts']} sampled streamed"] = stream_queue(tts, smoke, sp)
    out["stream request sampled 256"] = stream_request(tts, smoke)

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
