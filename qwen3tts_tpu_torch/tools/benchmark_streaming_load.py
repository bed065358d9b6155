#!/usr/bin/env python3
"""Streaming continuous serving under load on the port (counterpart of
``tools/benchmark_streaming_load.py``): per-request TTFA p50/p99.

Drives a lognormal request mix through the streaming path,
``Qwen3TTS.synthesize_queue(on_audio=...)`` (each chunk boundary vocodes the
emitting requests' windows together, ``vocode_batched_groups``), and
reports per request:

  ttfa     host time from the call to the request's first audio chunk in
           host memory; it includes the queue wait of requests admitted
           later (the "under load" number);
  e2e      host time to the request's final chunk;

and the aggregate useful frames/s over the call. Two passes: the first
warms up (the kernels' build, cuBLAS handles, the allocator), the second
is timed. The queue keeps EOS, as the JAX tool's does, so a request may
end before its budget.

    python3 qwen3tts_tpu_torch/tools/benchmark_streaming_load.py --lanes 64 \\
        --requests 128 [--chunk 8] [--cadence 32] [--quant int8|q4|q4pure|bf16]

Runs on the card (CUDA device 0) on seeded synthetic weights at
``PipelineConfig()``'s widths; without a card it exits 2. Prints one JSON
line, the timed pass's: the JAX tool's keys, plus ``device`` (the card's
name and power limit, as nvidia-smi gives them). The work is in
``make_texts`` and ``run_streaming_load``, which the CPU tests call at the
tiny configuration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__" and not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qwen3tts_tpu_torch.config import PipelineConfig, SamplingConfig  # noqa: E402
from qwen3tts_tpu_torch.tools.benchmark_continuous import (  # noqa: E402
    QUANT_TIERS, card_line, sync, synthetic_pipeline)

WORDS = ["hello", "there", "how", "are", "you", "today", "friend"]


def make_texts(n, rng, max_frames):
    """(budgets, texts): the JAX tool's lognormal budgets and texts of 3-8
    words, drawn from rng in its order."""
    budgets = np.clip(rng.lognormal(np.log(110), 0.45, n), 24,
                      max_frames).astype(int).tolist()
    texts = [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 9)))) + "."
             for _ in range(n)]
    return budgets, texts


def sampling(max_frames, seed=11) -> SamplingConfig:
    """The JAX tool's sampling: temperature 0.9, top-k 50, seed 11."""
    return SamplingConfig(temperature=0.9, top_k=50, max_audio_tokens=max_frames, seed=seed)


def run_streaming_load(tts, texts, budgets, params, *, lanes=64, chunk=8, kv_capacity=None,
                       stream_history=16, cadence=32, admit_per_chunk=None):
    """One synthesize_queue(on_audio=...) call over the texts. Returns
    (stats, results). Every request must succeed with exactly one finished
    call, at most its budget of frames and a first audio chunk."""
    n = len(texts)
    ttfa, done = {}, {}
    t0 = time.perf_counter()

    def on_audio(idx, chunk_audio, finished):
        t = time.perf_counter() - t0
        if idx in done:
            raise RuntimeError(f"request {idx}: audio after its finish")
        if len(chunk_audio):
            ttfa.setdefault(idx, t)
        if finished:
            done[idx] = t

    results = tts.synthesize_queue(
        texts, params, lanes=lanes, chunk_frames=chunk, kv_capacity=kv_capacity,
        on_audio=on_audio, stream_history=stream_history, stream_cadence=cadence,
        max_audio_tokens_per_request=budgets, admit_per_chunk=admit_per_chunk)
    sync(tts.device)
    wall = time.perf_counter() - t0
    bad = [i for i, r in enumerate(results)
           if not (r.success and 0 < r.n_frames <= budgets[i])]
    if bad or not (len(ttfa) == len(done) == n):
        raise RuntimeError(f"streaming load: requests {bad[:3]} failed or overran; "
                           f"{len(ttfa)} first chunks and {len(done)} finishes for {n}")
    useful = sum(r.n_frames for r in results)
    tt = np.array([ttfa[i] for i in range(n)])
    ee = np.array([done[i] for i in range(n)])
    return {"lanes": lanes, "requests": n, "chunk_frames": chunk, "cadence": cadence,
            "admit_per_chunk": admit_per_chunk or 0, "wall_s": wall,
            "useful_frames": useful, "aggregate_fps": useful / wall,
            "budget_mean": float(np.mean(budgets)),
            "requests_at_budget": sum(r.n_frames == b for r, b in zip(results, budgets)),
            "finishes": len(done),
            "ttfa_ms": {"p50": float(np.percentile(tt, 50)) * 1e3,
                        "p90": float(np.percentile(tt, 90)) * 1e3,
                        "p99": float(np.percentile(tt, 99)) * 1e3,
                        "first_admitted_min": float(tt.min()) * 1e3},
            "e2e_ms": {"p50": float(np.percentile(ee, 50)) * 1e3,
                       "p99": float(np.percentile(ee, 99)) * 1e3}}, results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=256)
    ap.add_argument("--stream-history", type=int, default=16)
    ap.add_argument("--cadence", type=int, default=32,
                    help="stream_cadence frames per steady emission (0: every chunk)")
    ap.add_argument("--kv-capacity", type=int, default=0,
                    help="the scheduler's KV capacity (0: synthesize_queue's default)")
    ap.add_argument("--admit-per-chunk", type=int, default=0,
                    help="admissions per chunk boundary (0: greedy admission)")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--quant", default="int8", choices=tuple(QUANT_TIERS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("benchmark_streaming_load: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    tts = synthetic_pipeline(PipelineConfig(), dev, args.quant)
    budgets, texts = make_texts(args.requests, np.random.default_rng(17), args.max_frames)
    for p in range(args.passes):
        st, _ = run_streaming_load(
            tts, texts, budgets, sampling(args.max_frames), lanes=args.lanes, chunk=args.chunk,
            kv_capacity=args.kv_capacity or None, stream_history=args.stream_history,
            cadence=args.cadence, admit_per_chunk=args.admit_per_chunk or None)
    print(json.dumps(dict(metric="streaming_ttfa_under_load", quant=args.quant, **st,
                          passes=args.passes, device=card_line(dev))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
