#!/usr/bin/env python3
"""A/B of the int8 KV-cache tier against the bf16 cache on the port's fused
generation loops (counterpart of ``tools/ab_kv_int8.py``), on the card.

The same prompt and the same keys run twice through
``decode_loop.generate_from_tokens`` (single stream: K1, or K1 over the
int8 ``(q, scale)`` cache, with K2) or ``generate_from_tokens_batched``
(``--batch B``: K5 or K5 over the int8 cache, with K6), once per cache
(``kv_quant`` "none" and "int8"), on int8 weights. Reports each cache's
first wall and the best of 3 (from the call to the codes on the host),
frames/s, the code match rate between the two caches and the share of
frames whose 16 codes all match. Codes can rightly part after the first
near-tie draw (autoregression), so the rates are read qualitatively: a
healthy tier matches a prefix of frames exactly and keeps the frame counts
equal.

The prompt is drawn once and serves both caches (the JAX tool draws a new
prompt for each cache, so its rates compare different prompts). Keys:
``prng_key(1)``, or ``split(prng_key(1), B)`` for a batch, the JAX tool's
``PRNGKey(1)`` and ``split(PRNGKey(1), B)``. A batch of more than 64 lanes
gets a bf16 cache whatever kv_quant says (``pipeline.resolve_kv_quant``,
``INT8_KV_MAX_LANES``), so the tool refuses it with the pipeline's message
and exits 2: it would compare the bf16 cache with itself.

    python3 qwen3tts_tpu_torch/tools/ab_kv_int8.py [--frames 256] [--batch 0] [--greedy]

Runs on the card (CUDA device 0) on the seeded synthetic weights of
``Qwen3TTS.load_models`` in the int8 tier; without a card it exits 2.
Prints one JSON line, with ``device`` (the card's name and power limit, as
nvidia-smi gives them). ``ab_kv_int8`` does the work; the CPU tests call it
at the tiny configuration.
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

from qwen3tts_tpu_torch.config import PipelineConfig, RuntimeConfig  # noqa: E402
from qwen3tts_tpu_torch.ops import prng  # noqa: E402
from qwen3tts_tpu_torch.pipeline import resolve_kv_quant  # noqa: E402
from qwen3tts_tpu_torch.runtime import decode_loop  # noqa: E402
from qwen3tts_tpu_torch.tools.benchmark_continuous import (  # noqa: E402
    AUTO, card_line, synthetic_pipeline)

CACHES = ("none", "int8")


def kv_capacity(frames) -> int:
    """The JAX tool's capacity: one request span, 256-aligned."""
    return -(-(10 + frames + 8) // 256) * 256


def make_tokens(rng, batch, token_high=150000):
    """A prompt of 32 ids in [2, token_high) padded to 64, or batch such
    prompts [batch, 64] (the JAX tool's draw)."""
    if batch:
        tokens = np.zeros((batch, 64), np.int64)
        tokens[:, :32] = rng.integers(2, token_high, size=(batch, 32))
    else:
        tokens = np.zeros((64,), np.int64)
        tokens[:32] = rng.integers(2, token_high, size=32)
    return tokens


def sampling(greedy) -> dict:
    return dict(temperature=0.0 if greedy else 0.9, top_k=0 if greedy else 50,
                repetition_penalty=1.05)


def run_cache(tp, cp, tcfg, ccfg, tokens, kv_quant, *, frames, greedy=False, flags=AUTO):
    """One generation with cache kv_quant; returns (codes [(B,) frames, 16]
    and frame counts, on the host)."""
    B = tokens.shape[0] if tokens.ndim == 2 else 0
    dev = tp.codec_embd.device
    kw = dict(talker_cfg=tcfg, cp_cfg=ccfg, max_frames=frames, kv_capacity=kv_capacity(frames),
              allow_eos=False, kv_quant=kv_quant, **sampling(greedy), **flags)
    if B:
        g = decode_loop.generate_from_tokens_batched(
            tp, cp, torch.from_numpy(tokens), [32] * B,
            torch.zeros((B, tcfg.hidden_size), dtype=torch.float32, device=dev), [2050] * B,
            prng.split(prng.prng_key(1), B), **kw)
        return g.codes.numpy(), list(g.n_frames)
    g = decode_loop.generate_from_tokens(
        tp, cp, torch.from_numpy(tokens), 32,
        torch.zeros((tcfg.hidden_size,), dtype=torch.float32, device=dev), 2050,
        prng.prng_key(1), **kw)
    return g.codes.cpu().numpy(), [g.n_frames]


def ab_kv_int8(tp, cp, tcfg, ccfg, *, frames=256, batch=0, greedy=False, runs=3,
               token_high=150000, flags=AUTO):
    """Both caches on one prompt (make_tokens(np.random.default_rng(0),
    batch)) with the same keys: per cache the first wall, the best of `runs`
    walls, frames and frames/s; the code match rate and the frame-exact
    share. Returns (stats, {cache: codes}). Raises ValueError for a batch
    that the pipeline gives a bf16 cache."""
    if batch and resolve_kv_quant(RuntimeConfig(kv_quant="int8"), batched=True,
                                  lanes=batch) != "int8":
        raise ValueError(f"a batch of {batch} lanes gets the bf16 cache: the A/B would "
                         "compare the bf16 cache with itself")
    tokens = make_tokens(np.random.default_rng(0), batch, token_high)
    outs, stats = {}, {}
    for kvq in CACHES:
        walls = []
        for _ in range(1 + runs):
            t0 = time.perf_counter()
            codes, n_frames = run_cache(tp, cp, tcfg, ccfg, tokens, kvq, frames=frames,
                                        greedy=greedy, flags=flags)
            walls.append(time.perf_counter() - t0)
        best = min(walls[1:])
        total = int(sum(n_frames))
        stats[kvq] = dict(first_wall_s=walls[0], best_wall_s=best, frames=total,
                          frames_per_s=total / best)
        outs[kvq] = codes
    a, b = outs["none"], outs["int8"]
    fa, fb = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return dict(frames=frames, batch=batch, greedy=greedy, **stats,
                code_match_rate=float((a == b).mean()),
                frame_exact_share=float((fa == fb).all(axis=1).mean())), outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--batch", type=int, default=0, help="0: single stream; B > 0: B lanes")
    ap.add_argument("--greedy", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kv_int8: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.batch and resolve_kv_quant(RuntimeConfig(kv_quant="int8"), batched=True,
                                       lanes=args.batch) != "int8":
        print(f"ab_kv_int8: --batch {args.batch} gets the bf16 cache; nothing to compare",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig()
    tts = synthetic_pipeline(cfg, dev, "int8")
    st, _ = ab_kv_int8(tts.talker_params, tts.cp_params, cfg.talker, cfg.code_predictor,
                       frames=args.frames, batch=args.batch, greedy=args.greedy)
    print(json.dumps(dict(metric="kv_int8_ab", **st, device=card_line(dev))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
