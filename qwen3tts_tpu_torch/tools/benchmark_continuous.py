#!/usr/bin/env python3
"""Continuous-batching serving benchmark of the port (counterpart of
``tools/benchmark_continuous.py``): aggregate useful frames/s on a
variable-length request mix, against the static batched loop on the same
mix.

Static batching's cost on unequal lengths is structural: a batch runs until
its longest request finishes, so its useful occupancy is about mean/max of
the length distribution. The continuous scheduler (``runtime/continuous.py``)
refills finished lanes mid-flight and pays a small per-session drain and
per-chunk refill cost.

Lengths are per-request frame budgets (EOS is suppressed, so budgets stand
for the EOS-driven length spread of real serving): the static baseline runs
each batch to the batch's largest budget (``generate_from_tokens_batched``
with ``budgets=``, exactly that many frame-sets), and both sides are
credited only sum(budgets) useful frames.

    python3 qwen3tts_tpu_torch/tools/benchmark_continuous.py --lanes 64 \\
        --requests 192 [--capacity 1024] [--chunk 8] [--quant int8|q4|q4pure|bf16] \\
        [--static-only|--continuous-only] [--no-sorted] [--arrival-static] [--timing]

Runs on the card (CUDA device 0) on seeded synthetic weights at
``PipelineConfig()``'s widths; without a card it exits 2. Every pass but
the last is a warm pass (the kernels' build, cuBLAS handles and the
allocator's first growth land there); the last is timed. Every static
batch's keys, ``split(prng_key(batch index), lanes)``, are built before the
clock starts. Prints one JSON line: the JAX tool's keys, plus ``device``
(the card's name and power limit, as nvidia-smi gives them).

The work is in functions of (params, configs, requests, ...) that the CPU
tests call at the tiny configuration: ``make_requests``,
``run_continuous``, ``static_batches``, ``run_static``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

if __name__ == "__main__" and not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qwen3tts_tpu_torch.config import PipelineConfig  # noqa: E402
from qwen3tts_tpu_torch.ops import prng  # noqa: E402
from qwen3tts_tpu_torch.pipeline import Qwen3TTS  # noqa: E402
from qwen3tts_tpu_torch.runtime.continuous import ContinuousScheduler  # noqa: E402
from qwen3tts_tpu_torch.runtime.decode_loop import generate_from_tokens_batched  # noqa: E402

# the JAX tools' sampling: temperature 0.9, top-k 50, penalty 1.05
SAMPLED = dict(temperature=0.9, top_k=50, repetition_penalty=1.05)
# the decode flags of Qwen3TTS(): "auto" resolves per tier
AUTO = dict(fused_talker="auto", fused_cp="auto")
# the tiers --quant names; "bf16" is RuntimeConfig.quant None
QUANT_TIERS = {"int8": "int8", "q4": "q4", "q4pure": "q4pure", "bf16": None}


def make_requests(n, rng, *, tb, max_frames, token_high=2000):
    """Budgets from a clipped lognormal, a TTS-like length mix with
    mean/max ~0.55 (the static loop's structural occupancy ceiling); each
    request 10 to tb - 1 token ids in [2, token_high), seed 1000 + i. With
    the default token_high, the JAX tool's requests field for field from
    the same rng (a config with fewer text ids passes its own bound)."""
    budgets = np.clip(rng.lognormal(np.log(110), 0.45, n), 24,
                      max_frames).astype(np.int32)
    reqs = []
    for i in range(n):
        ntok = int(rng.integers(10, tb))
        tokens = rng.integers(2, token_high, size=ntok).astype(np.int32)
        reqs.append(dict(tokens=tokens, n_tokens=ntok,
                         budget=int(budgets[i]), seed=1000 + i))
    return reqs


def synthetic_pipeline(cfg, device, quant="int8") -> Qwen3TTS:
    """A Qwen3TTS on `device` with the synthetic weights of
    ``load_models(None, synthetic=True)`` in tier `quant` (a QUANT_TIERS
    name)."""
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime,
                                                              quant=QUANT_TIERS[quant]))
    tts = Qwen3TTS(cfg, device=device)
    if not tts.load_models(None, synthetic=True):
        raise RuntimeError(tts.error_msg)
    return tts


def card_line(device) -> str:
    """The card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (its first line); "cpu" for a CPU device."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def new_scheduler(tp, cp, tcfg, ccfg, *, lanes, capacity, chunk, refill_slots,
                  max_frames, text_bucket, sampling=SAMPLED, flags=AUTO, **kw):
    """The JAX tools' ContinuousScheduler (EOS suppressed) on the port."""
    return ContinuousScheduler(
        tp, cp, tcfg, ccfg, lanes=lanes, kv_capacity=capacity, text_bucket=text_bucket,
        chunk_frames=chunk, refill_slots=refill_slots, max_frames=max_frames,
        allow_eos=False, **sampling, **flags, **kw)


def submit(sched, tcfg, r) -> int:
    """Submit one make_requests request (default voice, English)."""
    return sched.submit(r["tokens"], r["n_tokens"], np.zeros((tcfg.hidden_size,), np.float32),
                        tcfg.english_language_id, seed=r["seed"], max_frames=r["budget"])


def run_continuous(tp, cp, tcfg, ccfg, reqs, *, lanes=64, capacity=1024, chunk=8,
                   refill_slots=8, max_frames=256, text_bucket=32, passes=2,
                   compact_threshold=128, compact_policy="pressure", timing=False,
                   sampling=SAMPLED, flags=AUTO):
    """Every request through one ContinuousScheduler per pass (all present
    at the start); the last pass is timed, from run() to its results on
    the host. Returns (stats, each request's codes [budget, 16] of the
    timed pass in submission order). Every request must emit exactly its
    budget."""
    useful = sum(r["budget"] for r in reqs)
    dev = tp.codec_embd.device

    def one_pass():
        sched = new_scheduler(tp, cp, tcfg, ccfg, lanes=lanes, capacity=capacity, chunk=chunk,
                              refill_slots=refill_slots, max_frames=max_frames,
                              text_bucket=text_bucket, sampling=sampling, flags=flags,
                              compact_threshold=compact_threshold,
                              compact_policy=compact_policy, timing=timing)
        rids = [submit(sched, tcfg, r) for r in reqs]
        sync(dev)
        t0 = time.perf_counter()
        results = sched.run()
        sync(dev)
        wall = time.perf_counter() - t0
        codes = [results[rid] for rid in rids]
        for r, c in zip(reqs, codes):
            if c.shape[0] != r["budget"]:
                raise RuntimeError(f"request seed {r['seed']} emitted {c.shape[0]} frames, "
                                   f"not its budget {r['budget']}")
        return wall, sched, codes

    for _ in range(passes - 1):
        one_pass()
    wall, sched, codes = one_pass()
    res = dict(wall_s=wall, useful_frames=useful, frames_per_s=useful / wall,
               chunks=sched.chunks_run, sessions=sched.sessions,
               compactions=sched.compactions, refills=sched.refills,
               occupancy=useful / (sched.chunks_run * chunk * lanes))
    if timing:
        res["phases"] = dict(sched.stats)
        # host scheduling and anything outside the four device phases
        res["phases"]["other"] = wall - sum(sched.stats.values())
        res["decode_ms_per_frame_set"] = 1e3 * sched.stats["decode_s"] / (
            sched.chunks_run * chunk)
    return res, codes


def static_batches(reqs, B, order="sorted"):
    """Static batches of B requests, each run to its largest budget (what
    EOS would do): [(largest budget, requests)].

    order="sorted": length-grouped (sorted by budget, longest first), the
    offline-oracle baseline; it needs every request's length up front,
    which online serving never has. order="arrival": consecutive
    submission-order batches, the realistic online static baseline. The
    tail batch is padded with copies of its last request (full-cost lanes,
    credited nothing)."""
    ordered = (sorted(reqs, key=lambda r: r["budget"], reverse=True)
               if order == "sorted" else list(reqs))
    out = []
    for off in range(0, len(ordered), B):
        batch = list(ordered[off:off + B])
        while len(batch) < B:
            batch.append(batch[-1])
        out.append((max(r["budget"] for r in batch), batch))
    return out


def static_capacity(max_frames) -> int:
    """A static batch's KV capacity: one request span, 256-aligned (the
    JAX tools' C_static)."""
    return -(-(10 + max_frames + 8) // 256) * 256


def static_keys(n, B) -> list:
    """The keys of static batches 0..n-1: split(prng_key(index), B), the
    JAX tools' jax.random.split(PRNGKey(index), B)."""
    return [prng.split(prng.prng_key(i), B) for i in range(n)]


def run_static_batch(tp, cp, tcfg, ccfg, batch_reqs, keys, *, lanes, text_bucket,
                     max_frames, kv_capacity, sampling=SAMPLED, flags=AUTO):
    """One static batch of `lanes` lanes: batch_reqs in lanes 0.., empty
    lanes (a prompt of one id 0, a budget of 1 frame) after them; lane g
    stops at its request's budget and the loop at the largest. Returns the
    BatchedGenerateResult (its codes on the host)."""
    B, dev = lanes, tp.codec_embd.device
    tokens = np.zeros((B, text_bucket), np.int64)
    n_tok = np.ones((B,), np.int64)
    budgets = np.ones((B,), np.int64)
    for g, r in enumerate(batch_reqs):
        tokens[g, :r["n_tokens"]] = r["tokens"]
        n_tok[g] = r["n_tokens"]
        budgets[g] = r["budget"]
    return generate_from_tokens_batched(
        tp, cp, torch.from_numpy(tokens), n_tok.tolist(),
        torch.zeros((B, tcfg.hidden_size), dtype=torch.float32, device=dev),
        [tcfg.english_language_id] * B, keys, talker_cfg=tcfg, cp_cfg=ccfg,
        max_frames=max_frames, kv_capacity=kv_capacity, allow_eos=False,
        budgets=torch.from_numpy(budgets), **sampling, **flags)


def run_static(tp, cp, tcfg, ccfg, reqs, *, lanes=64, max_frames=256, text_bucket=32,
               passes=2, order="sorted", sampling=SAMPLED, flags=AUTO):
    """Static baseline: `lanes`-lane batches (static_batches), batch bi on
    keys split(prng_key(bi), lanes), each run to its largest budget,
    credited sum(budgets) useful frames; the last pass is timed, each batch
    from its launch to its codes on the host. Returns (stats, [(batch's
    requests, codes [lanes, largest budget, 16] host)] of the timed
    pass)."""
    useful = sum(r["budget"] for r in reqs)
    batches = static_batches(reqs, lanes, order)
    C = static_capacity(max_frames)
    keys = static_keys(len(batches), lanes)

    def one_pass():
        wall, out = 0.0, []
        for bi, (mf, batch) in enumerate(batches):
            sync(tp.codec_embd.device)
            t0 = time.perf_counter()
            res = run_static_batch(tp, cp, tcfg, ccfg, batch, keys[bi], lanes=lanes,
                                   text_bucket=text_bucket, max_frames=mf, kv_capacity=C,
                                   sampling=sampling, flags=flags)
            wall += time.perf_counter() - t0
            out.append((batch, res.codes.numpy()))
        return wall, out

    for _ in range(passes - 1):
        one_pass()
    wall, out = one_pass()
    return dict(wall_s=wall, useful_frames=useful, frames_per_s=useful / wall,
                batches=len(batches), buckets=sorted({mf for mf, _ in batches})), out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--requests", type=int, default=192)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--refill-slots", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=256)
    ap.add_argument("--text-bucket", type=int, default=32)
    ap.add_argument("--passes", type=int, default=2,
                    help="the last pass is timed; earlier passes warm up")
    ap.add_argument("--compact-threshold", type=int, default=128)
    ap.add_argument("--compact-policy", default="pressure",
                    choices=("pressure", "opportunistic"))
    ap.add_argument("--timing", action="store_true",
                    help="per-phase wall decomposition (a device sync after every "
                         "phase: diagnosis, not headline)")
    ap.add_argument("--quant", default="int8", choices=tuple(QUANT_TIERS))
    ap.add_argument("--static-only", action="store_true")
    ap.add_argument("--continuous-only", action="store_true")
    ap.add_argument("--no-sorted", action="store_true",
                    help="skip the length-sorted oracle baseline")
    ap.add_argument("--arrival-static", action="store_true",
                    help="also run the arrival-order static baseline")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("benchmark_continuous: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig()
    tcfg, ccfg = cfg.talker, cfg.code_predictor
    tts = synthetic_pipeline(cfg, dev, args.quant)
    tp, cp = tts.talker_params, tts.cp_params
    reqs = make_requests(args.requests, np.random.default_rng(17), tb=args.text_bucket,
                         max_frames=args.max_frames)
    out = {"metric": "continuous_vs_static_aggregate_fps", "lanes": args.lanes,
           "requests": args.requests, "capacity": args.capacity, "chunk": args.chunk,
           "quant": args.quant,
           "budget_mean": float(np.mean([r["budget"] for r in reqs])),
           "budget_max": int(max(r["budget"] for r in reqs)),
           "device": card_line(dev)}
    shape = dict(lanes=args.lanes, max_frames=args.max_frames, text_bucket=args.text_bucket,
                 passes=args.passes)
    if not args.static_only:
        print("continuous...", file=sys.stderr)
        out["continuous"], _ = run_continuous(
            tp, cp, tcfg, ccfg, reqs, capacity=args.capacity, chunk=args.chunk,
            refill_slots=args.refill_slots, compact_threshold=args.compact_threshold,
            compact_policy=args.compact_policy, timing=args.timing, **shape)
    if not args.continuous_only:
        if not args.no_sorted:
            print("static baseline (length-sorted oracle)...", file=sys.stderr)
            out["static"], _ = run_static(tp, cp, tcfg, ccfg, reqs, **shape)
        if args.arrival_static:
            print("static baseline (arrival order)...", file=sys.stderr)
            out["static_arrival"], _ = run_static(tp, cp, tcfg, ccfg, reqs, order="arrival",
                                                  **shape)
    if "continuous" in out and "static" in out:
        out["speedup"] = out["continuous"]["frames_per_s"] / out["static"]["frames_per_s"]
    if "continuous" in out and "static_arrival" in out:
        out["speedup_vs_arrival"] = (out["continuous"]["frames_per_s"]
                                     / out["static_arrival"]["frames_per_s"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
