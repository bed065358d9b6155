#!/usr/bin/env python3
"""Online arrival-process serving benchmark of the port (counterpart of
``tools/benchmark_arrivals.py``): Poisson arrivals, latency first.

The offline A/B (``benchmark_continuous.py``) understates continuous
batching: with every request present at t = 0, static batching only pays
its occupancy tax. Under arrivals the static server also makes requests
wait for the next batch boundary and holds every batch member until the
batch's longest request drains. This tool drives the same Poisson trace
through both servers and reports per-request first-codes and end-to-end
latency percentiles (codes level; the streaming-audio analog is
``benchmark_streaming_load.py``):

  continuous:  ContinuousScheduler.run(feeder=...): requests admitted
               mid-flight as they arrive; t_first = the harvest of the
               request's first codes (the overlapped loop harvests chunk
               N-1 while chunk N runs), e2e = its last chunk's harvest.
  static:      an online batch server: whenever the device is idle, batch
               everything queued (<= lanes) and run it to the batch's
               largest budget (``generate_from_tokens_batched`` with
               ``budgets=``); every member's codes land at batch end, so
               t_first == e2e.

Latencies are host time, read at the harvest (which waits for the chunk's
copy) or after the batch's codes reach the host. The feeder sleeps until
the next arrival only when nothing runs. Every static batch's keys,
``split(prng_key(batch index), lanes)``, are built before the clock
starts.

Arrival rate: --rate req/s, or rate = utilization * capacity / mean budget,
with the capacity (frames/s) from --capacity-fps; given neither, the
capacity is measured first on the card: ``benchmark_continuous``'s
continuous side on the same mix, printed as ``capacity_fps``.

    python3 qwen3tts_tpu_torch/tools/benchmark_arrivals.py --lanes 64 \\
        --requests 192 [--utilization 0.7] [--capacity-fps F | --rate R] \\
        [--quant int8|q4|q4pure|bf16] [--continuous-only|--static-only]

Runs on the card (CUDA device 0) on seeded synthetic weights at
``PipelineConfig()``'s widths; without a card it exits 2. A warm pass
(every request of the first 2 * lanes at t = 0; one static batch) runs
before the timed ones. Prints one JSON line: the JAX tool's keys, plus
``device`` (the card's name and power limit, as nvidia-smi gives them).
The work is in ``arrival_times``, ``run_continuous_arrivals`` and
``run_static_arrivals``, which take a clock: ``WallClock`` here, a virtual
one in the CPU tests.
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

from qwen3tts_tpu_torch.config import PipelineConfig  # noqa: E402
from qwen3tts_tpu_torch.tools.benchmark_continuous import (  # noqa: E402
    AUTO, QUANT_TIERS, SAMPLED, card_line, make_requests, new_scheduler, run_continuous,
    run_static_batch, static_capacity, static_keys, submit, sync, synthetic_pipeline)


class WallClock:
    """Seconds on the host clock since start(); sleep_until blocks."""

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)

    def tick(self) -> None:
        """A loop boundary (a virtual clock advances here)."""


def pcts(xs) -> dict:
    """p50, p90, p99 and mean of seconds, in ms."""
    a = np.asarray(sorted(xs), np.float64) * 1e3
    return {"p50": float(np.percentile(a, 50)), "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)), "mean": float(a.mean())}


def arrival_times(rng, rate, n) -> np.ndarray:
    """Poisson arrivals at `rate` req/s from rng (drawn after the
    requests, as the JAX tool draws them); the clock starts at the first."""
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    arrivals[0] = 0.0
    return arrivals


def run_continuous_arrivals(tp, cp, tcfg, ccfg, reqs, arrivals, *, lanes=64, capacity=1024,
                            chunk=32, refill_slots=8, max_frames=256, text_bucket=32,
                            clock=None, sampling=SAMPLED, flags=AUTO):
    """The trace through ContinuousScheduler.run(feeder=...). Returns
    (stats, each request's codes in request order). Every request must
    emit exactly its budget, with one first-codes event and one finish."""
    clock = clock or WallClock()
    n = len(reqs)
    sched = new_scheduler(tp, cp, tcfg, ccfg, lanes=lanes, capacity=capacity, chunk=chunk,
                          refill_slots=refill_slots, max_frames=max_frames,
                          text_bucket=text_bucket, sampling=sampling, flags=flags)
    rid_to_idx, first, done = {}, {}, {}
    state = {"next": 0}

    def feeder(idle):
        clock.tick()
        now = clock.now()
        nxt = state["next"]
        if idle and nxt < n and arrivals[nxt] > now:
            clock.sleep_until(arrivals[nxt])
            now = clock.now()
        while state["next"] < n and arrivals[state["next"]] <= now:
            i = state["next"]
            rid_to_idx[submit(sched, tcfg, reqs[i])] = i
            state["next"] += 1
        return state["next"] < n

    def on_chunk(events):
        now = clock.now()
        for rid, rows, finished in events:
            i = rid_to_idx[rid]
            if i in done:
                raise RuntimeError(f"request {i}: an event after its finish")
            if rows.size and i not in first:
                first[i] = now - arrivals[i]
            if finished:
                done[i] = now - arrivals[i]

    sync(tp.codec_embd.device)
    clock.start()
    results = sched.run(on_chunk=on_chunk, feeder=feeder)
    wall = clock.now()
    codes = [None] * n
    for rid, i in rid_to_idx.items():
        codes[i] = results[rid]
    useful = sum(c.shape[0] for c in codes)
    if useful != sum(r["budget"] for r in reqs) or not (len(first) == len(done) == n):
        raise RuntimeError(f"continuous arrivals: {useful} frames, {len(first)} first-codes "
                           f"events and {len(done)} finishes for {n} requests")
    return {"wall_s": wall, "useful_frames": useful, "frames_per_s": useful / wall,
            "t_first_codes_ms": pcts(first.values()), "e2e_ms": pcts(done.values()),
            "chunks": sched.chunks_run, "sessions": sched.sessions,
            "overlap_harvest": sched.overlap_harvest, "first_codes_events": len(first),
            "finishes": len(done)}, codes


def run_static_arrivals(tp, cp, tcfg, ccfg, reqs, arrivals, *, lanes=64, max_frames=256,
                        text_bucket=32, clock=None, sampling=SAMPLED, flags=AUTO):
    """The online static batch server on the same trace: whenever the
    device is idle, batch whatever is queued (<= lanes), batch b on keys
    split(prng_key(b), lanes), run it to its largest budget; everyone's
    codes land at batch end. Returns (stats, [(request indices, codes
    [lanes, largest budget, 16] host)] per batch)."""
    clock = clock or WallClock()
    n = len(reqs)
    C = static_capacity(max_frames)
    keys = static_keys(n, lanes)
    lat, out = {}, []
    sync(tp.codec_embd.device)
    clock.start()
    i = 0
    while i < n:
        clock.tick()
        now = clock.now()
        if arrivals[i] > now:
            clock.sleep_until(arrivals[i])
            now = clock.now()
            if arrivals[i] > now:
                continue
        batch = []
        while i < n and arrivals[i] <= now and len(batch) < lanes:
            batch.append(i)
            i += 1
        res = run_static_batch(tp, cp, tcfg, ccfg, [reqs[j] for j in batch], keys[len(out)],
                               lanes=lanes, text_bucket=text_bucket,
                               max_frames=max(reqs[j]["budget"] for j in batch),
                               kv_capacity=C, sampling=sampling, flags=flags)
        end = clock.now()
        out.append((batch, res.codes.numpy()))
        for j in batch:
            lat[j] = end - arrivals[j]
    wall = clock.now()
    useful = sum(r["budget"] for r in reqs)
    return {"wall_s": wall, "useful_frames": useful, "frames_per_s": useful / wall,
            "t_first_codes_ms": pcts(lat.values()),     # == e2e: batch end
            "e2e_ms": pcts(lat.values()), "batches": len(out)}, out


def speedups(out) -> None:
    """The two p50 speedups of continuous over static, into out."""
    c, s = out["continuous"], out["static"]
    out["e2e_p50_speedup"] = s["e2e_ms"]["p50"] / max(c["e2e_ms"]["p50"], 1e-9)
    out["first_codes_p50_speedup"] = (s["t_first_codes_ms"]["p50"]
                                      / max(c["t_first_codes_ms"]["p50"], 1e-9))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--requests", type=int, default=192)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--refill-slots", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=256)
    ap.add_argument("--text-bucket", type=int, default=32)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate, req/s (0: utilization * capacity / mean "
                         "budget)")
    ap.add_argument("--utilization", type=float, default=0.7)
    ap.add_argument("--capacity-fps", type=float, default=0.0,
                    help="the server's frames/s; 0: measured first on this card "
                         "(benchmark_continuous's continuous side on the same mix)")
    ap.add_argument("--seed", type=int, default=17, help="the requests' and arrivals' rng")
    ap.add_argument("--quant", default="int8", choices=tuple(QUANT_TIERS))
    ap.add_argument("--static-only", action="store_true")
    ap.add_argument("--continuous-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("benchmark_arrivals: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig()
    tcfg, ccfg = cfg.talker, cfg.code_predictor
    tts = synthetic_pipeline(cfg, dev, args.quant)
    tp, cp = tts.talker_params, tts.cp_params
    rng = np.random.default_rng(args.seed)
    reqs = make_requests(args.requests, rng, tb=args.text_bucket, max_frames=args.max_frames)
    mean_budget = float(np.mean([r["budget"] for r in reqs]))
    shape = dict(lanes=args.lanes, max_frames=args.max_frames, text_bucket=args.text_bucket)
    sched_kw = dict(capacity=args.capacity, chunk=args.chunk, refill_slots=args.refill_slots)
    out = {"metric": "poisson_arrival_latency", "lanes": args.lanes,
           "requests": args.requests, "chunk": args.chunk, "quant": args.quant,
           "device": card_line(dev)}
    capacity = args.capacity_fps
    if not args.rate and not capacity:
        print("capacity (continuous, offline, on this card)...", file=sys.stderr)
        capacity = run_continuous(tp, cp, tcfg, ccfg, reqs, **shape, **sched_kw)[0][
            "frames_per_s"]
        out["capacity_fps_measured"] = capacity
        print(f"capacity: {capacity} frames/s", file=sys.stderr)
    rate = args.rate or (args.utilization * capacity / mean_budget)
    arrivals = arrival_times(rng, rate, args.requests)
    out.update({"rate_req_s": rate, "offered_load_fps": rate * mean_budget,
                "budget_mean": mean_budget, "trace_span_s": float(arrivals[-1])})
    warm_n = min(args.requests, 2 * args.lanes)
    if not args.static_only:
        print("warm continuous...", file=sys.stderr)
        run_continuous_arrivals(tp, cp, tcfg, ccfg, reqs[:warm_n], np.zeros(warm_n),
                                **shape, **sched_kw)
        print("continuous (timed)...", file=sys.stderr)
        out["continuous"], _ = run_continuous_arrivals(tp, cp, tcfg, ccfg, reqs, arrivals,
                                                       **shape, **sched_kw)
    if not args.continuous_only:
        print("warm static...", file=sys.stderr)
        run_static_arrivals(tp, cp, tcfg, ccfg, reqs[:args.lanes], np.zeros(args.lanes),
                            **shape)
        print("static (timed)...", file=sys.stderr)
        out["static"], _ = run_static_arrivals(tp, cp, tcfg, ccfg, reqs, arrivals, **shape)
    if "continuous" in out and "static" in out:
        speedups(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
