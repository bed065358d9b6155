"""The port's serving tools (``qwen3tts_tpu_torch/tools/benchmark_continuous.py``,
``benchmark_arrivals.py``, ``benchmark_streaming_load.py``) against the JAX
package's tools and loops at the tiny configuration, on the JAX tests'
float32 weights carried over by ``io/from_jax.py``, unfused on both sides
(the JAX package's "auto" flags give its XLA step on the CPU):
- ``make_requests`` is the JAX tool's, field for field;
- the offline continuous run's codes equal the JAX ContinuousScheduler's,
  greedy and sampled;
- the arrivals run, on a virtual clock (arrivals released at set loop
  boundaries, no sleeps), gives each request the offline run's codes, with
  one first-codes event and one finish each;
- each static batch's lanes equal JAX ``generate_from_tokens_batched`` on
  ``split(PRNGKey(batch index), lanes)`` with the same budgets;
- the streaming load's codes equal the JAX package's
  ``synthesize_queue(on_audio=...)`` on the same texts and budgets.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3tts_tpu.runtime import continuous as jcont
from qwen3tts_tpu.runtime import decode_loop as jdl
from qwen3tts_tpu_torch.tools import benchmark_arrivals as arrivals_tool
from qwen3tts_tpu_torch.tools import benchmark_continuous as bc
from qwen3tts_tpu_torch.tools import benchmark_streaming_load as stream_tool
from torch_continuous_common import (  # noqa: F401 - fixtures by name
    CCFG,
    H,
    TCFG,
    UNFUSED,
    jparams,
    one_torch_thread,
    params,
    pipelines,
)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
# the tiny config's text ids end at 500 (its special ids)
TOKEN_HIGH = 500
GREEDY = dict(temperature=0.0, top_k=0, repetition_penalty=1.05)
# requests of 3-12 frames on 2 lanes (the tool's lognormal budgets are 24
# frames and more, too long for the tiny loops): staggered finishes,
# refills, and a capacity that blocks admission (compaction, reset)
SHAPE = dict(lanes=2, max_frames=12, text_bucket=16)
SCHED = dict(capacity=40, chunk=4, refill_slots=2)
BUDGETS = (5, 9, 3, 12, 4, 8)
JAX_UNFUSED = dict(fused_cp=False, fused_talker=False)


def import_jax_tools(*names):
    """The JAX package's tools/ modules, imported as tests/test_export.py
    imports them; their import-time compile-cache settings (jax.config and
    JAX_COMPILATION_CACHE_DIR) are put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    sys.path.insert(0, TOOLS)
    try:
        return [__import__(n) for n in names]
    finally:
        sys.path.remove(TOOLS)
        for k, v in old.items():
            jax.config.update(k, v)
        if env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = env


@pytest.fixture(scope="module")
def jtool():
    (mod,) = import_jax_tools("benchmark_continuous")
    return mod


def _reqs(n=6, seed=17):
    """make_requests' prompts and seeds, with BUDGETS as budgets."""
    reqs = bc.make_requests(n, np.random.default_rng(seed), tb=SHAPE["text_bucket"],
                            max_frames=SHAPE["max_frames"], token_high=TOKEN_HIGH)
    return [dict(r, budget=b) for r, b in zip(reqs, BUDGETS)]


@pytest.mark.parametrize("seed", [0, 17, 123])
def test_make_requests_is_the_jax_tools(jtool, seed):
    """The same rng gives the JAX tool's requests field for field (values
    and dtypes), at the JAX tool's defaults."""
    want = jtool.make_requests(192, np.random.default_rng(seed), tb=32, max_frames=256)
    got = bc.make_requests(192, np.random.default_rng(seed), tb=32, max_frames=256)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        assert g["tokens"].dtype == w["tokens"].dtype
        assert (g["n_tokens"], g["budget"], g["seed"]) == (w["n_tokens"], w["budget"],
                                                           w["seed"])


def _jax_scheduler_codes(jp, reqs, sampling):
    tp, cp = jp
    sched = jcont.ContinuousScheduler(
        tp, cp, TCFG, CCFG, lanes=SHAPE["lanes"], kv_capacity=SCHED["capacity"],
        text_bucket=SHAPE["text_bucket"], chunk_frames=SCHED["chunk"],
        refill_slots=SCHED["refill_slots"], max_frames=SHAPE["max_frames"], allow_eos=False,
        **sampling, **JAX_UNFUSED)
    rids = [sched.submit(r["tokens"], r["n_tokens"], np.zeros((H,), np.float32),
                         TCFG.english_language_id, seed=r["seed"], max_frames=r["budget"])
            for r in reqs]
    results = sched.run()
    return [np.asarray(results[rid]) for rid in rids]


@pytest.fixture(scope="module")
def offline(params):
    """The port's offline continuous run (one pass) on the sampled mix."""
    tp, cp = params
    return bc.run_continuous(tp, cp, TCFG, CCFG, _reqs(), passes=1, flags=UNFUSED, **SHAPE,
                             **SCHED)


@pytest.mark.parametrize("which", ["greedy", "sampled"])
def test_continuous_codes_equal_the_jax_scheduler(jparams, params, offline, which):
    """run_continuous's per-request codes equal the JAX ContinuousScheduler's
    on the same requests and seeds; each request emits exactly its budget,
    and the stats count what ran."""
    reqs = _reqs()
    sampling = GREEDY if which == "greedy" else bc.SAMPLED
    if which == "greedy":
        tp, cp = params
        stats, codes = bc.run_continuous(tp, cp, TCFG, CCFG, reqs, passes=1, sampling=GREEDY,
                                         flags=UNFUSED, **SHAPE, **SCHED)
    else:
        stats, codes = offline
    want = _jax_scheduler_codes(jparams, reqs, sampling)
    assert len({r["budget"] for r in reqs}) > 1
    for r, g, w in zip(reqs, codes, want):
        assert g.shape == (r["budget"], TCFG.n_codebooks)
        np.testing.assert_array_equal(g, w, err_msg=f"seed {r['seed']}")
    assert stats["useful_frames"] == sum(r["budget"] for r in reqs)
    assert stats["chunks"] > 0 and stats["refills"] >= 3 and 0 < stats["occupancy"] <= 1


class BoundaryClock:
    """A virtual clock: one unit a loop boundary (tick); sleep_until jumps
    to the time asked."""

    def start(self):
        self.t = 0.0

    def now(self):
        return self.t

    def sleep_until(self, t):
        self.t = max(self.t, t)

    def tick(self):
        self.t += 1.0


# arrivals at loop boundaries: two at once, then spread, with a gap that
# leaves the server idle (the feeder's sleep)
BOUNDARIES = np.array([0.0, 0.0, 2.0, 3.0, 5.0, 40.0])


def test_arrivals_give_the_offline_codes(params, offline):
    """The arrivals run on the virtual clock: each request's codes equal
    the offline run's, and each has one first-codes event and one finish,
    the finish no earlier than its first codes."""
    tp, cp = params
    reqs = _reqs()
    stats, codes = arrivals_tool.run_continuous_arrivals(
        tp, cp, TCFG, CCFG, reqs, BOUNDARIES, clock=BoundaryClock(), flags=UNFUSED, **SHAPE,
        **SCHED)
    for r, g, w in zip(reqs, codes, offline[1]):
        np.testing.assert_array_equal(g, w, err_msg=f"seed {r['seed']}")
    assert stats["first_codes_events"] == stats["finishes"] == len(reqs)
    assert stats["useful_frames"] == sum(r["budget"] for r in reqs)
    assert stats["e2e_ms"]["p50"] >= stats["t_first_codes_ms"]["p50"] > 0
    assert stats["overlap_harvest"] and stats["sessions"] >= 0


def _jax_batch(jp, batch, seed, lanes):
    """JAX generate_from_tokens_batched on a static batch: empty lanes a
    prompt of one id 0 and a budget of 1, keys split(PRNGKey(seed), lanes)."""
    tp, cp = jp
    tokens = np.zeros((lanes, SHAPE["text_bucket"]), np.int32)
    n_tok = np.ones((lanes,), np.int32)
    budgets = np.ones((lanes,), np.int32)
    for g, r in enumerate(batch):
        tokens[g, :r["n_tokens"]] = r["tokens"]
        n_tok[g] = r["n_tokens"]
        budgets[g] = r["budget"]
    res = jdl.generate_from_tokens_batched(
        tp, cp, jnp.asarray(tokens), jnp.asarray(n_tok), jnp.zeros((lanes, H), jnp.float32),
        jnp.full((lanes,), TCFG.english_language_id, jnp.int32),
        jax.random.split(jax.random.PRNGKey(seed), lanes), talker_cfg=TCFG, cp_cfg=CCFG,
        max_frames=SHAPE["max_frames"], kv_capacity=bc.static_capacity(SHAPE["max_frames"]),
        allow_eos=False, budgets=jnp.asarray(budgets), **bc.SAMPLED, **JAX_UNFUSED)
    return np.asarray(res.codes), np.asarray(res.n_frames)


def _assert_batch(jp, batch, codes, seed, lanes):
    want, n = _jax_batch(jp, batch, seed, lanes)
    for g, r in enumerate(batch):
        assert n[g] == r["budget"]
        np.testing.assert_array_equal(codes[g, :r["budget"]], want[g, :r["budget"]],
                                      err_msg=f"batch {seed} lane {g}")


def test_static_batches_equal_jax(jparams, params):
    """run_static (length-sorted, the tail batch padded with its last
    request): each batch's lanes equal JAX generate_from_tokens_batched with
    split(PRNGKey(batch index), lanes) and the same budgets."""
    tp, cp = params
    reqs = _reqs(5)
    lanes = 3
    stats, out = bc.run_static(tp, cp, TCFG, CCFG, reqs, passes=1, flags=UNFUSED,
                               **dict(SHAPE, lanes=lanes))
    assert stats["batches"] == len(out) == 2 and len(out[1][0]) == lanes
    assert stats["useful_frames"] == sum(r["budget"] for r in reqs)
    assert [b for b, _ in bc.static_batches(reqs, lanes)] == stats["buckets"][::-1]
    for bi, (batch, codes) in enumerate(out):
        _assert_batch(jparams, batch, codes, bi, lanes)


def test_static_arrivals_batch_what_is_queued(jparams, params):
    """The online static server on the virtual clock: it batches whatever
    has arrived when the device is idle (the two first at once, then one at
    a time), every member's latency is its batch's end, and each batch's
    lanes equal JAX's with that batch's keys and budgets (empty lanes
    included)."""
    tp, cp = params
    reqs = _reqs(4)
    lanes = 3
    stats, out = arrivals_tool.run_static_arrivals(
        tp, cp, TCFG, CCFG, reqs, np.array([0.0, 0.0, 3.0, 4.0]), clock=BoundaryClock(),
        flags=UNFUSED, **dict(SHAPE, lanes=lanes))
    assert [b for b, _ in out] == [[0, 1], [2], [3]] and stats["batches"] == 3
    assert stats["t_first_codes_ms"] == stats["e2e_ms"]
    for bi, (idx, codes) in enumerate(out):
        _assert_batch(jparams, [reqs[j] for j in idx], codes, bi, lanes)


def test_streaming_load_codes_equal_jax(pipelines):
    """run_streaming_load's codes equal the JAX package's
    synthesize_queue(on_audio=...) on the same texts, budgets and sampling,
    with exactly one finish per request (the tool raises otherwise) and a
    first audio chunk for each."""
    jt, pt = pipelines
    _, texts = stream_tool.make_texts(4, np.random.default_rng(17), 12)
    budgets = [6, 11, 4, 9]
    params = stream_tool.sampling(12)
    kw = dict(lanes=2, chunk_frames=4, stream_history=4, stream_cadence=8,
              max_audio_tokens_per_request=budgets)
    finishes = []
    want = jt.synthesize_queue(texts, params, on_audio=lambda i, a, f: finishes.append(f),
                               **kw)
    stats, got = stream_tool.run_streaming_load(pt, texts, budgets, params, lanes=2, chunk=4,
                                                stream_history=4, cadence=8)
    assert stats["finishes"] == sum(finishes) == len(texts)
    assert stats["useful_frames"] == sum(r.n_frames for r in got)
    assert np.isfinite(stats["ttfa_ms"]["p99"]) and stats["e2e_ms"]["p50"] > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.n_frames == w.n_frames
        np.testing.assert_array_equal(g.codes, np.asarray(w.codes).reshape(g.codes.shape),
                                      err_msg=f"request {i}")


def test_chip_smoke_serve_load_phase_at_tiny_config(capsys, monkeypatch):
    """chip_smoke's serve_load phase at the tiny configuration on the CPU
    (the int8 pipeline's plain K5/K6, so every launch count stays 0 and only
    the launch checks are left out), on budgets of 4 frames: three
    serve_load lines; every request at its budget; on the CPU the arrivals
    run's codes equal the offline run's (on the card they are counted)."""
    import json

    import chip_smoke
    from qwen3tts_tpu_torch import tiny_pipeline_config
    import torch

    monkeypatch.setattr(chip_smoke, "check_launches", lambda *a, **k: None)
    # the tools' budgets (24 frames and more) cut to a sixth for the tiny loops
    real_requests, real_texts = bc.make_requests, stream_tool.make_texts
    monkeypatch.setattr(bc, "make_requests", lambda *a, **k: [
        dict(r, budget=r["budget"] // 6) for r in real_requests(*a, **k)])
    monkeypatch.setattr(stream_tool, "make_texts", lambda *a: (
        lambda b, t: ([x // 6 for x in b], t))(*real_texts(*a)))
    tts = chip_smoke.make_pipeline(tiny_pipeline_config(), torch.device("cpu"))
    spec = dict(offline=dict(requests=5, lanes=2, capacity=64, chunk=4, refill_slots=2,
                             max_frames=26, text_bucket=16, passes=1),
                utilization=0.7,
                stream=dict(requests=3, lanes=2, chunk=4, max_frames=26, history=4, cadence=8,
                            passes=1))
    runs = chip_smoke.serve_load(tts, "cpu", spec)
    assert len(runs) == 5 and all(set(r.values()) == {0} for r in runs)
    lines = [json.loads(l.split(" ", 1)[1]) for l in capsys.readouterr().out.splitlines()
             if l.startswith("serve_load {")]
    assert [l["what"] for l in lines] == ["continuous_vs_static", "arrivals", "streaming"]
    cont, arr, stream = lines
    assert cont["continuous"]["useful_frames"] == cont["static"]["useful_frames"]
    assert arr["codes_equal_offline"] == dict(requests=1.0, frames=1.0)
    assert arr["continuous"]["finishes"] == arr["continuous"]["first_codes_events"] == 5
    assert arr["static"]["batches"] >= 1 and arr["capacity_fps"] > 0
    assert stream["finishes"] == 3 and stream["useful_frames"] > 0


@pytest.mark.parametrize("tool", ["benchmark_continuous", "benchmark_arrivals",
                                  "benchmark_streaming_load", "check_quant_cosine",
                                  "ab_kv_int8"])
def test_tool_needs_a_card(tool, monkeypatch, capsys):
    """With no CUDA device each tool's main() exits 2 with a message and
    prints no result: it never falls back to the CPU."""
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [tool])
    assert importlib.import_module(f"qwen3tts_tpu_torch.tools.{tool}").main() == 2
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""


def test_tool_runs_as_a_script():
    """A tool runs as a script from the repository root (it puts the root
    on sys.path and imports its sibling tool through the package)."""
    import subprocess

    out = subprocess.run([sys.executable, os.path.join("qwen3tts_tpu_torch", "tools",
                                                       "benchmark_arrivals.py")],
                         cwd=os.path.dirname(TOOLS), capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2, out.stderr
    assert "no CUDA device" in out.stderr and out.stdout == ""
