"""Continuous serving in the port against the JAX package
(tests/test_torch_continuous.py holds the scheduler's greedy cases): the
port's ContinuousScheduler and synthesize_queue beside the JAX package's
on the same queue, and the fused K5/K6 queue against fresh runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from qwen3tts_tpu.config import SamplingConfig
from qwen3tts_tpu_torch.runtime import continuous as cont
from torch_continuous_common import (  # noqa: F401 - fixtures by name
    TCFG,
    CCFG,
    H,
    UNFUSED,
    FUSED,
    jparams,
    params,
    qparams,
    _requests,
    _fresh,
    FUSED_REQS,
    _fused_scheduler,
    _jax_scheduler_codes,
    QUEUE_TEXTS,
    pipelines,
    one_torch_thread)


def test_continuous_fused_kernel_path_greedy(qparams):
    """int8 blocks through K5 (with ``start`` and its cb0 epilogue) and K6:
    C = 20 forces compaction mid-flight; spliced requests' greedy codes
    equal fresh single-stream runs of K1 and K2."""
    _, p = qparams
    sched = _fused_scheduler(p)
    rids = [sched.submit(r["tokens"], r["n_tokens"], np.zeros((H,)), TCFG.english_language_id,
                         seed=r["seed"], max_frames=r["budget"]) for r in FUSED_REQS]
    results = sched.run()
    sched.check_host_mirrors()
    assert sched.compactions >= 1
    for r, rid in zip(FUSED_REQS, rids):
        want = _fresh(p, r, temperature=0.0, top_k=0, flags=FUSED)
        np.testing.assert_array_equal(results[rid], want)


def test_fused_path_gets_the_mirrors_start_min(qparams, monkeypatch):
    """The scheduler passes K5 the host mirror's least active start as
    start_min: 0 on the first fill, above 0 once the one lane's occupant was
    spliced past row 0, and never above the lane's start (the plain K5
    raises if it were), with the overlapped loop's late harvests."""
    _, (tp, cp) = qparams
    mins = []
    real = cont.fused_talker_step_batched

    def spy(*args, **kw):
        mins.append(kw["start_min"])
        return real(*args, **kw)

    monkeypatch.setattr(cont, "fused_talker_step_batched", spy)
    sched = cont.ContinuousScheduler(
        tp, cp, TCFG, CCFG, lanes=1, kv_capacity=32, text_bucket=16, chunk_frames=2,
        refill_slots=1, max_frames=4, temperature=0.0, top_k=0, allow_eos=False, **FUSED)
    for r in FUSED_REQS[:3]:
        sched.submit(r["tokens"], r["n_tokens"], np.zeros((H,)), TCFG.english_language_id,
                     seed=r["seed"], max_frames=r["budget"])
    sched.run()
    sched.check_host_mirrors()
    assert mins[0] == 0 and max(mins) > 0


@pytest.mark.parametrize("which", ["unfused_f32", "fused_int8"])
def test_greedy_codes_match_the_jax_scheduler(jparams, params, qparams, which):
    """The same queue through the JAX ContinuousScheduler and the port's:
    greedy codes equal request for request. float32, unfused (XLA in JAX);
    int8, fused (the Pallas K5/K6 in interpret mode against the plain
    versions), C = 20 forcing compaction."""
    if which == "unfused_f32":
        reqs = _requests()
        kw = dict(lanes=2, kv_capacity=28, chunk_frames=2, refill_slots=2, max_frames=8)
        want = _jax_scheduler_codes(jparams, reqs, **kw, fused_cp=False, fused_talker=False)
        tp, cp = params
        sched = cont.ContinuousScheduler(tp, cp, TCFG, CCFG, text_bucket=16, temperature=0.0,
                                         top_k=0, repetition_penalty=1.05, allow_eos=False,
                                         **kw, **UNFUSED)
    else:
        reqs = FUSED_REQS
        kw = dict(lanes=2, kv_capacity=20, chunk_frames=2, refill_slots=2, max_frames=4)
        want = _jax_scheduler_codes(qparams[0], reqs, **kw, fused_cp=True, fused_talker=True)
        sched = _fused_scheduler(qparams[1])
    rids = [sched.submit(r["tokens"], r["n_tokens"], np.zeros((H,)), TCFG.english_language_id,
                         seed=r["seed"], max_frames=r["budget"]) for r in reqs]
    results = sched.run()
    for r, rid, w in zip(reqs, rids, want):
        assert w.shape == (r["budget"], TCFG.n_codebooks)
        np.testing.assert_array_equal(results[rid], w, err_msg=f"seed {r['seed']}")


def test_synthesize_queue_matches_jax(pipelines):
    """Greedy synthesize_queue: results in submission order, per-request
    budgets honoured, audio of n_frames * 1920 finite samples, codes equal
    to the JAX package's synthesize_queue on the same weights."""
    jt, pt = pipelines
    params = SamplingConfig(temperature=0.0, max_audio_tokens=6)
    budgets = [6, 2, 5, 3, 4]
    kw = dict(lanes=2, chunk_frames=2, refill_slots=2, max_audio_tokens_per_request=budgets)
    want = jt.synthesize_queue(QUEUE_TEXTS, params, **kw)
    got = pt.synthesize_queue(QUEUE_TEXTS, params, **kw)
    assert len(got) == len(QUEUE_TEXTS)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.success, g.error_msg
        assert g.n_frames == budgets[i] == w.n_frames
        np.testing.assert_array_equal(g.codes, np.asarray(w.codes), err_msg=f"request {i}")
        assert g.audio.shape == (g.n_frames * 1920,) and np.isfinite(g.audio).all()


def test_sampled_synthesize_queue_matches_jax(pipelines):
    """Default sampling (temperature 0.9, top-k 50, penalty 1.05), seed 30:
    synthesize_queue's codes EQUAL to the JAX package's on the same weights,
    request i drawing from prng_key(30 + i) as JAX's _host_prngkey, through
    refills on 2 lanes."""
    jt, pt = pipelines
    params = SamplingConfig(max_audio_tokens=4, seed=30)
    kw = dict(lanes=2, chunk_frames=2, refill_slots=2)
    want = jt.synthesize_queue(QUEUE_TEXTS[:4], params, **kw)
    got = pt.synthesize_queue(QUEUE_TEXTS[:4], params, **kw)
    assert sum(g.n_frames for g in got) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.n_frames == w.n_frames, f"request {i}"
        np.testing.assert_array_equal(g.codes, np.asarray(w.codes).reshape(g.codes.shape),
                                      err_msg=f"request {i}")


def test_synthesize_queue_results_in_submission_order(pipelines):
    """Each queued request equals its own synthesize run (sampled, seed
    params.seed + i): the order of results is the order of submission."""
    _, pt = pipelines
    params = SamplingConfig(max_audio_tokens=4, seed=30)
    got = pt.synthesize_queue(QUEUE_TEXTS[:3], params, lanes=2, chunk_frames=2)
    for i, g in enumerate(got):
        single = pt.synthesize(QUEUE_TEXTS[i], dataclasses.replace(params, seed=30 + i))
        assert (g.success, g.n_frames) == (single.success, single.n_frames), f"request {i}"
        np.testing.assert_array_equal(g.codes, single.codes, err_msg=f"request {i}")


def test_synthesize_queue_streaming_is_refused(pipelines):
    """Streaming is ported (tests/test_torch_streaming.py); what is refused
    now is an on_audio that cannot be called: it raises before any request
    runs, never ignored."""
    _, pt = pipelines
    with pytest.raises(TypeError, match="on_audio"):
        pt.synthesize_queue(["Hello."], SamplingConfig(max_audio_tokens=2),
                            on_audio="not a callable")
