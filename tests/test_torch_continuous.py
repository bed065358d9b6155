"""Continuous serving in the port (runtime/continuous.py): the counterparts
of tests/test_continuous.py, with fresh runs of the port's own loops as the
reference, and the port's scheduler and synthesize_queue against the JAX
package's on the same queue.

The invariant: a request spliced into a lane mid-session at cache rows
[p - P, p) generates exactly what a fresh single-stream run at [0, P)
generates (RoPE is relative, the start mask hides the previous occupant).
Greedy codes are the gate; sampled runs match too, because each request
draws from its own threefry key chain (prng_key(seed)) in the
single-stream loop's order, as the JAX scheduler's requests do.
The float32 queues run the unfused path, as the JAX package's scheduler
does on a CPU; the int8 queue runs K5 and K6 (plain versions here, the
Pallas kernels in interpret mode in JAX).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu import pipeline as jpipeline
from qwen3tts_tpu.config import SamplingConfig, tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu.runtime import continuous as jcont
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops import prng
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.runtime import continuous as cont
from qwen3tts_tpu_torch.runtime import decode_loop as pdl

CFG = tiny_pipeline_config()
TCFG, CCFG = CFG.talker, CFG.code_predictor
H = TCFG.hidden_size
UNFUSED = dict(fused_talker=False, fused_cp=False)
FUSED = dict(fused_talker=True, fused_cp=True)


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def jparams():
    tp = jtalker.init_talker_params(jax.random.PRNGKey(21), TCFG, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(22), CCFG, jnp.float32)
    return tp, cp


@pytest.fixture(scope="module")
def params(jparams):
    """The JAX tests' float32 weights in the port."""
    tp, cp = jparams
    return params_from_jax(_to_np(tp)), params_from_jax(_to_np(cp))


@pytest.fixture(scope="module")
def qparams(jparams):
    """The same weights with int8 blocks, in both packages."""
    tp, cp = jparams
    tpq = tp._replace(blocks=quantize_block_params(tp.blocks))
    cpq = cp._replace(blocks=quantize_block_params(cp.blocks))
    return (tpq, cpq), (params_from_jax(_to_np(tpq)), params_from_jax(_to_np(cpq)))


def _requests():
    """Unequal prompts and frame budgets: staggered finishes force
    mid-session refills at several splice points."""
    reqs = []
    for i, (ntok, budget) in enumerate([(11, 4), (12, 6), (10, 3), (13, 5), (11, 2), (12, 4)]):
        tokens = (np.arange(ntok, dtype=np.int64) * (i + 3)) % 50 + 2
        reqs.append(dict(tokens=tokens, n_tokens=ntok, budget=budget, seed=100 + i))
    return reqs


def _fresh(p, req, *, temperature, top_k, top_p=1.0, repetition_penalty=1.05, flags=UNFUSED,
           Tb=16):
    """The port's single-stream loop on one request, from the key
    prng_key(seed) of the request's seed."""
    tp, cp = p
    padded = np.zeros((Tb,), np.int64)
    padded[:req["n_tokens"]] = req["tokens"]
    res = pdl.generate_from_tokens(
        tp, cp, torch.from_numpy(padded), req["n_tokens"], torch.zeros((H,)),
        TCFG.english_language_id, prng.prng_key(req["seed"]),
        talker_cfg=TCFG, cp_cfg=CCFG, max_frames=req["budget"],
        kv_capacity=10 + req["budget"] + 8, temperature=temperature, top_k=top_k,
        top_p=top_p, repetition_penalty=repetition_penalty, allow_eos=False, **flags)
    return res.codes.numpy()


def _scheduler(p, *, temperature, top_k, lanes=2, kv_capacity=28, chunk_frames=2,
               refill_slots=2, flags=UNFUSED, **kw):
    tp, cp = p
    return cont.ContinuousScheduler(
        tp, cp, TCFG, CCFG, lanes=lanes, kv_capacity=kv_capacity, text_bucket=16,
        chunk_frames=chunk_frames, refill_slots=refill_slots, max_frames=8,
        temperature=temperature, top_k=top_k, repetition_penalty=1.05, allow_eos=False,
        **flags, **kw)


def _run_continuous(p, reqs, **kw):
    sched = _scheduler(p, **kw)
    rids = [sched.submit(r["tokens"], r["n_tokens"], np.zeros((H,)), TCFG.english_language_id,
                         seed=r["seed"], max_frames=r["budget"]) for r in reqs]
    results = sched.run()
    sched.check_host_mirrors()   # host n_past/start/done == the state
    return sched, [results[rid] for rid in rids]


def _assert_fresh(p, reqs, got, **kw):
    for r, codes in zip(reqs, got):
        want = _fresh(p, r, **kw)
        assert codes.shape == want.shape == (r["budget"], TCFG.n_codebooks)
        np.testing.assert_array_equal(codes, want, err_msg=f"seed {r['seed']}")


def test_continuous_greedy_matches_fresh_runs(params):
    """Every request through the 2-lane scheduler (staggered refills, a
    capacity tight enough for a session reset or a compaction) emits exactly
    the codes of a fresh single-stream greedy run."""
    reqs = _requests()
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0)
    assert sched.sessions + sched.compactions >= 1
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_compaction_is_exact(params):
    """Rolling compaction (roll and K re-rotation by -shift) mid-request
    changes no request's codes."""
    reqs = _requests() + [dict(r, seed=r["seed"] + 50) for r in _requests()]
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, kv_capacity=32)
    assert sched.compactions >= 1
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_opportunistic_compaction_is_exact(params):
    """compact_policy="opportunistic" with a threshold far below a roomy
    capacity: compactions fire in the normal refill loop (never a reset),
    and every request still matches its fresh run."""
    reqs = _requests()
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, kv_capacity=64,
                                 compact_threshold=4, compact_policy="opportunistic")
    assert sched.compactions >= 1 and sched.sessions == 0
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_pressure_policy_never_compacts_when_roomy(params):
    reqs = _requests()
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, kv_capacity=64,
                                 compact_threshold=4)
    assert sched.compactions == 0 and sched.sessions == 0
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_bulk_refill_is_exact(params):
    """4 idle lanes, 6 queued, R = 1: the first boundary fills every lane in
    one refill (one prefill of 4 windows); every request still matches."""
    reqs = _requests()
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, lanes=4,
                                 refill_slots=1, kv_capacity=48)
    assert sched.refills < len(reqs)
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_admission_pacing_and_timing_change_no_codes(params):
    """admit_per_boundary=1 admits one request per chunk boundary (more
    refills than the unpaced run); timing=True sums each phase's wall into
    stats. Neither changes a request's codes."""
    reqs = _requests()
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, lanes=4,
                                 kv_capacity=48, admit_per_boundary=1, timing=True)
    assert sched.refills == len(reqs)
    assert sched.stats["decode_s"] > 0 and sched.stats["refill_s"] > 0
    _assert_fresh(params, reqs, got, temperature=0.0, top_k=0)


def test_continuous_sampled_matches_fresh_runs(params):
    """Sampled: each request's key chain (split at refill, then per frame)
    reproduces the single-stream sampled output."""
    reqs = _requests()[:4]
    _, got = _run_continuous(params, reqs, temperature=0.9, top_k=50)
    _assert_fresh(params, reqs, got, temperature=0.9, top_k=50)


def test_refill_masks_previous_occupant(params):
    """One lane, the same request twice: the second occupant, spliced at
    p > 10, must not see the first one's cache."""
    req = _requests()[0]
    _, got = _run_continuous(params, [req, dict(req)], temperature=0.0, top_k=0, lanes=1,
                             refill_slots=1)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], _fresh(params, req, temperature=0.0, top_k=0))


def test_budget_and_emit_accounting(params):
    """Emissions per request == its budget (allow_eos=False), codes in range;
    every chunk advances n_past by chunk_frames."""
    reqs = _requests()[:3]
    sched, got = _run_continuous(params, reqs, temperature=0.0, top_k=0, kv_capacity=64)
    for r, codes in zip(reqs, got):
        assert codes.shape[0] == r["budget"]
        assert (codes >= 0).all() and (codes[:, 0] < TCFG.codec_vocab_size).all()
        assert (codes[:, 1:] < CCFG.vocab_size).all()
    assert sched.state.n_past == cont.prefill_window_len(False) + 2 * sched.chunks_run


def test_per_request_sampling_params(params):
    """Each request carries its own temperature, top-p and penalty: results
    equal fresh runs with those values, in one scheduler; a request outside
    the server's sampling class is refused."""
    overrides = [dict(temperature=0.7, repetition_penalty=1.0),
                 dict(temperature=1.3, repetition_penalty=1.3),
                 dict(temperature=0.9, top_p=0.8), dict()]
    reqs = _requests()[:4]
    sched = _scheduler(params, temperature=0.9, top_k=50, top_p=0.95)
    rids = [sched.submit(r["tokens"], r["n_tokens"], np.zeros((H,)), TCFG.english_language_id,
                         seed=r["seed"], max_frames=r["budget"], **ov)
            for r, ov in zip(reqs, overrides)]
    results = sched.run()
    for r, ov, rid in zip(reqs, overrides, rids):
        want = _fresh(params, r, temperature=ov.get("temperature", 0.9), top_k=50,
                      top_p=ov.get("top_p", 0.95),
                      repetition_penalty=ov.get("repetition_penalty", 1.05))
        np.testing.assert_array_equal(results[rid], want)
    with pytest.raises(ValueError, match="greedy"):
        sched.submit(reqs[0]["tokens"], reqs[0]["n_tokens"], np.zeros((H,)),
                     TCFG.english_language_id, temperature=0.0)
    greedy = _scheduler(params, temperature=0.0, top_k=0)
    with pytest.raises(ValueError, match="top-p"):
        _scheduler(params, temperature=0.9, top_k=0).submit(
            reqs[0]["tokens"], reqs[0]["n_tokens"], np.zeros((H,)), 0, top_p=0.5)
    with pytest.raises(ValueError, match="text bucket"):
        greedy.submit(np.arange(17), 17, np.zeros((H,)), 0)


# int8 requests whose greedy codes meet no near-tie between the two
# packages' float sums (the JAX test's queue)
FUSED_REQS = [dict(tokens=np.arange(11) + 2, n_tokens=11, budget=2, seed=7),
              dict(tokens=(np.arange(12) * 5) % 40 + 2, n_tokens=12, budget=3, seed=8),
              dict(tokens=np.arange(10) + 4, n_tokens=10, budget=2, seed=9),
              dict(tokens=(np.arange(13) * 3) % 30 + 2, n_tokens=13, budget=4, seed=10),
              dict(tokens=np.arange(12) + 6, n_tokens=12, budget=2, seed=11),
              dict(tokens=np.arange(11) + 8, n_tokens=11, budget=3, seed=12),
              dict(tokens=(np.arange(10) * 7) % 25 + 2, n_tokens=10, budget=4, seed=13),
              dict(tokens=np.arange(12) + 3, n_tokens=12, budget=2, seed=14)]


def _fused_scheduler(p):
    tp, cp = p
    return cont.ContinuousScheduler(
        tp, cp, TCFG, CCFG, lanes=2, kv_capacity=20, text_bucket=16, chunk_frames=2,
        refill_slots=2, max_frames=4, temperature=0.0, top_k=0, repetition_penalty=1.05,
        allow_eos=False, **FUSED)


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


def _jax_scheduler_codes(jp, reqs, **kw):
    tp, cp = jp
    sched = jcont.ContinuousScheduler(
        tp, cp, TCFG, CCFG, text_bucket=16, temperature=0.0, top_k=0,
        repetition_penalty=1.05, allow_eos=False, **kw)
    rids = [sched.submit(np.asarray(r["tokens"], np.int32), r["n_tokens"], np.zeros((H,)),
                         TCFG.english_language_id, seed=r["seed"], max_frames=r["budget"])
            for r in reqs]
    results = sched.run()
    return [np.asarray(results[rid]) for rid in rids]


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


def test_state_shapes_and_reset(params):
    st = cont.init_state(params[0], TCFG, lanes=4, kv_capacity=32, trailing_len=13)
    assert st.kv.shape == (4, TCFG.n_layers, 2, TCFG.n_kv_heads, 32, TCFG.head_dim)
    assert bool(st.done.all())
    assert st.n_past == cont.prefill_window_len(False) == 10
    assert cont.prefill_window_len(True) == 9


def test_feeder_online_arrivals_match_fresh_runs(params):
    """run(feeder=...) submits requests mid-run (keyed to chunks_run, so the
    test is deterministic); the loop idles on an empty queue while arrivals
    are pending, and every request emits its fresh-run codes."""
    reqs = _requests()
    sched = _scheduler(params, temperature=0.0, top_k=0)
    rids = {}
    release_at = [0, 0, 1, 3, 6, 9]
    state = {"next": 0}

    def feeder(idle):
        if idle and state["next"] < len(reqs):
            release_at[state["next"]] = sched.chunks_run   # jump the clock
        while state["next"] < len(reqs) and release_at[state["next"]] <= sched.chunks_run:
            r = reqs[state["next"]]
            rids[state["next"]] = sched.submit(r["tokens"], r["n_tokens"], np.zeros((H,)),
                                               TCFG.english_language_id, seed=r["seed"],
                                               max_frames=r["budget"])
            state["next"] += 1
        return state["next"] < len(reqs)

    results = sched.run(feeder=feeder)
    sched.check_host_mirrors()
    assert state["next"] == len(reqs)
    _assert_fresh(params, reqs, [results[rids[i]] for i in range(len(reqs))],
                  temperature=0.0, top_k=0)


@pytest.mark.parametrize("temperature, top_k", [(0.0, 0), (0.9, 5)])
def test_overlap_harvest_matches_serial(params, temperature, top_k):
    """The overlapped loop (one chunk in flight, refills one chunk late)
    gives the serial loop's per-request codes, and host mirrors equal the
    state after the drain."""
    reqs = _requests()
    outs = {}
    for overlap in (False, True):
        sched, got = _run_continuous(params, reqs, temperature=temperature, top_k=top_k,
                                     overlap_harvest=overlap)
        assert sched.overlap_harvest is overlap
        outs[overlap] = got
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)


# synthesize_queue against the JAX package's on the same weights
QUEUE_TEXTS = ["Hello there, port.", "Two lanes here.", "A third, somewhat longer request.",
               "Four.", "And a fifth one."]


@pytest.fixture(scope="module")
def pipelines():
    cfg = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, quant=None))
    jt = jpipeline.Qwen3TTS(cfg)
    assert jt.load_models(None, synthetic=True)
    pt = Qwen3TTS(cfg, device="cpu", **UNFUSED)
    pt.set_params(params_from_jax(_to_np(jt.talker_params)),
                  params_from_jax(_to_np(jt.cp_params)),
                  params_from_jax(_to_np(jt.vocoder_params)))
    return jt, pt


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
