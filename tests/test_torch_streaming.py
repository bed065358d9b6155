"""Streaming in the port at the tiny configuration: the chunked frame loop
(``decode_loop.generate_init`` / ``generate_chunk`` / ``generate_start``),
``runtime/e2e.start_and_vocode``, ``Qwen3TTS.synthesize_streaming`` and
``synthesize_queue(on_audio=...)``, against the JAX package's on the same
weights and against the port's own whole-request loop.

The JAX pipeline on the CPU resolves its "auto" decode flags to the XLA
step, so the pipelines compared run float32 weights on the unfused path;
the port's fused kernels (plain versions) are held against its own
``generate_from_tokens``. Streamed audio is held within 2e-3, the tolerance
of the JAX package's own streaming test (``tests/test_pipeline.py``): the
windows' valid samples are the same, summed in another order (the JAX
package pads each window to a bucket and masks the padding)."""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu import pipeline as jpipeline
from qwen3tts_tpu.config import SamplingConfig, tiny_pipeline_config
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu.runtime import decode_loop as jdl
from qwen3tts_tpu.runtime import e2e as je2e
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops import prng
from qwen3tts_tpu_torch.ops.kv_quant import is_quantized_kv
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.runtime import decode_loop as pdl
from qwen3tts_tpu_torch.runtime import e2e as pe2e

BASE = tiny_pipeline_config()
CFG = dataclasses.replace(BASE, runtime=dataclasses.replace(BASE.runtime, quant=None))
TCFG, CCFG, VCFG = CFG.talker, CFG.code_predictor, CFG.vocoder
SPF = VCFG.samples_per_frame
UNFUSED = dict(fused_talker=False, fused_cp=False)
FUSED = dict(fused_talker=True, fused_cp=True)
TEXTS = ["Hello there, port.", "Two lanes here.", "A third, somewhat longer request.",
         "Four.", "And a fifth one."]
# the vocoder's tolerance against JAX (tests/test_torch_vocoder.py)
RTOL, ATOL = 5e-3, 5e-4
# the JAX package's streaming tolerance (tests/test_pipeline.py:292-303)
S_RTOL, S_ATOL = 1e-3, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module's tiny products: several test
    workers share the machine's cores, and a thread pool's barriers then
    wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def pipelines():
    """The JAX pipeline on synthetic float32 weights and the port's, unfused,
    on the same weights."""
    jt = jpipeline.Qwen3TTS(CFG)
    assert jt.load_models(None, synthetic=True)
    pt = Qwen3TTS(CFG, device="cpu", **UNFUSED)
    pt.set_params(params_from_jax(_to_np(jt.talker_params)),
                  params_from_jax(_to_np(jt.cp_params)),
                  params_from_jax(_to_np(jt.vocoder_params)))
    return jt, pt


@pytest.fixture(scope="module")
def int8_port(pipelines):
    """The port on the same weights with int8 blocks (the fused kernels'
    plain versions)."""
    jt, _ = pipelines
    tp = jt.talker_params._replace(blocks=quantize_block_params(jt.talker_params.blocks))
    cp = jt.cp_params._replace(blocks=quantize_block_params(jt.cp_params.blocks))
    cfg = dataclasses.replace(BASE, runtime=dataclasses.replace(BASE.runtime, quant="int8"))
    pt = Qwen3TTS(cfg, device="cpu")
    pt.set_params(params_from_jax(_to_np(tp)), params_from_jax(_to_np(cp)),
                  params_from_jax(_to_np(jt.vocoder_params)))
    return pt


def _prompt(tts, text):
    padded, n = tts._fit_tokens(tts.tokenizer.encode_for_tts(text))
    return padded, n


GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=1.05)


def test_chunked_loop_matches_jax_chunks(pipelines):
    """generate_init, then generate_chunk in chunks of 3: after each chunk
    the frame count, the done flag and the greedy codes equal JAX's
    generate_init / generate_chunk on the same weights (XLA step)."""
    jt, pt = pipelines
    padded, n = _prompt(pt, TEXTS[0])
    max_frames, kv_capacity = 10, 32
    js, jpre = jdl.generate_init(
        jt.talker_params, jt.cp_params, jnp.asarray(padded, jnp.int32), jnp.int32(n),
        jnp.zeros((TCFG.hidden_size,), jnp.float32), jnp.int32(TCFG.english_language_id),
        jax.random.PRNGKey(0), talker_cfg=TCFG, cp_cfg=CCFG, max_frames=max_frames,
        kv_capacity=kv_capacity, fused_talker=False, greedy=True, use_top_p=False, **GREEDY)
    ps, ppre = pdl.generate_init(
        pt.talker_params, pt.cp_params, torch.from_numpy(padded), n,
        torch.zeros((TCFG.hidden_size,)), TCFG.english_language_id,
        prng.prng_key(0), talker_cfg=TCFG, cp_cfg=CCFG,
        max_frames=max_frames, kv_capacity=kv_capacity, fused_talker=False, **GREEDY)
    assert (ps.frame, ps.n_past, ps.done) == (0, 10, False)
    chunks = 0
    while True:
        js = jdl.generate_chunk(jt.talker_params, jt.cp_params, jpre, js, talker_cfg=TCFG,
                                cp_cfg=CCFG, chunk_frames=3, max_frames=max_frames,
                                fused_cp=False, fused_talker=False, **GREEDY)
        pdl.generate_chunk(pt.talker_params, pt.cp_params, ppre, ps, talker_cfg=TCFG,
                           cp_cfg=CCFG, chunk_frames=3, max_frames=max_frames, **GREEDY,
                           **UNFUSED)
        chunks += 1
        assert (ps.frame, ps.done) == (int(js.frame), bool(js.done)), f"chunk {chunks}"
        np.testing.assert_array_equal(ps.codes[:ps.frame].numpy(),
                                      np.asarray(js.codes)[:ps.frame])
        if ps.done or ps.frame >= max_frames:
            break
    assert ps.frame > 3 and chunks >= 2


@pytest.mark.parametrize("which, temperature, kv_quant", [
    ("fused", 0.0, "none"), ("fused", 0.9, "none"), ("unfused", 0.0, "none"),
    ("unfused", 0.9, "none"), ("fused", 0.9, "int8")])
def test_chunked_loop_equals_generate_from_tokens(pipelines, int8_port, which, temperature,
                                                  kv_quant):
    """The port's loop in chunks of 3 gives the codes and hidden rows of its
    own generate_from_tokens (one chunk of max_frames) with the same seed:
    greedy and sampled, fused (K1/K2 plain versions, int8 blocks) and
    unfused, and over the int8 (q, scale) cache."""
    tts = int8_port
    flags = FUSED if which == "fused" else UNFUSED
    padded, n = _prompt(tts, TEXTS[2])
    kw = dict(talker_cfg=TCFG, cp_cfg=CCFG, max_frames=7, kv_capacity=32,
              temperature=temperature, top_k=50, top_p=1.0, repetition_penalty=1.05)
    args = (tts.talker_params, tts.cp_params, torch.from_numpy(padded), n,
            torch.zeros((TCFG.hidden_size,)), TCFG.english_language_id)
    whole = pdl.generate_from_tokens(*args, prng.prng_key(4),
                                     kv_quant=kv_quant, **kw, **flags)
    state, prefill = pdl.generate_init(*args, prng.prng_key(4),
                                       kv_quant=kv_quant, fused_talker=flags["fused_talker"],
                                       **kw)
    assert is_quantized_kv(state.kv) == (kv_quant == "int8" and which == "fused")
    while not state.done and state.frame < 7:
        pdl.generate_chunk(tts.talker_params, tts.cp_params, prefill, state, talker_cfg=TCFG,
                           cp_cfg=CCFG, chunk_frames=3, max_frames=7,
                           temperature=temperature, top_k=50, **flags)
    assert whole.n_frames == state.frame > 0
    np.testing.assert_array_equal(state.codes[:state.frame].numpy(), whole.codes.numpy())
    np.testing.assert_array_equal(state.hidden_out[:state.frame].numpy(),
                                  whole.hidden.numpy())


def test_generate_start_and_start_and_vocode_match_jax(pipelines):
    """generate_start (prefill + the first chunk of 4) gives JAX's greedy
    codes and frame count; start_and_vocode's audio is the vocoder over
    exactly those frames, within the vocoder's tolerance of JAX's
    start_and_vocode (whose chunk is padded to chunk_frames)."""
    jt, pt = pipelines
    padded, n = _prompt(pt, TEXTS[1])
    common = dict(talker_cfg=TCFG, cp_cfg=CCFG, chunk_frames=4, max_frames=12,
                  kv_capacity=32, **GREEDY)
    jargs = (jnp.asarray(padded, jnp.int32), jnp.int32(n),
             jnp.zeros((TCFG.hidden_size,), jnp.float32), jnp.int32(TCFG.english_language_id),
             jax.random.PRNGKey(0))
    pargs = (torch.from_numpy(padded), n, torch.zeros((TCFG.hidden_size,)),
             TCFG.english_language_id)
    js, _ = jdl.generate_start(jt.talker_params, jt.cp_params, *jargs, fused_cp=False,
                               fused_talker=False, **common)
    ps, _ = pdl.generate_start(pt.talker_params, pt.cp_params, *pargs,
                               prng.prng_key(0), **common, **UNFUSED)
    assert ps.frame == int(js.frame) == 4
    np.testing.assert_array_equal(ps.codes[:4].numpy(), np.asarray(js.codes)[:4])

    ja, js, _ = je2e.start_and_vocode(jt.talker_params, jt.cp_params, jt.vocoder_params,
                                      *jargs, vocoder_cfg=VCFG, fused_cp=False,
                                      fused_talker=False, **common)
    pa, ps, _ = pe2e.start_and_vocode(pt.talker_params, pt.cp_params, pt.vocoder_params,
                                      *pargs, prng.prng_key(0),
                                      vocoder_cfg=VCFG, **common, **UNFUSED)
    assert pa.shape == (4 * SPF,) and ps.frame == int(js.frame) == 4
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja)[:4 * SPF], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("history", [2, 32])
def test_synthesize_streaming_matches_jax(pipelines, history):
    """Greedy synthesize_streaming in chunks of 4 frames: the same chunk
    lengths as the JAX package's, each chunk's audio within 2e-3, 1920
    samples per frame of the request's codes in all, and those codes equal
    synthesize's."""
    jt, pt = pipelines
    params = SamplingConfig(temperature=0.0, top_k=0, max_audio_tokens=12, seed=0)
    want = list(jt.synthesize_streaming(TEXTS[0], params, chunk_frames=4, history=history))
    got = list(pt.synthesize_streaming(TEXTS[0], params, chunk_frames=4, history=history))
    assert [len(c) for c in got] == [len(c) for c in want]
    assert len(got) >= 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=S_RTOL, atol=S_ATOL,
                                   err_msg=f"chunk {i}")
    full = pt.synthesize(TEXTS[0], params)
    st = pt.last_stream
    assert st["n_frames"] == full.n_frames and sum(st["chunk_frames"]) == full.n_frames
    assert sum(len(c) for c in got) == full.n_frames * SPF
    np.testing.assert_array_equal(st["codes"], full.codes)


def test_sampled_synthesize_streaming_matches_jax(pipelines):
    """Default sampling (temperature 0.9, top-k 50, penalty 1.05), seed 3,
    chunks of 4 frames: the same chunk lengths as the JAX package's stream,
    each chunk within 2e-3 of its chunk, and the streamed codes equal to the
    JAX package's synthesize with that seed (the key chain carries across
    chunks)."""
    jt, pt = pipelines
    params = SamplingConfig(max_audio_tokens=12, seed=3)
    want = list(jt.synthesize_streaming(TEXTS[0], params, chunk_frames=4, history=32))
    got = list(pt.synthesize_streaming(TEXTS[0], params, chunk_frames=4, history=32))
    assert [len(c) for c in got] == [len(c) for c in want] and len(got) >= 2
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=S_RTOL, atol=S_ATOL,
                                   err_msg=f"chunk {i}")
    full = jt.synthesize(TEXTS[0], params)
    np.testing.assert_array_equal(pt.last_stream["codes"], np.asarray(full.codes))


def test_sampled_stream_codes_equal_synthesize(int8_port):
    """A sampled stream (fused, int8 blocks) emits synthesize's codes with
    the same seed, in chunks of at most chunk_frames, and 1920 finite
    samples per frame."""
    params = SamplingConfig(max_audio_tokens=12, seed=7)
    chunks = list(int8_port.synthesize_streaming(TEXTS[3], params, chunk_frames=5,
                                                 history=3))
    full = int8_port.synthesize(TEXTS[3], params)
    st = int8_port.last_stream
    assert full.n_frames > 0 and st["n_frames"] == full.n_frames
    assert all(0 < k <= 5 for k in st["chunk_frames"])
    assert [len(c) for c in chunks] == [k * SPF for k in st["chunk_frames"]]
    assert all(np.isfinite(c).all() for c in chunks)
    np.testing.assert_array_equal(st["codes"], full.codes)


def _queue(tts, texts, params, *, stream=True, **kw):
    """synthesize_queue with an on_audio that records every call."""
    calls, audio = [], {}

    def on_audio(idx, chunk, finished):
        calls.append((idx, len(chunk) // SPF, bool(finished)))
        audio.setdefault(idx, []).append(np.asarray(chunk))

    rs = tts.synthesize_queue(texts, params, on_audio=on_audio if stream else None, **kw)
    return rs, calls, audio


@pytest.mark.parametrize("cadence", [0, 3])
def test_synthesize_queue_streaming_matches_jax(pipelines, cadence):
    """Greedy queue of five texts on 2 lanes, chunks of 2 frames, per-request
    budgets, stream_cadence 0 and 3: the same sequence of (request, frames,
    finished) calls as the JAX package's, each chunk within 2e-3 of its
    chunk, finished exactly once per request, the results' audio the
    concatenated stream, and the codes those of the same queue without
    on_audio."""
    jt, pt = pipelines
    params = SamplingConfig(temperature=0.0, top_k=0, max_audio_tokens=9)
    kw = dict(lanes=2, chunk_frames=2, refill_slots=2, stream_cadence=cadence,
              max_audio_tokens_per_request=[9, 2, 7, 4, 5])
    jrs, jcalls, jaudio = _queue(jt, TEXTS, params, **kw)
    prs, pcalls, paudio = _queue(pt, TEXTS, params, **kw)
    assert pcalls == jcalls
    assert sorted(i for i, _, fin in pcalls if fin) == list(range(len(TEXTS)))
    if cadence == 0:
        assert max(k for _, k, _ in pcalls) <= 2
    for i, (p, j) in enumerate(zip(prs, jrs)):
        assert p.success and p.n_frames == j.n_frames > 0
        np.testing.assert_array_equal(p.codes, np.asarray(j.codes), err_msg=f"request {i}")
        for c, (pc, jc) in enumerate(zip(paudio[i], jaudio[i])):
            np.testing.assert_allclose(pc, jc, rtol=S_RTOL, atol=S_ATOL,
                                       err_msg=f"request {i} chunk {c}")
        np.testing.assert_array_equal(p.audio, np.concatenate(paudio[i]))
        assert p.audio.shape == (p.n_frames * SPF,) and p.timings.t_decode_ms == 0.0
    plain, _, _ = _queue(pt, TEXTS, params, stream=False, **kw)
    for p, q in zip(prs, plain):
        np.testing.assert_array_equal(p.codes, q.codes)


def test_queue_admission_pacing_changes_no_codes(int8_port):
    """admit_per_chunk=1 admits one request per chunk boundary (more
    refills); streamed, on the fused kernels' plain versions, every
    request's codes equal the unpaced queue's, and each request finishes
    once."""
    params = SamplingConfig(max_audio_tokens=6, seed=11)
    kw = dict(lanes=3, chunk_frames=2, refill_slots=3)
    base, _, _ = _queue(int8_port, TEXTS, params, stream=False, **kw)
    refills = int8_port.last_queue_stats["refills"]
    paced, calls, _ = _queue(int8_port, TEXTS, params, admit_per_chunk=1, **kw)
    assert int8_port.last_queue_stats["refills"] > refills
    assert sorted(i for i, _, fin in calls if fin) == list(range(len(TEXTS)))
    for a, b in zip(base, paced):
        np.testing.assert_array_equal(a.codes, b.codes)


def test_zero_frame_finish_still_signals(pipelines):
    """A request that finishes without frames still gets on_audio(i, empty,
    True): here the scheduler's harvest is fed one event of no rows."""
    _, pt = pipelines
    calls = []
    on_chunk = pt._stream_on_chunk({5: 0}, lambda i, c, f: calls.append((i, len(c), f)), {},
                                   chunk_frames=2, history=16, cadence=3)
    on_chunk([(5, np.zeros((0, 16), np.int32), True)])
    assert calls == [(0, 0, True)]


def test_chip_smoke_stream_phase_at_tiny_config(capsys, monkeypatch):
    """chip_smoke's serve_stream phase at the tiny configuration on the CPU
    (plain versions: every launch count stays 0, so only the launch checks
    are left out): the stream's codes equal synthesize's and each chunk its
    window vocoded alone, TTFA over the seeds, the streamed queue's codes
    equal the queue's without on_audio with one finish per request,
    vocode_batched equal to lane-by-lane decode_codes, the bf16 stream."""
    import chip_smoke

    tts = chip_smoke.make_pipeline(tiny_pipeline_config(), torch.device("cpu"))
    bf16 = chip_smoke.make_pipeline(tiny_pipeline_config(), torch.device("cpu"), quant=None)
    spec = dict(
        request=("The quick brown fox.", dict(max_audio_tokens=7, seed=3)), chunk_frames=3,
        history=2, ttfa_seeds=tuple(range(3, 40)), ttfa_n=2,
        queue=dict(texts=3, lanes=2, kw=dict(max_audio_tokens=6, seed=3), chunk_frames=2,
                   history=2, cadence=3),
        batch=(3, dict(max_audio_tokens=6, seed=3)),
        bf16=dict(request=("Hello.", dict(max_audio_tokens=4, temperature=0.0, seed=1)),
                  chunk_frames=2, history=2))
    monkeypatch.setattr(chip_smoke, "check_launches", lambda *a, **k: None)
    runs = chip_smoke.serve_stream(tts, bf16, "cpu", spec)
    assert len(runs) == 4 and all(set(r.values()) == {0} for r in runs)
    lines = [json.loads(l.split(" ", 1)[1]) for l in capsys.readouterr().out.splitlines()
             if l.startswith("serve_stream ")]
    assert [l["what"] for l in lines] == ["request", "queue", "vocode_batched", "bf16 request"]
    assert lines[0]["frames"] > 0 and lines[0]["ttfa_ms"]["n"] == 2
    assert lines[1]["ttfa_ms"]["n"] == 3 and lines[1]["frames"] > 0
    assert lines[2]["peak_memory_bytes"] is None and lines[2]["max_abs_err"] <= 1e-5
