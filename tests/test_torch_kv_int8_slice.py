"""The int8-KV tier end to end against the JAX package at the tiny int8
configuration, its routing, and the chunked vocoder decode:
- greedy codes of ``synthesize`` and ``synthesize_batch`` with
  ``kv_quant="int8"`` equal JAX's ``generate_from_tokens`` and
  ``generate_from_tokens_batched`` with ``kv_quant="int8"`` and the fused
  talker (its Pallas kernels in interpret mode);
- the routing: the fused loops store the (q, scale) pair, the unfused step
  and the continuous queue keep a compute-dtype cache, more than 64 lanes
  get "none", and ``resolve_kv_quant`` agrees with JAX's;
- ``decode_codes`` with ``vocoder_chunk_frames`` equals JAX's chunked
  ``decode_codes`` (the parent vocoded the whole clip and did not)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3tts_tpu import pipeline as jpipeline
from qwen3tts_tpu.config import SamplingConfig, tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.models import vocoder as jvoc
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu.runtime import decode_loop as jdl
from qwen3tts_tpu.text.bpe import synthetic_tokenizer
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops import kv_quant as pkvq
from qwen3tts_tpu_torch.ops.kv_quant import is_quantized_kv
from qwen3tts_tpu_torch.pipeline import Qwen3TTS, resolve_kv_quant
from qwen3tts_tpu_torch.runtime import decode_loop as pdl

BASE = tiny_pipeline_config()
TCFG, CCFG = BASE.talker, BASE.code_predictor
TEXT = "Hello there, port."
TEXTS = ["Hello there, port.", "Two lanes here.", "A third, somewhat longer request."]
# what JAX's resolvers pick on a TPU for int8 blocks
FUSED = dict(fused_talker=True, fused_cp=True)
# float32 weights: the packages differ in the order and precision of their
# sums only (tests/test_torch_kv_quant.py)
TOL = 1e-4


def _cfg(kv_quant="int8", **rt):
    return dataclasses.replace(BASE, runtime=dataclasses.replace(
        BASE.runtime, quant="int8", kv_quant=kv_quant, **rt))


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def weights():
    """(JAX int8 params (talker, cp, vocoder), the port's Qwen3TTS on the
    same weights with kv_quant="int8")."""
    tp = jtalker.init_talker_params(jax.random.PRNGKey(11), TCFG, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(12), CCFG, jnp.float32)
    vp = jvoc.init_vocoder_params(jax.random.PRNGKey(13), BASE.vocoder, jnp.float32)
    tp = tp._replace(blocks=quantize_block_params(tp.blocks))
    cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    return (tp, cp, vp), _port(_cfg(), tp, cp, vp)


def _port(cfg, tp, cp, vp, **flags):
    tts = Qwen3TTS(cfg, device="cpu", **flags)
    tts.set_params(params_from_jax(_to_np(tp)), params_from_jax(_to_np(cp)),
                   params_from_jax(_to_np(vp)))
    return tts


def _tokens(tts, texts):
    fitted = [tts._fit_tokens(tts.tokenizer.encode_for_tts(t)) for t in texts]
    Tb = max(p.shape[0] for p, _ in fitted)
    tokens = np.zeros((len(texts), Tb), np.int64)
    for i, (p, _) in enumerate(fitted):
        tokens[i, : p.shape[0]] = p
    return tokens, [n for _, n in fitted]


@pytest.fixture
def spy(monkeypatch):
    """Records the cache each fused talker step receives (int8 pair or
    not) and each quantize_cache call."""
    seen = dict(steps=[], quantized=0)
    for name in ("fused_talker_step", "fused_talker_step_batched"):
        fn = getattr(pdl, name)

        def wrapped(*a, _fn=fn, **k):
            seen["steps"].append(is_quantized_kv(a[4]))
            return _fn(*a, **k)

        monkeypatch.setattr(pdl, name, wrapped)

    def quantize_cache(*a, **k):
        seen["quantized"] += 1
        return pkvq.quantize_cache(*a, **k)

    monkeypatch.setattr(pdl, "quantize_cache", quantize_cache)
    return seen


def test_greedy_synthesis_matches_jax(weights, spy):
    """synthesize with kv_quant="int8": greedy codes EQUAL to JAX's
    generate_from_tokens(kv_quant="int8") with the fused kernels (K1 over
    the int8 pair in every frame), hidden states within TOL, finite audio."""
    (tp, cp, _), tts = weights
    tokens = synthetic_tokenizer(TCFG.text_vocab_size).encode_for_tts(TEXT)
    padded = np.zeros((32,), np.int32)
    padded[:len(tokens)] = tokens
    gen = jdl.generate_from_tokens(
        tp, cp, jnp.asarray(padded), jnp.int32(len(tokens)),
        jnp.zeros((TCFG.hidden_size,), jnp.float32), jnp.int32(TCFG.english_language_id),
        jax.random.PRNGKey(0), talker_cfg=TCFG, cp_cfg=CCFG, max_frames=8, kv_capacity=32,
        temperature=0.0, top_k=50, repetition_penalty=1.05, kv_quant="int8", **FUSED)
    n = int(gen.n_frames)
    r = tts.synthesize(TEXT, SamplingConfig(temperature=0.0, max_audio_tokens=8))
    assert r.success, r.error_msg
    assert r.n_frames == n > 0
    np.testing.assert_array_equal(r.codes, np.asarray(gen.codes)[:n])
    np.testing.assert_allclose(r.hidden_states, np.asarray(gen.hidden)[:n], rtol=TOL, atol=TOL)
    assert np.isfinite(r.audio).all() and len(r.audio) == n * 1920
    assert spy["quantized"] == 1 and spy["steps"] and all(spy["steps"])


def test_greedy_batch_matches_jax(weights, spy):
    """synthesize_batch with kv_quant="int8": codes EQUAL to JAX's
    generate_from_tokens_batched(kv_quant="int8") lane for lane, K5 over
    the batch-major int8 pair."""
    (tp, cp, _), tts = weights
    tokens, n_tok = _tokens(tts, TEXTS)
    B = len(TEXTS)
    params = SamplingConfig(temperature=0.0, max_audio_tokens=4)
    max_frames, kv_capacity = tts._frame_budget(params)
    gen = jdl.generate_from_tokens_batched(
        tp, cp, jnp.asarray(tokens, jnp.int32), jnp.asarray(n_tok, jnp.int32),
        jnp.zeros((B, TCFG.hidden_size), jnp.float32),
        jnp.full((B,), TCFG.english_language_id, jnp.int32),
        jax.random.split(jax.random.PRNGKey(0), B), talker_cfg=TCFG, cp_cfg=CCFG,
        max_frames=max_frames, kv_capacity=kv_capacity, temperature=0.0, top_k=50,
        repetition_penalty=1.05, kv_quant="int8", **FUSED)
    for b, r in enumerate(tts.synthesize_batch(TEXTS, params)):
        n = int(gen.n_frames[b])
        assert r.success, r.error_msg
        assert r.n_frames == n > 0
        np.testing.assert_array_equal(r.codes, np.asarray(gen.codes[b])[:n],
                                      err_msg=f"lane {b}")
    assert spy["quantized"] == 1 and spy["steps"] and all(spy["steps"])


def test_unfused_step_ignores_kv_quant(weights, spy):
    """fused_talker=False: kv_quant="int8" is ignored, as in the JAX loops
    (no quantized cache; the codes those of kv_quant="none")."""
    (tp, cp, vp), _ = weights
    tts = _port(_cfg(), tp, cp, vp, fused_talker=False)
    none = _port(_cfg("none"), tp, cp, vp, fused_talker=False)
    params = SamplingConfig(temperature=0.0, max_audio_tokens=4)
    a, b = tts.synthesize(TEXT, params), none.synthesize(TEXT, params)
    assert a.success and a.n_frames == b.n_frames > 0
    np.testing.assert_array_equal(a.codes, b.codes)
    assert spy["quantized"] == 0 and not spy["steps"]


def test_queue_keeps_a_compute_dtype_cache(weights, spy):
    """synthesize_queue passes no kv_quant, as the JAX queue does: the
    int8-KV config serves what the "none" config serves, on a bf16 cache."""
    (tp, cp, vp), tts = weights
    none = _port(_cfg("none"), tp, cp, vp)
    params = SamplingConfig(temperature=0.0, max_audio_tokens=3)
    kw = dict(lanes=2, chunk_frames=2, refill_slots=2)
    a = tts.synthesize_queue(TEXTS, params, **kw)
    b = none.synthesize_queue(TEXTS, params, **kw)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.success and x.n_frames == y.n_frames > 0, i
        np.testing.assert_array_equal(x.codes, y.codes, err_msg=f"request {i}")
    assert spy["quantized"] == 0


@pytest.mark.parametrize("kv_quant", ["auto", "none", "int8"])
def test_resolve_kv_quant_matches_jax(monkeypatch, capsys, kv_quant):
    """resolve_kv_quant agrees with JAX's over weight tiers, single and
    batched calls and lane counts around the 64-lane cap (JAX's environment
    override unset; the port has none); above 64 lanes int8 gives "none"
    with JAX's message on stderr."""
    monkeypatch.delenv("QWEN3TTS_KV_INT8", raising=False)
    for quant in (None, "int8", "q4"):
        rt = dataclasses.replace(BASE.runtime, quant=quant, kv_quant=kv_quant)
        for batched in (False, True):
            for lanes in (0, 3, 64, 65, 128):
                want = jpipeline.resolve_kv_quant(rt, batched=batched, lanes=lanes)
                capsys.readouterr()
                got = resolve_kv_quant(rt, batched=batched, lanes=lanes)
                assert got == want, (quant, batched, lanes)
                capped = kv_quant == "int8" and batched and lanes > 64
                err = capsys.readouterr().err
                assert (got == "none" and f"int8 KV requested at {lanes} lanes" in err) \
                    if capped else err == ""


def test_batch_above_64_lanes_gets_a_bf16_cache(weights, monkeypatch):
    """synthesize_batch resolves the tier for the whole batch: 65 lanes
    run the loop with kv_quant="none", 3 lanes with "int8"."""
    _, tts = weights
    calls = []
    loop = pdl.generate_from_tokens_batched

    def spy(*a, **k):
        calls.append(k["kv_quant"])
        return loop(*a, **k)

    monkeypatch.setattr(pdl, "generate_from_tokens_batched", spy)
    params = SamplingConfig(temperature=0.0, max_audio_tokens=1)
    tts.synthesize_batch(["Hi."] * 65, params)
    tts.synthesize_batch(["Hi."] * 3, params)
    assert calls == ["none", "int8"]


def test_unknown_kv_tier_is_refused_by_the_loop():
    with pytest.raises(ValueError, match="kv_quant"):
        pdl.int8_kv("fp8", True)


# The chunked vocoder decode: 40 frames in chunks of 8 with 16 frames of
# left context reach windows that start past frame 0 (from frame 24 on),
# where the pre-transformer's unbounded causal attention sees less than the
# whole clip. Tolerance: the vocoder's (tests/test_torch_vocoder.py).
RTOL, ATOL = 5e-3, 5e-4


def test_chunked_decode_codes_matches_jax(weights):
    """decode_codes with vocoder_chunk_frames = 8 equals the JAX package's
    decode_codes on the same config and weights, chunk for chunk, and
    differs from one pass over the whole clip (what the parent returned,
    ignoring the field)."""
    (_, _, vp), _ = weights
    cfg = _cfg(vocoder_chunk_frames=8)
    jt = jpipeline.Qwen3TTS(cfg)
    jt.vocoder_params = vp
    pt = Qwen3TTS(cfg, device="cpu")
    pt.vocoder_params = params_from_jax(_to_np(vp))
    codes = np.random.default_rng(8).integers(0, BASE.vocoder.codebook_size,
                                              size=(40, 16)).astype(np.int32)
    want = np.asarray(jt.decode_codes(codes))
    got = pt.decode_codes(codes)
    assert got.shape == want.shape == (40 * 1920,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    chunks = list(pt.stream_decode_chunks(codes, 8))
    assert [len(c) for c in chunks] == [8 * 1920] * 5
    whole = pt._vocode(codes)
    assert not np.allclose(whole, want, rtol=RTOL, atol=ATOL)
    short = codes[:8]    # not longer than the chunk: one pass
    np.testing.assert_array_equal(pt.decode_codes(short), pt._vocode(short))


def test_chunked_decode_reaches_batch_lanes(weights):
    """synthesize_batch vocodes each lane through decode_codes, so the
    chunked decode applies to every lane (the JAX pipeline then skips its
    batched vocoder)."""
    (tp, cp, vp), _ = weights
    tts = _port(_cfg("none", vocoder_chunk_frames=2), tp, cp, vp)
    rs = tts.synthesize_batch(TEXTS[:2], SamplingConfig(temperature=0.0, max_audio_tokens=4))
    for r in rs:
        assert r.success and r.n_frames > 2
        np.testing.assert_array_equal(
            r.audio, np.concatenate(list(tts.stream_decode_chunks(r.codes, 2))))


def test_chunked_batch_times_each_lane(weights, monkeypatch):
    """When chunked vocoding applies, synthesize_batch times each lane's
    decode_codes on its own and takes t_total_ms after that lane, as the
    JAX pipeline does (qwen3tts_tpu/pipeline.py:691-721); without it every
    lane gets the batch's vocoder wall divided by B. Each lane's decode is
    held for a different time (10, 20, 30 ms), so its own t_decode_ms shows
    it."""
    import time

    (tp, cp, vp), _ = weights
    tts = _port(_cfg("none", vocoder_chunk_frames=2), tp, cp, vp)
    decode, calls = tts.decode_codes, []

    def slow_decode(codes):
        calls.append(len(calls))
        time.sleep(0.01 * len(calls))
        return decode(codes)

    monkeypatch.setattr(tts, "decode_codes", slow_decode)
    kw = SamplingConfig(temperature=0.0, max_audio_tokens=4)
    rs = tts.synthesize_batch(TEXTS, kw)
    assert all(r.success and r.n_frames > 2 for r in rs) and len(calls) == len(TEXTS)
    dec = [r.timings.t_decode_ms for r in rs]
    assert len(set(dec)) == len(dec)
    assert all(d >= 10.0 * (i + 1) for i, d in enumerate(dec))
    total = [r.timings.t_total_ms for r in rs]
    assert total == sorted(total) and all(t >= d for t, d in zip(total, dec))

    whole = _port(_cfg("none"), tp, cp, vp)
    rs = whole.synthesize_batch(TEXTS, kw)
    assert len({r.timings.t_decode_ms for r in rs}) == 1
