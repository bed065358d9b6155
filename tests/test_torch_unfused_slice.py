"""The unfused decode path (fused_talker=False and/or fused_cp=False) end to
end against the JAX package's, at the tiny int8 configuration: greedy codes
of both loops with each flag setting that leaves something unfused, the
teacher-forced talker step and code predictor, and sampled runs."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu.config import SamplingConfig, tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.models import vocoder as jvoc
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu.runtime import decode_loop as jdl
from qwen3tts_tpu.text.bpe import synthetic_tokenizer
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.models import code_predictor as pcp
from qwen3tts_tpu_torch.models import talker as ptalker
from qwen3tts_tpu_torch.ops import prng
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.runtime import decode_loop as pdl

CFG = tiny_pipeline_config()
CFG = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, quant="int8"))
TCFG, CCFG = CFG.talker, CFG.code_predictor
# Greedy codes on random weights flip where a last-bit difference between
# the two packages' float sums meets a near-tie of the top-2 logits; these
# texts meet none.
TEXT = "Hello there, port."
TEXTS = ["Hello there, port.", "Two lanes here.", "A third, somewhat longer request."]
UNFUSED = dict(fused_talker=False, fused_cp=False)
FLAGS = {"unfused": UNFUSED, "fused_talker_only": dict(fused_talker=True, fused_cp=False),
         "fused_cp_only": dict(fused_talker=False, fused_cp=True)}
# float32 weights end to end: the packages differ in summation order only
TOL = 1e-4


@pytest.fixture(scope="module")
def both():
    tp = jtalker.init_talker_params(jax.random.PRNGKey(11), TCFG, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(12), CCFG, jnp.float32)
    vp = jvoc.init_vocoder_params(jax.random.PRNGKey(13), CFG.vocoder, jnp.float32)
    tp = tp._replace(blocks=quantize_block_params(tp.blocks))
    cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)   # noqa: E731
    ports = {}
    for name, flags in FLAGS.items():
        tts = Qwen3TTS(CFG, device="cpu", **flags)
        tts.set_params(params_from_jax(to_np(tp)), params_from_jax(to_np(cp)),
                       params_from_jax(to_np(vp)))
        ports[name] = tts
    return (tp, cp), ports


def _jax_single(tp, cp, temperature=0.0, seed=0, **flags):
    tokens = synthetic_tokenizer(TCFG.text_vocab_size).encode_for_tts(TEXT)
    padded = np.zeros((32,), np.int32)
    padded[:len(tokens)] = tokens
    gen = jdl.generate_from_tokens(
        tp, cp, jnp.asarray(padded), jnp.int32(len(tokens)),
        jnp.zeros((TCFG.hidden_size,), jnp.float32), jnp.int32(TCFG.english_language_id),
        jax.random.PRNGKey(seed), talker_cfg=TCFG, cp_cfg=CCFG, max_frames=8, kv_capacity=32,
        temperature=temperature, top_k=50, repetition_penalty=1.05, **flags)
    n = int(gen.n_frames)
    return np.asarray(gen.codes)[:n], np.asarray(gen.hidden)[:n]


@pytest.mark.parametrize("which", sorted(FLAGS))
def test_greedy_synthesis_matches_jax(both, which):
    """Greedy codes EQUAL to JAX generate_from_tokens with the same flags
    (both off, or one fused kernel, in interpret mode in JAX, beside the
    other unfused part); hidden states within 1e-4."""
    (tp, cp), ports = both
    want_codes, want_hidden = _jax_single(tp, cp, **FLAGS[which])
    r = ports[which].synthesize(TEXT, SamplingConfig(temperature=0.0, max_audio_tokens=8))
    assert r.success, r.error_msg
    assert r.n_frames == len(want_codes) > 0
    np.testing.assert_array_equal(r.codes, want_codes)
    np.testing.assert_allclose(r.hidden_states, want_hidden, rtol=TOL, atol=TOL)
    assert np.isfinite(r.audio).all() and len(r.audio) == r.n_frames * 1920


def _tokens(tts, texts):
    fitted = [tts._fit_tokens(tts.tokenizer.encode_for_tts(t)) for t in texts]
    Tb = max(p.shape[0] for p, _ in fitted)
    tokens = np.zeros((len(texts), Tb), np.int64)
    for i, (p, _) in enumerate(fitted):
        tokens[i, : p.shape[0]] = p
    return tokens, [n for _, n in fitted]


@pytest.mark.parametrize("which", ["fused_talker_only", "unfused"])
def test_sampled_synthesis_matches_jax(both, which):
    """Default sampling (temperature 0.9, top-k 50, penalty 1.05), seed 3:
    codes EQUAL to JAX generate_from_tokens from PRNGKey(3) with the same
    flags: the unfused talker draws frame f's cb0 with its own split's
    k_cb0, the fused one with the previous frame's (in-kernel);
    predict_codes draws from k_cp's chain. (The bf16 tier's default path
    is fused_talker_only.)"""
    (tp, cp), ports = both
    want_codes, _ = _jax_single(tp, cp, temperature=0.9, seed=3, **FLAGS[which])
    r = ports[which].synthesize(TEXT, SamplingConfig(max_audio_tokens=8, seed=3))
    assert r.success, r.error_msg
    assert r.n_frames == len(want_codes) > 0
    np.testing.assert_array_equal(r.codes, want_codes)


@pytest.mark.parametrize("which", sorted(FLAGS))
def test_greedy_batch_matches_jax(both, which):
    """Greedy synthesize_batch: codes EQUAL to JAX
    generate_from_tokens_batched with the same flags, lane for lane (both
    off: the vmapped unfused loop; one fused kernel: the hand-batched loop
    with the other part unfused)."""
    (tp, cp), ports = both
    tts = ports[which]
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
        repetition_penalty=1.05, **FLAGS[which])
    rs = tts.synthesize_batch(TEXTS, params)
    for b, r in enumerate(rs):
        n = int(gen.n_frames[b])
        assert r.success, r.error_msg
        assert r.n_frames == n > 0
        np.testing.assert_array_equal(r.codes, np.asarray(gen.codes[b])[:n],
                                      err_msg=f"lane {b}")


@pytest.fixture(scope="module")
def step_inputs(both):
    (tp, cp), ports = both
    rng = np.random.default_rng(3)
    kv = (rng.normal(size=(3, TCFG.n_layers, 2, TCFG.n_kv_heads, 32, TCFG.head_dim)) * 0.5
          ).astype(np.float32)
    x = rng.normal(size=(3, TCFG.hidden_size)).astype(np.float32)
    return tp, cp, ports["unfused"], kv, x


@pytest.mark.parametrize("n_past", [0, 9, 31])
def test_talker_step_matches_jax(step_inputs, n_past):
    """Teacher-forced talker_step: one stream and three lanes against JAX's
    talker_step (vmapped, carried strategy, as the batched loop runs it):
    normed hidden, logits and the cache within 1e-4."""
    tp, _, tts, kv, x = step_inputs
    for lanes in (False, True):
        xs, kvs = (x, kv) if lanes else (x[0], kv[0])
        if lanes:
            hj, lj, kvj = jax.vmap(lambda e, c: jtalker.talker_step(
                tp, TCFG, e, jnp.int32(n_past), c, strategy="carried"))(
                jnp.asarray(xs), jnp.asarray(kvs))
        else:
            hj, lj, kvj = jtalker.talker_step(tp, TCFG, jnp.asarray(xs), jnp.int32(n_past),
                                              jnp.asarray(kvs))
        kv_t = torch.from_numpy(kvs.copy())
        ht, lt = ptalker.talker_step(tts.talker_params, TCFG, torch.from_numpy(xs), n_past, kv_t)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(kv_t.numpy(), np.asarray(kvj), rtol=TOL, atol=TOL)


def test_predict_codes_greedy_matches_jax(step_inputs):
    """Greedy predict_codes, one stream and three lanes: the 15 codes EQUAL
    to JAX's predict_codes."""
    tp, cp, tts, _, x = step_inputs
    cb0 = np.asarray(tp.codec_embd)[[5, 77, 901]]
    kw = dict(temperature=0.0, top_k=50, greedy=True, use_top_p=False)
    want = np.stack([np.asarray(jcp.predict_codes(cp, CCFG, jnp.asarray(x[b]), jnp.asarray(cb0[b]),
                                                  jax.random.PRNGKey(b), **kw))
                     for b in range(3)])
    cpp = tts.cp_params
    keys = np.stack([np.asarray(jax.random.PRNGKey(b)) for b in range(3)])
    got = pcp.predict_codes(cpp, CCFG, torch.from_numpy(x), torch.from_numpy(cb0), keys,
                            **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pcp.predict_codes(cpp, CCFG, torch.from_numpy(x[1]), torch.from_numpy(cb0[1]),
                          prng.prng_key(1), **kw).numpy(), want[1])


def test_predict_codes_sampled_matches_jax(step_inputs):
    """Sampled predict_codes (temperature 0.9, top-k 50, top-p 0.9), one
    stream and three lanes with their own keys: the 15 codes EQUAL to JAX's
    vmapped predict_codes with the same keys (its split chain, one
    categorical a code); the port draws the frame's 15 Gumbel fields in one
    pass."""
    tp, cp, tts, _, x = step_inputs
    cb0 = np.asarray(tp.codec_embd)[[5, 77, 901]]
    kw = dict(temperature=0.9, top_k=50, top_p=0.9)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(41), 3))
    want = np.asarray(jax.vmap(lambda h, c, k: jcp.predict_codes(cp, CCFG, h, c, k, **kw))(
        jnp.asarray(x), jnp.asarray(cb0), jnp.asarray(keys)))
    cpp = tts.cp_params
    got = pcp.predict_codes(cpp, CCFG, torch.from_numpy(x), torch.from_numpy(cb0), keys,
                            **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pcp.predict_codes(cpp, CCFG, torch.from_numpy(x[2]), torch.from_numpy(cb0[2]),
                          prng.key_pair(keys[2]), **kw).numpy(), want[2])


SAMPLED = dict(max_frames=6, temperature=0.9, top_k=50, top_p=0.95, repetition_penalty=1.05)


def test_sampled_synthesis_is_valid_and_reproducible(both):
    _, ports = both
    tts = ports["unfused"]
    p = SamplingConfig(max_audio_tokens=6, seed=5)
    a, b = tts.synthesize(TEXT, p), tts.synthesize(TEXT, p)
    assert a.success and a.n_frames > 0
    assert (a.codes[:, 0] < 2048).all() and (a.codes >= 0).all()
    assert (a.codes[:, 1:] < CCFG.vocab_size).all()
    assert np.isfinite(a.audio).all()
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.audio, b.audio)


def test_sampled_lane_equals_single_stream_with_its_seed(both):
    """Unfused, sampled: lane b of the batched loop from keys [B, 2] equals
    the single-stream loop run with keys[b] (frame count and codes)."""
    _, ports = both
    tts = ports["unfused"]
    tokens, n_tok = _tokens(tts, TEXTS)
    B = len(TEXTS)
    common = dict(talker_cfg=TCFG, cp_cfg=CCFG, kv_capacity=32, **UNFUSED, **SAMPLED)
    keys = np.asarray(prng.split(prng.prng_key(7), B), np.uint32)
    out = pdl.generate_from_tokens_batched(
        tts.talker_params, tts.cp_params, torch.from_numpy(tokens), n_tok,
        torch.zeros((B, TCFG.hidden_size)), [TCFG.english_language_id] * B, keys, **common)
    assert sum(out.n_frames) > 0
    for b in range(B):
        single = pdl.generate_from_tokens(
            tts.talker_params, tts.cp_params, torch.from_numpy(tokens[b]), n_tok[b],
            torch.zeros((TCFG.hidden_size,)), TCFG.english_language_id, keys[b], **common)
        assert out.n_frames[b] == single.n_frames, f"lane {b}"
        np.testing.assert_array_equal(out.codes[b, : single.n_frames].numpy(),
                                      single.codes.numpy(), err_msg=f"lane {b}")
