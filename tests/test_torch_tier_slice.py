"""The bf16, q4 and q4pure weight tiers end to end against the JAX package's
loops at the tiny configuration: greedy codes of ``Qwen3TTS`` (single
stream and batched, default "auto" flags) equal to JAX's
``generate_from_tokens`` and ``generate_from_tokens_batched`` with the flags
its resolvers pick on a TPU (the talker kernel in every tier; the
code-predictor kernel for int8 blocks only), the unfused flags on q4, a
sampled lane equal to the single stream with its seed, and the refusal of
the fused code predictor on bf16 blocks."""

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
from qwen3tts_tpu.ops.quant import quantize_block_params, quantize_talker_blocks
from qwen3tts_tpu.runtime import decode_loop as jdl
from qwen3tts_tpu.text.bpe import synthetic_tokenizer
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops import prng
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.runtime import decode_loop as pdl

BASE = tiny_pipeline_config()
TCFG, CCFG = BASE.talker, BASE.code_predictor
# Greedy codes on random weights flip where a last-bit difference between
# the two packages' float sums moves an activation's rounding and the next
# code's top-2 logits are close; these texts meet no such flip in any tier.
TEXT = "Hello there, port."
TEXTS = ["Hello there, port.", "Two lanes here.", "A third, somewhat longer request."]
# the flags JAX's resolvers pick on a TPU for each tier
JAX_FLAGS = {None: dict(fused_talker=True, fused_cp=False),
             "q4": dict(fused_talker=True, fused_cp=True),
             "q4pure": dict(fused_talker=True, fused_cp=True)}
UNFUSED = dict(fused_talker=False, fused_cp=False)
TOL = 1e-4   # float32 weights: the packages differ in summation order only


def _cfg(tier):
    return dataclasses.replace(BASE, runtime=dataclasses.replace(BASE.runtime, quant=tier))


@pytest.fixture(scope="module", params=[None, "q4", "q4pure"], ids=["bf16", "q4", "q4pure"])
def tier(request):
    """(tier, JAX params, the port's Qwen3TTS on the same weights)."""
    t = request.param
    tp = jtalker.init_talker_params(jax.random.PRNGKey(11), TCFG, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(12), CCFG, jnp.float32)
    vp = jvoc.init_vocoder_params(jax.random.PRNGKey(13), BASE.vocoder, jnp.float32)
    if t is not None:
        tp = tp._replace(blocks=quantize_talker_blocks(tp.blocks, t))
        cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)   # noqa: E731
    tts = Qwen3TTS(_cfg(t), device="cpu")
    tts.set_params(params_from_jax(to_np(tp)), params_from_jax(to_np(cp)),
                   params_from_jax(to_np(vp)))
    return t, (tp, cp), tts


def _jax_single(tp, cp, **flags):
    tokens = synthetic_tokenizer(TCFG.text_vocab_size).encode_for_tts(TEXT)
    padded = np.zeros((32,), np.int32)
    padded[:len(tokens)] = tokens
    gen = jdl.generate_from_tokens(
        tp, cp, jnp.asarray(padded), jnp.int32(len(tokens)),
        jnp.zeros((TCFG.hidden_size,), jnp.float32), jnp.int32(TCFG.english_language_id),
        jax.random.PRNGKey(0), talker_cfg=TCFG, cp_cfg=CCFG, max_frames=8, kv_capacity=32,
        temperature=0.0, top_k=50, repetition_penalty=1.05, **flags)
    n = int(gen.n_frames)
    return np.asarray(gen.codes)[:n], np.asarray(gen.hidden)[:n]


def _tokens(tts, texts):
    fitted = [tts._fit_tokens(tts.tokenizer.encode_for_tts(t)) for t in texts]
    Tb = max(p.shape[0] for p, _ in fitted)
    tokens = np.zeros((len(texts), Tb), np.int64)
    for i, (p, _) in enumerate(fitted):
        tokens[i, : p.shape[0]] = p
    return tokens, [n for _, n in fitted]


def test_greedy_synthesis_matches_jax(tier):
    """Qwen3TTS with the default flags: greedy codes EQUAL to JAX's
    generate_from_tokens with the tier's flags (its kernels in interpret
    mode); hidden states within 1e-4; finite audio of n_frames * 1920."""
    t, (tp, cp), tts = tier
    want_codes, want_hidden = _jax_single(tp, cp, **JAX_FLAGS[t])
    r = tts.synthesize(TEXT, SamplingConfig(temperature=0.0, max_audio_tokens=8))
    assert r.success, r.error_msg
    assert r.n_frames == len(want_codes) > 0
    np.testing.assert_array_equal(r.codes, want_codes)
    np.testing.assert_allclose(r.hidden_states, want_hidden, rtol=TOL, atol=TOL)
    assert np.isfinite(r.audio).all() and len(r.audio) == r.n_frames * 1920


def test_greedy_batch_matches_jax(tier):
    """Greedy synthesize_batch: codes EQUAL to JAX
    generate_from_tokens_batched with the tier's flags, lane for lane."""
    t, (tp, cp), tts = tier
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
        repetition_penalty=1.05, **JAX_FLAGS[t])
    for b, r in enumerate(tts.synthesize_batch(TEXTS, params)):
        n = int(gen.n_frames[b])
        assert r.success, r.error_msg
        assert r.n_frames == n > 0
        np.testing.assert_array_equal(r.codes, np.asarray(gen.codes[b])[:n],
                                      err_msg=f"lane {b}")


def test_auto_flags_resolve_by_tier(tier):
    """auto: the talker kernel in every tier; the code-predictor kernel
    only on int8 blocks (every quantized tier), as JAX's resolvers pick."""
    t, _, tts = tier
    assert pdl.resolve_fused_talker("auto") is True
    assert pdl.resolve_fused_cp("auto", tts.cp_params) is JAX_FLAGS[t]["fused_cp"]
    assert tts.fused == dict(fused_talker="auto", fused_cp="auto")


SAMPLED = dict(max_frames=6, temperature=0.9, top_k=50, top_p=0.95, repetition_penalty=1.05)


def test_sampled_lane_equals_single_stream_with_its_seed(tier):
    """Sampled, default flags: lane b of the batched loop from keys [B, 2]
    equals the single-stream loop run with keys[b] (frame count and
    codes)."""
    _, _, tts = tier
    tokens, n_tok = _tokens(tts, TEXTS)
    B = len(TEXTS)
    common = dict(talker_cfg=TCFG, cp_cfg=CCFG, kv_capacity=32, **SAMPLED)
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


@pytest.fixture(scope="module")
def q4_unfused():
    tp = jtalker.init_talker_params(jax.random.PRNGKey(11), TCFG, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(12), CCFG, jnp.float32)
    vp = jvoc.init_vocoder_params(jax.random.PRNGKey(13), BASE.vocoder, jnp.float32)
    tp = tp._replace(blocks=quantize_talker_blocks(tp.blocks, "q4"))
    cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)   # noqa: E731
    tts = Qwen3TTS(_cfg("q4"), device="cpu", **UNFUSED)
    tts.set_params(params_from_jax(to_np(tp)), params_from_jax(to_np(cp)),
                   params_from_jax(to_np(vp)))
    return (tp, cp), tts


def test_unfused_q4_matches_jax(q4_unfused):
    """fused_talker=False, fused_cp=False on q4: the talker's u4 FFN runs
    the grouped QuantLinear4 product; greedy codes EQUAL to JAX's unfused
    loop, single stream and batched."""
    (tp, cp), tts = q4_unfused
    want_codes, want_hidden = _jax_single(tp, cp, **UNFUSED)
    r = tts.synthesize(TEXT, SamplingConfig(temperature=0.0, max_audio_tokens=8))
    assert r.success and r.n_frames == len(want_codes) > 0
    np.testing.assert_array_equal(r.codes, want_codes)
    np.testing.assert_allclose(r.hidden_states, want_hidden, rtol=TOL, atol=TOL)
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
        repetition_penalty=1.05, **UNFUSED)
    for b, rb in enumerate(tts.synthesize_batch(TEXTS, params)):
        n = int(gen.n_frames[b])
        assert rb.n_frames == n > 0
        np.testing.assert_array_equal(rb.codes, np.asarray(gen.codes[b])[:n],
                                      err_msg=f"lane {b}")


def test_fused_cp_true_on_bf16_blocks_raises():
    """An explicit fused_cp=True on the bf16 tier's code predictor raises a
    ValueError naming the tier, in both loops (JAX fails on
    ``blocks.wqkv.q``, pallas_code_predictor.py:361)."""
    tts = Qwen3TTS(_cfg(None), device="cpu", fused_cp=True)
    assert tts.load_models(None, synthetic=True), tts.error_msg
    with pytest.raises(ValueError, match="bf16"):
        tts.synthesize(TEXT, SamplingConfig(max_audio_tokens=4))
    with pytest.raises(ValueError, match="bf16"):
        tts.synthesize_batch(TEXTS[:2], SamplingConfig(max_audio_tokens=4))
