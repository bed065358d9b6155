"""The port's main path end to end against the JAX package's: greedy
synthesis at the tiny int8 configuration on the same tokens and weights."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3tts_tpu.config import SamplingConfig, tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.models import vocoder as jvoc
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu.runtime import decode_loop as jdl
from qwen3tts_tpu.text.bpe import synthetic_tokenizer
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.pipeline import Qwen3TTS

CFG = tiny_pipeline_config()
CFG = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, quant="int8"))
TEXT = "Hello there, port."


@pytest.fixture(scope="module")
def both():
    tp = jtalker.init_talker_params(jax.random.PRNGKey(11), CFG.talker, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(12), CFG.code_predictor,
                                        jnp.float32)
    vp = jvoc.init_vocoder_params(jax.random.PRNGKey(13), CFG.vocoder, jnp.float32)
    tp = tp._replace(blocks=quantize_block_params(tp.blocks))
    cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)   # noqa: E731
    tts = Qwen3TTS(CFG, device="cpu")
    tts.set_params(params_from_jax(to_np(tp)), params_from_jax(to_np(cp)),
                   params_from_jax(to_np(vp)))
    return (tp, cp, vp), tts


def test_greedy_synthesis_matches_jax_fused_path(both):
    """Greedy codes EQUAL to the JAX fused-kernel loop (interpret mode);
    per-frame hidden states within 1e-4 (float32, summation order only);
    audio within 5e-3 relative / 5e-4 absolute (snake stages amplify
    reassociation, as tests/test_pallas_vocoder.py allows)."""
    (tp, cp, vp), tts = both
    tokens = synthetic_tokenizer(CFG.talker.text_vocab_size).encode_for_tts(TEXT)
    padded = np.zeros((32,), np.int32)
    padded[:len(tokens)] = tokens
    gen = jdl.generate_from_tokens(
        tp, cp, jnp.asarray(padded), jnp.int32(len(tokens)),
        jnp.zeros((CFG.talker.hidden_size,), jnp.float32),
        jnp.int32(CFG.talker.english_language_id), jax.random.PRNGKey(0),
        talker_cfg=CFG.talker, cp_cfg=CFG.code_predictor, max_frames=8, kv_capacity=32,
        temperature=0.0, top_k=50, repetition_penalty=1.05, fused_cp=True,
        fused_talker=True)
    n = int(gen.n_frames)
    want_codes = np.asarray(gen.codes)[:n]
    want_audio = np.asarray(jvoc.vocoder_forward(vp, CFG.vocoder, jnp.asarray(want_codes),
                                                 jnp.int32(n)))

    r = tts.synthesize(TEXT, SamplingConfig(temperature=0.0, max_audio_tokens=8))
    assert r.success, r.error_msg
    assert r.n_frames == n > 0
    np.testing.assert_array_equal(r.codes, want_codes)
    np.testing.assert_allclose(r.hidden_states, np.asarray(gen.hidden)[:n], rtol=1e-4,
                               atol=1e-4)
    assert r.audio.shape == (n * CFG.vocoder.samples_per_frame,)
    np.testing.assert_allclose(r.audio, want_audio, rtol=5e-3, atol=5e-4)


def test_sampled_synthesis_is_valid_and_reproducible(both):
    """Default sampling: codes in range, finite audio of n_frames * 1920
    samples, and the same seed gives the same output."""
    _, tts = both
    p = SamplingConfig(max_audio_tokens=6, seed=5)
    a, b = tts.synthesize(TEXT, p), tts.synthesize(TEXT, p)
    assert a.success and a.n_frames > 0
    assert (a.codes[:, 0] < 2048).all() and (a.codes >= 0).all()
    assert (a.codes[:, 1:] < CFG.code_predictor.vocab_size).all()
    assert len(a.audio) == a.n_frames * CFG.vocoder.samples_per_frame
    assert np.isfinite(a.audio).all()
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.audio, b.audio)


def test_sampled_synthesis_matches_jax_fused_path(both):
    """Default sampling (temperature 0.9, top-k 50, penalty 1.05): codes
    EQUAL to the JAX fused-kernel loop's from jax.random.PRNGKey(seed), the
    port drawing from prng_key(seed): frame 0's cb0 by categorical, K2's
    and K1's seeds seed32 of each frame's split, as the JAX loop draws
    them."""
    (tp, cp, _), tts = both
    tokens = synthetic_tokenizer(CFG.talker.text_vocab_size).encode_for_tts(TEXT)
    padded = np.zeros((32,), np.int32)
    padded[:len(tokens)] = tokens
    gen = jdl.generate_from_tokens(
        tp, cp, jnp.asarray(padded), jnp.int32(len(tokens)),
        jnp.zeros((CFG.talker.hidden_size,), jnp.float32),
        jnp.int32(CFG.talker.english_language_id), jax.random.PRNGKey(3),
        talker_cfg=CFG.talker, cp_cfg=CFG.code_predictor, max_frames=8, kv_capacity=32,
        temperature=0.9, top_k=50, repetition_penalty=1.05, fused_cp=True,
        fused_talker=True)
    n = int(gen.n_frames)
    r = tts.synthesize(TEXT, SamplingConfig(max_audio_tokens=8, seed=3))
    assert r.success, r.error_msg
    assert r.n_frames == n > 0
    np.testing.assert_array_equal(r.codes, np.asarray(gen.codes)[:n])
