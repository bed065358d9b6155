"""Batched serving end to end against the JAX package's hand-batched fused
loop, and against the port's own single-stream loop lane by lane, at the
tiny int8 configuration."""

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
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops import prng
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.runtime import decode_loop as pdl

CFG = tiny_pipeline_config()
CFG = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, quant="int8"))
TCFG, CCFG = CFG.talker, CFG.code_predictor
# Greedy codes on random weights flip where a last-bit difference between
# the two packages' float sums moves an int8 activation across a rounding
# boundary and the next code's top-2 logits are close: "Batched lanes."
# does so in the single-stream loop too. These texts do not.
TEXTS = ["Hello there, port.", "Two lanes here.", "A third, somewhat longer request."]


@pytest.fixture(scope="module")
def both():
    tp = jtalker.init_talker_params(jax.random.PRNGKey(11), TCFG, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(12), CCFG, jnp.float32)
    vp = jvoc.init_vocoder_params(jax.random.PRNGKey(13), CFG.vocoder, jnp.float32)
    tp = tp._replace(blocks=quantize_block_params(tp.blocks))
    cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)   # noqa: E731
    tts = Qwen3TTS(CFG, device="cpu")
    tts.set_params(params_from_jax(to_np(tp)), params_from_jax(to_np(cp)),
                   params_from_jax(to_np(vp)))
    return (tp, cp, vp), tts


def _tokens(tts, texts):
    """The padded [B, Tb] ids and real counts synthesize_batch feeds the loop."""
    fitted = [tts._fit_tokens(tts.tokenizer.encode_for_tts(t)) for t in texts]
    Tb = max(p.shape[0] for p, _ in fitted)
    tokens = np.zeros((len(texts), Tb), np.int64)
    for i, (p, _) in enumerate(fitted):
        tokens[i, : p.shape[0]] = p
    return tokens, [n for _, n in fitted]


def test_greedy_batch_matches_jax_hand_batched_loop(both):
    """Greedy synthesize_batch codes EQUAL to the JAX hand-batched fused loop
    (batched talker kernel with its cb0 epilogue, batched code predictor;
    interpret mode) lane for lane; each lane's audio within 5e-3 relative /
    5e-4 absolute of the JAX vocoder on the same codes (snake stages amplify
    reassociation, as tests/test_pallas_vocoder.py allows)."""
    (tp, cp, vp), tts = both
    tokens, n_tok = _tokens(tts, TEXTS)
    B = len(TEXTS)
    params = SamplingConfig(temperature=0.0, max_audio_tokens=4)
    max_frames, kv_capacity = tts._frame_budget(params)
    gen = jdl._generate_batched_fused(
        tp, cp, jnp.asarray(tokens, jnp.int32), jnp.asarray(n_tok, jnp.int32),
        jnp.zeros((B, TCFG.hidden_size), jnp.float32),
        jnp.full((B,), TCFG.english_language_id, jnp.int32),
        jax.random.split(jax.random.PRNGKey(0), B), talker_cfg=TCFG, cp_cfg=CCFG,
        max_frames=max_frames, kv_capacity=kv_capacity, temperature=0.0, top_k=50,
        top_p=1.0, repetition_penalty=1.05, nothink=False, fused_talker=True)
    rs = tts.synthesize_batch(TEXTS, params)
    spf = CFG.vocoder.samples_per_frame
    for b, r in enumerate(rs):
        n = int(gen.n_frames[b])
        want = np.asarray(gen.codes[b])[:n]
        assert r.success, r.error_msg
        assert r.n_frames == n > 0
        np.testing.assert_array_equal(r.codes, want, err_msg=f"lane {b}")
        want_audio = np.asarray(jvoc.vocoder_forward(vp, CFG.vocoder, jnp.asarray(want),
                                                     jnp.int32(n)))
        assert r.audio.shape == (n * spf,)
        np.testing.assert_allclose(r.audio, want_audio, rtol=5e-3, atol=5e-4)


def _lane_keys(seed, B):
    """split(prng_key(seed), B), the keys synthesize_batch gives its lanes."""
    return np.asarray(prng.split(prng.prng_key(seed), B), np.uint32)


def test_sampled_batch_matches_jax_hand_batched_loop(both):
    """Default sampling (temperature 0.9, top-k 50, penalty 1.05), seed 5:
    synthesize_batch codes EQUAL to the JAX hand-batched fused loop's from
    jax.random.split(PRNGKey(5), B), lane for lane (the JAX pipeline's lane
    keys, ``pipeline.py:667``)."""
    (tp, cp, _), tts = both
    tokens, n_tok = _tokens(tts, TEXTS)
    B = len(TEXTS)
    params = SamplingConfig(max_audio_tokens=4, seed=5)
    max_frames, kv_capacity = tts._frame_budget(params)
    gen = jdl._generate_batched_fused(
        tp, cp, jnp.asarray(tokens, jnp.int32), jnp.asarray(n_tok, jnp.int32),
        jnp.zeros((B, TCFG.hidden_size), jnp.float32),
        jnp.full((B,), TCFG.english_language_id, jnp.int32),
        jax.random.split(jax.random.PRNGKey(5), B), talker_cfg=TCFG, cp_cfg=CCFG,
        max_frames=max_frames, kv_capacity=kv_capacity, temperature=0.9, top_k=50,
        top_p=1.0, repetition_penalty=1.05, nothink=False, fused_talker=True)
    rs = tts.synthesize_batch(TEXTS, params)
    assert sum(r.n_frames for r in rs) > 0
    for b, r in enumerate(rs):
        n = min(int(gen.n_frames[b]), params.max_audio_tokens)
        assert r.n_frames == n, f"lane {b}"
        np.testing.assert_array_equal(r.codes, np.asarray(gen.codes[b])[:n],
                                      err_msg=f"lane {b}")


def _batched(tts, tokens, n_tok, seed, **kw):
    B = tokens.shape[0]
    return pdl.generate_from_tokens_batched(
        tts.talker_params, tts.cp_params, torch.from_numpy(tokens), n_tok,
        torch.zeros((B, TCFG.hidden_size)), [TCFG.english_language_id] * B,
        _lane_keys(seed, B), talker_cfg=TCFG, cp_cfg=CCFG, kv_capacity=32, **kw)


def _assert_lanes_equal_single_stream(tts, tokens, n_tok, seed, out, **kw):
    """Lane b of `out` equals generate_from_tokens run with lane b's key,
    split(prng_key(seed), B)[b]: the same frame count and codes."""
    for b, key in enumerate(_lane_keys(seed, tokens.shape[0])):
        single = pdl.generate_from_tokens(
            tts.talker_params, tts.cp_params, torch.from_numpy(tokens[b]), n_tok[b],
            torch.zeros((TCFG.hidden_size,)), TCFG.english_language_id, key,
            talker_cfg=TCFG, cp_cfg=CCFG, kv_capacity=32, **kw)
        assert out.n_frames[b] == single.n_frames, f"lane {b}"
        np.testing.assert_array_equal(out.codes[b, : single.n_frames].numpy(),
                                      single.codes.numpy(), err_msg=f"lane {b}")


SAMPLED = dict(max_frames=6, temperature=0.9, top_k=50, top_p=0.95, repetition_penalty=1.05)


def test_sampled_lane_equals_single_stream_with_its_seed(both):
    """Lane b of a sampled batch from split(prng_key(7), B) equals the
    single-stream loop from that split's key b."""
    _, tts = both
    tokens, n_tok = _tokens(tts, TEXTS)
    out = _batched(tts, tokens, n_tok, 7, **SAMPLED)
    assert sum(out.n_frames) > 0
    _assert_lanes_equal_single_stream(tts, tokens, n_tok, 7, out, **SAMPLED)


def test_chunked_code_predictor_keeps_lanes_equal(both, monkeypatch):
    """With the code predictor's lane cap patched to 2, B = 5 runs it in
    three groups; every lane still equals its single-stream run."""
    _, tts = both
    monkeypatch.setattr(pdl, "CP_KERNEL_MAX_LANES", 2)
    texts = TEXTS + ["Four.", "And a fifth one."]
    tokens, n_tok = _tokens(tts, texts)
    out = _batched(tts, tokens, n_tok, 13, **SAMPLED)
    assert sum(out.n_frames) > 0
    _assert_lanes_equal_single_stream(tts, tokens, n_tok, 13, out, **SAMPLED)


def test_groups_of_lanes_change_no_lane(both, monkeypatch):
    """With the batch's lane cap patched to 2, three sampled texts run as
    two groups one after another; every lane's codes and audio equal the
    one-group run's."""
    import qwen3tts_tpu_torch.pipeline as ppl

    _, tts = both
    params = SamplingConfig(max_audio_tokens=4, seed=21)
    whole = tts.synthesize_batch(TEXTS, params)
    monkeypatch.setattr(ppl, "MAX_BATCH_LANES", 2)
    grouped = tts.synthesize_batch(TEXTS, params)
    assert sum(r.n_frames for r in whole) > 0
    for b, (w, g) in enumerate(zip(whole, grouped)):
        assert (w.success, w.n_frames) == (g.success, g.n_frames), f"lane {b}"
        np.testing.assert_array_equal(w.codes, g.codes, err_msg=f"lane {b}")
        np.testing.assert_array_equal(w.audio, g.audio, err_msg=f"lane {b}")


def test_budgets_truncate_exactly(both):
    """Per-lane budgets: each lane emits exactly its budget, and those codes
    equal the unbudgeted run's first frames (the budget latch only masks
    emissions; it never perturbs another lane)."""
    _, tts = both
    tokens, n_tok = _tokens(tts, TEXTS)
    kw = dict(max_frames=6, temperature=0.9, top_k=5, repetition_penalty=1.05)
    full = _batched(tts, tokens, n_tok, 4, **kw)
    assert full.n_frames == [6, 6, 6]   # no lane draws EOS within 6 frames
    budgets = [2, 6, 4]
    capped = _batched(tts, tokens, n_tok, 4, budgets=budgets, **kw)
    assert capped.n_frames == budgets
    for b, n in enumerate(budgets):
        np.testing.assert_array_equal(capped.codes[b, :n].numpy(), full.codes[b, :n].numpy())
        assert not capped.codes[b, n:].any()
