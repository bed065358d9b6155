"""The port's XLA sampler (``ops/sampling.py`` apply_top_k, apply_top_p,
sample_token) against the JAX package's on the same rows and the same
Gumbel noise, and frame 0 of both decode loops drawn from JAX's top-k set."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.ops import sampling as jsampling
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.models import talker as ptalker
from qwen3tts_tpu_torch.ops import prng
from qwen3tts_tpu_torch.ops import sampling
from qwen3tts_tpu_torch.runtime import decode_loop as pdl

NEG = -1e30
V = 3072


def _rows(seed, n=8):
    """n cb0-sized rows with ties (values on a 0.25 grid) and the cb0
    suppression of [2048, 3072) except EOS 2150 in every other row."""
    rng = np.random.default_rng(seed)
    l = np.round(rng.normal(size=(n, V)) * 2.5 * 4) / 4
    l[::2, 2048:] = NEG
    l[::2, 2150] = 1.0
    return l.astype(np.float32)


def _kept(a):
    return np.asarray(a) > NEG / 2


@pytest.mark.parametrize("top_k", [1, 5, 50, 2049])
def test_top_k_keep_set_equals_jax(top_k):
    """The exact k-th-largest threshold with ties kept: the same ids survive
    (2049 = every unsuppressed id of a suppressed row)."""
    l = _rows(top_k)
    got = sampling.apply_top_k(torch.from_numpy(l), top_k).numpy()
    want = jsampling.apply_top_k(jnp.asarray(l), top_k)
    np.testing.assert_array_equal(_kept(got), _kept(want))
    np.testing.assert_array_equal(got[_kept(got)], l[_kept(got)])
    assert (_kept(got).sum(axis=1) >= top_k).all()


@pytest.mark.parametrize("top_p", [0.3, 0.9, 0.95])
def test_top_p_keep_set_equals_jax(top_p):
    l = _rows(int(top_p * 100)) / 2
    got = sampling.apply_top_p(torch.from_numpy(l), top_p).numpy()
    want = jsampling.apply_top_p(jnp.asarray(l), top_p)
    np.testing.assert_array_equal(_kept(got), _kept(want))


SAMPLERS = {
    "greedy": dict(temperature=0.0, top_k=50, top_p=1.0),
    "topk50": dict(temperature=0.9, top_k=50, top_p=1.0),
    "topk50_topp09": dict(temperature=0.9, top_k=50, top_p=0.9),
    "topp095": dict(temperature=0.7, top_k=0, top_p=0.95),
}


@pytest.mark.parametrize("mode", sorted(SAMPLERS))
def test_sample_token_equals_jax_with_the_same_noise(mode):
    """Fed np.asarray(jax.random.gumbel(k, shape)) as its noise, the port's
    sample_token draws what JAX's sample_token (jax.random.categorical)
    draws with key k, row by row, for 16 keys."""
    kw = SAMPLERS[mode]
    l = _rows(7, n=4)
    for i in range(16):
        key = jax.random.PRNGKey(100 + i)
        want = np.asarray(jsampling.sample_token(key, jnp.asarray(l), **kw))
        noise = torch.from_numpy(np.array(jax.random.gumbel(key, l.shape, jnp.float32)))
        got = sampling.sample_token(torch.from_numpy(l), noise, **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"key {100 + i}")


def test_frame0_sampler_draws_only_from_jax_top_k():
    """400 keys on one suppressed random row: every frame-0 draw of the
    port's loops (decode_loop.sample_cb0) lies in the set JAX's sample_token
    can draw from (the exact top 50 of the temperature-scaled row), and the
    draws spread over it."""
    rng = np.random.default_rng(21)
    row = rng.normal(size=(1, V)).astype(np.float32)
    tcfg = tiny_pipeline_config().talker
    supp = V - tcfg.n_suppressed_tail
    allowed = _kept(jsampling.apply_top_k(
        jsampling.apply_suppression(jnp.asarray(row), supp, tcfg.codec_eos_id) / 0.9, 50))[0]
    keys = prng.key_array([prng.prng_key(s) for s in np.arange(400) * 7919 - 200000])
    drawn = pdl.sample_cb0(torch.from_numpy(np.repeat(row, 400, axis=0)), keys,
                           suppress_start=supp, eos_id=tcfg.codec_eos_id, temperature=0.9,
                           top_k=50, top_p=1.0, greedy=False, use_top_p=False).numpy()
    outside = sorted(set(drawn[~allowed[drawn]].tolist()))
    assert not outside, f"drawn outside JAX's top-50 set: {outside}"
    assert len(set(drawn.tolist())) > 10


CFG = tiny_pipeline_config()
CFG = dataclasses.replace(CFG, runtime=dataclasses.replace(CFG.runtime, quant="int8"))


@pytest.fixture(scope="module")
def flat_params():
    """Tiny int8 weights whose codec head is scaled down 100x: the prefill
    logits are nearly flat, so a sampler that ignored top-k would draw
    outside the top 50 in almost every run."""
    tp = jtalker.init_talker_params(jax.random.PRNGKey(31), CFG.talker, jnp.float32)
    cp = jcp.init_code_predictor_params(jax.random.PRNGKey(32), CFG.code_predictor,
                                        jnp.float32)
    tp = tp._replace(blocks=quantize_block_params(tp.blocks), codec_head=tp.codec_head * 0.01)
    cp = cp._replace(blocks=quantize_block_params(cp.blocks))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)   # noqa: E731
    return params_from_jax(to_np(tp)), params_from_jax(to_np(cp))


def _tokens():
    tokens = np.zeros((16,), np.int64)
    tokens[:12] = np.arange(2, 14)
    return tokens


def _allowed_cb0(tp):
    """The ids JAX's frame-0 sampler can draw from these prefill logits."""
    tcfg = CFG.talker
    pre = ptalker.build_prefill(tp, tcfg, torch.from_numpy(_tokens()), 12,
                                torch.zeros(tcfg.hidden_size), tcfg.english_language_id)
    kv = ptalker.make_kv_cache(tcfg, 32, torch.float32)
    _, logits = ptalker.talker_prefill(tp, tcfg, pre.prefill_embd, kv)
    l = jsampling.apply_suppression(jnp.asarray(logits.numpy()), V - tcfg.n_suppressed_tail,
                                    tcfg.codec_eos_id)
    return _kept(jsampling.apply_top_k(l / 0.9, 50))


LOOP = dict(talker_cfg=CFG.talker, cp_cfg=CFG.code_predictor, max_frames=1, kv_capacity=32,
            temperature=0.9, top_k=50, repetition_penalty=1.05)


@pytest.mark.parametrize("flags", [{}, dict(fused_talker=False, fused_cp=False)],
                         ids=["fused", "unfused"])
def test_single_stream_frame0_within_jax_top_k(flat_params, flags):
    """generate_from_tokens over 40 keys: frame 0's cb0 (or an EOS stop)
    always lies in JAX's top-50 set, on the fused path (the defaults) and
    the unfused one."""
    tp, cp = flat_params
    allowed = _allowed_cb0(tp)
    eos = CFG.talker.codec_eos_id
    for seed in range(40):
        out = pdl.generate_from_tokens(
            tp, cp, torch.from_numpy(_tokens()), 12, torch.zeros(CFG.talker.hidden_size),
            CFG.talker.english_language_id, prng.prng_key(seed),
            **flags, **LOOP)
        cb0 = int(out.codes[0, 0]) if out.n_frames else eos
        assert allowed[cb0], f"seed {seed} drew {cb0}"


def test_batched_frame0_within_jax_top_k(flat_params):
    """generate_from_tokens_batched, 40 lanes of one text: every lane's frame-0
    cb0 lies in JAX's top-50 set."""
    tp, cp = flat_params
    allowed = _allowed_cb0(tp)
    B = 40
    out = pdl.generate_from_tokens_batched(
        tp, cp, torch.from_numpy(np.tile(_tokens(), (B, 1))), [12] * B,
        torch.zeros((B, CFG.talker.hidden_size)), [CFG.talker.english_language_id] * B,
        np.asarray(prng.split(prng.prng_key(3), B), np.uint32), **LOOP)
    eos = CFG.talker.codec_eos_id
    cb0 = [int(out.codes[b, 0, 0]) if out.n_frames[b] else eos for b in range(B)]
    assert all(allowed[c] for c in cb0), cb0
    assert len(set(cb0)) > 5
