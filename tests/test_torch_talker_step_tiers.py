"""Kernels K1 and K5 in the non-w8a8 weight modes (their plain versions)
against the JAX package's Pallas talker steps in interpret mode, at the
tiny configuration: the bf16 mode (bf16 weights, and float32 weights as the
JAX package's own tests run it), w4bf16 (the q4pure tier) and the q4 tier's
per-projection tuple. The same numpy inputs; weights cross over through
io/from_jax.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.ops import pallas_talker_step as jpts
from qwen3tts_tpu.ops.quant import quantize_talker_blocks
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops.fused_talker_step import (fused_talker_step,
                                                      fused_talker_step_batched, weight_mode)

CFG = tiny_pipeline_config().talker
C, B = 32, 3
# tier -> (weight dtype of the plain blocks, JAX tier for quantize_talker_blocks)
TIERS = {"bf16": ("bfloat16", None), "bf16_f32_weights": ("float32", None),
         "q4pure": ("float32", "q4pure"), "q4": ("float32", "q4")}
MODES = {"bf16": "bf16", "bf16_f32_weights": "f32", "q4pure": "w4bf16",
         "q4": ("w8a8", "w8a8", "w4bf16", "w4bf16")}
# the JAX package's name of each mode: its "bf16" mode dots at the weights'
# dtype, so float32 weights run in it too (the port's "f32")
JAX_MODES = dict(MODES, bf16_f32_weights="bf16")
# Float32 activations and KV. The versions differ in the order and
# precision of their sums (the port sums in float64 and rounds once; the
# batched Pallas kernel's softmax is online), which moves the float32 sums
# by a few ulp; an activation's bf16 or int8 rounding does not flip on
# these inputs, so 1e-4 holds through both layers.
TOL = 1e-4


@pytest.fixture(scope="module", params=sorted(TIERS))
def setup(request):
    name = request.param
    wdtype, tier = TIERS[name]
    params = jtalker.init_talker_params(jax.random.PRNGKey(5), CFG, jnp.float32)
    blocks = params.blocks
    if tier is not None:
        blocks = quantize_talker_blocks(blocks, tier)
    else:
        blocks = blocks._replace(**{k: getattr(blocks, k).astype(wdtype)
                                    for k in ("wqkv", "wo", "w_gateup", "w_down")})
    jparams = params._replace(blocks=blocks)
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(21)
    kv = (rng.normal(size=(B, CFG.n_layers, 2, CFG.n_kv_heads, C, CFG.head_dim)) * 0.5
          ).astype(np.float32)
    x = rng.normal(size=(B, CFG.hidden_size)).astype(np.float32)
    seen = rng.random((B, CFG.codec_vocab_size)) < 0.05
    return name, jparams, port, kv, x, seen


def test_weight_mode_matches_jax(setup):
    name, jparams, port, *_ = setup
    assert weight_mode(port.blocks) == MODES[name]
    assert jpts._weight_mode(jparams.blocks, "w8a8") == JAX_MODES[name]


SAMPLING = dict(top_k=50, suppress_start=2048, repetition_penalty=1.05)


@pytest.mark.parametrize("n_past", [0, 19])
def test_single_step_matches_jax(setup, n_past):
    """K1: hidden, logits and the whole cache within 1e-4; greedy cb0 and a
    sampled cb0 (temperature 0.9, top-k 50, penalty 1.05 over a seen-set,
    suppression of [2048, 3072) except EOS) with the same seed equal."""
    name, jparams, port, kv, x, seen = setup

    def jax_step(**kw):
        return jpts.fused_talker_step(
            jparams.blocks, CFG, jnp.asarray(x[0]), jnp.int32(n_past), jnp.asarray(kv[0]),
            output_norm=jparams.output_norm, codec_head=jparams.codec_head, interpret=True,
            **kw)

    def port_step(kv_t, **kw):
        return fused_talker_step(port.blocks, CFG, torch.from_numpy(x[0]), n_past, kv_t,
                                 output_norm=port.output_norm, codec_head=port.codec_head, **kw)

    hid, logits, kv_j = jax_step()
    kv_t = torch.from_numpy(kv[0].copy())
    out = port_step(kv_t)
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(hid), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kv_t.numpy(), np.asarray(kv_j), rtol=TOL, atol=TOL)
    for greedy, seed in ((True, 0), (False, 11)):
        temp = 0.0 if greedy else 0.9
        kw = dict(SAMPLING, eos_id=CFG.codec_eos_id, temperature=temp, greedy=greedy,
                  use_top_p=False)
        _, cb0_j, _ = jax_step(seen=jnp.asarray(seen[0]), seeds=jnp.int32(seed), **kw)
        o = port_step(torch.from_numpy(kv[0].copy()), seen=torch.from_numpy(seen[0]),
                      seed=seed, **kw)
        assert int(o.cb0[0]) == int(cb0_j), (name, greedy)


@pytest.mark.parametrize("n_past", [0, 19])
def test_batched_step_matches_jax(setup, n_past):
    """K5 at B = 3: hidden, logits and the whole cache within 1e-4; each
    lane's greedy and sampled cb0 (its own seed) equal."""
    name, jparams, port, kv, x, seen = setup

    def jax_step(**kw):
        return jpts.fused_talker_step_batched(
            jparams.blocks, CFG, jnp.asarray(x), jnp.int32(n_past), jnp.asarray(kv),
            output_norm=jparams.output_norm, codec_head=jparams.codec_head, chunk=8,
            interpret=True, **kw)

    def port_step(kv_t, **kw):
        return fused_talker_step_batched(port.blocks, CFG, torch.from_numpy(x), n_past, kv_t,
                                         output_norm=port.output_norm,
                                         codec_head=port.codec_head, **kw)

    hid, logits, kv_j = jax_step()
    kv_t = torch.from_numpy(kv.copy())
    out = port_step(kv_t)
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(hid), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kv_t.numpy(), np.asarray(kv_j), rtol=TOL, atol=TOL)
    seeds = np.array([5, -77, 123457], np.int32)
    for greedy in (True, False):
        kw = dict(SAMPLING, eos_id=CFG.codec_eos_id, temperature=0.0 if greedy else 0.9,
                  greedy=greedy, use_top_p=False)
        _, cb0_j, _ = jax_step(seen=jnp.asarray(seen), seeds=jnp.asarray(seeds), **kw)
        o = port_step(torch.from_numpy(kv.copy()), seen=torch.from_numpy(seen),
                      seeds=torch.from_numpy(seeds), **kw)
        np.testing.assert_array_equal(o.cb0.numpy(), np.asarray(cb0_j).reshape(-1))
