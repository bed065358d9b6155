"""Kernel K1's plain version and the port's talker prefill against the JAX
package at the tiny configuration: the same numpy inputs, weights crossing
over through io/from_jax.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.ops import pallas_talker_step as jpts
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.models import talker as ptalker
from qwen3tts_tpu_torch.models.transformer_core import forward_step
from qwen3tts_tpu_torch.ops.fused_talker_step import fused_talker_step

CFG = tiny_pipeline_config().talker
C = 32
# float32 end to end: the versions differ in summation order only, and the
# int8 activation roundings agree on these inputs.
TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    params = jtalker.init_talker_params(jax.random.PRNGKey(5), CFG, jnp.float32)
    qparams = params._replace(blocks=quantize_block_params(params.blocks))
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, qparams))
    rng = np.random.default_rng(9)
    kv = (rng.normal(size=(CFG.n_layers, 2, CFG.n_kv_heads, C, CFG.head_dim)) * 0.5
          ).astype(np.float32)
    x = rng.normal(size=(CFG.hidden_size,)).astype(np.float32)
    seen = rng.random(CFG.codec_vocab_size) < 0.05
    return qparams, port, kv, x, seen


def _jax_step(qparams, kv, x, n_past, **kw):
    return jpts.fused_talker_step(
        qparams.blocks, CFG, jnp.asarray(x), jnp.int32(n_past), jnp.asarray(kv),
        output_norm=qparams.output_norm, codec_head=qparams.codec_head, mode="w8a8",
        interpret=True, **kw)


@pytest.mark.parametrize("n_past", [0, 7, 31])
def test_step_matches_jax_w8a8(setup, n_past):
    qparams, port, kv, x, _ = setup
    hid, logits, kv_j = _jax_step(qparams, kv, x, n_past)
    kv_t = torch.from_numpy(kv.copy())
    out = fused_talker_step(port.blocks, CFG, torch.from_numpy(x), n_past, kv_t,
                            output_norm=port.output_norm, codec_head=port.codec_head)
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(hid), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kv_t.numpy(), np.asarray(kv_j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_past", [0, 7, 31])
def test_cb0_epilogue_matches_jax(setup, n_past):
    """cb0 equal for greedy and for sampled draws (temperature 0.9, top-k 50,
    penalty 1.05 over a seen-set, suppression of [2048, 3072) except EOS)
    with the same seeds."""
    qparams, port, kv, x, seen = setup
    common = dict(top_k=50, suppress_start=2048, eos_id=CFG.codec_eos_id,
                  repetition_penalty=1.05)
    for greedy, seed in ((True, 0), (False, 11), (False, -123457)):
        temp = 0.0 if greedy else 0.9
        _, cb0_j, _ = _jax_step(qparams, kv, x, n_past, seen=jnp.asarray(seen),
                                seeds=jnp.int32(seed), temperature=temp, greedy=greedy,
                                use_top_p=False, **common)
        out = fused_talker_step(
            port.blocks, CFG, torch.from_numpy(x), n_past, torch.from_numpy(kv.copy()),
            output_norm=port.output_norm, codec_head=port.codec_head,
            seen=torch.from_numpy(seen), seed=seed, temperature=temp, greedy=greedy,
            use_top_p=False, **common)
        assert int(out.cb0[0]) == int(cb0_j), (greedy, seed)


def test_prefill_matches_jax(setup):
    """build_prefill + the dense prefill: window, trailing schedule, last
    hidden, logits and the K/V rows written."""
    qparams, port, _, _, _ = setup
    tokens = np.zeros((16,), np.int32)
    tokens[:12] = np.arange(2, 14)
    spk = np.zeros((CFG.hidden_size,), np.float32)
    pj = jtalker.build_prefill(qparams, CFG, jnp.asarray(tokens), jnp.int32(12),
                               jnp.asarray(spk), jnp.int32(CFG.english_language_id))
    pp = ptalker.build_prefill(port, CFG, torch.from_numpy(tokens), 12, torch.from_numpy(spk),
                               CFG.english_language_id)
    np.testing.assert_allclose(pp.prefill_embd.numpy(), np.asarray(pj.prefill_embd),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pp.trailing.numpy(), np.asarray(pj.trailing), rtol=TOL, atol=TOL)
    assert pp.trailing_len == int(pj.trailing_len)
    kv_j = jtalker.make_kv_cache(CFG, C, jnp.float32)
    hj, lj, kv_j = jtalker.talker_prefill(qparams, CFG, pj.prefill_embd, kv_j)
    kv_t = ptalker.make_kv_cache(CFG, C, torch.float32)
    ht, lt = ptalker.talker_prefill(port, CFG, pp.prefill_embd, kv_t)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kv_t.numpy(), np.asarray(kv_j), rtol=TOL, atol=TOL)


def test_plain_forward_step_matches_jax(setup):
    """The port's dense forward_step (the tests' plain step) on the same
    int8 weights as the JAX XLA step."""
    from qwen3tts_tpu.models.talker import core_config
    from qwen3tts_tpu.models.transformer_core import forward_step as jforward_step

    qparams, port, kv, x, _ = setup
    hj, kv_j = jforward_step(qparams.blocks, core_config(CFG), jnp.asarray(x), jnp.int32(7),
                             jnp.asarray(kv))
    kv_t = torch.from_numpy(kv.copy())
    ht = forward_step(port.blocks, CFG, torch.from_numpy(x), 7, kv_t)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kv_t.numpy(), np.asarray(kv_j), rtol=TOL, atol=TOL)
