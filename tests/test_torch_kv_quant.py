"""The int8-KV tier's operands at the tiny configuration against the JAX
package: ``quantize_kv`` bit for bit, and the plain K1 and K5 over the (q,
scale) cache against the Pallas ``fused_talker_step_hbm`` and
``fused_talker_step_batched`` with their ``kv_int8`` operand, in interpret
mode. The same numpy inputs; weights cross over through io/from_jax.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.ops import kv_quant as jkvq
from qwen3tts_tpu.ops import pallas_talker_step as jpts
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops.fused_talker_step import (fused_talker_step,
                                                      fused_talker_step_batched)
from qwen3tts_tpu_torch.ops.kv_quant import (dequantize_kv, is_quantized_kv, quantize_cache,
                                             quantize_kv)

CFG = tiny_pipeline_config().talker
C, B = 32, 3
# float32 end to end. The port folds the current row in and divides the sum
# out last, as the Pallas kernels' online softmax does over one chunk (every
# C here fits one), so K1's bf16 rounding of e * v_scale meets the same
# values; what is left is the order and precision of the sums (float64 in
# the port): up to 1.2e-6 in the hidden and logits here. (Normalizing p
# before that rounding, as the bf16-KV K1 does, moved the hidden by 2e-2 at
# n_past = 31 and flipped 14 values of the new int8 rows.)
TOL = 1e-4


def _rows():
    """Rows with all-zero rows, exact ties at x / scale = k + 0.5, and
    bf16-rounded values, [6, 8]."""
    rng = np.random.default_rng(3)
    r = rng.normal(size=(6, 8)).astype(np.float32)
    r[1] = 0.0
    r[2] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -126.5], np.float32)
    r[3] = -r[2]
    r[4] = np.asarray(jnp.asarray(r[4] * 7.3).astype(jnp.bfloat16).astype(jnp.float32))
    r[5, :] = 1e-12
    return r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax_bit_for_bit(dtype):
    """q and scale equal JAX's bit for bit on rows with zeros, ties and
    bf16-rounded inputs, float32 and bf16; dequantize round-trips."""
    x = np.stack([_rows(), _rows() * 1000.0, _rows() * 1e-3])           # [3, 6, 8]
    jq, js = jkvq.quantize_kv(jnp.asarray(x).astype(dtype))
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = quantize_kv(t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and is_quantized_kv((q, s))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(
        dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(jkvq.dequantize_kv(jq, js, jnp.float32)))


def test_quantize_cache_equals_quantize_kv_of_the_padded_cache():
    """The prefill window quantized into a cache of C rows: the bits of
    quantize_kv over the zero-padded cache, unwritten rows included."""
    rng = np.random.default_rng(4)
    win = rng.normal(size=(2, 2, 3, 5, 8)).astype(np.float32)
    full = np.zeros((2, 2, 3, 12, 8), np.float32)
    full[..., :5, :] = win
    q, s = quantize_cache(torch.from_numpy(win).to(torch.bfloat16), 12)
    wq, ws = quantize_kv(torch.from_numpy(full).to(torch.bfloat16))
    assert torch.equal(q, wq) and torch.equal(s.view(torch.int32), ws.view(torch.int32))


@pytest.fixture(scope="module")
def setup():
    params = jtalker.init_talker_params(jax.random.PRNGKey(5), CFG, jnp.float32)
    qparams = params._replace(blocks=quantize_block_params(params.blocks))
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, qparams))
    rng = np.random.default_rng(29)
    kv = (rng.normal(size=(B, CFG.n_layers, 2, CFG.n_kv_heads, C, CFG.head_dim)) * 0.5
          ).astype(np.float32)
    jq, js = jkvq.quantize_kv(jnp.asarray(kv).astype(jnp.bfloat16))
    x = rng.normal(size=(B, CFG.hidden_size)).astype(np.float32)
    seen = rng.random((B, CFG.codec_vocab_size)) < 0.05
    return qparams, port, (np.asarray(jq), np.asarray(js)), x, seen


def _pair(q, s):
    return torch.from_numpy(q.copy()), torch.from_numpy(s.copy())


def _check_rows(q_t, s_t, kv_j):
    """The whole (q, scale) cache after the step equals JAX's: the new rows
    at n_past bit for bit, the others untouched (the JAX kernels scatter
    the row, the port writes it in place)."""
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(kv_j[0]))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(kv_j[1]))


SAMPLING = dict(top_k=50, suppress_start=2048, repetition_penalty=1.05, use_top_p=False)


@pytest.mark.parametrize("n_past", [0, 7, 31])
def test_single_step_int8_kv_matches_jax(setup, n_past):
    """Plain K1 over the int8 pair against ``fused_talker_step_hbm`` with
    ``kv_int8`` (the pipelined variant the JAX loop runs, interpret):
    hidden and logits within TOL, the whole (q, scale) cache equal after
    the step (the new rows are quantized from the same bf16 row), greedy
    and sampled cb0 equal."""
    qparams, port, (q, s), x, seen = setup

    def jax_step(**kw):
        return jpts.fused_talker_step_hbm(
            qparams.blocks, CFG, jnp.asarray(x[0]), jnp.int32(n_past),
            (jnp.asarray(q[0]), jnp.asarray(s[0])), output_norm=qparams.output_norm,
            codec_head=qparams.codec_head, chunk=8, variant="pipelined", interpret=True, **kw)

    def port_step(kv, **kw):
        return fused_talker_step(port.blocks, CFG, torch.from_numpy(x[0]), n_past, kv,
                                 output_norm=port.output_norm, codec_head=port.codec_head, **kw)

    hid, logits, kv_j = jax_step()
    kv_t = _pair(q[0], s[0])
    out = port_step(kv_t)
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(hid), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(logits), rtol=TOL, atol=TOL)
    _check_rows(*kv_t, kv_j)
    for greedy, seed in ((True, 0), (False, 11)):
        kw = dict(SAMPLING, eos_id=CFG.codec_eos_id, temperature=0.0 if greedy else 0.9,
                  greedy=greedy)
        _, cb0_j, _ = jax_step(seen=jnp.asarray(seen[0]), seeds=jnp.int32(seed), **kw)
        o = port_step(_pair(q[0], s[0]), seen=torch.from_numpy(seen[0]), seed=seed, **kw)
        assert int(o.cb0[0]) == int(cb0_j), greedy


@pytest.mark.parametrize("n_past", [0, 19])
def test_batched_step_int8_kv_matches_jax(setup, n_past):
    """Plain K5 over the batch-major int8 pair against
    ``fused_talker_step_batched`` with ``kv_int8`` (interpret) at B = 3:
    hidden and logits within TOL, the (q, scale) cache equal, each lane's
    greedy and sampled cb0 equal."""
    qparams, port, (q, s), x, seen = setup

    def jax_step(**kw):
        return jpts.fused_talker_step_batched(
            qparams.blocks, CFG, jnp.asarray(x), jnp.int32(n_past),
            (jnp.asarray(q), jnp.asarray(s)), output_norm=qparams.output_norm,
            codec_head=qparams.codec_head, interpret=True, **kw)

    def port_step(kv, **kw):
        return fused_talker_step_batched(port.blocks, CFG, torch.from_numpy(x), n_past, kv,
                                         output_norm=port.output_norm,
                                         codec_head=port.codec_head, **kw)

    hid, logits, kv_j = jax_step()
    kv_t = _pair(q, s)
    out = port_step(kv_t)
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(hid), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(logits), rtol=TOL, atol=TOL)
    _check_rows(*kv_t, kv_j)
    seeds = np.array([5, -77, 123457], np.int32)
    for greedy in (True, False):
        kw = dict(SAMPLING, eos_id=CFG.codec_eos_id, temperature=0.0 if greedy else 0.9,
                  greedy=greedy)
        _, cb0_j, _ = jax_step(seen=jnp.asarray(seen), seeds=jnp.asarray(seeds), **kw)
        o = port_step(_pair(q, s), seen=torch.from_numpy(seen),
                      seeds=torch.from_numpy(seeds), **kw)
        np.testing.assert_array_equal(o.cb0.numpy(), np.asarray(cb0_j).reshape(-1))


def test_batched_step_refuses_start_with_the_int8_cache(setup):
    """K5's wrapper refuses `start` with an int8 cache, on the CPU as on the
    card (the JAX package never combines them)."""
    _, port, (q, s), x, _ = setup
    with pytest.raises(ValueError, match="start"):
        fused_talker_step_batched(port.blocks, CFG, torch.from_numpy(x), 5, _pair(q, s),
                                  output_norm=port.output_norm, codec_head=port.codec_head,
                                  start=torch.zeros(B, dtype=torch.int32))
