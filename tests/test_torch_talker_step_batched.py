"""Kernel K5's plain version against the JAX package's batched fused talker
step (w8a8, batch-major, interpret mode) at the tiny configuration: the same
numpy inputs for B = 4 lanes, weights crossing over through io/from_jax.py."""

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
from qwen3tts_tpu_torch.ops.fused_talker_step import fused_talker_step_batched

CFG = tiny_pipeline_config().talker
B, C = 4, 32
# float32 end to end: the versions differ only in the order and precision
# of their sums (dense against online softmax; the port sums in float64),
# and the int8 activation roundings agree on these inputs.
TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    params = jtalker.init_talker_params(jax.random.PRNGKey(5), CFG, jnp.float32)
    qparams = params._replace(blocks=quantize_block_params(params.blocks))
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, qparams))
    rng = np.random.default_rng(19)
    kv = (rng.normal(size=(B, CFG.n_layers, 2, CFG.n_kv_heads, C, CFG.head_dim)) * 0.5
          ).astype(np.float32)
    x = rng.normal(size=(B, CFG.hidden_size)).astype(np.float32)
    seen = rng.random((B, CFG.codec_vocab_size)) < 0.05
    return qparams, port, kv, x, seen


def _jax_step(qparams, kv, x, n_past, **kw):
    return jpts.fused_talker_step_batched(
        qparams.blocks, CFG, jnp.asarray(x), jnp.int32(n_past), jnp.asarray(kv),
        output_norm=qparams.output_norm, codec_head=qparams.codec_head, mode="w8a8",
        chunk=8, interpret=True, **kw)


def _port_step(port, kv_t, x, n_past, **kw):
    return fused_talker_step_batched(port.blocks, CFG, torch.from_numpy(x), n_past, kv_t,
                                     output_norm=port.output_norm,
                                     codec_head=port.codec_head, **kw)


@pytest.mark.parametrize("n_past", [0, 7, 31])
def test_batched_step_matches_jax_w8a8(setup, n_past):
    """Hidden, logits and the whole cache (each lane's row at n_past
    written) within 1e-4."""
    qparams, port, kv, x, _ = setup
    hid, logits, kv_j = _jax_step(qparams, kv, x, n_past)
    kv_t = torch.from_numpy(kv.copy())
    out = _port_step(port, kv_t, x, n_past)
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(hid), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kv_t.numpy(), np.asarray(kv_j), rtol=TOL, atol=TOL)
    assert out.cb0 is None


@pytest.mark.parametrize("n_past", [0, 7, 31])
def test_batched_cb0_epilogue_matches_jax(setup, n_past):
    """cb0 equal lane for lane for greedy and for two sets of per-lane
    seeds (temperature 0.9, top-k 50, penalty 1.05 over each lane's
    seen-set, suppression of [2048, 3072) except EOS)."""
    qparams, port, kv, x, seen = setup
    common = dict(top_k=50, suppress_start=2048, eos_id=CFG.codec_eos_id,
                  repetition_penalty=1.05, use_top_p=False)
    for greedy, seeds in ((True, [0, 0, 0, 0]), (False, [11, -123457, 2 ** 31 - 1, 5]),
                          (False, [900001, 17, -1, 42])):
        temp = 0.0 if greedy else 0.9
        _, cb0_j, _ = _jax_step(qparams, kv, x, n_past, seen=jnp.asarray(seen),
                                seeds=jnp.asarray(seeds, jnp.int32), temperature=temp,
                                greedy=greedy, **common)
        out = _port_step(port, torch.from_numpy(kv.copy()), x, n_past,
                         seen=torch.from_numpy(seen), seeds=torch.tensor(seeds),
                         temperature=temp, greedy=greedy, **common)
        np.testing.assert_array_equal(out.cb0.numpy(), np.asarray(cb0_j),
                                      err_msg=f"greedy={greedy} seeds={seeds}")


def test_batched_lane_cap(setup):
    """More lanes than the kernel takes raise before any work."""
    _, port, _, _, _ = setup
    x = torch.zeros((129, CFG.hidden_size))
    with pytest.raises(ValueError, match="lanes"):
        fused_talker_step_batched(port.blocks, CFG, x, 0, torch.zeros(1),
                                  output_norm=port.output_norm, codec_head=port.codec_head)
