"""The port's u4 quantization and the tier policies against the JAX
package's (``qwen3tts_tpu/ops/quant.py``, ``ops/quantized_matmul.py``): the
same numpy weights through both."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.ops import quant as jquant
from qwen3tts_tpu.ops import quantized_matmul as jqmm
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops import quant

CFG = tiny_pipeline_config().talker
# (K, N): a real projection's group of 32, and tiny shapes whose K/2 the
# group does not divide (gcd rule: 24 -> gs 8, 6 -> gs 2), with a layer axis
SHAPES = [(128, 16), (48, 8), (12, 4)]


def _w(K, N, seed, lead=()):
    return np.random.default_rng(seed).normal(size=lead + (K, N)).astype(np.float32)


@pytest.mark.parametrize("K,N", SHAPES)
def test_quantize_w4_dequantize_unpack_equal_jax_bit_for_bit(K, N):
    w = _w(K, N, K + N, lead=(2,))
    want = jquant.quantize_w4(jnp.asarray(w))
    got = quant.quantize_w4(torch.from_numpy(w))
    assert quant._w4_group_size(K) == jquant._w4_group_size(K)
    assert got.scale.shape[-2] == K // quant._w4_group_size(K)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.zero.numpy(), np.asarray(want.zero))
    np.testing.assert_array_equal(quant.dequantize4(got).numpy(),
                                  np.asarray(jquant.dequantize4(want)))
    for a, b in zip(quant.unpack4(got.q), jqmm.unpack4(want.q)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert quant.weight_in_dim(got) == jqmm.weight_in_dim(want) == K


@pytest.mark.parametrize("tier", ["int8", "q4", "q4pure"])
def test_quantize_talker_blocks_gives_the_jax_leaf_types(tier):
    params = jtalker.init_talker_params(jax.random.PRNGKey(3), CFG, jnp.float32)
    want = jquant.quantize_talker_blocks(params.blocks, tier)
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    got = quant.quantize_talker_blocks(port.blocks, tier)
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        w, j = getattr(got, name), getattr(want, name)
        assert type(w).__name__ == type(j).__name__, name
        for a, b in zip(w, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unknown_tier_raises_in_both():
    blocks = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jtalker.init_talker_params(jax.random.PRNGKey(3), CFG, jnp.float32))).blocks
    with pytest.raises(ValueError, match="fp8"):
        quant.quantize_talker_blocks(blocks, "fp8")
    with pytest.raises(ValueError, match="fp8"):
        jquant.quantize_talker_blocks(None, "fp8")


@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("rows", [1, 3])
def test_matmul_on_quantlinear4_matches_jax(K, N, rows):
    """quant.matmul's grouped u4 product against quantized_matmul.matmul on
    float32 x, within 1e-5 (summation order only). bf16 x is not compared:
    XLA on the CPU has no bf16 x bf16 -> float32 dot."""
    w = _w(K, N, 7 * K)
    x = np.random.default_rng(K + rows).normal(size=(rows, K)).astype(np.float32)
    want = np.asarray(jqmm.matmul(jnp.asarray(x), jquant.quantize_w4(jnp.asarray(w))))
    got = quant.matmul(torch.from_numpy(x), quant.quantize_w4(torch.from_numpy(w))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_params_from_jax_carries_quantlinear4_unchanged():
    params = jtalker.init_talker_params(jax.random.PRNGKey(4), CFG, jnp.float32)
    qparams = params._replace(blocks=jquant.quantize_block_params_mixed(params.blocks))
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, qparams))
    assert isinstance(port.blocks.w_gateup, quant.QuantLinear4)
    assert isinstance(port.blocks.wqkv, quant.QuantLinear)
    for a, b in zip(port.blocks.w_down, qparams.blocks.w_down):
        assert a.dtype == {"int8": torch.int8, "float32": torch.float32}[str(b.dtype)]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
