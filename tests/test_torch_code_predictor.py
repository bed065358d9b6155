"""Kernel K2's plain version against the JAX package's fused code predictor
(w8a8, interpret mode) at the tiny configuration, and the weight seam for
bfloat16 leaves."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.ops.pallas_code_predictor import fused_predict_codes as jfused
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops.fused_code_predictor import fused_predict_codes

CFG = tiny_pipeline_config().code_predictor


@pytest.fixture(scope="module")
def setup():
    params = jcp.init_code_predictor_params(jax.random.PRNGKey(7), CFG, jnp.float32)
    qparams = params._replace(blocks=quantize_block_params(params.blocks))
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, qparams))
    rng = np.random.default_rng(3)
    th = rng.normal(size=(CFG.hidden_size,)).astype(np.float32)
    cb0 = rng.normal(size=(CFG.hidden_size,)).astype(np.float32)
    return qparams, port, th, cb0


@pytest.mark.parametrize("mode", ["greedy", "sampled", "sampled_topp"])
def test_codes_and_rest_sum_match_jax_w8a8(setup, mode):
    """Codes equal (greedy, and sampled with the same seed); rest_sum — a
    float32 sum of 15 embedding rows — within 1e-5."""
    qparams, port, th, cb0 = setup
    kw = dict(greedy=mode == "greedy", use_top_p=mode == "sampled_topp",
              temperature=0.0 if mode == "greedy" else 0.9,
              top_p=0.9 if mode == "sampled_topp" else 1.0, top_k=50)
    seed = {"greedy": 0, "sampled": 1234, "sampled_topp": -77}[mode]
    codes_j, sum_j = jfused(qparams, CFG, jnp.asarray(th), jnp.asarray(cb0), jnp.int32(seed),
                            mode="w8a8", interpret=True, **kw)
    codes_t, sum_t = fused_predict_codes(port, CFG, torch.from_numpy(th),
                                         torch.from_numpy(cb0), seed, **kw)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(sum_t.numpy(), np.asarray(sum_j), rtol=1e-5, atol=1e-5)


def test_bf16_leaves_cross_the_seam_unchanged():
    """ml_dtypes.bfloat16 arrays become torch.bfloat16 bit for bit, and the
    int8 q / float32 scale leaves are carried across without re-quantizing."""
    params = jcp.init_code_predictor_params(jax.random.PRNGKey(1), CFG, jnp.bfloat16)
    qparams = params._replace(blocks=quantize_block_params(params.blocks))
    np_tree = jax.tree_util.tree_map(np.asarray, qparams)
    port = params_from_jax(np_tree)
    assert port.embds.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.embds.view(torch.int16).numpy(),
                                  np_tree.embds.view(np.int16))
    assert port.blocks.wqkv.q.dtype == torch.int8
    np.testing.assert_array_equal(port.blocks.wqkv.q.numpy(), np_tree.blocks.wqkv.q)
    np.testing.assert_array_equal(port.blocks.wqkv.scale.numpy(), np_tree.blocks.wqkv.scale)
