"""Kernel K6's plain version against the JAX package's batched fused code
predictor (w8a8, interpret mode) at the tiny configuration, and against the
port's single-stream K2 lane by lane."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.ops.pallas_code_predictor_batched import (
    fused_predict_codes_batched as jfused_batched)
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.ops.fused_code_predictor import fused_predict_codes
from qwen3tts_tpu_torch.ops.fused_code_predictor_batched import fused_predict_codes_batched

CFG = tiny_pipeline_config().code_predictor
SEEDS = [17, -1234567, 900001]
MODES = {
    "greedy": dict(greedy=True, use_top_p=False, temperature=0.0, top_p=1.0, top_k=50),
    "sampled": dict(greedy=False, use_top_p=False, temperature=0.9, top_p=1.0, top_k=50),
    "sampled_topp": dict(greedy=False, use_top_p=True, temperature=0.9, top_p=0.95, top_k=50),
}


@pytest.fixture(scope="module")
def setup():
    params = jcp.init_code_predictor_params(jax.random.PRNGKey(7), CFG, jnp.float32)
    qparams = params._replace(blocks=quantize_block_params(params.blocks))
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, qparams))
    rng = np.random.default_rng(23)
    th = rng.normal(size=(len(SEEDS), CFG.hidden_size)).astype(np.float32)
    cb0 = rng.normal(size=(len(SEEDS), CFG.hidden_size)).astype(np.float32)
    return qparams, port, th, cb0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batched_codes_and_rest_sum_match_jax_w8a8(setup, mode):
    """Codes equal lane for lane (greedy, and sampled with per-lane seeds);
    rest_sum — a float32 sum of 15 embedding rows — within 1e-4."""
    qparams, port, th, cb0 = setup
    kw = MODES[mode]
    codes_j, sum_j = jfused_batched(qparams, CFG, jnp.asarray(th), jnp.asarray(cb0),
                                    jnp.asarray(SEEDS, jnp.int32), mode="w8a8",
                                    interpret=True, **kw)
    codes_t, sum_t = fused_predict_codes_batched(port, CFG, torch.from_numpy(th),
                                                 torch.from_numpy(cb0), SEEDS, **kw)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(sum_t.numpy(), np.asarray(sum_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_lane_equals_single_stream_k2(setup, mode):
    """Lane b equals the port's single-stream K2 with seed SEEDS[b]: the
    same codes, and the same rest_sum bit for bit (float32 weights, so K6's
    KV rows stored in the embedding dtype are K2's float32 rows)."""
    _, port, th, cb0 = setup
    kw = MODES[mode]
    codes_b, sum_b = fused_predict_codes_batched(port, CFG, torch.from_numpy(th),
                                                 torch.from_numpy(cb0), SEEDS, **kw)
    for b, seed in enumerate(SEEDS):
        codes_1, sum_1 = fused_predict_codes(port, CFG, torch.from_numpy(th[b]),
                                             torch.from_numpy(cb0[b]), seed, **kw)
        np.testing.assert_array_equal(codes_b[b].numpy(), codes_1.numpy(), err_msg=f"lane {b}")
        np.testing.assert_array_equal(sum_b[b].numpy(), sum_1.numpy(), err_msg=f"lane {b}")


def test_batched_lane_cap(setup):
    """More than 64 lanes raise: the decode loop runs larger batches in
    groups."""
    _, port, _, _ = setup
    h = torch.zeros((65, CFG.hidden_size))
    with pytest.raises(ValueError, match="lanes"):
        fused_predict_codes_batched(port, CFG, h, h, [0] * 65, **MODES["greedy"])
