"""Kernel K3's plain version against the JAX res-block kernel (interpret
mode), and the port's vocoder against the JAX float32 XLA vocoder, stage by
stage and at the output, at the tiny configuration."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import vocoder as jvoc
from qwen3tts_tpu.ops import norms as jnorms
from qwen3tts_tpu.ops.pallas_vocoder import fused_res_block as jres
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.models import vocoder as pvoc
from qwen3tts_tpu_torch.ops.fused_vocoder import fused_res_block

VCFG = tiny_pipeline_config().vocoder


def _t(a):
    return torch.from_numpy(np.array(a))


def _res_inputs(seed, T, C):
    rng = np.random.default_rng(seed)
    sc = 1.0 / np.sqrt(7 * C)
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    return f(T, C), (f(7, C, C) * sc, f(C) * 0.1, f(C) * 0.1, f(C) * 0.1,
                     f(1, C, C) * sc * 2, f(C) * 0.1, f(C) * 0.1, f(C) * 0.1)


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_res_block_matches_jax_kernel(dilation):
    """T=192 over 64-row tiles (the d=9 halo spans most of a tile); both
    float32, within 2e-5 as tests/test_pallas_vocoder.py allows."""
    x, ws = _res_inputs(dilation, 192, 16)
    want = jres(jnp.asarray(x), *map(jnp.asarray, ws), dilation=dilation, tile=64,
                interpret=True)
    got = fused_res_block(torch.from_numpy(x), *map(torch.from_numpy, ws), dilation=dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def voc():
    params = jvoc.init_vocoder_params(jax.random.PRNGKey(3), VCFG, jnp.float32)
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    codes = np.random.default_rng(4).integers(0, VCFG.codebook_size, size=(8, 16)).astype(
        np.int32)
    return params, port, codes


# Snake stages amplify reassociation (ROADMAP queue 3): each stage is fed
# the JAX stage's own input and held at 5e-3 relative / 5e-4 absolute, the
# bound tests/test_pallas_vocoder.py uses for two float32 orderings.
RTOL, ATOL = 5e-3, 5e-4


def test_vocoder_stages_match_jax(voc):
    params, port, codes = voc
    cj = jnp.asarray(codes)
    first = params.vq_first_cb[cj[:, 0]]
    rest = params.vq_rest_cb[jnp.arange(15), cj[:, 1:]]
    latent = first @ params.vq_first_proj + jnp.sum(rest, axis=1) @ params.vq_rest_proj
    x = jvoc.conv1d(latent, params.pre_conv_w, params.pre_conv_b, causal=True)
    x = x @ params.pt_in_w + params.pt_in_b
    pt_j = jvoc._pre_transformer(params, VCFG, x, jnp.int32(8))
    pt_t = pvoc._pre_transformer(port, VCFG, _t(x), 8)
    np.testing.assert_allclose(pt_t.numpy(), np.asarray(pt_j), rtol=RTOL, atol=ATOL)

    x = jnorms.rms_norm(pt_j, params.pt_norm, VCFG.rms_norm_eps)
    x = x @ params.pt_out_w + params.pt_out_b
    for i in range(VCFG.n_convnext):
        yj = jvoc._convnext_block(x, params.convnext, i, "causal")
        yt = pvoc._convnext_block(_t(x), port.convnext, i)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL)
        x = yj
    x = jvoc.conv1d(x, params.dec0_w, params.dec0_b, causal=True)
    for b, (blk, rate) in enumerate(zip(params.dec_blocks, VCFG.upsample_rates)):
        yj = jvoc._decoder_block(x, blk, rate, VCFG.res_dilations, "causal")
        yt = pvoc._decoder_block(_t(x), port.dec_blocks[b], rate, VCFG.res_dilations)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL, atol=ATOL,
                                   err_msg=f"decoder block {b}")
        x = yj


def test_vocoder_output_matches_jax(voc):
    params, port, codes = voc
    want = np.asarray(jvoc.vocoder_forward(params, VCFG, jnp.asarray(codes), jnp.int32(8)))
    got = pvoc.vocoder_decode(port, VCFG, torch.from_numpy(codes), 8).numpy()
    assert got.shape == (8 * VCFG.samples_per_frame,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
