"""The port's plain ops against the JAX package on the same numpy inputs:
norms, NEOX rope, int8 quantization, the counter-hash noise and the sampler
(kernel K4's plain version)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import reference_impl as ref
from qwen3tts_tpu.ops import kernel_prng as jprng
from qwen3tts_tpu.ops import norms as jnorms
from qwen3tts_tpu.ops import quant as jquant
from qwen3tts_tpu.ops import rope as jrope
from qwen3tts_tpu.ops import sampling as jsampling
from qwen3tts_tpu_torch.ops import kernel_prng, norms, quant, rope, sampling

# f32 elementwise math and short reductions: the two frameworks differ in
# summation order and transcendental rounding by a few ulps only.
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_and_layer_norm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        norms.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        norms.layer_norm(_t(x), _t(w), _t(b), 1e-6).numpy(),
        np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6)),
        rtol=TOL, atol=TOL)


def test_neox_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 4, 16)).astype(np.float32)
    pos = np.arange(3, 10, dtype=np.int32)
    cos, sin = rope.rope_for_positions(torch.from_numpy(pos), 16, 1e6)
    jcos, jsin = jrope.rope_for_positions(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        rope.apply_rope(_t(x), cos, sin).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jcos, jsin)), rtol=TOL, atol=TOL)


def test_rope_table_rows_equal_single_positions():
    """The fused wrappers read cos/sin rows of one cached table; each row is
    bit-equal to the angles of its position alone (float32 elementwise)."""
    from qwen3tts_tpu_torch.ops.fused_talker_step import rope_table

    cos_t, sin_t = rope_table(40, 16, 1e6, torch.device("cpu"))
    for p in (0, 7, 39):
        cos, sin = rope.rope_angles(torch.tensor([p]), 16, 1e6)
        assert torch.equal(cos_t[p], cos[0]) and torch.equal(sin_t[p], sin[0])


def test_int8_quantization_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 48, 40)).astype(np.float32)
    w[1, :, 5] = 0.0                      # an all-zero channel takes scale 1
    got = quant.quantize_per_channel(_t(w))
    want = jquant.quantize_per_channel(jnp.asarray(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=TOL, atol=0)
    np.testing.assert_allclose(
        quant.dequantize(got).numpy(), np.asarray(jquant.dequantize(want)), rtol=TOL, atol=TOL)
    x = rng.normal(size=(6, 48)).astype(np.float32)
    np.testing.assert_allclose(
        quant.matmul(_t(x), quant.QuantLinear(got.q[0], got.scale[0])).numpy(),
        np.asarray(jquant.matmul(jnp.asarray(x), jquant.QuantLinear(want.q[0], want.scale[0]))),
        rtol=1e-4, atol=1e-4)


def test_gumbel_noise_matches_reference_bit_for_bit():
    """The 24-bit integer uniforms are bit-exact with the NumPy mirror of the
    JAX kernel's hash; the float Gumbel transform agrees at 1e-4 (as
    tests/test_kernel_prng.py allows for the JAX kernel itself)."""
    seeds = np.array([[3], [-17], [123456789], [0], [-2 ** 31], [2 ** 31 - 1]], np.int64)
    shape = (6, 3072)
    u = kernel_prng.uniform24(torch.from_numpy(seeds), 7, shape).numpy()
    g_ref = ref.gumbel_noise_ref(seeds, 7, shape)
    u_ref = np.rint((np.exp(-np.exp(-g_ref)) - 1e-12) * (1 << 24)).astype(np.int64)
    np.testing.assert_array_equal(u, u_ref)
    g = kernel_prng.gumbel_noise(torch.from_numpy(seeds), 7, shape).numpy()
    np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-4)


def _jax_sampler_in_kernel(logits, seeds, step, *, temp, top_p, top_k, greedy, use_top_p):
    """JAX's make_sampler inside an interpret-mode pallas_call (as
    tests/test_kernel_prng.py runs gumbel_noise)."""
    R, V = logits.shape
    sample = jprng.make_sampler(top_k, V, greedy=greedy, use_top_p=use_top_p)

    def kern(l_ref, s_ref, o_ref):
        o_ref[...] = sample(l_ref[...], jnp.float32(temp), jnp.float32(top_p), s_ref[...],
                            jnp.int32(step))

    out = pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R, 1), jnp.int32),
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(logits), jnp.asarray(seeds.reshape(R, 1), jnp.int32))
    return np.asarray(out)[:, 0]


@pytest.mark.parametrize("mode", ["greedy", "topk50", "topk50_topp09"])
def test_sampler_matches_jax_kernel_sampler(mode):
    """Tokens equal on 8 seeds (one row each, R=8) for greedy, top-k 50 and
    top-k 50 + top-p 0.9, on cb0-sized rows after suppression."""
    greedy = mode == "greedy"
    use_top_p = mode.endswith("topp09")
    temp, top_p = (0.0, 1.0) if greedy else (0.9, 0.9 if use_top_p else 1.0)
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(8, 3072)) * 2.5).astype(np.float32)
    logits[:, 2048:] = -1e30                  # the cb0 suppression, EOS aside
    logits[:, 2150] = 1.0
    seeds = np.arange(8, dtype=np.int32) * 7919 - 11
    want = _jax_sampler_in_kernel(logits, seeds, 3, temp=temp, top_p=top_p, top_k=50,
                                  greedy=greedy, use_top_p=use_top_p)
    got = sampling.sample_rows_plain(
        _t(logits), torch.from_numpy(seeds), 3, temperature=temp, top_p=top_p, top_k=50,
        greedy=greedy, use_top_p=use_top_p).numpy()
    np.testing.assert_array_equal(got, want)
    if not greedy:
        assert len(set(got.tolist())) > 1, "different seeds should draw differently"


def test_suppression_and_penalty_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3072,)).astype(np.float32)
    seen = rng.random(3072) < 0.1
    got = sampling.apply_repetition_penalty(
        sampling.apply_suppression(_t(logits), 2048, 2150), torch.from_numpy(seen), 1.05)
    want = jsampling.apply_repetition_penalty(
        jsampling.apply_suppression(jnp.asarray(logits), 2048, 2150), jnp.asarray(seen), 1.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
