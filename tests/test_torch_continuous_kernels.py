"""The pieces of continuous serving against the JAX package's, at the tiny
configuration on the same numpy inputs: K5 with ``start`` and per-lane
sampling, K6 with per-lane sampling (plain versions against the Pallas
kernels in interpret mode), the per-row samplers, decode attention with
``start``, the refill's window prefill, and compaction."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from qwen3tts_tpu.config import tiny_pipeline_config
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtalker
from qwen3tts_tpu.ops import attention as jattn
from qwen3tts_tpu.ops import kernel_prng as jprng
from qwen3tts_tpu.ops import pallas_talker_step as jpts
from qwen3tts_tpu.ops import sampling as jsampling
from qwen3tts_tpu.ops.pallas_code_predictor_batched import (
    fused_predict_codes_batched as jfused_cp_batched)
from qwen3tts_tpu.ops.quant import quantize_block_params
from qwen3tts_tpu.runtime import continuous as jcont
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.models import talker as ptalker
from qwen3tts_tpu_torch.ops import attention as pattn
from qwen3tts_tpu_torch.ops import sampling
from qwen3tts_tpu_torch.ops.fused_code_predictor_batched import fused_predict_codes_batched
from qwen3tts_tpu_torch.ops.fused_talker_step import fused_talker_step_batched
from qwen3tts_tpu_torch.runtime import continuous as pcont

CFG = tiny_pipeline_config()
TCFG, CCFG = CFG.talker, CFG.code_predictor
B, C, N_PAST = 4, 32, 20
# lane 3 is a done lane: start = n_past, only its own row
STARTS = [0, 7, 16, N_PAST]
TEMPS = np.array([0.7, 1.0, 1.3, 0.9], np.float32)
TOPPS = np.array([0.8, 1.0, 0.95, 0.9], np.float32)
PENS = np.array([1.0, 1.05, 1.3, 1.1], np.float32)
# float32 end to end: the versions differ only in the order and precision of
# their sums (the port sums in float64), as in test_torch_talker_step_batched
TOL = 1e-4


def _to_np(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def talker():
    params = jtalker.init_talker_params(jax.random.PRNGKey(5), TCFG, jnp.float32)
    qparams = params._replace(blocks=quantize_block_params(params.blocks))
    rng = np.random.default_rng(19)
    kv = (rng.normal(size=(B, TCFG.n_layers, 2, TCFG.n_kv_heads, C, TCFG.head_dim)) * 0.5
          ).astype(np.float32)
    x = rng.normal(size=(B, TCFG.hidden_size)).astype(np.float32)
    seen = rng.random((B, TCFG.codec_vocab_size)) < 0.05
    return params, qparams, params_from_jax(_to_np(qparams)), kv, x, seen


@pytest.mark.parametrize("greedy", [True, False])
def test_k5_start_and_per_lane_sampling_match_jax(talker, greedy):
    """Plain K5 with ``start`` (one lane at start = n_past) and per-lane
    temperature, top-p and penalty against the Pallas K5 with the same
    operands: hidden and the cache within 1e-4, cb0 equal in every lane."""
    _, qparams, port, kv, x, seen = talker
    seeds = [11, -123457, 2 ** 31 - 1, 5]
    temps = np.zeros_like(TEMPS) if greedy else TEMPS
    common = dict(top_k=50, suppress_start=2048, eos_id=TCFG.codec_eos_id, greedy=greedy,
                  use_top_p=not greedy)
    hid_j, cb0_j, kv_j = jpts.fused_talker_step_batched(
        qparams.blocks, TCFG, jnp.asarray(x), jnp.int32(N_PAST), jnp.asarray(kv),
        output_norm=qparams.output_norm, codec_head=qparams.codec_head, mode="w8a8", chunk=8,
        interpret=True, seen=jnp.asarray(seen), seeds=jnp.asarray(seeds, jnp.int32),
        start=jnp.asarray(STARTS, jnp.int32), temperature=jnp.asarray(temps),
        top_p=jnp.asarray(TOPPS), repetition_penalty=jnp.asarray(PENS), **common)
    kv_t = torch.from_numpy(kv.copy())
    out = fused_talker_step_batched(
        port.blocks, TCFG, torch.from_numpy(x), N_PAST, kv_t, output_norm=port.output_norm,
        codec_head=port.codec_head, seen=torch.from_numpy(seen), seeds=torch.tensor(seeds),
        start=torch.tensor(STARTS, dtype=torch.int32), temperature=torch.from_numpy(temps),
        top_p=torch.from_numpy(TOPPS), repetition_penalty=torch.from_numpy(PENS), **common)
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(hid_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kv_t.numpy(), np.asarray(kv_j), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(out.cb0.numpy(), np.asarray(cb0_j))


def test_k5_start_reads_only_the_lanes_rows(talker):
    """Rows below a lane's start change nothing: garbage written there gives
    the same bits; without ``start`` it does not."""
    _, _, port, kv, x, _ = talker
    dirty = kv.copy()
    for b, s in enumerate(STARTS):
        dirty[b, :, :, :, :s] = 1e3
    outs = []
    for cache in (kv, dirty):
        outs.append(fused_talker_step_batched(
            port.blocks, TCFG, torch.from_numpy(x), N_PAST, torch.from_numpy(cache.copy()),
            output_norm=port.output_norm, codec_head=port.codec_head,
            start=torch.tensor(STARTS, dtype=torch.int32)))
    np.testing.assert_array_equal(outs[0].hidden.numpy(), outs[1].hidden.numpy())
    unmasked = fused_talker_step_batched(
        port.blocks, TCFG, torch.from_numpy(x), N_PAST, torch.from_numpy(dirty.copy()),
        output_norm=port.output_norm, codec_head=port.codec_head)
    assert not np.array_equal(unmasked.hidden.numpy(), outs[0].hidden.numpy())


def test_k5_start_min_is_held_to_the_starts(talker):
    """start_min, K5's promise that no lane's start lies below it (the kernel
    skips the attention chunks under it): at the lowest start it changes no
    bit; above a lane's start, or with no ``start`` at all, it is refused."""
    _, _, port, kv, x, _ = talker
    late = torch.tensor([7, 9, 16, N_PAST], dtype=torch.int32)

    def step(**kw):
        return fused_talker_step_batched(
            port.blocks, TCFG, torch.from_numpy(x), N_PAST, torch.from_numpy(kv.copy()),
            output_norm=port.output_norm, codec_head=port.codec_head, **kw)

    np.testing.assert_array_equal(step(start=late, start_min=7).hidden.numpy(),
                                  step(start=late).hidden.numpy())
    with pytest.raises(ValueError, match="start_min 8 lies above the start of lanes \\[0\\]"):
        step(start=late, start_min=8)
    with pytest.raises(ValueError, match="start_min"):
        step(start_min=1)


@pytest.fixture(scope="module")
def code_predictor():
    params = jcp.init_code_predictor_params(jax.random.PRNGKey(7), CCFG, jnp.float32)
    qparams = params._replace(blocks=quantize_block_params(params.blocks))
    rng = np.random.default_rng(23)
    th = rng.normal(size=(B, CCFG.hidden_size)).astype(np.float32)
    cb0 = rng.normal(size=(B, CCFG.hidden_size)).astype(np.float32)
    return qparams, params_from_jax(_to_np(qparams)), th, cb0


@pytest.mark.parametrize("use_top_p", [False, True])
def test_k6_per_lane_sampling_matches_jax(code_predictor, use_top_p):
    """Plain K6 with per-lane temperature and top-p against the Pallas K6
    with the same [B] operands: codes equal lane for lane; rest_sum within
    1e-4."""
    qparams, port, th, cb0 = code_predictor
    seeds = [17, -1234567, 900001, 3]
    kw = dict(top_k=50, greedy=False, use_top_p=use_top_p)
    codes_j, sum_j = jfused_cp_batched(
        qparams, CCFG, jnp.asarray(th), jnp.asarray(cb0), jnp.asarray(seeds, jnp.int32),
        temperature=jnp.asarray(TEMPS), top_p=jnp.asarray(TOPPS), mode="w8a8",
        interpret=True, **kw)
    codes_t, sum_t = fused_predict_codes_batched(
        port, CCFG, torch.from_numpy(th), torch.from_numpy(cb0), seeds,
        temperature=torch.from_numpy(TEMPS), top_p=torch.from_numpy(TOPPS), **kw)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(sum_t.numpy(), np.asarray(sum_j), rtol=TOL, atol=TOL)


def _rows(seed, n=4, V=3072):
    rng = np.random.default_rng(seed)
    l = (rng.normal(size=(n, V)) * 2.5).astype(np.float32)
    l[:, 2048:] = -1e30
    l[:, 2150] = 1.0
    return l


@pytest.mark.parametrize("top_k", [0, 50])
def test_sample_token_per_row_equals_jax(top_k):
    """Per-row temperature and top-p (one value per row, the continuous
    refill's frame-0 draw): row r equals JAX's sample_token with key r and
    row r's values, fed the same Gumbel noise."""
    l = _rows(5)
    keys = [jax.random.PRNGKey(300 + r) for r in range(len(l))]
    want = [int(jsampling.sample_token(k, jnp.asarray(l[r]), temperature=float(TEMPS[r]),
                                       top_k=top_k, top_p=float(TOPPS[r]), greedy=False,
                                       use_top_p=True)) for r, k in enumerate(keys)]
    noise = np.stack([np.asarray(jax.random.gumbel(k, l.shape[1:], jnp.float32)) for k in keys])
    got = sampling.sample_token(torch.from_numpy(l), torch.from_numpy(noise),
                                temperature=torch.from_numpy(TEMPS), top_k=top_k,
                                top_p=torch.from_numpy(TOPPS), greedy=False, use_top_p=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_rows_plain_per_row_equals_jax_kernel_sampler():
    """K4's plain version with per-row temperature, top-p and penalty against
    JAX's make_sampler fed [R, 1] operands inside an interpret-mode
    pallas_call (as the batched Pallas kernels feed it)."""
    l = _rows(9)
    R, V = l.shape
    seen = np.random.default_rng(2).random((R, V)) < 0.05
    seeds = np.array([3, -17, 123456789, 0], np.int32)
    penalized = np.asarray(jsampling.apply_repetition_penalty(
        jnp.asarray(l), jnp.asarray(seen), jnp.asarray(PENS)[:, None]))
    sample = jprng.make_sampler(50, V, greedy=False, use_top_p=True)

    def kern(l_ref, s_ref, t_ref, p_ref, o_ref):
        o_ref[...] = sample(l_ref[...], t_ref[...], p_ref[...], s_ref[...], jnp.int32(0))

    want = pl.pallas_call(
        kern, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 4,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R, 1), jnp.int32), interpret=pltpu.InterpretParams(),
    )(jnp.asarray(penalized), jnp.asarray(seeds[:, None]), jnp.asarray(TEMPS[:, None]),
      jnp.asarray(TOPPS[:, None]))
    got = sampling.sample_rows_plain(
        torch.from_numpy(l), torch.from_numpy(seeds), 0, temperature=torch.from_numpy(TEMPS),
        top_p=torch.from_numpy(TOPPS), top_k=50, greedy=False, use_top_p=True,
        seen=torch.from_numpy(seen), repetition_penalty=torch.from_numpy(PENS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, 0])


def test_per_row_scalars_keep_working():
    """A scalar where a row value can go gives what a row of equal values
    gives."""
    l = torch.from_numpy(_rows(11))
    noise = torch.rand(l.shape)
    a = sampling.sample_token(l, noise, temperature=0.8, top_k=50, top_p=0.9)
    b = sampling.sample_token(l, noise, temperature=torch.full((4,), 0.8), top_k=50,
                              top_p=torch.full((4,), 0.9), greedy=False, use_top_p=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("C_", [32, 1024])
def test_decode_attention_with_start_matches_jax(C_):
    """decode_attention_auto with per-lane ``start`` against JAX's XLA
    decode_attention lane by lane (-1e30 below start), within 1e-5; at C =
    1024 too, where without ``start`` the decode-attention kernel would run:
    with it the port keeps the XLA semantics, as JAX does."""
    rng = np.random.default_rng(4)
    Hq, Hkv, D, n_valid = TCFG.n_heads, TCFG.n_kv_heads, TCFG.head_dim, 21
    kv = rng.normal(size=(B, 2, 2, Hkv, C_, D)).astype(np.float32)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    starts = [0, 7, 16, n_valid - 1]
    want = np.stack([np.asarray(jattn.decode_attention(
        jnp.asarray(q[b]), jnp.asarray(kv[b, 1, 0]), jnp.asarray(kv[b, 1, 1]),
        jnp.int32(n_valid), jnp.int32(starts[b]))) for b in range(B)])
    got = pattn.decode_attention_auto(torch.from_numpy(q), torch.from_numpy(kv), 1, n_valid,
                                      torch.tensor(starts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_talker_prefill_window_matches_jax(talker):
    """Three windows at absolute positions [37, 47) as one [R, P, H]
    prefill against JAX's talker_prefill_window per window: last hidden,
    logits and the window cache within 1e-4."""
    params = talker[0]
    port = params_from_jax(_to_np(params))
    P, pos0 = 10, 37
    embd = np.random.default_rng(8).normal(size=(3, P, TCFG.hidden_size)).astype(np.float32)
    got = ptalker.talker_prefill_window(port, TCFG, torch.from_numpy(embd), pos0)
    for r in range(3):
        want = jtalker.talker_prefill_window(params, TCFG, jnp.asarray(embd[r]),
                                             jnp.int32(pos0), kv_dtype=jnp.float32)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_compact_matches_jax(talker):
    """compact on the same state: the rolled, re-rotated cache within 1e-5
    (float32 rotations, cos and sin of -shift from two libraries), n_past
    and starts (clamped at 0) exact."""
    params = talker[0]
    lanes, Cc, shift = 3, 24, 9
    rng = np.random.default_rng(12)
    kv = rng.normal(size=(lanes, TCFG.n_layers, 2, TCFG.n_kv_heads, Cc, TCFG.head_dim)
                    ).astype(np.float32)
    starts = np.array([12, 4, 20], np.int32)
    jstate = jcont.init_state(params, TCFG, lanes=lanes, kv_capacity=Cc, trailing_len=13)
    jstate = jstate._replace(kv=jnp.asarray(kv), n_past=jnp.int32(22),
                             start=jnp.asarray(starts))
    want = jcont.compact(jstate, jnp.int32(shift), talker_cfg=TCFG)
    pstate = pcont.init_state(params_from_jax(_to_np(params)), TCFG, lanes=lanes,
                              kv_capacity=Cc, trailing_len=13)
    pstate.kv, pstate.n_past = torch.from_numpy(kv.copy()), 22
    pstate.start = torch.from_numpy(starts.copy())
    pcont.compact(pstate, shift, talker_cfg=TCFG)
    np.testing.assert_allclose(pstate.kv.numpy(), np.asarray(want.kv), rtol=1e-5, atol=1e-5)
    assert pstate.n_past == int(want.n_past) == 13
    np.testing.assert_array_equal(pstate.start.numpy(), np.asarray(want.start))
    np.testing.assert_array_equal(pstate.start.numpy(), [3, 0, 11])
